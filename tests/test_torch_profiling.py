"""The port's forward profiler (ntxent_tpu_torch.utils.profiling): what
runs here without a card."""

import re

import pytest
import torch

from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.utils import profiling


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64>"
     "(__nv_bfloat16 const*, ...)", "flash_attention_fwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    ("void (anonymous namespace)::flash_dq_kernel<__nv_bfloat16, 64>(...)",
     "flash_attention_dq"),
    ("void (anonymous namespace)::flash_fold_kernel<__nv_bfloat16, 64>"
     "(...)", "flash_fold"),
    ("void (anonymous namespace)::flash_dkv_kernel<__nv_bfloat16, 64>(...)",
     "flash_attention_dkv"),
    ("void (anonymous namespace)::flash_dq_kernel_tma<64>(CUtensorMap_st, "
     "...)", "flash_attention_dq"),
    ("void (anonymous namespace)::flash_fold_kernel_tma<64>(CUtensorMap_st, "
     "...)", "flash_fold"),
    ("void (anonymous namespace)::ntxent_fwd_sym_walk<true>(...)",
     "ntxent_fwd"),
    ("(anonymous namespace)::ntxent_fwd_sym_reduce(float const*, int, "
     "float*)", "ntxent_fwd"),
    ("void (anonymous namespace)::ntxent_bwd_sym_walk<true, 128>(...)",
     "ntxent_bwd_sym"),
    ("void (anonymous namespace)::ntxent_fwd_general_walk<true>(...)",
     "ntxent_fwd_general"),
    ("void (anonymous namespace)::ntxent_fwd_sym_walk<false>(...)",
     "ntxent_fwd"),
    ("void (anonymous namespace)::ntxent_bwd_general_kernel<float, false>"
     "(...)", "ntxent_bwd_general_rows"),
    ("void (anonymous namespace)::ntxent_bwd_general_kernel<float, true>"
     "(...)", "ntxent_bwd_general_cols"),
    ("void (anonymous namespace)::infonce_dual_fwd_kernel<float>(...)",
     "infonce_dual_fwd"),
    ("(anonymous namespace)::infonce_loss_reduce(float const*, int, float*)",
     "infonce_dual_fwd"),
    ("void (anonymous namespace)::infonce_dual_bwd_kernel<__nv_bfloat16>"
     "(...)", "infonce_dual_bwd"),
    ("void (anonymous namespace)::infonce_fwd_rect_kernel<float>(...)",
     "infonce_dual_fwd_rect"),
    ("void (anonymous namespace)::infonce_bwd_rows_kernel<float>(...)",
     "infonce_bwd_rows"),
    ("void (anonymous namespace)::infonce_bwd_cols_kernel<__nv_bfloat16>"
     "(...)", "infonce_bwd_cols"),
    ("void (anonymous namespace)::ntxent_dual_stats_kernel<float>(...)",
     "block_lse_dual"),
    ("void (anonymous namespace)::ntxent_dual_grads_kernel<__nv_bfloat16>"
     "(...)", "block_grads_dual"),
    ("void (anonymous namespace)::tri_tiles_fwd_kernel<float>(...)",
     "ntxent_fwd_tri"),
    ("(anonymous namespace)::tri_fwd_merge_kernel(float const*, ...)",
     "ntxent_fwd_tri"),
    ("(anonymous namespace)::tri_loss_reduce(float const*, int, float*)",
     "ntxent_fwd_tri"),
    ("void (anonymous namespace)::tri_tiles_bwd_kernel<__nv_bfloat16>(...)",
     "ntxent_bwd_tri"),
    ("(anonymous namespace)::tri_bwd_sum_kernel(float const*, ...)",
     "ntxent_bwd_tri"),
])
def test_kernels_are_grouped_by_name(name, group):
    assert profiling._group(name) == group


@pytest.mark.parametrize("source", ["ntxent_fwd", "ntxent_bwd_sym"])
def test_tf32_ntxent_kernels_group_under_their_wrappers(source):
    """Every kernel of the TF32 #1 and #5 (prep, walk, merge, reduce,
    sum; the tensor-map parameters in their names) groups under the
    wrapper that launches it, never under cuBLAS's "matmul"."""
    text = _build.SOURCES[source].read_text()
    names = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\(", text)
    assert len(names) >= 3
    for name in names:
        demangled = (f"void (anonymous namespace)::{name}<true>("
                     f"CUtensorMap_st, CUtensorMap_st, ...)")
        wrapper = "ntxent_fwd_general" if "_general_" in name else source
        assert profiling._group(demangled) == wrapper, name


@pytest.mark.parametrize("argv", [["--bucket", "1"],
                                  ["--mode", "train", "--batch", "2"],
                                  ["--mode", "clip", "--batch", "2"],
                                  ["--mode", "dp", "--batch", "2"],
                                  ["--mode", "dp", "--dp-loss", "pair",
                                   "--batch", "2"],
                                  ["--mode", "clip_dp", "--batch", "2"],
                                  ["--mode", "longctx"],
                                  ["--mode", "longctx", "--ring-emulate",
                                   "4"],
                                  ["--mode", "ntxent"]])
def test_profiler_needs_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.main(argv)


def test_every_kernel_wrapper_counts_launches():
    counters = profiling.launch_counters()
    assert sorted(counters) == ["block_grads_dual", "block_lse_dual",
                                "flash_attention_dkv", "flash_attention_dq",
                                "flash_attention_fwd", "flash_fold",
                                "infonce_bwd_cols",
                                "infonce_bwd_rows", "infonce_dual_bwd",
                                "infonce_dual_fwd", "infonce_dual_fwd_rect",
                                "ntxent_bwd_general_cols",
                                "ntxent_bwd_general_rows", "ntxent_bwd_sym",
                                "ntxent_bwd_tri", "ntxent_fwd",
                                "ntxent_fwd_general", "ntxent_fwd_tri"]
    assert all(isinstance(w.launches, int) for w in counters.values())


@pytest.mark.parametrize("ranks", [2, 4, 8])
@pytest.mark.parametrize("impl", ["flash", "jnp"])
def test_emulated_ring_is_the_ring_of_that_many_ranks(ranks, impl):
    """The emulated ranks of ``--ring-emulate`` (and of chip_smoke.py's
    ring phases) give full causal attention and its gradients, within
    1e-5 (the same fp32 products summed in another order), on the CPU's
    plain versions of the hop kernels."""
    from ntxent_tpu_torch.parallel import attention_oracle

    gen = torch.Generator().manual_seed(ranks)
    qkv = [(0.5 * torch.randn(1, 64, 4, 16, generator=gen)).requires_grad_()
           for _ in range(3)]
    want = attention_oracle(*qkv, causal=True)
    want_g = torch.autograd.grad(want.pow(2).sum(), qkv)
    got = profiling.emulated_ring_attention(ranks, causal=True,
                                            impl=impl)(*qkv)
    got_g = torch.autograd.grad(got.pow(2).sum(), qkv)
    for g, w in zip((got, *got_g), (want, *want_g)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_emulated_ring_ntxent_is_the_global_loss(ranks):
    """The emulated ranks of chip_smoke.py's ring NT-Xent phase give the
    NT-Xent of the global batch and its gradient, within 1e-5 (the same
    fp32 terms summed in another order), on the CPU's plain versions of
    the block kernels."""
    from ntxent_tpu_torch.ops.oracle import cosine_normalize, ntxent_loss

    gen = torch.Generator().manual_seed(ranks)
    z = cosine_normalize(torch.randn(2 * 8 * ranks, 16, generator=gen))
    z.requires_grad_()
    want = ntxent_loss(z, 0.1)
    want_g, = torch.autograd.grad(want, z)
    n = z.shape[0] // 2
    got = profiling.emulated_ring_ntxent(ranks, 0.1)(z[:n], z[n:])
    got_g, = torch.autograd.grad(got, z)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got_g, want_g, atol=1e-5, rtol=0)
