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
    ("void (anonymous namespace)::ntxent_bwd_general_rows_walk<true, 128>"
     "(...)", "ntxent_bwd_general_rows"),
    ("void (anonymous namespace)::ntxent_bwd_general_cols_prep<__nv_"
     "bfloat16, false>(...)", "ntxent_bwd_general_cols"),
    ("void (anonymous namespace)::infonce_dual_fwd_walk<true>("
     "CUtensorMap_st, ...)", "infonce_dual_fwd"),
    ("(anonymous namespace)::infonce_loss_reduce(float const*, int, float*)",
     "infonce_dual_fwd"),
    ("void (anonymous namespace)::infonce_dual_bwd_walk<false, 128>("
     "ntx::BwdMaps, ...)", "infonce_dual_bwd"),
    ("void (anonymous namespace)::infonce_fwd_rect_walk<true>("
     "CUtensorMap_st, ...)", "infonce_dual_fwd_rect"),
    ("void (anonymous namespace)::infonce_bwd_rows_kernel<float>(...)",
     "infonce_bwd_rows"),
    ("void (anonymous namespace)::infonce_bwd_cols_kernel<__nv_bfloat16>"
     "(...)", "infonce_bwd_cols"),
    ("void infonce_cross::infonce_bwd_rows_walk<true, 128>(CUtensorMap_st, "
     "...)", "infonce_bwd_rows"),
    ("void infonce_cross::infonce_bwd_rows_prep<float, true>(float const*, "
     "...)", "infonce_bwd_rows"),
    ("infonce_cross::infonce_bwd_rows_sum(float const*, float*, unsigned "
     "long, int)", "infonce_bwd_rows"),
    ("void infonce_cross::infonce_bwd_cols_walk<false, 64>(CUtensorMap_st, "
     "...)", "infonce_bwd_cols"),
    ("void infonce_cross::infonce_bwd_cols_prep<__nv_bfloat16, false>(...)",
     "infonce_bwd_cols"),
    ("infonce_cross::infonce_bwd_cols_sum(float const*, float*, unsigned "
     "long, int)", "infonce_bwd_cols"),
    ("void (anonymous namespace)::ntxent_dual_stats_walk<true>("
     "CUtensorMap_st, ...)", "block_lse_dual"),
    ("void (anonymous namespace)::ntxent_dual_grads_walk<false, 128>("
     "ntx::BwdMaps, ...)", "block_grads_dual"),
    ("void (anonymous namespace)::ntxent_fwd_tri_walk<true>("
     "CUtensorMap_st, ...)", "ntxent_fwd_tri"),
    ("(anonymous namespace)::ntxent_fwd_tri_merge(float const*, ...)",
     "ntxent_fwd_tri"),
    ("(anonymous namespace)::ntxent_fwd_tri_reduce(float const*, int, "
     "float*)", "ntxent_fwd_tri"),
    ("void (anonymous namespace)::ntxent_bwd_tri_walk<false, 128>("
     "CUtensorMap_st, ...)", "ntxent_bwd_tri"),
    ("(anonymous namespace)::ntxent_bwd_tri_sum(float const*, ...)",
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


def test_tf32_infonce_backward_kernels_group_under_their_wrappers():
    """Every kernel of the TF32 #5 cross-modal and #4 (prep, walk, sum;
    ``csrc/infonce_cross_bwd.cuh``) groups under the wrapper of its side,
    never under cuBLAS's "matmul"."""
    header = _build.SOURCES["infonce_bwd_cols"].parent / \
        "infonce_cross_bwd.cuh"
    names = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\(", header.read_text())
    assert len(names) == 6
    for name in names:
        demangled = (f"void infonce_cross::{name}<true, 128>("
                     f"CUtensorMap_st, CUtensorMap_st, ...)")
        side = "rows" if "_rows_" in name else "cols"
        assert profiling._group(demangled) == f"infonce_bwd_{side}", name


@pytest.mark.parametrize("source", ["infonce_dual_fwd", "infonce_dual_bwd"])
def test_tf32_infonce_dual_kernels_group_under_their_wrappers(source):
    """Every kernel of the TF32 #9 (both modes: prep, walk, merge, reduce)
    and #10 (prep, walk, sum) groups under the wrapper that launches it,
    never under cuBLAS's "matmul"."""
    names = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\(", _build.SOURCES[source].read_text())
    assert len(names) >= 3
    for name in names:
        demangled = (f"void (anonymous namespace)::{name}<true>("
                     f"CUtensorMap_st, CUtensorMap_st, ...)")
        wrapper = "infonce_dual_fwd_rect" if "_rect_" in name else source
        assert profiling._group(demangled) == wrapper, name


@pytest.mark.parametrize("source,wrapper",
                         [("ntxent_dual_stats", "block_lse_dual"),
                          ("ntxent_dual_grads", "block_grads_dual")])
def test_tf32_pair_kernels_group_under_their_wrappers(source, wrapper):
    """Every kernel of the TF32 #7 (prep, walk, merge) and #8 (prep, walk,
    sum) groups under the wrapper that launches it, never under cuBLAS's
    "matmul"."""
    names = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\(", _build.SOURCES[source].read_text())
    assert len(names) == 3
    for name in names:
        demangled = (f"void (anonymous namespace)::{name}<true>("
                     f"CUtensorMap_st, CUtensorMap_st, ...)")
        assert profiling._group(demangled) == wrapper, name


@pytest.mark.parametrize("source,wrapper",
                         [("ntxent_tri_fwd", "ntxent_fwd_tri"),
                          ("ntxent_tri_bwd", "ntxent_bwd_tri")])
def test_tf32_tri_kernels_group_under_their_wrappers(source, wrapper):
    """Every kernel of the TF32 #2 (prep, walk, merge, reduce) and #3
    (prep, walk, sum) groups under the wrapper that launches it, never
    under cuBLAS's "matmul"."""
    names = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                       r"\s+(\w+)\(", _build.SOURCES[source].read_text())
    assert len(names) >= 3
    for name in names:
        demangled = (f"void (anonymous namespace)::{name}<true>("
                     f"CUtensorMap_st, CUtensorMap_st, ...)")
        assert profiling._group(demangled) == wrapper, name


@pytest.mark.parametrize("argv", [["--bucket", "1"],
                                  ["--mode", "train", "--batch", "2"],
                                  ["--mode", "clip", "--batch", "2"],
                                  ["--mode", "dp", "--batch", "2"],
                                  ["--mode", "dp", "--dp-loss", "pair",
                                   "--batch", "2"],
                                  ["--mode", "dp", "--dp-loss", "chunked",
                                   "--ring-chunks", "4", "--batch", "2"],
                                  ["--mode", "dp", "--collective-dtype",
                                   "int8", "--batch", "2"],
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


@pytest.mark.parametrize("ranks,chunks", [(2, 3), (4, 4), (3, 1)])
def test_emulated_chunked_ring_is_the_global_loss(ranks, chunks):
    """The emulated chunked ring of chip_smoke.py's ``[chunked-emulated]``
    phase (each hop's block folded as ``chunks`` slices) gives the global
    NT-Xent and its gradient within 1e-5, with ``ranks * ranks * chunks``
    launches of the block kernels' wrappers."""
    from ntxent_tpu_torch.ops import ntxent
    from ntxent_tpu_torch.ops.oracle import cosine_normalize, ntxent_loss

    gen = torch.Generator().manual_seed(10 * ranks + chunks)
    z = cosine_normalize(torch.randn(2 * 8 * ranks, 16, generator=gen))
    z.requires_grad_()
    want = ntxent_loss(z, 0.1)
    want_g, = torch.autograd.grad(want, z)
    n = z.shape[0] // 2
    got = profiling.emulated_ring_ntxent(ranks, 0.1, chunks=chunks)(
        z[:n], z[n:])
    got_g, = torch.autograd.grad(got, z)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got_g, want_g, atol=1e-5, rtol=0)


@pytest.mark.parametrize("flags", [
    dict(dp_loss="chunked", ring_chunks=2),
    dict(dp_loss="strip", collective_dtype="int8"),
    dict(dp_loss="chunked", ring_chunks=3, collective_dtype="bf16")])
def test_dp_mode_runs_at_a_tiny_size_on_the_cpu(flags):
    """``--mode dp``'s profile with the wire options, on the tiny ResNet
    at 8 px in a gloo world of one: host-clock times, no trace."""
    torch.set_num_threads(1)
    out = profiling.dp_profile(2, torch.device("cpu"), model="tiny",
                               image_size=8, **flags)
    assert out["dp_loss"] == flags["dp_loss"]
    assert out["ring_chunks"] == flags.get("ring_chunks")
    assert out["collective_dtype"] == flags.get("collective_dtype",
                                                "float32")
    assert out["step_ms"] > 0 and out["peak_memory_bytes"] is None
    assert set(out["parts_ms"]) == {
        "encoder_fwd_bwd", f"{flags['dp_loss']}_loss_fwd_bwd",
        "grad_pmean_lars_update"}

