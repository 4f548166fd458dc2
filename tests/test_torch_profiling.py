"""The port's forward profiler (ntxent_tpu_torch.utils.profiling): what
runs here without a card."""

import pytest
import torch

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
    ("void (anonymous namespace)::flash_dkv_kernel<__nv_bfloat16, 64>(...)",
     "flash_attention_dkv"),
    ("void (anonymous namespace)::ntxent_fwd_kernel<float>(...)",
     "ntxent_fwd"),
    ("(anonymous namespace)::ntxent_loss_reduce(float const*, int, float*)",
     "ntxent_fwd"),
    ("void (anonymous namespace)::ntxent_bwd_sym_kernel<float>(...)",
     "ntxent_bwd_sym"),
    ("void (anonymous namespace)::ntxent_fwd_kernel<float, true>(...)",
     "ntxent_fwd_general"),
    ("void (anonymous namespace)::ntxent_fwd_kernel<float, false>(...)",
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
])
def test_kernels_are_grouped_by_name(name, group):
    assert profiling._group(name) == group


@pytest.mark.parametrize("argv", [["--bucket", "1"],
                                  ["--mode", "train", "--batch", "2"],
                                  ["--mode", "clip", "--batch", "2"],
                                  ["--mode", "dp", "--batch", "2"],
                                  ["--mode", "clip_dp", "--batch", "2"]])
def test_profiler_needs_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.main(argv)


def test_every_kernel_wrapper_counts_launches():
    counters = profiling.launch_counters()
    assert sorted(counters) == ["flash_attention_dkv", "flash_attention_dq",
                                "flash_attention_fwd", "infonce_bwd_cols",
                                "infonce_bwd_rows", "infonce_dual_bwd",
                                "infonce_dual_fwd", "infonce_dual_fwd_rect",
                                "ntxent_bwd_general_cols",
                                "ntxent_bwd_general_rows", "ntxent_bwd_sym",
                                "ntxent_fwd", "ntxent_fwd_general"]
    assert all(isinstance(w.launches, int) for w in counters.values())
