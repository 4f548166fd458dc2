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
])
def test_kernels_are_grouped_by_name(name, group):
    assert profiling._group(name) == group


def test_profiler_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.main(["--bucket", "1"])
