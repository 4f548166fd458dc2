"""The port's flash attention (ntxent_tpu_torch.ops.attention) against the
JAX package's Pallas kernel.

The same numpy inputs go through JAX ``flash_attention(...,
interpret=True)`` (the Pallas ``_fwd_kernel`` run in interpret mode, as
tests/test_flash_attention.py runs it) and the port. On the CPU the
port's wrapper takes its plain version, so these tests hold the plain
version's ``(o, lse)`` to the TPU kernel's output and lse residual. The
CUDA kernel itself is held to the plain version on the card
(``cuda``-marked test below, and ``chip_smoke.py``).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops.attention_pallas import _flash_fwd, flash_attention
from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.ops import attention as tattn

# (lq, lk, causal, q_offset, k_offset). Block pins give JAX several q and
# kv tiles: bq = 8 with L = 20 leaves a ragged q tile; bk = 128 with
# Lk = 150 a ragged kv tile. q_offset=0, k_offset=3 masks the first three
# query rows entirely (l = 0 -> 1) and skips a kv tile.
CASES = {
    "noncausal_ragged": (20, 20, False, 0, 0),
    "causal": (20, 20, True, 0, 0),
    "causal_offsets_lq_ne_lk": (20, 150, True, 0, 3),
    "causal_offsets_shifted": (20, 150, True, 130, 5),
    "noncausal_lq_ne_lk": (20, 150, False, 0, 0),
}
# fp32: both sides accumulate fp32 products of the same values; only the
# summation order differs. bf16: p is rounded to bf16 at different
# running maxima and o is rounded to bf16 (2**-8 relative) on both sides.
TOL = {"float32": dict(o=1e-5, lse=1e-5), "bfloat16": dict(o=2e-2, lse=1e-4)}
B, H, D = 2, 2, 16
BLOCK_Q, BLOCK_KV = 8, 128


def _inputs(lq, lk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, n, H, D)).astype(np.float32)
               for n in (lq, lk, lk))
    if dtype == "bfloat16":  # both sides see the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    return q, k, v


def _jax(q, k, v, dtype, causal, q_off, k_off):
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    o = flash_attention(jq, jk, jv, causal=causal, q_offset=q_off,
                        k_offset=k_off, block_q=BLOCK_Q, block_kv=BLOCK_KV,
                        interpret=True)
    _, residual = _flash_fwd(jq, jk, jv, 1.0 / np.sqrt(D), causal, q_off,
                             k_off, BLOCK_Q, BLOCK_KV, True)
    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(residual[-1]))  # lse: (B*H, Lq)


def _flat(x, dtype):
    b, l, h, d = x.shape
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    return t.reshape(b * h, l, d).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case, dtype):
    lq, lk, causal, q_off, k_off = CASES[case]
    q, k, v = _inputs(lq, lk, dtype)
    o_jax, lse_jax = _jax(q, k, v, dtype, causal, q_off, k_off)

    o, lse = tattn.flash_attention_fwd(
        _flat(q, dtype), _flat(k, dtype), _flat(v, dtype), causal=causal,
        q_offset=q_off, k_offset=k_off)
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert lse.shape == (B * H, lq)
    o = o.float().reshape(B, H, lq, D).permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(o, o_jax, atol=TOL[dtype]["o"], rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=TOL[dtype]["lse"],
                               rtol=1e-6)


def test_public_layout_matches_pallas_kernel():
    """flash_attention keeps the JAX (B, L, H, D) layout at its surface."""
    q, k, v = _inputs(20, 150, "float32", seed=1)
    o_jax, _ = _jax(q, k, v, "float32", True, 0, 3)
    o = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, q_offset=0, k_offset=3)
    np.testing.assert_allclose(o.numpy(), o_jax, atol=1e-5, rtol=0)


def test_fully_masked_rows_give_zero_and_floor_lse():
    q, k, v = (torch.randn(1, 4, 8) for _ in range(3))
    o, lse = tattn.attention_plain(q, k, v, causal=True, q_offset=0,
                                   k_offset=2)
    assert torch.all(o[:, :2] == 0.0)
    assert torch.all(lse[:, :2] <= -1e29)
    assert torch.all(torch.isfinite(o)) and torch.all(lse[:, 2:] > -1e3)


def test_cpu_tensor_takes_the_plain_version_without_counting():
    q, k, v = (torch.randn(3, 5, 8) for _ in range(3))
    before = tattn.flash_attention_fwd.launches
    o, lse = tattn.flash_attention_fwd(q, k, v, scale=0.3)
    o_ref, lse_ref = tattn.attention_plain(q, k, v, scale=0.3)
    assert tattn.flash_attention_fwd.launches == before
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)


@pytest.mark.parametrize("shapes", [
    ((2, 5, 8), (2, 6, 8), (2, 7, 8)),      # k/v lengths differ
    ((2, 5, 8), (3, 6, 8), (3, 6, 8)),      # batch*heads differ
    ((2, 5, 8), (2, 6, 4), (2, 6, 4)),      # head dims differ
    ((2, 0, 8), (2, 6, 8), (2, 6, 8)),      # empty queries
])
def test_flat_wrapper_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, k, v)


def test_public_wrapper_rejects_bad_layout():
    with pytest.raises(ValueError):
        tattn.flash_attention(torch.zeros(2, 5, 8), torch.zeros(2, 5, 8),
                              torch.zeros(2, 5, 8))


def test_default_scale_rule():
    assert tattn.resolve_attention_scale(None, 64) == 0.125
    assert tattn.resolve_attention_scale(0.5, 64) == 0.5


def test_kernel_build_line_targets_hopper_from_repo_sources(tmp_path):
    cmd = _build.nvcc_command("flash_attention_fwd", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    source = _build.SOURCES["flash_attention_fwd"]
    assert str(source) in cmd and source.is_file()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    # A plain C entry point: the source includes no PyTorch header.
    text = source.read_text()
    assert "torch/" not in text and 'extern "C"' in text
    assert "ntx_flash_attention_fwd" in text


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal", [
    ("bfloat16", 64, False), ("float32", 64, False), ("bfloat16", 128, True),
    ("float32", 128, True)])
def test_cuda_kernel_matches_plain_version(dtype, d, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(24, n, d, generator=gen, device="cuda").to(
        getattr(torch, dtype)) for n in (197, 230, 230))
    before = tattn.flash_attention_fwd.launches
    o, lse = tattn.flash_attention_fwd(q, k, v, causal=causal, q_offset=40,
                                       k_offset=7)
    o_ref, lse_ref = tattn.attention_plain(q, k, v, causal=causal,
                                           q_offset=40, k_offset=7)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd.launches == before + 1
    atol = 2e-2 if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    assert isinstance(_build.load("flash_attention_fwd"), ctypes.CDLL)


# The edges of the bf16 forward kernel's tiles: lengths around the 64-row
# tile, head_dim 64 and 128, causal with k_offset 70, so the first 70
# query rows have no live key (o = 0, lse = -1e30 + log(1e-37)) and kv
# tiles that lie wholly after a q tile are skipped.
EDGE_LENGTHS = (1, 63, 64, 65, 197, 300)
EDGE_K_OFFSET = 70


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_cuda_forward_kernel_edges_match_plain_version(length, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(length + d)
    q, k, v = (torch.randn(6, length, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, q_offset=0, k_offset=EDGE_K_OFFSET)
    o, lse = tattn.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = tattn.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    dead = min(length, EDGE_K_OFFSET)  # rows with no live key
    assert torch.all(o[:, :dead] == 0)
    assert torch.all(lse[:, :dead] <= -1e29)
