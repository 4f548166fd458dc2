"""The port's fused InfoNCE (``ntxent_tpu_torch.ops.infonce``) and its
oracle against the JAX package.

The same numpy embeddings go through ``ntxent_tpu.ops.infonce_pallas.
info_nce_fused`` (its Pallas kernels in interpret mode on the CPU, as
``tests/test_infonce.py`` runs them) and through the port: its plain
forward and backward (what the CUDA kernels compute) and its autograd
function. Both the dual backward and, at N = 1536 with D = 512, the
TPU package's two-pass large-N backward (``_dual_bwd_fits`` false) are
held to the one port backward, which serves every N.

Tolerances: fp32 throughout, the same fp32 products summed in another
order -> 1e-5 absolute and relative on the loss and on the gradients of
za, zb and the logit scale; the oracles 1e-5 as well (bf16 inputs are
widened before the product on both sides, so the same bound holds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops import oracle as jax_oracle
from ntxent_tpu.ops.blocks import choose_blocks, round_up
from ntxent_tpu.ops.infonce_pallas import _dual_bwd_fits
from ntxent_tpu.ops.infonce_pallas import info_nce_fused as jax_info_nce
from ntxent_tpu_torch import api
from ntxent_tpu_torch.ops import infonce as I
from ntxent_tpu_torch.ops import oracle

# See tests/test_torch_training.py: one torch thread per test worker.
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
SCALE = 14.285714  # CLIP's initial exp(logit_scale) = 1 / 0.07


def _pair(n, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, n, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return z[0], z[1]


def _jax_loss_and_grads(za, zb, scale):
    fn = jax.value_and_grad(
        lambda a, b, s: jax_info_nce(a, b, scale=s), argnums=(0, 1, 2))
    loss, grads = fn(jnp.asarray(za), jnp.asarray(zb), jnp.float32(scale))
    return float(loss), [np.asarray(g) for g in grads]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n,d", [(8, 32), (64, 32), (100, 32), (8, 512),
                                 (64, 512), (100, 512), (1536, 512),
                                 # the wide embeddings of CLIP ViT-L/14 and
                                 # a D that is no multiple of 32
                                 (64, 768), (40, 1000)])
def test_info_nce_fused_matches_jax(n, d):
    za, zb = _pair(n, d, seed=n + d)
    want_loss, want = _jax_loss_and_grads(za, zb, SCALE)
    ta, tb = torch.from_numpy(za), torch.from_numpy(zb)
    scale = torch.tensor(SCALE)

    # the plain forward and backward: what the kernels compute
    loss_sum, lse_a, lse_b = I.infonce_dual_fwd_plain(ta, tb, scale)
    o_a, o_b = I.infonce_dual_bwd_plain(ta, tb, scale, lse_a, lse_b)
    coef = 1.0 / (2 * n)
    _close(loss_sum.item() / (2 * n), want_loss)
    _close(o_a * coef * SCALE, want[0])
    _close(o_b * coef * SCALE, want[1])
    _close(coef * torch.sum(o_a * ta).item(), want[2])

    # the autograd function over the same wrappers (CPU: plain versions)
    a, b, s = (t.clone().requires_grad_() for t in (ta, tb, scale))
    loss = I.info_nce_fused(a, b, scale=s)
    loss.backward()
    _close(loss.item(), want_loss)
    for got, ref in zip((a.grad, b.grad, s.grad), want):
        _close(got.numpy(), ref)


def test_large_n_case_takes_the_two_pass_backward_in_jax():
    """N = 1536 at D = 512 is where the TPU package's backward falls back
    to two ``_bwd_sym_call`` passes; the port holds it to one kernel."""
    n, d = 1536, 512
    br, bc = choose_blocks(n, n, d, jnp.float32)
    assert not _dual_bwd_fits(round_up(n, br), round_up(n, bc), d, br, bc)
    br, bc = choose_blocks(100, 100, d, jnp.float32)
    assert _dual_bwd_fits(round_up(100, br), round_up(100, bc), d, br, bc)


@pytest.mark.parametrize("temperature", [0.07, 0.5])
def test_temperature_sets_the_scale_when_none_is_given(temperature):
    za, zb = _pair(32, 16, seed=3)
    want = float(jax_info_nce(jnp.asarray(za), jnp.asarray(zb),
                              temperature=temperature))
    got = I.info_nce_fused(torch.from_numpy(za), torch.from_numpy(zb),
                           temperature=temperature)
    _close(got.item(), want)
    assert I.resolve_scale(temperature, None).item() == pytest.approx(
        1.0 / temperature, rel=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(8, 4), (33, 16), (128, 64)])
def test_info_nce_loss_oracle_matches_jax(n, d, dtype):
    za, zb = _pair(n, d, seed=n)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        za = np.array(jnp.asarray(za, jnp.bfloat16).astype(jnp.float32))
        zb = np.array(jnp.asarray(zb, jnp.bfloat16).astype(jnp.float32))
    want = float(jax_oracle.info_nce_loss(
        jnp.asarray(za, dtype), jnp.asarray(zb, dtype), temperature=0.07))
    tdt = getattr(torch, dtype)
    got = oracle.info_nce_loss(torch.from_numpy(za).to(tdt),
                               torch.from_numpy(zb).to(tdt), 0.07)
    _close(got.item(), want)
    assert api.info_nce_loss is oracle.info_nce_loss


def test_fused_loss_equals_the_oracle_and_its_gradients():
    za, zb = _pair(48, 24, seed=7)
    a1, b1, s1 = (torch.from_numpy(za).requires_grad_(),
                  torch.from_numpy(zb).requires_grad_(),
                  torch.tensor(SCALE, requires_grad=True))
    a2, b2, s2 = (t.detach().clone().requires_grad_() for t in (a1, b1, s1))
    fused = api.info_nce_fused(a1, b1, scale=s1)
    ref = oracle.info_nce_loss(a2, b2, temperature=1.0 / s2)
    fused.backward()
    ref.backward()
    torch.testing.assert_close(fused, ref.detach(), atol=ATOL, rtol=RTOL)
    for got, want in ((a1, a2), (b1, b2), (s1, s2)):
        torch.testing.assert_close(got.grad, want.grad, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    za, zb = (torch.from_numpy(z) for z in _pair(10, 8, seed=1))
    scale = torch.tensor(SCALE)
    counts = (I.infonce_dual_fwd.launches, I.infonce_dual_bwd.launches)
    loss_sum, lse_a, lse_b = I.infonce_dual_fwd(za, zb, scale)
    o_a, _ = I.infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
    assert counts == (I.infonce_dual_fwd.launches,
                      I.infonce_dual_bwd.launches)
    want = I.infonce_dual_fwd_plain(za, zb, scale)
    torch.testing.assert_close(loss_sum, want[0], atol=0, rtol=0)
    torch.testing.assert_close(
        o_a, I.infonce_dual_bwd_plain(za, zb, scale, *want[1:])[0], atol=0,
        rtol=0)


def test_input_checks():
    za = torch.zeros(6, 4)
    with pytest.raises(ValueError):
        I.info_nce_fused(za, torch.zeros(5, 4))
    with pytest.raises(ValueError):
        I.info_nce_fused(torch.zeros(0, 4), torch.zeros(0, 4))
    with pytest.raises(ValueError):
        I.infonce_dual_bwd(za, za, torch.tensor(1.0), torch.zeros(5),
                           torch.zeros(6))
    # what only the CUDA kernels refuse
    # any width from 1 to the grid's limit, wide CLIP embeddings included
    with pytest.raises(ValueError, match="D = 0"):
        I._check_kernel_input(torch.zeros(4, 0), torch.zeros(4, 0),
                              torch.tensor(1.0))
    I._check_kernel_input(torch.zeros(4, 1024), torch.zeros(4, 1024),
                          torch.tensor(1.0))
    with pytest.raises(TypeError):
        I._check_kernel_input(torch.zeros(4, 8, dtype=torch.float16),
                              torch.zeros(4, 8, dtype=torch.float16),
                              torch.tensor(1.0))
    with pytest.raises(ValueError, match="one value"):
        I._check_kernel_input(za, za, torch.ones(2))
