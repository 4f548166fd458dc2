"""The port's triangular symmetric NT-Xent and the rest of the loss API
against the JAX package.

* ``ntxent_loss_fused(z, T, triangular=True)`` (the triangular forward
  #2 and backward #3; on the CPU their plain versions, which fold
  per-64-column-block partials; the kernels' own order is emulated in
  ``tests/test_torch_tri_sm90.py``) against JAX's
  ``ntxent_loss_fused(..., triangular=True)`` with its Pallas kernels in
  interpret mode: 2N = 16, 40 (no multiple of the JAX block) and 64,
  D = 32, T = 0.07 and 0.5, fp32. The loss within 1e-5 and the gradient
  within 1e-6 (the same fp32 products summed in another order; gradients
  of size ~1e-2).
* ``ntxent_loss_and_lse`` against its JAX counterpart.
* ``losses.NTXentLoss`` (forward and backward) against the JAX oracle.
* The thirteen top-level names of ``ntxent_tpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntxent_tpu
import ntxent_tpu_torch
from ntxent_tpu.ops import ntxent_pallas as jpallas
from ntxent_tpu.ops import oracle as joracle
from ntxent_tpu_torch.losses import NTXentLoss, ntxent_loss_torch
from ntxent_tpu_torch.ops import ntxent as N

torch.set_num_threads(1)  # see test_torch_training.py

ROWS = (16, 40, 64)
TEMPERATURES = (0.07, 0.5)
D = 32


def _z(rows, seed=0, d=D):
    z = np.random.default_rng(seed + rows).normal(size=(rows, d))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return z.astype(np.float32)


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("rows", ROWS)
def test_triangular_loss_and_gradient_match_jax(rows, temperature):
    z = _z(rows)
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jpallas.ntxent_loss_fused(x, temperature, triangular=True,
                                            interpret=True))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    loss = N.ntxent_loss_fused(zt, temperature, triangular=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(grad_j),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("rows", ROWS)
def test_triangular_plain_versions_equal_the_rectangular_ones(rows):
    """The same function: the triangular plain versions against the
    symmetric ones (#1, #5), and through the autograd function against
    ``triangular=False``."""
    z = torch.from_numpy(_z(rows, seed=1))
    loss_t, lse_t = N.ntxent_fwd_tri_plain(z, 0.1)
    loss_s, lse_s = N.ntxent_fwd_plain(z, 0.1)
    torch.testing.assert_close(lse_t, lse_s, atol=1e-6, rtol=0)
    torch.testing.assert_close(loss_t / rows, loss_s / rows, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(N.ntxent_bwd_tri_plain(z, lse_s, 0.1),
                               N.ntxent_bwd_sym_plain(z, lse_s, 0.1),
                               atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_triangular_plain_versions_without_counting():
    z = torch.from_numpy(_z(16)).requires_grad_()
    fwd, bwd = N.ntxent_fwd_tri.launches, N.ntxent_bwd_tri.launches
    sym = N.ntxent_fwd.launches, N.ntxent_bwd_sym.launches
    N.ntxent_loss_fused(z, 0.1, triangular=True).backward()
    assert (N.ntxent_fwd_tri.launches, N.ntxent_bwd_tri.launches) == (fwd,
                                                                      bwd)
    assert (N.ntxent_fwd.launches, N.ntxent_bwd_sym.launches) == sym
    assert z.grad is not None and z.grad.abs().sum() > 0


@pytest.mark.parametrize("rows", ROWS)
def test_loss_and_lse_match_jax(rows):
    z = _z(rows, seed=2)
    loss_j, lse_j = jpallas.ntxent_loss_and_lse(jnp.asarray(z), 0.1,
                                                interpret=True)
    loss, lse = N.ntxent_loss_and_lse(torch.from_numpy(z), 0.1)
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=0)
    assert not loss.requires_grad


@pytest.mark.parametrize("views", ["stacked", "pair"])
def test_ntxent_loss_module_matches_the_jax_oracle(views):
    z = _z(24, seed=3)
    loss_j, grad_j = jax.value_and_grad(
        lambda x: joracle.ntxent_loss(x, 0.2))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    module = NTXentLoss(temperature=0.2)
    loss = module(zt) if views == "stacked" else module(zt[:12], zt[12:])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(grad_j),
                               atol=1e-6, rtol=0)
    assert "temperature=0.2" in repr(module)


def test_ntxent_loss_torch_rejects_odd_or_flat_input():
    with pytest.raises(ValueError, match="even 2N"):
        ntxent_loss_torch(torch.zeros(5, 4))
    with pytest.raises(ValueError, match="even 2N"):
        ntxent_loss_torch(torch.zeros(6))


def test_top_level_exports_the_jax_packages_names():
    assert set(ntxent_tpu_torch.__all__) == set(ntxent_tpu.__all__)
    for name in ntxent_tpu.__all__:
        assert hasattr(ntxent_tpu_torch, name), name


def test_top_level_losses_agree_on_one_input():
    """Each top-level loss of the port on the JAX package's namesake's
    input: the fused, the oracle and the reference API."""
    z = _z(16, seed=4)
    zt = torch.from_numpy(z)
    want = float(joracle.ntxent_loss(jnp.asarray(z), 0.1))
    for got in (ntxent_tpu_torch.ntxent_loss_fused(zt, 0.1),
                ntxent_tpu_torch.ntxent_loss_fused(zt, 0.1, triangular=True),
                ntxent_tpu_torch.ntxent_loss(zt, 0.1),
                ntxent_tpu_torch.ntxent_loss_and_lse(zt, 0.1)[0],
                ntxent_tpu_torch.forward(zt, 0.1)):
        np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [512, 300])
def test_cuda_triangular_kernels_match_plain_versions(rows, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the triangular kernels have no CPU "
                    "mode")
    z = torch.nn.functional.normalize(torch.randn(
        rows, 128, generator=torch.Generator().manual_seed(rows)), dim=1)
    z = z.to(dtype).cuda()
    loss, lse = N.ntxent_fwd_tri(z, 0.1)
    loss_p, lse_p = N.ntxent_fwd_tri_plain(z, 0.1)
    torch.testing.assert_close(lse, lse_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(loss / rows, loss_p / rows, atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(N.ntxent_bwd_tri(z, lse_p, 0.1),
                               N.ntxent_bwd_tri_plain(z, lse_p, 0.1),
                               atol=2e-4, rtol=0)
