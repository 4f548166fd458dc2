"""The port's NT-Xent loss, oracles, reference API and flash-attention
backward against the JAX package.

The same numpy inputs go through both packages. On the JAX side the
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU: ``_fwd_call``/``_bwd_sym_call`` (Queue B #1, #5),
``ntxent_partial_fused``/``block_lse``/``block_grads`` (#1 in its general
mode and ``_bwd_general_call``, #6) and ``flash_dq_hop``/
``flash_dkv_hop`` (#13, #14). On the port's side CPU
tensors take the kernels' plain versions, so these tests hold the
arithmetic that the CUDA kernels replace; ``test_torch_kernels_cuda.py``
holds the CUDA kernels to those plain versions on the card.

Tolerances, all absolute:

* NT-Xent fp32: the same fp32 products of the same values, summed in
  another order (logits up to 1/T = 10) -> 2e-5 on lse and loss/2N,
  1e-5 on grad. bf16 z: products of bf16 values are exact in fp32 on
  both sides -> the same bounds.
* general mode (rows x columns with global ids), fp32: the same fp32
  products summed in another order -> 1e-5 on loss_sum/R, lse and both
  gradients. bf16 embeddings: the products are exact on both sides, and
  the partial loss's gradients are cast to bf16 on both sides -> 1e-5 on
  the loss, one bf16 ulp of the gradients' size (2e-3).
* flash backward fp32: summation order only -> 1e-5. bf16: dq rounds ds
  to bf16 on both sides, and a one-ulp flip between summation orders
  moves dq by up to 2**-8 |ds| |k| -> 1e-2; dk/dv stay fp32 on both
  sides -> 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu import api as japi
from ntxent_tpu.ops import oracle as jor
from ntxent_tpu.ops.attention_pallas import _flash_fwd, flash_dkv_hop
from ntxent_tpu.ops.attention_pallas import flash_attention as jflash
from ntxent_tpu.ops.attention_pallas import flash_dq_hop
from ntxent_tpu.ops.ntxent_pallas import (
    _bwd_general_call,
    _bwd_sym_call,
    _fwd_call,
    _gid_column,
    _pad_rows,
)
from ntxent_tpu.ops.ntxent_pallas import block_grads as jblock_grads
from ntxent_tpu.ops.ntxent_pallas import block_lse as jblock_lse
from ntxent_tpu.ops.ntxent_pallas import ntxent_loss_fused as jfused
from ntxent_tpu.ops.ntxent_pallas import ntxent_partial_fused as jpartial
from ntxent_tpu_torch import api as tapi
from ntxent_tpu_torch.ops import attention as tattn
from ntxent_tpu_torch.ops import ntxent as tntx
from ntxent_tpu_torch.ops import oracle as tor

from test_torch_flash_attention import BLOCK_KV, BLOCK_Q, CASES, B, D, H
from test_torch_flash_attention import _flat as _flat_bhld
from test_torch_flash_attention import _inputs as _attn_inputs

# (2N, D): 2N a multiple of neither the JAX tiles (8 x 128) nor the CUDA
# tiles (32 x 64), and D != 2B (SURVEY D7).
SHAPES = [(100, 96), (300, 40)]
BR, BC = 8, 128
NTX_TOL = dict(lse=2e-5, loss=2e-5, grad=1e-5)
BWD_TOL = {"float32": dict(dq=1e-5, dkv=1e-5),
           "bfloat16": dict(dq=1e-2, dkv=1e-4)}


def _embeddings(two_n, dim, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(two_n, dim)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    if dtype == "bfloat16":  # both sides see the same bf16 values
        z = np.asarray(jnp.asarray(z, jnp.bfloat16), np.float32)
    return z


def _torch(z, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(z)).to(getattr(torch, dtype))


def _jax_kernels(z, dtype, temperature):
    """loss_sum, lse and the fp32 grad of the Pallas kernels (interpret)."""
    two_n = z.shape[0]
    pad = math.lcm(BR, BC)
    zp = _pad_rows(jnp.asarray(z, getattr(jnp, dtype)), pad)
    gid = _gid_column(jnp.arange(zp.shape[0]), pad, sentinel=two_n)
    kw = dict(br=BR, bc=BC, inv_t=1.0 / temperature, cols_actual=two_n,
              n_half=two_n // 2, interpret=True)
    loss_sum, lse = _fwd_call(zp, zp, gid, **kw)
    grad = _bwd_sym_call(zp, gid, lse, **kw)
    return (float(loss_sum), np.asarray(lse)[:two_n, 0],
            np.asarray(grad)[:two_n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_kernels_match_pallas_kernels(shape, dtype):
    z = _embeddings(*shape, dtype=dtype)
    loss_j, lse_j, grad_j = _jax_kernels(z, dtype, 0.1)
    zt = _torch(z, dtype)
    loss_sum, lse = tntx.ntxent_fwd(zt, 0.1)
    grad = tntx.ntxent_bwd_sym(zt, lse, 0.1)
    assert lse.dtype == grad.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=NTX_TOL["lse"],
                               rtol=0)
    assert abs(float(loss_sum) - loss_j) / shape[0] <= NTX_TOL["loss"]
    np.testing.assert_allclose(grad.numpy(), grad_j, atol=NTX_TOL["grad"],
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_loss_and_gradient_match_jax(shape, dtype):
    z = _embeddings(*shape, dtype=dtype, seed=1)
    jz = jnp.asarray(z, getattr(jnp, dtype))
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jfused(x, 0.07, block_rows=BR, block_cols=BC,
                         interpret=True))(jz)
    grad_o = jor.ntxent_grad_oracle(jnp.asarray(z), 0.07)
    zt = _torch(z, dtype).requires_grad_()
    loss = tntx.ntxent_loss_fused(zt, 0.07)
    loss.backward()
    assert zt.grad.dtype == zt.dtype
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=2e-5, rtol=0)
    # grad is (G @ z) / (2N T) cast to z's dtype on both sides
    atol = 2e-5 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(zt.grad.float().numpy(),
                               np.asarray(grad_j, np.float32), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(zt.grad.float().numpy(), np.asarray(grad_o),
                               atol=atol, rtol=0)


def test_fused_gradient_honours_the_upstream_gradient():
    z = _torch(_embeddings(64, 16, seed=2)).requires_grad_()
    (3.0 * tntx.ntxent_loss_fused(z, 0.1)).backward()
    g3 = z.grad.clone()
    z.grad = None
    tntx.ntxent_loss_fused(z, 0.1).backward()
    torch.testing.assert_close(g3, 3.0 * z.grad, rtol=1e-6, atol=0)


@pytest.mark.parametrize("temperature", [0.01, 0.05, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["random", "near_duplicates"])
def test_stability_grid(temperature, kind):
    z = _embeddings(128, 32, seed=3)
    if kind == "near_duplicates":  # every row nearly the same embedding
        z = z[:1] + 1e-6 * z
        z /= np.linalg.norm(z, axis=1, keepdims=True)
    zt = _torch(z).requires_grad_()
    loss = tntx.ntxent_loss_fused(zt, temperature)
    loss.backward()
    assert math.isfinite(loss.item())
    assert torch.isfinite(zt.grad).all()
    np.testing.assert_allclose(loss.item(), float(jor.ntxent_loss(
        jnp.asarray(z), temperature)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        zt.grad.numpy(), np.asarray(jor.ntxent_grad_oracle(
            jnp.asarray(z), temperature)), rtol=0,
        atol=1e-5 / temperature)


@pytest.mark.parametrize("name", [
    "ntxent_loss", "ntxent_loss_compat", "ntxent_grad_oracle",
    "ntxent_loss_and_softmax", "similarity_matrix", "ntxent_loss_paired",
    "info_nce_loss"])
def test_oracles_match_jax(name):
    z = _embeddings(40, 12, seed=4)
    args = {"ntxent_loss_paired": (z[:20], z[20:]),
            "info_nce_loss": (z[:20], z[20:])}.get(name, (z,))
    want = getattr(jor, name)(*(jnp.asarray(a) for a in args), 0.2)
    got = getattr(tor, name)(*(_torch(a) for a in args), 0.2)
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    (got if isinstance(got, tuple) else (got,))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=2e-5, rtol=1e-5)


def test_odd_row_count_is_rejected():
    with pytest.raises(ValueError):
        tntx.ntxent_loss_fused(torch.zeros(7, 4), 0.1)
    with pytest.raises(ValueError):
        tor.ntxent_loss(torch.zeros(7, 4))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(fused=False), dict(use_mixed_precision=True),
    dict(compat="reference"), dict(return_softmax=True),
    dict(compat="reference", return_softmax=True)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_reference_api_forward_matches_jax(kwargs):
    z = _embeddings(32, 24, seed=5)
    want = japi.forward(z, 0.1, **kwargs)
    got = tapi.forward(torch.from_numpy(z), 0.1, **kwargs)
    atol = 5e-3 if kwargs.get("use_mixed_precision") else 2e-5
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    (got if isinstance(got, tuple) else (got,))):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("mixed", [False, True])
def test_reference_api_backward_matches_jax(mixed):
    z = _embeddings(32, 24, seed=6)
    gz_j, gl_j = japi.backward(z, None, 2.0, 0.1, use_mixed_precision=mixed)
    gz, gl = tapi.backward(torch.from_numpy(z), None, 2.0, 0.1,
                           use_mixed_precision=mixed)
    assert gz.dtype == (torch.bfloat16 if mixed else torch.float32)
    np.testing.assert_allclose(gl.numpy(), np.asarray(gl_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(gz.float().numpy(),
                               np.asarray(gz_j, np.float32),
                               atol=2e-3 if mixed else 1e-5, rtol=0)
    # the reference-API gradient is the fused loss's gradient (x grad_output)
    zt = torch.from_numpy(z).requires_grad_()
    (2.0 * tapi.forward(zt, 0.1)).backward()
    if not mixed:
        torch.testing.assert_close(zt.grad, gz, atol=1e-5, rtol=0)


def test_reference_api_object_and_probe():
    assert tapi.ntxent.forward is tapi.forward
    assert tapi.ntxent.backward is tapi.backward
    assert isinstance(tapi.check_tensor_core_support(), bool)
    with pytest.raises(ValueError):
        tapi.forward(torch.zeros(4, 2), compat="bogus")


# ---------------------------------------------------------------------------
# General mode: the data-parallel partial loss and the ring's blocks
# ---------------------------------------------------------------------------

# (name, rows per view on this rank n, ranks P, rank d, D, extra sentinel
# rows): strips of the stacked views [view 1 of every rank; view 2 of
# every rank] with 2N = 2 n P columns.
STRIPS = [("rank1_of_4", 8, 4, 1, 32, 0),
          ("middle_rank_odd_n", 7, 4, 2, 40, 0),
          ("ragged_with_padding_rows", 5, 3, 1, 24, 3)]


def _strip(n, ranks, rank, dim, pad, dtype, seed):
    """(z_rows, z_cols, row_gid) of one rank's strip; ``pad`` padding rows
    carry the sentinel id 2N, as ``_gid_column`` pads them."""
    two_n = 2 * n * ranks
    z_cols = _embeddings(two_n, dim, dtype, seed)
    base = rank * n + np.arange(n)
    gid = np.concatenate([base, n * ranks + base,
                          np.full(pad, two_n)]).astype(np.int32)
    z_rows = np.concatenate([z_cols[gid[:2 * n]],
                             _embeddings(pad, dim, dtype, seed + 1)])
    return z_rows, z_cols, gid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strip", STRIPS, ids=lambda s: s[0])
def test_partial_fused_loss_and_gradients_match_jax(strip, dtype):
    _, n, ranks, rank, dim, pad = strip
    z_rows, z_cols, gid = _strip(n, ranks, rank, dim, pad, dtype, seed=11)
    jdt = getattr(jnp, dtype)
    loss_j, (g_rows_j, g_cols_j) = jax.value_and_grad(
        lambda a, b: jpartial(a, b, jnp.asarray(gid), 0.1, block_rows=BR,
                              block_cols=BC, interpret=True),
        argnums=(0, 1))(jnp.asarray(z_rows, jdt), jnp.asarray(z_cols, jdt))
    zr = _torch(z_rows, dtype).requires_grad_()
    zc = _torch(z_cols, dtype).requires_grad_()
    loss = tntx.ntxent_partial_fused(zr, zc, torch.from_numpy(gid), 0.1)
    loss.backward()
    assert zr.grad.dtype == zc.grad.dtype == zr.dtype
    rows = z_rows.shape[0]
    np.testing.assert_allclose(loss.item() / rows, float(loss_j) / rows,
                               atol=1e-5, rtol=0)
    atol = 1e-5 if dtype == "float32" else 2e-3
    for got, want in ((zr.grad, g_rows_j), (zc.grad, g_cols_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol,
                                   rtol=0)
    # padding rows add no loss and get a zero gradient
    assert not zr.grad[2 * n:].any()


@pytest.mark.parametrize("n_half", ["ring", "positives"])
def test_general_kernels_with_column_ids_match_block_lse_and_grads(n_half):
    """Columns that carry scattered global ids (``col_gid``): the ring
    loss's visiting block. ``block_lse``/``block_grads`` disable positives
    (n_half = total); with n_half = total / 2 the rows' positives are
    among the columns, as the kernels also allow."""
    rng = np.random.default_rng(12)
    total, rows, cols, dim = 160, 21, 37, 24
    col_gid = rng.permutation(total)[:cols].astype(np.int32)
    row_gid = np.concatenate([col_gid[:9], rng.permutation(total)[:rows - 9]]
                             ).astype(np.int32)
    if n_half == "positives":  # rows whose positive is a visiting column
        row_gid[:5] = (col_gid[10:15] + total // 2) % total
    z_rows, z_cols = _embeddings(rows, dim, seed=13), _embeddings(cols, dim,
                                                                 seed=14)
    half = total if n_half == "ring" else total // 2
    kw = dict(col_gid=torch.from_numpy(col_gid), cols_actual=total,
              n_half=half)
    args = (_torch(z_rows), _torch(z_cols), torch.from_numpy(row_gid))
    loss_sum, lse = tntx.ntxent_fwd_general(*args, 0.1, **kw)
    g_rows = tntx.ntxent_bwd_general_rows(*args, lse, 0.1, **kw)
    g_cols = tntx.ntxent_bwd_general_cols(*args, lse, 0.1, **kw)
    if n_half == "ring":
        jargs = (jnp.asarray(z_rows), jnp.asarray(z_cols),
                 jnp.asarray(row_gid), jnp.asarray(col_gid), 0.1, total)
        jkw = dict(block_rows=BR, block_cols=BC, interpret=True)
        lse_j = np.asarray(jblock_lse(*jargs, **jkw))
        g_rows_j, g_cols_j = jblock_grads(*jargs[:4], jnp.asarray(lse_j),
                                          *jargs[4:], **jkw)
    else:
        cg = _pad_rows(jnp.asarray(col_gid)[:, None], BC)[:, 0]
        cg = cg.at[cols:].set(total)
        zr, zc = _pad_rows(jnp.asarray(z_rows), BR), _pad_rows(
            jnp.asarray(z_cols), BC)
        gid = _gid_column(jnp.asarray(row_gid), BR, sentinel=total)
        jkw = dict(br=BR, bc=BC, inv_t=1.0 / 0.1, cols_actual=total,
                   n_half=half, interpret=True, col_gid=cg)
        loss_j, lse_p = _fwd_call(zr, zc, gid, **jkw)
        g_rows_j, g_cols_j = _bwd_general_call(zr, zc, gid, lse_p, **jkw)
        lse_j = np.asarray(lse_p)[:rows, 0]
        g_rows_j, g_cols_j = g_rows_j[:rows], g_cols_j[:cols]
        np.testing.assert_allclose(loss_sum.item() / rows,
                                   float(loss_j) / rows, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_rows.numpy(), np.asarray(g_rows_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_cols.numpy(), np.asarray(g_cols_j),
                               atol=1e-5, rtol=0)


def test_partial_fused_refuses_an_odd_global_count_and_bad_ids():
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="even"):
        tntx.ntxent_partial_fused(z, torch.zeros(7, 3), torch.arange(4), 0.1)
    with pytest.raises(ValueError, match="row_gid"):
        tntx.ntxent_partial_fused(z, torch.zeros(8, 3), torch.arange(3), 0.1)
    with pytest.raises(ValueError, match="share D"):
        tntx.ntxent_partial_fused(z, torch.zeros(8, 2), torch.arange(4), 0.1)


# ---------------------------------------------------------------------------
# flash-attention backward
# ---------------------------------------------------------------------------


def _jax_bwd(q, k, v, do, dtype, causal, q_off, k_off):
    """dq, dk, dv of the Pallas backward kernels (interpret), with the lse
    and delta they are handed, all on the flat (B*H, L, D) layout."""
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    sc = 1.0 / np.sqrt(D)
    out, res = _flash_fwd(jq, jk, jv, sc, causal, q_off, k_off, BLOCK_Q,
                          BLOCK_KV, True)
    lse = res[-1]

    def flat(x):
        b, l, h, d = x.shape
        return x.transpose(0, 2, 1, 3).reshape(b * h, l, d)

    qf, kf, vf, dof, of = (flat(x) for x in (jq, jk, jv, jdo, out))
    delta = jnp.sum(dof.astype(jnp.float32) * of.astype(jnp.float32), -1)
    kw = dict(q_offset=q_off, k_offset=k_off, scale=sc, causal=causal,
              block_q=BLOCK_Q, block_kv=BLOCK_KV, interpret=True)
    dq = flash_dq_hop(qf, kf, vf, dof, lse, delta, **kw)
    dk, dv = flash_dkv_hop(qf, kf, vf, dof, lse, delta, **kw)
    return tuple(np.array(x) for x in (lse, delta, dq, dk, dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_kernels(case, dtype):
    lq, lk, causal, q_off, k_off = CASES[case]
    q, k, v = _attn_inputs(lq, lk, dtype)
    do = _attn_inputs(lq, lq, dtype, seed=7)[0]
    lse, delta, dq_j, dk_j, dv_j = _jax_bwd(q, k, v, do, dtype, causal,
                                            q_off, k_off)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    args = (_flat_bhld(q, dtype), _flat_bhld(k, dtype), _flat_bhld(v, dtype),
            _flat_bhld(do, dtype), torch.from_numpy(lse),
            torch.from_numpy(delta))
    dq = tattn.flash_attention_dq(*args, **kw)
    dk, dv = tattn.flash_attention_dkv(*args, **kw)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    tol = BWD_TOL[dtype]
    np.testing.assert_allclose(dq.numpy(), dq_j, atol=tol["dq"], rtol=0)
    np.testing.assert_allclose(dk.numpy(), dk_j, atol=tol["dkv"], rtol=0)
    np.testing.assert_allclose(dv.numpy(), dv_j, atol=tol["dkv"], rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_autograd_matches_jax_grad(case):
    lq, lk, causal, q_off, k_off = CASES[case]
    q, k, v = _attn_inputs(lq, lk, "float32", seed=8)
    w = np.random.default_rng(9).normal(size=(B, lq, H, D)).astype(
        np.float32)

    def loss(q_, k_, v_):
        o = jflash(q_, k_, v_, causal=causal, q_offset=q_off,
                   k_offset=k_off, block_q=BLOCK_Q, block_kv=BLOCK_KV,
                   interpret=True)
        return jnp.sum(o * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tattn.flash_attention(*qkv, causal=causal, q_offset=q_off,
                              k_offset=k_off)
    (o * torch.from_numpy(w)).sum().backward()
    for t, g in zip(qkv, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0)
