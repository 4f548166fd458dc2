"""The arithmetic of the TF32 tensor-core NT-Xent kernels #1 and #5
(``csrc/ntxent_tf32.cuh``) that runs without a card.

* ``column_splits``, the planner of the kernels' grid: every column in
  exactly one non-empty run, the grid at most two waves of 132 SMs and as
  near one as the 32-column grain allows, one run when the row tiles fill
  the card;
* ``tf32_split``, the plain mirror of the operand split: hi keeps 10
  explicit mantissa bits, hi + lo is x bit for bit, and the three-product
  similarity of unit rows is within 2^-20 of fp64 (one TF32 pass is not);
* ``ntxent_fwd_split_plain``, the kernels' split-and-merge order, against
  the Pallas forward ``_fwd_call`` in interpret mode on the same numpy
  inputs: symmetric on a ragged (1000, 96) and general with scattered
  column ids and sentinel padding rows, at 1, 3 and 16 runs.

Tolerance of the last: both sides form the same fp32 products and sum
them in other orders, logits up to 1/T = 10 and lse up to ~17, where one
fp32 ulp is 1.9e-6 -> lse within 1e-6 relative (about an ulp), the loss
per row within 1e-6 absolute.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops.ntxent_pallas import _fwd_call, _gid_column, _pad_rows
from ntxent_tpu_torch.ops import ntxent as N

torch.set_num_threads(1)  # see test_torch_training.py

SMS = 132
T = 0.1
BR, BC = 128, 256  # the Pallas blocks: few interpret steps at 1000 rows


def _unit_rows(rows, d, seed):
    z = np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(512, 512), (128, 512), (8192, 8192),
                                       (2048, 8192), (1000, 1000),
                                       (100, 1000), (2, 2), (300, 40)])
def test_column_splits_cover_every_column_once(rows, cols):
    splits, width = N.column_splits(rows, cols, SMS)
    assert width % N.SPLIT_UNIT == 0
    runs = [range(s * width, min((s + 1) * width, cols))
            for s in range(splits)]
    assert all(len(run) > 0 for run in runs)
    assert sorted(c for run in runs for c in run) == list(range(cols))


@pytest.mark.parametrize("rows,cols", [(512, 512), (128, 512)])
def test_column_splits_fill_about_one_wave(rows, cols):
    """The grid is one or two waves of the SMs at most, and no fuller
    grid of 32-column runs fits in one wave."""
    row_tiles = -(-rows // N.TILE)
    splits, width = N.column_splits(rows, cols, SMS)
    grid = row_tiles * splits
    assert grid <= 2 * SMS
    finest = -(-cols // N.SPLIT_UNIT)
    assert grid >= min(SMS, row_tiles * finest) - row_tiles
    if (rows, cols) == (512, 512):  # 8 row tiles x 16 runs of 32
        assert (splits, width) == (16, 32)


def test_column_splits_keep_one_run_when_the_rows_fill_the_card():
    assert N.column_splits(8192, 8192, SMS) == (1, 8192)
    assert N.column_splits(2048, 8192, SMS) == (4, 2048)


# ---------------------------------------------------------------------------
# The TF32 split
# ---------------------------------------------------------------------------


def _values(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, size=4096))
    ties = 1.0 + np.array([1, 3, 5], dtype=np.float64) * 2.0 ** -11
    return torch.from_numpy(np.concatenate([x, ties, -ties]).astype(
        np.float32))


def test_tf32_split_hi_keeps_ten_mantissa_bits_and_rounds_to_nearest():
    x = _values()
    hi, _ = N.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    # nearest of the two TF32 neighbours (ties away from zero)
    bits = x.view(torch.int32)
    down = (bits & ~0x1FFF).view(torch.float32)
    up = ((bits & ~0x1FFF) + 0x2000).view(torch.float32)
    xd = x.double()
    gap_down, gap_up = (xd - down.double()).abs(), (up.double() - xd).abs()
    want = torch.where(gap_up <= gap_down, up, down)
    assert torch.equal(hi, want)


def test_tf32_split_is_exact():
    x = _values(1)
    hi, lo = N.tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi + lo, x)
    assert torch.equal((hi + lo).view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("d", [1, 5, 96, 128, 256])
def test_three_tf32_products_hold_fp32_accuracy(d):
    """s = hi.hi' + hi.lo' + lo.hi' of unit rows, each product exact (as
    in the tensor core), within 2^-20 of the fp64 dot; one TF32 pass
    (hi.hi') misses that by far at D > 1."""
    z = torch.from_numpy(_unit_rows(64, d, seed=d))
    hi, lo = (t.double() for t in N.tf32_split(z))
    exact = z.double() @ z.double().T
    three = hi @ hi.T + (hi @ lo.T + lo @ hi.T)
    assert (three - exact).abs().max().item() <= 2.0 ** -20
    if d > 1:
        assert (hi @ hi.T - exact).abs().max().item() > 2.0 ** -16


# ---------------------------------------------------------------------------
# The split-and-merge order against the Pallas forward
# ---------------------------------------------------------------------------


def _jax_forward(z_rows, z_cols, row_gid, col_gid, total, n_half):
    """(loss_sum, lse) of ``_fwd_call`` in interpret mode; padding rows
    carry the sentinel id ``total``, padding columns the id ``total``."""
    rows, cols = z_rows.shape[0], z_cols.shape[0]
    pad = math.lcm(BR, BC)
    zr = _pad_rows(jnp.asarray(z_rows), pad)
    zc = _pad_rows(jnp.asarray(z_cols), pad)
    gid = _gid_column(jnp.asarray(row_gid), pad, sentinel=total)
    cg = None
    if col_gid is not None:
        cg = jnp.full((zc.shape[0],), total, jnp.int32)
        cg = cg.at[:cols].set(jnp.asarray(col_gid))
    loss, lse = _fwd_call(zr, zc, gid, br=BR, bc=BC, inv_t=1.0 / T,
                          cols_actual=total, n_half=n_half, interpret=True,
                          col_gid=cg)
    return float(loss), np.asarray(lse)[:rows, 0]


def _splits(cols, count):
    width = -(-cols // count)
    return -(-cols // width), width


def _check(loss_t, lse_t, loss_j, lse_j, rows):
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=1e-6, atol=0)
    assert abs(float(loss_t) - loss_j) / rows <= 1e-6


@pytest.mark.parametrize("count", [1, 3, 16])
def test_split_merge_order_matches_pallas_symmetric(count):
    rows, d = 1000, 96  # ragged: no multiple of 64 or of the Pallas blocks
    z = _unit_rows(rows, d, seed=7)
    loss_j, lse_j = _jax_forward(z, z, np.arange(rows), None, rows,
                                 rows // 2)
    zt = torch.from_numpy(z)
    splits, width = _splits(rows, count)
    loss_t, lse_t = N.ntxent_fwd_split_plain(zt, zt, torch.arange(rows), T,
                                             splits, width)
    _check(loss_t, lse_t, loss_j, lse_j, rows)
    loss_p, lse_p = N.ntxent_fwd_plain(zt, T)  # the same function
    torch.testing.assert_close(lse_t, lse_p, rtol=1e-6, atol=0)


@pytest.mark.parametrize("count", [1, 3, 16])
def test_split_merge_order_matches_pallas_general(count):
    """Scattered column ids of a 2 x 600 problem, rows that share some of
    them and whose positives are among the columns, and sentinel padding
    rows (id = total) that add no loss."""
    rng = np.random.default_rng(11)
    rows, cols, d = 150, 600, 96
    total = 2 * cols
    col_gid = rng.permutation(total)[:cols].astype(np.int32)
    row_gid = np.concatenate([
        (col_gid[:100] + cols) % total,             # positives present
        rng.permutation(total)[:rows - 104],
        np.full(4, total)]).astype(np.int32)        # sentinel padding
    z_rows, z_cols = _unit_rows(rows, d, seed=12), _unit_rows(cols, d, 13)
    loss_j, lse_j = _jax_forward(z_rows, z_cols, row_gid, col_gid, total,
                                 total // 2)
    splits, width = _splits(cols, count)
    loss_t, lse_t = N.ntxent_fwd_split_plain(
        torch.from_numpy(z_rows), torch.from_numpy(z_cols),
        torch.from_numpy(row_gid), T, splits, width,
        col_gid=torch.from_numpy(col_gid), cols_actual=total,
        n_half=total // 2)
    _check(loss_t, lse_t, loss_j, lse_j, rows)
