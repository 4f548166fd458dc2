"""The arithmetic of the triangular NT-Xent kernels #2 (``ntxent_fwd_tri``,
``csrc/ntxent_tri_fwd.cu``) and #3 (``ntxent_bwd_tri``,
``csrc/ntxent_tri_bwd.cu``) on the TF32 walks of ``csrc/dual_tf32.cuh``
and ``csrc/ntxent_tf32.cuh``, which runs without a card:

* the planner ``ops.ntxent.tri_runs``: every upper tile walked exactly
  once, each run (piece) inside one row tile, a row tile's runs numbered
  in column order, every CTA within one tile of the mean, and a stretch
  of a few pieces, for 2N from 2 to 8192 at 132 and 8 SMs;
* ``_emulate_fwd`` repeats #2's order in plain PyTorch: z split into TF32
  hi and lo by ``ops.ntxent.tf32_split``, s as three products (hi.hi,
  then hi.lo + lo.hi added last) times 1/T; over the planner's runs, the
  rows' online (m, l, pos) per run and, for j > i, each column's (max,
  sum) per row tile; the merge folds a row's run partials in run order,
  then its column partials in row-tile order (``fold_partial``), the
  1e-37 floor, and reads the positive where it was formed (row k's runs,
  or row pos(k)'s when pos(k) lies in an earlier block);
* ``_emulate_bwd`` repeats #3's: G (#5's SymG) split into TF32 hi and lo,
  per tile the direct product G_ij.z_j (G_lo.z_hi + G_hi.z_lo, then
  G_hi.z_hi) added into its run's partial, for j > i the transposed
  product G_ij^T.z_i into the tile's own partial, and the sum: a row
  tile's run partials in run order, then the transposed partials of the
  tiles above it in tile order;
* both are held against the Pallas ``_fwd_tri_call`` / ``_bwd_tri_call``
  and the public ``ntxent_loss_fused(..., triangular=True)`` in interpret
  mode on the same numpy inputs: 2N = 512 and 300 (no multiple of 64) at
  D = 128 and 2N = 40 at D = 32 (both views in one tile), fp32 and bf16,
  at the planner's runs (132 SMs: one tile a CTA here; 8 SMs: stretches
  across row tiles) and at one run per row tile;
* one TF32 pass (hi alone, the kernels' control on the card) misses the
  tolerance;
* the sources: #2 runs the dual walk over the plan's pieces, #3 the
  backward walk with the transposed product; no FMA tile, no atomics,
  and ``infonce_tile.cuh`` is gone.

Tolerance: the emulation's products are fp32-accurate (3xTF32 drops
lo.lo, 2^-22 relative) and the Pallas calls' are fp32, summed in other
orders: 1e-5 absolute plus 1e-5 relative on lse, the loss sum over 2N
and the gradient, as the other TF32 kernels' emulations are held
(``test_torch_pair_sm90.py``).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops import ntxent_pallas as jpallas
from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.ops import ntxent as N

torch.set_num_threads(1)  # see test_torch_training.py

TILE = 64
TEMPERATURE = 0.1
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
# (2N, D): chip_smoke.py's path shape, a 2N that is no multiple of 64, and
# N < 64 (both views in one tile)
CASES = {"512": (512, 128), "300": (300, 128), "40": (40, 32)}
PLANS = ("rows", "planner", "planner8")


def _unit(rows, d, seed):
    z = np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


@functools.cache
def _case(case, dtype):
    """(z, loss_sum, lse, grad) as numpy: z from a seed (bf16: values exact
    in bf16, held as fp32 on both sides), then the Pallas ``_fwd_tri_call``
    and, at its lse, ``_bwd_tri_call`` in interpret mode."""
    rows, d = CASES[case]
    z = _unit(rows, d, rows + d)
    if dtype == "bfloat16":
        z = np.array(jnp.asarray(z, jnp.bfloat16).astype(jnp.float32))
    zp = jnp.asarray(np.pad(z, ((0, -rows % TILE), (0, 0))))
    kw = dict(b=TILE, inv_t=1.0 / TEMPERATURE, cols_actual=rows,
              n_half=rows // 2, interpret=True)
    loss, lse = jpallas._fwd_tri_call(zp, **kw)
    grad = jpallas._bwd_tri_call(zp, lse, **kw)
    return (z, float(loss), np.array(lse)[:rows, 0],
            np.array(grad)[:rows])


def _split(x, passes):
    hi, lo = N.tf32_split(x)
    return hi, lo if passes == 3 else torch.zeros_like(lo)


def _exp0(x):
    return torch.exp(torch.clamp(x, max=0.0))


def _fold(m, l, m_c, l_c):
    m_new = torch.maximum(m, m_c)
    return m_new, l * _exp0(m - m_new) + l_c * _exp0(m_c - m_new)


def _s(z, passes):
    """s = z . z^T in the kernels' three products, times 1/T."""
    hi, lo = _split(z.float(), passes)
    return (hi @ hi.T + (hi @ lo.T + lo @ hi.T)) * N._inv_t(TEMPERATURE)


def _rows_plan(rows):
    """One run per row tile, a CTA each."""
    nb = -(-rows // TILE)
    return N.TriRuns(tuple((i, i, nb - i, 0) for i in range(nb)),
                     tuple(range(nb + 1)), (1,) * nb)


def _plan(rows, plan):
    if plan == "rows":
        return _rows_plan(rows)
    return N.tri_runs(rows, 8 if plan == "planner8" else 132)


def _blocks(n):
    return [slice(b, min(b + TILE, n)) for b in range(0, n, TILE)]


def _emulate_fwd(z, runs, passes=3):
    """(loss_sum, lse) in #2's order (``passes=1``: one TF32 pass)."""
    n = z.shape[0]
    nb = -(-n // TILE)
    s = _s(z, passes)
    idx = torch.arange(n)
    pos = (idx + n // 2) % n
    blocks = _blocks(n)
    slots = max(runs.runs_of)
    rm, rl = torch.full((slots, n), NEG_INF), torch.zeros(slots, n)
    rp = torch.zeros(slots, n)
    cm, cl = torch.full((nb, n), NEG_INF), torch.zeros(nb, n)
    for i, j0, tiles, slot in runs.pieces:
        rows = blocks[i]
        m = torch.full((rows.stop - rows.start,), NEG_INF)
        l = torch.zeros_like(m)
        p = torch.zeros_like(m)
        for j in range(j0, j0 + tiles):
            cols = blocks[j]
            x = s[rows, cols]
            hit = idx[cols][None, :] == pos[rows][:, None]
            p = p + torch.where(hit, x, torch.zeros_like(x)).sum(dim=1)
            xr = x.masked_fill(idx[cols][None, :] == idx[rows][:, None],
                               NEG_INF)
            m_new = torch.maximum(m, xr.amax(dim=1))
            l = l * torch.exp(m - m_new) + _exp0(xr - m_new[:, None]).sum(1)
            m = m_new
            if j > i:  # the column pass: every row < 2N, none a column
                m_c = x.amax(dim=0)
                cm[i, cols] = m_c
                cl[i, cols] = _exp0(x - m_c[None, :]).sum(dim=0)
        rm[slot, rows], rl[slot, rows], rp[slot, rows] = m, l, p
    lse = torch.empty(n)
    for b, rows in enumerate(blocks):
        m = torch.full((rows.stop - rows.start,), NEG_INF)
        l = torch.zeros_like(m)
        for slot in range(runs.runs_of[b]):
            m, l = _fold(m, l, rm[slot, rows], rl[slot, rows])
        for t in range(b):
            m, l = _fold(m, l, cm[t, rows], cl[t, rows])
        lse[rows] = m + torch.log(torch.clamp(l, min=1e-37))
    owner = torch.where(pos // TILE >= idx // TILE, idx, pos)
    positive = torch.stack([rp[:runs.runs_of[o // TILE], o].sum()
                            for o in owner.tolist()])
    return (lse - positive).sum(), lse


def _emulate_bwd(z, lse, runs, passes=3):
    """G @ z in #3's order (``passes=1``: one TF32 pass)."""
    n, d = z.shape
    idx = torch.arange(n)
    pos = (idx + n // 2) % n
    x = _s(z, passes).masked_fill(idx[:, None] == idx[None, :], NEG_INF)
    onehot = (idx[None, :] == pos[:, None]).float()
    g = ((_exp0(x - lse[:, None]) - onehot)
         + (_exp0(x - lse[None, :]) - onehot))
    g_hi, g_lo = _split(g, passes)
    z_hi, z_lo = _split(z.float(), passes)
    blocks = _blocks(n)
    part = torch.zeros(max(runs.runs_of), n, d)
    trans = {}
    for i, j0, tiles, slot in runs.pieces:
        rows = blocks[i]
        acc = torch.zeros(rows.stop - rows.start, d)
        for j in range(j0, j0 + tiles):
            cols = blocks[j]
            gh, gl = g_hi[rows, cols], g_lo[rows, cols]
            acc = acc + ((gl @ z_hi[cols] + gh @ z_lo[cols])
                         + gh @ z_hi[cols])
            if j > i:
                trans[i, j] = ((gl.T @ z_hi[rows] + gh.T @ z_lo[rows])
                               + gh.T @ z_hi[rows])
        part[slot, rows] = acc
    grad = torch.empty(n, d)
    for b, rows in enumerate(blocks):
        out = part[0, rows]
        for slot in range(1, runs.runs_of[b]):
            out = out + part[slot, rows]
        for t in range(b):
            out = out + trans[t, b]
        grad[rows] = out
    return grad


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------


def _check_plan(rows, sms, runs):
    nb = -(-rows // TILE)
    tiles = nb * (nb + 1) // 2
    ctas = min(sms, tiles)
    assert len(runs.cta_start) == ctas + 1
    assert runs.cta_start[0] == 0 and runs.cta_start[-1] == len(runs.pieces)
    seen = set()
    for i, j0, length, _ in runs.pieces:
        assert length >= 1 and i <= j0 and j0 + length <= nb
        for j in range(j0, j0 + length):
            assert (i, j) not in seen
            seen.add((i, j))
    assert len(seen) == tiles  # every upper tile exactly once
    stretch = -(-tiles // ctas)
    for b in range(ctas):
        mine = runs.pieces[runs.cta_start[b]:runs.cta_start[b + 1]]
        assert tiles // ctas <= sum(p[2] for p in mine) <= stretch
        # a long row tile and a short one hold nb + 1 tiles together
        assert len(mine) <= 2 * -(-stretch // (nb + 1)) + 2
    for i in range(nb):
        mine = sorted((p for p in runs.pieces if p[0] == i),
                      key=lambda p: p[1])
        assert [p[3] for p in mine] == list(range(runs.runs_of[i]))
    assert max(p[2] for p in runs.pieces) <= stretch


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("rows", [2, 40, 64, 66, 128, 300, 512, 1000, 4096,
                                  8190, 8192])
def test_planner_walks_every_upper_tile_once(rows, sms):
    """Every upper tile in exactly one run, each run in one row tile,
    slots in column order; the busiest CTA within one tile of the mean
    (the longest run no longer), a stretch at most 2 ceil(stretch / (nb +
    1)) + 2 pieces. At 2N = 8192 and 132 SMs: 8256 tiles, 62-63 a CTA
    (the mean 62.5), at most 3 pieces."""
    _check_plan(rows, sms, N.tri_runs(rows, sms))


@pytest.mark.parametrize("sms", [132, 8])
def test_planner_balances_every_even_2n(sms):
    """2N from 2 to 8192: every CTA walks floor or ceil of tiles / CTAs,
    in one wave of min(sms, tiles) CTAs."""
    for rows in range(2, 8194, 2):
        runs = N.tri_runs(rows, sms)
        nb = -(-rows // TILE)
        tiles = nb * (nb + 1) // 2
        per = runs.cta_tiles()
        assert len(per) == min(sms, tiles) and sum(per) == tiles
        assert max(per) - min(per) <= 1, rows


def test_plan_table_is_what_the_kernels_read():
    """``TriPlan``'s layout: the pieces' four ints, the CTA starts, the
    runs of each row tile."""
    runs = N.tri_runs(300, 8)
    table = runs.table()
    n = len(runs.pieces)
    assert table[:4 * n] == [x for p in runs.pieces for x in p]
    assert table[4 * n:4 * n + 9] == list(runs.cta_start)
    assert table[4 * n + 9:] == list(runs.runs_of) and len(runs.runs_of) == 5


# ---------------------------------------------------------------------------
# The kernels' order against the Pallas calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_forward_matches_the_pallas_call(case, dtype, plan):
    z, loss_j, lse_j, _ = _case(case, dtype)
    zt = torch.from_numpy(z)
    loss, lse = _emulate_fwd(zt, _plan(len(z), plan))
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    np.testing.assert_allclose(loss.item() / len(z), loss_j / len(z), **TOL)
    # the emulation and the plain version are the same function
    loss_p, lse_p = N.ntxent_fwd_tri_plain(zt, TEMPERATURE)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), **TOL)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_backward_matches_the_pallas_call(case, dtype, plan):
    z, _, lse_j, grad_j = _case(case, dtype)
    zt, lse = torch.from_numpy(z), torch.from_numpy(lse_j)
    grad = _emulate_bwd(zt, lse, _plan(len(z), plan))
    np.testing.assert_allclose(grad.numpy(), grad_j, **TOL)
    plain = N.ntxent_bwd_tri_plain(zt, lse, TEMPERATURE)
    np.testing.assert_allclose(grad.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulations_give_the_public_triangular_loss(case):
    """The mean loss and its gradient of JAX's ``ntxent_loss_fused(...,
    triangular=True)`` from the emulated #2 and #3 at the planner's runs:
    loss_sum / 2N and G z / (2N T)."""
    z, _, _, _ = _case(case, "float32")
    rows = len(z)
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jpallas.ntxent_loss_fused(x, TEMPERATURE, triangular=True,
                                            interpret=True))(jnp.asarray(z))
    zt = torch.from_numpy(z)
    runs = N.tri_runs(rows, 8)
    loss, lse = _emulate_fwd(zt, runs)
    grad = _emulate_bwd(zt, lse, runs) / (rows * TEMPERATURE)
    np.testing.assert_allclose(loss.item() / rows, float(loss_j), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), **TOL)


def _limit(want):
    return TOL["atol"] + TOL["rtol"] * np.abs(want).max()


@pytest.mark.parametrize("case", ["512", "300"])
def test_one_tf32_pass_misses_the_forward_tolerance(case):
    """The kernels' control on the card: every product of hi alone errs
    at least 10x more on lse than the three-product emulation, and beyond
    the tolerance."""
    z, _, lse_j, _ = _case(case, "float32")
    zt, runs = torch.from_numpy(z), N.tri_runs(len(z), 132)
    three = np.abs(_emulate_fwd(zt, runs)[1].numpy() - lse_j).max()
    one = np.abs(_emulate_fwd(zt, runs, passes=1)[1].numpy() - lse_j).max()
    assert 10 * three <= one
    assert one > _limit(lse_j)


@pytest.mark.parametrize("case", ["512", "300"])
def test_one_tf32_pass_misses_the_backward_tolerance(case):
    z, _, lse_j, grad_j = _case(case, "float32")
    zt, lse = torch.from_numpy(z), torch.from_numpy(lse_j)
    runs = N.tri_runs(len(z), 132)
    three = np.abs(_emulate_bwd(zt, lse, runs).numpy() - grad_j).max()
    one = np.abs(_emulate_bwd(zt, lse, runs, passes=1).numpy()
                 - grad_j).max()
    assert 10 * three <= one
    assert one > _limit(grad_j)


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------


def _kernels(text):
    return re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                      r"\s+(\w+)\(", text)


def _body(text, start):
    at = text.index(start)
    return text[at:text.index("\n}\n", at)]


CSRC = _build.SOURCES["ntxent_tri_fwd"].parent


def test_tri_forward_forms_each_s_tile_once_on_the_dual_walk():
    """#2 is the dual walk of ``dual_tf32.cuh`` (#9's and #7's) over the
    plan's pieces with the symmetric masks, launched through
    ``fwd_launch``: one ``s_tile`` a tile, folded into the rows and, off
    the diagonal (``Pieces::kSelf``), the columns; prep, walk, merge,
    reduce."""
    text = _build.SOURCES["ntxent_tri_fwd"].read_text()
    assert '#include "dual_tf32.cuh"' in text
    walk = _body(text, "    ntxent_fwd_tri_walk(")
    assert "TriMask mask{" in walk
    assert "dual_walk<kSplit, true>(" in walk and "TriPieces(a.plan, n)" in walk
    assert text.count("fwd_launch<T>(") == 1 and "plan.ctas);" in text
    mask = _body(text, "struct TriMask {")
    assert "c < ce && c != row[h]" in mask  # rows
    assert "row[h] < n && c != row[h]" in mask  # columns
    header = (CSRC / "dual_tf32.cuh").read_text()
    dual = _body(header, "__device__ __forceinline__ void dual_walk(")
    assert dual.count("s_tile<kSplit>(") == 1
    assert "if (!Pieces::kSelf || col0 != row0)" in dual
    assert "mask.row_pos(" in dual and "wait_rows_free(" in dual
    merge = _body(text, "    ntxent_fwd_tri_merge(")
    assert merge.count("fold_partial(") == 2 and "1e-37f" in merge
    assert sorted(_kernels(text)) == sorted([
        "ntxent_fwd_tri_prep", "ntxent_fwd_tri_walk", "ntxent_fwd_tri_merge",
        "ntxent_fwd_tri_reduce"])
    assert 'extern "C" long long ntx_ntxent_tri_fwd_scratch(' in text


def test_tri_backward_makes_both_products_from_one_s():
    """#3 is #5's backward walk (``bwd_walk_pieces``, which
    ``bwd_walk_at`` runs for the split grids) with SymG over the plan's
    pieces: one ``s_tile`` a tile, the direct product with G as the
    register A operand and, off the diagonal, the transposed product with
    G^T from shared memory (``store_gt``); prep, walk, sum."""
    text = _build.SOURCES["ntxent_tri_bwd"].read_text()
    assert '#include "ntxent_tf32.cuh"' in text
    walk = _body(text, "    ntxent_bwd_tri_walk(")
    assert "SymG g{" in walk and "TriPieces(plan, n)" in walk
    assert "bwd_walk_pieces<kSplit, ND>(" in walk
    header = (CSRC / "ntxent_tf32.cuh").read_text()
    pieces = _body(header, "__device__ __forceinline__ void bwd_walk_pieces(")
    assert pieces.count("s_tile<kSplit>(") == 1
    assert pieces.count("mma_tf32_rs<ND>(") == 3  # direct: register A
    assert pieces.count("mma_tf32_ss<ND>(") == 3  # transposed: G^T in smem
    assert "store_gt(gt, g_hi, g_lo, r, q)" in pieces
    assert "kTrans && col0 != row0" in pieces
    at = _body(header, "__device__ __forceinline__ void bwd_walk_at(")
    assert "bwd_walk_pieces<kSplit, ND>(" in at
    store = _body(header, "__device__ __forceinline__ void store_gt(")
    assert "fence_async_shared();" in store
    assert store.count("consumers_sync();") == 2
    assert "struct SymG {" in header
    assert "struct SymG {" not in _build.SOURCES["ntxent_bwd_sym"].read_text()
    assert sorted(_kernels(text)) == sorted([
        "ntxent_bwd_tri_prep", "ntxent_bwd_tri_walk", "ntxent_bwd_tri_sum"])
    assert 'extern "C" long long ntx_ntxent_tri_bwd_scratch(' in text


@pytest.mark.parametrize("source", ["ntxent_tri_fwd", "ntxent_tri_bwd"])
def test_no_fma_tile_is_left(source):
    text = _build.SOURCES[source].read_text()
    for fma in ("infonce_tile.cuh", "tile_products", "fmaf(", "atomicAdd"):
        assert fma not in text, fma
    assert not (CSRC / "infonce_tile.cuh").exists()
    for path in sorted(CSRC.glob("*.cu*")):
        assert "infonce_tile.cuh" not in path.read_text(), path.name
