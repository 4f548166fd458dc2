"""The arithmetic of the shard-pair kernels #7 (``block_lse_dual``,
``csrc/ntxent_dual_stats.cu``) and #8 (``block_grads_dual``,
``csrc/ntxent_dual_grads.cu``) of ``--dp-loss pair`` on the TF32 walks of
``csrc/dual_tf32.cuh`` and ``csrc/ntxent_tf32.cuh``, which runs without a
card:

* ``_emulate_stats`` repeats #7's order in plain PyTorch: z_rows and
  z_cols split into TF32 hi and lo by ``ops.ntxent.tf32_split``, s as
  three products (hi.hi, then hi.lo + lo.hi added last) times 1/T, formed
  once; each direction masked by the OTHER side's id (>= total, or equal
  to this side's); the rows online over the 64-column tiles of each split
  of ``column_splits``, one (m, l) partial per row and split; the columns
  one (max, sum) partial per 64-row tile; both folded in order
  (``fold_partial``) with the 1e-37 floor;
* ``_emulate_grads`` repeats #8's: each side's own s (the column owners
  form s^T with the operands swapped), G of the ``PairG`` policy, G split
  into TF32 hi and lo, a fresh accumulator per 64-column tile of the
  other side (G_lo.z_hi + G_hi.z_lo, then G_hi.z_hi) added into the
  split's sum, the splits added in order (``dual_grads_splits``);
* both are held against the Pallas ``block_lse_dual`` and
  ``block_grads_dual`` in interpret mode on the same numpy inputs: the
  world-1 self tile (512, 512, 128), the k = 1 tile of rank 0 of a world
  of 4 (128, 128, 128), and a ragged (100, 260, 96) with scattered ids,
  20 ids shared by rows and columns and sentinel rows and columns, fp32
  and bf16, at one split and at the planner's;
* one TF32 pass (hi alone, the kernels' control on the card) misses the
  tolerance, and so does a self mask taken from the diagonal instead of
  the ids;
* the sources: #7 runs the dual walk through ``fwd_launch`` and forms s
  once a tile for both directions, #8 runs both sides' ``bwd_walk_at`` in
  one grid with ``PairG``; neither includes the FMA headers, and
  ``infonce_grad.cuh`` is gone.

Tolerance: the emulation's products are fp32-accurate (3xTF32 drops
lo.lo, 2^-22 relative) and the Pallas calls' are fp32, summed in other
orders: 1e-5 absolute plus 1e-5 relative on lse_rows, lse_cols and both
gradients, as the other TF32 kernels' emulations are held
(``test_torch_infonce_dual_sm90.py``).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops.ntxent_pallas import block_grads_dual as pallas_grads
from ntxent_tpu.ops.ntxent_pallas import block_lse_dual as pallas_lse
from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.ops import ntxent as N
from ntxent_tpu_torch.parallel.mesh import local_row_gids

torch.set_num_threads(1)  # see test_torch_training.py

SMS = 132
TILE = 64
TEMPERATURE = 0.1
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
# (R, C, D, world): the world-1 self tile of --dp-loss pair at batch 256,
# the k = 1 tile of rank 0 of a world of 4 at global batch 256, and a
# ragged tile (world None) with scattered, shared and sentinel ids
# (chip_smoke.py's PAIR_CASES).
CASES = {"self": (512, 512, 128, 1),
         "r4": (128, 128, 128, 4),
         "ragged": (100, 260, 96, None)}
# (R, C, D) of chip_smoke.py's #7 and #8 shapes
PATH_SHAPES = [(512, 512, 128), (128, 128, 128), (2048, 2048, 128),
               (100, 260, 96)]


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _ids(rows, cols, world):
    """(row ids, column ids, total) as numpy: rank 0's rows against shard
    (1 mod world)'s columns, or, for world None, ids scattered over 4 (R +
    C) with 20 shared by rows and columns (self entries off the diagonal),
    two sentinel rows and three sentinel columns (chip_smoke.py's
    ``_pair_ids``)."""
    if world is not None:
        rid = local_row_gids(0, rows // 2, world)
        cid = local_row_gids(1 % world, cols // 2, world)
        return (rid.numpy().astype(np.int32), cid.numpy().astype(np.int32),
                rows * world)
    total = 4 * (rows + cols)
    perm = np.random.default_rng(rows).permutation(total).astype(np.int32)
    rid = perm[:rows].copy()
    cid = np.concatenate([perm[rows - 20:rows], perm[rows:rows + cols - 20]])
    rid[[3, 50]] = total
    cid[[7, 8, 200]] = total
    return rid, cid, total


@functools.cache
def _case(case, dtype):
    """(z_rows, z_cols, row ids, column ids, total, lse_rows, lse_cols,
    grad_rows, grad_cols) as numpy: the inputs from a seed, then the Pallas
    ``block_lse_dual`` and, at its lse, ``block_grads_dual`` in interpret
    mode."""
    rows, cols, d, world = CASES[case]
    rng = np.random.default_rng(rows + cols + d)
    zr, zc = _unit(rng, rows, d), _unit(rng, cols, d)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        zr = np.array(jnp.asarray(zr, jnp.bfloat16).astype(jnp.float32))
        zc = np.array(jnp.asarray(zc, jnp.bfloat16).astype(jnp.float32))
    rid, cid, total = _ids(rows, cols, world)
    args = tuple(jnp.asarray(x) for x in (zr, zc, rid, cid))
    lse_r, lse_c = pallas_lse(*args, TEMPERATURE, total, interpret=True)
    g_r, g_c = pallas_grads(*args, lse_r, lse_c, TEMPERATURE, total,
                            interpret=True)
    return (zr, zc, rid, cid, total, np.array(lse_r), np.array(lse_c),
            np.array(g_r), np.array(g_c))


def _torch_case(case, dtype):
    zr, zc, rid, cid, total, *want = _case(case, dtype)
    return ((torch.from_numpy(zr), torch.from_numpy(zc),
             torch.from_numpy(rid), torch.from_numpy(cid), total),
            [torch.from_numpy(x) for x in want])


def _split(x, passes):
    hi, lo = N.tf32_split(x)
    return hi, lo if passes == 3 else torch.zeros_like(lo)


def _exp0(x):
    return torch.exp(torch.clamp(x, max=0.0))


def _fold(m, l, m_c, l_c):
    m_new = torch.maximum(m, m_c)
    return m_new, l * _exp0(m - m_new) + l_c * _exp0(m_c - m_new)


def _s(own, other, passes):
    """s = own . other^T in the kernels' three products."""
    o_hi, o_lo = _split(own.float(), passes)
    t_hi, t_lo = _split(other.float(), passes)
    return o_hi @ t_hi.T + (o_hi @ t_lo.T + o_lo @ t_hi.T)


def _self_hit(own_id, oth_id, diagonal=False):
    """Which entries are a vector against itself: equal ids (the kernels'
    rule) or, for a control, the diagonal."""
    if diagonal:
        return (torch.arange(len(own_id))[:, None]
                == torch.arange(len(oth_id))[None, :])
    return own_id.long()[:, None] == oth_id.long()[None, :]


def _emulate_stats(zr, zc, rid, cid, total, splits, width, passes=3,
                   diagonal=False):
    """(lse_rows, lse_cols) in #7's order. ``passes=1``: every product of
    hi alone (one TF32 pass); ``diagonal``: the self mask on the diagonal
    instead of the ids."""
    n_r, n_c = zr.shape[0], zc.shape[0]
    s = _s(zr, zc, passes) * N._inv_t(TEMPERATURE)
    hit = _self_hit(rid, cid, diagonal)
    s_row = s.masked_fill((cid.long()[None, :] >= total) | hit, NEG_INF)
    s_col = s.masked_fill((rid.long()[:, None] >= total) | hit, NEG_INF)
    # the rows: online over each split's 64-column tiles
    m = torch.full((n_r,), NEG_INF)
    l = torch.zeros(n_r)
    for start in range(0, splits * width, width):
        end = min(start + width, n_c)
        m_s = torch.full((n_r,), NEG_INF)
        l_s = torch.zeros(n_r)
        for c0 in range(start, end, TILE):
            x = s_row[:, c0:min(c0 + TILE, end)]
            m_new = torch.maximum(m_s, x.amax(dim=1))
            l_s = (l_s * torch.exp(m_s - m_new)
                   + _exp0(x - m_new[:, None]).sum(dim=1))
            m_s = m_new
        m, l = _fold(m, l, m_s, l_s)
    lse_rows = m + torch.log(torch.clamp(l, min=1e-37))
    # the columns: one partial per 64-row tile of z_rows
    m = torch.full((n_c,), NEG_INF)
    l = torch.zeros(n_c)
    for r0 in range(0, n_r, TILE):
        x = s_col[r0:r0 + TILE]
        m_c = x.amax(dim=0)
        m, l = _fold(m, l, m_c, _exp0(x - m_c[None, :]).sum(dim=0))
    return lse_rows, m + torch.log(torch.clamp(l, min=1e-37))


def _emulate_grads(side, zr, zc, rid, cid, total, lse_r, lse_c, splits,
                   width, passes=3, diagonal=False):
    """grad_rows (``side="rows"``) or grad_cols (``"cols"``) in #8's
    order: PairG with own = the side that owns the output."""
    own, other = (zr, zc) if side == "rows" else (zc, zr)
    own_id, oth_id = (rid, cid) if side == "rows" else (cid, rid)
    own_lse, oth_lse = (lse_r, lse_c) if side == "rows" else (lse_c, lse_r)
    x = _s(own, other, passes) * N._inv_t(TEMPERATURE)
    iid, oid = own_id.long()[:, None], oth_id.long()[None, :]
    hit = _self_hit(own_id, oth_id, diagonal)
    x_own = x.masked_fill((oid >= total) | hit, NEG_INF)
    x_oth = x.masked_fill((iid >= total) | hit, NEG_INF)
    g = (_exp0(x_own - own_lse[:, None]) * (iid < total).float()
         + _exp0(x_oth - oth_lse[None, :]) * (oid < total).float())
    g_hi, g_lo = _split(g, passes)
    oth_hi, oth_lo = _split(other.float(), passes)
    n_other = other.shape[0]
    out = None
    for start in range(0, splits * width, width):
        end = min(start + width, n_other)
        part = torch.zeros(own.shape)
        for c0 in range(start, end, TILE):
            c1 = min(c0 + TILE, end)
            part = part + ((g_lo[:, c0:c1] @ oth_hi[c0:c1]
                            + g_hi[:, c0:c1] @ oth_lo[c0:c1])
                           + g_hi[:, c0:c1] @ oth_hi[c0:c1])
        out = part if out is None else out + part
    return out


def _stats_plan(case, plan):
    rows, cols, _, _ = CASES[case]
    if plan == "one":
        return 1, -(-cols // N.SPLIT_UNIT) * N.SPLIT_UNIT
    return N.column_splits(rows, cols, SMS)


def _grads_plan(case, plan, side):
    rows, cols, d, _ = CASES[case]
    if plan == "one":
        other = cols if side == "rows" else rows
        return 1, -(-other // N.SPLIT_UNIT) * N.SPLIT_UNIT
    return N.dual_grads_splits(rows, cols, d, SMS)[side == "cols"]


@pytest.mark.parametrize("plan", ["one", "planner"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_stats_match_the_pallas_call(case, dtype, plan):
    args, (lse_r, lse_c, _, _) = _torch_case(case, dtype)
    got = _emulate_stats(*args, *_stats_plan(case, plan))
    np.testing.assert_allclose(got[0].numpy(), lse_r.numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), lse_c.numpy(), **TOL)
    # the emulation and the plain version are the same function
    plain = N.block_lse_dual_plain(*args[:4], TEMPERATURE, args[4])
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), **TOL)


@pytest.mark.parametrize("plan", ["one", "planner"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_grads_match_the_pallas_call(case, dtype, plan):
    args, (lse_r, lse_c, g_r, g_c) = _torch_case(case, dtype)
    got = [_emulate_grads(side, *args, lse_r, lse_c,
                          *_grads_plan(case, plan, side))
           for side in ("rows", "cols")]
    np.testing.assert_allclose(got[0].numpy(), g_r.numpy(), **TOL)
    np.testing.assert_allclose(got[1].numpy(), g_c.numpy(), **TOL)
    plain = N.block_grads_dual_plain(*args[:4], lse_r, lse_c, TEMPERATURE,
                                     args[4])
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), **TOL)


def _max_err(got, want):
    return max(np.abs(g.numpy() - w.numpy()).max()
               for g, w in zip(got, want))


def _limit(want):
    return TOL["atol"] + TOL["rtol"] * max(np.abs(w.numpy()).max()
                                           for w in want)


@pytest.mark.parametrize("case", ["self", "ragged"])
def test_one_tf32_pass_misses_the_stats_tolerance(case):
    """The kernels' control on the card: every product of hi alone errs
    at least 10x more on both lse than the three-product emulation, and
    beyond the tolerance."""
    args, (lse_r, lse_c, _, _) = _torch_case(case, "float32")
    plan = _stats_plan(case, "planner")
    three = _max_err(_emulate_stats(*args, *plan), (lse_r, lse_c))
    one = _max_err(_emulate_stats(*args, *plan, passes=1), (lse_r, lse_c))
    assert 10 * three <= one
    assert one > _limit((lse_r, lse_c))


@pytest.mark.parametrize("case", ["self", "ragged"])
def test_one_tf32_pass_misses_the_grads_tolerance(case):
    args, (lse_r, lse_c, g_r, g_c) = _torch_case(case, "float32")

    def grads(passes):
        return [_emulate_grads(side, *args, lse_r, lse_c,
                               *_grads_plan(case, "planner", side),
                               passes=passes)
                for side in ("rows", "cols")]

    three, one = _max_err(grads(3), (g_r, g_c)), _max_err(grads(1),
                                                          (g_r, g_c))
    assert 10 * three <= one
    assert one > _limit((g_r, g_c))


def test_the_self_mask_follows_the_ids_not_the_diagonal():
    """The ragged tile's shared ids sit off the diagonal (20 shared, two
    of them turned sentinel columns): a self mask taken from the diagonal
    misses the Pallas calls in both kernels."""
    args, (lse_r, lse_c, g_r, g_c) = _torch_case("ragged", "float32")
    rid, cid, total = args[2].long(), args[3].long(), args[4]
    hits = ((rid[:, None] == cid[None, :])
            & (rid[:, None] < total)).nonzero()
    assert len(hits) == 18 and bool((hits[:, 0] != hits[:, 1]).all())
    lse = _emulate_stats(*args, *_stats_plan("ragged", "planner"),
                         diagonal=True)
    assert _max_err(lse, (lse_r, lse_c)) > 1e-3
    grads = [_emulate_grads(side, *args, lse_r, lse_c,
                            *_grads_plan("ragged", "planner", side),
                            diagonal=True)
             for side in ("rows", "cols")]
    assert _max_err(grads, (g_r, g_c)) > 1e-3


def test_sentinel_vectors_keep_their_own_direction():
    """A real row or column whose id is the sentinel gets its lse over the
    other side's entries, as the TPU kernel computes it, and no gradient
    (valid = 0, and the other direction masks it)."""
    args, (lse_r, lse_c, g_r, g_c) = _torch_case("ragged", "float32")
    rid, cid, total = args[2], args[3], args[4]
    rows, cols = (rid >= total).nonzero()[:, 0], (cid >= total).nonzero()[:, 0]
    assert rows.tolist() == [3, 50] and cols.tolist() == [7, 8, 200]
    got_r, got_c = _emulate_stats(*args, *_stats_plan("ragged", "planner"))
    assert bool((got_r[rows] > 0).all()) and bool((got_c[cols] > 0).all())
    np.testing.assert_allclose(got_r[rows].numpy(), lse_r[rows].numpy(),
                               **TOL)
    np.testing.assert_allclose(got_c[cols].numpy(), lse_c[cols].numpy(),
                               **TOL)
    gr = _emulate_grads("rows", *args, lse_r, lse_c,
                        *_grads_plan("ragged", "planner", "rows"))
    gc = _emulate_grads("cols", *args, lse_r, lse_c,
                        *_grads_plan("ragged", "planner", "cols"))
    assert not gr[rows].any() and not gc[cols].any()
    assert not g_r.numpy()[rows.numpy()].any()
    assert not g_c.numpy()[cols.numpy()].any()


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_plans_cover_the_other_side_once(shape):
    """#7 cuts z_cols's columns as ``column_splits`` plans; #8 cuts each
    side's other side as ``dual_grads_splits`` plans, both sides together
    near one wave of the SMs."""
    rows, cols, d = shape
    plans = [(N.column_splits(rows, cols, SMS), cols)]
    (s_r, w_r), (s_c, w_c) = N.dual_grads_splits(rows, cols, d, SMS)
    plans += [((s_r, w_r), cols), ((s_c, w_c), rows)]
    ctas = (-(-rows // TILE) * s_r + -(-cols // TILE) * s_c) \
        * N._d_chunks(d)
    assert ctas <= 2 * SMS or (s_r, s_c) == (1, 1)
    for (splits, width), n in plans:
        assert width % N.SPLIT_UNIT == 0
        runs = [range(s * width, min((s + 1) * width, n))
                for s in range(splits)]
        assert all(len(run) > 0 for run in runs)
        assert sorted(c for run in runs for c in run) == list(range(n))


def _kernels(text):
    return re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                      r"\s+(\w+)\(", text)


def _body(text, start):
    at = text.index(start)
    return text[at:text.index("\n}\n", at)]


CSRC = _build.SOURCES["ntxent_dual_stats"].parent


def test_dual_stats_forms_each_s_tile_once_for_both_directions():
    """#7 is the dual walk of ``dual_tf32.cuh`` with the pair masks,
    launched through ``fwd_launch``: one ``s_tile`` a column tile, the
    column pass reading the column mask and the row pass the row mask of
    the same registers; prep, walk and merge."""
    text = _build.SOURCES["ntxent_dual_stats"].read_text()
    assert '#include "dual_tf32.cuh"' in text
    walk = _body(text, "    ntxent_dual_stats_walk(")
    assert "PairMask mask{" in walk
    assert "dual_walk<kSplit, false>(" in walk
    assert text.count("fwd_launch<T>(") == 1
    assert "cuTensorMapEncode" not in text and "tensor_map_f32" not in text
    mask = _body(text, "struct PairMask {")
    assert "cid[j] < total && cid[j] != rid[h]" in mask  # rows
    assert "rid[h] < total && rid[h] != cid[j]" in mask  # columns
    header = (CSRC / "dual_tf32.cuh").read_text()
    dual = _body(header, "__device__ __forceinline__ void dual_walk(")
    assert dual.count("s_tile<kSplit>(") == 1
    assert dual.count("mask.col_in(") == 2 and dual.count("mask.row_in(") == 1
    assert "online_rows(" in dual and dual.count("consumers_sync()") == 2
    assert sorted(_kernels(text)) == sorted([
        "ntxent_dual_stats_prep", "ntxent_dual_stats_walk",
        "ntxent_dual_stats_merge"])
    assert 'extern "C" long long ntx_ntxent_dual_stats_scratch(' in text


def test_dual_grads_runs_both_sides_in_one_grid():
    """#8 is one prep, one walk launch whose CTAs take PairG as the row
    owners or, with the operands and ids swapped, as the column owners
    (bwd_walk_at), and one split sum, through #10's ``dual_bwd_launch``."""
    text = _build.SOURCES["ntxent_dual_grads"].read_text()
    assert '#include "dual_tf32.cuh"' in text
    walk = _body(text, "    ntxent_dual_grads_walk(")
    assert walk.count("PairG g{") == 2
    assert walk.count("bwd_walk_at<kSplit, ND>(") == 2
    assert "PairG g{in.row_gid, in.col_gid, in.lse_rows, in.lse_cols," in walk
    assert "PairG g{in.col_gid, in.row_gid, in.lse_cols, in.lse_rows," in walk
    assert text.count("dual_bwd_launch<T, ND>(") == 1
    assert "cuTensorMapEncode" not in text and "<<<" not in text
    assert sorted(_kernels(text)) == sorted([
        "ntxent_dual_grads_prep", "ntxent_dual_grads_walk",
        "ntxent_dual_grads_sum"])
    assert 'extern "C" long long ntx_ntxent_dual_grads_scratch(' in text
    # #10 launches through the same code
    square = _build.SOURCES["infonce_dual_bwd"].read_text()
    assert square.count("dual_bwd_launch<T, ND>(") == 1


@pytest.mark.parametrize("source", ["ntxent_dual_stats", "ntxent_dual_grads"])
def test_no_fma_walk_is_left(source):
    text = _build.SOURCES[source].read_text()
    for fma in ("infonce_tile.cuh", "infonce_grad.cuh", "tile_products",
                "grad_rows<", "opt_in_smem", "fmaf(", "atomicAdd"):
        assert fma not in text, fma
    assert not (CSRC / "infonce_grad.cuh").exists()
