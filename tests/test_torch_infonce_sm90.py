"""The arithmetic of the data-parallel CLIP backward kernels #5 (its
cross-modal mode, ``ntx_infonce_bwd_rows``) and #4
(``ntx_infonce_bwd_cols``) on the TF32 walk (``csrc/infonce_cross_bwd.cuh``
over ``csrc/ntxent_tf32.cuh``), which runs without a card:

* ``_emulate`` repeats the kernels' order in plain PyTorch: the operands
  split into TF32 hi and lo by ``ops.ntxent.tf32_split``, s as three
  products (hi.hi, then hi.lo + lo.hi added last), G from the policy of
  each side (``CrossRowsG``, ``CrossColsG``) split in its turn, a fresh
  accumulator per 64-column tile of the other side (G_lo.z_hi + G_hi.z_lo,
  then G_hi.z_hi) added into the split's sum, and the splits' partials
  added in split order. It is held against the Pallas calls
  ``_bwd_sym_call(..., diag_pos=True, z_cols=, lse_cols=)`` and
  ``_bwd_sym_cols_call`` in interpret mode on the same numpy inputs and
  lse, at one split and at the planner's, on aligned, padded and
  scattered-id shapes with a padding row (id = n_c) whose column term
  stays, and one of several 64-column tiles, fp32 and bf16;
* one TF32 pass (hi alone, the kernels' control on the card) misses the
  tolerance by far, and the rule of #6's policies (a row whose id is
  >= n_c adds nothing) misses it at the padding row;
* ``general_bwd_splits``, the planner of both sides, covers the other
  side once;
* the sources: both entry points launch ``bwd_walk`` through
  ``infonce_cross_bwd.cuh`` with the scratch and split arguments (the
  square #10 runs these walks too: ``test_torch_infonce_dual_sm90``), and
  the FMA walk of ``infonce_grad.cuh`` is gone with its last caller, #8
  (now on the TF32 walk: ``test_torch_pair_sm90``).

Tolerance: the emulation's products are fp32-accurate (3xTF32 drops
lo.lo, 2^-22 relative) and the Pallas calls' are fp32, summed in other
orders: 1e-5 absolute plus 1e-5 relative on o_a and o_b, as the plain
versions are held (``test_torch_clip_dp.py``).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops.blocks import choose_blocks
from ntxent_tpu.ops.infonce_pallas import _dual_fwd_call
from ntxent_tpu.ops.ntxent_pallas import (
    _bwd_sym_call,
    _bwd_sym_cols_call,
    _gid_column,
    _pad_rows,
)
from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.ops import infonce as I
from ntxent_tpu_torch.ops import ntxent as N

torch.set_num_threads(1)  # see test_torch_training.py

SMS = 132
TILE = 64
SCALE = np.float32(1 / 0.07)  # CLIP's initial exp(logit_scale)
TOL = dict(atol=1e-5, rtol=1e-5)
# (rows, cols, D, ids): block-aligned rows of the last rank, a padded
# strip, scattered ids with a padding row (id = cols), and scattered ids
# over several 64-column tiles of either side with a padding row.
CASES = {"aligned": (16, 64, 32, "strip"),
         "padded": (10, 40, 24, "strip"),
         "scattered": (12, 50, 16, "scattered"),
         "tiles": (101, 300, 96, "scattered")}
# (rows, cols, D) of the data-parallel CLIP path (chip_smoke.py's
# DP_CLIP_SHAPES): world 1 and one rank of 4 at batch 256, one rank of 4
# at batch 4096, the ragged shape.
DP_CLIP_SHAPES = [(256, 256, 512), (64, 256, 512), (1024, 4096, 512),
                  (101, 1000, 96)]


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _row_ids(rows, cols, kind, seed):
    if kind == "strip":
        return np.arange(cols - rows, cols, dtype=np.int32)
    ids = np.random.default_rng(seed).permutation(cols)[:rows]
    ids[-1] = cols  # a padding row: valid_row = 0, its column term stays
    return ids.astype(np.int32)


@functools.cache
def _case(case, dtype):
    """(za, zb, row ids, lse_a, lse_b, o_a, o_b) as numpy: the inputs from
    a seed, then the Pallas forward's lse and the two backward calls in
    interpret mode."""
    rows, cols, d, kind = CASES[case]
    rng = np.random.default_rng(rows + cols)
    za, zb = _unit(rng, rows, d), _unit(rng, cols, d)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        za = np.array(jnp.asarray(za, jnp.bfloat16).astype(jnp.float32))
        zb = np.array(jnp.asarray(zb, jnp.bfloat16).astype(jnp.float32))
    gid = _row_ids(rows, cols, kind, seed=d)
    br, bc = choose_blocks(rows, cols, d, jnp.float32)
    zap, zbp = _pad_rows(jnp.asarray(za), br), _pad_rows(jnp.asarray(zb), bc)
    _, lse_a, lse_b = _dual_fwd_call(
        zap, zbp, jnp.float32(SCALE), br=br, bc=bc, rows_actual=rows,
        cols_actual=cols, interpret=True, stats_only=True)
    lse_a, lse_b = np.array(lse_a[:rows, 0]), np.array(lse_b[:cols, 0])
    common = dict(br=br, bc=bc, inv_t=1.0, cols_actual=cols, n_half=0,
                  interpret=True, diag_pos=True, scale=jnp.float32(SCALE))
    gid_col = _gid_column(jnp.asarray(gid), br, sentinel=cols)
    lse_ap = _pad_rows(jnp.asarray(lse_a).reshape(rows, 1), br)
    lse_bp = _pad_rows(jnp.asarray(lse_b).reshape(cols, 1), bc)
    o_a = _bwd_sym_call(zap, gid_col, lse_ap, z_cols=zbp, lse_cols=lse_bp,
                        **common)[:rows]
    o_b = _bwd_sym_cols_call(zap, zbp, gid_col, lse_ap, lse_bp,
                             **common)[:cols]
    return za, zb, gid, lse_a, lse_b, np.asarray(o_a), np.asarray(o_b)


def _exp0(x):
    return torch.exp(torch.clamp(x, max=0.0))


def _emulate(side, za, zb, gid, scale, lse_a, lse_b, splits, width,
             passes=3, drop_padding_rows=False):
    """o_a (``side="rows"``) or o_b (``"cols"``) in the kernels' order.
    ``passes=1``: every product of hi alone (one TF32 pass);
    ``drop_padding_rows``: G zero on a row whose id is >= n_c, the rule of
    #6's policies, which the cross-modal mode does not follow."""
    za, zb, gid = za.float(), zb.float(), gid.long()
    n_c = zb.shape[0]
    own, other = (za, zb) if side == "rows" else (zb, za)

    def split(x):
        hi, lo = N.tf32_split(x)
        return hi, lo if passes == 3 else torch.zeros_like(lo)

    own_hi, own_lo = split(own)
    oth_hi, oth_lo = split(other)
    s = own_hi @ oth_hi.T + (own_hi @ oth_lo.T + own_lo @ oth_hi.T)
    x = s * scale
    cols = torch.arange(n_c)
    if side == "rows":  # (n_r, n_c): CrossRowsG
        pos = (gid[:, None] == cols[None, :]).float()
        valid = (gid < n_c).float()[:, None]
        g = ((_exp0(x - lse_a[:, None]) - pos) * valid
             + (_exp0(x - lse_b[None, :]) - pos))
    else:  # (n_c, n_r): CrossColsG
        pos = (cols[:, None] == gid[None, :]).float()
        valid = (gid < n_c).float()[None, :]
        g = ((_exp0(x - lse_a[None, :]) - pos) * valid
             + (_exp0(x - lse_b[:, None]) - pos))
    if drop_padding_rows:
        g = g * valid
    g_hi, g_lo = split(g)
    n_other = other.shape[0]
    out = None
    for start in range(0, splits * width, width):
        end = min(start + width, n_other)
        part = torch.zeros(own.shape)
        for c0 in range(start, end, TILE):
            c1 = min(c0 + TILE, end)
            acc = (g_lo[:, c0:c1] @ oth_hi[c0:c1]
                   + g_hi[:, c0:c1] @ oth_lo[c0:c1]) \
                + g_hi[:, c0:c1] @ oth_hi[c0:c1]
            part = part + acc
        out = part if out is None else out + part
    return out


def _plan(side, case, plan):
    rows, cols, d, _ = CASES[case]
    own, other = (rows, cols) if side == "rows" else (cols, rows)
    if plan == "one":
        return 1, -(-other // N.SPLIT_UNIT) * N.SPLIT_UNIT
    return N.general_bwd_splits(own, other, d, SMS)


def _torch_inputs(case, dtype):
    za, zb, gid, lse_a, lse_b, o_a, o_b = _case(case, dtype)
    t = [torch.from_numpy(x) for x in (za, zb, gid, lse_a, lse_b)]
    return (*t, torch.tensor(SCALE)), {"rows": o_a, "cols": o_b}


@pytest.mark.parametrize("plan", ["one", "planner"])
@pytest.mark.parametrize("side", ["rows", "cols"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernels_match_the_pallas_calls(case, dtype, side, plan):
    (za, zb, gid, lse_a, lse_b, scale), want = _torch_inputs(case, dtype)
    splits, width = _plan(side, case, plan)
    got = _emulate(side, za, zb, gid, scale, lse_a, lse_b, splits, width)
    np.testing.assert_allclose(got.numpy(), want[side], **TOL)
    # the emulation and the plain version are the same function
    plain = (I.infonce_bwd_rows_plain if side == "rows"
             else I.infonce_bwd_cols_plain)
    np.testing.assert_allclose(
        got.numpy(), plain(za, zb, gid, scale, lse_a, lse_b).numpy(), **TOL)


@pytest.mark.parametrize("side", ["rows", "cols"])
def test_one_tf32_pass_misses_the_tolerance(side):
    """The kernels' control on the card: every product of hi alone errs
    at least 10x more than the three-product emulation, and beyond the
    tolerance."""
    (za, zb, gid, lse_a, lse_b, scale), want = _torch_inputs("tiles",
                                                             "float32")
    splits, width = _plan(side, "tiles", "planner")
    args = (side, za, zb, gid, scale, lse_a, lse_b, splits, width)
    three = np.abs(_emulate(*args).numpy() - want[side]).max()
    one = np.abs(_emulate(*args, passes=1).numpy() - want[side]).max()
    assert 10 * three <= one
    assert one > TOL["atol"] + TOL["rtol"] * np.abs(want[side]).max()


@pytest.mark.parametrize("side", ["rows", "cols"])
def test_the_padding_row_keeps_its_column_term(side):
    """valid_row multiplies the row term only: a G that also drops the
    padding row's column term (the rule of #6's RowsG and ColsG) misses
    the Pallas call; on the row side exactly at the padding row."""
    (za, zb, gid, lse_a, lse_b, scale), want = _torch_inputs("tiles",
                                                             "float32")
    assert int(gid[-1]) == zb.shape[0]
    splits, width = _plan(side, "tiles", "planner")
    dropped = _emulate(side, za, zb, gid, scale, lse_a, lse_b, splits,
                       width, drop_padding_rows=True).numpy()
    err = np.abs(dropped - want[side]).max(axis=1)
    assert err.max() > 1e-2
    if side == "rows":
        assert err[-1] > 1e-2 and err[:-1].max() <= 1e-4


@pytest.mark.parametrize("shape", DP_CLIP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("side", ["rows", "cols"])
def test_split_plan_covers_the_other_side_once(side, shape):
    rows, cols, d = shape
    own, other = (rows, cols) if side == "rows" else (cols, rows)
    splits, width = N.general_bwd_splits(own, other, d, SMS)
    assert width % N.SPLIT_UNIT == 0
    runs = [range(s * width, min((s + 1) * width, other))
            for s in range(splits)]
    assert all(len(run) > 0 for run in runs)
    assert sorted(c for run in runs for c in run) == list(range(other))
    assert -(-own // TILE) * splits * N._d_chunks(d) <= 2 * SMS


def _entry_body(text, name):
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


@pytest.mark.parametrize("side,source", [("rows", "infonce_dual_bwd"),
                                         ("cols", "infonce_bwd_cols")])
def test_entry_points_run_the_tf32_walk(side, source):
    text = _build.SOURCES[source].read_text()
    assert '#include "infonce_cross_bwd.cuh"' in text
    body = _entry_body(text, f"ntx_infonce_bwd_{side}")
    assert f"infonce_cross::run<{str(side == 'cols').lower()}>" in body
    assert "void* scratch" in body and "int splits" in body \
        and "int split_cols" in body
    assert f'extern "C" long long ntx_infonce_bwd_{side}_scratch(' in text
    assert "grad_rows" not in body


def test_only_the_square_kernel_keeps_the_fma_walk():
    """The FMA walk of ``infonce_grad.cuh`` (grad_rows) is gone: the
    square #10 runs the TF32 walks of this header, and #8, its last
    caller, runs them too (``dual_tf32.cuh``), so the header is deleted
    and no source or header includes it or calls grad_rows."""
    csrc = _build.SOURCES["infonce_bwd_cols"].parent
    assert not (csrc / "infonce_grad.cuh").exists()
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        for gone in ("infonce_grad.cuh", "grad_rows<", "grad_rows("):
            assert gone not in text, (path.name, gone)
    header = (csrc / "infonce_cross_bwd.cuh").read_text()
    assert "bwd_walk<kSplit, ND>" in header and "grad_rows" not in header
    kernels = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", header)
    assert sorted(kernels) == sorted(
        f"infonce_bwd_{side}_{part}" for side in ("rows", "cols")
        for part in ("prep", "walk", "sum"))
