"""The arithmetic of the CLIP loss kernels #9 (the dual forward,
``csrc/infonce_dual_fwd.cu``: the square mode of ``info_nce_fused`` and the
rectangular stats-only mode of the data-parallel CLIP loss) and #10 (the
square dual backward, ``csrc/infonce_dual_bwd.cu``) on the TF32 walks of
``csrc/ntxent_tf32.cuh``, which runs without a card:

* ``_emulate_fwd`` repeats #9's order in plain PyTorch: za and zb split
  into TF32 hi and lo by ``ops.ntxent.tf32_split``, s as three products
  (hi.hi, then hi.lo + lo.hi added last) times the scale, formed once;
  the row direction online over the 64-column tiles of each split of zb's
  columns (``column_splits``), one (m, l, pos) partial per row and split;
  the column direction one (max, sum) partial per column and 64-row tile
  of za; both folded in order (``fold_partial``), the 1e-37 floor, and
  the square loss sum_i (lse_a - s_ii) + (lse_b - s_ii). It is held
  against the Pallas ``_dual_fwd_call`` in interpret mode on the same
  numpy inputs: square (256, 256, 64) and ragged (1000, 1000, 96),
  rectangular stats-only (64, 256, 512) and (101, 1000, 96), fp32 and
  bf16, at one split and at the planner's;
* #10 is the rows and the columns walks of ``csrc/infonce_cross_bwd.cuh``
  with the ids 0 .. N - 1: ``test_torch_infonce_sm90._emulate`` of both
  sides, held against the Pallas ``_dual_bwd_call`` in interpret mode on
  the square shapes, at one split and at ``dual_grads_splits``' plan;
* one TF32 pass (hi alone, the kernels' control on the card) misses the
  tolerance by far in both;
* the sources: #9 and #10 reach the TF32 walks (#9 forms s once a tile
  for both directions), and no FMA kernel is left in either.

Tolerance: the emulation's products are fp32-accurate (3xTF32 drops
lo.lo, 2^-22 relative) and the Pallas calls' are fp32, summed in other
orders: 1e-5 absolute plus 1e-5 relative on lse_a, lse_b, the mean loss
loss_sum / 2N, o_a and o_b, as the plain versions are held
(``test_torch_infonce_sm90.py``, ``test_torch_clip_dp.py``).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_infonce_sm90 as cross
from ntxent_tpu.ops.blocks import choose_blocks
from ntxent_tpu.ops.infonce_pallas import _dual_bwd_call, _dual_fwd_call
from ntxent_tpu.ops.ntxent_pallas import _gid_column, _pad_rows
from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.ops import infonce as I
from ntxent_tpu_torch.ops import ntxent as N

torch.set_num_threads(1)  # see test_torch_training.py

SMS = 132
TILE = 64
SCALE = np.float32(1 / 0.07)  # CLIP's initial exp(logit_scale)
TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30
# (n_a, n_b, D, square): the square mode at a narrow D and at a ragged N
# that is no multiple of the 64-row tile, and the rectangular stats-only
# mode at one rank of 4 at CLIP's batch 256 and at a ragged shape.
FWD_CASES = {"square": (256, 256, 64, True),
             "ragged": (1000, 1000, 96, True),
             "rect_r4": (64, 256, 512, False),
             "rect_ragged": (101, 1000, 96, False)}
SQUARE = [case for case, (*_, square) in FWD_CASES.items() if square]
# (n_a, n_b, D) of chip_smoke.py's #9 and #10 shapes: CLIP at batch 256,
# N = 8192, one rank of 4 at batch 256 and 4096.
PATH_SHAPES = [(256, 256, 512), (8192, 8192, 512), (64, 256, 512),
               (1024, 4096, 512)]


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


@functools.cache
def _fwd_case(case, dtype):
    """(za, zb, loss_sum, lse_a, lse_b) as numpy: the inputs from a seed,
    then the Pallas forward in interpret mode (its loss only in the square
    mode)."""
    n_a, n_b, d, square = FWD_CASES[case]
    rng = np.random.default_rng(n_a + n_b + d)
    za, zb = _unit(rng, n_a, d), _unit(rng, n_b, d)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        za = np.array(jnp.asarray(za, jnp.bfloat16).astype(jnp.float32))
        zb = np.array(jnp.asarray(zb, jnp.bfloat16).astype(jnp.float32))
    br, bc = choose_blocks(n_a, n_b, d, jnp.float32)
    loss, lse_a, lse_b = _dual_fwd_call(
        _pad_rows(jnp.asarray(za), br), _pad_rows(jnp.asarray(zb), bc),
        jnp.float32(SCALE), br=br, bc=bc, rows_actual=n_a, cols_actual=n_b,
        interpret=True, stats_only=not square)
    return (za, zb, float(loss) if square else None,
            np.array(lse_a[:n_a, 0]), np.array(lse_b[:n_b, 0]))


def _split(x, passes):
    hi, lo = N.tf32_split(x)
    return hi, lo if passes == 3 else torch.zeros_like(lo)


def _exp0(x):
    return torch.exp(torch.clamp(x, max=0.0))


def _fold(m, l, m_c, l_c):
    m_new = torch.maximum(m, m_c)
    return m_new, l * _exp0(m - m_new) + l_c * _exp0(m_c - m_new)


def _emulate_fwd(za, zb, scale, splits, width, passes=3, loss=True):
    """(loss_sum or None, lse_a, lse_b) in #9's order. ``passes=1``: every
    product of hi alone (one TF32 pass)."""
    n_a, n_b = za.shape[0], zb.shape[0]
    a_hi, a_lo = _split(za.float(), passes)
    b_hi, b_lo = _split(zb.float(), passes)
    s = (a_hi @ b_hi.T + (a_hi @ b_lo.T + a_lo @ b_hi.T)) * scale
    diag = torch.arange(n_a)[:, None] == torch.arange(n_b)[None, :]
    # the row direction: online over each split's 64-column tiles
    m = torch.full((n_a,), NEG_INF)
    l = torch.zeros(n_a)
    pos = torch.zeros(n_a)
    for start in range(0, splits * width, width):
        end = min(start + width, n_b)
        m_s = torch.full((n_a,), NEG_INF)
        l_s = torch.zeros(n_a)
        for c0 in range(start, end, TILE):
            x = s[:, c0:min(c0 + TILE, end)]
            m_new = torch.maximum(m_s, x.amax(dim=1))
            l_s = (l_s * torch.exp(m_s - m_new)
                   + _exp0(x - m_new[:, None]).sum(dim=1))
            m_s = m_new
        pos = pos + (s * diag)[:, start:end].sum(dim=1)
        m, l = _fold(m, l, m_s, l_s)
    lse_a = m + torch.log(torch.clamp(l, min=1e-37))
    # the column direction: one partial per 64-row tile of za
    m = torch.full((n_b,), NEG_INF)
    l = torch.zeros(n_b)
    for r0 in range(0, n_a, TILE):
        x = s[r0:r0 + TILE]
        m_c = x.amax(dim=0)
        m, l = _fold(m, l, m_c, _exp0(x - m_c[None, :]).sum(dim=0))
    lse_b = m + torch.log(torch.clamp(l, min=1e-37))
    if not loss:
        return None, lse_a, lse_b
    return ((lse_a - pos) + (lse_b - pos)).sum(), lse_a, lse_b


def _fwd_plan(case, plan):
    n_a, n_b, _, _ = FWD_CASES[case]
    if plan == "one":
        return 1, -(-n_b // N.SPLIT_UNIT) * N.SPLIT_UNIT
    return N.column_splits(n_a, n_b, SMS)


def _check_fwd(got, want, n_a):
    loss, lse_a, lse_b = got
    loss_ref, lse_a_ref, lse_b_ref = want
    np.testing.assert_allclose(lse_a.numpy(), lse_a_ref, **TOL)
    np.testing.assert_allclose(lse_b.numpy(), lse_b_ref, **TOL)
    if loss_ref is not None:
        np.testing.assert_allclose(float(loss) / (2 * n_a),
                                   loss_ref / (2 * n_a), **TOL)


@pytest.mark.parametrize("plan", ["one", "planner"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_emulated_dual_forward_matches_the_pallas_call(case, dtype, plan):
    za, zb, *want = _fwd_case(case, dtype)
    n_a, _, _, square = FWD_CASES[case]
    za, zb = torch.from_numpy(za), torch.from_numpy(zb)
    scale = torch.tensor(SCALE)
    got = _emulate_fwd(za, zb, scale, *_fwd_plan(case, plan), loss=square)
    _check_fwd(got, want, n_a)
    # the emulation and the plain version are the same function
    plain = (I.infonce_dual_fwd_plain(za, zb, scale) if square
             else (None, *I.infonce_dual_fwd_rect_plain(za, zb, scale)))
    _check_fwd(got, (None if plain[0] is None else float(plain[0]),
                     plain[1].numpy(), plain[2].numpy()), n_a)


@pytest.mark.parametrize("case", ["ragged", "rect_ragged"])
def test_one_tf32_pass_misses_the_forward_tolerance(case):
    """The kernels' control on the card: every product of hi alone errs
    at least 10x more on lse than the three-product emulation, and beyond
    the tolerance."""
    za, zb, _, lse_a, lse_b = _fwd_case(case, "float32")
    want = np.concatenate([lse_a, lse_b])
    args = (torch.from_numpy(za), torch.from_numpy(zb), torch.tensor(SCALE),
            *_fwd_plan(case, "planner"))

    def err(passes):
        _, a, b = _emulate_fwd(*args, passes=passes, loss=False)
        return np.abs(torch.cat([a, b]).numpy() - want).max()

    three, one = err(3), err(1)
    assert 10 * three <= one
    assert one > TOL["atol"] + TOL["rtol"] * np.abs(want).max()


@functools.cache
def _bwd_case(case, dtype):
    """(za, zb, lse_a, lse_b, o_a, o_b) as numpy: the Pallas forward's lse,
    then the Pallas ``_dual_bwd_call`` in interpret mode, as
    ``_infonce_bwd`` calls it (ids 0 .. N - 1, sentinel N)."""
    za, zb, _, lse_a, lse_b = _fwd_case(case, dtype)
    n, _, d, _ = FWD_CASES[case]
    br, bc = choose_blocks(n, n, d, jnp.float32)
    o_a, o_b = _dual_bwd_call(
        _pad_rows(jnp.asarray(za), br), _pad_rows(jnp.asarray(zb), bc),
        _gid_column(jnp.arange(n), br, sentinel=n), jnp.float32(SCALE),
        _pad_rows(jnp.asarray(lse_a).reshape(n, 1), br),
        _pad_rows(jnp.asarray(lse_b).reshape(n, 1), bc), br=br, bc=bc,
        rows_actual=n, cols_actual=n, interpret=True)
    return za, zb, lse_a, lse_b, np.asarray(o_a[:n]), np.asarray(o_b[:n])


def _bwd_plan(case, plan):
    n, _, d, _ = FWD_CASES[case]
    if plan == "one":
        return 1, -(-n // N.SPLIT_UNIT) * N.SPLIT_UNIT
    return N.dual_grads_splits(n, n, d, SMS)[0]


def _emulate_bwd(case, dtype, plan, passes=3):
    """(o_a, o_b, want_a, want_b): #10 as the rows and the columns walks
    (CrossRowsG, CrossColsG) with the ids 0 .. N - 1."""
    za, zb, lse_a, lse_b, o_a, o_b = _bwd_case(case, dtype)
    t = [torch.from_numpy(x) for x in (za, zb)]
    ids = torch.arange(za.shape[0], dtype=torch.int32)
    args = (*t, ids, torch.tensor(SCALE), torch.from_numpy(lse_a),
            torch.from_numpy(lse_b), *_bwd_plan(case, plan))
    return (cross._emulate("rows", *args, passes=passes),
            cross._emulate("cols", *args, passes=passes), o_a, o_b)


@pytest.mark.parametrize("plan", ["one", "planner"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SQUARE)
def test_emulated_dual_backward_matches_the_pallas_call(case, dtype, plan):
    got_a, got_b, want_a, want_b = _emulate_bwd(case, dtype, plan)
    np.testing.assert_allclose(got_a.numpy(), want_a, **TOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, **TOL)
    # and the plain version, from the same lse
    za, zb, lse_a, lse_b, _, _ = _bwd_case(case, dtype)
    plain = I.infonce_dual_bwd_plain(
        *(torch.from_numpy(x) for x in (za, zb)), torch.tensor(SCALE),
        torch.from_numpy(lse_a), torch.from_numpy(lse_b))
    np.testing.assert_allclose(got_a.numpy(), plain[0].numpy(), **TOL)
    np.testing.assert_allclose(got_b.numpy(), plain[1].numpy(), **TOL)


def test_one_tf32_pass_misses_the_backward_tolerance():
    three = _emulate_bwd("ragged", "float32", "planner")
    one = _emulate_bwd("ragged", "float32", "planner", passes=1)
    want = np.concatenate([three[2], three[3]])

    def err(out):
        return np.abs(torch.cat(out[:2]).numpy() - want).max()

    assert 10 * err(three) <= err(one)
    assert err(one) > TOL["atol"] + TOL["rtol"] * np.abs(want).max()


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_plans_cover_the_columns_once(shape):
    """#9 cuts zb's columns as ``column_splits`` plans; #10 cuts each
    side's other side as ``dual_grads_splits`` plans, both sides together
    near one wave of the SMs."""
    n_a, n_b, d = shape
    plans = [(N.column_splits(n_a, n_b, SMS), n_b)]
    if n_a == n_b:
        plans.append((N.dual_grads_splits(n_a, n_a, d, SMS)[0], n_a))
        splits, _ = plans[-1][0]
        assert 2 * -(-n_a // TILE) * splits * N._d_chunks(d) <= 2 * SMS \
            or splits == 1
    for (splits, width), cols in plans:
        assert width % N.SPLIT_UNIT == 0
        runs = [range(s * width, min((s + 1) * width, cols))
                for s in range(splits)]
        assert all(len(run) > 0 for run in runs)
        assert sorted(c for run in runs for c in run) == list(range(cols))


def _kernels(text):
    return re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?"
                      r"\s+(\w+)\(", text)


def _body(text, start):
    at = text.index(start)
    return text[at:text.index("\n}\n", at)]


def test_dual_forward_forms_each_s_tile_once_on_the_tf32_walk():
    """Both modes of #9 run ``dual_walk`` (``dual_tf32.cuh``, which #7
    shares with its own mask): one ``s_tile`` (3xTF32 wgmma from the ring)
    a column tile, folded into the rows' online softmax and the columns'
    tile statistics; the launches go through ``fwd_launch``."""
    text = _build.SOURCES["infonce_dual_fwd"].read_text()
    assert '#include "dual_tf32.cuh"' in text
    assert "infonce_tile.cuh" not in text
    header = (_build.SOURCES["infonce_dual_fwd"].parent
              / "dual_tf32.cuh").read_text()
    assert '#include "ntxent_tf32.cuh"' in header
    walk = _body(header, "__device__ __forceinline__ void dual_walk(")
    assert walk.count("s_tile<kSplit>(") == 1
    assert "online_rows(" in walk and walk.count("consumers_sync()") == 2
    for kernel, loss in (("infonce_dual_fwd_walk", "true"),
                         ("infonce_fwd_rect_walk", "false")):
        body = _body(text, f"    {kernel}(")
        assert "LiveMask mask{" in body
        assert f"dual_walk<kSplit, {loss}>(" in body
        assert text.count(f"{kernel}<kSplit>,") == 1  # handed to fwd_launch
    assert text.count("fwd_launch<T>(") == 2
    assert "cuTensorMapEncode" not in text and "tensor_map_f32" not in text
    assert sorted(_kernels(text)) == sorted([
        "infonce_dual_fwd_prep", "infonce_dual_fwd_walk",
        "infonce_dual_fwd_merge", "infonce_loss_reduce",
        "infonce_fwd_rect_prep", "infonce_fwd_rect_walk",
        "infonce_fwd_rect_merge"])


def test_dual_backward_runs_both_cross_walks_in_one_grid():
    """#10 is one prep, one walk launch whose CTAs take CrossRowsG or
    CrossColsG (bwd_walk_at), and one split sum (``dual_bwd_launch`` of
    ``dual_tf32.cuh``, which #8 shares)."""
    text = _build.SOURCES["infonce_dual_bwd"].read_text()
    assert '#include "infonce_cross_bwd.cuh"' in text
    assert '#include "dual_tf32.cuh"' in text
    walk = _body(text, "    infonce_dual_bwd_walk(")
    assert "CrossRowsG g{" in walk and "CrossColsG g{" in walk
    assert walk.count("bwd_walk_at<kSplit, ND>(") == 2
    entry = _body(text, 'extern "C" int ntx_infonce_dual_bwd(')
    assert "Inputs in{nullptr," in entry  # the ids 0 .. N - 1
    assert 'extern "C" long long ntx_infonce_dual_bwd_scratch(' in text
    assert sorted(_kernels(text)) == sorted([
        "infonce_dual_bwd_prep", "infonce_dual_bwd_walk",
        "infonce_dual_bwd_sum"])


@pytest.mark.parametrize("source", ["infonce_dual_fwd", "infonce_dual_bwd"])
def test_no_fma_kernel_is_left(source):
    text = _build.SOURCES[source].read_text()
    for fma in ("infonce_tile.cuh", "infonce_grad.cuh", "tile_products",
                "grad_rows", "lse_rows", "fmaf("):
        assert fma not in text, fma
