"""The training slice's hand-written kernels against their plain versions.

This file imports torch and the port only (no JAX, no flax), so it runs
on the card, where the JAX package's model code cannot load:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

``cuda``-marked tests hold each CUDA kernel (``ntxent_fwd``,
``ntxent_bwd_sym``, ``ntxent_fwd_general``, ``ntxent_bwd_general_rows``,
``ntxent_bwd_general_cols``, ``flash_attention_dq``,
``flash_attention_dkv``, ``flash_fold``, ``infonce_dual_fwd``,
``infonce_dual_bwd``, ``infonce_dual_fwd_rect``, ``infonce_bwd_rows``,
``infonce_bwd_cols``, ``block_lse_dual``, ``block_grads_dual``) to its
plain version on the same card, and the
differentiable wrappers' gradients to the same computation on the CPU;
they skip here. The other tests run anywhere: the plain backward
versions against torch autograd of the plain forwards, the CPU dispatch,
the input checks and the build table.

Tolerances (max abs error against the plain version on the card):

* NT-Xent, fp32 z: the kernels form products in 3xTF32 (about 22 bits)
  and the plain version in fp32, summed in another order -> 2e-4 on lse
  and loss_sum/2N (logits up to 1/T = 10), 2e-4 on the gradient; bf16 z:
  products of bf16 values are exact in TF32 and fp32 on both sides, so
  the same bounds hold. The TF32 control (the plain version on z rounded
  to TF32 once, one TF32 pass) must err at least 10x more than the
  kernels on lse and on the gradient: a kernel that dropped a lo product
  would sit at the control's error, which NTX_ATOL alone would not show.
* general NT-Xent (rows x columns with global ids), fp32 or bf16: the
  same products in another order -> the symmetric bounds, 2e-4 on lse,
  loss_sum/R and both gradients. In the InfoNCE mode (``diag_pos``, a
  device scale) the logits reach the scale instead of 1/T = 10, and an
  error of the products grows with them: NTX_ATOL * max(1, scale / 10)
  (2.9e-4 at CLIP's initial 14.3, 2e-3 at 100); the TF32 control as
  above.
* flash backward, fp32: summation order only -> 1e-4 on dq/dk/dv of
  unit-scale inputs. bf16: s and dp are exact-product fp32 sums on both
  sides; ds is rounded to bf16 before ds . K on both sides, but a
  one-ulp flip of a rounded ds between the two summation orders moves
  dq by up to 2**-8 |ds| |k| -> 3e-2 on dq; dk/dv keep p and ds to
  ~16 bits (the kernel's hi/lo split) against the plain version's fp32
  -> 1e-2.
* flash fold (#12): m within 1e-4 (the same fp32 maxima of exact
  products), l within 1e-4 relative, and acc / l within |a - b| / |b|
  of 1e-5 over the tensor in fp32 (summation order) and 1e-2 in bf16 (p
  rounded to bf16 at another running max); a hop wholly in the rows'
  future leaves the carry bit for bit.
* InfoNCE, fp32 or bf16 za/zb: the same exact fp32 products summed in
  another order, logits up to the scale 17.5 -> 2e-4 on lse_a, lse_b and
  loss_sum/2N, 2e-4 on o_a and o_b (rows of G sum to at most 4 in
  absolute value, times unit-norm embeddings); the data-parallel modes
  (rows x columns with global row ids) the same bounds, for the same
  reasons. #9 (both modes), #10, #5's cross-modal mode and #4 run on the
  TF32 walks (3xTF32 for fp32) and are held to the TF32 control as the
  NT-Xent kernels are.
* shard-pair (#7 ``block_lse_dual``, #8 ``block_grads_dual``), fp32 or
  bf16: the NT-Xent bounds for the NT-Xent reasons, 2e-4 on both lse and
  both gradients; both on the TF32 walks and held to the TF32 control.
"""

import numpy as np
import pytest
import torch

from ntxent_tpu_torch.ops import _build
from ntxent_tpu_torch.ops import attention as A
from ntxent_tpu_torch.ops import infonce as I
from ntxent_tpu_torch.ops import ntxent as N

NTX_ATOL = 2e-4
BWD_ATOL = {"float32": dict(dq=1e-4, dkv=1e-4),
            "bfloat16": dict(dq=3e-2, dkv=1e-2)}
# (2N, D): the training path's shape, the north-star global batch, and a
# ragged 2N with D != 2B.
NTX_SHAPES = [(512, 128), (8192, 128), (1000, 96)]
# Embedding widths: D padded to 32 with zeros, D = 256 in two chunks of
# the backward, D = 288 and 512, where the fp32 row tile streams through
# the ring, and the wide D of CLIP ViT-L/14 (768) and ViT-H/14 (1024) and
# a D that is no multiple of 32 (1000), where the bf16 row tile streams
# too and a backward walks 6-8 chunks of D.
NTX_EDGE_DIMS = [1, 5, 256, 288, 512, 768, 1000, 1024]
TF32_CONTROL_FACTOR = 10
# (R, C, D) of the general kernels: one rank's strip of a 4-card world at
# global batch 256 and at 4096, and a ragged shape with D != 2B.
GENERAL_SHAPES = [(128, 512, 128), (2048, 8192, 128), (100, 1000, 96)]
INFONCE_ATOL = 2e-4
# (N, D): the CLIP path's shape (batch 256, embedding 512), a ragged N
# that is no multiple of the 64-row tile, a narrower D, and N = 8192.
INFONCE_SHAPES = [(256, 512), (1000, 512), (1000, 128), (8192, 512)]
INFONCE_SCALE = 17.5  # not 1/T of the default temperature
# (rows, cols, D) of the data-parallel InfoNCE kernels: world 1 at
# global batch 256, one rank of a 4-card world at 256 and at 4096, and a
# ragged shape with scattered row ids and a padding row.
DP_INFONCE_SHAPES = [(256, 256, 512), (64, 256, 512), (1024, 4096, 512),
                     (101, 1000, 96)]
# (R, C, D, world) of the shard-pair kernels: the world-1 self tile of
# --dp-loss pair at batch 256, the k = 1 tile of rank 0 of a world of 4 at
# global batch 256 and 4096, and a ragged tile (world None) with
# scattered ids, ids shared by rows and columns and sentinel rows and
# columns (chip_smoke.py's PAIR_CASES).
PAIR_CASES = [(512, 512, 128, 1), (128, 128, 128, 4), (2048, 2048, 128, 4),
              (100, 260, 96, None)]
# (bh, lq, lk, d, causal, q_offset, k_offset)
BWD_CASES = {
    "train_shape": (48, 197, 197, 64, False, 0, 0),
    "causal_lq_ne_lk": (8, 100, 300, 64, True, 0, 37),
    "causal_shifted": (8, 100, 300, 64, True, 150, 20),
    "d128": (16, 197, 197, 128, False, 0, 0),
    "fully_masked_rows": (4, 70, 90, 64, True, 0, 3),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _unit_rows(n, d, seed, device="cpu", dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    z = torch.nn.functional.normalize(torch.randn(n, d, generator=gen), dim=1)
    return z.to(device=device, dtype=dtype)


def _general_case(rows, cols, seed, device="cpu", col_ids=False):
    """(row_gid, col_gid, cols_actual, n_half) of a general-mode call.

    Without ``col_ids``: the strip layout, the row ids of rank 3 of 4 over
    ``cols`` gathered columns (ids: the index), one sentinel row id if
    ``rows`` is not a whole rank. With ``col_ids``: columns that carry
    scattered global ids of a 2 x ``cols`` problem (the ring's visiting
    block), rows that share some of them, positives at +-``cols``."""
    gen = torch.Generator().manual_seed(seed)
    if not col_ids:
        n_local = rows // 2
        gid = 3 * n_local + torch.arange(n_local)
        row_gid = torch.cat([gid, cols // 2 + gid])
        if rows % 2:
            row_gid = torch.cat([row_gid, torch.tensor([cols])])
        return row_gid.to(device), None, cols, cols // 2
    total = 2 * cols
    col_gid = torch.randperm(total, generator=gen)[:cols]
    row_gid = torch.cat([col_gid[:rows // 2],
                         torch.randperm(total, generator=gen)[:rows
                                                              - rows // 2]])
    return row_gid.to(device), col_gid.to(device), total, total // 2


def _oracle_loss(z, temperature):
    zf = z.float()
    n2 = z.shape[0]
    s = zf @ zf.T / temperature
    s = s.masked_fill(torch.eye(n2, dtype=torch.bool, device=z.device), -1e30)
    pos = (torch.arange(n2, device=z.device) + n2 // 2) % n2
    return (torch.logsumexp(s, 1) - s[torch.arange(n2), pos]).mean()


# ---------------------------------------------------------------------------
# Anywhere: plain versions, dispatch, checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.05, 0.5])
def test_plain_ntxent_backward_is_the_gradient_of_the_loss(temperature):
    z = _unit_rows(12, 5, seed=0).requires_grad_()
    ref = _oracle_loss(z, temperature)
    (g_ref,) = torch.autograd.grad(ref, z)
    loss_sum, lse = N.ntxent_fwd_plain(z.detach(), temperature)
    grad = N.ntxent_bwd_sym_plain(z.detach(), lse, temperature)
    torch.testing.assert_close(loss_sum / 12, ref.detach(), atol=1e-5,
                               rtol=1e-6)
    torch.testing.assert_close(grad / 12 / temperature, g_ref, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_flash_backward_is_the_gradient_of_attention_plain(case):
    _, lq, lk, _, causal, q_off, k_off = BWD_CASES[case]
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, n, 8, generator=gen).requires_grad_()
               for n in (lq, lk, lk))
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o, lse = A.attention_plain(q, k, v, **kw)
    do = torch.randn(o.shape, generator=gen)
    grads = torch.autograd.grad(o, (q, k, v), do)
    delta = (do * o).sum(-1).detach()
    args = (q.detach(), k.detach(), v.detach(), do, lse.detach(), delta)
    dq = A.flash_attention_dq(*args, **kw)
    dk, dv = A.flash_attention_dkv(*args, **kw)
    for got, ref in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    z = _unit_rows(8, 4, seed=1)
    counts = (N.ntxent_fwd.launches, N.ntxent_bwd_sym.launches,
              A.flash_attention_dq.launches, A.flash_attention_dkv.launches)
    loss_sum, lse = N.ntxent_fwd(z, 0.1)
    N.ntxent_bwd_sym(z, lse, 0.1)
    q = torch.randn(2, 5, 8)
    o, lse_a = A.flash_attention_fwd(q, q, q)
    A.flash_attention_dq(q, q, q, o, lse_a, lse_a)
    A.flash_attention_dkv(q, q, q, o, lse_a, lse_a)
    assert counts == (N.ntxent_fwd.launches, N.ntxent_bwd_sym.launches,
                      A.flash_attention_dq.launches,
                      A.flash_attention_dkv.launches)
    torch.testing.assert_close(loss_sum, N.ntxent_fwd_plain(z, 0.1)[0],
                               atol=0, rtol=0)


@pytest.mark.parametrize("col_ids", [False, True])
def test_plain_general_backward_is_the_gradient_of_the_forward(col_ids):
    zr = _unit_rows(9, 5, seed=2).requires_grad_()
    zc = _unit_rows(14, 5, seed=3).requires_grad_()
    row_gid, col_gid, total, n_half = _general_case(9, 14, 4, col_ids=col_ids)
    kw = dict(col_gid=col_gid, cols_actual=total, n_half=n_half)
    loss_sum, lse = N.ntxent_fwd_general_plain(zr, zc, row_gid, 0.1, **kw)
    g_rows, g_cols = torch.autograd.grad(loss_sum, (zr, zc))
    args = (zr.detach(), zc.detach(), row_gid, lse.detach(), 0.1)
    torch.testing.assert_close(N.ntxent_bwd_general_rows(*args, **kw) / 0.1,
                               g_rows, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(N.ntxent_bwd_general_cols(*args, **kw) / 0.1,
                               g_cols, atol=1e-5, rtol=1e-5)


def test_partial_losses_of_every_rank_sum_to_the_symmetric_loss():
    z = _unit_rows(24, 6, seed=5)
    full, _ = N.ntxent_fwd_plain(z, 0.1)
    n = 3  # rows per view on each of 4 ranks
    parts = [N.ntxent_partial_fused(
        torch.cat([z[d * n:(d + 1) * n], z[12 + d * n:12 + (d + 1) * n]]), z,
        torch.cat([d * n + torch.arange(n), 12 + d * n + torch.arange(n)]),
        0.1) for d in range(4)]
    # the same terms summed in another order: one fp32 ulp of the sum
    torch.testing.assert_close(sum(parts) / 24, full / 24, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(7, 4), (6,), (0, 4)])
def test_ntxent_rejects_odd_or_malformed_input(shape):
    with pytest.raises(ValueError):
        N.ntxent_loss_fused(torch.zeros(shape), 0.1)


def test_flash_backward_rejects_mismatched_shapes():
    q = torch.randn(2, 5, 8)
    with pytest.raises(ValueError):
        A.flash_attention_dq(q, q, q, q[:, :4], torch.zeros(2, 5),
                             torch.zeros(2, 5))
    with pytest.raises(ValueError):
        A.flash_attention_dkv(q, q, q, q, torch.zeros(2, 4),
                              torch.zeros(2, 5))


def _included_headers(source):
    """The csrc/*.cuh headers a kernel source includes."""
    return [source.parent / line.split('"')[1]
            for line in source.read_text().splitlines()
            if line.startswith('#include "')]


@pytest.mark.parametrize("name,symbols", [
    ("flash_attention_fwd", ["ntx_flash_attention_fwd"]),
    ("ntxent_fwd", ["ntx_ntxent_fwd", "ntx_ntxent_fwd_general"]),
    ("ntxent_bwd_sym", ["ntx_ntxent_bwd_sym"]),
    ("ntxent_bwd_general", ["ntx_ntxent_bwd_general_rows",
                            "ntx_ntxent_bwd_general_cols"]),
    ("flash_attention_bwd", ["ntx_flash_attention_dq",
                             "ntx_flash_attention_dkv"]),
    ("flash_attention_fold", ["ntx_flash_attention_fold"]),
    ("infonce_dual_fwd", ["ntx_infonce_dual_fwd",
                          "ntx_infonce_dual_fwd_rect"]),
    ("infonce_dual_bwd", ["ntx_infonce_dual_bwd", "ntx_infonce_bwd_rows"]),
    ("infonce_bwd_cols", ["ntx_infonce_bwd_cols"]),
    ("ntxent_dual_stats", ["ntx_ntxent_dual_stats",
                           "ntx_ntxent_dual_stats_scratch"]),
    ("ntxent_dual_grads", ["ntx_ntxent_dual_grads",
                           "ntx_ntxent_dual_grads_scratch"]),
    ("ntxent_tri_fwd", ["ntx_ntxent_tri_fwd",
                        "ntx_ntxent_tri_fwd_scratch"]),
    ("ntxent_tri_bwd", ["ntx_ntxent_tri_bwd",
                        "ntx_ntxent_tri_bwd_scratch"]),
])
def test_training_kernels_build_from_repo_sources(tmp_path, name, symbols):
    cmd = _build.nvcc_command(name, tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    source = _build.SOURCES[name]
    assert str(source) in cmd and source.is_file()
    text = source.read_text()
    assert "torch/" not in text and "atomicAdd" not in text
    for header in _included_headers(source):
        assert header.suffix == ".cuh" and header.is_file()
        body = header.read_text()
        assert "torch/" not in body and "atomicAdd" not in body
    for symbol in symbols:
        # a library's scratch size is a count of floats, its entry points
        # return a cudaError_t
        kind = "long long" if symbol.endswith("_scratch") else "int"
        assert f'extern "C" {kind} {symbol}(' in text


# The bf16 launch of each flash source: the entry point's bf16 branches
# and the TMA/wgmma kernel they reach.
BF16_ROUTES = {
    "flash_attention_fwd": (["dtype == 1 && head_dim == 64)\n    return "
                             "launch_tma<64>",
                             "dtype == 1 && head_dim == 128)\n    return "
                             "launch_tma<128>"],
                            "flash_fwd_kernel_tma<D><<<"),
    "flash_attention_bwd": (["dtype == 1 && head_dim == 64) "
                             "NTX_DQ(launch_dq_tma, 64)",
                             "dtype == 1 && head_dim == 128) "
                             "NTX_DQ(launch_dq_tma, 128)",
                             "dtype == 1 && head_dim == 64) "
                             "NTX_DKV(launch_dkv_tma, 64)",
                             "dtype == 1 && head_dim == 128) "
                             "NTX_DKV(launch_dkv_tma, 128)"],
                            "flash_dq_kernel_tma<D><<<"),
    "flash_attention_fold": (["dtype == 1 && head_dim == 64) "
                              "NTX_FOLD(launch_tma, 64)",
                              "dtype == 1 && head_dim == 128) "
                              "NTX_FOLD(launch_tma, 128)"],
                             "flash_fold_kernel_tma<D><<<"),
}


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_bwd",
                                  "flash_attention_fold"])
def test_hopper_flash_kernels_issue_tma_and_wgmma(name):
    """#11, #12, #13 and #14 in bf16 load their tiles by TMA and multiply
    with wgmma: each source's bf16 branches launch its TMA kernel, and
    the instructions sit in csrc/flash_attention_sm90.cuh, which it
    includes."""
    source = _build.SOURCES[name]
    headers = _included_headers(source)
    assert source.parent / "flash_attention_sm90.cuh" in headers
    text = "\n".join(f.read_text() for f in [source, *headers])
    assert "wgmma.mma_async" in text
    assert "cp.async.bulk.tensor" in text
    assert "mbarrier" in text
    branches, launch = BF16_ROUTES[name]
    body = source.read_text()
    for branch in branches:
        assert branch in body
    assert launch in body


def test_no_kernel_source_uses_wmma():
    """Every bf16 flash kernel runs on wgmma; no csrc file keeps the
    older WMMA API."""
    csrc = _build.SOURCES["flash_attention_fwd"].parent
    sources = sorted(csrc.iterdir())
    assert len(sources) >= len(_build.SOURCES)
    for path in sources:
        assert "wmma" not in path.read_text().lower(), path.name


# Where each flash source takes the masks and p from the shared header.
MASK_USES = {
    "flash_attention_fwd": ["sm90::fwd_consume<D>("],
    "flash_attention_fold": ["sm90::fwd_consume<D>("],
    "flash_attention_bwd": ["sm90::QueryRowMask mask(",
                            "sm90::KeyRowMask mask(", "sm90::prob(",
                            "sm90::edge_tile("],
}


@pytest.mark.parametrize("name", sorted(MASK_USES))
def test_hopper_flash_kernels_share_one_mask_rule(name):
    """The bf16 #11, #12, #13 and #14 take the length and causal masks,
    the edge-tile test and p = exp(min(s - m, 0)) from
    csrc/flash_attention_sm90.cuh, where each is defined once; no source
    re-derives the masks' thresholds."""
    source = _build.SOURCES[name]
    header = source.parent / "flash_attention_sm90.cuh"
    body = header.read_text()
    for helper in ("float prob(float x, float m)", "bool edge_tile(",
                   "struct QueryRowMask", "struct KeyRowMask"):
        assert body.count(helper) == 1, helper
    assert "QueryRowMask mask(" in body and "edge_tile(k0, lk" in body
    text = source.read_text()
    for use in MASK_USES[name]:
        assert use in text, use
    assert "n > after" not in text and "n < before" not in text


def test_flash_attention_carries_gradient_on_the_cpu():
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 9, 3, 8, generator=gen).requires_grad_()
               for _ in range(3))
    A.flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NTX_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_ntxent_kernels_match_plain_versions(shape, dtype):
    dev = _cuda()
    rows, d = shape
    z = _unit_rows(rows, d, seed=rows, device=dev, dtype=getattr(torch, dtype))
    before = (N.ntxent_fwd.launches, N.ntxent_bwd_sym.launches)
    loss_sum, lse = N.ntxent_fwd(z, 0.1)
    grad = N.ntxent_bwd_sym(z, lse, 0.1)
    loss_ref, lse_ref = N.ntxent_fwd_plain(z, 0.1)
    grad_ref = N.ntxent_bwd_sym_plain(z, lse_ref, 0.1)
    torch.cuda.synchronize()
    assert (N.ntxent_fwd.launches, N.ntxent_bwd_sym.launches) == (
        before[0] + 1, before[1] + 1)
    assert lse.dtype == grad.dtype == torch.float32
    torch.testing.assert_close(lse, lse_ref, atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(loss_sum / rows, loss_ref / rows,
                               atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(grad, grad_ref, atol=NTX_ATOL, rtol=0)
    # No atomics: the loss is bitwise repeatable.
    again, _ = N.ntxent_fwd(z, 0.1)
    assert again.item() == loss_sum.item()


def _ntxent_errors(z, lse, grad, t=0.1):
    """(lse, grad) max abs errors of a kernel's or a control's readings
    against the plain versions on z."""
    _, lse_ref = N.ntxent_fwd_plain(z, t)
    grad_ref = N.ntxent_bwd_sym_plain(z, lse_ref, t)
    return ((lse - lse_ref).abs().max().item(),
            (grad - grad_ref).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [512, 8192])
def test_cuda_ntxent_kernels_beat_the_tf32_control(rows):
    """fp32 z: the 3xTF32 kernels' lse and gradient errors sit at least
    10x below those of one TF32 pass (the plain version on z rounded to
    TF32, tf32_split's hi), and under NTX_ATOL."""
    dev = _cuda()
    z = _unit_rows(rows, 128, seed=rows + 1, device=dev)
    _, lse = N.ntxent_fwd(z, 0.1)
    grad = N.ntxent_bwd_sym(z, lse, 0.1)
    kernel = _ntxent_errors(z, lse, grad)
    z_tf32 = N.tf32_split(z)[0]
    _, lse_c = N.ntxent_fwd_plain(z_tf32, 0.1)
    control = _ntxent_errors(z, lse_c,
                             N.ntxent_bwd_sym_plain(z_tf32, lse_c, 0.1))
    torch.cuda.synchronize()
    for k, c in zip(kernel, control):
        assert k <= NTX_ATOL
        assert TF32_CONTROL_FACTOR * k <= c, (kernel, control)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_ntxent_kernels_take_every_width(d, dtype):
    dev = _cuda()
    z = _unit_rows(300, d, seed=d, device=dev, dtype=getattr(torch, dtype))
    loss_sum, lse = N.ntxent_fwd(z, 0.1)
    grad = N.ntxent_bwd_sym(z, lse, 0.1)
    loss_ref, lse_ref = N.ntxent_fwd_plain(z, 0.1)
    torch.cuda.synchronize()
    lse_err, grad_err = _ntxent_errors(z, lse, grad)
    assert abs(loss_sum.item() - loss_ref.item()) / 300 <= NTX_ATOL
    assert lse_err <= NTX_ATOL and grad_err <= NTX_ATOL, (lse_err, grad_err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_general_ntxent_forward_takes_every_width(d):
    dev = _cuda()
    zr = _unit_rows(100, d, seed=d, device=dev)
    zc = _unit_rows(1000, d, seed=d + 1, device=dev)
    row_gid, col_gid, total, n_half = _general_case(100, 1000, 6, dev, True)
    kw = dict(col_gid=col_gid, cols_actual=total, n_half=n_half)
    loss_sum, lse = N.ntxent_fwd_general(zr, zc, row_gid, 0.1, **kw)
    loss_ref, lse_ref = N.ntxent_fwd_general_plain(zr, zc, row_gid, 0.1,
                                                   **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_ref, atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(loss_sum / 100, loss_ref / 100,
                               atol=NTX_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("col_ids", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GENERAL_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_cuda_general_ntxent_kernels_match_plain_versions(shape, dtype,
                                                          col_ids):
    dev = _cuda()
    rows, cols, d = shape
    tdt = getattr(torch, dtype)
    zr = _unit_rows(rows, d, seed=rows, device=dev, dtype=tdt)
    zc = _unit_rows(cols, d, seed=cols, device=dev, dtype=tdt)
    row_gid, col_gid, total, n_half = _general_case(rows, cols, 6, dev,
                                                    col_ids)
    kw = dict(col_gid=col_gid, cols_actual=total, n_half=n_half)
    wrappers = (N.ntxent_fwd_general, N.ntxent_bwd_general_rows,
                N.ntxent_bwd_general_cols)
    before = [w.launches for w in wrappers]
    loss_sum, lse = N.ntxent_fwd_general(zr, zc, row_gid, 0.1, **kw)
    g_rows = N.ntxent_bwd_general_rows(zr, zc, row_gid, lse, 0.1, **kw)
    g_cols = N.ntxent_bwd_general_cols(zr, zc, row_gid, lse, 0.1, **kw)
    loss_ref, lse_ref = N.ntxent_fwd_general_plain(zr, zc, row_gid, 0.1,
                                                   **kw)
    g_rows_ref = N.ntxent_bwd_general_rows_plain(zr, zc, row_gid, lse_ref,
                                                 0.1, **kw)
    g_cols_ref = N.ntxent_bwd_general_cols_plain(zr, zc, row_gid, lse_ref,
                                                 0.1, **kw)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    assert lse.dtype == g_rows.dtype == g_cols.dtype == torch.float32
    torch.testing.assert_close(lse, lse_ref, atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(loss_sum / rows, loss_ref / rows,
                               atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(g_rows, g_rows_ref, atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(g_cols, g_cols_ref, atol=NTX_ATOL, rtol=0)
    again, _ = N.ntxent_fwd_general(zr, zc, row_gid, 0.1, **kw)
    assert again.item() == loss_sum.item()


@pytest.mark.cuda
def test_cuda_ntxent_partial_fused_gradients_match_the_cpu():
    dev = _cuda()
    zr_cpu = _unit_rows(128, 128, seed=31).requires_grad_()
    zc_cpu = _unit_rows(512, 128, seed=32).requires_grad_()
    row_gid = _general_case(128, 512, 0)[0]
    zr_gpu, zc_gpu = (t.detach().to(dev).requires_grad_()
                      for t in (zr_cpu, zc_cpu))
    loss_cpu = N.ntxent_partial_fused(zr_cpu, zc_cpu, row_gid, 0.1)
    loss_gpu = N.ntxent_partial_fused(zr_gpu, zc_gpu, row_gid.to(dev), 0.1)
    loss_cpu.backward()
    loss_gpu.backward()
    # a sum of 128 row losses (~840): compare it per row, as loss_sum / R
    torch.testing.assert_close(loss_gpu.cpu() / 128, loss_cpu.detach() / 128,
                               atol=1e-5, rtol=0)
    for c, g in ((zr_cpu, zr_gpu), (zc_cpu, zc_gpu)):
        torch.testing.assert_close(g.grad.cpu(), c.grad, atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.cuda
def test_cuda_ntxent_loss_fused_gradient_matches_the_cpu():
    dev = _cuda()
    z_cpu = _unit_rows(256, 128, seed=9).requires_grad_()
    z_gpu = z_cpu.detach().to(dev).requires_grad_()
    loss_cpu = N.ntxent_loss_fused(z_cpu, 0.1)
    loss_gpu = N.ntxent_loss_fused(z_gpu, 0.1)
    loss_cpu.backward()
    loss_gpu.backward()
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu.detach(), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(z_gpu.grad.cpu(), z_cpu.grad, atol=1e-6,
                               rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_cuda_flash_backward_kernels_match_plain_versions(case, dtype):
    dev = _cuda()
    bh, lq, lk, d, causal, q_off, k_off = BWD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(11)
    tdt = getattr(torch, dtype)
    q, do = (torch.randn(bh, lq, d, generator=gen, device=dev).to(tdt)
             for _ in range(2))
    k, v = (torch.randn(bh, lk, d, generator=gen, device=dev).to(tdt)
            for _ in range(2))
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o, lse = A.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    before = (A.flash_attention_dq.launches, A.flash_attention_dkv.launches)
    dq = A.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = A.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    dq_ref = A.attention_dq_plain(q, k, v, do, lse, delta, **kw)
    dk_ref, dv_ref = A.attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (A.flash_attention_dq.launches,
            A.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    tol = BWD_ATOL[dtype]
    torch.testing.assert_close(dq, dq_ref, atol=tol["dq"], rtol=0)
    torch.testing.assert_close(dk, dk_ref, atol=tol["dkv"], rtol=0)
    torch.testing.assert_close(dv, dv_ref, atol=tol["dkv"], rtol=0)


# The edges of the bf16 dK/dV, dQ and fold kernels' tiles: lengths around
# the 64-row tile, head_dim 64 and 128, causal with k_offset 70, so the
# first 70 query rows have no live key and the kv tiles from position L
# on have no live query.
EDGE_LENGTHS = (1, 63, 64, 65, 197, 300)
EDGE_K_OFFSET = 70


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_cuda_dkv_kernel_edges_match_plain_version(length, d):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(length + d)
    q, k, v, do = (torch.randn(6, length, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, q_offset=0, k_offset=EDGE_K_OFFSET)
    o, lse = A.attention_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = A.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    dk_ref, dv_ref = A.attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(dk, dk_ref, atol=BWD_ATOL["bfloat16"]["dkv"],
                               rtol=0)
    torch.testing.assert_close(dv, dv_ref, atol=BWD_ATOL["bfloat16"]["dkv"],
                               rtol=0)
    # keys after the last query (position length - 1) see no query
    dead = max(0, length - EDGE_K_OFFSET)
    assert torch.all(dk[:, dead:] == 0) and torch.all(dv[:, dead:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_cuda_dq_kernel_edges_match_plain_version(length, d):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(length + d)
    q, k, v, do = (torch.randn(6, length, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, q_offset=0, k_offset=EDGE_K_OFFSET)
    o, lse = A.attention_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = A.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dq_ref = A.attention_dq_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(dq, dq_ref, atol=BWD_ATOL["bfloat16"]["dq"],
                               rtol=0)
    # queries before the first key (position 70) see no key
    assert torch.all(dq[:, :EDGE_K_OFFSET] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_cuda_fold_kernel_edges_match_plain_version(length, d):
    """Two bf16 folds at the tile edges: a block of keys 0 .. L - 1, then
    one at k_offset 70 whose keys the first 70 rows do not see (their
    carry must pass bit for bit), then a block wholly after every row."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(length + d)
    q, k1, v1, k2, v2 = (torch.randn(6, length, d, generator=gen,
                                     device=dev).to(torch.bfloat16)
                         for _ in range(5))
    fresh = (torch.full((6, length), -1e30, device=dev),
             torch.zeros(6, length, device=dev),
             torch.zeros(6, length, d, device=dev))
    first = A.flash_fold(q, k1, v1, *fresh, causal=True)
    want = A.flash_fold_plain(q, k1, v1, *fresh, causal=True)
    kw = dict(causal=True, q_offset=0, k_offset=EDGE_K_OFFSET)
    got = A.flash_fold(q, k2, v2, *first, **kw)
    want = A.flash_fold_plain(q, k2, v2, *want, **kw)
    after = A.flash_fold(q, k2, v2, *got, causal=True, q_offset=0,
                         k_offset=length)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=1e-4)
    o_got = got[2] / got[1][..., None]
    o_want = want[2] / want[1][..., None]
    assert ((o_got - o_want).norm() / o_want.norm()).item() \
        <= FOLD_O_RTOL["bfloat16"]
    blind = slice(0, EDGE_K_OFFSET)
    assert all(torch.equal(a[:, blind], b[:, blind])
               for a, b in zip(got, first))
    assert all(torch.equal(a, b) for a, b in zip(after, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_dq_kernel_wholly_masked_hop_gives_exact_zeros(d, dtype):
    """A ring hop whose keys all come after its queries: no q tile has a
    live kv tile; each loads nothing and writes dq = 0 bit for bit."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v, do = (torch.randn(8, 1024, d, generator=gen, device=dev)
                   .to(getattr(torch, dtype)) for _ in range(4))
    lse, delta = (torch.randn(8, 1024, generator=gen, device=dev)
                  for _ in range(2))
    dq = A.flash_attention_dq(q, k, v, do, lse, delta, causal=True,
                              q_offset=0, k_offset=1024)
    torch.cuda.synchronize()
    assert torch.equal(dq, torch.zeros_like(dq))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_dkv_kernel_wholly_masked_hop_gives_exact_zeros(d, dtype):
    """A ring hop whose keys all come after its queries: every kv tile has
    no live q tile, loads nothing and writes dk = dv = 0 bit for bit."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v, do = (torch.randn(8, 1024, d, generator=gen, device=dev)
                   .to(getattr(torch, dtype)) for _ in range(4))
    lse, delta = (torch.randn(8, 1024, generator=gen, device=dev)
                  for _ in range(2))
    dk, dv = A.flash_attention_dkv(q, k, v, do, lse, delta, causal=True,
                                   q_offset=0, k_offset=1024)
    torch.cuda.synchronize()
    assert torch.equal(dk, torch.zeros_like(dk))
    assert torch.equal(dv, torch.zeros_like(dv))


@pytest.mark.cuda
def test_cuda_flash_attention_gradient_matches_the_cpu():
    """The fault this slice repairs: on the card, flash_attention used to
    return a tensor autograd could not see. Its gradient now goes through
    the backward kernels and matches the CPU's plain backward."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(13)
    qkv = [torch.randn(4, 197, 3, 64, generator=gen) for _ in range(3)]
    cpu = [t.clone().requires_grad_() for t in qkv]
    gpu = [t.to(dev).requires_grad_() for t in qkv]
    w = torch.randn(4, 197, 3, 64, generator=gen)
    (A.flash_attention(*cpu) * w).sum().backward()
    (A.flash_attention(*gpu) * w.to(dev)).sum().backward()
    for c, g in zip(cpu, gpu):
        assert g.grad is not None
        torch.testing.assert_close(g.grad.cpu(), c.grad, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_vit_flash_block_gets_qkv_gradients():
    from ntxent_tpu_torch.models import VisionTransformer, init_weights

    dev = _cuda()
    vit = init_weights(VisionTransformer(image_size=32, patch_size=16,
                                         hidden_dim=128, depth=2, num_heads=2,
                                         mlp_dim=256, attention_impl="flash"),
                       torch.Generator().manual_seed(0)).to(dev)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(4, 32, 32, 3)).astype(np.float32)).to(dev)
    vit(x).square().sum().backward()
    for block in vit.blocks:
        for proj in (block.attn.query, block.attn.key, block.attn.value):
            assert proj.weight.grad is not None
            assert proj.weight.grad.abs().sum().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", INFONCE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_infonce_kernels_match_plain_versions(shape, dtype):
    dev = _cuda()
    n, d = shape
    tdt = getattr(torch, dtype)
    za = _unit_rows(n, d, seed=n + d, device=dev, dtype=tdt)
    zb = _unit_rows(n, d, seed=n + d + 1, device=dev, dtype=tdt)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    before = (I.infonce_dual_fwd.launches, I.infonce_dual_bwd.launches)
    loss_sum, lse_a, lse_b = I.infonce_dual_fwd(za, zb, scale)
    o_a, o_b = I.infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
    loss_ref, lse_a_ref, lse_b_ref = I.infonce_dual_fwd_plain(za, zb, scale)
    o_a_ref, o_b_ref = I.infonce_dual_bwd_plain(za, zb, scale, lse_a_ref,
                                                lse_b_ref)
    torch.cuda.synchronize()
    assert (I.infonce_dual_fwd.launches, I.infonce_dual_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert lse_a.dtype == o_a.dtype == o_b.dtype == torch.float32
    torch.testing.assert_close(lse_a, lse_a_ref, atol=INFONCE_ATOL, rtol=0)
    torch.testing.assert_close(lse_b, lse_b_ref, atol=INFONCE_ATOL, rtol=0)
    torch.testing.assert_close(loss_sum / (2 * n), loss_ref / (2 * n),
                               atol=INFONCE_ATOL, rtol=0)
    torch.testing.assert_close(o_a, o_a_ref, atol=INFONCE_ATOL, rtol=0)
    torch.testing.assert_close(o_b, o_b_ref, atol=INFONCE_ATOL, rtol=0)
    # No atomics: the loss is bitwise repeatable.
    again = I.infonce_dual_fwd(za, zb, scale)[0]
    assert again.item() == loss_sum.item()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1000, 8192])
def test_cuda_infonce_kernels_beat_the_tf32_control(n):
    """fp32 at D = 512: the 3xTF32 #9 and #10 err at least 10x less on lse
    and on the gradients than one TF32 pass (the plain versions on za, zb
    rounded to TF32), the gradients at the plain forward's lse."""
    dev = _cuda()
    za = _unit_rows(n, 512, seed=n, device=dev)
    zb = _unit_rows(n, 512, seed=n + 1, device=dev)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    _, *lse = I.infonce_dual_fwd_plain(za, zb, scale)
    za_c, zb_c = N.tf32_split(za)[0], N.tf32_split(zb)[0]
    got = (*I.infonce_dual_fwd(za, zb, scale)[1:],
           *I.infonce_dual_bwd(za, zb, scale, *lse))
    ctl = (*I.infonce_dual_fwd_plain(za_c, zb_c, scale)[1:],
           *I.infonce_dual_bwd_plain(za_c, zb_c, scale, *lse))
    want = (*lse, *I.infonce_dual_bwd_plain(za, zb, scale, *lse))
    torch.cuda.synchronize()
    for part in (slice(0, 2), slice(2, 4)):  # lse, then the gradients
        k = max((g - w).abs().max().item()
                for g, w in zip(got[part], want[part]))
        c = max((g - w).abs().max().item()
                for g, w in zip(ctl[part], want[part]))
        assert k <= INFONCE_ATOL
        assert TF32_CONTROL_FACTOR * k <= c, (part, k, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_infonce_kernels_take_every_width(d):
    """D padded to 32, one to four chunks of D in #10, and the fp32 row
    tile streaming through the ring past D = 256, at a ragged N in both
    modes of #9."""
    dev = _cuda()
    za = _unit_rows(1000, d, seed=d, device=dev)
    zb = _unit_rows(1000, d, seed=d + 1, device=dev)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    loss, lse_a, lse_b = I.infonce_dual_fwd(za, zb, scale)
    o_a, o_b = I.infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
    rect = I.infonce_dual_fwd_rect(za[:101], zb, scale)
    loss_ref, *lse_ref = I.infonce_dual_fwd_plain(za, zb, scale)
    o_ref = I.infonce_dual_bwd_plain(za, zb, scale, lse_a, lse_b)
    rect_ref = I.infonce_dual_fwd_rect_plain(za[:101], zb, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(loss / 2000, loss_ref / 2000,
                               atol=INFONCE_ATOL, rtol=0)
    for got, want in zip((lse_a, lse_b, o_a, o_b, *rect),
                         (*lse_ref, *o_ref, *rect_ref)):
        torch.testing.assert_close(got, want, atol=INFONCE_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_info_nce_fused_gradients_match_the_cpu():
    """za, zb and the learnable scale get the CPU's gradients."""
    dev = _cuda()
    za, zb = _unit_rows(256, 512, seed=21), _unit_rows(256, 512, seed=22)
    scale = torch.tensor(INFONCE_SCALE)
    cpu = [t.clone().requires_grad_() for t in (za, zb, scale)]
    gpu = [t.to(dev).requires_grad_() for t in (za, zb, scale)]
    loss_cpu = I.info_nce_fused(cpu[0], cpu[1], scale=cpu[2])
    loss_gpu = I.info_nce_fused(gpu[0], gpu[1], scale=gpu[2])
    loss_cpu.backward()
    loss_gpu.backward()
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu.detach(), atol=1e-5,
                               rtol=0)
    for c, g in zip(cpu, gpu):
        torch.testing.assert_close(g.grad.cpu(), c.grad, atol=1e-6,
                                   rtol=1e-4)


def _dp_row_ids(rows, cols, seed, device):
    """The last rank's row ids where rows divide cols, else scattered ids
    with a padding row (id = cols) last."""
    if cols % rows == 0:
        return (cols - rows + torch.arange(rows, dtype=torch.int32)).to(
            device)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randperm(cols, generator=gen)[:rows].to(torch.int32)
    ids[-1] = cols
    return ids.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DP_INFONCE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_dp_infonce_kernels_match_plain_versions(shape, dtype):
    dev = _cuda()
    rows, cols, d = shape
    tdt = getattr(torch, dtype)
    za = _unit_rows(rows, d, seed=rows + d, device=dev, dtype=tdt)
    zb = _unit_rows(cols, d, seed=cols + d, device=dev, dtype=tdt)
    gid = _dp_row_ids(rows, cols, seed=rows, device=dev)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    wrappers = (I.infonce_dual_fwd_rect, I.infonce_bwd_rows,
                I.infonce_bwd_cols)
    before = [w.launches for w in wrappers]
    lse_a, lse_b = I.infonce_dual_fwd_rect(za, zb, scale)
    o_a = I.infonce_bwd_rows(za, zb, gid, scale, lse_a, lse_b)
    o_b = I.infonce_bwd_cols(za, zb, gid, scale, lse_a, lse_b)
    ref_a, ref_b = I.infonce_dual_fwd_rect_plain(za, zb, scale)
    ref_oa = I.infonce_bwd_rows_plain(za, zb, gid, scale, lse_a, lse_b)
    ref_ob = I.infonce_bwd_cols_plain(za, zb, gid, scale, lse_a, lse_b)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    assert o_a.shape == (rows, d) and o_b.shape == (cols, d)
    for got, want in ((lse_a, ref_a), (lse_b, ref_b), (o_a, ref_oa),
                      (o_b, ref_ob)):
        torch.testing.assert_close(got, want, atol=INFONCE_ATOL, rtol=0)
    # one owner per output row, no atomics: bitwise repeatable
    again_a, again_b = I.infonce_dual_fwd_rect(za, zb, scale)
    assert torch.equal(again_a, lse_a) and torch.equal(again_b, lse_b)
    assert torch.equal(I.infonce_bwd_cols(za, zb, gid, scale, lse_a, lse_b),
                       o_b)
    assert torch.equal(I.infonce_bwd_rows(za, zb, gid, scale, lse_a, lse_b),
                       o_a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DP_INFONCE_SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_dp_infonce_backward_beats_the_tf32_control(shape):
    """fp32: the 3xTF32 #5 cross-modal and #4 err at least 10x less
    than one TF32 pass (the plain versions on za, zb rounded to TF32) at
    the same lse."""
    dev = _cuda()
    rows, cols, d = shape
    za = _unit_rows(rows, d, seed=rows, device=dev)
    zb = _unit_rows(cols, d, seed=cols + 1, device=dev)
    gid = _dp_row_ids(rows, cols, seed=rows, device=dev)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    lse = I.infonce_dual_fwd_rect_plain(za, zb, scale)
    za_c, zb_c = N.tf32_split(za)[0], N.tf32_split(zb)[0]
    for kernel, plain in ((I.infonce_bwd_rows, I.infonce_bwd_rows_plain),
                          (I.infonce_bwd_cols, I.infonce_bwd_cols_plain)):
        want = plain(za, zb, gid, scale, *lse)
        got = kernel(za, zb, gid, scale, *lse)
        ctl = plain(za_c, zb_c, gid, scale, *lse)
        torch.cuda.synchronize()
        k, c = (got - want).abs().max().item(), (ctl - want).abs().max().item()
        assert k <= INFONCE_ATOL
        assert TF32_CONTROL_FACTOR * k <= c, (kernel.__name__, k, c)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DP_INFONCE_SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_dp_infonce_forward_beats_the_tf32_control(shape):
    """fp32: the 3xTF32 #9 rectangular errs at least 10x less on both lse
    than one TF32 pass."""
    dev = _cuda()
    rows, cols, d = shape
    za = _unit_rows(rows, d, seed=rows, device=dev)
    zb = _unit_rows(cols, d, seed=cols + 1, device=dev)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    want = I.infonce_dual_fwd_rect_plain(za, zb, scale)
    got = I.infonce_dual_fwd_rect(za, zb, scale)
    ctl = I.infonce_dual_fwd_rect_plain(N.tf32_split(za)[0],
                                        N.tf32_split(zb)[0], scale)
    torch.cuda.synchronize()
    k = max((g - w).abs().max().item() for g, w in zip(got, want))
    c = max((g - w).abs().max().item() for g, w in zip(ctl, want))
    assert k <= INFONCE_ATOL
    assert TF32_CONTROL_FACTOR * k <= c, (k, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_dp_infonce_backward_takes_every_width(d):
    """D padded to 32, one to four chunks of D, and the fp32 row tile
    streaming through the ring past D = 256, on a ragged shape with a
    padding row."""
    dev = _cuda()
    za = _unit_rows(101, d, seed=d, device=dev)
    zb = _unit_rows(1000, d, seed=d + 1, device=dev)
    gid = _dp_row_ids(101, 1000, seed=d, device=dev)
    scale = torch.tensor(INFONCE_SCALE, device=dev)
    lse = I.infonce_dual_fwd_rect_plain(za, zb, scale)
    for kernel, plain in ((I.infonce_bwd_rows, I.infonce_bwd_rows_plain),
                          (I.infonce_bwd_cols, I.infonce_bwd_cols_plain)):
        got = kernel(za, zb, gid, scale, *lse)
        want = plain(za, zb, gid, scale, *lse)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=INFONCE_ATOL, rtol=0)


def _pair_case(rows, cols, d, world, device, dtype=torch.float32):
    """(z_rows, z_cols, row ids, column ids, total) of one shard-pair tile:
    rank 0's rows against shard (1 mod world)'s columns, or, for world
    None, ids scattered over 4 (rows + cols) with 20 shared by rows and
    columns, two sentinel rows and three sentinel columns."""
    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    if world is not None:
        rid = local_row_gids(0, rows // 2, world)
        cid = local_row_gids(1 % world, cols // 2, world)
        total = rows * world
    else:
        total = 4 * (rows + cols)
        perm = torch.randperm(total, generator=torch.Generator().manual_seed(
            rows)).to(torch.int32)
        rid = perm[:rows].clone()
        cid = torch.cat([perm[rows - 20:rows], perm[rows:rows + cols - 20]])
        rid[[3, 50]] = total
        cid[[7, 8, 200]] = total
    return (_unit_rows(rows, d, seed=rows + d, device=device, dtype=dtype),
            _unit_rows(cols, d, seed=cols + d + 3, device=device,
                       dtype=dtype),
            rid.to(device), cid.to(device), total)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAIR_CASES,
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_cuda_pair_kernels_match_plain_versions(case, dtype):
    dev = _cuda()
    zr, zc, rid, cid, total = _pair_case(*case, dev, getattr(torch, dtype))
    args = (zr, zc, rid, cid)
    before = (N.block_lse_dual.launches, N.block_grads_dual.launches)
    lse = N.block_lse_dual(*args, 0.1, total)
    want_lse = N.block_lse_dual_plain(*args, 0.1, total)
    grads = N.block_grads_dual(*args, *want_lse, 0.1, total)
    want_grads = N.block_grads_dual_plain(*args, *want_lse, 0.1, total)
    torch.cuda.synchronize()
    assert (N.block_lse_dual.launches, N.block_grads_dual.launches) == (
        before[0] + 1, before[1] + 1)
    for got, want in zip((*lse, *grads), (*want_lse, *want_grads)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=NTX_ATOL, rtol=0)
    # one owner per output, no atomics: bitwise repeatable
    again = (*N.block_lse_dual(*args, 0.1, total),
             *N.block_grads_dual(*args, *want_lse, 0.1, total))
    assert all(torch.equal(a, b) for a, b in zip(again, (*lse, *grads)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [PAIR_CASES[0], PAIR_CASES[2]],
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_cuda_pair_kernels_beat_the_tf32_control(case):
    """fp32: the 3xTF32 #7 and #8 err at least 10x less than one TF32
    pass (the plain versions on z_rows, z_cols rounded to TF32) on both lse
    and on both gradients at the same lse."""
    dev = _cuda()
    zr, zc, rid, cid, total = _pair_case(*case, dev)
    lse = N.block_lse_dual_plain(zr, zc, rid, cid, 0.1, total)
    grads = N.block_grads_dual_plain(zr, zc, rid, cid, *lse, 0.1, total)
    zr_c, zc_c = N.tf32_split(zr)[0], N.tf32_split(zc)[0]
    for got, ctl, want in (
            (N.block_lse_dual(zr, zc, rid, cid, 0.1, total),
             N.block_lse_dual_plain(zr_c, zc_c, rid, cid, 0.1, total), lse),
            (N.block_grads_dual(zr, zc, rid, cid, *lse, 0.1, total),
             N.block_grads_dual_plain(zr_c, zc_c, rid, cid, *lse, 0.1,
                                      total), grads)):
        torch.cuda.synchronize()
        k = max((g - w).abs().max().item() for g, w in zip(got, want))
        c = max((g - w).abs().max().item() for g, w in zip(ctl, want))
        assert k <= NTX_ATOL
        assert TF32_CONTROL_FACTOR * k <= c, (k, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_pair_kernels_take_every_width(d, dtype):
    """D padded to 32, one to four chunks of D in #8, and the fp32 row
    tile streaming through the ring past D = 256, on the ragged tile."""
    dev = _cuda()
    zr, zc, rid, cid, total = _pair_case(100, 260, d, None, dev,
                                         getattr(torch, dtype))
    args = (zr, zc, rid, cid)
    want_lse = N.block_lse_dual_plain(*args, 0.1, total)
    got = (*N.block_lse_dual(*args, 0.1, total),
           *N.block_grads_dual(*args, *want_lse, 0.1, total))
    want = (*want_lse,
            *N.block_grads_dual_plain(*args, *want_lse, 0.1, total))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=NTX_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [512, 4096])
def test_cuda_tri_kernels_beat_the_tf32_control(rows):
    """fp32: the 3xTF32 #2 and #3 err at least 10x less than one TF32 pass
    (the plain versions on z rounded to TF32) on lse and on the gradient
    at the same lse, and repeat bit for bit."""
    dev = _cuda()
    z = _unit_rows(rows, 128, rows, dev)
    _, lse = N.ntxent_fwd_tri_plain(z, 0.1)
    grad = N.ntxent_bwd_tri_plain(z, lse, 0.1)
    z_c = N.tf32_split(z)[0]
    got = (N.ntxent_fwd_tri(z, 0.1)[1], N.ntxent_bwd_tri(z, lse, 0.1))
    again = (N.ntxent_fwd_tri(z, 0.1)[1], N.ntxent_bwd_tri(z, lse, 0.1))
    ctl = (N.ntxent_fwd_tri_plain(z_c, 0.1)[1],
           N.ntxent_bwd_tri_plain(z_c, lse, 0.1))
    torch.cuda.synchronize()
    for g, c, w, a in zip(got, ctl, (lse, grad), again):
        k, e = (g - w).abs().max().item(), (c - w).abs().max().item()
        assert k <= NTX_ATOL
        assert TF32_CONTROL_FACTOR * k <= e, (k, e)
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_tri_kernels_take_every_width(d, dtype):
    """D padded to 32, one to four chunks of D in #3, and the fp32 row
    tile streaming through the ring past D = 256, at a 2N of no multiple
    of 64 (2N = 300: the last row tile's padding rows)."""
    dev = _cuda()
    z = _unit_rows(300, d, d, dev, getattr(torch, dtype))
    loss_p, lse_p = N.ntxent_fwd_tri_plain(z, 0.1)
    loss, lse = N.ntxent_fwd_tri(z, 0.1)
    grad = N.ntxent_bwd_tri(z, lse_p, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, atol=NTX_ATOL, rtol=0)
    torch.testing.assert_close(loss / 300, loss_p / 300, atol=NTX_ATOL,
                               rtol=0)
    torch.testing.assert_close(grad, N.ntxent_bwd_tri_plain(z, lse_p, 0.1),
                               atol=NTX_ATOL, rtol=0)


# (BH, Lq, Lk, D, dtype, causal, q_offset, k_offsets of three folds)
FOLD_CASES = {
    "noncausal_bf16": (8, 1024, 1024, 64, "bfloat16", False, 0,
                       (0, 1024, 2048)),
    "partly_masked_fp32": (4, 300, 500, 128, "float32", True, 900,
                           (0, 500, 1000)),
    "diagonal_bf16": (4, 200, 200, 64, "bfloat16", True, 200,
                      (0, 200, 200)),
}
# acc / l against the plain version as |a - b| / |b| over the tensor: fp32
# summation order -> 1e-5; bf16, p rounded to bf16 at another running
# maximum -> 1e-2 (a typical |acc / l| is 1 / sqrt(keys), too small for an
# absolute limit)
FOLD_O_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_cuda_flash_fold_matches_its_plain_version(case):
    dev = _cuda()
    bh, lq, lk, d, dtype, causal, q_off, k_offs = FOLD_CASES[case]
    gen = torch.Generator().manual_seed(lq + lk)
    dt = getattr(torch, dtype)
    q = torch.randn(bh, lq, d, generator=gen).to(dev, dt)
    carry = (torch.full((bh, lq), -1e30, device=dev),
             torch.zeros(bh, lq, device=dev),
             torch.zeros(bh, lq, d, device=dev))
    want = carry
    for k_off in k_offs:
        k, v = (torch.randn(bh, lk, d, generator=gen).to(dev, dt)
                for _ in range(2))
        kw = dict(q_offset=q_off, k_offset=k_off, causal=causal)
        carry = A.flash_fold(q, k, v, *carry, **kw)
        want = A.flash_fold_plain(q, k, v, *want, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(carry[0], want[0], atol=1e-4, rtol=0)
        torch.testing.assert_close(carry[1], want[1], atol=0, rtol=1e-4)
        o_got = carry[2] / carry[1][..., None]
        o_want = want[2] / want[1][..., None]
        assert ((o_got - o_want).norm() / o_want.norm()).item() \
            <= FOLD_O_RTOL[dtype]
    # a block wholly after every row: the carry goes out bit for bit
    after = A.flash_fold(q, k, v, *carry, q_offset=q_off,
                         k_offset=q_off + lq, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(after, carry))


# ---------------------------------------------------------------------------
# The InfoNCE mode of #1 and #6 (info_nce_partial_fused)
# ---------------------------------------------------------------------------

# (R, C, D): the two-pass CLIP path at batch 256 on one card, one rank of 4
# at batch 4096, a ragged shape with scattered row ids and a padding row.
TWOPASS_SHAPES = [(256, 256, 512), (1024, 4096, 512), (101, 1000, 96)]
TWOPASS_SCALES = [14.3, 100.0]  # CLIP's initial exp(logit_scale), its cap


def _twopass_atol(scale):
    return NTX_ATOL * max(1.0, scale / 10)


def _twopass(za, zb, gid, scale, plain=False):
    """(loss_sum, lse, grad rows, grad cols) of #1 and #6 in the InfoNCE
    mode, from the kernels or their plain versions."""
    kw = dict(diag_pos=True, scale=scale)
    fwd, rows, cols = ((N.ntxent_fwd_general_plain,
                        N.ntxent_bwd_general_rows_plain,
                        N.ntxent_bwd_general_cols_plain) if plain else
                       (N.ntxent_fwd_general, N.ntxent_bwd_general_rows,
                        N.ntxent_bwd_general_cols))
    loss, lse = fwd(za, zb, gid, 1.0, **kw)
    return (loss, lse, rows(za, zb, gid, lse, 1.0, **kw),
            cols(za, zb, gid, lse, 1.0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", TWOPASS_SCALES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TWOPASS_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_general_kernels_infonce_mode_match_plain_versions(shape, dtype,
                                                                scale):
    dev = _cuda()
    rows, cols, d = shape
    tdt = getattr(torch, dtype)
    za = _unit_rows(rows, d, seed=rows + d, device=dev, dtype=tdt)
    zb = _unit_rows(cols, d, seed=cols + d, device=dev, dtype=tdt)
    gid = _dp_row_ids(rows, cols, seed=rows, device=dev)
    sc = torch.tensor(scale, device=dev)
    wrappers = (N.ntxent_fwd_general, N.ntxent_bwd_general_rows,
                N.ntxent_bwd_general_cols)
    before = [w.launches for w in wrappers]
    got = _twopass(za, zb, gid, sc)
    want = _twopass(za, zb, gid, sc, plain=True)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    atol = _twopass_atol(scale)
    torch.testing.assert_close(got[0] / rows, want[0] / rows, atol=atol,
                               rtol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=atol, rtol=0)
    again = _twopass(za, zb, gid, sc)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TWOPASS_SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_general_kernels_infonce_mode_beat_the_tf32_control(shape):
    """fp32: the 3xTF32 #1 and #6 err at least 10x less than one TF32 pass
    (the plain versions on za, zb rounded to TF32) on lse and on both
    gradients."""
    dev = _cuda()
    rows, cols, d = shape
    za = _unit_rows(rows, d, seed=rows, device=dev)
    zb = _unit_rows(cols, d, seed=cols + 1, device=dev)
    gid = _dp_row_ids(rows, cols, seed=rows, device=dev)
    sc = torch.tensor(TWOPASS_SCALES[0], device=dev)
    want = _twopass(za, zb, gid, sc, plain=True)
    got = _twopass(za, zb, gid, sc)
    ctl = _twopass(N.tf32_split(za)[0], N.tf32_split(zb)[0], gid, sc,
                   plain=True)
    torch.cuda.synchronize()
    for g, c, w in zip(got[1:], ctl[1:], want[1:]):
        k, e = (g - w).abs().max().item(), (c - w).abs().max().item()
        assert k <= _twopass_atol(TWOPASS_SCALES[0])
        assert TF32_CONTROL_FACTOR * k <= e, (k, e)


@pytest.mark.cuda
@pytest.mark.parametrize("d", NTX_EDGE_DIMS)
def test_cuda_general_ntxent_backward_takes_every_width(d):
    dev = _cuda()
    zr = _unit_rows(100, d, seed=d, device=dev)
    zc = _unit_rows(1000, d, seed=d + 1, device=dev)
    row_gid, col_gid, total, n_half = _general_case(100, 1000, 6, dev, True)
    kw = dict(col_gid=col_gid, cols_actual=total, n_half=n_half)
    _, lse = N.ntxent_fwd_general_plain(zr, zc, row_gid, 0.1, **kw)
    for kernel, plain in ((N.ntxent_bwd_general_rows,
                           N.ntxent_bwd_general_rows_plain),
                          (N.ntxent_bwd_general_cols,
                           N.ntxent_bwd_general_cols_plain)):
        got = kernel(zr, zc, row_gid, lse, 0.1, **kw)
        want = plain(zr, zc, row_gid, lse, 0.1, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=NTX_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_tf32_walks_raise_past_the_grid_width():
    """Any D up to N.MAX_WIDTH runs (the backward grid's 65535 chunks of
    128); a wider z raises, naming the width, before any launch."""
    dev = _cuda()
    z = torch.zeros(2, N.MAX_WIDTH + 1, device=dev)
    gid = torch.arange(2, device=dev)
    lse = torch.zeros(2, device=dev)
    for call in (lambda: N.ntxent_fwd(z, 0.1),
                 lambda: N.ntxent_bwd_sym(z, lse, 0.1),
                 lambda: N.ntxent_fwd_general(z, z, gid, 0.1),
                 lambda: N.ntxent_bwd_general_rows(z, z, gid, lse, 0.1),
                 lambda: N.ntxent_bwd_general_cols(z, z, gid, lse, 0.1)):
        with pytest.raises(ValueError, match=f"D = {N.MAX_WIDTH + 1}"):
            call()


@pytest.mark.cuda
def test_cuda_info_nce_partial_fused_gradients_match_the_cpu():
    """The two-pass partial sum: za, zb and the learnable scale get the
    CPU's gradients."""
    dev = _cuda()
    za, zb = _unit_rows(256, 512, seed=23), _unit_rows(256, 512, seed=24)
    gid = torch.arange(256, dtype=torch.int32)
    scale = torch.tensor(TWOPASS_SCALES[0])
    cpu = [t.clone().requires_grad_() for t in (za, zb, scale)]
    gpu = [t.to(dev).requires_grad_() for t in (za, zb, scale)]
    loss_cpu = I.info_nce_partial_fused(cpu[0], cpu[1], gid, scale=cpu[2])
    loss_gpu = I.info_nce_partial_fused(gpu[0], gpu[1], gid.to(dev),
                                        scale=gpu[2])
    (loss_cpu / 256).backward()
    (loss_gpu / 256).backward()
    torch.testing.assert_close(loss_gpu.cpu() / 256, loss_cpu.detach() / 256,
                               atol=1e-5, rtol=0)
    for c, g in zip(cpu, gpu):
        torch.testing.assert_close(g.grad.cpu(), c.grad, atol=1e-6,
                                   rtol=1e-4)
