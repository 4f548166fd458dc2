"""Where the port's serving forward and training steps spend device time.

Nine modes, all but ``ntxent`` on the model of its slice (ViT-B/16 or
ResNet-50 at 224 px, random weights from seed 0):

``--mode forward`` (the default; serving): for one batch-size bucket and
each attention impl,

* times the forward with CUDA events (10 calls after warmup): ms per
  forward and images/s;
* traces 3 forwards with ``torch.profiler`` and sums the device time of
  every kernel, grouped as the hand-written kernels, matrix products
  (cuBLAS/CUTLASS) and everything else, with the device's busy share of
  the traced wall time and the top kernels by time.

``--mode train`` (the training slice, ``--vit-attention flash``): one
``ntxent-train`` step at ``--batch`` (2B views through the encoder) on a
fixed pair of augmented views,

* times the step with CUDA events: step ms and images/s (2B per step);
* times the two-view augmentation of one batch apart;
* traces 3 steps: device busy share, device ms by kernel group, the ms of
  each hand-written kernel and the top kernels;
* counts each kernel's launches per step and the peak device memory.

``--mode clip`` (the CLIP slice, ``--vit-attention flash``): one
``ntxent-train --objective clip`` step of CLIP ViT-B/16 (image tower
ViT-B/16, text tower width 512, 12 blocks, 77 tokens of a 49408-id
vocabulary, embedding 512) at ``--batch`` pairs on fixed synthetic pairs,

* times the step with CUDA events: step ms and images/s (B per step);
* times apart, with CUDA events, each tower's forward and backward, the
  InfoNCE loss's forward and backward, and the AdamW update;
* traces 3 steps as ``--mode train`` does, and counts launches and peak
  device memory.

``--mode dp`` (the data-parallel slice): one step of data-parallel
ResNet-50 SimCLR (``make_sharded_train_step``, cross-replica BatchNorm,
the ``--dp-loss`` schedule: ``strip`` by default, ``pair``, or
``chunked`` with ``--ring-chunks C``; the ``--collective-dtype`` wire,
float32 by default, ``bf16`` or ``int8`` with error feedback) over an
NCCL process group of world size 1 at ``--batch`` (2B views at 224 px)
on a fixed pair of augmented views,

* times the step with CUDA events: step ms and images/s (2B per step);
* times apart the encoder's forward and backward, the loss's forward and
  backward with its collectives, and the gradient pmean with the LARS
  update;
* traces 3 steps as ``--mode train`` does (cuDNN's convolutions fall in
  the ``matmul`` group, BatchNorm's element-wise passes in ``other``),
  and counts launches and peak device memory.

``--mode clip_dp`` (the data-parallel CLIP slice): one step of
data-parallel CLIP ViT-B/16 (``make_sharded_clip_train_step``, the dual
InfoNCE) over an NCCL process group of world size 1 at ``--batch`` pairs
on fixed synthetic pairs,

* times the step with CUDA events: step ms and images/s (B per step);
* times apart each tower's forward and backward, the loss's forward and
  backward with its collectives (the all-gather, the column-lse ``pmax``
  and ``psum``, the loss ``psum``), the gradient ``pmean`` and the AdamW
  update;
* traces 3 steps as ``--mode train`` does, and counts launches and peak
  device memory.

``--mode longctx`` (the long-context slice): one forward and backward
of the probe ``sum(out^2)`` through ``LongContextTransformer`` at the
JAX package's defaults (hidden 512, depth 8, 8 heads, MLP 2048,
``max_len`` 32768, bf16 over fp32 weights) with the CLIP text vocabulary
of 49408 ids, batch 1 at L = 32768, causal, under
``make_ring_attention(group, causal=True, impl="flash")`` over an NCCL
process group of world size 1; with ``--ring-emulate P``, under P ring
ranks emulated in one process instead (``emulated_ring_attention``),

* times the pass with CUDA events: ms per forward and backward and
  tokens/s;
* traces 3 passes: device busy share, the device ms of the fold (#12),
  dQ (#13) and dK/dV (#14) kernels and the other groups, and counts each
  kernel's launches per pass and the peak device memory.

``--mode ntxent`` (the NT-Xent kernels alone): #1 and #5 in fp32 at D =
128, 2N = 512 (the SimCLR path at ``--batch 256``, T = 0.1), 4096 (the
reference's headline shape: ``bench.py`` times z (4096, 128) at T =
0.07) and 8192 (T = 0.1), and ``ntxent_loss_fused``'s forward and
backward at each; #1's general mode and #6's rows and columns kernels at
the (R, C, D) of ``NTXENT_STRIPS``: in the NT-Xent mode one rank of 4 at
global batch 256, world 1 at 256, the ring NT-Xent's P = 4 hop and one
rank of 4 at 4096 (D = 128), and in the InfoNCE mode (``diag_pos``, the
scale 14.3 on the device) the two-pass CLIP of world 1 at batch 256 and
one rank of 4 at 4096 (D = 512), which a tree whose kernels take D <= 256
skips (its ``ops.ntxent.MAX_DIM``), and the data-parallel CLIP
backward (#5 cross-modal, #4) at the (R, C, D) of ``DP_CLIP_STRIPS``
(world 1 and one rank of 4 at batch 256, one rank of 4 at 4096, D =
512, the scale 14.3), and the CLIP kernels #9 (square) and #10 at the
(N, D) of ``INFONCE_SQUARE`` (CLIP at batch 256, N = 8192) and #9's
rectangular mode at the (R, C, D) of ``INFONCE_RECT`` (one rank of 4 at
batch 256 and 4096), and the shard-pair kernels #7 (``block_lse_dual``)
and #8 (``block_grads_dual``) at the tiles of ``PAIR_TILES`` (the
world-1 self tile of ``--dp-loss pair`` at batch 256, the k = 1 tile of
rank 0 of 4 at global batch 256 and 4096, D = 128, T = 0.1): copied
into an older tree, the module times what that tree can run,

* times each call with CUDA events (20 calls after warmup), and the
  host's ms of one call at 2N = 512, of #9 and #10 at N = 256 and of #7
  and #8 at the self tile (no synchronisation in the loop).

``--mode pipeline`` (the input pipeline): ``ntxent-train``'s SimCLR
ViT-B/16 path at ``--batch`` for ``PIPELINE_STEPS`` steps through
``cli.train``, with the train flags given after ``--`` (``--store N``
first writes a uint8 npy row store of N rows at 224 px from seed 0 and
adds ``--dataset npy --data-dir`` it),

* the mean over the records of steps 2 .. PIPELINE_STEPS - 1 (host
  clock; under ``--lag-metrics`` the last record holds no queueing) of
  the step ms, the data wait ms a step and, under ``--prefetch``, the
  host fetch and transfer dispatch ms; a tree whose ``train_loop``
  records no data wait reports None for it.

``--mode moe`` (the MoE slice): one switch-MoE layer of the ViT-B/16 MoE
path (8 experts of 3072, the tokens of ``--batch`` x 2 views of 197, width
768, bf16, inputs layer-normed around a common direction, as the path's
tokens at initialization route mostly alike) against the dense MLP of the
same width on the same tokens, forward and backward,

* times each in turns with CUDA events (dense, MoE, MoE, dense);
* its peak memory above the inputs, the share of dropped tokens;
* traces the MoE layer: device ms by kernel group and the top kernels.

Run on the card, from the repository root:

    python -m ntxent_tpu_torch.utils.profiling --bucket 64 --impls flash,xla
    python -m ntxent_tpu_torch.utils.profiling --mode train --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode clip --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode dp --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode dp --dp-loss chunked \
        --ring-chunks 4 --collective-dtype int8 --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode dp --dp-loss pair \
        --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode clip_dp --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode clip_dp --batch 256 \
        --infonce twopass
    python -m ntxent_tpu_torch.utils.profiling --mode longctx
    python -m ntxent_tpu_torch.utils.profiling --mode longctx \
        --ring-emulate 4
    python -m ntxent_tpu_torch.utils.profiling --mode ntxent
    python -m ntxent_tpu_torch.utils.profiling --mode moe --batch 256
    python -m ntxent_tpu_torch.utils.profiling --mode pipeline --store 1280 \
        -- --loader native --prefetch 2 --lag-metrics --nan-policy skip

The last line of the output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from collections import defaultdict

import torch

from ..ops import attention
from ..ops.ntxent import _log_l, block_grads
from ..parallel import ring as ring_losses
from ..parallel import ring_attention
from ..parallel.mesh import chunk_bounds, local_row_gids

__all__ = ["cuda_time_ms", "kernel_breakdown", "main"]

_GEMM_MARKERS = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")
# Device-function name of each hand-written kernel -> its wrapper's name.
_KERNELS = (("flash_fwd_kernel", "flash_attention_fwd"),
            ("flash_fold_kernel", "flash_fold"),
            ("flash_dq_kernel", "flash_attention_dq"),
            ("flash_dkv_kernel", "flash_attention_dkv"),
            # the TF32 kernels of #1, #5 and #6 (prep, walk, merge,
            # reduce, sum): each name carries its mode or side
            ("ntxent_fwd_general_", "ntxent_fwd_general"),
            ("ntxent_fwd_sym_", "ntxent_fwd"),
            ("ntxent_bwd_sym_", "ntxent_bwd_sym"),
            ("ntxent_bwd_general_rows_", "ntxent_bwd_general_rows"),
            ("ntxent_bwd_general_cols_", "ntxent_bwd_general_cols"),
            # the TF32 kernels of #9 (prep, walk, merge, reduce; the
            # rectangular mode's carry its name) and #10 (prep, walk, sum)
            ("infonce_dual_fwd_", "infonce_dual_fwd"),
            ("infonce_loss_reduce", "infonce_dual_fwd"),
            ("infonce_fwd_rect_", "infonce_dual_fwd_rect"),
            ("infonce_dual_bwd_", "infonce_dual_bwd"),
            # the TF32 kernels of #5 cross-modal and #4 (prep, walk, sum)
            ("infonce_bwd_rows_", "infonce_bwd_rows"),
            ("infonce_bwd_cols_", "infonce_bwd_cols"),
            # the TF32 kernels of #7 (prep, walk, merge) and #8 (prep,
            # walk, sum)
            ("ntxent_dual_stats_", "block_lse_dual"),
            ("ntxent_dual_grads_", "block_grads_dual"),
            # the TF32 kernels of #2 (prep, walk, merge, reduce) and #3
            # (prep, walk, sum)
            ("ntxent_fwd_tri_", "ntxent_fwd_tri"),
            ("ntxent_bwd_tri_", "ntxent_bwd_tri"))
MODEL, IMAGE_SIZE, SEED = "vit_b16", 224, 0
# The long-context slice: the JAX tower's defaults, the CLIP text
# vocabulary, batch 1 at the tower's max_len.
LONGCTX = dict(vocab_size=49408, hidden_dim=512, depth=8, num_heads=8,
               mlp_dim=2048, max_len=32768)
LONGCTX_BATCH = 1
RUNS, TRACE_RUNS = 10, 3
# (2N, T) of --mode ntxent: the SimCLR path, the reference's headline
# (bench.py), the north-star global batch
NTXENT_ROWS = ((512, 0.1), (4096, 0.07), (8192, 0.1))
# (R, C, D, InfoNCE mode) of the general kernels in --mode ntxent
NTXENT_STRIPS = ((128, 512, 128, False), (512, 512, 128, False),
                 (2048, 2048, 128, False), (2048, 8192, 128, False),
                 (256, 256, 512, True), (1024, 4096, 512, True))
TWOPASS_SCALE = 14.3  # about CLIP's initial exp(logit_scale)
# (R, C, D) of the data-parallel CLIP backward (#5 cross-modal, #4) in
# --mode ntxent: world 1 and one rank of 4 at batch 256, one rank of 4 at
# batch 4096
DP_CLIP_STRIPS = ((256, 256, 512), (64, 256, 512), (1024, 4096, 512))
# (N, D) of #9 square and #10 in --mode ntxent: CLIP at batch 256, N = 8192
INFONCE_SQUARE = ((256, 512), (8192, 512))
# (R, C, D) of #9's rectangular mode: one rank of 4 at batch 256 and 4096
INFONCE_RECT = ((64, 256, 512), (1024, 4096, 512))
# (R, C, D, world) of the shard-pair kernels #7 and #8 in --mode ntxent:
# the self tile of a world of 1 at batch 256 (the --dp-loss pair path) and
# the k = 1 tile of rank 0 of a world of 4 at global batch 256 and 4096
PAIR_TILES = ((512, 512, 128, 1), (128, 128, 128, 4), (2048, 2048, 128, 4))


def cuda_time_ms(fn, runs: int = RUNS, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` on the current CUDA stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def _host_ms(fn, runs: int = 50) -> float:
    """Mean host ms of one ``fn()`` enqueue (no synchronisation in the
    loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    ms = (time.perf_counter() - t0) / runs * 1e3
    torch.cuda.synchronize()
    return ms


def _group(name: str) -> str:
    lowered = name.lower()
    for marker, group in _KERNELS:
        if marker in lowered:
            return group
    if any(marker in lowered for marker in _GEMM_MARKERS):
        return "matmul"
    return "other"


def kernel_breakdown(fn, runs: int = TRACE_RUNS, top: int = 8) -> dict:
    """Device time of ``runs`` calls of ``fn`` by kernel, from a
    ``torch.profiler`` trace (CPU + CUDA activities)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_kernel[evt.name]
            entry[0] += evt.time_range.elapsed_us()
            entry[1] += 1
    device_us = sum(us for us, _ in by_kernel.values())
    groups: dict[str, float] = defaultdict(float)
    for name, (us, _) in by_kernel.items():
        groups[_group(name)] += us
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "runs": runs,
        "wall_ms_per_run": wall_us / runs / 1e3,
        "device_ms_per_run": device_us / runs / 1e3,
        "device_busy_share": device_us / wall_us if wall_us else None,
        "groups_ms_per_run": {g: us / runs / 1e3 for g, us in
                              sorted(groups.items())},
        "top_kernels": [{"name": name[:120], "ms_per_run": us / runs / 1e3,
                         "calls_per_run": calls / runs}
                        for name, (us, calls) in ranked],
    }


def launch_counters() -> dict:
    """The launch-counting wrapper of each hand-written kernel."""
    from ..ops import attention, infonce, ntxent

    return {"flash_attention_fwd": attention.flash_attention_fwd,
            "flash_attention_dq": attention.flash_attention_dq,
            "flash_attention_dkv": attention.flash_attention_dkv,
            "flash_fold": attention.flash_fold,
            "ntxent_fwd": ntxent.ntxent_fwd,
            "ntxent_bwd_sym": ntxent.ntxent_bwd_sym,
            "ntxent_fwd_general": ntxent.ntxent_fwd_general,
            "ntxent_bwd_general_rows": ntxent.ntxent_bwd_general_rows,
            "ntxent_bwd_general_cols": ntxent.ntxent_bwd_general_cols,
            "ntxent_fwd_tri": ntxent.ntxent_fwd_tri,
            "ntxent_bwd_tri": ntxent.ntxent_bwd_tri,
            "block_lse_dual": ntxent.block_lse_dual,
            "block_grads_dual": ntxent.block_grads_dual,
            "infonce_dual_fwd": infonce.infonce_dual_fwd,
            "infonce_dual_bwd": infonce.infonce_dual_bwd,
            "infonce_dual_fwd_rect": infonce.infonce_dual_fwd_rect,
            "infonce_bwd_rows": infonce.infonce_bwd_rows,
            "infonce_bwd_cols": infonce.infonce_bwd_cols}


def _traced_step(one_step) -> dict:
    """Trace breakdown of ``one_step`` and each kernel's launches per
    step (``kernel_breakdown`` makes one untraced warmup call first)."""
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    breakdown = kernel_breakdown(one_step, top=16)
    launches = {name: w.launches / (TRACE_RUNS + 1)
                for name, w in counters.items()}
    return {"launches_per_step": launches, **breakdown}


# --mode pipeline: steps of each run (records 2 .. PIPELINE_STEPS - 1 timed)
PIPELINE_STEPS = 10


def pipeline_profile(batch: int, device, flags: list[str],
                     store_rows: int) -> dict:
    """The numbers of ``--mode pipeline`` (see the module docstring)."""
    import tempfile

    import numpy as np

    from ..cli import build_train_parser, train

    argv = ["--model", MODEL, "--vit-attention", "flash", "--image-size",
            str(IMAGE_SIZE), "--batch", str(batch), "--steps",
            str(PIPELINE_STEPS), "--log-every", "1", "--device",
            device.type, *flags]
    with tempfile.TemporaryDirectory() as tmp:
        if store_rows:
            store = f"{tmp}/rows.npy"
            np.save(store, np.random.default_rng(SEED).integers(
                0, 256, (store_rows, IMAGE_SIZE, IMAGE_SIZE, 3),
                dtype=np.uint8))
            argv += ["--dataset", "npy", "--data-dir", store]
        _, history = train(build_train_parser().parse_args(argv))
        torch.cuda.synchronize()
    timed = history[1:-1]
    step_ms = [1e3 / h["steps_per_sec"] for h in timed]

    def mean_of(key):
        values = [h[key] for h in timed if key in h]
        return sum(values) / len(values) if values else None

    mean_ms = sum(step_ms) / len(step_ms)
    return {"flags": flags, "store_rows": store_rows, "step_ms": mean_ms,
            "step_ms_each": step_ms, "images_per_s": 2 * batch / mean_ms
            * 1e3, "data_wait_ms": mean_of("data_wait_ms"),
            "fetch_ms": mean_of("fetch_ms"),
            "transfer_ms": mean_of("transfer_ms")}


def train_profile(batch: int, device) -> dict:
    """The numbers of ``--mode train`` for one batch (see the module
    docstring)."""
    from ..cli import build_model, build_train_parser
    from ..training import (
        TrainerConfig,
        augment_batch_pair,
        create_train_state,
        make_train_step,
    )

    args = build_train_parser().parse_args(
        ["--model", MODEL, "--vit-attention", "flash", "--image-size",
         str(IMAGE_SIZE), "--batch", str(batch), "--seed", str(SEED)])
    cfg = TrainerConfig(batch_size=batch, temperature=args.temperature,
                        base_lr=args.base_lr, warmup_steps=1)
    state = create_train_state(build_model(args), cfg, device)
    step = make_train_step(cfg.temperature)
    gen = torch.Generator(device=device).manual_seed(SEED)
    images = torch.rand(batch, IMAGE_SIZE, IMAGE_SIZE, 3, generator=gen,
                        device=device)
    v1, v2 = augment_batch_pair(images, gen)
    augment_ms = cuda_time_ms(lambda: augment_batch_pair(images, gen),
                              runs=5, warmup=1)

    def one_step():
        step(state, v1, v2)

    torch.cuda.reset_peak_memory_stats(device)
    step_ms = cuda_time_ms(one_step, runs=5, warmup=2)
    peak = torch.cuda.max_memory_allocated(device)
    return {"batch": batch, "views_per_step": 2 * batch, "step_ms": step_ms,
            "images_per_s": 2 * batch / step_ms * 1e3,
            "augment_ms": augment_ms, "peak_memory_bytes": peak,
            **_traced_step(one_step)}


def _clip_setup(batch: int, device):
    """CLIP ViT-B/16 (flash attention) with its AdamW state and fixed
    synthetic pairs on ``device``: (state, images, tokens)."""
    from ..cli import build_clip_model, build_train_parser
    from ..training import TrainerConfig, create_clip_train_state

    args = build_train_parser().parse_args(
        ["--objective", "clip", "--model", MODEL, "--vit-attention", "flash",
         "--image-size", str(IMAGE_SIZE), "--batch", str(batch),
         "--token-len", "77", "--seed", str(SEED)])
    cfg = TrainerConfig(batch_size=batch, base_lr=5e-4, warmup_steps=1)
    state = create_clip_train_state(build_clip_model(args), cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    images = torch.rand(batch, IMAGE_SIZE, IMAGE_SIZE, 3, generator=gen,
                        device=device)
    tokens = torch.randint(1, args.vocab_size, (batch, args.token_len),
                           generator=gen, device=device)
    return state, images, tokens


def _clip_step_profile(state, images, tokens, step, loss_fn,
                       grad_reduce=None) -> dict:
    """The numbers of a CLIP step: step ms on CUDA events, peak memory,
    the parts timed apart (each tower's forward and backward, the loss's
    forward and backward ``loss_fn(zi, zt, scale)``, ``grad_reduce`` of
    the gradients if given, the AdamW update) and the traced breakdown."""
    model = state.model
    batch = images.shape[0]
    device = images.device

    def one_step():
        step(state, images, tokens)

    torch.cuda.reset_peak_memory_stats(device)
    step_ms = cuda_time_ms(one_step, runs=5, warmup=2)
    peak = torch.cuda.max_memory_allocated(device)

    def tower(encode, x):
        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            encode(x).sum().backward()
        return fwd_bwd

    zi = model.encode_image(images).detach().requires_grad_()
    zt = model.encode_text(tokens).detach().requires_grad_()
    scale = model.scale().detach().requires_grad_()

    def loss_fwd_bwd():
        loss_fn(zi, zt, scale).backward()

    parts = {
        "image_tower_fwd_bwd": cuda_time_ms(
            tower(model.encode_image, images), runs=3, warmup=1),
        "text_tower_fwd_bwd": cuda_time_ms(
            tower(model.encode_text, tokens), runs=3, warmup=1),
        "infonce_fwd_bwd": cuda_time_ms(loss_fwd_bwd, runs=5, warmup=1),
    }
    one_step()  # leaves this step's gradients for the timings below
    if grad_reduce is not None:
        grads = [p.grad for p in model.parameters()]
        parts["grad_pmean"] = cuda_time_ms(lambda: grad_reduce(grads),
                                           runs=5, warmup=1)
    # AdamW alone: the lr comes from the host count, nothing else changes
    parts["adamw_update"] = cuda_time_ms(state.optimizer.optimizer.step,
                                         runs=5, warmup=1)
    return {"batch": batch, "images_per_step": batch, "step_ms": step_ms,
            "images_per_s": batch / step_ms * 1e3, "peak_memory_bytes": peak,
            "parts_ms": parts, **_traced_step(one_step)}


def clip_profile(batch: int, device) -> dict:
    """The numbers of ``--mode clip`` for one batch (see the module
    docstring)."""
    from ..ops.infonce import info_nce_fused
    from ..training import make_clip_train_step

    state, images, tokens = _clip_setup(batch, device)
    return _clip_step_profile(
        state, images, tokens, make_clip_train_step(),
        lambda zi, zt, scale: info_nce_fused(zi, zt, scale=scale))


def clip_dp_profile(batch: int, device, infonce: str = "dual") -> dict:
    """The numbers of ``--mode clip_dp`` for one batch (see the module
    docstring), the InfoNCE body ``infonce`` ("dual" or "twopass")."""
    import tempfile

    from ..parallel import mesh
    from ..parallel.dist_loss import resolve_local_infonce
    from ..training import make_sharded_clip_train_step

    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_from_file(f"{tmp}/store", 0, 1, device)
        try:
            state, images, tokens = _clip_setup(batch, device)
            return {"infonce": infonce, **_clip_step_profile(
                state, images, tokens,
                make_sharded_clip_train_step(None, infonce),
                resolve_local_infonce(infonce), grad_reduce=mesh.pmean_)}
        finally:
            mesh.shutdown()


def _time_ms(fn, device, runs: int, warmup: int) -> float:
    """``cuda_time_ms`` on the card; the host clock's mean on the CPU."""
    if device.type == "cuda":
        return cuda_time_ms(fn, runs=runs, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) * 1e3 / runs


def dp_profile(batch: int, device, dp_loss: str = "strip",
               ring_chunks: int | None = None,
               collective_dtype: str = "float32", model: str = "resnet50",
               image_size: int = IMAGE_SIZE) -> dict:
    """The numbers of ``--mode dp`` for one batch (see the module
    docstring): ``dp_loss`` strip, pair or chunked (``ring_chunks`` a
    hop), the ``collective_dtype`` wire (int8 with an error-feedback
    residual). On a CPU ``device`` (the tests' tiny ``model``) the times
    are the host clock's and nothing is traced."""
    import tempfile

    from ..cli import build_model, build_train_parser
    from ..models import cross_replica_batch_norm
    from ..parallel import mesh
    from ..parallel.dist_loss import resolve_local_ntxent
    from ..parallel.precision import collective_precision
    from ..training import (
        TrainerConfig,
        augment_batch_pair,
        create_train_state,
        init_error_feedback,
        make_sharded_train_step,
    )
    from ..training.trainer import _reduce_grads

    args = build_train_parser().parse_args(
        ["--model", model, "--image-size", str(image_size), "--batch",
         str(batch), "--seed", str(SEED)])
    card = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_from_file(f"{tmp}/store", 0, 1, device)
        try:
            cfg = TrainerConfig(batch_size=batch,
                                temperature=args.temperature,
                                base_lr=args.base_lr, warmup_steps=1)
            net = cross_replica_batch_norm(build_model(args),
                                           torch.distributed.group.WORLD)
            state = create_train_state(net, cfg, device)
            wire = collective_precision(collective_dtype).dtype
            if wire == "int8":
                state = init_error_feedback(state)
            chunks = ring_chunks if dp_loss == "chunked" else None
            step = make_sharded_train_step(None, cfg.temperature,
                                           loss_impl=dp_loss,
                                           collective_dtype=wire,
                                           ring_chunks=chunks)
            loss_body = resolve_local_ntxent(dp_loss)
            if dp_loss == "chunked":
                loss_body = functools.partial(loss_body, chunks=chunks)
            gen = torch.Generator(device=device).manual_seed(SEED)
            images = torch.rand(batch, image_size, image_size, 3,
                                generator=gen, device=device)
            v1, v2 = augment_batch_pair(images, gen)
            both = torch.cat([v1, v2])

            def one_step():
                step(state, v1, v2)

            if card:
                torch.cuda.reset_peak_memory_stats(device)
            step_ms = _time_ms(one_step, device, runs=5, warmup=2)
            peak = torch.cuda.max_memory_allocated(device) if card else None

            def encoder_fwd_bwd():
                net.zero_grad(set_to_none=True)
                net(both).sum().backward()

            z = net(both).detach()
            z1 = z[:batch].clone().requires_grad_()
            z2 = z[batch:].clone().requires_grad_()

            def loss_fwd_bwd():
                with collective_precision(wire):
                    loss_body(z1, z2, cfg.temperature).backward()

            one_step()  # leaves this step's gradients for the update timing

            def reduce_and_update():
                _reduce_grads(state, None, wire)
                state.optimizer.step()

            parts = {
                "encoder_fwd_bwd": _time_ms(encoder_fwd_bwd, device, runs=3,
                                            warmup=1),
                f"{dp_loss}_loss_fwd_bwd": _time_ms(loss_fwd_bwd, device,
                                                    runs=5, warmup=1),
            }
            one_step()
            parts["grad_pmean_lars_update"] = _time_ms(
                reduce_and_update, device, runs=5, warmup=1)
            out = {"batch": batch, "views_per_step": 2 * batch,
                   "dp_loss": dp_loss, "ring_chunks": chunks,
                   "collective_dtype": wire, "step_ms": step_ms,
                   "images_per_s": 2 * batch / step_ms * 1e3,
                   "peak_memory_bytes": peak, "parts_ms": parts}
            if card:
                out.update(_traced_step(one_step))
            return out
        finally:
            mesh.shutdown()


def _shard(x: torch.Tensor, r: int, length: int) -> torch.Tensor:
    """Rank r's sequence shard of a flat (BH, L, ...) tensor."""
    return x[:, r * length:(r + 1) * length].contiguous()


class _EmulatedRing(torch.autograd.Function):
    """P ring ranks run one after another in one process: each rank's hop
    schedule (``ring_attention.hop_fold``, ``hop_grads``) over the
    sequence shards of the whole (flat) q, k, v, the blocks it would
    receive read in place. Forward: rank r folds the blocks of r, r - 1,
    ... at their global offsets. Backward: each rank's second pass, every
    block's (dK, dV) summed over the ranks it visits, as it arrives home
    in the real ring."""

    @staticmethod
    def forward(ctx, qf, kf, vf, rings):
        p, l_loc = len(rings), qf.shape[1] // len(rings)
        outs, lses = [], []
        for ring in rings:
            r = ring.rank
            stats = ring_attention._init_stats(qf.shape[0], l_loc,
                                               qf.shape[2], qf.device)
            for hop in range(p):
                src = ring.source(hop)
                stats = ring_attention.hop_fold(
                    ring, _shard(qf, r, l_loc), _shard(kf, src, l_loc),
                    _shard(vf, src, l_loc), r * l_loc, src * l_loc, stats)
            out, lse = ring_attention.ring_output(stats, qf.dtype)
            outs.append(out)
            lses.append(lse)
        out = torch.cat(outs, dim=1)
        ctx.save_for_backward(qf, kf, vf, out, torch.cat(lses, dim=1))
        ctx.rings = rings
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        rings = ctx.rings
        p, l_loc = len(rings), qf.shape[1] // len(rings)
        dof = g.contiguous().to(qf.dtype)
        delta = torch.sum(dof.float() * out.float(), dim=-1)
        dq, dk, dv = (torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device) for x in (qf, kf, vf))
        for ring in rings:
            r = ring.rank
            for hop in range(p):
                src = ring.source(hop)
                dq_c, dk_c, dv_c = ring_attention.hop_grads(
                    ring, _shard(qf, r, l_loc), _shard(kf, src, l_loc),
                    _shard(vf, src, l_loc),
                    *(_shard(x, r, l_loc) for x in (dof, lse, delta)),
                    r * l_loc, src * l_loc)
                dq[:, r * l_loc:(r + 1) * l_loc] += dq_c
                dk[:, src * l_loc:(src + 1) * l_loc] += dk_c
                dv[:, src * l_loc:(src + 1) * l_loc] += dv_c
        return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None


def emulated_ring_attention(ranks: int, *, causal: bool = False,
                            scale=None, impl: str = "flash"):
    """``fn(q, k, v)`` on the whole (B, L, H, D) sequence that computes
    what ``make_ring_attention`` computes over ``ranks`` ranks, each rank
    one after another in this process (one card cannot hold two NCCL
    ranks): the same per-hop kernels at the same global offsets, ``ranks``
    folds per rank forward and ``ranks`` dQ and dK/dV hops per rank
    backward. L % ranks == 0."""

    def fn(q, k, v):
        b, length, h, d = q.shape
        if length % ranks:
            raise ValueError(f"L = {length} does not split over {ranks} "
                             "ranks")
        sc = attention.resolve_attention_scale(scale, d)
        rings = tuple(ring_attention._Ring(None, ranks, r, bool(causal), sc,
                                           impl, 1) for r in range(ranks))
        out = _EmulatedRing.apply(attention._flat(q), attention._flat(k),
                                  attention._flat(v), rings)
        return attention._unflat(out, b, h)

    return fn


class _EmulatedRingLseSum(torch.autograd.Function):
    """The lse part of the fused ring NT-Xent (``ring._RingLseSum``) of P
    ranks run one after another in one process. zs: (P, 2n, D) each
    rank's stacked views, gids: (P, 2n) their global row ids. Forward:
    rank r folds the blocks of r, r - 1, ... with ``ring.lse_hop`` (#1);
    returns (P,), each rank's sum of its rows' lse. Backward: each rank's
    ``block_grads`` (#6) of the same hops, every block's column gradient
    summed over the ranks it visits, as it arrives home in the real
    ring."""

    @staticmethod
    def forward(ctx, zs, gids, temperature, chunks):
        p, rows = zs.shape[:2]
        bounds = chunk_bounds(rows, chunks)
        lses = []
        for r in range(p):
            stats = ring_losses._stats(rows, zs.device)
            for hop in range(p):
                src = (r - hop) % p
                for lo, hi in bounds:
                    stats = ring_losses.lse_hop(
                        zs[r], zs[src, lo:hi], gids[r], gids[src, lo:hi],
                        temperature, p * rows, stats)
            lses.append(stats[0] + _log_l(stats[1]))
        lse = torch.stack(lses)
        ctx.save_for_backward(zs, gids, lse)
        ctx.temperature, ctx.bounds = temperature, bounds
        return lse.sum(dim=1)

    @staticmethod
    def backward(ctx, ct):
        zs, gids, lse = ctx.saved_tensors
        t = ctx.temperature
        p, rows = zs.shape[:2]
        grows = torch.zeros(zs.shape, dtype=torch.float32, device=zs.device)
        gblk = torch.zeros_like(grows)
        for r in range(p):
            for hop in range(p):
                src = (r - hop) % p
                for lo, hi in ctx.bounds:
                    g_rows, g_cols = block_grads(
                        zs[r], zs[src, lo:hi], gids[r], gids[src, lo:hi],
                        lse[r], t, p * rows)
                    grows[r] += g_rows
                    gblk[src, lo:hi] += g_cols
        return torch.stack([
            ring_losses.lse_sum_grad(grows[r], gblk[r], ct[r], t, zs.dtype)
            for r in range(p)]), None, None, None


def emulated_ring_ntxent(ranks: int, temperature: float = 0.07,
                         chunks: int = 1):
    """``fn(z1, z2)`` on the global views (N, D) that computes what
    ``make_ring_ntxent(impl="fused", chunks=chunks)`` (and, with
    ``chunks``, ``--dp-loss chunked``'s ``local_ntxent_chunked``)
    computes over ``ranks`` ranks, each rank one after another in this
    process: the same per-hop kernels, ``ranks * chunks`` of #1 and of #6
    rows and columns per rank, each hop's block folded as ``chunks``
    slices of rows. Returns the global mean loss; its gradient is the
    global one (the real ring's rank holds P times its share). N % ranks
    == 0."""
    t = float(temperature)

    def fn(z1, z2):
        if z1.shape[0] % ranks:
            raise ValueError(f"N = {z1.shape[0]} does not split over "
                             f"{ranks} ranks")
        n = z1.shape[0] // ranks
        views = [(z1[r * n:(r + 1) * n], z2[r * n:(r + 1) * n])
                 for r in range(ranks)]
        zs = torch.stack([torch.cat(v) for v in views])
        gids = torch.stack([local_row_gids(r, n, ranks, z1.device)
                            for r in range(ranks)])
        lse_sums = _EmulatedRingLseSum.apply(zs, gids, t, int(chunks))
        return sum(ring_losses.rank_loss_sum(a, b, t, lse_sums[r])
                   for r, (a, b) in enumerate(views)) / (2 * z1.shape[0])

    return fn


def build_long_context(device, attention_fn, depth: int | None = None,
                       dtype=torch.bfloat16):
    """The long-context slice's model (``LONGCTX``, ``depth`` blocks if
    given) on ``device``, weights drawn from ``SEED``."""
    from ..models import LongContextTransformer, init_weights

    sizes = dict(LONGCTX, **({} if depth is None else {"depth": depth}))
    model = LongContextTransformer(**sizes, dtype=dtype,
                                   attention_fn=attention_fn)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model.to(device)


def long_context_tokens(device, length: int = LONGCTX["max_len"],
                        batch: int = LONGCTX_BATCH) -> torch.Tensor:
    gen = torch.Generator().manual_seed(SEED)
    return torch.randint(0, LONGCTX["vocab_size"], (batch, length),
                         generator=gen).to(device)


def longctx_profile(device, ring_emulate: int = 0) -> dict:
    """The numbers of ``--mode longctx`` (see the module docstring)."""
    import tempfile

    from ..parallel import make_ring_attention, mesh

    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_from_file(f"{tmp}/store", 0, 1, device)
        try:
            plan = (emulated_ring_attention(ring_emulate, causal=True)
                    if ring_emulate else
                    make_ring_attention(None, causal=True, impl="flash"))
            model = build_long_context(device, plan)
            tokens = long_context_tokens(device)

            def one_pass():
                model.zero_grad(set_to_none=True)
                model(tokens).float().pow(2).sum().backward()

            torch.cuda.reset_peak_memory_stats(device)
            pass_ms = cuda_time_ms(one_pass, runs=3, warmup=1)
            peak = torch.cuda.max_memory_allocated(device)
            traced = _traced_step(one_pass)
            n_tokens = tokens.numel()
            return {"tokens_per_pass": n_tokens,
                    "ring_ranks": ring_emulate or 1,
                    "emulated": bool(ring_emulate), "pass_ms": pass_ms,
                    "tokens_per_s": n_tokens / pass_ms * 1e3,
                    "peak_memory_bytes": peak,
                    "launches_per_pass": traced.pop("launches_per_step"),
                    **traced}
        finally:
            mesh.shutdown()


def _tri_plan_stats(tri_runs, rows: int, device) -> dict:
    """#2's plan at 2N = rows on this card, printed and returned: the
    busiest CTA's tiles, the longest run and the mean tiles an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    runs = tri_runs(rows, sms)
    tiles = runs.cta_tiles()
    plan = {f"tri_busiest_cta_tiles_{rows}": max(tiles),
            f"tri_longest_run_{rows}": max(p[2] for p in runs.pieces),
            f"tri_mean_tiles_per_sm_{rows}": sum(tiles) / sms}
    print(f"[ntxent] 2N={rows}: #2's plan {plan}", flush=True)
    return plan


def ntxent_profile(device) -> dict:
    """CUDA-event ms of #1 and #5 (fp32, D = 128), of the triangular #2 and
    #3, and of ``ntxent_loss_fused``'s forward and backward, rectangular
    and triangular, at each (2N, T) of ``NTXENT_ROWS`` (with #2's plan:
    the busiest CTA's tiles and the longest run against the mean tiles an
    SM), the host ms of one call at the first, and #1's general
    mode and #6's two kernels at each (R, C, D) of ``NTXENT_STRIPS`` (rank
    3's rows of a world of C / R ranks in the NT-Xent mode, rank C / R -
    1's in the InfoNCE mode), and #5 cross-modal and #4 at each (R, C, D)
    of ``DP_CLIP_STRIPS`` (rank C / R - 1's rows), #9 and #10 at each
    (N, D) of ``INFONCE_SQUARE`` (with the host ms of one call at the
    first), #9's rectangular mode at each (R, C, D) of ``INFONCE_RECT``
    and the shard-pair #7 and #8 at each tile of ``PAIR_TILES`` (with the
    host ms of one call at the first)."""
    from ..ops import ntxent
    from ..ops.infonce import (infonce_bwd_cols, infonce_bwd_rows,
                               infonce_dual_bwd, infonce_dual_fwd,
                               infonce_dual_fwd_rect)

    gen = torch.Generator(device=device).manual_seed(SEED)

    def unit_rows(rows, d=128):
        z = torch.randn(rows, d, generator=gen, device=device)
        return torch.nn.functional.normalize(z, dim=1)

    out = {}
    for rows, t in NTXENT_ROWS:
        z = unit_rows(rows)
        _, lse = ntxent.ntxent_fwd(z, t)
        out[f"fwd_{rows}_ms"] = cuda_time_ms(
            lambda: ntxent.ntxent_fwd(z, t), 20)
        out[f"bwd_{rows}_ms"] = cuda_time_ms(
            lambda: ntxent.ntxent_bwd_sym(z, lse, t), 20)
        zg = z.clone().requires_grad_()
        out[f"loss_fwd_bwd_{rows}_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(ntxent.ntxent_loss_fused(zg, t), zg),
            20)
        tri_fwd = functools.partial(ntxent.ntxent_fwd_tri, z, t)
        tri_bwd = functools.partial(ntxent.ntxent_bwd_tri, z, lse, t)
        out[f"tri_fwd_{rows}_ms"] = cuda_time_ms(tri_fwd, 20)
        out[f"tri_bwd_{rows}_ms"] = cuda_time_ms(tri_bwd, 20)
        out[f"tri_loss_fwd_bwd_{rows}_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(
                ntxent.ntxent_loss_fused(zg, t, triangular=True), zg), 20)
        if hasattr(ntxent, "tri_runs"):  # an older tree has no planner
            out |= _tri_plan_stats(ntxent.tri_runs, rows, device)
        if rows == NTXENT_ROWS[0][0]:
            out[f"fwd_{rows}_host_ms"] = _host_ms(
                lambda: ntxent.ntxent_fwd(z, t))
            out[f"bwd_{rows}_host_ms"] = _host_ms(
                lambda: ntxent.ntxent_bwd_sym(z, lse, t))
            out[f"tri_fwd_{rows}_host_ms"] = _host_ms(tri_fwd)
            out[f"tri_bwd_{rows}_host_ms"] = _host_ms(tri_bwd)
    for rows, cols, d, infonce in NTXENT_STRIPS:
        if d > getattr(ntxent, "MAX_DIM", d):
            continue  # an older tree's kernels do not take this width
        z_rows, z_cols = unit_rows(rows, d), unit_rows(cols, d)
        if infonce:
            gid = cols - rows + torch.arange(rows, device=device)
            t, kw = 1.0, dict(diag_pos=True, scale=torch.tensor(
                TWOPASS_SCALE, device=device))
            tag = f"infonce_{rows}x{cols}x{d}"
        else:
            gid = local_row_gids(min(3, cols // rows - 1), rows // 2,
                                 cols // rows, device)
            t, kw, tag = 0.1, {}, f"{rows}x{cols}"
        args = (z_rows, z_cols, gid)
        _, lse = ntxent.ntxent_fwd_general(*args, t, **kw)
        out[f"general_{tag}_ms"] = cuda_time_ms(
            lambda: ntxent.ntxent_fwd_general(*args, t, **kw), 20)
        for side in ("rows", "cols"):
            fn = getattr(ntxent, f"ntxent_bwd_general_{side}")
            out[f"{side}_{tag}_ms"] = cuda_time_ms(
                lambda: fn(*args, lse, t, **kw), 20)
    scale = torch.tensor(TWOPASS_SCALE, device=device)
    for rows, cols, d in DP_CLIP_STRIPS:
        za, zb = unit_rows(rows, d), unit_rows(cols, d)
        gid = cols - rows + torch.arange(rows, device=device)
        args = (za, zb, gid, scale, *infonce_dual_fwd_rect(za, zb, scale))
        for side, fn in (("rows", infonce_bwd_rows),
                         ("cols", infonce_bwd_cols)):
            out[f"dp_clip_{side}_{rows}x{cols}x{d}_ms"] = cuda_time_ms(
                lambda: fn(*args), 20)
    for n, d in INFONCE_SQUARE:
        za, zb = unit_rows(n, d), unit_rows(n, d)
        _, lse_a, lse_b = infonce_dual_fwd(za, zb, scale)
        fwd = functools.partial(infonce_dual_fwd, za, zb, scale)
        bwd = functools.partial(infonce_dual_bwd, za, zb, scale, lse_a,
                                lse_b)
        out[f"infonce_fwd_{n}x{d}_ms"] = cuda_time_ms(fwd, 20)
        out[f"infonce_bwd_{n}x{d}_ms"] = cuda_time_ms(bwd, 20)
        if n == INFONCE_SQUARE[0][0]:
            out[f"infonce_fwd_{n}x{d}_host_ms"] = _host_ms(fwd)
            out[f"infonce_bwd_{n}x{d}_host_ms"] = _host_ms(bwd)
    for rows, cols, d in INFONCE_RECT:
        za, zb = unit_rows(rows, d), unit_rows(cols, d)
        out[f"infonce_rect_{rows}x{cols}x{d}_ms"] = cuda_time_ms(
            functools.partial(infonce_dual_fwd_rect, za, zb, scale), 20)
    for rows, cols, d, world in PAIR_TILES:
        z_rows, z_cols = unit_rows(rows, d), unit_rows(cols, d)
        rid = local_row_gids(0, rows // 2, world, device)
        cid = local_row_gids(1 % world, cols // 2, world, device)
        args = (z_rows, z_cols, rid, cid, 0.1, rows * world)
        lse_r, lse_c = ntxent.block_lse_dual(*args)
        stats = functools.partial(ntxent.block_lse_dual, *args)
        grads = functools.partial(ntxent.block_grads_dual, *args[:4], lse_r,
                                  lse_c, *args[4:])
        tag = f"{rows}x{cols}x{d}"
        out[f"pair_stats_{tag}_ms"] = cuda_time_ms(stats, 20)
        out[f"pair_grads_{tag}_ms"] = cuda_time_ms(grads, 20)
        if rows == PAIR_TILES[0][0]:
            out[f"pair_stats_{tag}_host_ms"] = _host_ms(stats)
            out[f"pair_grads_{tag}_host_ms"] = _host_ms(grads)
    return out


def moe_profile(batch: int, device) -> dict:
    """The numbers of ``--mode moe`` (see the module docstring)."""
    from ..models.layers import init_weights
    from ..models.vit import MlpBlock
    from ..parallel.moe import MoEMlp

    gen = torch.Generator().manual_seed(SEED)
    moe = init_weights(MoEMlp(768, 8, 3072), gen).to(device)
    dense = init_weights(MlpBlock(768, 3072, torch.bfloat16), gen).to(device)
    tokens = torch.randn(2 * batch * 197, 768, generator=gen)
    x = torch.nn.functional.layer_norm(0.3 * tokens + tokens[:1], (768,))
    x = x.to(device=device, dtype=torch.bfloat16).requires_grad_()

    def run(layer):
        def once():
            layer(x).float().square().mean().backward()
        return once

    times = {"dense": [], "moe": []}
    for name in ("dense", "moe", "moe", "dense"):
        times[name].append(cuda_time_ms(run(dense if name == "dense"
                                            else moe)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    run(moe)()
    torch.cuda.synchronize()
    return {"tokens": x.shape[0], "experts": 8,
            "dense_ms": times["dense"], "moe_ms": times["moe"],
            "moe_peak_gib": (torch.cuda.max_memory_allocated() - before)
            / 2**30, "dropped_share": float(moe.dropped),
            **kernel_breakdown(run(moe), top=10)}


def main(argv=None) -> int:
    from ..cli import build_model, build_serve_parser
    from .capability import card_power_line, device_name, resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="forward",
                   choices=["forward", "train", "clip", "dp", "clip_dp",
                            "longctx", "ntxent", "pipeline", "moe"])
    p.add_argument("--bucket", type=int, default=64,
                   help="forward mode: batch size of the profiled forward")
    p.add_argument("--impls", default="flash,xla",
                   help="forward mode: comma list of --vit-attention values")
    p.add_argument("--batch", type=int, default=256,
                   help="train, clip, dp and clip_dp modes: --batch of the "
                        "profiled step")
    p.add_argument("--dp-loss", default="strip",
                   choices=["strip", "pair", "chunked"],
                   help="dp mode: the data-parallel NT-Xent schedule")
    p.add_argument("--ring-chunks", type=int, default=None, metavar="C",
                   help="dp mode with --dp-loss chunked: chunks a hop")
    p.add_argument("--collective-dtype", default="float32",
                   choices=["float32", "bf16", "bfloat16", "int8"],
                   help="dp mode: the wire dtype of the collectives")
    p.add_argument("--infonce", default="dual", choices=["dual", "twopass"],
                   help="clip_dp mode: the data-parallel InfoNCE body")
    p.add_argument("--ring-emulate", type=int, default=0, metavar="P",
                   help="longctx mode: P ring ranks emulated in one "
                        "process (0: the ring of the world-1 group)")
    p.add_argument("--store", type=int, default=0, metavar="ROWS",
                   help="pipeline mode: train from a uint8 npy row store "
                        "of ROWS rows written from seed 0")
    p.add_argument("train_flags", nargs=argparse.REMAINDER,
                   help="pipeline mode: ntxent-train flags, after --")
    args = p.parse_args(argv)

    device = resolve_device("cuda")
    if args.mode == "pipeline":
        flags = [f for f in args.train_flags if f != "--"]
        card = card_power_line()
        print(f"card: {card}", flush=True)
        result = {"device": device_name(device), "card": card,
                  "mode": "pipeline", **pipeline_profile(
                      args.batch, device, flags, args.store)}
        store = f", an npy store of {args.store} rows" if args.store else ""
        print(f"[pipeline] batch {args.batch}, flags "
              f"{' '.join(flags) or 'none'}{store}: "
              f"{result['step_ms']:.3f} ms a step (steps 2-"
              f"{PIPELINE_STEPS - 1}), {result['images_per_s']:.1f} "
              f"images/s, data wait {result['data_wait_ms']} ms, fetch "
              f"{result['fetch_ms']} ms, transfer {result['transfer_ms']} ms",
              flush=True)
        print(json.dumps(result))
        return 0
    if args.mode == "moe":
        card = card_power_line()
        print(f"card: {card}", flush=True)
        result = {"device": device_name(device), "card": card,
                  "mode": "moe", **moe_profile(args.batch, device)}
        print(f"[moe] {result['tokens']} tokens x 768, 8 experts of 3072, "
              f"bf16, forward + backward in turns: dense "
              f"{result['dense_ms']} ms, MoE {result['moe_ms']} ms; peak "
              f"{result['moe_peak_gib']:.2f} GiB above the inputs; dropped "
              f"share {result['dropped_share']:.4f}; device ms by group "
              f"{json.dumps(result['groups_ms_per_run'])}", flush=True)
        for k in result["top_kernels"]:
            print(f"[moe]   {k['ms_per_run']:8.3f} ms "
                  f"{k['calls_per_run']:.0f}x {k['name']}", flush=True)
        print(json.dumps(result))
        return 0
    if args.mode == "ntxent":
        card = card_power_line()
        print(f"card: {card}", flush=True)
        result = {"device": device_name(device), "card": card,
                  "mode": "ntxent", **ntxent_profile(device)}
        times = {k: round(v, 4) for k, v in result.items()
                 if k.endswith("_ms")}
        print(f"[ntxent] ms a call: {json.dumps(times)}", flush=True)
        print(json.dumps(result))
        return 0
    if args.mode == "longctx":
        card = card_power_line()
        print(f"card: {card}", flush=True)
        result = {"device": device_name(device), "card": card,
                  "mode": "longctx", "model": LONGCTX,
                  **longctx_profile(device, args.ring_emulate)}
        print(f"[longctx] {result['ring_ranks']} ring rank(s)"
              f"{' emulated' if result['emulated'] else ''}: "
              f"{result['pass_ms']:.3f} ms per forward and backward, "
              f"{result['tokens_per_s']:.1f} tokens/s; device busy "
              f"{result['device_busy_share']:.3f}; device ms by group "
              f"{json.dumps(result['groups_ms_per_run'])}; launches per "
              f"pass {json.dumps(result['launches_per_pass'])}; peak "
              f"memory {result['peak_memory_bytes'] / 2**30:.2f} GiB",
              flush=True)
        for k in result["top_kernels"]:
            print(f"[longctx]   {k['ms_per_run']:8.3f} ms "
                  f"x{k['calls_per_run']:.0f}  {k['name']}")
        print(json.dumps(result))
        return 0
    if args.mode in ("train", "clip", "dp", "clip_dp"):
        card = card_power_line()
        print(f"card: {card}", flush=True)
        profile = {"train": train_profile, "clip": clip_profile,
                   "dp": functools.partial(
                       dp_profile, dp_loss=args.dp_loss,
                       ring_chunks=args.ring_chunks,
                       collective_dtype=args.collective_dtype),
                   "clip_dp": functools.partial(clip_dp_profile,
                                                infonce=args.infonce)}[
            args.mode]
        result = {"device": device_name(device), "card": card,
                  "model": "resnet50" if args.mode == "dp" else MODEL,
                  "image_size": IMAGE_SIZE, "mode": args.mode,
                  **profile(args.batch, device)}
        tag = f"[{args.mode}]"
        extra = (f"augment {result['augment_ms']:.3f} ms"
                 if args.mode == "train" else
                 f"parts ms {json.dumps(result['parts_ms'])}")
        print(f"{tag} batch {args.batch}: {result['step_ms']:.3f} ms per "
              f"step, {result['images_per_s']:.1f} images/s; {extra}; "
              f"device busy "
              f"{result['device_busy_share']:.3f}; device ms by group "
              f"{json.dumps(result['groups_ms_per_run'])}; launches per "
              f"step {json.dumps(result['launches_per_step'])}; peak "
              f"memory {result['peak_memory_bytes'] / 2**30:.2f} GiB",
              flush=True)
        for k in result["top_kernels"]:
            print(f"{tag}   {k['ms_per_run']:8.3f} ms "
                  f"x{k['calls_per_run']:.0f}  {k['name']}")
        print(json.dumps(result))
        return 0
    x = torch.randn(args.bucket, IMAGE_SIZE, IMAGE_SIZE, 3,
                    generator=torch.Generator().manual_seed(SEED))
    x = x.to(device)
    card = card_power_line()
    print(f"card: {card}", flush=True)
    result = {"device": device_name(device), "card": card, "model": MODEL,
              "image_size": IMAGE_SIZE, "bucket": args.bucket, "impls": {}}
    for impl in args.impls.split(","):
        serve_args = build_serve_parser().parse_args(
            ["--model", MODEL, "--image-size", str(IMAGE_SIZE),
             "--vit-attention", impl, "--head", "embedding",
             "--seed", str(SEED)])
        model = build_model(serve_args).to(device).eval()

        def forward():
            with torch.inference_mode():
                return model(x)

        ms = cuda_time_ms(forward)
        attention.flash_attention_fwd.launches = 0
        breakdown = kernel_breakdown(forward)
        # kernel_breakdown makes one untraced warmup call before the trace
        launches = attention.flash_attention_fwd.launches / (TRACE_RUNS + 1)
        result["impls"][impl] = {
            "forward_ms": ms, "images_per_s": args.bucket / ms * 1e3,
            "flash_launches_per_forward": launches, **breakdown}
        print(f"[{impl}] bucket {args.bucket}: {ms:.3f} ms per forward, "
              f"{args.bucket / ms * 1e3:.1f} images/s; device busy "
              f"{breakdown['device_busy_share']:.3f} of the traced wall "
              f"time; device ms by group "
              f"{json.dumps(breakdown['groups_ms_per_run'])}", flush=True)
        for k in breakdown["top_kernels"]:
            print(f"[{impl}]   {k['ms_per_run']:8.3f} ms "
                  f"x{k['calls_per_run']:.0f}  {k['name']}")
        del model
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
