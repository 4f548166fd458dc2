#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``ntxent_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result:

1. card: its name and power limit;
2. build: every CUDA kernel source in ``ntxent_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together, timed; the registers and
   spill bytes ptxas reports for every kernel it compiled (among them
   the TMA/wgmma #11, #12, #13 and #14 in bf16, at head_dim 64 and
   128, and the TF32 wgmma #1 and #5);
2a. data-parallel InfoNCE kernels: ``infonce_dual_fwd_rect`` (#9's
   rectangular stats-only mode), ``infonce_bwd_rows`` (#5's cross-modal
   mode) and ``infonce_bwd_cols`` (#4) against their plain versions at
   (rows, cols, D) = (256, 256, 512) (the path of this run), (64, 256,
   512) (one rank of 4 at batch 256), (1024, 4096, 512) (one rank of 4 at
   batch 4096) and a ragged (101, 1000, 96) with scattered ids and a
   padding row, fp32 and bf16, bitwise repeatable; CUDA-event times
   beside the bound; and the symmetric ``ntxent_fwd`` re-timed over 200
   launches;
3. kernels: each hand-written kernel against its plain version on the
   card -- ``flash_attention_fwd`` (the ViT-B/16 serving and training
   shapes in bf16 and fp32, causal cases with q_offset != k_offset and
   ragged lengths, head_dim 128; in bf16 at the training shape, over
   four seeds, its rms error against an fp32 truth over the plain
   version's, and that of a control that rounds once more, which must
   miss);
   ``ntxent_fwd`` and ``ntxent_bwd_sym``
   (2N = 512 and 8192 at D = 128, and a ragged 2N = 1000 at D = 96, in
   fp32 and bf16; TF32 tensor-core kernels, held in fp32 at 2N = 512 and
   8192 at least 10x below a TF32 control's lse and gradient errors, their
   walks' ptxas registers and spills printed, timed at 2N = 512 and
   8192); ``flash_attention_dq`` and ``flash_attention_dkv``
   (the training shape in bf16 and fp32 and the causal offset cases, and
   a wholly masked ring hop whose dk and dv must be zero bit for bit; in
   bf16 the TMA/wgmma dQ, over four seeds at the training shape, against
   an fp32 truth as the forward is, its control accumulating dq in bf16)
   --
   ``infonce_dual_fwd`` and ``infonce_dual_bwd`` (N = 256, 1000, 8192 at
   D = 512 and 128, fp32 and bf16, a logit scale of 17.5 passed as a
   device tensor; the loss bitwise repeatable) -- then CUDA-event times
   of each kernel, its plain version and, where one PyTorch call computes
   the same function, that call (a yardstick the port never calls),
   beside the bound;
4. serve: a ViT-B/16 SimCLR embedding server built through
   ``ntxent_tpu_torch.cli``, concurrent ``/embed`` requests over HTTP,
   every answer held against the model's direct forward, the forward
   kernel's launch count per forward chunk, ``/healthz`` and
   ``/metrics``, and a 70-row engine call that chunks through the
   largest bucket;
5. train: ``ntxent-train --model vit_b16 --vit-attention flash
   --image-size 224 --batch 256 --steps 5`` through
   ``ntxent_tpu_torch.cli``: a finite loss every step, parameters that
   moved, exactly 1/1/12/12/12 launches per step of ntxent_fwd,
   ntxent_bwd_sym and the three flash kernels, a nonzero gradient on
   every q/k/v projection; step ms, images/s and peak memory;
6. step parity: one train step of ViT-B/16 (batch 4) on the card against
   the same step on the CPU (the kernels' plain versions) from identical
   weights and views: loss and relative gradient-norm error, in fp32
   within fixed tolerances; the path's bf16 step is printed as a reading
   beside the gap bf16 rounding opens on the CPU itself (the bf16
   kernels' accuracy is gated against an fp32 truth in phases 3 and
   12g);
7. CLIP train: ``ntxent-train --objective clip --model vit_b16
   --vit-attention flash --image-size 224 --batch 256 --steps 5
   --base-lr 5e-4 --warmup-steps 1`` through ``ntxent_tpu_torch.cli``: a
   finite loss every step, parameters that moved, exactly 1/1/12/12/12
   launches per step of infonce_dual_fwd, infonce_dual_bwd and the three
   flash kernels (image tower only: the causal text tower runs plain
   attention) and none of the NT-Xent kernels, a nonzero gradient on the
   logit scale and on every q/k/v projection of both towers; step ms,
   images/s and peak memory;
8. CLIP step parity: one fp32 CLIP ViT-B/16 train step (batch 4) on the
   card against the same step on the CPU, within fixed tolerances;
9. general NT-Xent kernels: ``ntxent_fwd_general`` (#1 in its general
   mode), ``ntxent_bwd_general_rows`` and ``ntxent_bwd_general_cols``
   (#6) against their plain versions at (R, C, D) = (512, 512, 128) (the
   data-parallel path of a world of one at --batch 256), (128, 512, 128)
   (one rank of a world of four, rank 3's row ids), (2048, 8192, 128)
   (one rank of four at global batch 4096) and a ragged (100, 1000, 96)
   with a padding row, in fp32 and bf16, with and without scattered
   column ids; the loss bitwise repeatable; CUDA-event times beside the
   bound;
10. four ranks emulated on one card: the per-rank strip losses and row and
   column gradients of P = 4 at global batch 256, summed and scattered as
   the all-gather's backward does, against the single-card symmetric loss
   and gradient; then four CLIP ranks at global batch 256 (D = 512):
   each rank's rectangular forward, the column lse merged by hand, each
   rank's rows and columns gradients, against the single-card
   ``info_nce_fused`` loss and gradients;
11. data-parallel train: ResNet-50 SimCLR through
   ``cli.train(..., data_parallel=True)`` over a real NCCL process group
   of world size 1 (a ``FileStore``), ``--image-size 224 --batch 256
   --steps 5``: finite losses, exactly 1/1/1 launches per step of the
   general forward and the two general backward kernels and none of any
   other loss or attention kernel, a nonzero gradient on every
   convolution and BatchNorm weight; step ms, images/s, peak memory;
12. device-count parity: one fp32 ResNet-50 step (batch 8) of the
   data-parallel step at world 1 against the single-card step from the
   same weights and views, cuDNN's TF32 off;
12a. data-parallel CLIP train: ``ntxent-train --objective clip --model
   vit_b16 --vit-attention flash --image-size 224 --batch 256 --steps 5``
   through ``cli.train(..., data_parallel=True)`` in the same NCCL group
   of world 1: finite losses, exactly 1/1/1 launches per step of the
   rectangular forward and the rows and columns kernels and 12/12/12 of
   the flash kernels, no other loss kernel, a nonzero gradient on the
   logit scale and every q/k/v weight of both towers; step ms, images/s,
   peak memory;
12b. its parity: one fp32 CLIP ViT-B/16 step (batch 4) of the
   data-parallel step at world 1 against the single-card CLIP step, TF32
   off;
12c. shard-pair kernels: ``block_lse_dual`` (#7) and ``block_grads_dual``
   (#8) against their plain versions at (R, C, D) = (512, 512, 128) (the
   self tile of the pair path of this run), (128, 128, 128) and (2048,
   2048, 128) (the k = 1 tile of one rank of 4 at global batch 256 and
   4096) and a ragged (100, 260, 96) with scattered, shared and sentinel
   ids, fp32 and bf16, bitwise repeatable; CUDA-event times beside the
   bound;
12d. triangular kernels: ``ntxent_fwd_tri`` (#2) and ``ntxent_bwd_tri``
   (#3) against their plain versions and against #1 + #5 at 2N = 512, 8192
   and 300 (D = 128), fp32 and bf16; one ``ntxent_loss_fused(...,
   triangular=True)`` forward and backward launching #2 and #3 once each
   and nothing else; times beside #1 + #5;
12e. pair ranks emulated on one card: P = 2, 3, 4 and 8 at global batch
   256 (255 for P = 3) through ``parallel.pair``'s per-rank functions,
   the lse shares merged and the gradient buffers summed by hand, against
   the single-card ``ntxent_fwd`` / ``ntxent_bwd_sym``;
12f. data-parallel train with ``--dp-loss pair``: the ResNet-50 command
   of phase 11 plus ``--dp-loss pair`` in the same NCCL group: exactly
   1/1 launches per step of #7 and #8 and none of any other kernel; and
   in phase 12 the world-1 fp32 pair step against the world-1 strip step;
12g. the carried-statistics fold kernel ``flash_fold`` (#12; in bf16 the
   TMA/wgmma walk of #11 with the carry in its register accumulator)
   against its plain version: consecutive folds with a carried state at
   (BH, L, D) = (8, 8192, 64) bf16 non-causal and causal with q_offset
   == k_offset, (8, 4096, 128) fp32 causal with q_offset > k_offset
   (partly masked), and a ragged (4, 1000, 64); after each, a block
   wholly after the rows (q_offset < k_offset) whose carry must come out
   bit for bit, and a control (the last block folded into a fresh carry
   must miss); over four seeds, two bf16 folds at the P = 4 hop (a past
   block, then the causal diagonal) against an fp32 truth, its control
   rounding acc to bf16 between them; at the long-context path's hop (8,
   32768, 64) and the P = 4 hop (8, 8192, 64) against the plain version
   run in row chunks, and times beside the bound, with the dQ and dK/dV
   kernels (#13, #14) there, held against their plain versions run in
   q-row chunks with the true lse and delta (a control without the first
   chunk must miss), and over every 64-row tile of dq and of dk/dv, each
   tile's error held to its own size (controls that leave one tile pair
   out of the heaviest walk must miss), and SDPA's causal forward and
   backward of the same block (the backward is #13's and #14's library
   time at the hop);
12h. ring attention of P = 2, 4, 8 ranks emulated on one card at (B 1, L
   8192, H 8, D 64), bf16 and fp32, causal and not: the flash ring against
   the jnp ring and flash_attention of the whole sequence (out, dq, dk,
   dv), exactly P folds (#12) per rank forward and P dQ and dK/dV hops
   per rank backward, no forward kernel (#11);
12i. the ring NT-Xent of P = 2, 4, 8 ranks emulated at 2N = 8192, D =
   128 (``emulated_ring_ntxent``: the ring's per-hop ``lse_hop`` over #1
   general, ``block_grads`` over #6) against ntxent_loss_fused, P
   launches of each per rank;
12j. the long-context path in the NCCL group of world 1:
   ``LongContextTransformer`` (vocabulary 49408, hidden 512, depth 8, 8
   heads, MLP 2048, max_len 32768, bf16) at B 1, L 32768 under
   ``make_ring_attention(group, causal=True, impl="flash")``: three
   forward and backward passes of the probe sum(out^2), host-clock timed,
   each launching exactly 8/8/8 of #12/#13/#14 and nothing else, every
   parameter's gradient finite; the output and gradients against the same
   weights under ``flash_attention`` and under 4 emulated ring ranks; an
   fp32 model at depth 2, L 1024 against the CPU;
12k. in the same group: Ulysses attention at world 1 against
   ``attention_oracle``, the flash ring with two transfer chunks against
   one, ``make_ring_ntxent(group, impl="fused")`` and ``impl="auto"``
   against ``ntxent_loss_fused`` (1/1/1 launches of #1 general and #6
   rows and columns), and the ring InfoNCE (dual and twoblock) against
   ``info_nce_fused``;
13. one JSON line describing each kernel of the paths;
14. the last line: ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --truth`` runs phases 1 and 2 and then prints the
three bf16 kernels' fp32-truth readings (#11, #13, #12) and the per-tile
readings of #13 and #14 at the two hops of 12g, without gating them: run
over the kernels a change replaces, they are the readings a gate's
factor or tolerance is set between.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, the bf16
# tensor-core rate and the fastest fp32-accurate product: three TF32
# passes (3xTF32, hi.hi + hi.lo + lo.hi) at the 495 TFLOP/s TF32 rate.
# The 67 TFLOP/s CUDA-core fp32 rate is no least time: #1 and #5 run on
# the tensor cores in 3xTF32 and would read above 100% of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 495e12 / 3

# Serving shape of ViT-B/16 at bucket 64: B=64, L=197, H=12, D=64.
SERVE_SHAPE = dict(b=64, lq=197, lk=197, h=12, d=64)
# Training shape of ViT-B/16 at --batch 256: both views, B=512.
TRAIN_SHAPE = dict(b=512, lq=197, lk=197, h=12, d=64)
# (name, shape, dtype, causal, q_offset, k_offset)
KERNEL_CASES = [
    ("serve_bf16", SERVE_SHAPE, "bfloat16", False, 0, 0),
    ("serve_fp32", SERVE_SHAPE, "float32", False, 0, 0),
    ("train_bf16", TRAIN_SHAPE, "bfloat16", False, 0, 0),
    ("causal_bf16", dict(b=2, lq=100, lk=300, h=4, d=64), "bfloat16", True,
     0, 37),
    ("causal_fp32", dict(b=2, lq=100, lk=300, h=4, d=64), "float32", True,
     150, 20),
    ("d128_bf16", dict(b=4, lq=197, lk=197, h=8, d=128), "bfloat16", False,
     0, 0),
    ("d128_fp32", dict(b=4, lq=197, lk=197, h=8, d=128), "float32", False,
     0, 0),
]
# Tolerances (max abs error against the plain version on the same card).
# o in bf16: p is rounded to bf16 at the kernel's running max rather than
# the final one, and o itself is rounded to bf16 (one ulp is 2**-8
# relative) -> 2e-2. o in fp32: only the summation order differs -> 1e-4.
# lse is fp32 in both dtypes, built from the same exactly-multiplied
# inputs -> 1e-3.
O_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_ATOL = 1e-3
# The bf16 forward against an fp32 truth (the fp32 softmax of the same
# bf16 inputs, p never rounded) at the training shape, over seeds: its
# rms error over the plain version's. On the H100 the kernel read
# 0.9821-0.9822 over these seeds (it rounds p at a running maximum, the
# plain version at the final one) and a control that rounds acc to bf16
# once more before the division 1.2554-1.2556; the factor sits between
# them, near their geometric mean -> 1.1, and the control must exceed it.
TRUTH_SEEDS = (101, 102, 103, 104)
TRUTH_RMS_FACTOR = 1.1
# dQ (#13) and the fold (#12) against an fp32 truth in the same way, each
# over TRUTH_SEEDS: the same bf16 inputs through fp32 arithmetic with
# nothing rounded (p, ds and P in fp32). dQ at the training shape, from
# the plain forward's lse and delta; its control accumulates the plain
# dq in bf16 across 64-key tiles. The fold: two consecutive folds at the
# P = 4 hop (FOLD_TRUTH_SHAPE), a whole block of the past and then the
# causal diagonal block (q_offset == k_offset), normalized to acc / l;
# its control rounds acc to bf16 between the two folds. On the H100 the
# WMMA kernels these replaced read: dQ 1.00000 over the four seeds (it
# rounds ds as the plain version does), its control 1.9604-1.9618; the
# fold 0.9834-0.9844 (p rounded at a 64-key tile's running maximum), its
# control 1.3140-1.3253. Each factor sits between its two readings, near
# their geometric mean.
DQ_TRUTH_RMS_FACTOR = 1.4
FOLD_TRUTH_RMS_FACTOR = 1.14
FOLD_TRUTH_SHAPE = (8, 8192, 64)
# Embeddings are unit vectors computed in bf16: batching and padding may
# change the GEMM shapes and so the rounding, never more than this.
EMBED_ATOL = 2e-2
# NT-Xent kernels against their plain versions: the same fp32 products
# (bf16 inputs are exact in fp32) summed in another order, logits up to
# 1/T = 10 -> 2e-4 on lse, loss_sum/2N and grad.
NTX_ATOL = 2e-4
# (2N, D): the path's shape, the north-star global batch 4096, and a
# ragged 2N with D != 2B.
NTX_SHAPES = [(512, 128), (8192, 128), (1000, 96)]
NTX_TEMPERATURE = 0.1
# The TF32 control of #1 and #5 at the first two NTX_SHAPES in fp32: the
# plain versions on z rounded to TF32 once (one TF32 pass, tf32_split's
# hi). The kernels' lse and gradient errors must lie this factor below
# the control's: a kernel that dropped a lo product would sit at the
# control's error, within NTX_ATOL.
TF32_CONTROL_FACTOR = 10
# Flash backward against its plain version. fp32: summation order only
# -> 1e-4. bf16: ds is rounded to bf16 before ds . K on both sides, and a
# one-ulp flip of a rounded ds between the two summation orders moves dq
# by up to 2**-8 |ds| |k| -> 3e-2 on dq; dk/dv keep p and ds to ~16 bits
# (the kernel's hi/lo split) against the plain version's fp32 -> 1e-2.
BWD_ATOL = {"bfloat16": dict(dq=3e-2, dkv=1e-2),
            "float32": dict(dq=1e-4, dkv=1e-4)}
BWD_CASES = [
    ("train_bf16", TRAIN_SHAPE, "bfloat16", False, 0, 0),
    ("train_fp32", TRAIN_SHAPE, "float32", False, 0, 0),
    ("causal_bf16", dict(b=2, lq=100, lk=300, h=4, d=64), "bfloat16", True,
     0, 37),
    ("causal_fp32", dict(b=2, lq=100, lk=300, h=4, d=64), "float32", True,
     150, 20),
]

# InfoNCE kernels against their plain versions. The same exact fp32
# products (bf16 inputs are exact in fp32) summed in another order, logits
# up to the scale 17.5 -> 2e-4 on lse_a, lse_b and loss_sum/2N; rows of G
# sum to at most 4 in absolute value over unit-norm embeddings -> 2e-4 on
# o_a and o_b.
INFONCE_ATOL = 2e-4
# (N, D): the CLIP path's shape (batch 256, embedding 512), a ragged N,
# N = 8192, each also at D = 128.
INFONCE_SHAPES = [(256, 512), (1000, 512), (8192, 512), (256, 128),
                  (1000, 128), (8192, 128)]
INFONCE_SCALE = 17.5  # not 1/T of the default temperature
INFONCE_TIMED_N = (256, 8192)

TRAIN_STEPS = 5
TRAIN_ARGV = ["--model", "vit_b16", "--vit-attention", "flash",
              "--image-size", "224", "--batch", "256", "--steps",
              str(TRAIN_STEPS), "--dataset", "synthetic", "--device", "cuda",
              "--log-every", "1"]
# Kernel launches per train step: the loss forward and backward once, each
# of the 12 blocks' attention forward, dQ and dK/dV once.
STEP_LAUNCHES = {"ntxent_fwd": 1, "ntxent_bwd_sym": 1,
                 "flash_attention_fwd": 12, "flash_attention_dq": 12,
                 "flash_attention_dkv": 12}
# Card vs CPU, one step of ViT-B/16 from the same weights and views.
# fp32: both sides compute in fp32 (FMA kernels, no TF32) and differ by
# summation order only, amplified through 12 blocks, the projection head
# and the loss's gradient -> 1e-4 on the loss, 1e-2 on the relative
# gradient norm. bf16, the path's dtype, is a printed reading and no
# gate: at initialization the embeddings of random images nearly coincide
# (loss ~ log(2B - 1)), so the loss and its gradient are made of
# differences between embeddings of the size of bf16 rounding, which the
# two devices round in other places (on one CPU the bf16 step's loss
# moves by 0.2 with the thread count alone), and kernels of one accuracy
# fell on both sides of any limit on it. The bf16 kernels' accuracy is
# held by their fp32-truth gates (TRUTH_GATES) instead.
PARITY_BATCH = 4
PARITY_LOSS_ATOL = 1e-4
PARITY_GRAD_RTOL = 1e-2

CLIP_STEPS = 5
CLIP_ARGV = ["--objective", "clip", "--model", "vit_b16", "--vit-attention",
             "flash", "--image-size", "224", "--batch", "256", "--steps",
             str(CLIP_STEPS), "--base-lr", "5e-4", "--warmup-steps", "1",
             "--device", "cuda", "--log-every", "1"]
# Kernel launches per CLIP step: the loss forward and backward once (each
# kernel covers both directions in one launch), each of the image tower's
# 12 blocks' attention forward, dQ and dK/dV once.
CLIP_STEP_LAUNCHES = {"infonce_dual_fwd": 1, "infonce_dual_bwd": 1,
                      "flash_attention_fwd": 12, "flash_attention_dq": 12,
                      "flash_attention_dkv": 12}
# Card vs CPU, one fp32 CLIP step from the same weights, images and
# tokens: summation order only, through 12 blocks of each tower, the
# projections and the loss -> the SimCLR step's fp32 tolerances.
CLIP_PARITY_BATCH = 4

# General NT-Xent kernels (#1 general mode, #6): (R, C, D). The first is
# the data-parallel path of this run (a world of one at --batch 256, every
# row a local row), the second one rank of a 4-card world at global batch
# 256, the third one rank of four at global batch 4096, the last ragged
# with a padding row (R odd) and D != 2B. Tolerances: those of the
# symmetric kernels (NTX_ATOL), for the same reasons.
GENERAL_SHAPES = [(512, 512, 128), (128, 512, 128), (2048, 8192, 128),
                  (101, 1000, 96)]
# Four ranks on one card: P = 4 strips of global batch 256 (2N = 512,
# D = 128) against the single-card loss: the same terms summed in another
# order -> 1e-5 on the mean loss, 1e-4 on the relative gradient.
EMULATED_RANKS, EMULATED_BATCH = 4, 256
EMULATED_LOSS_ATOL, EMULATED_GRAD_RTOL = 1e-5, 1e-4

DP_STEPS = 5
DP_ARGV = ["--model", "resnet50", "--image-size", "224", "--batch", "256",
           "--steps", str(DP_STEPS), "--dataset", "synthetic", "--device",
           "cuda", "--log-every", "1"]
# Kernel launches per data-parallel step: the strip loss's forward and
# its two backward kernels once; nothing else.
DP_STEP_LAUNCHES = {"ntxent_fwd_general": 1, "ntxent_bwd_general_rows": 1,
                    "ntxent_bwd_general_cols": 1}
# World-1 data-parallel step vs the single-card step, fp32 ResNet-50:
# the strip loss against the symmetric one (another summation order) and
# the cross-replica BatchNorm's all-reduces at world 1 -> the fp32 train
# parity tolerances.
DP_PARITY_BATCH = 8

# Data-parallel CLIP kernels (#9 rectangular, #5 cross-modal, #4): (rows,
# cols, D) of one rank's za rows against the gathered zb. A world of one
# at --batch 256 (the path of this run), one rank of 4 at batch 256, one
# rank of 4 at a global batch of 4096 (where the TPU package's backward
# takes its two-kernel fallback), and a ragged shape with scattered row
# ids and a padding row (id = cols). Tolerances: INFONCE_ATOL, for its
# reasons (the same exact products summed in another order).
DP_CLIP_SHAPES = [(256, 256, 512), (64, 256, 512), (1024, 4096, 512),
                  (101, 1000, 96)]
DP_CLIP_SCALE = 1 / 0.07  # CLIP's initial exp(logit_scale)
# Four ranks of a world of 4 on one card at global batch 256 (D = 512):
# the merged partial losses and gradients against the single-card
# info_nce_fused: the same terms summed in another order -> 1e-5 on the
# mean loss, 1e-4 on each relative gradient.
DP_CLIP_LOSS_ATOL, DP_CLIP_GRAD_RTOL = 1e-5, 1e-4
CLIP_DP_STEPS = 5
CLIP_DP_ARGV = ["--objective", "clip", "--model", "vit_b16",
                "--vit-attention", "flash", "--image-size", "224", "--batch",
                "256", "--steps", str(CLIP_DP_STEPS), "--base-lr", "5e-4",
                "--warmup-steps", "1", "--device", "cuda", "--log-every",
                "1"]
# Kernel launches per data-parallel CLIP step: the rectangular forward and
# the two backward kernels once, the image tower's flash kernels 12 times;
# no other loss kernel.
CLIP_DP_STEP_LAUNCHES = {"infonce_dual_fwd_rect": 1, "infonce_bwd_rows": 1,
                         "infonce_bwd_cols": 1, "flash_attention_fwd": 12,
                         "flash_attention_dq": 12, "flash_attention_dkv": 12}
# The symmetric ntxent_fwd re-timed beside the data-parallel InfoNCE
# kernels over more launches than the other timings: ten launches of a
# ~0.1 ms kernel do not separate its modes' times.
SYM_RETIME_RUNS = 200

# Shard-pair kernels (#7 block_lse_dual, #8 block_grads_dual): (R, C, D,
# world) of one tile. The self tile of a world of one at --batch 256 (the
# data-parallel pair path of this run, k = 0), the k = 1 tile of rank 0
# of a world of 4 at global batch 256 ("r4") and 4096 ("r4/4096"), and a
# ragged tile (world None) with scattered ids, ids shared by rows and
# columns (self entries) and sentinel rows and columns. Tolerance:
# NTX_ATOL, for its reasons (the same exact products summed in another
# order).
PAIR_CASES = [(512, 512, 128, 1), (128, 128, 128, 4), (2048, 2048, 128, 4),
              (100, 260, 96, None)]
# Pair ranks emulated on one card one after another, their lse shares
# merged as the pmax and psum do and their gradient buffers summed as the
# psum does, against the single-card symmetric kernels: P = 2, 3, 4, 8 at
# global batch 256 (255 for P = 3, which 256 does not divide), D = 128.
# Tolerances: EMULATED_LOSS_ATOL and EMULATED_GRAD_RTOL.
PAIR_WORLDS = (2, 3, 4, 8)
DP_PAIR_ARGV = DP_ARGV + ["--dp-loss", "pair"]
# Kernel launches per data-parallel pair step at world 1: the self tile's
# dual stats and dual gradients once each; nothing else.
DP_PAIR_STEP_LAUNCHES = {"block_lse_dual": 1, "block_grads_dual": 1}
# Triangular kernels (#2 ntxent_fwd_tri, #3 ntxent_bwd_tri): (2N, D), the
# symmetric path's shape, the north-star global batch 4096 and a 2N that
# is no multiple of the 64-row tile. Against their plain versions at
# NTX_ATOL; against the rectangular kernels (#1 + #5) on the same input,
# the loss within TRI_LOSS_RTOL (the same terms summed in another order).
TRI_SHAPES = [(512, 128), (8192, 128), (300, 128)]
TRI_LOSS_RTOL = 1e-5
# Launches of one ntxent_loss_fused(..., triangular=True) forward and
# backward: #2 and #3 once each, nothing else.
TRI_LAUNCHES = {"ntxent_fwd_tri": 1, "ntxent_bwd_tri": 1}

# The long-context slice. Fold kernel (#12) cases: (name, (BH, Lq, Lk,
# D), dtype, causal, q_offset, k_offsets of consecutive folds). Against
# the plain version: m, the same fp32 maxima of exact products -> 1e-4;
# l, the same fp32 terms summed in another order -> 1e-4 relative; acc /
# l (the attention output) as |a - b| / |b| over the whole tensor, the
# emulated rings' RING_RTOL: fp32 summation order -> 1e-5; bf16, p
# rounded to bf16 (2**-8 relative) at the running max of a 64-key tile
# where the plain version folds the block in one step -> 1e-2. A relative
# norm and not an absolute limit, since a typical |acc / l| over 8192
# randn keys is about 0.01. The control: a fold that dropped the carry
# must miss by more than that.
FOLD_CASES = [
    ("noncausal_bf16", (8, 8192, 8192, 64), "bfloat16", False, 0, (0, 8192)),
    ("partly_masked_fp32", (8, 4096, 4096, 128), "float32", True, 6144,
     (0, 4096)),
    ("diagonal_bf16", (8, 8192, 8192, 64), "bfloat16", True, 8192,
     (0, 8192)),
    ("ragged_bf16", (4, 1000, 1000, 64), "bfloat16", True, 1000, (0, 1000)),
]
FOLD_M_ATOL, FOLD_L_RTOL = 1e-4, 1e-4
FOLD_O_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
# The plain fold, dQ and dK/dV at the path's hop run in q-row chunks: the
# whole (8, 32768, 32768) fp32 score matrix would not fit on the card.
HOP_PLAIN_CHUNKS = 8
# #13 and #14 at those hops, tile by tile: the largest |a - b| / |b| over
# the 64-row tiles of dq (q tiles) and of dk, dv (kv tiles) against the
# plain versions. Under a causal mask with these random inputs the rows'
# p falls as 1/position, so dq shrinks from the first rows to the last
# and an absolute tolerance cannot see the late rows; a tile's relative
# error can. Controls leave one tile pair out of the heaviest walk and
# must miss: for dq the last q tile (its p spread over all its kv tiles)
# without the kv tile in the middle of its walk; for dk/dv kv tile 0
# (every q tile live) without q tile 1, the rows nearest its keys, which
# carry its dk/dv (a far q tile adds too little to be seen in bf16). On
# the H100 the worst tile read, at the path's hop and the P = 4 hop: dq
# 6.0e-4 and 2.7e-4 on the WMMA dQ this replaced, 6.0e-4 and 2.5e-4 on
# the TMA/wgmma dQ; dk/dv 1.4e-4 and 3.4e-5; the controls dq 4.4e-2 and
# 9.5e-2, dk/dv 0.50 and 0.52. The limit sits between the sound readings
# and the controls, near dq's geometric mean.
HOP_TILE_RTOL = 5e-3
# The path: batch 1 x 8 heads of 64 at L = 32768 (the tower's max_len).
LONGCTX_BATCH, LONGCTX_LEN, LONGCTX_BH, LONGCTX_HEAD_DIM = 1, 32768, 8, 64
LONGCTX_PASSES = 3
# One forward and backward at world 1: per block one fold, one dQ and one
# dK/dV hop; nothing else.
LONGCTX_LAUNCHES = {"flash_fold": 8, "flash_attention_dq": 8,
                    "flash_attention_dkv": 8}
# The same bf16 weights under another plan: each block's attention output
# may differ by a bf16 rounding of p at another running maximum (2**-8
# relative at most per element); over 8 blocks the gaps add up to
# 8 * 2**-8 -> 3e-2 relative on the output, twice that (6e-2) on the
# gradient vector, which goes through the blocks twice. The fp32 model
# against the CPU: the train parity tolerances (PARITY_LOSS_ATOL on the
# output, PARITY_GRAD_RTOL).
LONGCTX_OUT_RTOL, LONGCTX_GRAD_RTOL = 3e-2, 6e-2
LONGCTX_PARITY_LEN = 1024
# Emulated rings: (B, L, H, D), the rank counts, and the largest relative
# error |a - b| / |b| of out, dq, dk, dv against flash_attention of the
# whole sequence and against the jnp ring: fp32 summation order -> 1e-5;
# bf16, p rounded at other running maxima and ds at other lse roundings
# -> 1e-2.
RING_SHAPE = dict(b=1, l=8192, h=8, d=64)
RING_WORLDS = (2, 4, 8)
RING_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
# The ring NT-Xent's global batch and the ring InfoNCE's pairs; the
# kernels a fused ring NT-Xent launches once a hop per rank.
RING_NTX_2N = 8192
RING_NTX_KERNELS = ("ntxent_fwd_general", "ntxent_bwd_general_rows",
                    "ntxent_bwd_general_cols")
RING_INFONCE_N = 1024

SERVE_ARGV = ["--model", "vit_b16", "--vit-attention", "flash",
              "--image-size", "224", "--head", "embedding",
              "--buckets", "1,4,16,64", "--port", "0",
              # a window long enough for concurrent requests, whose bodies
              # take a while to parse, to coalesce into one device call
              "--max-delay-ms", "250", "--device", "cuda", "--seed", "0"]
CLIENT_THREADS = 4
CLIENT_ROUNDS = 3
ROW_COUNTS = (1, 3, 8)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _bound(moved: int, flops: int, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of their type."""
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / peak_flops * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms
                                     else "operations")


def phase_card() -> tuple[str, str]:
    import torch

    from ntxent_tpu_torch.utils.capability import card_power_line

    name = torch.cuda.get_device_name(0)
    smi = card_power_line()
    print(f"[card] {name} | nvidia-smi: {smi} | torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return name, smi


def phase_build() -> dict:
    """Build every kernel; returns nvcc's reports by kernel name."""
    from ntxent_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel source(s) ready in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    for name in _build.SOURCES:
        if name not in logs:
            print(f"[build] {name}: built before this run, no ptxas report")
        for line in logs.get(name, "").splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "spill")):
                print(f"[build] {name}: {line.strip()}")
    return logs


def _qkv(shape, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bh = shape["b"] * shape["h"]

    def rand(length):
        return torch.randn(bh, length, shape["d"], generator=gen,
                           device="cuda").to(getattr(torch, dtype))

    return rand(shape["lq"]), rand(shape["lk"]), rand(shape["lk"])


def _fwd_truth_rms(seed: int) -> dict:
    """#11 at the training shape in bf16 against the fp32 softmax of the
    same inputs (p never rounded); the control is the plain forward's
    arithmetic with one rounding more, the unnormalized accumulator
    stored in v's dtype before the division (an epilogue that kept acc
    in bf16)."""
    import torch

    from ntxent_tpu_torch.ops import attention

    q, k, v = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / TRAIN_SHAPE["d"] ** 0.5
    truth = torch.softmax(s, -1) @ v.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    acc = torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)
    control = (acc.float() / p.sum(-1, keepdim=True)).to(q.dtype)
    del p, acc
    return {"kernel": _rms(attention.flash_attention_fwd(q, k, v)[0], truth),
            "plain": _rms(attention.attention_plain(q, k, v)[0], truth),
            "control": _rms(control, truth)}


def _truth_gate(label: str, wrapper: str, rms_of_seed, factor: float,
                control: str, gate: bool = True) -> None:
    """Hold a bf16 kernel to an fp32 truth over TRUTH_SEEDS: its rms
    error over the plain version's must be at most ``factor``, and the
    control's (one rounding more) must exceed it. ``rms_of_seed(seed)``
    returns the rms errors of "kernel", "plain" and "control". With
    ``gate`` false the readings are printed and nothing fails."""
    for seed in TRUTH_SEEDS:
        rms = rms_of_seed(seed)
        ratio = rms["kernel"] / rms["plain"]
        over = rms["control"] / rms["plain"]
        ok = ratio <= factor < over
        verdict = ("ok" if ok else "MISMATCH") if gate else "(not gated)"
        print(f"[kernel] {label} seed {seed} against an fp32 truth: rms "
              f"error kernel {rms['kernel']:.6e}, plain version "
              f"{rms['plain']:.6e}, ratio {ratio:.5f} (at most {factor:g}); "
              f"the control ({control}) {rms['control']:.6e}, ratio "
              f"{over:.5f} (must exceed it) {verdict}", flush=True)
        if gate and not ok:
            fail(f"{wrapper}'s bf16 result against the fp32 truth (seed "
                 f"{seed}): ratio {ratio:.5f}, control {over:.5f}, factor "
                 f"{factor:g}")


def _rms(a, b) -> float:
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


def _dq_truth_rms(seed: int) -> dict:
    """#13 at the training shape in bf16 against dq in fp32 with ds never
    rounded, from the plain forward's lse and delta; the control
    accumulates the plain dq in bf16 across 64-key tiles."""
    import torch

    from ntxent_tpu_torch.ops import attention as A

    q, k, v = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed)
    do = _qkv(TRAIN_SHAPE, "bfloat16", seed=seed + 1000)[0]
    o, lse = A.attention_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    del o
    sc = A.resolve_attention_scale(None, q.shape[-1])
    _, ds = A._bwd_probs(q, k, v, do, lse, delta, sc, False, 0, 0)
    kf = k.float()
    truth = torch.matmul(ds, kf)
    ds = ds.to(k.dtype).float()
    control = torch.zeros_like(truth, dtype=torch.bfloat16)
    for j in range(0, k.shape[1], 64):
        control = (control.float() + torch.matmul(
            ds[..., j:j + 64], kf[:, j:j + 64])).to(torch.bfloat16)
    del ds, kf
    args = (q, k, v, do, lse, delta)
    return {"kernel": _rms(A.flash_attention_dq(*args), truth),
            "plain": _rms(A.attention_dq_plain(*args), truth),
            "control": _rms(control, truth)}


def _fold_truth_rms(seed: int) -> dict:
    """#12 in bf16: two consecutive folds at FOLD_TRUTH_SHAPE (a whole
    block of the past, then the causal diagonal block), acc / l, against
    the fp32 softmax of the same inputs over both blocks (P never
    rounded); the control rounds acc to bf16 between the two folds."""
    import torch

    from ntxent_tpu_torch.ops import attention as A

    bh, length, d = FOLD_TRUTH_SHAPE
    q, k1, v1 = _flat_qkv(bh, length, length, d, "bfloat16", seed)
    _, k2, v2 = _flat_qkv(bh, length, length, d, "bfloat16", seed + 1000)
    first = dict(q_offset=length, k_offset=0, causal=True)
    second = dict(q_offset=length, k_offset=length, causal=True)

    def out(carry):
        return carry[2] / carry[1][..., None]

    kernel = A.flash_fold(q, k1, v1, *_fold_carry(bh, length, d), **first)
    kernel = out(A.flash_fold(q, k2, v2, *kernel, **second))
    plain = A.flash_fold_plain(q, k1, v1, *_fold_carry(bh, length, d),
                               **first)
    rounded = (plain[0], plain[1], plain[2].to(torch.bfloat16).float())
    plain = out(A.flash_fold_plain(q, k2, v2, *plain, **second))
    control = out(A.flash_fold_plain(q, k2, v2, *rounded, **second))
    del rounded
    kf, vf = torch.cat([k1, k2], 1).float(), torch.cat([v1, v2], 1).float()
    sq = {"kernel": 0.0, "plain": 0.0, "control": 0.0}
    rows = length // 4
    for r in range(0, length, rows):  # the truth in row chunks
        s = torch.matmul(q[:, r:r + rows].float(), kf.transpose(-1, -2)) \
            * d ** -0.5
        live = torch.arange(2 * length, device=q.device)[None, :] \
            <= length + r + torch.arange(rows, device=q.device)[:, None]
        truth = torch.softmax(s.masked_fill(~live, float("-inf")), -1) @ vf
        del s
        for name, o in (("kernel", kernel), ("plain", plain),
                        ("control", control)):
            sq[name] += (o[:, r:r + rows] - truth).pow(2).sum().item()
    return {name: (total / kernel.numel()) ** 0.5
            for name, total in sq.items()}


# (label, wrapper, rms of a seed, factor, control) of each bf16 kernel's
# fp32-truth gate: #11, #13 and #12.
TRUTH_GATES = [
    ("train_bf16", "flash_attention_fwd", _fwd_truth_rms, TRUTH_RMS_FACTOR,
     "acc rounded to bf16 once more"),
    ("dq train_bf16", "flash_attention_dq", _dq_truth_rms,
     DQ_TRUTH_RMS_FACTOR, "dq accumulated in bf16 across 64-key tiles"),
    ("fold P4 hop", "flash_fold", _fold_truth_rms, FOLD_TRUTH_RMS_FACTOR,
     "acc rounded to bf16 between the two folds"),
]


def phase_kernels() -> dict:
    import torch
    import torch.nn.functional as F

    from ntxent_tpu_torch.ops import attention
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    serve_err = None
    for i, (name, shape, dtype, causal, q_off, k_off) in enumerate(
            KERNEL_CASES):
        q, k, v = _qkv(shape, dtype, seed=i)
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        o, lse = attention.flash_attention_fwd(q, k, v, **kw)
        o_ref, lse_ref = attention.attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if o.dtype != q.dtype or lse.shape != (q.shape[0], q.shape[1]):
            fail(f"{name}: kernel returned o {o.dtype}, lse "
                 f"{tuple(lse.shape)}")
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = o_err <= O_ATOL[dtype] and lse_err <= LSE_ATOL
        print(f"[kernel] {name}: o max|err| {o_err:.3e} "
              f"(atol {O_ATOL[dtype]:g}), lse max|err| {lse_err:.3e} "
              f"(atol {LSE_ATOL:g}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"flash_attention_fwd disagrees with its plain version "
                 f"in case {name}")
        if name == "serve_bf16":
            serve_err = o_err

    _truth_gate(*TRUTH_GATES[0])

    times = {}
    for label, s in (("serve", SERVE_SHAPE), ("train", TRAIN_SHAPE)):
        q, k, v = _qkv(s, "bfloat16", seed=100)
        q4, k4, v4 = (t.view(s["b"], s["h"], -1, s["d"]) for t in (q, k, v))
        kernel_ms = cuda_time_ms(
            lambda: attention.flash_attention_fwd(q, k, v))
        plain_ms = cuda_time_ms(lambda: attention.attention_plain(q, k, v))
        sdpa_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4))
        bh, lq, lk, d = s["b"] * s["h"], s["lq"], s["lk"], s["d"]
        moved = (2 * bh * lq * d + 2 * bh * lk * d) * 2 + bh * lq * 4
        flops = 4 * bh * lq * lk * d
        bound_ms, bound_by = _bound(moved, flops, PEAK_BF16_FLOPS)
        print(f"[kernel] {label} shape (B*H={bh}, L={lq}, D={d}, bf16): "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({moved} bytes, "
              f"{flops} flops)", flush=True)
        times[label] = (kernel_ms, plain_ms, sdpa_ms, bound_ms, bound_by)
    kernel_ms, plain_ms, sdpa_ms, bound_ms, bound_by = times["train"]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "ntxent_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ntxent_tpu/ops/attention_pallas.py:73 (_fwd_kernel)",
            "checked": True, "launches": None, "max_abs_err": serve_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": sdpa_ms,
            "serve_shape_ms": times["serve"][0]}


def _unit_rows(rows, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn(rows, d, generator=gen, device="cuda")
    return torch.nn.functional.normalize(z, dim=1).to(getattr(torch, dtype))


def _ptxas_walks(logs: dict, name: str) -> list[str]:
    """One line per TF32 walk kernel in a build report: its mangled name,
    ptxas's spill and register lines."""
    lines = logs.get(name, "").splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "_walk" in line:
            kernel = line.split("'")[1] if "'" in line else line
            report = [ln.split(":")[-1].strip() for ln in lines[i + 1:i + 4]
                      if "registers" in ln or "spill" in ln]
            out.append(f"{kernel}: {' | '.join(report)}")
    return out


def _tf32_control(z, t) -> tuple[tuple[float, float], tuple[float, float]]:
    """(lse, gradient) max abs errors against the fp32 plain versions of
    #1 + #5 on z, and of one TF32 pass (the plain versions on z rounded to
    TF32)."""
    import torch

    from ntxent_tpu_torch.ops import ntxent

    _, lse_ref = ntxent.ntxent_fwd_plain(z, t)
    grad_ref = ntxent.ntxent_bwd_sym_plain(z, lse_ref, t)
    _, lse = ntxent.ntxent_fwd(z, t)
    grad = ntxent.ntxent_bwd_sym(z, lse, t)
    z_tf32 = ntxent.tf32_split(z)[0]
    _, lse_c = ntxent.ntxent_fwd_plain(z_tf32, t)
    grad_c = ntxent.ntxent_bwd_sym_plain(z_tf32, lse_c, t)
    torch.cuda.synchronize()

    def err(a, b):
        return (a - b).abs().max().item()

    return ((err(lse, lse_ref), err(grad, grad_ref)),
            (err(lse_c, lse_ref), err(grad_c, grad_ref)))


def phase_ntxent_kernels(build_logs: dict) -> list[dict]:
    """ntxent_fwd and ntxent_bwd_sym against their plain versions, the
    TF32 control, ptxas's report of their walks, then times at the path's
    shape (2N = 512, D = 128, fp32) and at 2N = 8192."""
    import torch

    from ntxent_tpu_torch.ops import ntxent
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t = NTX_TEMPERATURE
    errs = {}
    for rows, d in NTX_SHAPES:
        for dtype in ("float32", "bfloat16"):
            z = _unit_rows(rows, d, dtype, seed=rows + d)
            loss, lse = ntxent.ntxent_fwd(z, t)
            grad = ntxent.ntxent_bwd_sym(z, lse, t)
            loss_ref, lse_ref = ntxent.ntxent_fwd_plain(z, t)
            grad_ref = ntxent.ntxent_bwd_sym_plain(z, lse_ref, t)
            again, _ = ntxent.ntxent_fwd(z, t)
            torch.cuda.synchronize()
            fwd_err = max((lse - lse_ref).abs().max().item(),
                          abs(loss.item() - loss_ref.item()) / rows)
            bwd_err = (grad - grad_ref).abs().max().item()
            repeat = again.item() == loss.item()
            ok = fwd_err <= NTX_ATOL and bwd_err <= NTX_ATOL and repeat
            print(f"[kernel] ntxent 2N={rows} D={d} {dtype}: fwd max|err| "
                  f"{fwd_err:.3e}, bwd max|err| {bwd_err:.3e} (atol "
                  f"{NTX_ATOL:g}), loss bitwise repeatable {repeat} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the NT-Xent kernels disagree with their plain "
                     f"versions at 2N={rows} D={d} {dtype}")
            if (rows, d, dtype) == (512, 128, "float32"):
                errs = {"ntxent_fwd": fwd_err, "ntxent_bwd_sym": bwd_err}
            del z, grad, grad_ref

    for rows, d in NTX_SHAPES[:2]:
        z = _unit_rows(rows, d, "float32", seed=rows + d)
        kernel, control = _tf32_control(z, t)
        ok = all(k <= NTX_ATOL and TF32_CONTROL_FACTOR * k <= c
                 for k, c in zip(kernel, control))
        print(f"[kernel] ntxent TF32 control 2N={rows} D={d} fp32: kernels "
              f"lse {kernel[0]:.3e} grad {kernel[1]:.3e}, one TF32 pass lse "
              f"{control[0]:.3e} grad {control[1]:.3e} (ratios "
              f"{control[0] / max(kernel[0], 1e-30):.1f}, "
              f"{control[1] / max(kernel[1], 1e-30):.1f}; at least "
              f"{TF32_CONTROL_FACTOR}) {'ok' if ok else 'MISSED'}",
              flush=True)
        if not ok:
            fail(f"the NT-Xent kernels are not {TF32_CONTROL_FACTOR}x more "
                 f"accurate than one TF32 pass at 2N={rows}")
        del z
    for name in ("ntxent_fwd", "ntxent_bwd_sym"):
        for line in _ptxas_walks(build_logs, name):
            print(f"[kernel] ptxas {name}: {line}", flush=True)

    timed = {}
    for rows, d in NTX_SHAPES[:2]:
        z = _unit_rows(rows, d, "float32", seed=0)
        _, lse = ntxent.ntxent_fwd(z, t)
        runs = 3 if rows > 4096 else 10
        fwd_ms = cuda_time_ms(lambda: ntxent.ntxent_fwd(z, t))
        fwd_plain = cuda_time_ms(lambda: ntxent.ntxent_fwd_plain(z, t), runs)
        bwd_ms = cuda_time_ms(lambda: ntxent.ntxent_bwd_sym(z, lse, t))
        bwd_plain = cuda_time_ms(
            lambda: ntxent.ntxent_bwd_sym_plain(z, lse, t), runs)
        zb = rows * d * 4
        fwd_bound = _bound(zb + rows * 4 + 4, 2 * rows * rows * d,
                           PEAK_FP32_FLOPS)
        bwd_bound = _bound(2 * zb + rows * 4, 4 * rows * rows * d,
                           PEAK_FP32_FLOPS)
        splits = ntxent.column_splits(
            rows, rows, torch.cuda.get_device_properties(0)
            .multi_processor_count)
        print(f"[kernel] ntxent (2N={rows}, D={d}, fp32; {splits[0]} column "
              f"split(s) of {splits[1]}): fwd {fwd_ms:.4f} ms (plain "
              f"{fwd_plain:.4f}, bound {fwd_bound[0]:.5f} by "
              f"{fwd_bound[1]}), bwd {bwd_ms:.4f} ms (plain "
              f"{bwd_plain:.4f}, bound {bwd_bound[0]:.5f} by "
              f"{bwd_bound[1]}); no single PyTorch call computes NT-Xent, "
              f"so there is no library time", flush=True)
        timed[rows] = ((fwd_ms, fwd_plain, fwd_bound),
                       (bwd_ms, bwd_plain, bwd_bound))
        del z
    common = {"route": "cuda", "checked": True, "launches": None,
              "library_ms": None}
    out = [
        {"name": "ntxent_fwd", **common,
         "source": "ntxent_tpu_torch/csrc/ntxent_fwd.cu",
         "replaces": "ntxent_tpu/ops/ntxent_pallas.py:130 (_fwd_kernel, "
                     "_fwd_call :190)",
         "max_abs_err": errs["ntxent_fwd"]},
        {"name": "ntxent_bwd_sym", **common,
         "source": "ntxent_tpu_torch/csrc/ntxent_bwd_sym.cu",
         "replaces": "ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel, "
                     "_bwd_sym_call :612)",
         "max_abs_err": errs["ntxent_bwd_sym"]},
    ]
    for i, entry in enumerate(out):
        (ms, plain, bound), big = timed[512][i], timed[8192][i]
        entry |= {"ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                  "bound_by": bound[1], "n8192_ms": big[0],
                  "n8192_plain_ms": big[1], "n8192_bound_ms": big[2][0]}
    return out


def phase_infonce_kernels() -> list[dict]:
    """infonce_dual_fwd and infonce_dual_bwd against their plain versions,
    then times at the CLIP path's shape (N = 256, D = 512, fp32) and at
    N = 8192."""
    import torch

    from ntxent_tpu_torch.ops import infonce
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    scale = torch.tensor(INFONCE_SCALE, device="cuda")
    errs = {}
    for n, d in INFONCE_SHAPES:
        for dtype in ("float32", "bfloat16"):
            za = _unit_rows(n, d, dtype, seed=n + d)
            zb = _unit_rows(n, d, dtype, seed=n + d + 1)
            loss, lse_a, lse_b = infonce.infonce_dual_fwd(za, zb, scale)
            o_a, o_b = infonce.infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
            loss_ref, lse_a_ref, lse_b_ref = infonce.infonce_dual_fwd_plain(
                za, zb, scale)
            o_a_ref, o_b_ref = infonce.infonce_dual_bwd_plain(
                za, zb, scale, lse_a_ref, lse_b_ref)
            again = infonce.infonce_dual_fwd(za, zb, scale)[0]
            torch.cuda.synchronize()
            fwd_err = max((lse_a - lse_a_ref).abs().max().item(),
                          (lse_b - lse_b_ref).abs().max().item(),
                          abs(loss.item() - loss_ref.item()) / (2 * n))
            bwd_err = max((o_a - o_a_ref).abs().max().item(),
                          (o_b - o_b_ref).abs().max().item())
            repeat = again.item() == loss.item()
            ok = (fwd_err <= INFONCE_ATOL and bwd_err <= INFONCE_ATOL
                  and repeat)
            print(f"[kernel] infonce N={n} D={d} {dtype} scale "
                  f"{INFONCE_SCALE}: fwd max|err| {fwd_err:.3e}, bwd "
                  f"max|err| {bwd_err:.3e} (atol {INFONCE_ATOL:g}), loss "
                  f"bitwise repeatable {repeat} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"the InfoNCE kernels disagree with their plain "
                     f"versions at N={n} D={d} {dtype}")
            if (n, d, dtype) == (256, 512, "float32"):
                errs = {"infonce_dual_fwd": fwd_err,
                        "infonce_dual_bwd": bwd_err}
            del za, zb, o_a, o_b, o_a_ref, o_b_ref

    d = 512
    times = {}
    for n in INFONCE_TIMED_N:
        za = _unit_rows(n, d, "float32", seed=n)
        zb = _unit_rows(n, d, "float32", seed=n + 1)
        _, lse_a, lse_b = infonce.infonce_dual_fwd(za, zb, scale)
        fwd_ms = cuda_time_ms(lambda: infonce.infonce_dual_fwd(za, zb, scale))
        fwd_plain = cuda_time_ms(
            lambda: infonce.infonce_dual_fwd_plain(za, zb, scale))
        bwd_ms = cuda_time_ms(
            lambda: infonce.infonce_dual_bwd(za, zb, scale, lse_a, lse_b))
        bwd_plain = cuda_time_ms(
            lambda: infonce.infonce_dual_bwd_plain(za, zb, scale, lse_a,
                                                   lse_b))
        zbytes = n * d * 4
        # inputs read once (za, zb, the scale; lse for the backward),
        # outputs written once; 2 N^2 D and 6 N^2 D fp32 operations
        fwd_bound = _bound(2 * zbytes + 4 + 2 * n * 4 + 4, 2 * n * n * d,
                           PEAK_FP32_FLOPS)
        bwd_bound = _bound(2 * zbytes + 4 + 2 * n * 4 + 2 * zbytes,
                           6 * n * n * d, PEAK_FP32_FLOPS)
        print(f"[kernel] infonce N={n}, D={d}, fp32: fwd {fwd_ms:.4f} ms "
              f"(plain {fwd_plain:.4f}, bound {fwd_bound[0]:.5f} by "
              f"{fwd_bound[1]}), bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, "
              f"bound {bwd_bound[0]:.5f} by {bwd_bound[1]}); no single "
              f"PyTorch call computes InfoNCE, so there is no library time",
              flush=True)
        times[n] = (fwd_ms, fwd_plain, fwd_bound, bwd_ms, bwd_plain,
                    bwd_bound)
        del za, zb
    fwd_ms, fwd_plain, fwd_bound, bwd_ms, bwd_plain, bwd_bound = times[256]
    big = times[8192]
    common = {"route": "cuda", "checked": True, "launches": None,
              "library_ms": None}
    return [
        {"name": "infonce_dual_fwd", **common,
         "source": "ntxent_tpu_torch/csrc/infonce_dual_fwd.cu",
         "replaces": "ntxent_tpu/ops/infonce_pallas.py:75 (_dual_fwd_kernel, "
                     "_dual_fwd_call :165)",
         "max_abs_err": errs["infonce_dual_fwd"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], "n8192_ms": big[0],
         "n8192_plain_ms": big[1], "n8192_bound_ms": big[2][0]},
        {"name": "infonce_dual_bwd", **common,
         "source": "ntxent_tpu_torch/csrc/infonce_dual_bwd.cu",
         "replaces": "ntxent_tpu/ops/infonce_pallas.py:204 (_dual_bwd_kernel, "
                     "_dual_bwd_call :266)",
         "max_abs_err": errs["infonce_dual_bwd"], "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "n8192_ms": big[3],
         "n8192_plain_ms": big[4], "n8192_bound_ms": big[5][0]},
    ]


def _bwd_inputs(shape, dtype, causal, q_off, k_off, seed):
    import torch

    from ntxent_tpu_torch.ops import attention

    q, k, v = _qkv(shape, dtype, seed)
    do = _qkv(shape, dtype, seed + 1)[0]
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o, lse = attention.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta), kw


def phase_flash_backward() -> list[dict]:
    """flash_attention_dq / _dkv against their plain versions, then times
    at the training shape beside SDPA's backward through autograd."""
    import torch
    import torch.nn.functional as F

    from ntxent_tpu_torch.ops import attention
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    errs = {}
    for i, (name, shape, dtype, causal, q_off, k_off) in enumerate(
            BWD_CASES):
        args, kw = _bwd_inputs(shape, dtype, causal, q_off, k_off, 200 + i)
        dq = attention.flash_attention_dq(*args, **kw)
        dk, dv = attention.flash_attention_dkv(*args, **kw)
        dq_ref = attention.attention_dq_plain(*args, **kw)
        dk_ref, dv_ref = attention.attention_dkv_plain(*args, **kw)
        torch.cuda.synchronize()
        dq_err = (dq - dq_ref).abs().max().item()
        dkv_err = max((dk - dk_ref).abs().max().item(),
                      (dv - dv_ref).abs().max().item())
        tol = BWD_ATOL[dtype]
        ok = dq_err <= tol["dq"] and dkv_err <= tol["dkv"]
        print(f"[kernel] flash backward {name}: dq max|err| {dq_err:.3e} "
              f"(atol {tol['dq']:g}), dk/dv max|err| {dkv_err:.3e} (atol "
              f"{tol['dkv']:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the flash backward kernels disagree with their plain "
                 f"versions in case {name}")
        if name == "train_bf16":
            errs = {"flash_attention_dq": dq_err,
                    "flash_attention_dkv": dkv_err}
        del args, dq, dk, dv, dq_ref, dk_ref, dv_ref

    # A ring hop wholly after its queries: every kv tile of dK/dV has no
    # live q tile and must write zeros bit for bit.
    for dtype in ("bfloat16", "float32"):
        shape = dict(b=1, lq=1024, lk=1024, h=8, d=64)
        args, kw = _bwd_inputs(shape, dtype, True, 0, 1024, 400)
        dk, dv = attention.flash_attention_dkv(*args, **kw)
        torch.cuda.synchronize()
        zeros = bool(torch.equal(dk, torch.zeros_like(dk))
                     and torch.equal(dv, torch.zeros_like(dv)))
        print(f"[kernel] flash backward wholly masked hop ({dtype}): dk, dv "
              f"zero bit for bit: {zeros}", flush=True)
        if not zeros:
            fail(f"flash_attention_dkv wrote nonzeros on a wholly masked hop "
                 f"({dtype})")
    _truth_gate(*TRUTH_GATES[1])

    s = TRAIN_SHAPE
    args, kw = _bwd_inputs(s, "bfloat16", False, 0, 0, 300)
    dq_ms = cuda_time_ms(lambda: attention.flash_attention_dq(*args, **kw))
    dkv_ms = cuda_time_ms(lambda: attention.flash_attention_dkv(*args, **kw))
    dq_plain = cuda_time_ms(
        lambda: attention.attention_dq_plain(*args, **kw), runs=3)
    dkv_plain = cuda_time_ms(
        lambda: attention.attention_dkv_plain(*args, **kw), runs=3)
    q, k, v, do = (t.view(s["b"], s["h"], -1, s["d"]).detach()
                   .requires_grad_() for t in args[:4])
    out = F.scaled_dot_product_attention(q, k, v)
    sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (q, k, v), do.detach(), retain_graph=True))
    bh, l, d = s["b"] * s["h"], s["lq"], s["d"]
    inputs = 4 * bh * l * d * 2 + 2 * bh * l * 4
    dq_bound = _bound(inputs + bh * l * d * 4, 3 * 2 * bh * l * l * d,
                      PEAK_BF16_FLOPS)
    dkv_bound = _bound(inputs + 2 * bh * l * d * 4, 4 * 2 * bh * l * l * d,
                       PEAK_BF16_FLOPS)
    print(f"[kernel] flash backward train shape (B*H={bh}, L={l}, D={d}, "
          f"bf16): dq {dq_ms:.4f} ms (plain {dq_plain:.4f}, bound "
          f"{dq_bound[0]:.4f} by {dq_bound[1]}), dkv {dkv_ms:.4f} ms (plain "
          f"{dkv_plain:.4f}, bound {dkv_bound[0]:.4f} by {dkv_bound[1]}); "
          f"SDPA backward (dq, dk, dv together) {sdpa_bwd_ms:.4f} ms",
          flush=True)
    common = {"route": "cuda", "checked": True, "launches": None,
              "source": "ntxent_tpu_torch/csrc/flash_attention_bwd.cu",
              # one library call computes dq, dk and dv together
              "library_ms": sdpa_bwd_ms}
    return [
        {"name": "flash_attention_dq", **common,
         "replaces": "ntxent_tpu/ops/attention_pallas.py:125 (_dq_kernel, "
                     "flash_dq_hop :306)",
         "max_abs_err": errs["flash_attention_dq"], "ms": dq_ms,
         "plain_ms": dq_plain, "bound_ms": dq_bound[0],
         "bound_by": dq_bound[1]},
        {"name": "flash_attention_dkv", **common,
         "replaces": "ntxent_tpu/ops/attention_pallas.py:166 (_dkv_kernel, "
                     "flash_dkv_hop :338)",
         "max_abs_err": errs["flash_attention_dkv"], "ms": dkv_ms,
         "plain_ms": dkv_plain, "bound_ms": dkv_bound[0],
         "bound_by": dkv_bound[1]},
    ]


def _post(url, body, rid):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.headers.get("X-Request-Id"), \
                json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("X-Request-Id"), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_embeddings(name, got, ref):
    got = np.asarray(got, dtype=np.float32)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        fail(f"{name}: embeddings of shape {got.shape}, expected "
             f"{ref.shape}, finite")
    norm_err = float(np.abs(np.linalg.norm(got, axis=1) - 1.0).max())
    err = float(np.abs(got - ref).max())
    if norm_err > 1e-3 or err > EMBED_ATOL:
        fail(f"{name}: |norm-1| {norm_err:.2e}, max|err| vs the direct "
             f"forward {err:.2e} (atol {EMBED_ATOL:g})")
    return err


def phase_serve(card_line: str) -> int:
    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.ops import attention

    t0 = time.monotonic()
    server = cli.build_server(cli.build_serve_parser().parse_args(SERVE_ARGV))
    server.start()
    engine = server.engine
    depth = len(engine.model.backbone.blocks)
    url = f"http://127.0.0.1:{server.port}"
    print(f"[serve] ViT-B/16 SimCLR server built and warm in "
          f"{time.monotonic() - t0:.1f} s at {url}", flush=True)
    try:
        rng = np.random.default_rng(0)
        requests = []  # (thread, round, x, body)
        for r in range(CLIENT_ROUNDS):
            for t in range(CLIENT_THREADS):
                n = ROW_COUNTS[(t + r) % len(ROW_COUNTS)]
                # three decimals keep the JSON body near 7 bytes a value
                x = rng.uniform(-1, 1, (n, 224, 224, 3)).round(3)
                body = json.dumps({"inputs": x.tolist(),
                                   "timeout_ms": 120000}).encode()
                requests.append((t, r, x.astype(np.float32), body))
        x_big = rng.uniform(-1, 1, (70, 224, 224, 3)).astype(np.float32)

        results, errors = {}, []
        barrier = threading.Barrier(CLIENT_THREADS)

        def client(t):
            try:
                for tt, r, _, body in requests:
                    if tt != t:
                        continue
                    barrier.wait(timeout=300)
                    t_send = time.monotonic()
                    status, rid, payload = _post(f"{url}/embed", body,
                                                 f"smoke-{t}-{r}")
                    results[(t, r)] = (status, rid, payload,
                                       (time.monotonic() - t_send) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"client {t}: {type(e).__name__}: {e}")

        attention.flash_attention_fwd.launches = 0
        calls0 = engine.metrics.device_calls
        t_http = time.monotonic()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(CLIENT_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        http_s = time.monotonic() - t_http
        out_big = engine.embed(x_big)
        launches = attention.flash_attention_fwd.launches
        chunks = engine.metrics.device_calls - calls0
        if errors or any(th.is_alive() for th in threads):
            fail(f"client threads: {errors or 'did not finish'}")

        if launches == 0 or launches != depth * chunks:
            fail(f"flash_attention_fwd launched {launches} times over "
                 f"{chunks} forward chunks; expected {depth} per chunk")
        print(f"[serve] flash_attention_fwd launches on the served path: "
              f"{launches} over {chunks} forward chunks ({depth} per "
              f"chunk)", flush=True)

        health, _ = _get(f"{url}/healthz")
        metrics_code, metrics = _get(f"{url}/metrics")
        if health != 200 or metrics_code != 200:
            fail(f"/healthz {health}, /metrics {metrics_code}")
        fill = metrics.get("batch_fill_ratio") or 0.0
        if fill <= 1.0:
            fail(f"batch_fill_ratio {fill}: concurrent requests were not "
                 "coalesced")

        worst = 0.0
        with torch.inference_mode():
            def direct(x):
                return engine.model(torch.from_numpy(x).to(
                    engine.device)).float().cpu().numpy()

            for t, r, x, _ in requests:
                status, rid, payload, _ = results[(t, r)]
                if status != 200 or rid != f"smoke-{t}-{r}":
                    fail(f"request {t}/{r}: HTTP {status}, X-Request-Id "
                         f"{rid!r}: {payload}")
                if payload["dim"] != 128 or payload["rows"] != x.shape[0]:
                    fail(f"request {t}/{r}: dim {payload['dim']}, rows "
                         f"{payload['rows']}")
                worst = max(worst, _check_embeddings(
                    f"request {t}/{r}", payload["embeddings"], direct(x)))
            worst = max(worst, _check_embeddings("70-row engine call",
                                                 out_big, direct(x_big)))
        lat = sorted(v[3] for v in results.values())
        rows = sum(x.shape[0] for _, _, x, _ in requests)
        print(f"[serve] {len(results)} concurrent /embed requests, {rows} "
              f"rows, all 200 and unit-norm (n, 128); max|err| vs direct "
              f"forward {worst:.3e}; batch_fill_ratio {fill}; "
              f"padding_waste {metrics.get('padding_waste')}", flush=True)
        print(f"[serve] request latency p50 {lat[len(lat) // 2]:.1f} ms, "
              f"p99 {lat[min(len(lat) - 1, int(0.99 * len(lat)))]:.1f} ms, "
              f"{rows / http_s:.1f} rows/s over HTTP with JSON bodies "
              f"(client clock) on {card_line}", flush=True)
        return launches
    finally:
        server.close()


def phase_train(card_line: str) -> dict:
    """ntxent-train on the card; returns the launches of each kernel."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(TRAIN_ARGV)
    initial = cli.build_model(args).state_dict()
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    state, history = cli.train(args)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train losses {losses}: expected {TRAIN_STEPS} finite values")
    want = {n: STEP_LAUNCHES.get(n, 0) * TRAIN_STEPS for n in counters}
    if launches != want:
        fail(f"kernel launches over {TRAIN_STEPS} steps {launches}, "
             f"expected {want}")
    moved = max((p.detach().cpu() - initial[n]).abs().max().item()
                for n, p in state.model.named_parameters())
    if not moved > 0:
        fail("no parameter changed over the train steps")
    for i, block in enumerate(state.model.backbone.blocks):
        for proj in ("query", "key", "value"):
            g = getattr(block.attn, proj).weight.grad
            if g is None or not g.abs().sum().item() > 0:
                fail(f"block {i} attn.{proj}.weight has no gradient: "
                     "flash_attention did not carry the gradient")
    # steps after the first (which also loads the kernel libraries)
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    images_per_s = 2 * args.batch / step_ms * 1e3
    print(f"[train] ViT-B/16 flash, batch {args.batch} (2 x {args.batch} "
          f"views), {TRAIN_STEPS} steps in {wall_s:.1f} s: losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{ {n: c // TRAIN_STEPS for n, c in launches.items()} }; "
          f"largest parameter change {moved:.3e}; every q/k/v weight has "
          f"a nonzero gradient", flush=True)
    print(f"[train] step {step_ms:.1f} ms (steps 2-{TRAIN_STEPS}, host clock "
          f"around a synchronizing loss read), {images_per_s:.1f} images/s, "
          f"peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {card_line}", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


def _parity_step(dtype: str, device: str, views) -> tuple[float, object]:
    """(loss, flat fp32 gradient) of one train step of ViT-B/16 in
    ``dtype`` from the weights of seed 0."""
    import torch

    from ntxent_tpu_torch.models import SimCLRModel, ViT_B16, init_weights
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_train_state,
        make_train_step,
    )

    tdt = getattr(torch, dtype)
    model = init_weights(
        SimCLRModel(ViT_B16(image_size=224, attention_impl="flash",
                            dtype=tdt), dtype=tdt),
        torch.Generator().manual_seed(0))
    cfg = TrainerConfig(batch_size=PARITY_BATCH, warmup_steps=1)
    state = create_train_state(model, cfg, torch.device(device))
    step = make_train_step(cfg.temperature, use_fused=True)
    _, metrics = step(state, *(v.to(device) for v in views))
    grads = torch.cat([p.grad.detach().float().cpu().flatten()
                       for p in state.model.parameters()])
    return metrics["loss"].item(), grads


def phase_step_parity() -> None:
    """One train step on the card vs the same step on the CPU (the
    kernels' plain versions): fp32 within fixed tolerances; the path's
    bf16 printed beside the CPU's own bf16-vs-fp32 gap (see PARITY_*)."""
    import torch

    rng = np.random.default_rng(0)
    views = [torch.from_numpy(rng.uniform(size=(
        PARITY_BATCH, 224, 224, 3)).astype(np.float32)) for _ in range(2)]
    steps, cpu_s = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.monotonic()
        steps[dtype, "cpu"] = _parity_step(dtype, "cpu", views)
        cpu_s[dtype] = time.monotonic() - t0
        steps[dtype, "cuda"] = _parity_step(dtype, "cuda", views)

    def gap(a, b):
        """(|loss_a - loss_b|, |g_a - g_b| / |g_b|)."""
        (loss_a, g_a), (loss_b, g_b) = steps[a], steps[b]
        return abs(loss_a - loss_b), ((g_a - g_b).norm() / g_b.norm()).item()

    noise = gap(("bfloat16", "cpu"), ("float32", "cpu"))
    print(f"[parity] bf16 rounding on the CPU (its bf16 step vs its fp32 "
          f"step): loss {noise[0]:.2e}, gradient {noise[1]:.2e}", flush=True)
    for dtype in ("float32", "bfloat16"):
        loss_err, grad_err = gap((dtype, "cuda"), (dtype, "cpu"))
        if dtype == "float32":
            ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
            verdict = (f"(atol {PARITY_LOSS_ATOL:.2e}, rtol "
                       f"{PARITY_GRAD_RTOL:.2e}) {'ok' if ok else 'MISMATCH'}")
        else:
            ok, verdict = True, "(a reading, not gated)"
        print(f"[parity] ViT-B/16 train step {dtype}, batch {PARITY_BATCH}: "
              f"loss card {steps[dtype, 'cuda'][0]:.6f} vs CPU "
              f"{steps[dtype, 'cpu'][0]:.6f} (|err| {loss_err:.2e}); "
              f"gradient |g_card - g_cpu| / |g_cpu| = {grad_err:.2e}; CPU "
              f"step {cpu_s[dtype]:.1f} s {verdict}", flush=True)
        if not ok:
            fail(f"the card's {dtype} train step disagrees with the CPU's")


def phase_clip_train(card_line: str) -> dict:
    """ntxent-train --objective clip on the card; returns the launches of
    each kernel."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(CLIP_ARGV)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    state, history = cli.train(args)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != CLIP_STEPS or not all(map(math.isfinite, losses)):
        fail(f"CLIP losses {losses}: expected {CLIP_STEPS} finite values")
    want = {n: CLIP_STEP_LAUNCHES.get(n, 0) * CLIP_STEPS for n in counters}
    if launches != want:
        fail(f"kernel launches over {CLIP_STEPS} CLIP steps {launches}, "
             f"expected {want}")
    model = state.model
    initial = cli.build_clip_model(args).state_dict()
    moved = max((p.detach().cpu() - initial[n]).abs().max().item()
                for n, p in model.named_parameters())
    if not moved > 0:
        fail("no CLIP parameter changed over the train steps")
    g = model.logit_scale.grad
    if g is None or not g.abs().item() > 0:
        fail("the logit scale has no gradient")
    for tower in ("image_tower", "text_tower"):
        for i, block in enumerate(getattr(model, tower).blocks):
            for proj in ("query", "key", "value"):
                g = getattr(block.attn, proj).weight.grad
                if g is None or not g.abs().sum().item() > 0:
                    fail(f"{tower} block {i} attn.{proj}.weight has no "
                         "gradient")
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    print(f"[clip] CLIP ViT-B/16 (text width 512, 12 blocks, 77 tokens) "
          f"flash, batch {args.batch} pairs, {CLIP_STEPS} steps in "
          f"{wall_s:.1f} s: losses {[round(x, 4) for x in losses]}; launches "
          f"per step { {n: c // CLIP_STEPS for n, c in launches.items()} }; "
          f"largest parameter change {moved:.3e}; logit-scale gradient "
          f"{model.logit_scale.grad.item():.3e}; every q/k/v weight of both "
          f"towers has a nonzero gradient", flush=True)
    print(f"[clip] step {step_ms:.1f} ms (steps 2-{CLIP_STEPS}, host clock "
          f"around a synchronizing loss read), "
          f"{args.batch / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) on "
          f"{card_line}", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return launches


def _clip_parity_step(model, device: str, images, tokens):
    """(loss, flat fp32 gradient) of one fp32 CLIP train step of a copy of
    ``model`` on ``device``."""
    import copy

    import torch

    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_clip_train_state,
        make_clip_train_step,
    )

    cfg = TrainerConfig(batch_size=CLIP_PARITY_BATCH, base_lr=5e-4,
                        warmup_steps=1)
    state = create_clip_train_state(copy.deepcopy(model), cfg,
                                    torch.device(device))
    step = make_clip_train_step(use_fused=True)
    _, metrics = step(state, images.to(device), tokens.to(device))
    grads = torch.cat([p.grad.detach().float().cpu().flatten()
                       for p in state.model.parameters()])
    return metrics["loss"].item(), grads


def phase_clip_parity() -> None:
    """One fp32 CLIP step on the card vs the same step on the CPU (the
    kernels' plain versions) from the same weights, images and tokens."""
    import torch

    from ntxent_tpu_torch.models import (
        CLIPModel,
        TextTransformer,
        ViT_B16,
        init_weights,
    )

    model = init_weights(
        CLIPModel(ViT_B16(image_size=224, attention_impl="flash",
                          dtype=torch.float32),
                  TextTransformer(dtype=torch.float32)),
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(size=(
        CLIP_PARITY_BATCH, 224, 224, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, 49408, (CLIP_PARITY_BATCH,
                                                      77)))
    t0 = time.monotonic()
    loss_cpu, g_cpu = _clip_parity_step(model, "cpu", images, tokens)
    cpu_s = time.monotonic() - t0
    loss_gpu, g_gpu = _clip_parity_step(model, "cuda", images, tokens)
    loss_err = abs(loss_gpu - loss_cpu)
    grad_err = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
    print(f"[clip-parity] CLIP ViT-B/16 train step float32, batch "
          f"{CLIP_PARITY_BATCH}: loss card {loss_gpu:.6f} vs CPU "
          f"{loss_cpu:.6f} (|err| {loss_err:.2e}, atol "
          f"{PARITY_LOSS_ATOL:.2e}); gradient |g_card - g_cpu| / |g_cpu| = "
          f"{grad_err:.2e} (rtol {PARITY_GRAD_RTOL:.2e}); CPU step "
          f"{cpu_s:.1f} s {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the card's fp32 CLIP train step disagrees with the CPU's")


def _general_ids(rows, cols, scattered, seed):
    """(row_gid, col_gid, cols_actual, n_half) on the card: the strip of
    rank 3 of 4 (ids: indices of the gathered columns; a padding row with
    the sentinel 2N when ``rows`` is odd), or, ``scattered``, columns with
    scattered global ids of a problem twice as wide (the ring's block)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if not scattered:
        n = rows // 2
        base = 3 * n + torch.arange(n) if rows < cols else torch.arange(n)
        ids = [base, cols // 2 + base] + ([torch.tensor([cols])]
                                          if rows % 2 else [])
        return torch.cat(ids).cuda(), None, cols, cols // 2
    total = 2 * cols
    col_gid = torch.randperm(total, generator=gen)[:cols]
    row_gid = torch.cat([col_gid[:rows // 2], torch.randperm(
        total, generator=gen)[:rows - rows // 2]])
    return row_gid.cuda(), col_gid.cuda(), total, total // 2


def _general_bounds(rows, cols, d):
    """Bounds of #1 general and of each #6 kernel at fp32 (R, C, D): each
    input read once (z_rows, z_cols, the row ids; the lse for #6), each
    output written once; 2 R C D and 4 R C D fp32 operations."""
    inputs = (rows + cols) * d * 4 + rows * 4
    return (_bound(inputs + rows * 4 + 4, 2 * rows * cols * d,
                   PEAK_FP32_FLOPS),
            _bound(inputs + rows * 4 + rows * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS),
            _bound(inputs + rows * 4 + cols * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS))


def phase_general_kernels() -> list[dict]:
    """#1 general, #6 rows and #6 cols against their plain versions, then
    times at every fp32 strip shape."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t = NTX_TEMPERATURE
    errs = {}
    for rows, cols, d in GENERAL_SHAPES:
        for dtype in ("float32", "bfloat16"):
            for scattered in (False, True):
                zr = _unit_rows(rows, d, dtype, seed=rows + d)
                zc = _unit_rows(cols, d, dtype, seed=cols + d)
                row_gid, col_gid, total, n_half = _general_ids(
                    rows, cols, scattered, seed=rows)
                kw = dict(col_gid=col_gid, cols_actual=total, n_half=n_half)
                args = (zr, zc, row_gid)
                loss, lse = N.ntxent_fwd_general(*args, t, **kw)
                g_rows = N.ntxent_bwd_general_rows(*args, lse, t, **kw)
                g_cols = N.ntxent_bwd_general_cols(*args, lse, t, **kw)
                loss_ref, lse_ref = N.ntxent_fwd_general_plain(*args, t, **kw)
                g_rows_ref = N.ntxent_bwd_general_rows_plain(
                    *args, lse_ref, t, **kw)
                g_cols_ref = N.ntxent_bwd_general_cols_plain(
                    *args, lse_ref, t, **kw)
                again, _ = N.ntxent_fwd_general(*args, t, **kw)
                torch.cuda.synchronize()
                fwd_err = max((lse - lse_ref).abs().max().item(),
                              abs(loss.item() - loss_ref.item()) / rows)
                rows_err = (g_rows - g_rows_ref).abs().max().item()
                cols_err = (g_cols - g_cols_ref).abs().max().item()
                repeat = again.item() == loss.item()
                ok = (max(fwd_err, rows_err, cols_err) <= NTX_ATOL
                      and repeat)
                print(f"[general] R={rows} C={cols} D={d} {dtype} "
                      f"{'scattered column ids' if scattered else 'strip'}: "
                      f"fwd max|err| {fwd_err:.3e}, rows {rows_err:.3e}, "
                      f"cols {cols_err:.3e} (atol {NTX_ATOL:g}), loss "
                      f"bitwise repeatable {repeat} "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"the general NT-Xent kernels disagree with their "
                         f"plain versions at R={rows} C={cols} D={d} "
                         f"{dtype} (scattered ids: {scattered})")
                if (rows, cols, dtype, scattered) == (512, 512, "float32",
                                                      False):
                    errs = {"ntxent_fwd_general": fwd_err,
                            "ntxent_bwd_general_rows": rows_err,
                            "ntxent_bwd_general_cols": cols_err}
                del zr, zc, g_rows, g_cols, g_rows_ref, g_cols_ref

    times = {}
    for rows, cols, d in GENERAL_SHAPES[:3]:
        zr = _unit_rows(rows, d, "float32", seed=1)
        zc = _unit_rows(cols, d, "float32", seed=2)
        row_gid = _general_ids(rows, cols, False, seed=0)[0]
        args = (zr, zc, row_gid)
        _, lse = N.ntxent_fwd_general(*args, t)
        runs = 3 if cols > 4096 else 10
        ms = (cuda_time_ms(lambda: N.ntxent_fwd_general(*args, t), runs),
              cuda_time_ms(lambda: N.ntxent_bwd_general_rows(*args, lse, t),
                           runs),
              cuda_time_ms(lambda: N.ntxent_bwd_general_cols(*args, lse, t),
                           runs))
        plain = (
            cuda_time_ms(lambda: N.ntxent_fwd_general_plain(*args, t), runs),
            cuda_time_ms(lambda: N.ntxent_bwd_general_rows_plain(
                *args, lse, t), runs),
            cuda_time_ms(lambda: N.ntxent_bwd_general_cols_plain(
                *args, lse, t), runs))
        bounds = _general_bounds(rows, cols, d)
        print(f"[general] R={rows} C={cols} D={d} fp32: fwd {ms[0]:.4f} ms "
              f"(plain {plain[0]:.4f}, bound {bounds[0][0]:.5f}), rows "
              f"{ms[1]:.4f} ms (plain {plain[1]:.4f}, bound "
              f"{bounds[1][0]:.5f}), cols {ms[2]:.4f} ms (plain "
              f"{plain[2]:.4f}, bound {bounds[2][0]:.5f}); no single PyTorch "
              f"call computes them, so there is no library time", flush=True)
        times[rows, cols] = (ms, plain, bounds)
        del zr, zc
    names = ("ntxent_fwd_general", "ntxent_bwd_general_rows",
             "ntxent_bwd_general_cols")
    replaces = (
        "ntxent_tpu/ops/ntxent_pallas.py:130 (_fwd_kernel in its general "
        "mode, _fwd_call :190)",
        "ntxent_tpu/ops/ntxent_pallas.py:552 (_bwd_rows_kernel, "
        "_bwd_general_call :648)",
        "ntxent_tpu/ops/ntxent_pallas.py:580 (_bwd_cols_kernel, "
        "_bwd_general_call :648)")
    sources = ("ntxent_tpu_torch/csrc/ntxent_fwd.cu",
               "ntxent_tpu_torch/csrc/ntxent_bwd_general.cu",
               "ntxent_tpu_torch/csrc/ntxent_bwd_general.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds = times[512, 512]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True, "launches": None,
                 "max_abs_err": errs[name], "ms": ms[i],
                 "plain_ms": plain[i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "library_ms": None}
        for (rows, cols), tag in (((128, 512), "rank4"),
                                  ((2048, 8192), "rank4_b4096")):
            ms, plain, bounds = times[rows, cols]
            entry |= {f"{tag}_ms": ms[i], f"{tag}_plain_ms": plain[i],
                      f"{tag}_bound_ms": bounds[i][0]}
        out.append(entry)
    return out


def phase_emulated_ranks() -> None:
    """P = 4 ranks one after another on the card: each rank's strip loss
    and its row and column gradients from the kernels; the losses summed,
    the column gradients summed and the row gradients scattered (what the
    all-gather's reduce-scatter and the psum do), against the single-card
    ntxent_fwd / ntxent_bwd_sym on the same 2N rows."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    t, p, batch, d = NTX_TEMPERATURE, EMULATED_RANKS, EMULATED_BATCH, 128
    z = _unit_rows(2 * batch, d, "float32", seed=7)   # [view 1; view 2]
    n = batch // p
    loss, grad = 0.0, torch.zeros_like(z)
    for rank in range(p):
        gid = local_row_gids(rank, n, p, z.device)
        z_local = z[gid.long()]
        loss_r, lse_r = N.ntxent_fwd_general(z_local, z, gid, t)
        grad.index_add_(0, gid.long(),
                        N.ntxent_bwd_general_rows(z_local, z, gid, lse_r, t))
        grad += N.ntxent_bwd_general_cols(z_local, z, gid, lse_r, t)
        loss = loss + loss_r
    loss_sym, lse = N.ntxent_fwd(z, t)
    grad_sym = N.ntxent_bwd_sym(z, lse, t)
    torch.cuda.synchronize()
    loss_err = abs(loss.item() - loss_sym.item()) / (2 * batch)
    grad_err = ((grad - grad_sym).norm() / grad_sym.norm()).item()
    ok = loss_err <= EMULATED_LOSS_ATOL and grad_err <= EMULATED_GRAD_RTOL
    print(f"[ranks] {p} ranks emulated at global batch {batch} (2N = "
          f"{2 * batch}, D = {d}): sum of strip losses / 2N "
          f"{loss.item() / (2 * batch):.6f} vs single card "
          f"{loss_sym.item() / (2 * batch):.6f} (|err| {loss_err:.2e}, atol "
          f"{EMULATED_LOSS_ATOL:g}); gradient |g_ranks - g_card| / |g_card| "
          f"= {grad_err:.2e} (rtol {EMULATED_GRAD_RTOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the emulated ranks' strip losses do not sum to the single-card "
             "loss and gradient")


def phase_dp_train(card_line: str, argv=DP_ARGV,
                   step_launches=DP_STEP_LAUNCHES, tag: str = "dp") -> dict:
    """Data-parallel ResNet-50 SimCLR through ntxent_tpu_torch.cli over
    the NCCL group of world 1 (``argv``: the strip loss, or with
    ``--dp-loss pair`` the pair loss); returns the launches of each
    kernel."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.models import BatchNorm
    from ntxent_tpu_torch.models.resnet import Conv
    from ntxent_tpu_torch.parallel import mesh
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(argv)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    mark = mesh.comms_accounting().totals()
    t0 = time.monotonic()
    state, history = cli.train(args, data_parallel=True)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    comms = mesh.comms_accounting().delta(mark)
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != DP_STEPS or not all(map(math.isfinite, losses)):
        fail(f"data-parallel losses {losses}: expected {DP_STEPS} finite "
             "values")
    want = {n: step_launches.get(n, 0) * DP_STEPS for n in counters}
    if launches != want:
        fail(f"kernel launches over {DP_STEPS} data-parallel steps "
             f"{launches}, expected {want}")
    weights = [(n, m.weight) for n, m in state.model.named_modules()
               if isinstance(m, (Conv, BatchNorm))]
    for name, w in weights:
        if w.grad is None or not w.grad.abs().sum().item() > 0:
            fail(f"{name}.weight has no gradient in the data-parallel step")
    convs = sum(isinstance(m, Conv) for m in state.model.modules())
    norms = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    images_per_s = 2 * args.batch / step_ms * 1e3
    print(f"[{tag}] ResNet-50 SimCLR data-parallel over NCCL (world 1), "
          f"--dp-loss {args.dp_loss}, batch "
          f"{args.batch} (2 x {args.batch} views at 224 px), {DP_STEPS} "
          f"steps in {wall_s:.1f} s: losses {[round(x, 4) for x in losses]}; "
          f"launches per step "
          f"{ {n: c // DP_STEPS for n, c in launches.items() if c} } (every "
          f"other kernel 0); all {convs} convolutions and {norms} BatchNorms "
          f"have a nonzero weight gradient; comms over the run (calls, "
          f"bytes per device; 0 at world 1) "
          f"{ {op: c for (op, _), c in comms.items()} }", flush=True)
    print(f"[{tag}] step {step_ms:.1f} ms (steps 2-{DP_STEPS}, host clock "
          f"around a synchronizing loss read), {images_per_s:.1f} images/s, "
          f"peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {card_line}", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches


def _dp_parity_step(sharded: bool, views, loss_impl: str = "strip"):
    """(loss, flat fp32 gradient) of one fp32 ResNet-50 step from the
    weights of seed 0: the data-parallel step at world 1 (with the
    ``loss_impl`` schedule) or the single-card step."""
    import torch

    from ntxent_tpu_torch.models import (
        ResNet50,
        SimCLRModel,
        cross_replica_batch_norm,
        init_weights,
    )
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_train_state,
        make_sharded_train_step,
        make_train_step,
    )

    model = init_weights(SimCLRModel(ResNet50(dtype=torch.float32),
                                     dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    cfg = TrainerConfig(batch_size=DP_PARITY_BATCH, warmup_steps=1)
    if sharded:
        cross_replica_batch_norm(model, torch.distributed.group.WORLD)
        step = make_sharded_train_step(None, cfg.temperature,
                                       loss_impl=loss_impl)
    else:
        step = make_train_step(cfg.temperature, use_fused=True)
    state = create_train_state(model, cfg, torch.device("cuda"))
    _, metrics = step(state, *(v.cuda() for v in views))
    grads = torch.cat([p.grad.detach().float().cpu().flatten()
                       for p in state.model.parameters()])
    return metrics["loss"].item(), grads


def phase_dp_parity() -> None:
    """The world-1 data-parallel step against the single-card step, and
    the world-1 pair step against the world-1 strip step: fp32 ResNet-50,
    same weights and views, TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    views = [torch.from_numpy(rng.uniform(size=(
        DP_PARITY_BATCH, 224, 224, 3)).astype(np.float32)) for _ in range(2)]
    loss_dp, g_dp = _dp_parity_step(True, views)
    loss_one, g_one = _dp_parity_step(False, views)
    loss_pair, g_pair = _dp_parity_step(True, views, loss_impl="pair")
    for tag, (loss_a, g_a), (loss_b, g_b), what in (
            ("dp-parity", (loss_dp, g_dp), (loss_one, g_one),
             "data-parallel (world 1) vs single card"),
            ("dp-pair-parity", (loss_pair, g_pair), (loss_dp, g_dp),
             "pair (world 1) vs strip (world 1)")):
        loss_err = abs(loss_a - loss_b)
        grad_err = ((g_a - g_b).norm() / g_b.norm()).item()
        ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
        print(f"[{tag}] ResNet-50 train step float32, batch "
              f"{DP_PARITY_BATCH}: loss {what} {loss_a:.6f} vs {loss_b:.6f} "
              f"(|err| {loss_err:.2e}, atol {PARITY_LOSS_ATOL:.2e}); "
              f"relative gradient error {grad_err:.2e} (rtol "
              f"{PARITY_GRAD_RTOL:.2e}) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"the ResNet-50 steps disagree: {what}")


def _dp_clip_ids(rows: int, cols: int, seed: int):
    """Global row ids on the card: the rows of rank cols / rows - 1 where
    rows divide cols (rank 0 of a world of one at rows == cols), else
    scattered ids with a padding row (id = cols) last."""
    import torch

    if cols % rows == 0:
        first = cols - rows
        return (first + torch.arange(rows, dtype=torch.int32)).cuda()
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randperm(cols, generator=gen)[:rows].to(torch.int32)
    ids[-1] = cols
    return ids.cuda()


def _dp_clip_loss(za, zb, gid, scale, lse_a, lse_b):
    """The partial loss sum of the rows from the lse, as
    ``info_nce_dual_partial`` assembles it (a padding row's id clamped)."""
    import torch

    idx = gid.long().clamp(max=zb.shape[0] - 1)
    pos = scale * torch.sum(za.float() * zb.float()[idx], dim=1)
    return torch.sum(lse_a - pos) + torch.sum(lse_b[idx] - pos)


def _dp_clip_bounds(rows: int, cols: int, d: int, itemsize: int):
    """Bounds of #9 rectangular, #5 cross-modal and #4 at (rows, cols, D):
    each input read once (za, zb, the scale; the row ids and both lse for
    the backward), each output written once; 2 R C D and 4 R C D
    operations at the fp32 peak (bf16 inputs are widened to fp32)."""
    z = (rows + cols) * d * itemsize + 4
    lse = (rows + cols) * 4
    return (_bound(z + lse, 2 * rows * cols * d, PEAK_FP32_FLOPS),
            _bound(z + rows * 4 + lse + rows * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS),
            _bound(z + rows * 4 + lse + cols * d * 4, 4 * rows * cols * d,
                   PEAK_FP32_FLOPS))


def phase_dp_clip_kernels() -> tuple[list[dict], float]:
    """#9 rectangular, #5 cross-modal and #4 against their plain versions,
    then times at every fp32 shape but the ragged one; and the symmetric
    #1 re-timed in the same call. Returns the kernel entries and the
    symmetric #1's ms."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I
    from ntxent_tpu_torch.ops import ntxent
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    scale = torch.tensor(DP_CLIP_SCALE, dtype=torch.float32, device="cuda")
    errs = {}
    for rows, cols, d in DP_CLIP_SHAPES:
        gid = _dp_clip_ids(rows, cols, seed=rows)
        for dtype in ("float32", "bfloat16"):
            za = _unit_rows(rows, d, dtype, seed=rows + d)
            zb = _unit_rows(cols, d, dtype, seed=cols + d + 1)

            def run():
                lse_a, lse_b = I.infonce_dual_fwd_rect(za, zb, scale)
                return (lse_a, lse_b,
                        I.infonce_bwd_rows(za, zb, gid, scale, lse_a, lse_b),
                        I.infonce_bwd_cols(za, zb, gid, scale, lse_a, lse_b),
                        _dp_clip_loss(za, zb, gid, scale, lse_a, lse_b))

            got, again = run(), run()
            lse_a, lse_b, o_a, o_b, loss = got
            ref = I.infonce_dual_fwd_rect_plain(za, zb, scale)
            ref_oa = I.infonce_bwd_rows_plain(za, zb, gid, scale, lse_a,
                                              lse_b)
            ref_ob = I.infonce_bwd_cols_plain(za, zb, gid, scale, lse_a,
                                              lse_b)
            torch.cuda.synchronize()
            fwd_err = max((lse_a - ref[0]).abs().max().item(),
                          (lse_b - ref[1]).abs().max().item())
            rows_err = (o_a - ref_oa).abs().max().item()
            cols_err = (o_b - ref_ob).abs().max().item()
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = (max(fwd_err, rows_err, cols_err) <= INFONCE_ATOL
                  and repeat and bool(torch.isfinite(loss)))
            print(f"[dp-clip-kernel] R={rows} C={cols} D={d} {dtype}: rect "
                  f"fwd max|err| {fwd_err:.3e}, #5 rows {rows_err:.3e}, #4 "
                  f"cols {cols_err:.3e} (atol {INFONCE_ATOL:g}); lse, o_a, "
                  f"o_b and the loss bitwise repeatable {repeat} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the data-parallel InfoNCE kernels disagree with "
                     f"their plain versions at R={rows} C={cols} D={d} "
                     f"{dtype}")
            if (rows, cols, dtype) == (256, 256, "float32"):
                errs = {"infonce_dual_fwd_rect": fwd_err,
                        "infonce_bwd_rows": rows_err,
                        "infonce_bwd_cols": cols_err}
            del za, zb, got, again, ref_oa, ref_ob

    times = {}
    for rows, cols, d in DP_CLIP_SHAPES[:3]:
        za = _unit_rows(rows, d, "float32", seed=1)
        zb = _unit_rows(cols, d, "float32", seed=2)
        gid = _dp_clip_ids(rows, cols, seed=0)
        lse_a, lse_b = I.infonce_dual_fwd_rect(za, zb, scale)
        args = (za, zb, gid, scale, lse_a, lse_b)
        ms = (cuda_time_ms(lambda: I.infonce_dual_fwd_rect(za, zb, scale)),
              cuda_time_ms(lambda: I.infonce_bwd_rows(*args)),
              cuda_time_ms(lambda: I.infonce_bwd_cols(*args)))
        plain = (cuda_time_ms(
            lambda: I.infonce_dual_fwd_rect_plain(za, zb, scale)),
            cuda_time_ms(lambda: I.infonce_bwd_rows_plain(*args)),
            cuda_time_ms(lambda: I.infonce_bwd_cols_plain(*args)))
        bounds = _dp_clip_bounds(rows, cols, d, 4)
        print(f"[dp-clip-kernel] R={rows} C={cols} D={d} fp32: rect fwd "
              f"{ms[0]:.4f} ms (plain {plain[0]:.4f}, bound "
              f"{bounds[0][0]:.5f} by {bounds[0][1]}), #5 rows {ms[1]:.4f} "
              f"ms (plain {plain[1]:.4f}, bound {bounds[1][0]:.5f} by "
              f"{bounds[1][1]}), #4 cols {ms[2]:.4f} ms (plain "
              f"{plain[2]:.4f}, bound {bounds[2][0]:.5f} by "
              f"{bounds[2][1]}); no single PyTorch call computes them, so "
              f"there is no library time", flush=True)
        times[rows, cols] = (ms, plain, bounds)
        del za, zb, args

    z = _unit_rows(*NTX_SHAPES[0], "float32", seed=0)
    sym_ms = cuda_time_ms(lambda: ntxent.ntxent_fwd(z, NTX_TEMPERATURE),
                          runs=SYM_RETIME_RUNS, warmup=20)
    print(f"[dp-clip-kernel] symmetric ntxent_fwd re-timed at 2N="
          f"{NTX_SHAPES[0][0]}, D={NTX_SHAPES[0][1]} fp32 over "
          f"{SYM_RETIME_RUNS} launches: {sym_ms:.4f} ms", flush=True)

    names = ("infonce_dual_fwd_rect", "infonce_bwd_rows", "infonce_bwd_cols")
    replaces = (
        "ntxent_tpu/ops/infonce_pallas.py:75 (_dual_fwd_kernel in its "
        "rectangular stats_only mode, _dual_fwd_call :165)",
        "ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel in its "
        "cross-modal mode, _bwd_sym_call :612)",
        "ntxent_tpu/ops/ntxent_pallas.py:479 (_bwd_sym_cols_kernel, "
        "_bwd_sym_cols_call :516)")
    sources = ("ntxent_tpu_torch/csrc/infonce_dual_fwd.cu",
               "ntxent_tpu_torch/csrc/infonce_dual_bwd.cu",
               "ntxent_tpu_torch/csrc/infonce_bwd_cols.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds = times[256, 256]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True, "launches": None,
                 "max_abs_err": errs[name], "ms": ms[i],
                 "plain_ms": plain[i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "library_ms": None}
        for (rows, cols), tag in (((64, 256), "rank4"),
                                  ((1024, 4096), "rank4_b4096")):
            ms, plain, bounds = times[rows, cols]
            entry |= {f"{tag}_ms": ms[i], f"{tag}_plain_ms": plain[i],
                      f"{tag}_bound_ms": bounds[i][0]}
        out.append(entry)
    return out, sym_ms


def phase_dp_clip_emulated_ranks() -> None:
    """P = 4 ranks of global batch 256 (D = 512) one after another on the
    card: each rank's rectangular forward, the column lse merged by hand
    (max, then log-sum-exp), each rank's rows and columns gradients; the
    partial losses summed, the za rows concatenated, the zb partials and
    the scale's shares summed, against the single-card info_nce_fused
    loss and its gradients."""
    import torch

    from ntxent_tpu_torch.ops import infonce as I

    p, batch, d = EMULATED_RANKS, EMULATED_BATCH, 512
    za = _unit_rows(batch, d, "float32", seed=11)
    zb = _unit_rows(batch, d, "float32", seed=12)
    scale = torch.tensor(DP_CLIP_SCALE, dtype=torch.float32, device="cuda")
    n = batch // p
    parts = []
    for rank in range(p):
        gid = rank * n + torch.arange(n, dtype=torch.int32, device="cuda")
        za_r = za[rank * n:(rank + 1) * n]
        parts.append((za_r, gid, *I.infonce_dual_fwd_rect(za_r, zb, scale)))
    stacked = torch.stack([lse_b for *_, lse_b in parts])
    m = stacked.amax(dim=0)
    lse_b = m + torch.log(torch.exp(stacked - m).sum(dim=0))
    loss = 0.0
    g_za, g_zb, g_scale = [], torch.zeros_like(zb), 0.0
    coef = 1.0 / (2 * batch)
    for za_r, gid, lse_a, _ in parts:
        loss = loss + _dp_clip_loss(za_r, zb, gid, scale, lse_a, lse_b)
        o_a = I.infonce_bwd_rows(za_r, zb, gid, scale, lse_a, lse_b)
        g_za.append(o_a * coef * scale)
        g_zb += I.infonce_bwd_cols(za_r, zb, gid, scale, lse_a, lse_b) \
            * coef * scale
        g_scale = g_scale + coef * torch.sum(o_a * za_r)
    a, b, s = (t.clone().requires_grad_() for t in (za, zb, scale))
    ref = I.info_nce_fused(a, b, scale=s)
    ref.backward()
    torch.cuda.synchronize()
    loss_err = abs(loss.item() * coef - ref.item())
    grad_errs = [((got - want).norm() / want.norm()).item()
                 for got, want in ((torch.cat(g_za), a.grad), (g_zb, b.grad),
                                   (g_scale, s.grad))]
    ok = loss_err <= DP_CLIP_LOSS_ATOL and max(grad_errs) <= DP_CLIP_GRAD_RTOL
    print(f"[dp-clip-ranks] {p} ranks emulated at global batch {batch} "
          f"(D = {d}): merged partial losses / 2N {loss.item() * coef:.6f} "
          f"vs single card {ref.item():.6f} (|err| {loss_err:.2e}, atol "
          f"{DP_CLIP_LOSS_ATOL:g}); relative gradient errors za "
          f"{grad_errs[0]:.2e}, zb {grad_errs[1]:.2e}, scale "
          f"{grad_errs[2]:.2e} (rtol {DP_CLIP_GRAD_RTOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the emulated ranks' partial InfoNCE losses do not sum to the "
             "single-card loss and gradients")


def phase_clip_dp_train(card_line: str) -> dict:
    """Data-parallel CLIP ViT-B/16 through ntxent_tpu_torch.cli over the
    NCCL group of world 1; returns the launches of each kernel."""
    import math

    import torch

    from ntxent_tpu_torch import cli
    from ntxent_tpu_torch.parallel import mesh
    from ntxent_tpu_torch.utils.profiling import launch_counters

    args = cli.build_train_parser().parse_args(CLIP_DP_ARGV)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    mark = mesh.comms_accounting().totals()
    t0 = time.monotonic()
    state, history = cli.train(args, data_parallel=True)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = {name: w.launches for name, w in counters.items()}
    comms = mesh.comms_accounting().delta(mark)
    peak = torch.cuda.max_memory_allocated()

    losses = [h["loss"] for h in history]
    if len(losses) != CLIP_DP_STEPS or not all(map(math.isfinite, losses)):
        fail(f"data-parallel CLIP losses {losses}: expected {CLIP_DP_STEPS} "
             "finite values")
    want = {n: CLIP_DP_STEP_LAUNCHES.get(n, 0) * CLIP_DP_STEPS
            for n in counters}
    if launches != want:
        fail(f"kernel launches over {CLIP_DP_STEPS} data-parallel CLIP "
             f"steps {launches}, expected {want}")
    model = state.model
    g = model.logit_scale.grad
    if g is None or not g.abs().item() > 0:
        fail("the logit scale has no gradient in the data-parallel step")
    for tower in ("image_tower", "text_tower"):
        for i, block in enumerate(getattr(model, tower).blocks):
            for proj in ("query", "key", "value"):
                g = getattr(block.attn, proj).weight.grad
                if g is None or not g.abs().sum().item() > 0:
                    fail(f"{tower} block {i} attn.{proj}.weight has no "
                         "gradient in the data-parallel step")
    steady = history[1:]
    step_ms = 1e3 * sum(1.0 / h["steps_per_sec"]
                        for h in steady) / len(steady)
    print(f"[clip-dp] CLIP ViT-B/16 data-parallel over NCCL (world 1), "
          f"batch {args.batch} pairs, {CLIP_DP_STEPS} steps in {wall_s:.1f} "
          f"s: losses {[round(x, 4) for x in losses]}; launches per step "
          f"{ {n: c // CLIP_DP_STEPS for n, c in launches.items() if c} } "
          f"(every other kernel 0); logit-scale gradient "
          f"{model.logit_scale.grad.item():.3e}; every q/k/v weight of both "
          f"towers has a nonzero gradient; comms over the run (calls, bytes "
          f"per device; 0 at world 1) "
          f"{ {op: c for (op, _), c in comms.items()} }", flush=True)
    print(f"[clip-dp] step {step_ms:.1f} ms (steps 2-{CLIP_DP_STEPS}, host "
          f"clock around a synchronizing loss read), "
          f"{args.batch / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) on "
          f"{card_line}", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return launches


def phase_clip_dp_parity() -> None:
    """The world-1 data-parallel CLIP step against the single-card CLIP
    step, fp32 CLIP ViT-B/16, same weights, images and tokens, TF32 off."""
    import copy

    import torch

    from ntxent_tpu_torch.models import (
        CLIPModel,
        TextTransformer,
        ViT_B16,
        init_weights,
    )
    from ntxent_tpu_torch.training import (
        TrainerConfig,
        create_clip_train_state,
        make_clip_train_step,
        make_sharded_clip_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = init_weights(
        CLIPModel(ViT_B16(image_size=224, attention_impl="flash",
                          dtype=torch.float32),
                  TextTransformer(dtype=torch.float32)),
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(size=(
        CLIP_PARITY_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.integers(1, 49408, (CLIP_PARITY_BATCH,
                                                      77))).cuda()
    cfg = TrainerConfig(batch_size=CLIP_PARITY_BATCH, base_lr=5e-4,
                        warmup_steps=1)
    results = []
    for step in (make_sharded_clip_train_step(None),
                 make_clip_train_step(use_fused=True)):
        state = create_clip_train_state(copy.deepcopy(model), cfg,
                                        torch.device("cuda"))
        _, metrics = step(state, images, tokens)
        results.append((metrics["loss"].item(), torch.cat(
            [p.grad.detach().float().cpu().flatten()
             for p in state.model.parameters()])))
        del state
    (loss_dp, g_dp), (loss_one, g_one) = results
    loss_err = abs(loss_dp - loss_one)
    grad_err = ((g_dp - g_one).norm() / g_one.norm()).item()
    ok = loss_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
    print(f"[clip-dp-parity] CLIP ViT-B/16 train step float32, batch "
          f"{CLIP_PARITY_BATCH}: loss data-parallel (world 1) {loss_dp:.6f} "
          f"vs single card {loss_one:.6f} (|err| {loss_err:.2e}, atol "
          f"{PARITY_LOSS_ATOL:.2e}); gradient |g_dp - g_card| / |g_card| = "
          f"{grad_err:.2e} (rtol {PARITY_GRAD_RTOL:.2e}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the data-parallel CLIP step at world 1 disagrees with the "
             "single-card CLIP step")


def _pair_ids(rows: int, cols: int, world, seed: int):
    """(row ids, column ids, total) on the card: rank 0's rows against
    shard (1 mod world)'s columns of a world of ``world`` (the self tile
    at world 1, the k = 1 tile beyond), or, for ``world`` None, scattered
    ids out of 4 (rows + cols) with 20 shared by rows and columns, two
    sentinel rows and three sentinel columns."""
    import torch

    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    if world is not None:
        n = rows // 2
        rid = local_row_gids(0, n, world)
        cid = local_row_gids(1 % world, n, world)
        return rid.cuda(), cid.cuda(), rows * world
    total = 4 * (rows + cols)
    perm = torch.randperm(total, generator=torch.Generator().manual_seed(
        seed)).to(torch.int32)
    rid = perm[:rows].clone()
    cid = torch.cat([perm[rows - 20:rows], perm[rows:rows + cols - 20]])
    rid[[3, 50]] = total
    cid[[7, 8, 200]] = total
    return rid.cuda(), cid.cuda(), total


def _pair_bounds(rows: int, cols: int, d: int, itemsize: int):
    """Bounds of #7 and #8 at (R, C, D): each input read once (z_rows,
    z_cols, both ids; both lse for #8), each output written once (both
    lse; both fp32 gradients for #8); 2 R C D and 6 R C D operations at
    the fp32 peak (bf16 inputs are widened to fp32)."""
    z = (rows + cols) * d * itemsize
    ids = lse = (rows + cols) * 4
    return (_bound(z + ids + lse, 2 * rows * cols * d, PEAK_FP32_FLOPS),
            _bound(z + ids + lse + (rows + cols) * d * 4,
                   6 * rows * cols * d, PEAK_FP32_FLOPS))


def phase_pair_kernels() -> list[dict]:
    """#7 and #8 against their plain versions at every shape and dtype,
    each bitwise repeatable, then times at the fp32 shapes."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    t = NTX_TEMPERATURE
    errs = {}
    for rows, cols, d, world in PAIR_CASES:
        rid, cid, total = _pair_ids(rows, cols, world, seed=rows)
        for dtype in ("float32", "bfloat16"):
            zr = _unit_rows(rows, d, dtype, seed=rows + d)
            zc = _unit_rows(cols, d, dtype, seed=cols + d + 3)
            args = (zr, zc, rid, cid)
            lse_r, lse_c = N.block_lse_dual_plain(*args, t, total)

            def run():
                return (*N.block_lse_dual(*args, t, total),
                        *N.block_grads_dual(*args, lse_r, lse_c, t, total))

            got, again = run(), run()
            ref = (lse_r, lse_c,
                   *N.block_grads_dual_plain(*args, lse_r, lse_c, t, total))
            torch.cuda.synchronize()
            stats_err = max((got[i] - ref[i]).abs().max().item()
                            for i in (0, 1))
            grads_err = max((got[i] - ref[i]).abs().max().item()
                            for i in (2, 3))
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = max(stats_err, grads_err) <= NTX_ATOL and repeat
            print(f"[pair-kernel] R={rows} C={cols} D={d} {dtype} (total "
                  f"{total}): block_lse_dual max|err| {stats_err:.3e}, "
                  f"block_grads_dual {grads_err:.3e} (atol {NTX_ATOL:g}); "
                  f"both lse and both gradients bitwise repeatable "
                  f"{repeat} {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the shard-pair kernels disagree with their plain "
                     f"versions at R={rows} C={cols} D={d} {dtype}")
            if (rows, dtype) == (512, "float32"):
                errs = {"block_lse_dual": stats_err,
                        "block_grads_dual": grads_err}
            del zr, zc, got, again, ref

    times = {}
    for rows, cols, d, world in PAIR_CASES[:3]:
        rid, cid, total = _pair_ids(rows, cols, world, seed=0)
        args = (_unit_rows(rows, d, "float32", seed=1),
                _unit_rows(cols, d, "float32", seed=2), rid, cid)
        lse_r, lse_c = N.block_lse_dual(*args, t, total)
        runs = 3 if rows > 1024 else 10
        ms = (cuda_time_ms(lambda: N.block_lse_dual(*args, t, total), runs),
              cuda_time_ms(lambda: N.block_grads_dual(
                  *args, lse_r, lse_c, t, total), runs))
        plain = (cuda_time_ms(lambda: N.block_lse_dual_plain(
            *args, t, total), runs),
            cuda_time_ms(lambda: N.block_grads_dual_plain(
                *args, lse_r, lse_c, t, total), runs))
        bounds = _pair_bounds(rows, cols, d, 4)
        print(f"[pair-kernel] R={rows} C={cols} D={d} fp32: block_lse_dual "
              f"{ms[0]:.4f} ms (plain {plain[0]:.4f}, bound "
              f"{bounds[0][0]:.5f} by {bounds[0][1]}), block_grads_dual "
              f"{ms[1]:.4f} ms (plain {plain[1]:.4f}, bound "
              f"{bounds[1][0]:.5f} by {bounds[1][1]}); no single PyTorch "
              f"call computes them, so there is no library time",
              flush=True)
        times[rows] = (ms, plain, bounds)
        del args
    names = ("block_lse_dual", "block_grads_dual")
    replaces = (
        "ntxent_tpu/ops/ntxent_pallas.py:1037 (_dual_stats_kernel, "
        "block_lse_dual :1094)",
        "ntxent_tpu/ops/ntxent_pallas.py:1159 (_dual_grads_kernel, "
        "block_grads_dual :1213)")
    sources = ("ntxent_tpu_torch/csrc/ntxent_dual_stats.cu",
               "ntxent_tpu_torch/csrc/ntxent_dual_grads.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds = times[512]
        entry = {"name": name, "route": "cuda", "source": sources[i],
                 "replaces": replaces[i], "checked": True, "launches": None,
                 "max_abs_err": errs[name], "ms": ms[i],
                 "plain_ms": plain[i], "bound_ms": bounds[i][0],
                 "bound_by": bounds[i][1], "library_ms": None}
        for rows, tag in ((128, "rank4"), (2048, "rank4_b4096")):
            ms, plain, bounds = times[rows]
            entry |= {f"{tag}_ms": ms[i], f"{tag}_plain_ms": plain[i],
                      f"{tag}_bound_ms": bounds[i][0]}
        out.append(entry)
    return out


def phase_pair_emulated_ranks() -> None:
    """P = 2, 3, 4, 8 pair ranks one after another on the card, through
    the pair loss's own per-rank functions (``parallel.pair``): each
    rank's lse shares, merged over ranks as the pmax and psum do, and each
    rank's gradient buffer, summed as the psum does; the positives added
    by hand; against the single-card ntxent_fwd / ntxent_bwd_sym."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel import pair
    from ntxent_tpu_torch.parallel.mesh import local_row_gids

    t, d = NTX_TEMPERATURE, 128
    for p in PAIR_WORLDS:
        batch = EMULATED_BATCH - EMULATED_BATCH % p
        two_n, n = 2 * batch, batch // p
        z = _unit_rows(two_n, d, "float32", seed=17 + p)  # [view 1; view 2]
        gids = [local_row_gids(r, n, p, z.device) for r in range(p)]
        z_g = torch.cat([z[g.long()] for g in gids])  # the all-gather
        shares = torch.stack([
            pair.rank_lse_part(z[g.long()], g, z_g, r, p, t)
            for r, g in enumerate(gids)])
        m = shares.amax(dim=0)                                 # pmax
        lse = m + torch.log(torch.exp(shares - m).sum(dim=0))  # psum
        buf = sum(pair.rank_grad_buffer(z[g.long()], g, z_g, r, p, lse, t)
                  for r, g in enumerate(gids))                 # psum
        rows = torch.arange(two_n, device=z.device)
        pos = (rows + batch) % two_n
        pos_logits = (z * z[pos]).sum(dim=1) * (1.0 / t)
        loss = (lse - pos_logits).sum() / two_n
        grad = buf - 2.0 * z[pos]  # d(-positives)/dz times T
        loss_sym, lse_sym = N.ntxent_fwd(z, t)
        grad_sym = N.ntxent_bwd_sym(z, lse_sym, t)
        torch.cuda.synchronize()
        loss_err = abs(loss.item() - loss_sym.item() / two_n)
        grad_err = ((grad - grad_sym).norm() / grad_sym.norm()).item()
        ok = loss_err <= EMULATED_LOSS_ATOL and grad_err <= EMULATED_GRAD_RTOL
        print(f"[pair-ranks] P = {p} pair ranks emulated at global batch "
              f"{batch} (2N = {two_n}, D = {d}, {len(pair._tile_schedule(p))}"
              f" tiles a rank): merged loss {loss.item():.6f} vs single card "
              f"{loss_sym.item() / two_n:.6f} (|err| {loss_err:.2e}, atol "
              f"{EMULATED_LOSS_ATOL:g}); gradient |g_ranks - g_card| / "
              f"|g_card| = {grad_err:.2e} (rtol {EMULATED_GRAD_RTOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the emulated pair ranks (P = {p}) do not give the "
                 "single-card loss and gradient")


def _tri_bounds(rows: int, d: int, itemsize: int):
    """Bounds of #2 and #3 at (2N, D): each input read once (z; the lse for
    #3), each output written once (lse and the loss; the fp32 gradient);
    (2N)^2 D and 3 (2N)^2 D operations at the fp32 peak."""
    z = rows * d * itemsize
    return (_bound(z + rows * 4 + 4, rows * rows * d, PEAK_FP32_FLOPS),
            _bound(z + rows * 4 + rows * d * 4, 3 * rows * rows * d,
                   PEAK_FP32_FLOPS))


def phase_tri_kernels() -> tuple[list[dict], dict]:
    """#2 and #3 against their plain versions and against the rectangular
    kernels (#1 + #5) at every shape and dtype, the loss bitwise
    repeatable; one ``ntxent_loss_fused(..., triangular=True)`` forward and
    backward (the triangular path) with its launches counted; times
    beside #1 + #5. Returns the kernel entries and the path's launches."""
    import torch

    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms, launch_counters

    t = NTX_TEMPERATURE
    errs = {}
    for rows, d in TRI_SHAPES:
        for dtype in ("float32", "bfloat16"):
            z = _unit_rows(rows, d, dtype, seed=rows + d + 5)
            loss, lse = N.ntxent_fwd_tri(z, t)
            again, _ = N.ntxent_fwd_tri(z, t)
            loss_ref, lse_ref = N.ntxent_fwd_tri_plain(z, t)
            grad = N.ntxent_bwd_tri(z, lse_ref, t)
            grad_ref = N.ntxent_bwd_tri_plain(z, lse_ref, t)
            loss_rect, lse_rect = N.ntxent_fwd(z, t)
            grad_rect = N.ntxent_bwd_sym(z, lse_rect, t)
            grad_tri = N.ntxent_bwd_tri(z, lse, t)
            torch.cuda.synchronize()
            fwd_err = max((lse - lse_ref).abs().max().item(),
                          abs(loss.item() - loss_ref.item()) / rows)
            bwd_err = (grad - grad_ref).abs().max().item()
            rect_loss = abs(loss.item() - loss_rect.item()) / abs(
                loss_rect.item())
            rect_grad = ((grad_tri - grad_rect).norm()
                         / grad_rect.norm()).item()
            repeat = again.item() == loss.item()
            ok = (max(fwd_err, bwd_err) <= NTX_ATOL and repeat
                  and rect_loss <= TRI_LOSS_RTOL
                  and rect_grad <= EMULATED_GRAD_RTOL)
            print(f"[tri-kernel] 2N={rows} D={d} {dtype}: ntxent_fwd_tri "
                  f"max|err| {fwd_err:.3e}, ntxent_bwd_tri {bwd_err:.3e} "
                  f"(atol {NTX_ATOL:g}); against #1 + #5: loss "
                  f"{rect_loss:.2e} relative (rtol {TRI_LOSS_RTOL:g}), "
                  f"gradient {rect_grad:.2e} relative (rtol "
                  f"{EMULATED_GRAD_RTOL:g}); loss bitwise repeatable "
                  f"{repeat} {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the triangular kernels disagree at 2N={rows} D={d} "
                     f"{dtype}")
            if (rows, dtype) == (512, "float32"):
                errs = {"ntxent_fwd_tri": fwd_err, "ntxent_bwd_tri": bwd_err}
            del z, grad, grad_ref, grad_rect, grad_tri

    # the triangular path: the public loss's forward and backward
    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    z = _unit_rows(*TRI_SHAPES[0], "float32", seed=9).requires_grad_()
    loss = N.ntxent_loss_fused(z, t, triangular=True)
    loss.backward()
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in counters.items()}
    want = {name: TRI_LAUNCHES.get(name, 0) for name in counters}
    finite = bool(torch.isfinite(loss)) and bool(
        torch.isfinite(z.grad).all())
    print(f"[tri] ntxent_loss_fused(z, {t}, triangular=True).backward() at "
          f"2N={TRI_SHAPES[0][0]}: loss {loss.item():.6f}, launches "
          f"{ {n: c for n, c in launches.items() if c} } (every other "
          f"kernel 0), finite loss and gradient {finite}", flush=True)
    if launches != want or not finite:
        fail(f"the triangular loss launched {launches}, expected {want} "
             f"(finite: {finite})")

    times = {}
    for rows, d in TRI_SHAPES[:2]:
        z = _unit_rows(rows, d, "float32", seed=1)
        _, lse = N.ntxent_fwd(z, t)
        runs = 3 if rows > 4096 else 10
        ms = (cuda_time_ms(lambda: N.ntxent_fwd_tri(z, t), runs),
              cuda_time_ms(lambda: N.ntxent_bwd_tri(z, lse, t), runs))
        plain = (cuda_time_ms(lambda: N.ntxent_fwd_tri_plain(z, t), runs),
                 cuda_time_ms(lambda: N.ntxent_bwd_tri_plain(z, lse, t),
                              runs))
        rect = (cuda_time_ms(lambda: N.ntxent_fwd(z, t), runs),
                cuda_time_ms(lambda: N.ntxent_bwd_sym(z, lse, t), runs))
        bounds = _tri_bounds(rows, d, 4)
        print(f"[tri-kernel] 2N={rows} D={d} fp32: ntxent_fwd_tri "
              f"{ms[0]:.4f} ms (plain {plain[0]:.4f}, bound "
              f"{bounds[0][0]:.5f} by {bounds[0][1]}; #1 symmetric "
              f"{rect[0]:.4f}), ntxent_bwd_tri {ms[1]:.4f} ms (plain "
              f"{plain[1]:.4f}, bound {bounds[1][0]:.5f} by {bounds[1][1]}; "
              f"#5 {rect[1]:.4f}); no single PyTorch call computes them, so "
              f"there is no library time", flush=True)
        times[rows] = (ms, plain, bounds, rect)
        del z
    names = ("ntxent_fwd_tri", "ntxent_bwd_tri")
    replaces = (
        "ntxent_tpu/ops/ntxent_pallas.py:237 (_fwd_tri_kernel, "
        "_fwd_tri_call :308)",
        "ntxent_tpu/ops/ntxent_pallas.py:350 (_bwd_tri_kernel, "
        "_bwd_tri_call :406)")
    sources = ("ntxent_tpu_torch/csrc/ntxent_tri_fwd.cu",
               "ntxent_tpu_torch/csrc/ntxent_tri_bwd.cu")
    out = []
    for i, name in enumerate(names):
        ms, plain, bounds, rect = times[512]
        big = times[8192]
        out.append({"name": name, "route": "cuda", "source": sources[i],
                    "replaces": replaces[i], "checked": True,
                    "launches": None, "max_abs_err": errs[name],
                    "ms": ms[i], "plain_ms": plain[i],
                    "bound_ms": bounds[i][0], "bound_by": bounds[i][1],
                    "library_ms": None, "rectangular_ms": rect[i],
                    "n8192_ms": big[0][i], "n8192_plain_ms": big[1][i],
                    "n8192_bound_ms": big[2][i][0],
                    "n8192_rectangular_ms": big[3][i]})
    return out, launches


def _rel(a, b) -> float:
    """|a - b| / |b| over whole tensors, in fp32."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _tile_rel(a, b) -> float:
    """The largest |a - b| / |b| over the 64-row tiles of (BH, L, D)
    tensors (L a multiple of 64), each tile against its own norm."""
    bh, n, d = b.shape

    def tiles(t):
        return t.float().reshape(bh, n // 64, 64 * d).norm(dim=-1)

    return (tiles(a.float() - b.float()) / tiles(b)).max().item()


def _fold_bound(bh, lq, lk, d, itemsize, pairs, peak):
    """#12's bound: q, k, v read once, (m, l, acc) read and written once;
    4 D operations (q.k and p.v) per live (query, key) pair."""
    moved = (bh * lq * d + 2 * bh * lk * d) * itemsize \
        + 2 * (2 * bh * lq * 4 + bh * lq * d * 4)
    return _bound(moved, 4 * d * bh * pairs, peak)


def _causal_pairs(lq, lk, q_off, k_off) -> int:
    """Live (query, key) pairs of a causal block: key position <= query
    position."""
    import numpy as np

    qpos = q_off + np.arange(lq)
    return int(np.clip(qpos - k_off + 1, 0, lk).sum())


def _fold_carry(bh, lq, d):
    import torch

    return (torch.full((bh, lq), -1e30, device="cuda"),
            torch.zeros(bh, lq, device="cuda"),
            torch.zeros(bh, lq, d, device="cuda"))


def _fold_errors(got, want) -> tuple[float, float, float, float]:
    """(m max|err|, l max relative error, acc / l relative error over the
    whole tensor, acc / l max|err|) of a fold against its plain version;
    every row has seen a key, so l > 0."""
    o_got = got[2] / got[1][..., None]
    o_want = want[2] / want[1][..., None]
    return ((got[0] - want[0]).abs().max().item(),
            ((got[1] - want[1]).abs() / want[1]).max().item(),
            _rel(o_got, o_want), (o_got - o_want).abs().max().item())


def _fold_ok(errs, dtype) -> bool:
    return (errs[0] <= FOLD_M_ATOL and errs[1] <= FOLD_L_RTOL
            and errs[2] <= FOLD_O_RTOL[dtype])


def _fold_report(errs, dtype) -> str:
    return (f"m max|err| {errs[0]:.2e} (atol {FOLD_M_ATOL:g}), l max rel "
            f"err {errs[1]:.2e} (rtol {FOLD_L_RTOL:g}), acc/l |a - b| / |b| "
            f"{errs[2]:.2e} (rtol {FOLD_O_RTOL[dtype]:g}), acc/l max|err| "
            f"{errs[3]:.2e}")


def _flat_qkv(bh, lq, lk, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(bh, n, d, generator=gen, device="cuda").to(dt)
                 for n in (lq, lk, lk))


def _hop_backward(q, k, v, do) -> dict:
    """#13 and #14 at a causal hop (q_offset = k_offset = 0) against their
    plain versions, run in q-row chunks that fit the card: the true lse
    and delta from the plain forward of each chunk; dq joined and (dk,
    dv) summed over the chunks. Returns the stats, the max|err| and
    |a - b| / |b| of each, the control (the plain sums without the first
    q chunk, which must miss) and the plain versions' times."""
    import torch

    from ntxent_tpu_torch.ops import attention as A
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    rows = q.shape[1] // HOP_PLAIN_CHUNKS
    parts = [(c * rows, slice(c * rows, (c + 1) * rows))
             for c in range(HOP_PLAIN_CHUNKS)]
    lse, delta = [], []
    for off, sl in parts:
        o, chunk_lse = A.attention_plain(q[:, sl], k, v, causal=True,
                                         q_offset=off)
        lse.append(chunk_lse)
        delta.append((do[:, sl].float() * o.float()).sum(-1))
        del o
    lse, delta = torch.cat(lse, 1), torch.cat(delta, 1)

    def chunk(off, sl):
        return ((q[:, sl], k, v, do[:, sl], lse[:, sl], delta[:, sl]),
                dict(causal=True, q_offset=off))

    def plain_dq(chunks=parts):
        return torch.cat([A.attention_dq_plain(*a, **kw)
                          for a, kw in (chunk(*p) for p in chunks)], 1)

    def plain_dkv(chunks=parts):
        dk = dv = 0
        for a, kw in (chunk(*p) for p in chunks):
            gk, gv = A.attention_dkv_plain(*a, **kw)
            dk, dv = dk + gk, dv + gv
        return dk, dv

    dq_want, (dk_want, dv_want) = plain_dq(), plain_dkv()
    dq_plain_ms = cuda_time_ms(plain_dq, runs=1, warmup=0)
    dkv_plain_ms = cuda_time_ms(plain_dkv, runs=1, warmup=0)
    kw = dict(causal=True, q_offset=0, k_offset=0)
    dq = A.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = A.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    out = {"stats": (lse, delta), "dq_plain_ms": dq_plain_ms,
           "dkv_plain_ms": dkv_plain_ms,
           "dq_err": (dq - dq_want).abs().max().item(),
           "dq_rel": _rel(dq, dq_want),
           "dq_tile": _tile_rel(dq, dq_want),
           "dkv_err": max((dk - dk_want).abs().max().item(),
                          (dv - dv_want).abs().max().item()),
           "dkv_rel": max(_rel(dk, dk_want), _rel(dv, dv_want)),
           "dkv_tile": max(_tile_rel(dk, dk_want), _tile_rel(dv, dv_want))}
    # the tile controls (HOP_TILE_RTOL): one tile pair's plain share taken
    # out of the heaviest walk
    n = q.shape[1]
    last, mid = slice(n - 64, n), slice(n // 2, n // 2 + 64)
    dq_want[:, last] -= A.attention_dq_plain(
        q[:, last], k[:, mid], v[:, mid], do[:, last], lse[:, last],
        delta[:, last], causal=True, q_offset=n - 64, k_offset=n // 2)
    first, second = slice(0, 64), slice(64, 128)
    gk, gv = A.attention_dkv_plain(
        q[:, second], k[:, first], v[:, first], do[:, second],
        lse[:, second], delta[:, second], causal=True, q_offset=64)
    dk_want[:, first] -= gk
    dv_want[:, first] -= gv
    out["dq_tile_control"] = _tile_rel(dq, dq_want)
    out["dkv_tile_control"] = max(_tile_rel(dk, dk_want),
                                  _tile_rel(dv, dv_want))
    dq_want = torch.cat([torch.zeros_like(dq_want[:, parts[0][1]]),
                         plain_dq(parts[1:])], 1)
    dk_want, dv_want = plain_dkv(parts[1:])
    out["dq_control"] = (dq - dq_want).abs().max().item()
    out["dkv_control"] = max((dk - dk_want).abs().max().item(),
                             (dv - dv_want).abs().max().item())
    return out


def _hop_bwd_check(label: str, bwd: dict, gate: bool = True) -> None:
    """Print #13's and #14's readings at a hop (``_hop_backward``) and,
    with ``gate``, fail unless each max|err| is within BWD_ATOL and each
    tile's relative error within HOP_TILE_RTOL, and every control misses
    both."""
    tol, rtol = BWD_ATOL["bfloat16"], HOP_TILE_RTOL
    ok = (bwd["dq_err"] <= tol["dq"] < bwd["dq_control"]
          and bwd["dkv_err"] <= tol["dkv"] < bwd["dkv_control"]
          and bwd["dq_tile"] <= rtol < bwd["dq_tile_control"]
          and bwd["dkv_tile"] <= rtol < bwd["dkv_tile_control"])
    verdict = ("ok" if ok else "MISMATCH") if gate else "(not gated)"
    print(f"[fold-kernel] {label} hop backward against the plain "
          f"versions (true lse and delta, {HOP_PLAIN_CHUNKS} q-row "
          f"chunks): dq max|err| {bwd['dq_err']:.3e} (atol "
          f"{tol['dq']:g}), |a - b| / |b| {bwd['dq_rel']:.2e}, worst 64-row "
          f"tile {bwd['dq_tile']:.3e} (rtol {rtol:g}); dk/dv max|err| "
          f"{bwd['dkv_err']:.3e} (atol {tol['dkv']:g}), |a - b| / |b| "
          f"{bwd['dkv_rel']:.2e}, worst 64-row tile {bwd['dkv_tile']:.3e} "
          f"(rtol {rtol:g}); without the first q chunk the plain dq "
          f"would miss by {bwd['dq_control']:.3e} and dk/dv by "
          f"{bwd['dkv_control']:.3e}; the worst tile would read "
          f"{bwd['dq_tile_control']:.3e} on dq with the last q tile's "
          f"middle kv tile left out, {bwd['dkv_tile_control']:.3e} on dk/dv "
          f"with kv tile 0's q tile 1 left out; plain dq "
          f"{bwd['dq_plain_ms']:.4f} ms, plain dk/dv "
          f"{bwd['dkv_plain_ms']:.4f} ms {verdict}", flush=True)
    if gate and not ok:
        fail(f"flash_attention_dq/_dkv disagree with their plain versions "
             f"at the {label} hop, or a control did not miss")


def _hop_tensors(length: int):
    """(q, k, v, do) of the hops of 12g: bf16 (LONGCTX_BH, length,
    LONGCTX_HEAD_DIM) from seeds 700 and 701."""
    bh, d = LONGCTX_BH, LONGCTX_HEAD_DIM
    q, k, v = _flat_qkv(bh, length, length, d, "bfloat16", 700)
    return q, k, v, _flat_qkv(bh, length, length, d, "bfloat16", 701)[0]


HOP_LENGTHS = (("path", LONGCTX_LEN), ("p4_hop", LONGCTX_LEN // 4))


def phase_fold_kernel() -> tuple[dict, dict]:
    """flash_fold (#12) against flash_fold_plain: consecutive folds with a
    carried state at every case's offsets, then a block wholly after the
    rows, whose carry must come out bit for bit, and the control (the
    plain fold of the last block from a fresh carry must miss); then at
    the long-context path's world-1 hop and at the P = 4 hop, the kernel
    against the plain version (run in row chunks), its time beside its
    bound and the plain version's; the dQ and dK/dV kernels (#13, #14) at
    the same hops against theirs (``_hop_backward``, ``_hop_bwd_check``).
    Returns #12's entry and the ring times of #13/#14."""
    import torch
    import torch.nn.functional as F

    from ntxent_tpu_torch.ops import attention as A
    from ntxent_tpu_torch.utils.capability import set_fp32_precision
    from ntxent_tpu_torch.utils.profiling import cuda_time_ms

    set_fp32_precision()
    for i, (name, (bh, lq, lk, d), dtype, causal, q_off, k_offs) in \
            enumerate(FOLD_CASES):
        q, _, _ = _flat_qkv(bh, lq, lk, d, dtype, 500 + i)
        carry = want = _fold_carry(bh, lq, d)
        errs = (0.0, 0.0, 0.0, 0.0)
        for j, k_off in enumerate(k_offs):
            _, k, v = _flat_qkv(bh, lq, lk, d, dtype, 600 + 10 * i + j)
            kw = dict(q_offset=q_off, k_offset=k_off, causal=causal)
            carry = A.flash_fold(q, k, v, *carry, **kw)
            want = A.flash_fold_plain(q, k, v, *want, **kw)
            torch.cuda.synchronize()
            errs = tuple(map(max, errs, _fold_errors(carry, want)))
        # the control: the last block folded into a fresh carry
        control = _fold_errors(carry, A.flash_fold_plain(
            q, k, v, *_fold_carry(bh, lq, d), **kw))[2]
        after = A.flash_fold(q, k, v, *carry, q_offset=q_off,
                             k_offset=q_off + lq, causal=True)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(after, carry))
        ok = (_fold_ok(errs, dtype) and bitwise
              and control > FOLD_O_RTOL[dtype])
        print(f"[fold-kernel] {name} (BH={bh}, Lq={lq}, Lk={lk}, D={d}, "
              f"{dtype}, {'causal' if causal else 'full'}, q_offset "
              f"{q_off}, k_offsets {list(k_offs)}): "
              f"{_fold_report(errs, dtype)}; a fold that dropped the carry "
              f"would miss by {control:.2e}; a hop wholly in the rows' "
              f"future leaves the carry bit for bit: {bitwise} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"flash_fold disagrees with its plain version in case "
                 f"{name}")
        del q, k, v, carry, want, after
    _truth_gate(*TRUTH_GATES[2])

    times = {}
    for label, length in HOP_LENGTHS:
        bh, d = LONGCTX_BH, LONGCTX_HEAD_DIM
        q, k, v, do = _hop_tensors(length)
        carry = _fold_carry(bh, length, d)
        kw = dict(q_offset=0, k_offset=0, causal=True)
        got = A.flash_fold(q, k, v, *carry, **kw)
        ms = cuda_time_ms(lambda: A.flash_fold(q, k, v, *carry, **kw),
                          runs=5, warmup=1)
        rows = length // HOP_PLAIN_CHUNKS

        def plain():  # the same work in row chunks that fit the card
            parts = [A.flash_fold_plain(
                q[:, sl], k, v, carry[0][:, sl], carry[1][:, sl],
                carry[2][:, sl], q_offset=c * rows, k_offset=0, causal=True)
                for c, sl in ((c, slice(c * rows, (c + 1) * rows))
                              for c in range(HOP_PLAIN_CHUNKS))]
            return tuple(torch.cat(t, dim=1) for t in zip(*parts))

        want = plain()
        plain_ms = cuda_time_ms(plain, runs=1, warmup=0)
        errs = _fold_errors(got, want)
        ok = _fold_ok(errs, "bfloat16")
        del got, want
        pairs = _causal_pairs(length, length, 0, 0)
        bound = _fold_bound(bh, length, length, d, 2, pairs, PEAK_BF16_FLOPS)
        bwd = _hop_backward(q, k, v, do)
        stats = bwd.pop("stats")
        dq_ms = cuda_time_ms(lambda: A.flash_attention_dq(
            q, k, v, do, *stats, **kw), runs=3, warmup=1)
        dkv_ms = cuda_time_ms(lambda: A.flash_attention_dkv(
            q, k, v, do, *stats, **kw), runs=3, warmup=1)
        # SDPA's causal attention of the same (1, 8, L, 64) block: its
        # forward, and its backward (dq, dk, dv in one call), the library
        # time of #13 and #14 at the hop; the port never calls it.
        q4, k4, v4, do4 = (t.view(1, bh, length, d).detach().requires_grad_()
                           for t in (q, k, v, do))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        sdpa_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), runs=3, warmup=1)
        sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4.detach(), retain_graph=True), runs=3,
            warmup=1)
        del q4, k4, v4, do4, out4
        inputs = 4 * bh * length * d * 2 + 2 * bh * length * 4
        dq_bound = _bound(inputs + bh * length * d * 4,
                          3 * 2 * d * bh * pairs, PEAK_BF16_FLOPS)
        dkv_bound = _bound(inputs + 2 * bh * length * d * 4,
                           4 * 2 * d * bh * pairs, PEAK_BF16_FLOPS)
        print(f"[fold-kernel] {label} hop (BH={bh}, L={length}, D={d}, bf16, "
              f"causal, q_offset = k_offset = 0): against the plain version "
              f"{_fold_report(errs, 'bfloat16')} {'ok' if ok else 'MISMATCH'}"
              f"; flash_fold {ms:.4f} ms (plain {plain_ms:.4f} ms in "
              f"{HOP_PLAIN_CHUNKS} row chunks, bound {bound[0]:.4f} by "
              f"{bound[1]}; no single PyTorch call folds into a carried "
              f"state); flash_attention_dq {dq_ms:.4f} ms (bound "
              f"{dq_bound[0]:.4f}), flash_attention_dkv {dkv_ms:.4f} ms "
              f"(bound {dkv_bound[0]:.4f}); SDPA causal forward "
              f"{sdpa_fwd_ms:.4f} ms, backward (dq, dk, dv together) "
              f"{sdpa_bwd_ms:.4f} ms", flush=True)
        if not ok:
            fail(f"flash_fold disagrees with its plain version at the "
                 f"{label} hop")
        _hop_bwd_check(label, bwd)
        times[label] = dict(ms=ms, plain_ms=plain_ms, bound=bound,
                            err=errs[3], dq=(dq_ms, dq_bound),
                            dkv=(dkv_ms, dkv_bound), sdpa_fwd=sdpa_fwd_ms,
                            sdpa_bwd=sdpa_bwd_ms, bwd=bwd)
        del q, k, v, do, carry, stats
        torch.cuda.empty_cache()
    path, p4 = times["path"], times["p4_hop"]
    entry = {"name": "flash_fold", "route": "cuda",
             "source": "ntxent_tpu_torch/csrc/flash_attention_fold.cu",
             "replaces": "ntxent_tpu/ops/attention_pallas.py:217 "
                         "(_fold_kernel, flash_fold :261)",
             "checked": True, "launches": None, "max_abs_err": path["err"],
             "ms": path["ms"], "plain_ms": path["plain_ms"],
             "bound_ms": path["bound"][0], "bound_by": path["bound"][1],
             "library_ms": None, "p4_hop_ms": p4["ms"],
             "p4_hop_plain_ms": p4["plain_ms"],
             "p4_hop_bound_ms": p4["bound"][0],
             # SDPA's whole causal attention, not a fold: a yardstick only
             "longctx_hop_sdpa_fwd_ms": path["sdpa_fwd"],
             "p4_hop_sdpa_fwd_ms": p4["sdpa_fwd"]}
    ring = {name: {"longctx_hop_ms": path[key][0],
                   "longctx_hop_plain_ms": path["bwd"][f"{key}_plain_ms"],
                   "longctx_hop_bound_ms": path[key][1][0],
                   "longctx_hop_library_ms": path["sdpa_bwd"],
                   "longctx_hop_max_abs_err": path["bwd"][f"{key}_err"],
                   "p4_hop_ms": p4[key][0],
                   "p4_hop_plain_ms": p4["bwd"][f"{key}_plain_ms"],
                   "p4_hop_bound_ms": p4[key][1][0],
                   "p4_hop_library_ms": p4["sdpa_bwd"],
                   "p4_hop_max_abs_err": p4["bwd"][f"{key}_err"]}
            for name, key in (("flash_attention_dq", "dq"),
                              ("flash_attention_dkv", "dkv"))}
    return entry, ring


def _attention_grads(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn`` for the cotangent ``do``."""
    import torch

    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


def phase_emulated_rings() -> None:
    """Ring attention of P = 2, 4, 8 ranks emulated on one card at (B 1,
    L 8192, H 8, D 64), bf16 and fp32, causal and not: the flash ring
    (#12 forward, #13/#14 backward) against the jnp ring and against
    flash_attention on the whole sequence, out, dq, dk and dv; exactly P
    folds per rank forward and P dQ and dK/dV hops per rank backward, no
    forward kernel (#11)."""
    import torch

    from ntxent_tpu_torch.ops.attention import flash_attention
    from ntxent_tpu_torch.utils.capability import set_fp32_precision
    from ntxent_tpu_torch.utils.profiling import (
        emulated_ring_attention,
        launch_counters,
    )

    set_fp32_precision()
    counters = launch_counters()
    s = RING_SHAPE
    for dtype in ("bfloat16", "float32"):
        for causal in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(800)
            q, k, v, do = (torch.randn(s["b"], s["l"], s["h"], s["d"],
                                       generator=gen, device="cuda")
                           .to(getattr(torch, dtype)) for _ in range(4))
            for t in (q, k, v):
                t.requires_grad_()
            ref = _attention_grads(
                lambda a, b, c: flash_attention(a, b, c, causal=causal),
                q, k, v, do)
            for p in RING_WORLDS:
                for wrapper in counters.values():
                    wrapper.launches = 0
                out = emulated_ring_attention(p, causal=causal)(q, k, v)
                fwd = {n: w.launches for n, w in counters.items()}
                grads = torch.autograd.grad(out, (q, k, v), do)
                torch.cuda.synchronize()
                both = {n: w.launches for n, w in counters.items()}
                flash = (out.detach(), *grads)
                jnp = _attention_grads(
                    emulated_ring_attention(p, causal=causal, impl="jnp"),
                    q, k, v, do)
                want_fwd = {n: p * p if n == "flash_fold" else 0
                            for n in counters}
                want_both = {n: p * p if n in ("flash_fold",
                                               "flash_attention_dq",
                                               "flash_attention_dkv") else 0
                             for n in counters}
                err_ref = max(_rel(a, b) for a, b in zip(flash, ref))
                err_jnp = max(_rel(a, b) for a, b in zip(flash, jnp))
                tol = RING_RTOL[dtype]
                ok = (fwd == want_fwd and both == want_both
                      and err_ref <= tol and err_jnp <= tol)
                print(f"[ring] P = {p} ranks emulated, (B={s['b']}, "
                      f"L={s['l']}, H={s['h']}, D={s['d']}) {dtype} "
                      f"{'causal' if causal else 'full'}: flash ring vs "
                      f"flash_attention of the whole sequence "
                      f"{err_ref:.2e}, vs the jnp ring {err_jnp:.2e} (the "
                      f"largest relative error of out, dq, dk, dv; rtol "
                      f"{tol:g}); launches forward "
                      f"{ {n: c for n, c in fwd.items() if c} }, forward "
                      f"and backward { {n: c for n, c in both.items() if c} }"
                      f" ({p} a rank each) {'ok' if ok else 'MISMATCH'}",
                      flush=True)
                if not ok:
                    fail(f"the emulated ring of {p} ranks ({dtype}, causal "
                         f"{causal}) disagrees or launched {both}")
                del out, grads, flash, jnp
            del q, k, v, do, ref
    torch.cuda.empty_cache()


def _set_attention(model, fn) -> None:
    model.attention_fn = fn
    for block in model.blocks:
        block.attn.attention_fn = fn


def _long_context_pass(model, tokens):
    """(output, every parameter's gradient) of one forward and backward of
    the probe sum(out^2)."""
    import torch

    model.zero_grad(set_to_none=True)
    out = model(tokens)
    out.float().pow(2).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), [p.grad for p in model.parameters()]


def phase_long_context(card_line: str) -> dict:
    """The long-context path at full width over the NCCL group of world 1:
    three forward and backward passes of LongContextTransformer under
    make_ring_attention(group, causal=True, impl="flash"), each launching
    exactly 8/8/8 of #12/#13/#14 and nothing else; every parameter's
    gradient finite; the output and gradients against the same weights
    under flash_attention and under 4 emulated ring ranks; then an fp32
    model at depth 2, L = 1024 against the CPU. Returns the launches of
    one pass."""
    import copy
    from functools import partial

    import torch

    from ntxent_tpu_torch.ops.attention import flash_attention
    from ntxent_tpu_torch.parallel import make_ring_attention
    from ntxent_tpu_torch.utils.capability import set_fp32_precision
    from ntxent_tpu_torch.utils.profiling import (
        build_long_context,
        emulated_ring_attention,
        launch_counters,
        long_context_tokens,
    )

    set_fp32_precision()
    torch.cuda.empty_cache()
    plan = make_ring_attention(torch.distributed.group.WORLD, causal=True,
                               impl="flash")
    model = build_long_context("cuda", plan)
    tokens = long_context_tokens("cuda", LONGCTX_LEN, LONGCTX_BATCH)
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(LONGCTX_PASSES):
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        out, grads = _long_context_pass(model, tokens)
        times.append((time.perf_counter() - t0) * 1e3)
        launches = {name: w.launches for name, w in counters.items()}
        want = {n: LONGCTX_LAUNCHES.get(n, 0) for n in counters}
        if launches != want:
            fail(f"a long-context pass launched {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    names = [n for n, _ in model.named_parameters()]
    bad = [n for n, g in zip(names, grads)
           if g is None or not torch.isfinite(g).all()]
    if bad or not torch.isfinite(out).all() or out.shape != (
            LONGCTX_BATCH, LONGCTX_LEN, 512):
        fail(f"long-context output {tuple(out.shape)} finite "
             f"{bool(torch.isfinite(out).all())}; parameters without a "
             f"finite gradient: {bad}")
    grads = torch.cat([g.reshape(-1) for g in grads])
    print(f"[longctx] LongContextTransformer (vocab 49408, 512/8/8/2048, "
          f"max_len 32768, bf16) B={LONGCTX_BATCH}, L={LONGCTX_LEN}, causal "
          f"ring attention (flash) over the NCCL group of world 1: "
          f"{LONGCTX_PASSES} forward + backward passes "
          f"{[round(t, 1) for t in times]} ms (host clock, synchronized); "
          f"{LONGCTX_BATCH * LONGCTX_LEN / (min(times[1:]) / 1e3):.0f} "
          f"tokens/s at the fastest later pass; launches per pass "
          f"{ {n: c for n, c in launches.items() if c} } (every other "
          f"kernel 0); every parameter has a finite gradient; peak memory "
          f"{peak / 2**30:.2f} GiB on {card_line}", flush=True)
    for label, fn in (("flash_attention", partial(flash_attention,
                                                  causal=True)),
                      ("4 emulated ring ranks",
                       emulated_ring_attention(4, causal=True))):
        _set_attention(model, fn)
        out_b, grads_b = _long_context_pass(model, tokens)
        grads_b = torch.cat([g.reshape(-1) for g in grads_b])
        out_err, grad_err = _rel(out, out_b), _rel(grads, grads_b)
        ok = out_err <= LONGCTX_OUT_RTOL and grad_err <= LONGCTX_GRAD_RTOL
        print(f"[longctx] the same weights under {label}: output "
              f"|a - b| / |b| {out_err:.2e} (rtol {LONGCTX_OUT_RTOL:g}), "
              f"gradient {grad_err:.2e} (rtol {LONGCTX_GRAD_RTOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the ring plan disagrees with {label}")
        del out_b, grads_b
    del model, out, grads
    torch.cuda.empty_cache()

    # fp32 at depth 2, L = 1024: the card against the CPU
    model = build_long_context("cuda", plan, depth=2, dtype=torch.float32)
    cpu = copy.deepcopy(model).cpu()
    short = tokens[:, :LONGCTX_PARITY_LEN]
    out, grads = _long_context_pass(model, short)
    out_c, grads_c = _long_context_pass(cpu, short.cpu())
    out_err = (out.cpu() - out_c).abs().max().item()
    grad_err = _rel(torch.cat([g.reshape(-1).cpu() for g in grads]),
                    torch.cat([g.reshape(-1) for g in grads_c]))
    ok = out_err <= PARITY_LOSS_ATOL and grad_err <= PARITY_GRAD_RTOL
    print(f"[longctx] fp32, depth 2, L = {LONGCTX_PARITY_LEN}: card vs CPU "
          f"output max|err| {out_err:.2e} (atol {PARITY_LOSS_ATOL:g}), "
          f"gradient |g_card - g_cpu| / |g_cpu| {grad_err:.2e} (rtol "
          f"{PARITY_GRAD_RTOL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the fp32 long-context model on the card disagrees with the CPU")
    del model, cpu
    torch.cuda.empty_cache()
    return launches


def _ntxent_grad(fn, z) -> tuple:
    """(loss, gradient of z) of ``fn(z1, z2)`` on the stacked views z =
    [z1; z2]."""
    import torch

    zr = z.clone().requires_grad_()
    n = z.shape[0] // 2
    loss = fn(zr[:n], zr[n:])
    grad, = torch.autograd.grad(loss, zr)
    return loss.item(), grad


def _fused_ntxent(t):
    """ntxent_loss_fused of the views (z1, z2), the one-card reference."""
    import torch

    from ntxent_tpu_torch.ops.ntxent import ntxent_loss_fused

    return lambda z1, z2: ntxent_loss_fused(torch.cat([z1, z2]), t)


def phase_world1_plans() -> None:
    """At world 1 over the NCCL group: Ulysses attention equals
    attention_oracle (its all-to-alls are the identity), and the flash ring
    with transfer_chunks=2 gives the same output and gradients as with one
    chunk, bit for bit; the ring NT-Xent's entry point, impl "fused" and
    "auto", equals ntxent_loss_fused in loss and gradient and launches #1
    general and #6 rows and columns once each."""
    import torch

    from ntxent_tpu_torch.parallel import (
        attention_oracle,
        make_ring_attention,
        make_ring_ntxent,
        make_ulysses_attention,
    )
    from ntxent_tpu_torch.utils.profiling import launch_counters

    group = torch.distributed.group.WORLD
    s = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(900)
    q, k, v, do = (torch.randn(s["b"], s["l"], s["h"], s["d"], generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    uly = _attention_grads(make_ulysses_attention(group, causal=True),
                           q, k, v, do)
    ref = _attention_grads(lambda a, b, c: attention_oracle(a, b, c,
                                                            causal=True),
                           q, k, v, do)
    uly_ok = all(torch.equal(a, b) for a, b in zip(uly, ref))
    one, two = (_attention_grads(make_ring_attention(
        group, causal=True, impl="flash", transfer_chunks=c), q, k, v, do)
        for c in (1, 2))
    chunks_ok = all(torch.equal(a, b) for a, b in zip(one, two))
    print(f"[world1] Ulysses at world 1 equals attention_oracle (out, dq, "
          f"dk, dv; {s}, bf16, causal) bit for bit: {uly_ok}; the flash "
          f"ring with transfer_chunks=2 equals one chunk bit for bit: "
          f"{chunks_ok}", flush=True)
    if not (uly_ok and chunks_ok):
        fail("Ulysses or the chunked ring disagrees at world 1")
    del q, k, v, do, uly, ref, one, two

    t = NTX_TEMPERATURE
    z = _unit_rows(RING_NTX_2N, 128, "float32", seed=32)
    ref_loss, ref_grad = _ntxent_grad(_fused_ntxent(t), z)
    counters = launch_counters()
    for impl in ("fused", "auto"):
        for wrapper in counters.values():
            wrapper.launches = 0
        loss, grad = _ntxent_grad(make_ring_ntxent(group, t, impl=impl), z)
        launches = {name: w.launches for name, w in counters.items()}
        want = {n: 1 if n in RING_NTX_KERNELS else 0 for n in counters}
        loss_err, grad_err = abs(loss - ref_loss), _rel(grad, ref_grad)
        ok = (loss_err <= EMULATED_LOSS_ATOL
              and grad_err <= EMULATED_GRAD_RTOL and launches == want)
        print(f"[world1] make_ring_ntxent(group, {t}, impl={impl!r}) at "
              f"world 1 (2N = {RING_NTX_2N}, D = 128, fp32): loss "
              f"{loss:.6f} vs ntxent_loss_fused {ref_loss:.6f} (|err| "
              f"{loss_err:.2e}, atol {EMULATED_LOSS_ATOL:g}); gradient "
              f"{grad_err:.2e} relative (rtol {EMULATED_GRAD_RTOL:g}); "
              f"launches { {n: c for n, c in launches.items() if c} } "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the ring NT-Xent ({impl}) at world 1 disagrees or "
                 f"launched {launches}")


def phase_ring_ntxent_emulated() -> dict:
    """The fused ring NT-Xent of P = 2, 4, 8 ranks emulated on one card at
    global 2N = 8192, D = 128 (``emulated_ring_ntxent``: each rank's hops
    through the ring's own ``lse_hop`` with block_lse (#1 general), its
    second pass with block_grads (#6 rows and columns), the column
    gradients carried to their block's rank); against ntxent_loss_fused
    and its gradient. Returns the kernels' times at the P = 4 hop."""
    from ntxent_tpu_torch.ops import ntxent as N
    from ntxent_tpu_torch.parallel.mesh import local_row_gids
    from ntxent_tpu_torch.utils.profiling import (
        cuda_time_ms,
        emulated_ring_ntxent,
        launch_counters,
    )

    t, d = NTX_TEMPERATURE, 128
    two_n = RING_NTX_2N
    z = _unit_rows(two_n, d, "float32", seed=31)  # [view 1; view 2]
    ref_loss, ref_grad = _ntxent_grad(_fused_ntxent(t), z)
    counters = launch_counters()
    for p in RING_WORLDS:
        for wrapper in counters.values():
            wrapper.launches = 0
        loss, grad = _ntxent_grad(emulated_ring_ntxent(p, t), z)
        launches = {name: w.launches for name, w in counters.items()}
        loss_err = abs(loss - ref_loss)
        grad_err = _rel(grad, ref_grad)
        want = {n_: p * p if n_ in RING_NTX_KERNELS else 0
                for n_ in counters}
        ok = (loss_err <= EMULATED_LOSS_ATOL
              and grad_err <= EMULATED_GRAD_RTOL and launches == want)
        print(f"[ring-ntxent] P = {p} ranks emulated (2N = {two_n}, D = {d}, "
              f"fused: block_lse / block_grads): loss {loss:.6f} vs "
              f"ntxent_loss_fused {ref_loss:.6f} (|err| {loss_err:.2e}, "
              f"atol {EMULATED_LOSS_ATOL:g}); gradient {grad_err:.2e} "
              f"relative (rtol {EMULATED_GRAD_RTOL:g}); launches "
              f"{ {k: c for k, c in launches.items() if c} } ({p} a rank "
              f"each) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the emulated ring NT-Xent of {p} ranks disagrees or "
                 f"launched {launches}")
    # the P = 4 hop: 2n = 2048 rows against a 2048-column block
    n = two_n // 2 // 4
    gid0, gid1 = (local_row_gids(r, n, 4, z.device) for r in (0, 1))
    z0, z1 = z[gid0.long()], z[gid1.long()]
    lse0 = N.block_lse(z0, z1, gid0, gid1, t, two_n)
    lse_ms = cuda_time_ms(lambda: N.block_lse(z0, z1, gid0, gid1, t, two_n))
    grads_ms = cuda_time_ms(lambda: N.block_grads(z0, z1, gid0, gid1, lse0,
                                                  t, two_n))
    print(f"[ring-ntxent] the P = 4 hop (2048 rows x 2048 columns, D = {d}, "
          f"fp32): block_lse (#1 general) {lse_ms:.4f} ms, block_grads (#6 "
          f"rows + columns) {grads_ms:.4f} ms", flush=True)
    return {"ntxent_fwd_general": {"ring_hop_ms": lse_ms},
            "ntxent_bwd_general_rows": {"ring_hop_rows_and_cols_ms":
                                        grads_ms}}


def phase_ring_infonce() -> None:
    """The ring InfoNCE, dual and twoblock, at world 1 over the NCCL group
    against the port's dual InfoNCE (info_nce_fused, #9/#10) on the same
    pairs and a learnable scale: loss and the gradients of both
    embeddings and of the scale."""
    import torch

    from ntxent_tpu_torch.ops.infonce import info_nce_fused
    from ntxent_tpu_torch.parallel import make_ring_infonce

    group = torch.distributed.group.WORLD
    za, zb = (_unit_rows(RING_INFONCE_N, 512, "float32", seed=s)
              for s in (41, 42))

    def loss_and_grads(fn):
        a, b = za.clone().requires_grad_(), zb.clone().requires_grad_()
        scale = torch.tensor(DP_CLIP_SCALE, device="cuda",
                             requires_grad=True)
        loss = fn(a, b, scale)
        return (loss.detach(), *torch.autograd.grad(loss, (a, b, scale)))

    ref = loss_and_grads(lambda a, b, s: info_nce_fused(a, b, scale=s))
    for impl in ("dual", "twoblock"):
        got = loss_and_grads(make_ring_infonce(group, impl=impl))
        loss_err = abs(got[0].item() - ref[0].item())
        grad_err = max(_rel(g, w) for g, w in zip(got[1:], ref[1:]))
        ok = (loss_err <= EMULATED_LOSS_ATOL
              and grad_err <= EMULATED_GRAD_RTOL)
        print(f"[ring-infonce] {impl} ring at world 1 (N = {RING_INFONCE_N}, "
              f"D = 512, scale {DP_CLIP_SCALE:.4f}): loss {got[0].item():.6f}"
              f" vs info_nce_fused {ref[0].item():.6f} (|err| "
              f"{loss_err:.2e}); gradients of za, zb and the scale "
              f"{grad_err:.2e} relative (rtol {EMULATED_GRAD_RTOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the {impl} ring InfoNCE disagrees with info_nce_fused")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs on "
              "the GPU only", file=sys.stderr)
        return 1
    import ntxent_tpu_torch  # noqa: F401 — fail before any result line

    name, smi = phase_card()
    build_logs = phase_build()
    if sys.argv[1:] == ["--truth"]:
        # the bf16 kernels' fp32-truth readings alone, ungated: how each
        # factor is set from the kernels a change replaces
        from ntxent_tpu_torch.utils.capability import set_fp32_precision

        set_fp32_precision()
        for gate in TRUTH_GATES:
            _truth_gate(*gate, gate=False)
        for label, length in HOP_LENGTHS:
            bwd = _hop_backward(*_hop_tensors(length))
            _hop_bwd_check(label, bwd, gate=False)
            del bwd
            torch.cuda.empty_cache()
        return 0
    dp_clip_kernels, sym_retimed_ms = phase_dp_clip_kernels()
    tri_kernels, tri_launches = phase_tri_kernels()
    fold_kernel, ring_times = phase_fold_kernel()
    kernels = [phase_kernels(), *phase_ntxent_kernels(build_logs),
               *phase_flash_backward(), *phase_infonce_kernels(),
               *phase_general_kernels(), *dp_clip_kernels,
               *phase_pair_kernels(), *tri_kernels, fold_kernel]
    kernels[1]["retimed_ms"] = sym_retimed_ms
    phase_emulated_ranks()
    phase_dp_clip_emulated_ranks()
    phase_pair_emulated_ranks()
    phase_emulated_rings()
    ring_times |= phase_ring_ntxent_emulated()
    serve_launches = phase_serve(smi)
    train_launches = phase_train(smi)
    phase_step_parity()
    clip_launches = phase_clip_train(smi)
    phase_clip_parity()
    from ntxent_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as tmp:
        mesh.init_from_file(f"{tmp}/store", 0, 1, device="cuda")
        try:
            dp_launches = phase_dp_train(smi)
            dp_pair_launches = phase_dp_train(
                smi, DP_PAIR_ARGV, DP_PAIR_STEP_LAUNCHES, "dp-pair")
            phase_dp_parity()
            clip_dp_launches = phase_clip_dp_train(smi)
            phase_clip_dp_parity()
            longctx_launches = phase_long_context(smi)
            phase_world1_plans()
            phase_ring_infonce()
        finally:
            mesh.shutdown()
    paths = (train_launches, clip_launches, dp_launches, clip_dp_launches,
             dp_pair_launches, tri_launches, longctx_launches)
    for kernel in kernels:
        # launches on the path that runs the kernel (SimCLR for the
        # symmetric NT-Xent and flash kernels, CLIP for the square InfoNCE
        # kernels, the data-parallel ResNet-50 for the general NT-Xent
        # kernels, the data-parallel CLIP for the rectangular InfoNCE
        # kernels, the data-parallel ResNet-50 with --dp-loss pair for the
        # shard-pair kernels, one triangular loss's forward and backward
        # for the triangular kernels, one long-context forward and backward
        # for the fold kernel), and on each path but SimCLR's
        wrapper = kernel["name"]
        kernel["launches"] = next((path[wrapper] for path in paths
                                   if path[wrapper]), 0)
        kernel["clip_launches"] = clip_launches[wrapper]
        kernel["dp_launches"] = dp_launches[wrapper]
        kernel["clip_dp_launches"] = clip_dp_launches[wrapper]
        kernel["dp_pair_launches"] = dp_pair_launches[wrapper]
        kernel["tri_launches"] = tri_launches[wrapper]
        kernel["longctx_launches"] = longctx_launches[wrapper]
        kernel |= ring_times.get(wrapper, {})
    kernels[0]["serve_launches"] = serve_launches
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
