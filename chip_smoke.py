#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``ntxent_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result:

1. card: its name and power limit;
2. build: every CUDA kernel source in ``ntxent_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together, timed;
3. kernels: each hand-written kernel against its plain version on the
   card -- ``flash_attention_fwd`` (the ViT-B/16 serving and training
   shapes in bf16 and fp32, causal cases with q_offset != k_offset and
   ragged lengths, head_dim 128); ``ntxent_fwd`` and ``ntxent_bwd_sym``
   (2N = 512 and 8192 at D = 128, and a ragged 2N = 1000 at D = 96, in
   fp32 and bf16); ``flash_attention_dq`` and ``flash_attention_dkv``
   (the training shape in bf16 and fp32 and the causal offset cases) --
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
   within fixed tolerances and in the path's bf16 within twice the gap
   bf16 rounding opens on the CPU itself;
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
9. one JSON line describing each kernel of the paths;
10. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, the bf16
# tensor-core rate and the fp32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

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
# gradient norm. bf16, the path's dtype: at initialization the embeddings
# of random images nearly coincide (loss ~ log(2B - 1)), so the loss and
# its gradient are made of differences between embeddings of the size of
# bf16 rounding, which the two devices round in other places (on one CPU
# the bf16 step's loss moves by 0.2 with the thread count alone). So the
# bf16 step is held to twice the gap that bf16 rounding itself opens on
# the CPU: its bf16 step against its fp32 step, on loss and gradient.
PARITY_BATCH = 4
PARITY_LOSS_ATOL = 1e-4
PARITY_GRAD_RTOL = 1e-2
PARITY_BF16_FACTOR = 2.0

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


def phase_build() -> None:
    from ntxent_tpu_torch.ops import _build

    t0 = time.monotonic()
    logs = _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel source(s) ready in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(key in line for key in ("entry function", "registers",
                                           "spill")):
                print(f"[build] {name}: {line.strip()}")


def _qkv(shape, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bh = shape["b"] * shape["h"]

    def rand(length):
        return torch.randn(bh, length, shape["d"], generator=gen,
                           device="cuda").to(getattr(torch, dtype))

    return rand(shape["lq"]), rand(shape["lk"]), rand(shape["lk"])


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


def phase_ntxent_kernels() -> list[dict]:
    """ntxent_fwd and ntxent_bwd_sym against their plain versions, then
    times at the path's shape (2N = 512, D = 128, fp32)."""
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

    rows, d = NTX_SHAPES[0]
    z = _unit_rows(rows, d, "float32", seed=0)
    _, lse = ntxent.ntxent_fwd(z, t)
    fwd_ms = cuda_time_ms(lambda: ntxent.ntxent_fwd(z, t))
    fwd_plain = cuda_time_ms(lambda: ntxent.ntxent_fwd_plain(z, t))
    bwd_ms = cuda_time_ms(lambda: ntxent.ntxent_bwd_sym(z, lse, t))
    bwd_plain = cuda_time_ms(lambda: ntxent.ntxent_bwd_sym_plain(z, lse, t))
    zb = rows * d * 4
    fwd_bound = _bound(zb + rows * 4 + 4, 2 * rows * rows * d,
                       PEAK_FP32_FLOPS)
    bwd_bound = _bound(2 * zb + rows * 4, 4 * rows * rows * d,
                       PEAK_FP32_FLOPS)
    print(f"[kernel] ntxent path shape (2N={rows}, D={d}, fp32): fwd "
          f"{fwd_ms:.4f} ms (plain {fwd_plain:.4f}, bound "
          f"{fwd_bound[0]:.5f} by {fwd_bound[1]}), bwd {bwd_ms:.4f} ms "
          f"(plain {bwd_plain:.4f}, bound {bwd_bound[0]:.5f} by "
          f"{bwd_bound[1]}); no single PyTorch call computes NT-Xent, so "
          f"there is no library time", flush=True)
    common = {"route": "cuda", "checked": True, "launches": None,
              "library_ms": None}
    return [
        {"name": "ntxent_fwd", **common,
         "source": "ntxent_tpu_torch/csrc/ntxent_fwd.cu",
         "replaces": "ntxent_tpu/ops/ntxent_pallas.py:130 (_fwd_kernel, "
                     "_fwd_call :190)",
         "max_abs_err": errs["ntxent_fwd"], "ms": fwd_ms,
         "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1]},
        {"name": "ntxent_bwd_sym", **common,
         "source": "ntxent_tpu_torch/csrc/ntxent_bwd_sym.cu",
         "replaces": "ntxent_tpu/ops/ntxent_pallas.py:445 (_bwd_sym_kernel, "
                     "_bwd_sym_call :612)",
         "max_abs_err": errs["ntxent_bwd_sym"], "ms": bwd_ms,
         "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1]},
    ]


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
    kernels' plain versions): fp32 within fixed tolerances, the path's
    bf16 within twice the CPU's own bf16-vs-fp32 gap (see PARITY_*)."""
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
    limits = {"float32": (PARITY_LOSS_ATOL, PARITY_GRAD_RTOL),
              "bfloat16": tuple(PARITY_BF16_FACTOR * x for x in noise)}
    for dtype, (loss_tol, grad_tol) in limits.items():
        loss_err, grad_err = gap((dtype, "cuda"), (dtype, "cpu"))
        ok = loss_err <= loss_tol and grad_err <= grad_tol
        print(f"[parity] ViT-B/16 train step {dtype}, batch {PARITY_BATCH}: "
              f"loss card {steps[dtype, 'cuda'][0]:.6f} vs CPU "
              f"{steps[dtype, 'cpu'][0]:.6f} (|err| {loss_err:.2e}, atol "
              f"{loss_tol:.2e}); gradient |g_card - g_cpu| / |g_cpu| = "
              f"{grad_err:.2e} (rtol {grad_tol:.2e}); CPU step "
              f"{cpu_s[dtype]:.1f} s {'ok' if ok else 'MISMATCH'}",
              flush=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs on "
              "the GPU only", file=sys.stderr)
        return 1
    import ntxent_tpu_torch  # noqa: F401 — fail before any result line

    name, smi = phase_card()
    phase_build()
    kernels = [phase_kernels(), *phase_ntxent_kernels(),
               *phase_flash_backward(), *phase_infonce_kernels()]
    serve_launches = phase_serve(smi)
    train_launches = phase_train(smi)
    phase_step_parity()
    clip_launches = phase_clip_train(smi)
    phase_clip_parity()
    for kernel in kernels:
        # launches on the train path that runs the kernel (SimCLR for the
        # NT-Xent and flash kernels, CLIP for InfoNCE), and on CLIP's
        kernel["launches"] = (train_launches[kernel["name"]]
                              or clip_launches[kernel["name"]])
        kernel["clip_launches"] = clip_launches[kernel["name"]]
    kernels[0]["serve_launches"] = serve_launches
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
