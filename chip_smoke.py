#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``ntxent_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result:

1. card: its name and power limit;
2. build: the CUDA kernels from ``ntxent_tpu_torch/csrc``, timed;
3. kernels: ``flash_attention_fwd`` against its plain version on the card
   (the ViT-B/16 serving shape in bf16 and fp32, causal cases with
   q_offset != k_offset and ragged lengths, head_dim 128), then CUDA-event
   times of the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   beside the bound;
4. serve: a ViT-B/16 SimCLR embedding server built through
   ``ntxent_tpu_torch.cli``, concurrent ``/embed`` requests over HTTP,
   every answer held against the model's direct forward, the kernel's
   launch count per forward chunk, ``/healthz`` and ``/metrics``, and a
   70-row engine call that chunks through the largest bucket;
5. one JSON line describing each kernel of the path;
6. the last line: ``{"ok": true, "device": {...}}``.

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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth and the bf16
# tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Serving shape of ViT-B/16 at bucket 64: B=64, L=197, H=12, D=64.
SERVE_SHAPE = dict(b=64, lq=197, lk=197, h=12, d=64)
# (name, shape, dtype, causal, q_offset, k_offset)
KERNEL_CASES = [
    ("serve_bf16", SERVE_SHAPE, "bfloat16", False, 0, 0),
    ("serve_fp32", SERVE_SHAPE, "float32", False, 0, 0),
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

    s = SERVE_SHAPE
    q, k, v = _qkv(s, "bfloat16", seed=100)
    q4, k4, v4 = (t.view(s["b"], s["h"], -1, s["d"]) for t in (q, k, v))
    kernel_ms = cuda_time_ms(lambda: attention.flash_attention_fwd(q, k, v))
    plain_ms = cuda_time_ms(lambda: attention.attention_plain(q, k, v))
    sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    bh, lq, lk, d = s["b"] * s["h"], s["lq"], s["lk"], s["d"]
    moved = (2 * bh * lq * d + 2 * bh * lk * d) * 2 + bh * lq * 4
    flops = 4 * bh * lq * lk * d
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print(f"[kernel] serve shape (B*H={bh}, L={lq}, D={d}, bf16): kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms ({moved} bytes, "
          f"{flops} flops)", flush=True)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "ntxent_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ntxent_tpu/ops/attention_pallas.py:73 (_fwd_kernel)",
            "checked": True, "launches": None, "max_abs_err": serve_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": sdpa_ms}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs on "
              "the GPU only", file=sys.stderr)
        return 1
    import ntxent_tpu_torch  # noqa: F401 — fail before any result line

    name, smi = phase_card()
    phase_build()
    kernel = phase_kernels()
    kernel["launches"] = phase_serve(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
