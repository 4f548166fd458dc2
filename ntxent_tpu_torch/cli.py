"""Command line of the port: the ``ntxent-serve`` counterpart.

Same flag names and defaults as ``ntxent_tpu/cli.py``'s
``build_serve_parser`` for what the port supports (ViT towers; JSON
``/metrics``), plus ``--device``. Weights are random from ``--seed``, as
``ntxent-serve`` serves without ``--ckpt-dir``.

Run: ``python -m ntxent_tpu_torch.cli --model vit_b16 --vit-attention
flash --image-size 224 --head embedding --port 8080``.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from .models import SimCLRModel, init_weights
from .models.vit import ViT_B16, ViT_L16, ViT_S16, ViT_Ti16
from .resilience.retry import RetryPolicy
from .serving import EmbeddingServer, InferenceEngine
from .utils.capability import device_name, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["build_model", "build_serve_parser", "build_server", "serve_main"]

ENCODERS = {"vit_t16": ViT_Ti16, "vit_s16": ViT_S16, "vit_b16": ViT_B16,
            "vit_l16": ViT_L16}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ntxent-serve (torch)",
        description="Embedding inference service on PyTorch/CUDA: bucketed "
                    "engine + micro-batching scheduler over HTTP (/embed, "
                    "/healthz, /readyz, /metrics)")
    m = p.add_argument_group("model")
    m.add_argument("--model", default="vit_b16", choices=sorted(ENCODERS))
    m.add_argument("--image-size", type=int, default=32,
                   help="served input resolution")
    m.add_argument("--vit-attention", default="xla", choices=["xla", "flash"],
                   help="flash: the hand-written flash-attention kernel; "
                        "xla: plain PyTorch attention on the same weights")
    m.add_argument("--proj-hidden-dim", type=int, default=2048)
    m.add_argument("--proj-dim", type=int, default=128)
    m.add_argument("--head", default="features",
                   choices=["features", "embedding"],
                   help="what /embed returns: encoder features or the "
                        "projected L2-normalized contrastive embedding")

    s = p.add_argument_group("serving")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (printed at startup)")
    s.add_argument("--buckets", default="1,4,16,64,128",
                   help="batch-size ladder; requests pad up to the nearest "
                        "rung, the largest rung is the chunking cap")
    s.add_argument("--max-batch", type=int, default=None,
                   help="coalescing cap per device call (default: the "
                        "largest bucket)")
    s.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="micro-batching window after the first request")
    s.add_argument("--queue-size", type=int, default=64,
                   help="bounded request queue; full => 429 + Retry-After")
    s.add_argument("--timeout-ms", type=float, default=10000.0,
                   help="default per-request deadline (the request's "
                        "timeout_ms field overrides it)")
    s.add_argument("--max-request-rows", type=int, default=None,
                   help="per-request row cap (413 above it; default 8x the "
                        "largest bucket)")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip running every bucket once at startup")
    s.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                   help="input dtype handed to the model (the tower "
                        "computes in bf16 either way)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")

    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    return p


def _buckets(text: str) -> tuple[int, ...]:
    try:
        buckets = tuple(int(b) for b in text.split(",") if b)
    except ValueError:
        buckets = ()
    if not buckets or min(buckets) < 1:
        raise SystemExit(f"--buckets must be a comma list of positive ints, "
                         f"got {text!r}")
    return buckets


def build_model(args) -> SimCLRModel:
    """The served SimCLR model with random weights drawn from ``--seed``
    (on the CPU, so a seed gives the same weights on every device)."""
    encoder = ENCODERS[args.model](image_size=args.image_size,
                                   attention_impl=args.vit_attention)
    model = SimCLRModel(encoder, proj_hidden_dim=args.proj_hidden_dim,
                        proj_dim=args.proj_dim)
    return init_weights(model, torch.Generator().manual_seed(args.seed))


def build_server(args) -> EmbeddingServer:
    """Model, engine and server from parsed ``args``; the ladder is warm
    unless ``--no-warmup``. Call ``start()`` or ``serve_forever()``."""
    buckets = _buckets(args.buckets)
    device = resolve_device(args.device)
    engine = InferenceEngine(
        build_model(args), (args.image_size, args.image_size, 3),
        method="forward" if args.head == "embedding" else "features",
        buckets=buckets, dtype=DTYPES[args.dtype], device=device)
    if not args.no_warmup:
        engine.warmup()
    logger.info("serving %s (%s attention) on %s", args.model,
                args.vit_attention, device_name(device))
    return EmbeddingServer(
        engine, host=args.host, port=args.port, max_batch=args.max_batch,
        max_delay_s=args.max_delay_ms / 1e3, queue_size=args.queue_size,
        retry_policy=RetryPolicy(base_delay_s=0.05, max_delay_s=1.0,
                                 seed=args.seed),
        default_timeout_s=args.timeout_ms / 1e3,
        max_request_rows=args.max_request_rows)


def serve_main(argv=None) -> int:
    args = build_serve_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    server = build_server(args)
    server.start()
    print(f"serving on http://{server.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("interrupted: draining")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
