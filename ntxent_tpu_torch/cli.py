"""Command line of the port: the ``ntxent-serve`` and ``ntxent-train``
counterparts.

Same flag names and defaults as ``ntxent_tpu/cli.py`` for what the port
supports, plus ``--device`` (cuda by default; raises without a GPU):

* ``serve_main`` (``build_serve_parser``): ViT towers, JSON ``/metrics``;
  random weights from ``--seed``, as ``ntxent-serve`` serves without
  ``--ckpt-dir``.
* ``train_main`` (``build_train_parser``): single-card training on one
  card, random weights from ``--seed``:

  - ``--objective simclr`` (the default): SimCLR of a ViT tower on
    ``--dataset synthetic``. ``--model`` defaults to ``vit_b16`` (the JAX
    default, resnet50, is a later slice);
  - ``--objective clip``: a CLIP dual encoder (ViT image tower, causal
    text tower; ``--model tiny`` for both towers at width 32) with
    InfoNCE at a learnable logit scale and AdamW, on synthetic pairs or
    ``--data-dir pairs.npz`` (``images`` and ``tokens`` arrays), with the
    JAX CLI's checks. ``--temperature`` is ignored, as there: the logit
    scale is the model's.

  Flags of what is not ported yet (models, datasets, parallelism,
  checkpoints, the guard, remat, accumulation) exit with a message naming
  the ROADMAP.md item.

Run: ``python -m ntxent_tpu_torch.cli --model vit_b16 --vit-attention
flash --image-size 224 --head embedding --port 8080`` (serving),
``python -m ntxent_tpu_torch.cli train --model vit_b16 --vit-attention
flash --image-size 224 --batch 256 --steps 100`` (SimCLR training), or
``python -m ntxent_tpu_torch.cli train --objective clip --model vit_b16
--vit-attention flash --image-size 224 --batch 256 --steps 100`` (CLIP).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from .models import CLIPModel, SimCLRModel, TextTransformer, init_weights
from .models.vit import (
    ViT_B16,
    ViT_L16,
    ViT_S16,
    ViT_Ti16,
    VisionTransformer,
)
from .resilience.retry import RetryPolicy
from .serving import EmbeddingServer, InferenceEngine
from .training import (
    ROADMAP_ITEMS,
    ArraySource,
    PairedArrayLoader,
    PairedPipeline,
    StreamingLoader,
    TrainerConfig,
    TwoViewPipeline,
    create_clip_train_state,
    create_train_state,
    make_clip_train_step,
    make_train_step,
    train_loop,
)
from .utils.capability import device_name, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["build_clip_model", "build_model", "build_serve_parser",
           "build_server", "build_train_parser", "serve_main", "train",
           "train_main"]

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
    """The served or trained SimCLR model with random weights drawn from
    ``--seed`` (on the CPU, so a seed gives the same weights on every
    device)."""
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


# --------------------------------------------------------------------------
# ntxent-train
# --------------------------------------------------------------------------

# The JAX CLI's --model choices; those not ported yet exit with the item.
MODEL_CHOICES = ["resnet18", "resnet34", "resnet50", "resnet50x2",
                 "resnet101", "resnet152", "vit_t16", "vit_s16",
                 "vit_b16", "vit_l16", "tiny"]


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ntxent-train (torch)",
        description="SimCLR (fused NT-Xent kernels) or CLIP (fused "
                    "InfoNCE kernels) pretraining on PyTorch/CUDA, single "
                    "card")
    d = p.add_argument_group("data")
    d.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "cifar10", "imagefolder", "npy"],
                   help="only synthetic is ported")
    d.add_argument("--data-dir", default=None)
    d.add_argument("--image-size", type=int, default=None,
                   help="default: 32 (synthetic)")
    d.add_argument("--loader", default="python",
                   choices=["python", "native"])
    p.add_argument("--synthetic-samples", type=int, default=512)

    m = p.add_argument_group("model")
    m.add_argument("--model", default="vit_b16", choices=MODEL_CHOICES)
    m.add_argument("--vit-attention", default="xla", choices=["xla", "flash"],
                   help="flash: the hand-written flash-attention kernels "
                        "(forward and backward); xla: plain PyTorch "
                        "attention on the same weights")
    m.add_argument("--proj-hidden-dim", type=int, default=2048)
    m.add_argument("--proj-dim", type=int, default=128)
    m.add_argument("--moe-experts", type=int, default=0)

    t = p.add_argument_group("training")
    t.add_argument("--objective", default="simclr",
                   choices=["simclr", "clip"])
    t.add_argument("--vocab-size", type=int, default=49408,
                   help="clip: text-tower vocabulary")
    t.add_argument("--token-len", type=int, default=None,
                   help="clip: tokenized caption length (derived from "
                        "--data-dir tokens when given; 77 for synthetic)")
    t.add_argument("--parallel", default="dp", choices=["dp", "tp"])
    t.add_argument("--fsdp", action="store_true")
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--temperature", type=float, default=0.1)
    t.add_argument("--base-lr", type=float, default=0.3)
    t.add_argument("--weight-decay", type=float, default=1e-6)
    t.add_argument("--warmup-steps", type=int, default=100)
    t.add_argument("--accum-steps", type=int, default=1)
    t.add_argument("--remat", action="store_true")
    t.add_argument("--ckpt-dir", default=None)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--max-restarts", type=int, default=0)
    t.add_argument("--nan-policy", default="off",
                   choices=["off", "skip", "backoff", "rollback"])
    t.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    p.add_argument("--seed", type=int, default=0)
    return p


def _check_train_args(args) -> None:
    """Exit, naming the ROADMAP item, on anything not ported yet (and, for
    CLIP, on what the JAX CLI refuses)."""
    clip = args.objective == "clip"
    if clip and args.model.startswith("resnet"):
        raise SystemExit("--objective clip takes a ViT image tower "
                         "(--model vit_*|tiny); the CLIP step carries no "
                         "BatchNorm state")
    if clip and args.dataset != "synthetic":
        raise SystemExit("--objective clip takes paired data via "
                         "--data-dir pairs.npz (images + tokens arrays); "
                         "--dataset applies to the simclr objective only")
    unported = [
        (not (args.model.startswith("vit") or clip),
         f"--model {args.model}", "resnet"),
        (args.dataset != "synthetic", f"--dataset {args.dataset}", "data"),
        (args.data_dir is not None and not clip, "--data-dir", "data"),
        (args.loader != "python", f"--loader {args.loader}", "data"),
        (args.parallel != "dp" or args.fsdp, "--parallel tp / --fsdp", "mp"),
        (args.moe_experts > 0, "--moe-experts", "mp"),
        (args.accum_steps > 1, "--accum-steps", "resilience"),
        (args.remat, "--remat", "resilience"),
        (args.ckpt_dir is not None, "--ckpt-dir", "resilience"),
        (args.max_restarts > 0, "--max-restarts", "resilience"),
        (args.nan_policy != "off", f"--nan-policy {args.nan_policy}",
         "resilience"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise SystemExit(f"ntxent-train (torch): {flag} is not ported "
                             f"yet: {ROADMAP_ITEMS[item]}")
    if args.batch < 1 or args.steps < 1 or args.log_every < 1:
        raise SystemExit("--batch, --steps and --log-every must be positive")


def _synthetic_pipeline(args, device) -> TwoViewPipeline:
    """``--dataset synthetic`` as the JAX CLI makes it
    (``RandomState(seed).rand``), streamed and augmented on ``device``."""
    rng = np.random.RandomState(args.seed)
    source = ArraySource(rng.rand(args.synthetic_samples, args.image_size,
                                  args.image_size, 3).astype(np.float32))
    loader = StreamingLoader(source, args.batch, seed=args.seed)
    return TwoViewPipeline(loader, device, seed=args.seed + 1)


def _clip_data(args):
    """(images, tokens) as the JAX CLI makes them (``cli.py:1208-1240``):
    ``--data-dir pairs.npz`` with its checks, else synthetic pairs from
    ``RandomState(seed)``. Sets ``args.image_size`` and
    ``args.token_len`` from the arrays."""
    if args.data_dir:
        with np.load(args.data_dir) as z:
            images, tokens = z["images"], z["tokens"]
        if images.ndim != 4 or images.shape[1] != images.shape[2] \
                or images.shape[3] != 3:
            raise SystemExit(f"images in {args.data_dir} must be square "
                             f"NHWC with 3 channels, got {images.shape}")
        if args.image_size is not None \
                and args.image_size != images.shape[1]:
            raise SystemExit(f"--image-size {args.image_size} != images in "
                             f"{args.data_dir} ({images.shape[1]})")
        if args.token_len is not None \
                and args.token_len != tokens.shape[1]:
            raise SystemExit(f"--token-len {args.token_len} != tokens in "
                             f"{args.data_dir} ({tokens.shape[1]})")
        args.image_size = int(images.shape[1])
        args.token_len = int(tokens.shape[1])
        tmin, tmax = int(tokens.min()), int(tokens.max())
        if tmax >= args.vocab_size or tmin < 0:
            raise SystemExit(
                f"token ids span [{tmin}, {tmax}] outside [0, --vocab-size "
                f"{args.vocab_size})")
        return images, tokens
    if args.image_size is None:
        args.image_size = 32
    if args.token_len is None:
        args.token_len = 77
    rng = np.random.RandomState(args.seed)
    n, size = args.synthetic_samples, args.image_size
    images = rng.rand(n, size, size, 3).astype(np.float32)
    tokens = rng.randint(1, args.vocab_size,
                         (n, args.token_len)).astype(np.int32)
    return images, tokens


def build_clip_model(args) -> CLIPModel:
    """The CLIP model of ``--model`` (``cli.py:1145``) with random weights
    drawn from ``--seed`` on the CPU. Needs ``args.image_size`` and
    ``args.token_len`` resolved."""
    if args.model == "tiny":
        image = VisionTransformer(image_size=args.image_size, patch_size=8,
                                  hidden_dim=32, depth=2, num_heads=2,
                                  mlp_dim=64,
                                  attention_impl=args.vit_attention)
        text = TextTransformer(vocab_size=args.vocab_size,
                               max_len=args.token_len, hidden_dim=32,
                               depth=2, num_heads=2)
        embed_dim = 32
    else:
        image = ENCODERS[args.model](image_size=args.image_size,
                                     attention_impl=args.vit_attention)
        text = TextTransformer(vocab_size=args.vocab_size,
                               max_len=args.token_len)
        embed_dim = 512
    model = CLIPModel(image, text, embed_dim=embed_dim)
    return init_weights(model, torch.Generator().manual_seed(args.seed))


def _train_clip(args, device):
    """The CLIP branch of ``train`` (``cli.py:1175``, single device)."""
    images, tokens = _clip_data(args)
    cfg = TrainerConfig(batch_size=args.batch, base_lr=args.base_lr,
                        weight_decay=args.weight_decay,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.steps)
    state = create_clip_train_state(build_clip_model(args), cfg, device)
    loader = PairedArrayLoader(images, tokens, args.batch, seed=args.seed)
    logger.info("training CLIP %s (%s attention) on %s: batch %d, %d "
                "steps, peak lr %g, %d tokens of %d ids", args.model,
                args.vit_attention, device_name(device), args.batch,
                args.steps, args.base_lr, args.token_len, args.vocab_size)
    return state, train_loop(state, PairedPipeline(loader, device),
                             make_clip_train_step(), args.steps,
                             log_every=args.log_every, views=1)


def train(args):
    """Train as ``train_main`` does from parsed ``args``; returns
    (TrainState, history)."""
    _check_train_args(args)
    device = resolve_device(args.device)
    if args.objective == "clip":
        state, history = _train_clip(args, device)
        _log_final(history)
        return state, history
    if args.image_size is None:
        args.image_size = 32
    cfg = TrainerConfig(batch_size=args.batch, temperature=args.temperature,
                        base_lr=args.base_lr, weight_decay=args.weight_decay,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.steps)
    state = create_train_state(build_model(args), cfg, device)
    step = make_train_step(cfg.temperature)
    logger.info("training %s (%s attention) on %s: batch %d, %d steps, "
                "peak lr %g", args.model, args.vit_attention,
                device_name(device), args.batch, args.steps,
                cfg.learning_rate)
    history = train_loop(state, _synthetic_pipeline(args, device), step,
                         args.steps, log_every=args.log_every)
    _log_final(history)
    return state, history


def _log_final(history) -> None:
    if history:
        last = history[-1]
        logger.info("final: step %d loss %.4f (%.2f steps/s)", last["step"],
                    last["loss"], last["steps_per_sec"])


def train_main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    train(build_train_parser().parse_args(argv))
    return 0


def main(argv=None) -> int:
    """``train ...`` runs ``train_main``; anything else ``serve_main``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["train"]:
        return train_main(argv[1:])
    return serve_main(argv)


if __name__ == "__main__":
    sys.exit(main())
