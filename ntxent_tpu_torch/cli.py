"""Command line of the port: the ``ntxent-serve``, ``ntxent-train`` and
``ntxent-eval`` counterparts.

Same flag names and defaults as ``ntxent_tpu/cli.py`` for what the port
supports, plus ``--device`` (cuda by default; raises without a GPU):

* ``serve_main`` (``build_serve_parser``): the SimCLR model of ``--model``
  (``resnet50`` by default, as ``ntxent-serve``; every ResNet, ``tiny``
  and the ViTs) in eval mode; the params and batch_stats of the newest
  valid step of ``--ckpt-dir`` (a checkpoint of either package), or
  random weights from ``--seed`` without it. ``--dtype int8`` serves the
  quantized rung, ``--adaptive-buckets`` learns the ladder
  (``--ladder-*``), ``--max-restarts`` and ``--stall-timeout`` supervise
  the batcher, ``--watch-ckpt`` adopts new steps (``--watch-poll``,
  ``--watch-delay``; ``POST /rollback``), ``--port-file`` binds before the
  warmup and publishes the port, ``--log-jsonl`` and ``--run-id`` install
  the event log (request spans) and label ``/metrics``.
* ``train_main`` (``build_train_parser``): training from random weights
  drawn from ``--seed``, through ``training.fit`` under a
  ``PreemptionGuard``: with ``--ckpt-dir`` it resumes the newest valid
  step (or ``--restore-step``) with the input pipeline's position, saves
  every ``--ckpt-every`` steps (``--async-ckpt``, ``--ckpt-keep-last``,
  ``--ckpt-keep-every``, ``--ckpt-mirror``, ``--no-ckpt-verify``) and at
  the end, and on SIGTERM saves the stopped step and exits 0; the format
  is the JAX package's, so either package resumes the other's steps:

  - ``--objective simclr`` (the default): SimCLR of a ResNet (``--model
    resnet50``, the default, ``resnet18/34/50x2/101/152``, ``tiny``; the
    CIFAR stem at ``--image-size`` <= 64, else the ImageNet stem, as a
    7x7/2 convolution or with ``--stem space_to_depth`` as the 4x4/1
    convolution of the space-to-depth'd image from the same weight) or a
    ViT tower on ``--dataset
    synthetic|cifar10|imagefolder|npy`` (``--data-dir``; an npy store
    fixes ``--image-size``) through ``--loader python`` (threaded reads)
    or ``native`` (C++ threads over the memmapped npy store). On one
    card, or data-parallel under ``torchrun`` when ``WORLD_SIZE`` > 1
    (``cli.py:824-870``): one rank per card
    (``cuda:LOCAL_RANK``, NCCL) or per CPU process under ``--device cpu``
    (gloo), ``--batch`` global, cross-replica BatchNorm, the strip loss
    (``--dp-loss strip``), the balanced shard-pair loss (``--dp-loss
    pair``) or the chunked ring-overlap loss (``--dp-loss chunked``,
    ``--ring-chunks C``; ``--measure-overlap`` logs the strip-against-
    chunked A/B before training), the ``--collective-dtype
    float32|bf16|int8`` wire (int8 with an error-feedback residual that
    ``--ckpt-save-ef`` keeps in the checkpoints), only rank 0 logging. A
    world of one takes the single-card step, as the JAX CLI does on one
    device (``--dp-loss``, ``--collective-dtype`` and
    ``--measure-overlap`` are then ignored with a warning);
  - ``--objective clip``: a CLIP dual encoder (ViT image tower, causal
    text tower; ``--model tiny`` for both towers at width 32) with
    InfoNCE at a learnable logit scale and AdamW, on synthetic pairs or
    ``--data-dir pairs.npz`` (``images`` and ``tokens`` arrays), with the
    JAX CLI's checks. ``--temperature`` is ignored, as there: the logit
    scale is the model's. On one card, or data-parallel under ``torchrun``
    when ``WORLD_SIZE`` > 1 (``--clip-parallel dp``, ``cli.py:1338-1358``):
    ``--batch`` global, each rank its rows of every batch, the dual
    InfoNCE (only the text embeddings gathered), the
    ``--collective-dtype`` wire, only rank 0 logging.

  The input pipeline, on every branch (``cli.py:980-1011``):
  ``--prefetch DEPTH`` copies the next loader batches to the card ahead
  of the step (innermost: ``--chaos`` wraps the batches the steps
  consume), ``--lag-metrics`` reads each step's loss and guard outcome
  one step late (``train_loop(metrics_lag=1)``).

  Training resilience, on every branch as the JAX CLI has it
  (``cli.py:949-1140``): ``--remat`` (the forward rebuilt in the
  backward), ``--accum-steps K`` (an optimizer update every K
  micro-batches), ``--nan-policy skip|backoff|rollback`` (the guarded
  step and a ``DivergenceGuard``; SimCLR only: the CLIP steps carry no
  guard, so CLIP warns and trains without it), ``--stall-timeout S`` (a
  ``StallWatchdog``), ``--max-restarts N`` and ``--chaos SPEC`` (the run
  under a ``resilience.supervisor.Supervisor``, restarting in-process
  from the newest valid checkpoint; a supervised run that does not reach
  ``--steps`` exits 1). ``--chaos`` injects the plan's faults
  (``resilience.faults``): into the batches, the synthetic source's
  reads (retried by the loader), the checkpoint writes and between
  attempts; a bad spec exits before any device work. Under ``torchrun``
  every rank holds its own injector, so a batch fault fires on every
  rank at the same batch.

  Telemetry, as the JAX CLI has it (``cli.py:450-506``): any of
  ``--metrics-port PORT`` (``/metrics`` in Prometheus text, ``?format=
  json``, ``/healthz``; 0 picks a free port, logged), ``--log-jsonl PATH``
  (typed JSONL events: the step timeline, compiles, retries, divergence,
  restarts, checkpoints, traces) and ``--trace-dir DIR`` (a
  ``torch.profiler`` capture of ``--trace-steps`` steps after a step
  slower than ``--slow-step-factor`` x the rolling median, or after
  ``touch DIR/TRIGGER`` or SIGUSR2) installs an event log and hands
  ``fit`` a ``StepTimeline``: one ``torch.cuda.synchronize`` a step on the
  synchronous path (none under ``--lag-metrics``) and step 1's FLOPs
  counted for the MFU. With none of them the loop adds no sync and counts
  nothing.

* ``eval_main`` (``build_eval_parser``, ``main`` dispatches ``eval ...``):
  the newest step of ``--ckpt-dir`` (either package's; ``--accum-steps``
  shapes its optimizer state) evaluated by ``--protocol probe|knn|both``
  (frozen features), ``finetune`` (SimCLR) or ``zeroshot`` (CLIP,
  ``--class-tokens``) on labelled synthetic, CIFAR-10 or ImageFolder
  data; one JSON line of accuracies.

  Model parallelism and MoE (``cli.py:625-830``, ``:1245-1370``), with
  the JAX CLI's warnings and exits: ``--moe-experts E`` (ViT towers: a
  switch-MoE MLP in every other block; ``--moe-aux-weight`` its
  load-balance loss) on every branch; in a world of several ranks
  ``--parallel tp`` / ``--clip-parallel tp`` (Megatron on a (data,
  model) grid of ``--model-par`` model ranks, ``--tp-loss-axes``; with
  ``--fsdp`` Megatron + ZeRO-3) and ``--fsdp`` (ZeRO-3; hybrid over
  ``--dcn-slices`` slices). The world comes from ``torchrun``'s
  environment or, without one, from ``--coordinator host:port
  --num-processes N --process-id I`` (a ``tcp://`` rendezvous). One rank
  warns that it ignores ``--parallel tp`` and ``--fsdp`` and trains the
  single-card step, as the JAX CLI does on one device;
  ``train(args, data_parallel=True)`` runs their steps in a world of one.

Every flag of the JAX CLI's ``ntxent-train``, ``ntxent-eval`` and
``ntxent-serve`` parses here and runs; ``--platform cpu|gpu`` selects
``--device``.

Run: ``python -m ntxent_tpu_torch.cli --model vit_b16 --vit-attention
flash --image-size 224 --head embedding --port 8080`` (serving),
``python -m ntxent_tpu_torch.cli train --model vit_b16 --vit-attention
flash --image-size 224 --batch 256 --steps 100`` (SimCLR training of a
ViT on one card), ``torchrun --nproc_per_node 4 -m ntxent_tpu_torch.cli
train --model resnet50 --image-size 224 --batch 256`` (data-parallel
ResNet-50 on four cards), ``python -m ntxent_tpu_torch.cli train
--objective clip --model vit_b16 --vit-attention flash --image-size 224
--batch 256 --steps 100`` (CLIP), or the same under ``torchrun
--nproc_per_node 4 -m ntxent_tpu_torch.cli`` (data-parallel CLIP);
``python -m ntxent_tpu_torch.cli train ... --dataset npy --data-dir
rows.npy --loader native --prefetch 2 --lag-metrics --ckpt-dir ck`` then
``python -m ntxent_tpu_torch.cli eval --model vit_b16 --image-size 224
--ckpt-dir ck`` (train from a row store, then evaluate).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

import numpy as np
import torch

from .models import (
    CLIPModel,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet50x2,
    ResNet101,
    ResNet152,
    SimCLRModel,
    TextTransformer,
    cross_replica_batch_norm,
    init_weights,
)
from .models.vit import (
    ViT_B16,
    ViT_L16,
    ViT_S16,
    ViT_Ti16,
    VisionTransformer,
)
from .parallel import mesh
from .resilience import (
    DivergenceGuard,
    FaultInjector,
    FaultPlan,
    RetryPolicy,
)
from .obs import events as obs_events
from .obs.exporters import MetricsServer
from .obs.profiler import ProfilerTrigger
from .obs.timeline import StepTimeline
from .resilience.supervisor import Supervisor
from .serving import CheckpointWatcher, EmbeddingServer, InferenceEngine
from .training import (
    ROADMAP_ITEMS,
    ArraySource,
    CheckpointManager,
    Cifar10Source,
    ImageFolderSource,
    NativeStreamingLoader,
    PairedArrayLoader,
    PairedPipeline,
    PreemptionGuard,
    StreamingLoader,
    TrainerConfig,
    TwoViewPipeline,
    create_clip_train_state,
    create_train_state,
    extract_features,
    finetune,
    fit,
    knn_accuracy,
    linear_probe,
    make_clip_train_step,
    make_sharded_clip_train_step,
    make_sharded_train_step,
    make_train_step,
)
from .training.trainer import init_error_feedback, measure_comms_overlap
from .utils.capability import device_name, resolve_device
from .utils.watchdog import StallWatchdog

logger = logging.getLogger(__name__)

__all__ = ["build_clip_model", "build_eval_parser", "build_model",
           "build_serve_parser", "build_server", "build_train_parser",
           "eval_main", "eval_model", "evaluate", "serve_main", "train",
           "train_main"]

ENCODERS = {"vit_t16": ViT_Ti16, "vit_s16": ViT_S16, "vit_b16": ViT_B16,
            "vit_l16": ViT_L16}
RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34, "resnet50": ResNet50,
           "resnet50x2": ResNet50x2, "resnet101": ResNet101,
           "resnet152": ResNet152}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SERVE_DTYPES = {**DTYPES, "int8": torch.int8}


# The JAX CLI's --model choices; those not ported yet exit with the item.
MODEL_CHOICES = ["resnet18", "resnet34", "resnet50", "resnet50x2",
                 "resnet101", "resnet152", "vit_t16", "vit_s16",
                 "vit_b16", "vit_l16", "tiny"]

_STEM_HELP = ("ResNet ImageNet stem: space_to_depth runs the 7x7/s2 conv "
              "as a 4x4/s1 conv on space-to-depth input (the same weight)")

def _add_platform(p: argparse.ArgumentParser) -> None:
    p.add_argument("--platform", default=None, metavar="cpu|gpu",
                   help="the JAX CLI's platform flag: cpu runs on the CPU, "
                        "gpu (or cuda) on the card; it sets --device")


def _apply_platform(args) -> None:
    """``--platform`` of the JAX CLI selects the device the port runs on."""
    if args.platform is None:
        return
    devices = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}
    if args.platform not in devices:
        raise SystemExit(f"--platform {args.platform}: the port runs on the "
                         "CUDA card (gpu) or the CPU (cpu)")
    args.device = devices[args.platform]


def _exit_on_unported(prog: str, args, table, items) -> None:
    """Exit naming the item of the first flag of ``table`` (dest, default,
    item) that is set to anything but its default."""
    for dest, default, item in table:
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(f"{prog}: {flag} is not ported yet: "
                             f"{items[item]}")


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ntxent-serve (torch)",
        description="Embedding inference service on PyTorch/CUDA: bucketed "
                    "engine + micro-batching scheduler over HTTP (/embed, "
                    "/healthz, /readyz, /metrics)")
    m = p.add_argument_group("model")
    m.add_argument("--model", default="resnet50", choices=MODEL_CHOICES,
                   help="the SimCLR encoder (a ResNet's BatchNorm normalizes "
                        "with its running statistics)")
    m.add_argument("--image-size", type=int, default=32,
                   help="served input resolution (a ResNet takes the CIFAR "
                        "stem at 64 and below)")
    m.add_argument("--stem", default="conv",
                   choices=["conv", "space_to_depth"], help=_STEM_HELP)
    m.add_argument("--vit-attention", default="xla", choices=["xla", "flash"],
                   help="flash: the hand-written flash-attention kernel; "
                        "xla: plain PyTorch attention on the same weights")
    m.add_argument("--proj-hidden-dim", type=int, default=2048)
    m.add_argument("--proj-dim", type=int, default=128)
    m.add_argument("--head", default="features",
                   choices=["features", "embedding"],
                   help="what /embed returns: encoder features or the "
                        "projected L2-normalized contrastive embedding")
    m.add_argument("--ckpt-dir", default=None,
                   help="serve the params and batch_stats of the newest "
                        "valid checkpoint step here (either package's); "
                        "an empty directory exits")
    m.add_argument("--accum-steps", type=int, default=1,
                   help="the training run's accumulation (shapes the JAX "
                        "optimizer state; serving reads only the params "
                        "and batch_stats, so any value reads)")

    s = p.add_argument_group("serving")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (printed at startup)")
    s.add_argument("--buckets", default="1,4,16,64,128",
                   help="batch-size ladder; requests pad up to the nearest "
                        "rung, the largest rung is the chunking cap")
    s.add_argument("--adaptive-buckets", action="store_true",
                   help="learn the ladder from live traffic: a decayed "
                        "histogram of chunk sizes feeds a DP that picks the "
                        "rungs of least expected padding; a background "
                        "worker runs each new rung once and swaps the "
                        "ladder atomically (--buckets is the prior; its "
                        "largest rung stays the chunking cap)")
    s.add_argument("--ladder-max-buckets", type=int, default=6,
                   help="rungs the optimizer may use, the fixed top one "
                        "included")
    s.add_argument("--ladder-min-requests", type=int, default=200,
                   help="chunks observed before the first re-optimization "
                        "may swap the ladder")
    s.add_argument("--ladder-interval", type=float, default=2.0,
                   metavar="SECONDS",
                   help="background re-optimization period (0: only "
                        "explicit refresh_ladder() calls)")
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
                   help="skip running every bucket once at startup (the "
                        "first request of each bucket then pays its first "
                        "run)")
    s.add_argument("--dtype", "--serve-dtype", dest="dtype",
                   default="float32", choices=["float32", "bfloat16",
                                               "int8"],
                   help="input dtype of the chunks (the tower computes in "
                        "bf16 either way); int8 quantizes each chunk on the "
                        "host per example and dequantizes it on the card: "
                        "~4x fewer bytes to the device")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")

    r = p.add_argument_group("resilience and fleet worker")
    r.add_argument("--stall-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="a device call silent this long dumps the thread "
                        "stacks and (with --max-restarts) ends the "
                        "attempt: the batcher drains and a fresh one "
                        "starts")
    r.add_argument("--max-restarts", type=int, default=0,
                   help="supervised restarts after a stall (0: one "
                        "attempt)")
    r.add_argument("--port-file", default=None, metavar="PATH",
                   help="bind BEFORE the warmup and publish the bound port "
                        "to this file (/readyz answers 503 and /embed "
                        "sheds with Retry-After until the ladder is warm)")
    r.add_argument("--watch-ckpt", action="store_true",
                   help="watch --ckpt-dir for new manifest-valid steps and "
                        "swap them in (POST /rollback reverts and blocks a "
                        "step); an empty directory serves random weights "
                        "until the first step lands")
    r.add_argument("--watch-poll", type=float, default=2.0,
                   metavar="SECONDS", help="checkpoint poll interval")
    r.add_argument("--watch-delay", type=float, default=0.0,
                   metavar="SECONDS",
                   help="adopt a new step only this long after first "
                        "seeing it (staggers the workers of a fleet)")

    o = p.add_argument_group("observability")
    o.add_argument("--log-jsonl", default=None, metavar="PATH",
                   help="append typed JSONL events (request, queue, batch "
                        "and device-chunk spans sharing the request id; "
                        "export with python -m ntxent_tpu_torch.obs.trace)")
    o.add_argument("--run-id", default=None, metavar="ID",
                   help="identity stamped on every event and in /metrics "
                        "(serving_run_info{run_id=...}; default: random "
                        "when --log-jsonl is given)")

    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    _add_platform(p)
    return p


def _check_serve_args(args) -> None:
    """Exit on what the JAX CLI refuses (``cli.py:355-364``)."""
    _apply_platform(args)
    if args.max_restarts < 0:
        raise SystemExit("--max-restarts must be >= 0")
    if args.stall_timeout is not None and args.stall_timeout <= 0:
        raise SystemExit("--stall-timeout must be positive")
    if args.watch_ckpt and args.ckpt_dir is None:
        raise SystemExit("--watch-ckpt requires --ckpt-dir")
    if args.vit_attention != "xla" and not args.model.startswith("vit"):
        raise SystemExit(f"--vit-attention {args.vit_attention} applies to "
                         f"ViT encoders only (got --model {args.model}); it "
                         "would be silently ignored")


def _buckets(text: str) -> tuple[int, ...]:
    try:
        buckets = tuple(int(b) for b in text.split(",") if b)
    except ValueError:
        buckets = ()
    if not buckets or min(buckets) < 1:
        raise SystemExit(f"--buckets must be a comma list of positive ints, "
                         f"got {text!r}")
    return buckets


def _check_stem(args) -> None:
    """``--stem space_to_depth`` is a ResNet's ImageNet stem: other
    encoders and the CIFAR stem (``--image-size`` <= 64) refuse it, as the
    JAX CLI does (``cli.py:357-381``)."""
    if args.stem == "conv":
        return
    if not args.model.startswith("resnet"):
        raise SystemExit(f"--stem {args.stem} applies to ResNet encoders "
                         f"only (got --model {args.model}); it would be "
                         "silently ignored")
    if args.image_size is not None and args.image_size <= 64:
        raise SystemExit(
            f"--stem {args.stem} applies to the ImageNet stem only; "
            f"--image-size {args.image_size} selects the small-images "
            "(3x3/s1) stem, which would silently ignore it")


def _encoder(args):
    """The encoder of ``--model`` (``cli.py:341-395``): ``tiny`` is a
    one-stage ResNet on the CIFAR stem, a ResNet takes the CIFAR stem at
    ``--image-size`` <= 64 and otherwise the ImageNet stem of ``--stem``,
    which the other encoders refuse, as the JAX CLI does."""
    _check_stem(args)
    if args.model == "tiny":
        return ResNet((1,), small_images=True)
    if args.model in RESNETS:
        return RESNETS[args.model](small_images=args.image_size <= 64,
                                   stem=args.stem)
    return ENCODERS[args.model](image_size=args.image_size,
                                attention_impl=args.vit_attention,
                                moe_experts=getattr(args, "moe_experts", 0))


def build_model(args) -> SimCLRModel:
    """The served or trained SimCLR model with random weights drawn from
    ``--seed`` (on the CPU, so a seed gives the same weights on every
    device and every rank)."""
    model = SimCLRModel(_encoder(args), proj_hidden_dim=args.proj_hidden_dim,
                        proj_dim=args.proj_dim)
    return init_weights(model, torch.Generator().manual_seed(args.seed))


def _restore_served(args, model) -> int | None:
    """The step of ``--ckpt-dir`` loaded into ``model`` (None: random
    weights). An empty or missing directory exits, unless
    ``--watch-ckpt`` waits for its first step (``cli.py:1588-1598``)."""
    if args.ckpt_dir is None:
        logger.warning("no --ckpt-dir: serving RANDOM weights (smoke/"
                       "load-test mode)")
        return None
    empty = not os.path.isdir(args.ckpt_dir) \
        or CheckpointManager(args.ckpt_dir).latest_step() is None
    if empty and not args.watch_ckpt:
        raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
    if empty:
        logger.warning("no checkpoint under %s yet: serving random weights "
                       "and watching for the first valid step",
                       args.ckpt_dir)
        return None
    step = CheckpointManager(args.ckpt_dir).restore_variables(model)
    logger.info("serving checkpoint step %d from %s", step, args.ckpt_dir)
    return step


def build_server(args) -> EmbeddingServer:
    """Model, engine and server from parsed ``args`` (``cli.py:1545-1718``).

    The ladder is warm unless ``--no-warmup``. With ``--port-file`` the
    server comes back started: it binds first (``/readyz`` 503 while
    warming), publishes the port, then warms. ``--watch-ckpt`` sets
    ``server.reloader`` (``serve_main`` starts it); ``--log-jsonl`` or
    ``--run-id`` install an async event log. ``server.close()`` stops all
    of it. Call ``start()`` (unless started) or ``serve_forever()``."""
    _check_serve_args(args)
    buckets = _buckets(args.buckets)
    device = resolve_device(args.device)
    model = build_model(args)
    initial_step = _restore_served(args, model)
    event_log = None
    if args.log_jsonl or args.run_id:
        # async: span emits ride the batcher's dispatch loop
        event_log = obs_events.EventLog(args.log_jsonl, run_id=args.run_id,
                                        async_io=True)
        obs_events.install(event_log)
        logger.info("serving telemetry: run_id=%s%s", event_log.run_id,
                    f", events -> {args.log_jsonl}" if args.log_jsonl
                    else "")
    retry_policy = RetryPolicy(max_attempts=2, base_delay_s=0.05,
                               max_delay_s=1.0, seed=args.seed)
    engine = InferenceEngine(
        model, (args.image_size, args.image_size, 3),
        method="forward" if args.head == "embedding" else "features",
        buckets=buckets, dtype=SERVE_DTYPES[args.dtype], device=device,
        retry_policy=retry_policy, adaptive=args.adaptive_buckets,
        ladder_max_buckets=args.ladder_max_buckets,
        ladder_min_requests=args.ladder_min_requests,
        ladder_interval_s=(args.ladder_interval if args.adaptive_buckets
                           else 0.0))
    if event_log is not None:
        engine.metrics.set_run_id(event_log.run_id)
    if initial_step is not None:
        engine.metrics.set_checkpoint_step(initial_step)
    server = EmbeddingServer(
        engine, host=args.host, port=args.port, max_batch=args.max_batch,
        max_delay_s=args.max_delay_ms / 1e3, queue_size=args.queue_size,
        retry_policy=retry_policy, stall_timeout_s=args.stall_timeout,
        max_restarts=args.max_restarts,
        default_timeout_s=args.timeout_ms / 1e3,
        max_request_rows=args.max_request_rows)
    server.event_log = event_log
    if args.watch_ckpt:
        server.reloader = CheckpointWatcher(
            args.ckpt_dir, build_model(args), engine,
            poll_s=args.watch_poll, delay_s=args.watch_delay,
            initial_step=initial_step)
    logger.info("serving %s on %s", _model_label(args), device_name(device))
    if args.port_file:
        # mark the ladder cold BEFORE the bind, so a probe racing it never
        # sees ready, then publish the port, then warm
        server.begin_warmup()
        server.start()
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)
        if not args.no_warmup:
            engine.warmup()
        server.end_warmup()
    elif not args.no_warmup:
        engine.warmup()
    return server


def serve_main(argv=None) -> int:
    args = build_serve_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    server = build_server(args)
    if not server.listening:
        server.start()
    print(f"serving on http://{server.host}:{server.port}", flush=True)
    if server.reloader is not None:
        server.reloader.start()
    try:
        completed = server.serve_forever()
    except KeyboardInterrupt:
        logger.info("interrupted: draining")
        completed = True
    finally:
        server.close()
    return 0 if completed else 1


# --------------------------------------------------------------------------
# ntxent-train
# --------------------------------------------------------------------------

# (dest, the JAX CLI's default, item): train flags that exit when set
# (every train flag runs since Queue A 9; the mechanism stays for serve).
TRAIN_UNPORTED: list = []


def _add_common_args(p: argparse.ArgumentParser) -> None:
    """The data and model flags ``ntxent-train`` and ``ntxent-eval``
    share (``cli.py:33-78``), with ``--seed``, ``--platform`` and
    ``--device``."""
    d = p.add_argument_group("data")
    d.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "cifar10", "imagefolder", "npy"],
                   help="cifar10: the cifar-10-batches-py pickles under "
                        "--data-dir; imagefolder: --data-dir/<class>/<image> "
                        "(decoded, shorter side resized, centre-cropped); "
                        "npy: a (N, H, H, 3) array file read through a "
                        "memmap (--data-dir is the .npy file)")
    d.add_argument("--data-dir", default=None)
    d.add_argument("--image-size", type=int, default=None,
                   help="default: 224 for imagefolder, the store's for npy, "
                        "32 otherwise")
    d.add_argument("--loader", default="python",
                   choices=["python", "native"],
                   help="python: worker threads read the source; native: "
                        "C++ threads gather the rows of a memmapped npy "
                        "store (the same batches)")

    m = p.add_argument_group("model")
    m.add_argument("--model", default="resnet50", choices=MODEL_CHOICES)
    m.add_argument("--stem", default="conv",
                   choices=["conv", "space_to_depth"], help=_STEM_HELP)
    m.add_argument("--vit-attention", default="xla", choices=["xla", "flash"],
                   help="flash: the hand-written flash-attention kernels "
                        "(forward and backward); xla: plain PyTorch "
                        "attention on the same weights")
    m.add_argument("--proj-hidden-dim", type=int, default=2048)
    m.add_argument("--proj-dim", type=int, default=128)
    m.add_argument("--moe-experts", type=int, default=0,
                   help="ViT towers only (the SimCLR encoder, the CLIP image "
                        "tower): a switch-MoE MLP with this many experts in "
                        "every other block; 0 = dense")
    m.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="weight of the MoE load-balance loss when "
                        "--moe-experts > 0 (the Switch Transformer default)")

    p.add_argument("--seed", type=int, default=0)
    _add_platform(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ntxent-train (torch)",
        description="SimCLR (fused NT-Xent kernels) or CLIP (fused "
                    "InfoNCE kernels) on one card or data-parallel under "
                    "torchrun, on PyTorch/CUDA")
    _add_common_args(p)
    p.add_argument("--synthetic-samples", type=int, default=512)

    t = p.add_argument_group("training")
    t.add_argument("--objective", default="simclr",
                   choices=["simclr", "clip"])
    t.add_argument("--vocab-size", type=int, default=49408,
                   help="clip: text-tower vocabulary")
    t.add_argument("--token-len", type=int, default=None,
                   help="clip: tokenized caption length (derived from "
                        "--data-dir tokens when given; 77 for synthetic)")
    t.add_argument("--clip-parallel", default="dp", choices=["dp", "tp"],
                   help="clip multi-rank strategy: dp = data parallelism "
                        "with the dual InfoNCE; tp = Megatron tensor "
                        "parallelism on a (data, model) grid of ranks")
    t.add_argument("--model-par", type=int, default=2,
                   help="tp runs: ranks of the model axis of the (data, "
                        "model) grid; the world must divide by it")
    t.add_argument("--tp-loss-axes", default="data", choices=["data", "both"],
                   help="tp runs: the loss over the data axis (every model "
                        "rank the same rows) or over every rank")
    t.add_argument("--parallel", default="dp", choices=["dp", "tp"],
                   help="simclr multi-rank strategy: dp = data parallelism; "
                        "tp = Megatron tensor parallelism (ViT encoders) on "
                        "a (data, model) grid, with --fsdp Megatron + ZeRO-3")
    t.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: parameters and optimizer state cut over the "
                        "data ranks, gathered each step; with --dcn-slices > "
                        "1 hybrid ZeRO (cut within a slice, replicated "
                        "across slices)")
    t.add_argument("--dp-loss", default="strip",
                   choices=["strip", "pair", "chunked"],
                   help="data-parallel NT-Xent schedule: strip (local rows "
                        "x global columns on every rank), pair (the "
                        "balanced shard-pair schedule: each global tile "
                        "formed once across the world) or chunked (the "
                        "embedding all-gather becomes ring hops sent in "
                        "chunks whose transfers overlap the folds; the "
                        "same wire bytes)")
    t.add_argument("--ring-chunks", type=int, default=None, metavar="C",
                   help="chunks a ring hop of --dp-loss chunked sends "
                        "(default: the cached autotune vote or the "
                        "heuristic for the batch, width and world; ignored "
                        "with a warning for other --dp-loss values)")
    t.add_argument("--measure-overlap", action="store_true",
                   help="before training, time the strip against the "
                        "chunked loss on this world and log the overlap "
                        "window (data-parallel runs)")
    t.add_argument("--collective-dtype", default="float32",
                   choices=["float32", "bf16", "bfloat16", "int8"],
                   help="wire dtype of the data-parallel collectives: bf16 "
                        "halves the bytes; int8 quantizes the embedding "
                        "gathers (straight-through gradients) and the "
                        "gradient pmean (with error feedback: the "
                        "compression residual carries into the next step) "
                        "for about a quarter of the bytes; the BatchNorm "
                        "statistics stay float32")
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--temperature", type=float, default=0.1)
    t.add_argument("--base-lr", type=float, default=0.3)
    t.add_argument("--weight-decay", type=float, default=1e-6)
    t.add_argument("--warmup-steps", type=int, default=100)
    t.add_argument("--accum-steps", type=int, default=1,
                   help="one optimizer update every K micro-batches (the "
                        "mean of their gradients; negatives stay within a "
                        "micro-batch)")
    t.add_argument("--remat", action="store_true",
                   help="rematerialize the whole encoder-and-head forward "
                        "in the backward, the span jax.checkpoint wraps: one "
                        "more forward a step; the recompute rebuilds every "
                        "activation at once, so peak memory does not fall")
    t.add_argument("--log-every", type=int, default=50)

    c = p.add_argument_group("checkpoints (the JAX package's format)")
    c.add_argument("--ckpt-dir", default=None,
                   help="resume the newest valid step here and save into "
                        "it; SIGTERM saves the stopped step and exits 0")
    c.add_argument("--ckpt-every", type=int, default=500)
    c.add_argument("--async-ckpt", action="store_true",
                   help="snapshot to host and write on a background "
                        "thread (the loop blocks only while a save is in "
                        "flight); a SIGTERM stop still saves synchronously")
    c.add_argument("--ckpt-keep-last", type=int, default=3, metavar="K",
                   help="keep the newest K steps (0 keeps all); the newest "
                        "valid step is never collected")
    c.add_argument("--ckpt-keep-every", type=int, default=None, metavar="N",
                   help="also keep every step divisible by N")
    c.add_argument("--restore-step", type=int, default=None, metavar="N",
                   help="resume from step N (a step no replica holds "
                        "fails); the steps after N are deleted in both "
                        "replicas")
    c.add_argument("--ckpt-save-ef", action="store_true",
                   help="keep the int8 wire's error-feedback residual in "
                        "each step (every rank's, in the JAX layout); by "
                        "default saves drop it and a resume starts it at "
                        "zeros")
    c.add_argument("--ckpt-mirror", default=None, metavar="DIR",
                   help="copy every step to DIR; restore falls back to it")
    c.add_argument("--no-ckpt-verify", action="store_true",
                   help="write no CRC manifests (restore can then no longer "
                        "tell a corrupt step)")
    r = p.add_argument_group("resilience")
    r.add_argument("--max-restarts", type=int, default=0,
                   help="restart in-process from the newest valid "
                        "checkpoint after a crash, a divergence rollback, "
                        "SIGTERM or a stall, at most N times")
    r.add_argument("--nan-policy", default="off",
                   choices=["off", "skip", "backoff", "rollback"],
                   help="skip non-finite steps; backoff also halves the "
                        "gradient scale after 2 in a row; rollback also "
                        "restarts after 8 in an attempt (one host sync a "
                        "step; SimCLR only)")
    r.add_argument("--chaos", default=None, metavar="SPEC",
                   help="inject faults, e.g. 'nan@3,crash@5,truncate@1,"
                        "diskfull@2,fetch@4,sigterm@6,kill@7' (runs "
                        "supervised)")
    r.add_argument("--stall-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="dump every thread's stack after this long without "
                        "a step; supervised, also stop and restart")
    i = p.add_argument_group("input pipeline")
    i.add_argument("--prefetch", type=int, default=0, metavar="DEPTH",
                   help="copy the next DEPTH loader batches to the card "
                        "(pinned buffers, a side stream) ahead of the step")
    i.add_argument("--lag-metrics", action="store_true",
                   help="read each step's loss and guard outcome one step "
                        "late, after the next step is queued (the guard "
                        "then keeps a bad update out on the card)")

    o = p.add_argument_group("observability (obs/: metrics registry, JSONL "
                             "event log, profiler)")
    o.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve the metrics registry over HTTP on this "
                        "port (/metrics: Prometheus text, ?format=json "
                        "for JSON; /healthz); 0 picks a free port "
                        "(logged at startup)")
    o.add_argument("--log-jsonl", default=None, metavar="PATH",
                   help="append typed JSONL events (step timeline, "
                        "retries, divergence, restarts, checkpoints, "
                        "compiles, traces) to this file")
    o.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="arm on-demand torch.profiler capture into DIR: a "
                        "step slower than --slow-step-factor x the "
                        "rolling median (or touching DIR/TRIGGER, or "
                        "SIGUSR2) captures the next --trace-steps steps "
                        "as a Chrome trace")
    o.add_argument("--trace-steps", type=int, default=5,
                   help="steps per profiler capture window")
    o.add_argument("--slow-step-factor", type=float, default=3.0,
                   help="slow-step trigger threshold (x rolling median "
                        "device time; warmup and first-run steps never "
                        "fire it)")

    h = p.add_argument_group("multi-host rendezvous (torchrun's environment "
                             "wins when it is set)")
    h.add_argument("--dcn-slices", type=int, default=1,
                   help="split the ranks into this many slices: hybrid ZeRO "
                        "under --fsdp; 1 = one flat world")
    h.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (tcp:// rendezvous)")
    h.add_argument("--num-processes", type=int, default=None)
    h.add_argument("--process-id", type=int, default=None)
    return p


def _check_train_args(args) -> None:
    """Exit, naming the ROADMAP item, on anything not ported yet (and, for
    CLIP, on what the JAX CLI refuses)."""
    _apply_platform(args)
    clip = args.objective == "clip"
    if clip and args.model.startswith("resnet"):
        raise SystemExit("--objective clip takes a ViT image tower "
                         "(--model vit_*|tiny); the CLIP step carries no "
                         "BatchNorm state")
    if clip and args.dataset != "synthetic":
        raise SystemExit("--objective clip takes paired data via "
                         "--data-dir pairs.npz (images + tokens arrays); "
                         "--dataset applies to the simclr objective only")
    if args.prefetch < 0:
        raise SystemExit("--prefetch must be >= 0")
    _exit_on_unported("ntxent-train (torch)", args, TRAIN_UNPORTED,
                      ROADMAP_ITEMS)
    _check_moe(args)
    if args.model_par < 1 or args.dcn_slices < 1:
        raise SystemExit("--model-par and --dcn-slices must be positive")
    if not clip and args.vit_attention != "xla" \
            and not args.model.startswith("vit"):
        raise SystemExit(f"--vit-attention {args.vit_attention} applies to "
                         f"ViT encoders only (got --model {args.model}); it "
                         "would be silently ignored")
    if args.batch < 1 or args.steps < 1 or args.log_every < 1:
        raise SystemExit("--batch, --steps and --log-every must be positive")
    if args.ckpt_every < 1 or args.accum_steps < 1:
        raise SystemExit("--ckpt-every and --accum-steps must be positive")
    if args.max_restarts < 0:
        raise SystemExit("--max-restarts must be >= 0")
    if args.stall_timeout is not None and args.stall_timeout <= 0:
        raise SystemExit("--stall-timeout must be positive")
    if args.restore_step is not None and args.ckpt_dir is None:
        raise SystemExit("--restore-step needs --ckpt-dir (there is no "
                         "store to restore the named step from)")


def _check_moe(args) -> None:
    """``--moe-experts`` needs a ViT (``cli.py:355-356``)."""
    if args.moe_experts < 0:
        raise SystemExit("--moe-experts must be >= 0")
    if args.moe_experts > 0 and not (args.model.startswith("vit")
                                     or (args.model == "tiny" and getattr(
                                         args, "objective", "simclr")
                                         == "clip")):
        raise SystemExit("--moe-experts requires a ViT model")


def _moe_aux(args) -> float:
    return args.moe_aux_weight if args.moe_experts > 0 else 0.0


def _make_injector(args) -> FaultInjector | None:
    """The ``FaultInjector`` of ``--chaos`` or None; a bad spec exits
    before any device work (``cli.py:436-448``)."""
    if not args.chaos:
        return None
    try:
        plan = FaultPlan.parse(args.chaos, seed=args.seed)
    except ValueError as e:
        raise SystemExit(f"--chaos: {e}") from None
    logger.warning("chaos mode: %s", plan)
    return FaultInjector(plan)


def _make_step_guard(nan_policy: str) -> DivergenceGuard | None:
    """The ``DivergenceGuard`` of ``--nan-policy`` (``cli.py:510-520``);
    None for ``off``."""
    if nan_policy == "off":
        return None
    if nan_policy == "skip":
        return DivergenceGuard(backoff_after=None, rollback_after=None)
    if nan_policy == "backoff":
        return DivergenceGuard(rollback_after=None)
    return DivergenceGuard()  # rollback: every tier armed


def _npy_store_shape(args) -> tuple:
    """The array shape of ``--dataset npy``'s store (``cli.py:332-339``),
    read through a memmap."""
    if args.data_dir is None:
        raise SystemExit("--dataset npy requires --data-dir")
    return np.load(args.data_dir, mmap_mode="r").shape


def _resolve_image_size(args) -> None:
    """``--image-size`` of a SimCLR run (``cli.py:645-656``): an npy store
    has no resize path, so the model takes the store's size (a different
    explicit size exits); imagefolder defaults to 224, the rest to 32."""
    if args.dataset == "npy":
        store_size = int(_npy_store_shape(args)[1])
        if args.image_size is not None and args.image_size != store_size:
            raise SystemExit(
                f"--image-size {args.image_size} disagrees with the npy "
                f"store's row shape ({store_size}); omit the flag or "
                f"re-export the store")
        args.image_size = store_size
    elif args.image_size is None:
        args.image_size = 224 if args.dataset == "imagefolder" else 32


def _source(args):
    """The source of ``--dataset`` (``cli.py:536-554``); synthetic as the
    JAX CLI draws it (``RandomState(seed).rand``)."""
    if args.dataset in ("cifar10", "imagefolder") and args.data_dir is None:
        raise SystemExit(f"--dataset {args.dataset} requires --data-dir")
    if args.dataset == "cifar10":
        return Cifar10Source(args.data_dir)
    if args.dataset == "imagefolder":
        return ImageFolderSource(args.data_dir, image_size=args.image_size)
    if args.dataset == "npy":
        return ArraySource(np.load(args.data_dir, mmap_mode="r"))
    rng = np.random.RandomState(args.seed)
    return ArraySource(rng.rand(args.synthetic_samples, args.image_size,
                                args.image_size, 3).astype(np.float32))


def _make_pipeline(args, device, rank: int = 0, world_size: int = 1,
                   injector: FaultInjector | None = None) -> TwoViewPipeline:
    """The SimCLR input pipeline (``cli.py:523-598``): the ``--dataset``
    source, the ``--loader`` engine (rank ``rank`` of ``world_size`` gets
    its rows of each global batch), views augmented on ``device`` and,
    with ``--prefetch``, the loader batches on their way to the device
    ahead of the step. Each source read retries transient errors
    (``cli.py:560-561``), the ``injector``'s ``fetch@n`` fails them; the
    native engine reads the file itself, so ``fetch@n`` is ignored
    there, with the JAX CLI's warning."""
    source = _source(args)
    retry = RetryPolicy(max_attempts=3, base_delay_s=0.1, max_delay_s=5.0,
                        seed=args.seed)
    if args.loader == "native":
        if injector is not None and injector.plan.fetch_calls:
            logger.warning("--chaos fetch@N ignored: the native engine "
                           "reads the mmap'd file directly (no per-item "
                           "__getitem__ to inject into)")
        try:
            loader = NativeStreamingLoader(
                source, args.batch, seed=args.seed, rank=rank,
                world_size=world_size, retry_policy=retry)
        except (TypeError, ValueError, OSError, RuntimeError) as e:
            # not a memmap, or the engine did not build: one clean exit
            raise SystemExit(f"--loader native: {e}") from None
    else:
        if injector is not None:
            source = injector.wrap_source(source)
        loader = StreamingLoader(source, args.batch, seed=args.seed,
                                 rank=rank, world_size=world_size,
                                 retry_policy=retry)
    if args.prefetch and rank == 0:
        logger.info("device prefetch: depth %d", args.prefetch)
    # each rank its rows, the views of their global positions: JAX's
    # GlobalTwoViewPipeline (cli.py:587-591) for any world size
    return TwoViewPipeline(loader, device, seed=args.seed + 1,
                           prefetch=args.prefetch)


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
                                  mlp_dim=64, moe_experts=args.moe_experts,
                                  attention_impl=args.vit_attention)
        text = TextTransformer(vocab_size=args.vocab_size,
                               max_len=args.token_len, hidden_dim=32,
                               depth=2, num_heads=2)
        embed_dim = 32
    else:
        image = ENCODERS[args.model](image_size=args.image_size,
                                     attention_impl=args.vit_attention,
                                     moe_experts=args.moe_experts)
        text = TextTransformer(vocab_size=args.vocab_size,
                               max_len=args.token_len)
        embed_dim = 512
    model = CLIPModel(image, text, embed_dim=embed_dim)
    return init_weights(model, torch.Generator().manual_seed(args.seed))


def _clip_config(args) -> TrainerConfig:
    return TrainerConfig(batch_size=args.batch, base_lr=args.base_lr,
                         weight_decay=args.weight_decay,
                         warmup_steps=args.warmup_steps,
                         total_steps=args.steps,
                         accum_steps=args.accum_steps)


def _warn_clip_nan_policy(args) -> None:
    if args.nan_policy != "off":
        logger.warning("--nan-policy %s ignored: the CLIP steps carry no "
                       "in-step divergence guard yet", args.nan_policy)


def _clip_label(args) -> str:
    return (f"CLIP {args.model} ({args.vit_attention} attention), "
            f"{args.token_len} tokens of {args.vocab_size} ids")


def _warn_single_card(args, simclr: bool) -> None:
    """The multi-rank flags a single-card run ignores, with the JAX CLI's
    warnings (``cli.py:910-932``, ``:1363-1365``)."""
    if args.fsdp:
        logger.warning("--fsdp ignored: single-device run has nothing to "
                       "shard over")
    if simclr and args.parallel != "dp":
        logger.warning("--parallel %s ignored: single-device run has no "
                       "model axis", args.parallel)
    if simclr and args.dp_loss != "strip":
        logger.warning("--dp-loss %s ignored: single-device run has no "
                       "shard-pair schedule", args.dp_loss)
    if args.collective_dtype != "float32":
        logger.warning("--collective-dtype %s ignored: single-device run "
                       "issues no collectives", args.collective_dtype)
    if args.measure_overlap:
        logger.warning("--measure-overlap ignored: the overlap A/B "
                       "measures the data-parallel loss schedule")


def _wire_log(args) -> None:
    if args.collective_dtype != "float32":
        logger.info("quantized collectives: %s wire payloads%s",
                    args.collective_dtype,
                    " + gradient error feedback"
                    if args.collective_dtype == "int8" else "")


def _train_clip(args, device, stats, injector, timeline):
    """The CLIP branch of ``train`` (``cli.py:1175``, single device)."""
    images, tokens = _clip_data(args)
    _warn_clip_nan_policy(args)

    def fresh():
        return create_clip_train_state(build_clip_model(args),
                                       _clip_config(args), device)

    loader = PairedArrayLoader(images, tokens, args.batch, seed=args.seed)
    logger.info("training %s on %s: batch %d, %d steps, peak lr %g",
                _clip_label(args), device_name(device), args.batch,
                args.steps, args.base_lr)
    return _fit(args, fresh(), PairedPipeline(loader, device, args.prefetch),
                make_clip_train_step(remat=args.remat,
                                     moe_aux_weight=_moe_aux(args)),
                stats, views=1, state_factory=fresh, injector=injector,
                timeline=timeline)


def _multi_process(args) -> bool:
    """Whether the run spans several processes: a launcher's environment
    of more than one rank, or ``--coordinator`` (``cli.py:611-613``)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 or (
        "WORLD_SIZE" not in os.environ and args.coordinator is not None)


def _join(args) -> torch.device:
    """Join the world (``mesh.init_distributed``: torchrun's environment,
    else ``--coordinator``); returns this rank's device."""
    try:
        device = mesh.init_distributed(args.coordinator, args.num_processes,
                                       args.process_id, args.device)
    except ValueError as e:
        raise SystemExit(f"ntxent-train (torch): {e}") from None
    return device if device is not None else mesh.init_from_env(args.device)


def _data_slices(args, world: int) -> None:
    """``--dcn-slices`` must divide the world (``cli.py:411-418``); a
    data-parallel world is one flat group whatever the slices."""
    if world % args.dcn_slices:
        raise SystemExit(f"--dcn-slices {args.dcn_slices} must divide the "
                         f"{world} devices")


def _world_size(args) -> int:
    """The world of a data-parallel run; ``--batch`` must divide over it."""
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
    elif "WORLD_SIZE" not in os.environ and args.coordinator is not None:
        world = args.num_processes or 1
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.batch % world:
        raise SystemExit(f"--batch {args.batch} must divide across {world} "
                         "devices")
    return world


def _train_clip_data_parallel(args, stats, injector, timeline):
    """The data-parallel CLIP branch (``cli.py:1338-1358``, ``--clip-parallel
    dp``): one rank per card (NCCL) or per CPU process (gloo), weights from
    ``--seed`` on every rank, each rank its rows of every global batch,
    the dual InfoNCE, rank 0 logging."""
    world = _world_size(args)
    device = _join(args)
    _data_slices(args, world)
    info = mesh.process_info()
    rank, lead = info["process_index"], info["process_index"] == 0
    images, tokens = _clip_data(args)
    if lead:
        _warn_clip_nan_policy(args)

    def fresh():
        state = create_clip_train_state(build_clip_model(args),
                                        _clip_config(args), device)
        return init_error_feedback(state) \
            if args.collective_dtype == "int8" else state

    loader = PairedArrayLoader(images, tokens, args.batch, seed=args.seed,
                               rank=rank, world_size=world)
    if lead:
        _wire_log(args)
        if args.measure_overlap:
            logger.warning("--measure-overlap ignored: the overlap A/B "
                           "measures the SimCLR data-parallel loss schedule")
        logger.info("topology: %s", info)
        logger.info("training %s data-parallel over %d ranks (%s, dual "
                    "InfoNCE): global batch %d, %d steps, peak lr %g",
                    _clip_label(args), world,
                    torch.distributed.get_backend(), args.batch, args.steps,
                    args.base_lr)
    state, history = _fit(args, fresh(),
                          PairedPipeline(loader, device, args.prefetch),
                          make_sharded_clip_train_step(
                              None, remat=args.remat,
                              collective_dtype=args.collective_dtype,
                              moe_aux_weight=_moe_aux(args)),
                          stats, views=1, ranks=world, log=lead,
                          state_factory=fresh, injector=injector,
                          timeline=timeline)
    if lead:
        _log_final(history)
    return state, history


def train(args, data_parallel: bool | None = None,
          checkpoint_stats: dict | None = None):
    """Train as ``train_main`` does from parsed ``args``; returns
    (TrainState, history). ``data_parallel=None`` takes the data-parallel
    branch when ``WORLD_SIZE`` > 1 in the environment; ``True`` takes it in
    any case, a world of one included (the process group is joined from
    the environment unless the caller joined one already).
    ``checkpoint_stats`` receives ``fit``'s checkpoint timings. The
    telemetry flags install their event log, metrics server and profiler
    for the run (``_setup_observability``) and close them at its end."""
    _check_train_args(args)
    injector = _make_injector(args)
    if args.objective == "clip":
        if args.loader != "python":
            logger.warning("--loader %s ignored: the CLIP objective uses "
                           "PairedArrayLoader", args.loader)
    else:
        _resolve_image_size(args)
    _check_stem(args)  # before a process group is joined
    if data_parallel is None:
        data_parallel = _multi_process(args)
        if not data_parallel and (args.num_processes is not None
                                  or args.process_id is not None):
            # as jax.distributed's auto-detection without a coordinator
            logger.info("no cluster environment detected; single-process "
                        "mode (--num-processes/--process-id need "
                        "--coordinator)")
    obs = _setup_observability(args)
    try:
        return _train(args, data_parallel, checkpoint_stats, injector,
                      obs.timeline)
    finally:
        obs.close()


def _train(args, data_parallel: bool, checkpoint_stats, injector,
           timeline):
    clip = args.objective == "clip"
    if clip:
        if args.parallel != "dp":
            logger.warning("--parallel %s ignored: the CLIP objective uses "
                           "--clip-parallel for its strategy", args.parallel)
        if args.tp_loss_axes != "data" and args.clip_parallel != "tp":
            logger.warning("--tp-loss-axes %s ignored: only --clip-parallel "
                           "tp runs shard the loss over the model axis",
                           args.tp_loss_axes)
    elif args.tp_loss_axes != "data" and not (data_parallel
                                              and args.parallel == "tp"):
        logger.warning("--tp-loss-axes %s ignored: only --parallel tp runs "
                       "shard the loss over the model axis",
                       args.tp_loss_axes)
    if data_parallel:
        tp = args.clip_parallel == "tp" if clip else args.parallel == "tp"
        if tp or args.fsdp:
            return _train_sharded(args, checkpoint_stats, injector, timeline,
                                  tp)
        if clip:
            return _train_clip_data_parallel(args, checkpoint_stats,
                                             injector, timeline)
        return _train_data_parallel(args, checkpoint_stats, injector,
                                    timeline)
    device = resolve_device(args.device)
    _warn_single_card(args, simclr=args.objective != "clip")
    if args.objective == "clip":
        state, history = _train_clip(args, device, checkpoint_stats,
                                     injector, timeline)
        _log_final(history)
        return state, history
    cfg = _train_config(args)

    def fresh():
        return create_train_state(build_model(args), cfg, device)

    step = make_train_step(cfg.temperature, remat=args.remat,
                           moe_aux_weight=_moe_aux(args),
                           guard=args.nan_policy != "off")
    logger.info("training %s on %s: batch %d, %d steps, peak lr %g",
                _model_label(args), device_name(device), args.batch,
                args.steps, cfg.learning_rate)
    state, history = _fit(args, fresh(),
                          _make_pipeline(args, device, injector=injector),
                          step, checkpoint_stats, state_factory=fresh,
                          step_guard=_make_step_guard(args.nan_policy),
                          injector=injector, timeline=timeline)
    _log_final(history)
    return state, history


def _train_config(args) -> TrainerConfig:
    return TrainerConfig(batch_size=args.batch, temperature=args.temperature,
                         base_lr=args.base_lr,
                         weight_decay=args.weight_decay,
                         warmup_steps=args.warmup_steps,
                         total_steps=args.steps,
                         accum_steps=args.accum_steps)


def _model_label(args) -> str:
    if args.model.startswith("vit"):
        return f"{args.model} ({args.vit_attention} attention)"
    return args.model


def _train_data_parallel(args, stats, injector, timeline):
    """The data-parallel branch (``cli.py:824-870``): one rank per card
    (NCCL) or per CPU process (gloo), weights from ``--seed`` on every
    rank, cross-replica BatchNorm, the ``--dp-loss`` schedule (strip,
    pair or chunked with ``--ring-chunks``), the ``--collective-dtype``
    wire (int8 with an error-feedback residual in the state), the
    ``--measure-overlap`` A/B before training (published on the timeline
    when there is one), rank 0 logging."""
    world = _world_size(args)
    device = _join(args)
    _data_slices(args, world)
    info = mesh.process_info()
    rank, lead = info["process_index"], info["process_index"] == 0
    cfg = _train_config(args)
    ring_chunks = args.ring_chunks if args.dp_loss == "chunked" else None
    if lead and args.ring_chunks is not None and args.dp_loss != "chunked":
        logger.warning("--ring-chunks %d ignored: --dp-loss %s has no ring "
                       "chunks (use --dp-loss chunked)", args.ring_chunks,
                       args.dp_loss)

    def fresh():
        model = cross_replica_batch_norm(build_model(args),
                                         torch.distributed.group.WORLD)
        state = create_train_state(model, cfg, device)
        return init_error_feedback(state) \
            if args.collective_dtype == "int8" else state

    step = make_sharded_train_step(None, cfg.temperature,
                                   loss_impl=args.dp_loss, remat=args.remat,
                                   guard=args.nan_policy != "off",
                                   collective_dtype=args.collective_dtype,
                                   ring_chunks=ring_chunks,
                                   moe_aux_weight=_moe_aux(args))
    if args.measure_overlap:
        overlap = measure_comms_overlap(None, args.batch // world,
                                        args.proj_dim,
                                        temperature=cfg.temperature,
                                        ring_chunks=ring_chunks,
                                        device=device, timeline=timeline)
        if lead:
            logger.info("comms overlap A/B: %s", overlap)
    if lead:
        _wire_log(args)
        logger.info("topology: %s", info)
        logger.info("training %s data-parallel over %d ranks (%s, %s "
                    "loss): global batch %d, %d steps, peak lr %g",
                    _model_label(args), world,
                    torch.distributed.get_backend(), args.dp_loss,
                    args.batch, args.steps, cfg.learning_rate)
    state, history = _fit(args, fresh(),
                          _make_pipeline(args, device, rank, world,
                                         injector),
                          step, stats, ranks=world, log=lead,
                          state_factory=fresh,
                          step_guard=_make_step_guard(args.nan_policy),
                          injector=injector, timeline=timeline)
    if lead:
        _log_final(history)
    return state, history


def _train_sharded(args, stats, injector, timeline, tp: bool):
    """The tensor-parallel (``--parallel tp`` / ``--clip-parallel tp``,
    with ``--fsdp`` Megatron + ZeRO-3) and ZeRO-3 (``--fsdp``) branches
    (``cli.py:720-830``, ``:1279-1335``): the grid's groups, the state
    placed by ``parallel.tp`` or ``parallel.fsdp`` (and again on every
    restart), each data rank its rows of every global batch, the JAX
    CLI's warnings and exits, rank 0 logging."""
    from .parallel.fsdp import (
        make_fsdp_clip_train_step,
        make_fsdp_train_step,
        shard_train_state_fsdp,
    )
    from .parallel.tp import (
        make_tp_clip_train_step,
        make_tp_simclr_train_step,
        shard_train_state,
        shard_train_state_tp_fsdp,
    )

    clip = args.objective == "clip"
    world = _world_size(args)
    if tp and args.dcn_slices > 1 and (args.fsdp or not clip):
        raise SystemExit(f"--dcn-slices > 1 does not compose with "
                         f"--{'clip-' if clip else ''}parallel tp yet (the "
                         "TP grid has no 'dcn' axis); use --"
                         f"{'clip-' if clip else ''}parallel dp")
    if tp and not clip and args.moe_experts > 0:
        raise SystemExit("--parallel tp does not collect the MoE aux loss "
                         "(make_tp_simclr_train_step); use --parallel dp for "
                         "MoE encoders")
    if tp and world % args.model_par:
        raise SystemExit(f"--model-par {args.model_par} must divide {world} "
                         "devices")
    if not tp:
        _data_slices(args, world)
    device = _join(args)
    lead = mesh.rank() == 0
    what = ("Megatron + ZeRO-3" if tp and args.fsdp else
            "Megatron TP" if tp else "FSDP (ZeRO-3)")
    if lead:
        if tp and not clip and not args.model.startswith("vit"):
            logger.warning("--parallel tp shards transformer weights only; "
                           "--model %s keeps everything replicated over the "
                           "model axis", args.model)
        if args.nan_policy != "off":
            logger.warning("--nan-policy %s ignored: the %s step carries no "
                           "in-step divergence guard yet; use data "
                           "parallelism for guarded runs", args.nan_policy,
                           what)
        if args.collective_dtype != "float32":
            logger.warning("--collective-dtype %s ignored: the %s step's "
                           "parameter and gradient collectives are not the "
                           "quantizable data-parallel wire",
                           args.collective_dtype, what)
        if args.measure_overlap:
            logger.warning("--measure-overlap ignored: the overlap A/B "
                           "measures the data-parallel loss schedule")
    dcn = None
    if tp:
        data_group, model_group = mesh.grid_groups(world // args.model_par,
                                                   args.model_par)
        rows, ranks = mesh.rank() // args.model_par, world // args.model_par
    elif args.dcn_slices > 1:
        dcn, data_group = mesh.grid_groups(args.dcn_slices,
                                           world // args.dcn_slices)
        rows, ranks = mesh.rank(), world
    else:
        data_group, rows, ranks = None, mesh.rank(), world

    def place(state):
        if tp and args.fsdp:
            return shard_train_state_tp_fsdp(state, model_group, data_group)
        if tp:
            return shard_train_state(state, model_group, data_group)
        return shard_train_state_fsdp(state, data_group, dcn_group=dcn)

    moe = _moe_aux(args)
    loss_axes = args.tp_loss_axes if tp else None
    if clip:
        images, tokens = _clip_data(args)

        def fresh():
            return place(create_clip_train_state(
                build_clip_model(args), _clip_config(args), device))

        step = (make_tp_clip_train_step(loss_axes=loss_axes,
                                        remat=args.remat,
                                        moe_aux_weight=moe) if tp
                else make_fsdp_clip_train_step(remat=args.remat,
                                               moe_aux_weight=moe))
        data = PairedPipeline(PairedArrayLoader(
            images, tokens, args.batch, seed=args.seed, rank=rows,
            world_size=ranks), device, args.prefetch)
        label, views, lr = _clip_label(args), 1, args.base_lr
    else:
        cfg = _train_config(args)

        def fresh():
            return place(create_train_state(build_model(args), cfg, device))

        ring_chunks = args.ring_chunks if args.dp_loss == "chunked" else None
        step = (make_tp_simclr_train_step(
                    cfg.temperature, loss_impl=args.dp_loss,
                    loss_axes=loss_axes, remat=args.remat,
                    ring_chunks=ring_chunks) if tp
                else make_fsdp_train_step(
                    cfg.temperature, loss_impl=args.dp_loss,
                    remat=args.remat, moe_aux_weight=moe,
                    ring_chunks=ring_chunks))
        data = _make_pipeline(args, device, rows, ranks, injector)
        label, views, lr = _model_label(args), 2, cfg.learning_rate
    if lead:
        logger.info("topology: %s", mesh.process_info())
        if dcn is not None:
            logger.info("hybrid ZeRO: params sharded over ICI axis 'data' "
                        "(size %d), replicated across %d slices",
                        world // args.dcn_slices, args.dcn_slices)
        grid = (f"the ({ranks}, {args.model_par}) (data, model) grid"
                if tp else f"{world} ranks")
        logger.info("training %s, %s over %s (%s): global batch %d, %d "
                    "steps, peak lr %g", label, what, grid,
                    torch.distributed.get_backend(), args.batch, args.steps,
                    lr)
    state, history = _fit(args, fresh(), data, step, stats, views=views,
                          ranks=ranks, log=lead, state_factory=fresh,
                          injector=injector, timeline=timeline)
    if lead:
        _log_final(history)
    return state, history


def _fit(args, state, data, step, stats: dict | None, views: int = 2,
         ranks: int = 1, log: bool = True, state_factory=None,
         step_guard: DivergenceGuard | None = None,
         injector: FaultInjector | None = None, timeline=None):
    """``training.fit`` with the checkpoint and resilience flags
    (``cli.py:949-1140``). Without ``--max-restarts`` or ``--chaos``: one
    ``fit`` under a ``PreemptionGuard`` (a SIGTERM ends the run at the
    next step boundary with the stopped step saved, and the run returns
    normally, exit 0), with ``--stall-timeout``'s watchdog when set.
    Otherwise a ``Supervisor`` runs attempts of ``fit``, each on a fresh
    state from ``state_factory`` after the first, the data chaos-wrapped
    when ``injector`` is given; a run that does not reach ``--steps``
    exits 1. ``timeline`` (``_setup_observability``) goes to every
    attempt's ``fit``."""
    keep_last = args.ckpt_keep_last
    kwargs = dict(
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        log_every=args.log_every,
        checkpoint_retry_policy=RetryPolicy(
            max_attempts=3, base_delay_s=0.5, max_delay_s=10.0,
            seed=args.seed),
        checkpoint_verify_writes=not args.no_ckpt_verify,
        async_checkpointing=args.async_ckpt,
        checkpoint_keep_last=keep_last if keep_last else None,
        checkpoint_keep_every=args.ckpt_keep_every,
        checkpoint_mirror=args.ckpt_mirror, views=views, ranks=ranks,
        log=log, checkpoint_stats=stats, step_guard=step_guard,
        checkpoint_fault_hook=(injector.on_checkpoint_write
                               if injector is not None else None),
        metrics_lag=1 if args.lag_metrics else 0,
        checkpoint_save_ef=args.ckpt_save_ef, timeline=timeline)
    if args.lag_metrics and log:
        logger.info("lag-1 metrics drain: guard/telemetry reads run one "
                    "step behind dispatch")
    if args.max_restarts <= 0 and injector is None:
        watchdog = (StallWatchdog(timeout_s=args.stall_timeout)
                    if args.stall_timeout else None)
        with PreemptionGuard() as guard, \
                (watchdog or contextlib.nullcontext()):
            state, history = fit(state, data, step, args.steps,
                                 stop_fn=guard.requested, watchdog=watchdog,
                                 restore_step=args.restore_step, **kwargs)
        if guard.preempted and log:
            if args.ckpt_dir is None:
                logger.warning("run was preempted at step %d; without "
                               "--ckpt-dir nothing was saved", state.step)
            else:
                logger.warning("run was preempted; checkpoint saved at "
                               "step %d — relaunch with the same flags to "
                               "resume", state.step)
        return state, history

    if args.ckpt_dir is None and log:
        logger.warning("supervised run without --ckpt-dir: every restart "
                       "begins again from step 0 (no checkpoint to resume "
                       "from)")
    if injector is not None:
        data = injector.wrap_iterator(data)
    # attempt 0 trains the state given (no other reference keeps it
    # alive); every later attempt a fresh one that fit restores into, so
    # no tensor of a crashed attempt is reused
    first, state = [state], None

    def run_attempt(attempt, stop_fn, watchdog):
        s = first.pop() if first else state_factory()
        if step_guard is not None:
            step_guard.reset_attempt()
        return fit(s, data, step, args.steps, stop_fn=stop_fn,
                   watchdog=watchdog,
                   restore_step=args.restore_step if attempt == 0 else None,
                   **kwargs)

    # only rank 0 corrupts the shared directory between attempts
    supervisor = Supervisor(
        run_attempt, num_steps=args.steps,
        checkpoint_dir=args.ckpt_dir if mesh.rank() == 0 else None,
        max_restarts=args.max_restarts, stall_timeout_s=args.stall_timeout,
        injector=injector)
    result = supervisor.run()
    if log and injector is not None and injector.fired:
        logger.info("chaos faults fired: %s", ", ".join(injector.fired))
    if log and step_guard is not None:
        logger.info("divergence guard: %s", step_guard.stats)
    if not result.completed:
        logger.error("supervised run did NOT reach step %d (restart budget "
                     "of %d spent)", args.steps, args.max_restarts)
        raise SystemExit(1)
    return result.state, result.history


class _ObsContext:
    """What the telemetry flags wired up (inert when none was given);
    ``train`` closes it at the end of the run."""

    def __init__(self):
        self.event_log = None
        self.server = None
        self.profiler = None
        self.timeline = None

    def close(self) -> None:
        if self.timeline is not None:
            self.timeline.close()  # ends a capture in flight
        if self.server is not None:
            self.server.close()
        if self.event_log is not None:
            obs_events.install(None)
            self.event_log.close()


def _setup_observability(args) -> _ObsContext:
    """Telemetry from the observability flags (``cli.py:474-506``). Any
    one of them installs an event log process-wide (so the checkpoint and
    resilience layers publish events even with only ``--metrics-port``)
    and gives the run a ``StepTimeline``. With none, training keeps the
    fast path: no timeline, no per-step sync, no FLOP count. In a world of
    several ranks only rank 0 wires telemetry, as only it logs."""
    ctx = _ObsContext()
    if args.metrics_port is None and not args.log_jsonl \
            and not args.trace_dir:
        return ctx
    if int(os.environ.get("RANK", args.process_id or 0)) != 0:
        return ctx  # a rank of torchrun's or of --coordinator's world
    ctx.event_log = obs_events.EventLog(args.log_jsonl)
    obs_events.install(ctx.event_log)
    logger.info("telemetry: run_id=%s%s", ctx.event_log.run_id,
                f" events -> {args.log_jsonl}" if args.log_jsonl else "")
    if args.metrics_port is not None:
        ctx.server = MetricsServer(port=args.metrics_port).start()
    if args.trace_dir:
        ctx.profiler = ProfilerTrigger(
            args.trace_dir, slow_factor=args.slow_step_factor,
            capture_steps=args.trace_steps)
        ctx.profiler.install_sigusr2()
        logger.info("profiler armed: traces -> %s (touch %s or SIGUSR2 "
                    "for a manual capture)", args.trace_dir,
                    ctx.profiler.trigger_file)
    ctx.timeline = StepTimeline(profiler=ctx.profiler)
    return ctx


def _log_final(history) -> None:
    if history:
        last = history[-1]
        logger.info("final: step %d loss %.4f (%.2f steps/s)", last["step"],
                    last["loss"], last["steps_per_sec"])


def train_main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    try:
        train(build_train_parser().parse_args(argv))
    finally:
        mesh.shutdown()
    return 0


# --------------------------------------------------------------------------
# ntxent-eval
# --------------------------------------------------------------------------

def build_eval_parser() -> argparse.ArgumentParser:
    """Every flag of the JAX CLI's ``ntxent-eval`` (``cli.py:2564-2611``)
    and ``--device``."""
    p = argparse.ArgumentParser(
        prog="ntxent-eval (torch)",
        description="SSL evaluation of a pretrained checkpoint (either "
                    "package's): linear probe, weighted kNN, fine-tuning "
                    "or CLIP zero-shot, on PyTorch/CUDA")
    _add_common_args(p)  # model/proj flags must match the training run
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--objective", default="simclr",
                   choices=["simclr", "clip"],
                   help="what the checkpoint was trained with; clip "
                        "evaluates the projected, L2-normalized image "
                        "embeddings (encode_image) and needs --vocab-size "
                        "and --token-len to match the run")
    p.add_argument("--vocab-size", type=int, default=49408)
    p.add_argument("--token-len", type=int, default=77)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="match the training run's value (it shapes the "
                        "checkpoint's optimizer state)")
    p.add_argument("--protocol", default="both",
                   choices=["probe", "knn", "both", "finetune", "zeroshot"],
                   help="frozen-feature probe / kNN; finetune: the whole "
                        "encoder (SimCLR checkpoints); zeroshot: CLIP "
                        "checkpoints classify test images by the nearest "
                        "class-prompt embedding (--class-tokens)")
    p.add_argument("--class-tokens", default=None, metavar="NPY",
                   help="zeroshot: (num_classes, token_len) int array of "
                        "tokenized class prompts saved by np.save; row i "
                        "is the prompt of label i")
    p.add_argument("--finetune-steps", type=int, default=500)
    p.add_argument("--finetune-lr", type=float, default=1e-3)
    p.add_argument("--finetune-batch", type=int, default=64,
                   help="fine-tuning minibatch (full backprop through the "
                        "encoder)")
    p.add_argument("--batch", type=int, default=256,
                   help="feature-extraction batch")
    p.add_argument("--probe-steps", type=int, default=500)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--max-train", type=int, default=10000,
                   help="subsample caps keep eval wall time bounded")
    p.add_argument("--max-test", type=int, default=2000)
    return p


def _labeled_arrays(args, test_only: bool = False):
    """(train_images, train_labels, test_images, test_labels), float32
    NHWC in [0, 1] (``cli.py:2612-2692``): CIFAR-10's train and test
    batches, an image folder's even and odd images (the caps applied to
    the indices before decoding), or 512 synthetic images of 4 classes
    with a class-dependent mean shift (384 train, 128 test); then the
    caps. ``test_only`` loads no train split."""
    def subsample(images, labels, cap, seed):
        if cap and len(images) > cap:
            idx = np.random.RandomState(seed).choice(
                len(images), cap, replace=False)
            return images[idx], labels[idx]
        return images, labels

    def empty_like(x, y):
        return (np.zeros((0,) + x.shape[1:], x.dtype),
                np.zeros((0,), y.dtype))

    if args.dataset == "cifar10":
        if args.data_dir is None:
            raise SystemExit("--dataset cifar10 requires --data-dir")
        te = Cifar10Source(args.data_dir, train=False)
        xte, yte = te.images, te.labels
        if test_only:
            xtr, ytr = empty_like(xte, yte)
        else:
            tr = Cifar10Source(args.data_dir, train=True)
            xtr, ytr = tr.images, tr.labels
    elif args.dataset == "imagefolder":
        if args.data_dir is None:
            raise SystemExit("--dataset imagefolder requires --data-dir")
        src = ImageFolderSource(args.data_dir, image_size=args.image_size)

        def pick(idxs, cap, seed):
            if cap and len(idxs) > cap:
                idxs = np.random.RandomState(seed).choice(
                    idxs, cap, replace=False)
            return np.sort(idxs)

        te_idx = pick(np.arange(1, len(src), 2), args.max_test,
                      args.seed + 1)
        if len(te_idx) == 0:
            raise SystemExit(
                f"imagefolder {args.data_dir} has no test images (the "
                "odd-index half is empty); need at least 2 images")
        xte = np.stack([src[int(i)] for i in te_idx])
        yte = src.labels[te_idx]
        if test_only:
            xtr, ytr = empty_like(xte, yte)
        else:
            tr_idx = pick(np.arange(0, len(src), 2), args.max_train,
                          args.seed)
            xtr = np.stack([src[int(i)] for i in tr_idx])
            ytr = src.labels[tr_idx]
    elif args.dataset == "npy":
        raise SystemExit("--dataset npy has no labels; evaluation needs "
                         "cifar10 or imagefolder")
    else:
        rng = np.random.RandomState(args.seed)
        n, s = 512, args.image_size
        labels = rng.randint(0, 4, n).astype(np.int32)
        # a class-dependent mean shift makes the synthetic task learnable
        imgs = (rng.rand(n, s, s, 3) * 0.5
                + labels[:, None, None, None] * 0.125).astype(np.float32)
        xtr, ytr = imgs[:384], labels[:384]
        xte, yte = imgs[384:], labels[384:]
    xtr, ytr = subsample(xtr, ytr, args.max_train, args.seed)
    xte, yte = subsample(xte, yte, args.max_test, args.seed + 1)

    def to_f32(x):
        return (x.astype(np.float32) / 255.0 if x.dtype == np.uint8
                else x.astype(np.float32))

    return to_f32(xtr), ytr, to_f32(xte), yte


def _check_eval_args(args) -> str | None:
    """The JAX CLI's early refusals (``cli.py:2699-2717``): the message of
    a protocol that does not fit the objective, else None. Exits on
    ``--moe-experts`` without a ViT, as building the encoder does."""
    if args.protocol == "finetune" and args.objective == "clip":
        return ("--protocol finetune needs a SimCLR-objective checkpoint "
                "(an encoder with a features method)")
    if args.protocol == "zeroshot":
        if args.objective != "clip":
            return ("--protocol zeroshot needs a CLIP-objective checkpoint "
                    "(a text tower to embed the class prompts); got "
                    f"--objective {args.objective}")
        if not args.class_tokens:
            return ("--protocol zeroshot requires --class-tokens "
                    "(pre-tokenized class prompts; see --help)")
    _apply_platform(args)
    _check_moe(args)
    if args.objective == "clip" and args.model.startswith("resnet"):
        raise SystemExit("--objective clip checkpoints have ViT image "
                         "towers (--model vit_*|tiny); no resnet CLIP "
                         "checkpoint can exist")
    return None


def eval_model(args, device):
    """The model of ``args`` (SimCLR or CLIP) with the newest step of
    ``--ckpt-dir`` restored into the train state its run wrote (the
    optimizer's layout from ``--accum-steps``), in eval mode; returns
    (model, step)."""
    if args.image_size is None:
        args.image_size = 224 if args.dataset == "imagefolder" else 32
    config = TrainerConfig(accum_steps=args.accum_steps)
    if args.objective == "clip":
        state = create_clip_train_state(build_clip_model(args), config,
                                        device)
    else:
        state = create_train_state(build_model(args), config, device)
    if not os.path.isdir(args.ckpt_dir) \
            or CheckpointManager(args.ckpt_dir).latest_step() is None:
        raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
    manager = CheckpointManager(args.ckpt_dir)
    try:
        state = manager.restore(state)
    finally:
        manager.close()
    logger.info("restored step %d from %s", state.step, args.ckpt_dir)
    return state.model.eval(), state.step


def _zeroshot(args, model, step: int, device) -> dict:
    """CLIP zero-shot top-1 (``cli.py:2813-2869``): each test image takes
    the label of its nearest class-prompt embedding; every row of
    ``--class-tokens`` competes, and only the test split is loaded."""
    toks = np.load(args.class_tokens)
    if toks.ndim != 2 or not np.issubdtype(toks.dtype, np.integer):
        raise SystemExit(f"--class-tokens must be a 2-D integer array; got "
                         f"{toks.dtype} {toks.shape}")
    if toks.shape[1] != args.token_len:
        raise SystemExit(f"--class-tokens rows are {toks.shape[1]} tokens "
                         f"but the checkpoint's text tower takes "
                         f"--token-len {args.token_len}")
    if int(toks.min()) < 0 or int(toks.max()) >= args.vocab_size:
        raise SystemExit(f"--class-tokens ids must be in [0, "
                         f"{args.vocab_size}); got range "
                         f"[{int(toks.min())}, {int(toks.max())}]")
    _, _, xte, yte = _labeled_arrays(args, test_only=True)
    n_prompt = int(toks.shape[0])
    if len(yte) == 0:
        raise SystemExit("zero-shot eval needs a non-empty test split; got "
                         "0 test examples (check the dataset's test half)")
    if int(yte.max()) >= n_prompt:
        raise SystemExit(f"test labels reach {int(yte.max())} but "
                         f"--class-tokens has only {n_prompt} prompt rows "
                         "(row i = label i)")
    with torch.no_grad():
        # both encoders L2-normalize: the product is the cosine similarity
        text = model.encode_text(torch.as_tensor(toks, device=device).long())
        fte = extract_features(model.encode_image, xte, args.batch, device)
        pred = (fte.float() @ text.float().T).argmax(1).cpu().numpy()
    acc = float(np.mean(pred == yte))
    logger.info("zero-shot top-1: %.4f over %d prompt classes", acc,
                n_prompt)
    return {"step": step, "zeroshot_top1": acc, "num_classes": n_prompt,
            "num_test": int(len(yte))}


def evaluate(args) -> dict:
    """``eval_main``'s work from parsed ``args`` (refusals checked);
    returns the JSON record it prints."""
    device = resolve_device(args.device)
    model, step = eval_model(args, device)
    if args.protocol == "zeroshot":
        return _zeroshot(args, model, step, device)
    xtr, ytr, xte, yte = _labeled_arrays(args)
    num_classes = int(max(int(ytr.max()), int(yte.max()))) + 1
    generator = torch.Generator().manual_seed(args.seed)
    if args.protocol == "finetune":
        res = finetune(model, xtr, ytr, xte, yte, num_classes,
                       steps=args.finetune_steps,
                       batch_size=args.finetune_batch,
                       learning_rate=args.finetune_lr, generator=generator)
        logger.info("finetune top-1: %.4f", res["test_accuracy"])
        return {"step": step, "finetune_top1": res["test_accuracy"],
                "finetune_train_top1": res["train_accuracy"],
                "finetune_loss": res["final_loss"]}
    apply_features = (model.encode_image if args.objective == "clip"
                      else model.features)
    feats = extract_features(apply_features, np.concatenate([xtr, xte]),
                             args.batch, device).float()
    ftr, fte = feats[:len(xtr)], feats[len(xtr):]
    logger.info("features: train %s test %s, %d classes",
                tuple(ftr.shape), tuple(fte.shape), num_classes)
    results = {"step": step}
    if args.protocol in ("knn", "both"):
        results["knn_top1"] = knn_accuracy(ftr, ytr, fte, yte, k=args.k)
        logger.info("kNN (k=%d) top-1: %.4f", args.k, results["knn_top1"])
    if args.protocol in ("probe", "both"):
        probe = linear_probe(ftr, ytr, fte, yte, num_classes,
                             steps=args.probe_steps, generator=generator)
        results["probe_top1"] = probe["test_accuracy"]
        logger.info("linear probe top-1: %.4f", results["probe_top1"])
    return results


def eval_main(argv=None) -> int:
    """``ntxent-eval``: restore ``--ckpt-dir``, run ``--protocol``, print
    one JSON line (``cli.py:2694-2908``)."""
    args = build_eval_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    refusal = _check_eval_args(args)
    if refusal is not None:
        logger.error(refusal)
        return 2
    print(json.dumps(evaluate(args)), flush=True)
    return 0


def main(argv=None) -> int:
    """``train ...`` runs ``train_main``, ``eval ...`` ``eval_main``;
    anything else ``serve_main``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["train"]:
        return train_main(argv[1:])
    if argv[:1] == ["eval"]:
        return eval_main(argv[1:])
    return serve_main(argv)


if __name__ == "__main__":
    sys.exit(main())
