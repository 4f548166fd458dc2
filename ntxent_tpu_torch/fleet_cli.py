"""The serving fleet's command line, counterpart of ``ntxent-fleet``
(``ntxent_tpu/cli.py:1721-2561``): a router process over N supervised
workers of the port's serve, in one command.

``python -m ntxent_tpu_torch.fleet_cli --model vit_b16 --vit-attention
flash --image-size 224 --head embedding --buckets 1,4,16,64 --workers 2
--ckpt-dir DIR`` starts the router (``serving.router.FleetRouter`` with its
``serving.cache.EmbeddingCache``, the canary and shadow verdicts of
``WorkerPool`` and ``serving.shadow.ShadowMirror``, ``TenantAdmission``)
over ``serving.fleet.ServingFleet``, which spawns each worker as ``python
-m ntxent_tpu_torch.cli <serve flags>`` with ``--port-file`` and, given
``--ckpt-dir``, ``--watch-ckpt`` (worker i waits ``i x --worker-stagger``
seconds before it adopts a new step, so the earliest is the canary).
``--fed-interval`` federates the workers' ``/metrics?format=state`` into
``/metrics/fleet`` and records ``/metrics/history`` (``--history-dir``
spills it); ``--slo-*`` page through ``/alerts``; ``--autoscale`` sizes
the pool; ``--chaos`` fires ``killworker``, ``slowworker``, ``spike`` and
``drainworker`` on supervision ticks, and ``killshard`` and ``lagshard``
on the shard fleet's. ``--index-mem`` or ``--index-dir`` attach the
retrieval tier (``retrieval.IndexManager``: ``POST /search``,
``/index/insert``, ``/embed?store=true``, ``GET /index``);
``--search-shards N`` fans searches out over N shard servers
(``retrieval.ShardFanout``), with ``--shard-procs`` as supervised ``python
-m ntxent_tpu_torch.retrieval.shard`` subprocesses on fixed ports, their
inserts journaled (``--shard-journal-dir``) and repaired. A SIGTERM drains
the fleet and exits 0.

The router process imports no torch (this module, ``obs``, ``serving``'s
router tier, ``retrieval`` and ``resilience.faults`` load stdlib and numpy
only), and neither does a shard process, so the router
starts and restarts in well under a second. ``cli.main(["fleet", ...])``
and ``cli.fleet_main`` reach the same entry.

Every flag of ``ntxent-fleet`` parses, with the JAX CLI's defaults,
exits and warnings.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .cli_common import MODEL_CHOICES, PLATFORM_DEVICES

logger = logging.getLogger(__name__)

__all__ = ["build_fleet_parser", "fleet_main"]

def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ntxent-fleet (torch)",
        description="Serving fleet: a fault-tolerant router tier over N "
                    "supervised worker replicas of the port's serve "
                    "(python -m ntxent_tpu_torch.cli) — embedding cache, "
                    "per-request retry failover, 429 load shedding, "
                    "canaried zero-downtime checkpoint rollout "
                    "(ntxent_tpu_torch/serving/{router,fleet,cache,"
                    "shadow,autoscale}.py). The router process imports no "
                    "torch")
    m = p.add_argument_group("model (forwarded to every worker)")
    m.add_argument("--model", default="resnet50", choices=MODEL_CHOICES)
    m.add_argument("--image-size", type=int, default=32)
    m.add_argument("--stem", default="conv",
                   choices=["conv", "space_to_depth"])
    m.add_argument("--vit-attention", default="xla",
                   choices=["xla", "flash"])
    m.add_argument("--proj-hidden-dim", type=int, default=2048)
    m.add_argument("--proj-dim", type=int, default=128)
    m.add_argument("--head", default="features",
                   choices=["features", "embedding"])
    m.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir the workers restore from AND "
                        "watch for new steps (zero-downtime rollout); "
                        "omit for random weights (smoke/load tests)")
    m.add_argument("--accum-steps", type=int, default=1)

    w = p.add_argument_group("workers")
    w.add_argument("--workers", type=int, default=2,
                   help="worker replica count")
    w.add_argument("--buckets", default="1,4,16,64,128")
    w.add_argument("--adaptive-buckets", action="store_true",
                   help="each worker learns its ladder from its own "
                        "traffic (serve --adaptive-buckets); "
                        "workers adapt independently — the router's "
                        "cache keys hash row content, never buckets, "
                        "so per-worker ladders cannot skew routing or "
                        "caching")
    w.add_argument("--ladder-max-buckets", type=int, default=6)
    w.add_argument("--ladder-min-requests", type=int, default=200)
    w.add_argument("--ladder-interval", type=float, default=2.0)
    w.add_argument("--max-batch", type=int, default=None)
    w.add_argument("--max-delay-ms", type=float, default=5.0)
    w.add_argument("--queue-size", type=int, default=64)
    w.add_argument("--timeout-ms", type=float, default=10000.0)
    w.add_argument("--max-request-rows", type=int, default=None)
    w.add_argument("--dtype", "--serve-dtype", dest="dtype",
                   default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="forwarded to every worker (int8 = quantized "
                        "rungs, see serve --dtype)")
    w.add_argument("--stall-timeout", type=float, default=None)
    w.add_argument("--watch-poll", type=float, default=2.0,
                   help="worker checkpoint-watch poll interval")
    w.add_argument("--worker-stagger", type=float, default=3.0,
                   metavar="SECONDS",
                   help="per-worker delay step before adopting a new "
                        "checkpoint (worker i waits i*stagger): the "
                        "earliest adopter is the router's canary "
                        "cohort")

    rt = p.add_argument_group("router")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=8080,
                    help="router port (0 picks a free one)")
    rt.add_argument("--port-file", default=None, metavar="PATH",
                    help="publish the router's bound port to this file")
    rt.add_argument("--retries", type=int, default=2,
                    help="per-request failover budget: extra workers "
                         "tried after a 5xx/unreachable forward")
    rt.add_argument("--forward-timeout", type=float, default=30.0)
    rt.add_argument("--cache-rows", type=int, default=4096,
                    help="embedding cache LRU capacity in rows")
    rt.add_argument("--cache-ttl", type=float, default=300.0,
                    help="embedding cache TTL seconds")
    rt.add_argument("--cache-warm-rows", type=int, default=32,
                    help="hot rows replayed through a newly promoted "
                         "model right after the promote flush "
                         "(0 = boot the cache cold as before)")
    rt.add_argument("--no-cache", action="store_true")
    rt.add_argument("--canary-fraction", type=float, default=0.25,
                    help="traffic fraction routed to new-checkpoint "
                         "workers while their canary is undecided")
    rt.add_argument("--canary-min-requests", type=int, default=20,
                    help="canary outcomes before a promote/rollback "
                         "verdict")
    rt.add_argument("--canary-max-error-rate", type=float, default=0.1,
                    help="canary error rate above which the step is "
                         "rolled back fleet-wide")
    rt.add_argument("--shadow-fraction", type=float, default=0.0,
                    help="shadow routing: mirror this "
                         "fraction of trusted-cohort traffic to the "
                         "undecided canary OFF the client's critical "
                         "path and diff the embeddings per row "
                         "(cosine distance); 0 disables")
    rt.add_argument("--shadow-max-drift", type=float, default=0.05,
                    help="drift bar: promote requires mirrored-traffic "
                         "drift p99 at or under this cosine distance "
                         "(in addition to the error-rate bar); a "
                         "breach rolls the canary back")
    rt.add_argument("--shadow-min-samples", type=int, default=8,
                    help="mirrored rows diffed before the drift bar "
                         "can judge (the verdict defers until then)")

    ix = p.add_argument_group("retrieval (ntxent_tpu_torch/retrieval/: "
                              "checkpoint-step-versioned ANN index "
                              "over served embeddings — POST /search)")
    ix.add_argument("--index-dir", default=None, metavar="DIR",
                    help="enable the retrieval tier with segment "
                         "persistence under DIR (per-step subdirs; "
                         "stage-fsync-rename sealing). POST /search, "
                         "/index/insert and /embed?store=true go live")
    ix.add_argument("--index-mem", action="store_true",
                    help="enable the retrieval tier fully in memory "
                         "(no segment persistence — smoke/load tests)")
    ix.add_argument("--index-train-rows", type=int, default=2048,
                    metavar="N",
                    help="rows before IVF centroids train; below this "
                         "search is exact brute force (perfect recall "
                         "while small)")
    ix.add_argument("--index-centroids", type=int, default=64,
                    help="IVF list count once trained")
    ix.add_argument("--index-nprobe", type=int, default=16,
                    help="IVF lists scanned per query")
    ix.add_argument("--index-seal-rows", type=int, default=4096,
                    help="mutable-segment rows before a seal to disk")
    ix.add_argument("--index-docstore-rows", type=int, default=65536,
                    help="input rows retained for background "
                         "re-embedding rebuilds (promote/stale); past "
                         "the bound the oldest are evicted")
    ix.add_argument("--index-maintain-interval", type=float,
                    default=2.0, metavar="SECONDS",
                    help="background maintenance tick (train/seal/"
                         "compact/recall probe)")
    ix.add_argument("--index-pq-m", type=int, default=8, metavar="M",
                    help="PQ code bytes per row (0 = raw "
                         "IVF-flat); sealed segments carry "
                         "codes, searches ADC-scan + exact re-rank")
    ix.add_argument("--search-shards", type=int, default=0,
                    metavar="N",
                    help="start N shard servers and fan /search out "
                         "across them (IVF lists placed by rendezvous "
                         "hash over the ring; a dead shard degrades "
                         "recall, never availability, and its rows "
                         "are journaled + repaired on restart)")
    ix.add_argument("--shard-procs", action="store_true",
                    help="run --search-shards workers as supervised "
                         "SUBPROCESSES (readiness probe, eject-after-"
                         "streak, backoff restart) instead of "
                         "in-process servers; a restarted shard is "
                         "refilled from the insert journal")
    ix.add_argument("--shard-journal-dir", default=None, metavar="DIR",
                    help="durable per-shard insert journal (default: "
                         "in-memory): every routed batch is logged "
                         "before delivery, so rows a dead shard "
                         "missed are replayed by the repair loop")
    ix.add_argument("--shard-repair-interval", type=float, default=1.0,
                    metavar="SECONDS",
                    help="repair-loop tick: probe dead shards, drain "
                         "journal debt through the insert path")

    f = p.add_argument_group("fleet supervision")
    f.add_argument("--workdir", default=None,
                   help="port files + per-worker logs (default: a "
                        "temp dir)")
    f.add_argument("--attach-workdir", default=None, metavar="PATH",
                   help="REPLICA router mode: spawn no workers — "
                        "attach to the worker pool a primary "
                        "ntxent-fleet already runs in PATH (its w*.port "
                        "files), probe health, and route. N routers "
                        "over one pool is the stateless-router "
                        "replication proof; "
                        "process supervision stays with the primary")
    f.add_argument("--health-poll", type=float, default=0.5,
                   help="supervision tick: /readyz probe interval")
    f.add_argument("--eject-after", type=int, default=3,
                   help="consecutive probe/forward failures before a "
                        "worker is killed and restarted")
    f.add_argument("--worker-max-restarts", type=int, default=8,
                   help="per-worker restart budget")
    f.add_argument("--chaos", default=None, metavar="PLAN",
                   help="fleet fault plan, e.g. 'killworker@10,"
                        "slowworker@30,spike@20,drainworker@40,"
                        "killshard@15,lagshard@25' (ordinals are "
                        "supervision ticks; resilience/faults.py "
                        "grammar; spike/drainworker exercise the "
                        "autoscaler and need --autoscale; killshard/"
                        "lagshard hit the shard plane and need "
                        "--shard-procs)")

    a = p.add_argument_group("autoscaling (closed-loop pool "
                             "sizing over the federated signals — "
                             "serving/autoscale.py; scale-down drains "
                             "to zero in-flight before SIGTERM)")
    a.add_argument("--autoscale", action="store_true",
                   help="size the pool between --min-workers and "
                        "--max-workers from queue depth / in-flight / "
                        "p99 / burn rate (requires federation, "
                        "--fed-interval > 0; --workers is then the "
                        "STARTING size)")
    a.add_argument("--min-workers", type=int, default=None,
                   help="pool floor (default: 1)")
    a.add_argument("--max-workers", type=int, default=None,
                   help="pool ceiling (default: max(--workers, 4))")
    a.add_argument("--scale-up-queue", type=float, default=8.0,
                   help="federated queue depth per routable worker "
                        "that counts as scale-up pressure")
    a.add_argument("--scale-up-inflight", type=float, default=4.0,
                   help="router in-flight per routable worker that "
                        "counts as scale-up pressure")
    a.add_argument("--scale-up-p99-ms", type=float, default=None,
                   help="fleet p99 (ms) that counts as scale-up "
                        "pressure (default: off)")
    a.add_argument("--scale-up-burn", type=float, default=1.0,
                   help="availability burn rate (vs --scale-slo-target "
                        "budget) that counts as scale-up pressure")
    a.add_argument("--scale-slo-target", type=float, default=0.999,
                   help="availability target whose error budget the "
                        "scale-up burn signal is measured against")
    a.add_argument("--scale-up-ticks", type=int, default=2,
                   help="consecutive pressure ticks before adding a "
                        "worker (hysteresis)")
    a.add_argument("--scale-idle-ticks", type=int, default=6,
                   help="consecutive idle ticks before draining one "
                        "(hysteresis)")
    a.add_argument("--scale-up-cooldown", type=float, default=15.0,
                   metavar="SECONDS")
    a.add_argument("--scale-down-cooldown", type=float, default=30.0,
                   metavar="SECONDS")
    a.add_argument("--drain-deadline", type=float, default=30.0,
                   metavar="SECONDS",
                   help="max drain wait before a still-busy victim is "
                        "retired anyway")
    a.add_argument("--predict-horizon", type=float, default=None,
                   metavar="SECONDS",
                   help="predictive scale-up: feed Holt-"
                        "Winters forecasters the request-rate and "
                        "queue-depth series and treat the PROJECTED "
                        "value this many seconds out as scale-up "
                        "pressure ('forecast' reason) — capacity "
                        "arrives before a diurnal ramp breaches. "
                        "Scale-down stays purely reactive. Requires "
                        "--autoscale")
    a.add_argument("--predict-capacity", type=float, default=None,
                   metavar="REQ_S",
                   help="rated per-worker throughput (req/s) the "
                        "forecast rate signal is judged against "
                        "(default: off — only the forecast queue-"
                        "depth signal fires)")
    a.add_argument("--predict-season", type=float, default=None,
                   metavar="SECONDS",
                   help="seasonal period for the forecasters (e.g. "
                        "86400 for a diurnal cycle; default: trend "
                        "only)")
    a.add_argument("--scale-up-rss-bytes", type=float, default=None,
                   metavar="BYTES",
                   help="worker vertical memory pressure: "
                        "federated max serving_worker_rss_bytes at or "
                        "over this counts as scale-up pressure "
                        "(default: off)")
    a.add_argument("--tenant-quota", default=None,
                   metavar="NAME=RATE[:BURST],...",
                   help="arm per-tenant admission control (X-Tenant "
                        "header; rows/s token buckets; 429 + "
                        "Retry-After on exhaustion). The tenant named "
                        "'default' sets the quota every unlisted "
                        "tenant gets, e.g. "
                        "'default=100,big=1000:2000'. Works with or "
                        "without --autoscale")

    o = p.add_argument_group("observability (ntxent_tpu_torch/obs/)")
    o.add_argument("--log-jsonl", default=None, metavar="PATH",
                   help="router-side typed JSONL events (fleet.request/"
                        "fleet.cache/fleet.forward/fleet.shadow spans; "
                        "workers log to <workdir>/wN.jsonl with the "
                        "same run id — stitch them with "
                        "`python -m ntxent_tpu_torch.obs.trace --merge`)")
    o.add_argument("--run-id", default=None, metavar="ID")
    o.add_argument("--fed-interval", type=float, default=2.0,
                   metavar="SECONDS",
                   help="metric-federation tick: how often the router "
                        "scrapes every worker's /metrics?format=state "
                        "into the merged /metrics/fleet view (and "
                        "evaluates SLOs); 0 disables federation")
    o.add_argument("--slo-availability", type=float, default=None,
                   metavar="TARGET",
                   help="availability SLO target (e.g. 0.99): alert "
                        "when the router-edge failure rate burns the "
                        "error budget faster than --slo-burn-factor "
                        "over BOTH burn windows (obs/slo.py)")
    o.add_argument("--slo-latency-ms", type=float, default=None,
                   metavar="MS",
                   help="p99 latency SLO bound on the router's "
                        "fleet_latency_ms{stage=total}")
    o.add_argument("--slo-drift", type=float, default=None,
                   metavar="DIST",
                   help="drift SLO bound on fleet_shadow_drift p99 "
                        "(alerting view of the shadow bar)")
    o.add_argument("--slo-retrieval-degraded", type=float, default=None,
                   metavar="TARGET",
                   help="retrieval health SLO target (e.g. 0.99): "
                        "alert when the fraction of searches served "
                        "degraded (shard timeouts/failures) burns the "
                        "budget over both windows")
    o.add_argument("--slo-fast-window", type=float, default=60.0,
                   metavar="SECONDS")
    o.add_argument("--slo-slow-window", type=float, default=300.0,
                   metavar="SECONDS")
    o.add_argument("--slo-burn-factor", type=float, default=2.0,
                   help="error-budget burn multiple that pages")
    o.add_argument("--history-dir", default=None, metavar="DIR",
                   help="durable spill directory for the metrics-"
                        "history plane: the per-series "
                        "rollup store survives router restarts via "
                        "stage-fsync-rename (default: in-memory only). "
                        "History itself is always on with federation — "
                        "/metrics/history")
    o.add_argument("--history-raw", type=int, default=720,
                   metavar="SAMPLES",
                   help="raw ring length per series (rollups keep the "
                        "same count at 10s and 1m resolution)")
    o.add_argument("--anomaly-mad", type=float, default=6.0,
                   metavar="FACTOR",
                   help="anomaly detector sensitivity: |value - "
                        "rolling median| over this many MADs fires a "
                        "typed 'anomaly' alert + flight dump")
    o.add_argument("--anomaly-warmup", type=int, default=20,
                   metavar="SAMPLES",
                   help="per-series samples before the anomaly "
                        "detector arms")
    o.add_argument("--anomaly-series", default=None,
                   metavar="NAME,NAME,...",
                   help="restrict the anomaly watch to these history "
                        "series (default: every recorded series)")

    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default=None, metavar="cpu|gpu",
                   help="forwarded to every worker: cpu runs the workers "
                        "on the CPU, gpu (or cuda) on the card")
    return p


def fleet_main(argv=None) -> int:
    """``ntxent-fleet``: router + N supervised workers in one command.

    The router process imports no torch — workers pay the import and the
    device init, the router only moves bytes, which is what lets it
    restart in milliseconds and makes its cache a robustness layer (warm
    keys keep serving through any worker's death). A SIGTERM or SIGINT
    drains the fleet and returns 0.
    """
    import signal as _signal
    import tempfile
    import threading
    from pathlib import Path

    args = build_fleet_parser().parse_args(argv)
    if args.platform is not None and args.platform not in PLATFORM_DEVICES:
        raise SystemExit(f"--platform {args.platform}: the port runs on the "
                         "CUDA card (gpu) or the CPU (cpu)")
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    if args.workers < 1:
        raise SystemExit(f"--workers must be >= 1, got {args.workers}")
    try:
        bucket_list = tuple(int(b) for b in args.buckets.split(",") if b)
        if not bucket_list or min(bucket_list) < 1:
            raise ValueError
    except ValueError:
        raise SystemExit(f"--buckets must be a comma list of positive "
                         f"ints, got {args.buckets!r}")

    from . import obs
    from .resilience.faults import FaultInjector, FaultPlan
    from .serving.cache import EmbeddingCache
    from .serving.fleet import ServingFleet
    from .serving.router import FleetRouter, WorkerPool

    attach = args.attach_workdir is not None
    injector = None
    if args.chaos:
        plan = FaultPlan.parse(args.chaos, seed=args.seed)
        has_fleet = bool(plan.killworker_ticks or plan.slowworker_ticks
                         or plan.spike_ticks or plan.drainworker_ticks)
        has_shard = plan.has_shard_actions()
        if attach and has_fleet:
            # Shard chaos still applies: the shard fleet is owned by
            # THIS router even when the embed workers belong to a
            # primary elsewhere.
            logger.warning("--chaos fleet actions are ignored in "
                           "--attach-workdir mode: a replica router "
                           "does not own the worker processes")
            has_fleet = False
        if has_shard and not (args.shard_procs and args.search_shards):
            logger.warning("--chaos shard actions (killshard@T/"
                           "lagshard@T) need --search-shards N with "
                           "--shard-procs — ignored here")
            has_shard = False
        if has_fleet or has_shard:
            injector = FaultInjector(plan)
        else:
            logger.warning("--chaos %r has no applicable actions — "
                           "ignored here", args.chaos)

    if attach:
        workdir = Path(args.attach_workdir)
        if not workdir.is_dir():
            raise SystemExit(f"--attach-workdir {workdir} does not "
                             "exist (start the primary fleet first)")
    else:
        workdir = Path(args.workdir) if args.workdir \
            else Path(tempfile.mkdtemp(prefix="ntxent-fleet-"))
        workdir.mkdir(parents=True, exist_ok=True)

    event_log = None
    if args.log_jsonl or args.run_id:
        event_log = obs.EventLog(args.log_jsonl, run_id=args.run_id,
                                 async_io=True)
        obs.install(event_log)
        logger.info("fleet telemetry: run_id=%s%s", event_log.run_id,
                    f" events -> {args.log_jsonl}" if args.log_jsonl
                    else "")
    run_id = event_log.run_id if event_log is not None else None

    # Worker argv: the port's serve (``python -m ntxent_tpu_torch.cli``
    # runs serve_main for flags that name no subcommand). Every worker
    # shares the SAME --seed so random-init smoke fleets serve identical
    # weights.
    def make_cmd(worker_id: str, port_file) -> list[str]:
        idx = int(worker_id.lstrip("w"))
        cmd = [sys.executable, "-m", "ntxent_tpu_torch.cli",
               "--model", args.model,
               "--image-size", str(args.image_size),
               "--stem", args.stem,
               "--vit-attention", args.vit_attention,
               "--proj-hidden-dim", str(args.proj_hidden_dim),
               "--proj-dim", str(args.proj_dim),
               "--head", args.head,
               "--accum-steps", str(args.accum_steps),
               "--buckets", args.buckets,
               "--max-delay-ms", str(args.max_delay_ms),
               "--queue-size", str(args.queue_size),
               "--timeout-ms", str(args.timeout_ms),
               "--dtype", args.dtype,
               "--seed", str(args.seed),
               "--port", "0",
               "--port-file", str(port_file),
               "--watch-poll", str(args.watch_poll),
               "--watch-delay", str(idx * args.worker_stagger)]
        if args.adaptive_buckets:
            cmd += ["--adaptive-buckets",
                    "--ladder-max-buckets", str(args.ladder_max_buckets),
                    "--ladder-min-requests",
                    str(args.ladder_min_requests),
                    "--ladder-interval", str(args.ladder_interval)]
        if args.max_batch is not None:
            cmd += ["--max-batch", str(args.max_batch)]
        if args.max_request_rows is not None:
            cmd += ["--max-request-rows", str(args.max_request_rows)]
        if args.stall_timeout is not None:
            cmd += ["--stall-timeout", str(args.stall_timeout)]
        if args.ckpt_dir is not None:
            cmd += ["--ckpt-dir", args.ckpt_dir, "--watch-ckpt"]
        if args.platform:
            cmd += ["--platform", args.platform]
        if args.log_jsonl:
            cmd += ["--log-jsonl", str(workdir / f"{worker_id}.jsonl")]
        if run_id:
            cmd += ["--run-id", run_id]
        return cmd

    registry = obs.default_registry()
    pool = WorkerPool(canary_fraction=args.canary_fraction,
                      canary_min_requests=args.canary_min_requests,
                      canary_max_error_rate=args.canary_max_error_rate,
                      shadow_max_drift=(args.shadow_max_drift
                                        if args.shadow_fraction > 0
                                        else None),
                      shadow_min_samples=args.shadow_min_samples,
                      registry=registry)
    cache = None
    if not args.no_cache:
        cache = EmbeddingCache(capacity_rows=args.cache_rows,
                               ttl_s=args.cache_ttl,
                               buckets=bucket_list, registry=registry,
                               # the hot store must hold at least what
                               # a promote wants to replay, or
                               # --cache-warm-rows is silently capped
                               hot_rows=max(64, args.cache_warm_rows))
    fleet = ServingFleet(make_cmd, n_workers=args.workers,
                         workdir=workdir, pool=pool,
                         poll_s=args.health_poll,
                         eject_after=args.eject_after,
                         max_restarts=args.worker_max_restarts,
                         injector=injector, registry=registry,
                         attach=attach)
    router = FleetRouter(
        pool, cache=cache,
        example_shape=(args.image_size, args.image_size, 3),
        host=args.host, port=args.port, retries=args.retries,
        forward_timeout_s=args.forward_timeout, registry=registry,
        warm_rows=args.cache_warm_rows)
    router.set_run_id(run_id)

    # Retrieval tier: the versioned ANN index rides the router process —
    # torch-free like everything else here, its rebuild re-embeds through
    # the router's own forward path.
    index_mgr = None
    if args.index_dir or args.index_mem:
        from .retrieval import IndexManager

        index_mgr = IndexManager(
            root=args.index_dir, registry=registry,
            docstore_rows=args.index_docstore_rows,
            maintain_interval_s=args.index_maintain_interval,
            train_rows=args.index_train_rows,
            n_centroids=args.index_centroids,
            nprobe=args.index_nprobe,
            seal_rows=args.index_seal_rows,
            pq_m=args.index_pq_m)
        router.attach_index(index_mgr)
        logger.info("retrieval tier: POST /search live (%s, "
                    "train_rows=%d, nprobe=%d/%d, pq_m=%d)",
                    args.index_dir or "in-memory",
                    args.index_train_rows, args.index_nprobe,
                    args.index_centroids, args.index_pq_m)

    # Sharded index plane: N shard servers, the router fans /search out
    # and merges — the single-process capacity ceiling becomes a
    # fleet-shaped one. --shard-procs runs them as SUPERVISED
    # SUBPROCESSES through the same ServingFleet machinery the embed
    # workers use (readiness probe, eject-after-streak, backoff restart),
    # on a second fleet with its own WorkerPool and a PRIVATE registry
    # (the shard pool's canary state machine must not fight the embed
    # pool's on the shared metric names). In production the servers run
    # on separate hosts (python -m ntxent_tpu_torch.retrieval.shard). The
    # plane's width is --proj-dim, as in the JAX CLI: a fleet serving
    # another width (--head features) has every shard insert dropped.
    shard_servers = []
    shard_fleet = None
    if args.search_shards > 0:
        from .retrieval import ShardFanout, ShardServer

        dim = args.proj_dim
        if args.shard_procs:
            import socket as _socket

            # FIXED pre-allocated ports: the fan-out routes by URL, so
            # a shard restarted by supervision must rebind the exact
            # port its clients already hold — an ephemeral port would
            # orphan the ring entry and turn every restart into a
            # permanent hole.
            shard_ports = []
            for _ in range(args.search_shards):
                sk = _socket.socket()
                sk.bind(("127.0.0.1", 0))
                shard_ports.append(sk.getsockname()[1])
                sk.close()
            shard_workdir = workdir / "shards"

            def make_shard_cmd(worker_id: str, port_file) -> list[str]:
                idx = int(worker_id.lstrip("w"))
                return [sys.executable, "-m",
                        "ntxent_tpu_torch.retrieval.shard",
                        "--dim", str(dim),
                        "--port", str(shard_ports[idx]),
                        "--port-file", str(port_file)]

            shard_pool = WorkerPool(registry=obs.MetricsRegistry())
            shard_fleet = ServingFleet(
                make_shard_cmd, n_workers=args.search_shards,
                workdir=shard_workdir, pool=shard_pool,
                poll_s=args.health_poll,
                eject_after=args.eject_after,
                max_restarts=args.worker_max_restarts,
                injector=injector, registry=shard_pool.registry,
                chaos_channel="shard")
            shard_urls = [f"http://127.0.0.1:{p}" for p in shard_ports]
        else:
            shard_servers = [ShardServer(dim).start()
                             for _ in range(args.search_shards)]
            shard_urls = [s.url for s in shard_servers]
        fanout = ShardFanout(
            shard_urls, dim=dim,
            train_rows=args.index_train_rows,
            n_centroids=args.index_centroids,
            nprobe=args.index_nprobe, pq_m=max(1, args.index_pq_m),
            journal_dir=args.shard_journal_dir,
            registry=registry)
        router.attach_shards(fanout)
        logger.info("retrieval: shard plane live — %d shard(s)%s, "
                    "rendezvous list placement, journal %s",
                    args.search_shards,
                    " (supervised subprocesses)" if args.shard_procs
                    else "",
                    args.shard_journal_dir or "in-memory")

    # Fleet observability plane: shadow mirror, metric federation, SLO
    # engine. All off-hot-path; all optional.
    shadow = None
    if args.shadow_fraction > 0:
        from .serving.shadow import ShadowMirror

        shadow = ShadowMirror(pool, fraction=args.shadow_fraction,
                              forward_timeout_s=args.forward_timeout)
        router.attach_shadow(shadow)

    slo_flags = (args.slo_availability, args.slo_latency_ms,
                 args.slo_drift, args.slo_retrieval_degraded)
    if any(f is not None for f in slo_flags) and args.fed_interval <= 0:
        # SLOs evaluate on federation ticks: accepting the flags while
        # silently never arming them would look like paging that is on
        # but is dead.
        raise SystemExit("--slo-* objectives require federation "
                         "(--fed-interval > 0)")
    aggregator = None
    history = None
    if args.fed_interval > 0:
        def _fed_targets() -> dict:
            return {w.worker_id: w.url for w in pool.workers()
                    if w.url}

        aggregator = obs.FleetAggregator(
            _fed_targets, local={"router": registry},
            interval_s=args.fed_interval)
        router.aggregator = aggregator
        # Metrics-history plane: every federation tick lands
        # one sample per derived series in the rollup store, the MAD
        # detector judges each as it arrives, and the router serves the
        # retained view at /metrics/history. Always on with federation
        # — the plane is bounded memory and off the hot path.
        history = obs.MetricHistory(
            raw_len=args.history_raw, rollup_len=args.history_raw,
            spill_dir=args.history_dir, registry=registry)
        watch = None
        if args.anomaly_series:
            watch = {s.strip() for s in args.anomaly_series.split(",")
                     if s.strip()}
        detector = obs.AnomalyDetector(
            store=router.alerts, warmup=args.anomaly_warmup,
            mad_factor=args.anomaly_mad, watch=watch,
            registry=registry)
        recorder = obs.HistoryRecorder(history, detector=detector)
        aggregator.on_merge.append(recorder.on_merge)
        router.history = history
        objectives = []
        if args.slo_availability is not None:
            objectives.append(obs.Objective(
                name="availability", kind="availability",
                target=args.slo_availability,
                total_metric="fleet_requests_total",
                bad_metric="fleet_rejected_total",
                # Saturation is backpressure, not failure: the client
                # was told to retry.
                bad_exclude={"reason": "saturated"},
                fast_window_s=args.slo_fast_window,
                slow_window_s=args.slo_slow_window,
                burn_factor=args.slo_burn_factor))
        if args.slo_latency_ms is not None:
            objectives.append(obs.Objective(
                name="latency_p99", kind="quantile",
                target=args.slo_latency_ms,
                metric="fleet_latency_ms", labels={"stage": "total"},
                q=0.99))
        if args.slo_drift is not None:
            objectives.append(obs.Objective(
                name="shadow_drift_p99", kind="quantile",
                target=args.slo_drift,
                metric="fleet_shadow_drift", q=0.99,
                min_samples=args.shadow_min_samples))
        if args.slo_retrieval_degraded is not None:
            # Retrieval health rides the same burn machinery as
            # availability: a sustained degraded-search fraction over
            # both windows pages through /alerts.
            objectives.append(obs.Objective(
                name="retrieval_degraded", kind="availability",
                target=args.slo_retrieval_degraded,
                total_metric="retrieval_searches_total",
                bad_metric="retrieval_shard_degraded_searches_total",
                fast_window_s=args.slo_fast_window,
                slow_window_s=args.slo_slow_window,
                burn_factor=args.slo_burn_factor))
        if objectives:
            engine = obs.SLOEngine(objectives, store=router.alerts)
            aggregator.on_merge.append(engine.evaluate)

    # Per-tenant admission control: independent of --autoscale — quotas
    # make sense on a fixed fleet too.
    if args.tenant_quota:
        from .serving.autoscale import parse_tenant_quotas
        from .serving.router import TenantAdmission

        try:
            quotas = parse_tenant_quotas(args.tenant_quota)
        except ValueError as e:
            raise SystemExit(f"--tenant-quota: {e}")
        default_rate, default_burst = quotas.pop("default", (100.0, None))
        router.admission = TenantAdmission(
            default_rate=default_rate, default_burst=default_burst,
            quotas=quotas, registry=registry)
        logger.info("admission control: %d named tenant quota(s), "
                    "default %.1f rows/s", len(quotas), default_rate)

    # Closed-loop autoscaling: the controller observes the
    # same federated registry the SLO engine does, so it MUST ride a
    # federation tick — accepting --autoscale without --fed-interval
    # would be a controller that never observes.
    controller = None
    if args.predict_horizon is not None and not args.autoscale:
        raise SystemExit("--predict-horizon is a scale-up input: it "
                         "requires --autoscale")
    if args.autoscale:
        if attach:
            raise SystemExit("--autoscale is not available in "
                             "--attach-workdir mode: a replica router "
                             "does not own the worker processes")
        if args.fed_interval <= 0:
            raise SystemExit("--autoscale requires federation "
                             "(--fed-interval > 0): sizing decisions "
                             "consume the federated signals")
        from .serving.autoscale import AutoscaleController, flash_crowd

        min_w = args.min_workers if args.min_workers is not None else 1
        max_w = args.max_workers if args.max_workers is not None \
            else max(args.workers, 4)
        if not 1 <= min_w <= max_w:
            raise SystemExit(f"need 1 <= --min-workers <= "
                             f"--max-workers, got {min_w}..{max_w}")
        controller = AutoscaleController(
            fleet, pool, registry=registry,
            min_workers=min_w, max_workers=max_w,
            up_queue_depth=args.scale_up_queue,
            up_inflight=args.scale_up_inflight,
            up_p99_ms=args.scale_up_p99_ms,
            up_burn=args.scale_up_burn,
            up_ticks=args.scale_up_ticks,
            idle_ticks=args.scale_idle_ticks,
            up_cooldown_s=args.scale_up_cooldown,
            down_cooldown_s=args.scale_down_cooldown,
            drain_deadline_s=args.drain_deadline,
            slo_target=args.scale_slo_target,
            predict_horizon_s=args.predict_horizon,
            predict_capacity=args.predict_capacity,
            predict_season_s=args.predict_season,
            up_rss_bytes=args.scale_up_rss_bytes,
            history=history)
        aggregator.on_merge.append(controller.observe)
        fleet.autoscaler = controller

        def _on_spike(action: str) -> None:
            # chaos 'spike@T': a closed-loop flash crowd against our
            # own router, off the supervision thread. 3 rows/request
            # keeps each forward cheap while the concurrency drives
            # queueing — what the controller must react to.
            import json as _json
            s = args.image_size
            row = [[[0.5, 0.5, 0.5]] * s] * s
            body = _json.dumps({"inputs": [row] * 3}).encode()
            url = f"http://{args.host}:{router.port}"
            threading.Thread(
                target=flash_crowd, args=(url, body),
                kwargs={"duration_s": 3.0, "concurrency": 8,
                        "tenant": "chaos-spike"},
                daemon=True, name="chaos-spike").start()

        fleet.on_spike = _on_spike
        if index_mgr is not None:
            # Heavy retrieval maintenance (segment compaction, docstore
            # log compaction) defers to the autoscaler's idle detector
            # instead of running blind against a loaded fleet; the
            # manager bounds the deferral so a permanently busy fleet
            # still compacts.
            index_mgr.heavy_gate = controller.maintenance_ok
            logger.info("retrieval: heavy maintenance gated on fleet "
                        "idleness (forced through after %d deferred "
                        "tick(s))", index_mgr.heavy_defer_ticks)
        logger.info("autoscale: pool %d..%d (start %d), up after %d "
                    "pressure tick(s), drain after %d idle tick(s)",
                    min_w, max_w, args.workers, args.scale_up_ticks,
                    args.scale_idle_ticks)
        if args.predict_horizon is not None:
            logger.info("autoscale: predictive scale-up armed — "
                        "%.0fs horizon%s", args.predict_horizon,
                        f", {args.predict_capacity:.0f} req/s/worker "
                        "rated capacity"
                        if args.predict_capacity is not None else "")

    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001
        logger.info("fleet: signal %d — draining", signum)
        stop.set()

    _signal.signal(_signal.SIGTERM, _on_signal)
    _signal.signal(_signal.SIGINT, _on_signal)

    fleet.start()
    if shard_fleet is not None:
        shard_fleet.start()
    if router.shards is not None:
        # Repair loop: probe dead shards, drain journal debt through the
        # normal insert path once they answer.
        router.shards.start(args.shard_repair_interval)
    router.start()
    if index_mgr is not None:
        index_mgr.start()
    if shadow is not None:
        shadow.start()
    if aggregator is not None:
        aggregator.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(router.port))
        os.replace(tmp, args.port_file)
    logger.info("fleet: router on http://%s:%d over %d worker(s) "
                "(workdir %s)", args.host, router.port, args.workers,
                workdir)
    try:
        while not stop.is_set():
            stop.wait(0.2)
    finally:
        if aggregator is not None:
            aggregator.stop()
        if history is not None:
            # Final spill: a clean shutdown leaves the full retained
            # view on disk for the next --history-dir reopen.
            history.close()
        if shadow is not None:
            shadow.stop()
        if index_mgr is not None:
            index_mgr.stop()
        for srv in shard_servers:
            srv.stop()
        if shard_fleet is not None:
            shard_fleet.stop()
        if router.shards is not None:
            router.shards.close()
        router.close()
        fleet.stop()
        if event_log is not None:
            obs.install(None)
            event_log.close()
    return 0


if __name__ == "__main__":
    sys.exit(fleet_main())
