"""Shape-bucketed inference engine, counterpart of
``ntxent_tpu/serving/engine.py``.

Requests pad up to the nearest rung of a ladder of batch sizes (default
1/4/16/64/128) and oversized requests split into max-bucket chunks plus
one bucketed tail, so the device only ever sees a few batch shapes.

* **A "compile" is a key's first run.** PyTorch runs eagerly and builds
  nothing per bucket, but the first forward of a (bucket, dtype, weights
  structure and version) key pays what the reference's compile stands
  for: the caching allocator's growth, the libraries' plan choice and,
  once per process, the hand-written kernels' build. The engine keeps
  the reference's accounting on that unit: ``warmup()`` runs every rung
  of the ladder once, a later miss runs the key once before the chunk
  (``serving_compiles_total``, by cause in
  ``serving_compiles_by_cause_total``), a hit counts in
  ``serving_compile_cache_hits_total``. "Requests never pay a compile
  across a ladder swap" means what it means in the reference: no
  request-path first run.
* **The int8 rung** (``dtype=torch.int8``): each padded chunk is
  quantized on the host per example (symmetric, scale ``amax / 127``,
  bit for bit the reference's ``_quantize_host``), the int8 payload and
  the float32 scales go to the card, and ``q.float() * scale`` runs
  there before the model's forward: the host-to-device copy moves ~4x
  fewer bytes (``h2d_bytes``). The dequantization is plain PyTorch, as
  it is XLA, not Pallas, in the reference.
* **Atomic weight swaps.** The weights live in the module, so every
  request chunk holds the read side of ``_forward_lock`` for its copy in,
  forward and copy out, and only the in-place weight copy takes the
  write side. ``swap_variables`` with an unchanged structure stages the
  new tensors on the device off the lock and copies them into the live
  module under its write side (``"reused"``: the warm ladder stays
  valid). A changed structure builds a second module, runs every rung on
  it off the lock, then publishes it under the state lock (``"warmed"``;
  the watcher and a rollback always swap one layout, so this branch
  serves a caller that swaps in another model). A chunk snapshots
  (module, weights hash, bucket, run function) under one lock hold, so a
  swap landing mid-request flips the next chunk, never one in flight.
  Chunks share the lock, and a waiting writer does not shut new readers
  out: a wedged forward cannot block the fresh batcher that a supervised
  restart starts (only a swap waits for it).
* **The adaptive ladder** (``adaptive=True``): a decayed histogram of
  chunk sizes feeds the DP of ``serving/ladder.py``; ``refresh_ladder``
  runs each new rung once off the request path
  (``serving_ladder_compiles_total``) and publishes the ladder
  atomically; evicted rungs drop from the cache but a chunk that
  snapshotted one finishes on it. A failed re-warm keeps the old ladder.
  ``ladder_interval_s > 0`` runs refreshes on a daemon thread.

Warm runs (``warmup``, a miss, a re-warm, a structure swap) do not take
``_forward_lock``: their output is discarded, they read weights that only
a ``"reused"`` swap writes (a torn read can spoil only that discarded
output), and a swap must not wait for their host-side launches. Request
chunks take its read side, so each runs wholly on one set of weights.

The engine is synchronous; coalescing, queuing and backpressure live one
layer up in ``serving.batcher.MicroBatcher``.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import logging
import threading
import time
from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..obs import events as _events
from ..obs import trace as _trace
from ..utils.capability import resolve_device
from ..analysis.graph.recompile import RecompileDiffer
from .ladder import SizeHistogram, expected_padded_rows, optimize_ladder
from .metrics import ServingMetrics

logger = logging.getLogger(__name__)

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine", "quantize_host"]

DEFAULT_BUCKETS: tuple[int, ...] = (1, 4, 16, 64, 128)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}


def quantize_host(x: np.ndarray, example_ndim: int) -> tuple:
    """Per-example symmetric int8 quantization of a padded chunk
    (``engine.py:307-317`` of the reference): scale = max(amax, 1e-30) /
    127 in float32, ``rint(x / scale)`` clipped to [-127, 127]; all-zero
    (padding) rows quantize to zeros."""
    amax = np.abs(x.reshape(x.shape[0], -1)).max(axis=1)
    scale = (np.maximum(amax, 1e-30) / 127.0).reshape(
        (-1,) + (1,) * example_ndim).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


class _SharedLock:
    """A read/write lock that prefers readers: ``read()`` waits only
    while a writer holds the lock, ``write()`` waits until no reader
    does."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writing:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            while self._writing or self._readers:
                self._cond.wait()
            self._writing = True
        try:
            yield
        finally:
            with self._cond:
                self._writing = False
                self._cond.notify_all()


def _structure_hash(weights: Mapping) -> str:
    """Fingerprint of a state dict's layout: names, shapes, dtypes."""
    h = hashlib.sha1()
    for name, t in weights.items():
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
    return h.hexdigest()[:16]


def _model_hash(structure: str, version: int) -> str:
    return hashlib.sha1(f"{structure}v{version}".encode()).hexdigest()[:16]


class InferenceEngine:
    """Bucketed forward of ``model`` over a fixed per-example shape.

    ``method`` names the model method to serve (``"forward"`` for the
    normalized embedding, ``"features"`` for encoder features).
    ``example_shape`` is one example's trailing shape, e.g. (H, W, C).
    ``dtype`` is the input dtype (``torch.int8``: the quantized rung).
    ``device`` defaults to CUDA and raises when there is no GPU; pass
    ``"cpu"`` for the CPU. ``retry_policy`` retries a failed chunk (not
    the chunks before it).
    """

    def __init__(self, model: nn.Module, example_shape: Sequence[int], *,
                 method: str = "forward",
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 metrics: ServingMetrics | None = None,
                 retry_policy=None, adaptive: bool = False,
                 ladder_max_buckets: int = 6,
                 ladder_min_requests: int = 200,
                 ladder_decay: float = 0.999,
                 ladder_interval_s: float = 0.0):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        if dtype not in _DTYPE_NAMES:
            raise ValueError(f"dtype must be one of {list(_DTYPE_NAMES)}, "
                             f"got {dtype}")
        if adaptive and ladder_max_buckets < 1:
            raise ValueError(f"ladder_max_buckets must be >= 1, got "
                             f"{ladder_max_buckets}")
        self.buckets = buckets
        self.initial_buckets = buckets  # the adaptive ladder's prior
        self.max_bucket = buckets[-1]
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = dtype
        self.dtype_name = _DTYPE_NAMES[dtype]
        self.quantized = dtype == torch.int8
        self.method = method
        self.device = resolve_device(device)
        self.metrics = metrics or ServingMetrics()
        self.retry_policy = retry_policy
        self.model = model.to(self.device).eval()
        self.version = 0
        self._structure = _structure_hash(self.model.state_dict())
        self._hash = _model_hash(self._structure, self.version)
        # (bucket, dtype name, weights hash) -> the run function of a key
        # that has had its first run
        self._cache: dict[tuple, Callable] = {}
        self._lock = threading.Lock()          # module, hash, ladder, cache
        self._forward_lock = _SharedLock()  # chunks read, weight copy writes
        self._swap_lock = threading.Lock()     # one swap at a time
        self._recompile = RecompileDiffer()
        # host-to-device bytes of request chunks (the int8 rung's saving),
        # counted under _lock
        self.h2d_bytes = 0
        self.adaptive = bool(adaptive)
        self.ladder_max_buckets = int(ladder_max_buckets)
        self.ladder_min_requests = int(ladder_min_requests)
        # a proposal must beat the live ladder's expected padding by this
        # relative margin, or re-warming pays for nothing
        self.ladder_min_rel_improvement = 0.05
        self.ladder_generation = 0
        self.histogram = (SizeHistogram(decay=ladder_decay)
                          if self.adaptive else None)
        self._ladder_refresh_lock = threading.Lock()
        self._ladder_stop = threading.Event()
        self._ladder_thread: threading.Thread | None = None
        self.metrics.set_ladder(self.buckets, 0)
        if self.adaptive and ladder_interval_s > 0:
            self._ladder_thread = threading.Thread(
                target=self._ladder_loop, args=(float(ladder_interval_s),),
                daemon=True, name="ntxent-torch-ladder-rewarm")
            self._ladder_thread.start()

    @property
    def compile_cache_size(self) -> int:
        """Warm keys in the cache (read at /metrics scrape time)."""
        with self._lock:
            return len(self._cache)

    @property
    def variables(self) -> dict:
        """A host copy of the served weights (a state dict), what a
        rollback swaps back in."""
        with self._forward_lock.read():
            return {k: v.detach().to("cpu", copy=True)
                    for k, v in self.model.state_dict().items()}

    # -- model lifecycle -------------------------------------------------
    def update_variables(self, state_dict: Mapping) -> None:
        """Load new weights now and invalidate the warm keys: the next
        chunk of each bucket runs it first (cause ``weights_reload``)."""
        with self._forward_lock.write(), self._lock:
            self.model.load_state_dict(state_dict)
            self.version += 1
            self._hash = _model_hash(self._structure, self.version)
            self._cache.clear()

    def swap_variables(self, variables) -> str:
        """Zero-downtime weight swap; returns ``"reused"`` or
        ``"warmed"``.

        ``variables`` is a state dict or a module. One whose layout equals
        the live module's is staged on the device off the lock and copied
        in under it: the warm ladder stays valid (``"reused"``). Another
        layout (a module, or a state dict that differs in dtype and loads
        by assignment into a copy of the live module) becomes a second
        module whose every rung runs once before it is published
        (``"warmed"``); the previous module's keys leave the cache."""
        with self._swap_lock:
            if isinstance(variables, nn.Module):
                module, weights = variables, variables.state_dict()
            else:
                module, weights = None, variables
            structure = _structure_hash(weights)
            if structure == self._structure:
                staged = {k: v.detach().to(self.device)
                          for k, v in weights.items()}
                with self._forward_lock.write():
                    self.model.load_state_dict(staged)
                self.metrics.model_swap("reused")
                logger.info("serving: swapped weights (structure unchanged: "
                            "warm ladder reused)")
                return "reused"
            if module is None:
                with self._forward_lock.read():
                    module = copy.deepcopy(self.model)
                # cloned: the module never aliases the caller's dict (a
                # watcher keeps it to roll back to)
                module.load_state_dict({k: v.detach().clone()
                                        for k, v in weights.items()},
                                       assign=True)
            module = module.to(self.device).eval()
            version = self.version + 1
            new_hash = _model_hash(structure, version)
            for bucket in self.buckets:
                self._executable(bucket, new_hash, module)
            with self._lock:
                self.model = module
                self.version = version
                self._structure = structure
                self._hash = new_hash
                # in-flight chunks hold their own run function
                self._cache = {k: v for k, v in self._cache.items()
                               if k[2] == new_hash}
            self.metrics.model_swap("warmed")
            logger.info("serving: swapped weights (structure changed: "
                        "every rung run first)")
            return "warmed"

    def _snapshot(self) -> tuple:
        """(module, weights hash) as a consistent pair."""
        with self._lock:
            return self.model, self._hash

    def _chunk_snapshot(self, n: int) -> tuple:
        """(module, hash, bucket, warm run function or None) under ONE
        lock hold: the bucket and its cache lookup come from the same
        ladder generation, so a ladder swap cannot evict the rung between
        them and make the request pay a first run."""
        with self._lock:
            bucket = next(b for b in self.buckets if b >= n)
            exe = self._cache.get((bucket, self.dtype_name, self._hash))
            return self.model, self._hash, bucket, exe

    # -- argument marshalling --------------------------------------------
    def _make_run(self, module: nn.Module) -> Callable:
        """The forward of ``module`` on device arguments: the int8 rung
        dequantizes first."""
        fn = getattr(module, self.method)
        if self.quantized:
            def run(q, scale):
                return fn(q.float() * scale)
        else:
            def run(x):
                return fn(x)
        return run

    def _dummy_args(self, bucket: int) -> tuple:
        """Zero host arguments of one bucket (the first-run shapes)."""
        shape = (bucket,) + self.example_shape
        if self.quantized:
            return (torch.zeros(shape, dtype=torch.int8),
                    torch.ones((bucket,) + (1,) * len(self.example_shape)))
        return (torch.zeros(shape, dtype=self.dtype),)

    def _quantize_host(self, x: np.ndarray) -> tuple:
        return quantize_host(x, len(self.example_shape))

    def _chunk_args(self, x: np.ndarray) -> tuple:
        """Host tensors of a padded chunk, in the dtype they cross to the
        card in."""
        if self.quantized:
            q, scale = self._quantize_host(np.asarray(x, np.float32))
            return torch.from_numpy(q), torch.from_numpy(scale)
        return (torch.from_numpy(np.asarray(x, np.float32)).to(self.dtype),)

    def _launch(self, exe: Callable, args: tuple) -> np.ndarray:
        """Copy ``args`` to the device, run ``exe``, return host float32."""
        with torch.inference_mode():
            out = exe(*(a.to(self.device) for a in args))
            return out.float().cpu().numpy()

    def _device_call(self, exe: Callable, args: tuple) -> np.ndarray:
        """One request chunk, wholly on one set of weights."""
        with self._lock:
            self.h2d_bytes += sum(a.numel() * a.element_size()
                                  for a in args)
        with self._forward_lock.read():
            return self._launch(exe, args)

    # -- bucket math -----------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (n must fit the ladder)."""
        if n < 1:
            raise ValueError(f"need at least one row, got {n}")
        if n > self.max_bucket:
            raise ValueError(f"{n} rows exceed the largest bucket "
                             f"{self.max_bucket} (chunking is embed()'s "
                             "job)")
        return next(b for b in self.buckets if b >= n)

    def _executable(self, bucket: int, model_hash: str | None = None,
                    module: nn.Module | None = None,
                    cached: Callable | None = None,
                    background: bool = False) -> Callable:
        """The run function of ``bucket`` on ``module``, after its first
        run if the key had none. ``cached`` is what ``_chunk_snapshot``
        resolved under the lock (a hit)."""
        if cached is not None:
            self.metrics.compile_cache_hit()
            return cached
        if model_hash is None or module is None:
            module, model_hash = self._snapshot()
        key = (bucket, self.dtype_name, model_hash)
        with self._lock:
            exe = self._cache.get(key)
        if exe is not None:
            if not background:
                self.metrics.compile_cache_hit()
            return exe
        # the first run, outside the locks (a concurrent miss on the same
        # key costs one more run, never a wrong result)
        exe = self._make_run(module)
        t0 = time.monotonic()
        self._launch(exe, self._dummy_args(bucket))
        duration_ms = (time.monotonic() - t0) * 1e3
        structure = _structure_hash(module.state_dict())
        cause = self._recompile.observe(key, {
            "structure": structure,
            "dtype": self.dtype_name,
            "version": model_hash,
            "shape": (bucket,) + self.example_shape,
        })
        logger.info("serving: first run of bucket %d (%s) in %.1f ms%s "
                    "[cause=%s]", bucket, self.dtype_name, duration_ms,
                    " [background]" if background else "", cause)
        # a re-warm is off the request path: serving_compiles_total is
        # what requests (and warmup) paid
        (self.metrics.ladder_compiled if background
         else self.metrics.compiled)(cause=cause)
        _events.emit("compile", bucket=int(bucket), dtype=self.dtype_name,
                     structure=structure[:8], cause=cause,
                     background=bool(background),
                     duration_ms=round(duration_ms, 3))
        with self._lock:
            return self._cache.setdefault(key, exe)

    # -- adaptive ladder -------------------------------------------------
    def refresh_ladder(self, force: bool = False) -> bool:
        """One observe, optimize, re-warm, swap cycle; True when a new
        ladder was published.

        ``force=True`` skips the min-requests gate and the hysteresis
        margin but still needs a non-empty histogram and a different
        proposal. A failed re-warm keeps the live ladder (counted in
        ``serving_ladder_refresh_failures_total``); a structure swap that
        lands mid-re-warm abandons the publish."""
        if self.histogram is None:
            return False
        with self._ladder_refresh_lock:
            if (not force and self.histogram.observations
                    < self.ladder_min_requests):
                return False
            weights = self.histogram.weights()
            if not weights:
                return False
            proposal = optimize_ladder(weights, self.ladder_max_buckets,
                                       self.max_bucket,
                                       self.initial_buckets)
            current = self.buckets
            if proposal == current:
                return False
            if not force:
                cur_cost = expected_padded_rows(weights, current)
                new_cost = expected_padded_rows(weights, proposal)
                if not (cur_cost > 0.0 and new_cost <= cur_cost
                        * (1.0 - self.ladder_min_rel_improvement)):
                    return False
            module, model_hash = self._snapshot()
            try:
                for bucket in proposal:
                    self._executable(bucket, model_hash, module,
                                     background=True)
            except Exception:  # noqa: BLE001 — a failed re-warm must never
                # take serving down: the old ladder keeps working
                logger.exception("serving: ladder re-warm failed; keeping "
                                 "ladder %s", list(current))
                self.metrics.ladder_refresh_failed()
                return False
            with self._lock:
                if self._hash != model_hash:
                    return False  # weights changed mid-re-warm
                self.buckets = proposal
                self.ladder_generation += 1
                generation = self.ladder_generation
                keep = set(proposal)
                self._cache = {k: v for k, v in self._cache.items()
                               if k[0] in keep or k[2] != model_hash}
            self.metrics.ladder_swap(proposal, generation)
            logger.info("serving: ladder swapped %s -> %s (generation %d)",
                        list(current), list(proposal), generation)
            return True

    def _ladder_loop(self, interval_s: float) -> None:
        while not self._ladder_stop.wait(interval_s):
            try:
                self.refresh_ladder()
            except Exception:  # noqa: BLE001 — the worker outlives a bad
                # cycle; serving never depends on it
                logger.exception("serving: ladder refresh cycle failed")

    def close(self) -> None:
        """Stop the background re-warm worker (no-op without one)."""
        self._ladder_stop.set()
        thread, self._ladder_thread = self._ladder_thread, None
        if thread is not None:
            thread.join(5.0)

    # -- public API ------------------------------------------------------
    def warmup(self) -> None:
        """Run every ladder bucket once, so no request pays a first run
        (the /readyz gate)."""
        module, model_hash = self._snapshot()
        for bucket in self.buckets:
            self._executable(bucket, model_hash, module)
        logger.info("serving: warmup complete (%d buckets: %s)",
                    len(self.buckets), list(self.buckets))

    def _embed_chunk(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        if n < 1 or n > self.max_bucket:
            raise ValueError(f"chunk of {n} rows outside (0, "
                             f"{self.max_bucket}] (chunking is embed()'s "
                             "job)")
        module, model_hash, bucket, cached = self._chunk_snapshot(n)
        pad = bucket - n
        if pad:
            x = np.concatenate(
                [x, np.zeros((pad,) + self.example_shape, x.dtype)])
        exe = self._executable(bucket, model_hash, module, cached)
        args = self._chunk_args(x)

        def run_once():
            return self._device_call(exe, args)

        t0 = time.monotonic()
        with _trace.span("serve.device_chunk", bucket=int(bucket),
                         rows=int(n), pad=int(pad)):
            out = (self.retry_policy.call(run_once)
                   if self.retry_policy is not None else run_once())
        # device_ms spans retries and their backoff: the chunk's service
        # time as the queue sees it
        self.metrics.device_call(bucket, rows_real=n, rows_padded=pad,
                                 device_ms=(time.monotonic() - t0) * 1e3)
        return out[:n]

    def embed(self, x: np.ndarray, n_requests: int = 1) -> np.ndarray:
        """Outputs for ``x`` of shape ``(N,) + example_shape``.

        ``N`` may exceed the largest bucket: the batch splits into
        max-bucket chunks plus one bucketed tail, each its own device
        call. ``n_requests`` is accounting only: how many coalesced
        requests this dispatch carries (the batch-fill-ratio numerator).
        """
        x = np.asarray(x, dtype=np.float32)
        if x.shape[1:] != self.example_shape:
            raise ValueError(f"expected trailing shape {self.example_shape},"
                             f" got {x.shape[1:]}")
        if x.shape[0] < 1:
            raise ValueError("need at least one row")
        self.metrics.dispatch(n_requests)
        n = int(x.shape[0])
        # sizes are recorded per device chunk, the unit that pads
        sizes = ([n] if n <= self.max_bucket else
                 [self.max_bucket] * (n // self.max_bucket)
                 + ([n % self.max_bucket] if n % self.max_bucket else []))
        for size in sizes:
            self.metrics.observe_request_size(size)
            if self.histogram is not None:
                self.histogram.observe(size)
        return np.concatenate([
            self._embed_chunk(x[start:start + self.max_bucket])
            for start in range(0, n, self.max_bucket)])
