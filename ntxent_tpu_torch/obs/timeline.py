"""Per-step training timeline, counterpart of ``ntxent_tpu/obs/timeline.py``:
where each step's wall clock went.

``trainer.train_loop(timeline=)`` hands every completed step to
``record_step``: how long the host waited for the batch
(``data_wait_ms``, split into host fetch and transfer dispatch when the
iterator is a ``data.DevicePrefetcher``), how long the card ran
(``device_ms``: a ``torch.cuda.synchronize`` bracket, paid only with a
timeline, as the JAX loop's ``block_until_ready``; dispatch to ready under
``metrics_lag=1``) and how long the step hook took (``checkpoint_ms``).
Each step lands in the process-wide ``MetricsRegistry`` (histograms,
gauges) and, with an event log installed, as one ``step`` event per
``event_every`` steps. The series names, help strings, event names and
fields are the JAX package's.

Two more signals hang on it: a non-finite loss on a step without the
in-step guard (no ``step_ok``) produces a ``divergence`` event (guarded
runs get theirs from ``resilience.DivergenceGuard``), and each step's
device time feeds the attached ``obs.profiler.ProfilerTrigger``.

MFU: ``set_flops_per_step`` (``train_loop`` counts step 1's FLOPs,
``trainer.count_step_flops``) times steps/s over the card's peak, resolved
lazily through ``trainer.peak_flops_per_chip``.

``history=`` takes an ``obs.history.MetricHistory``: each step also
lands in the retained time-series plane (``train_step_device_ms``,
``train_steps_per_sec``, ``train_loss``), which spills when its interval
has passed, so a training process gets the rollups and the anomaly watch
the serving fleet has.

The comms profile: ``set_comms_per_step`` publishes the declared
collectives of step 1 and, with ``graph=`` (``train_loop`` runs step 1
under ``analysis.graph.census.CollectiveCensus``), the traffic the
declarations miss (autograd's collectives) as
``collective_graph_bytes_total{source="ad"}``.
"""

from __future__ import annotations

import logging
import math
import time

from . import events
from .registry import MetricsRegistry, default_registry

logger = logging.getLogger(__name__)

__all__ = ["StepTimeline"]


class StepTimeline:
    """Collects per-step timings from ``train_loop`` and publishes them.

    One instance a run: supervised attempts share it (the counters and
    the profiler's rolling window survive a restart; the event log's
    ``attempt`` field tells the records apart)."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 profiler=None, event_every: int = 1,
                 histogram_window: int = 2048, history=None):
        self.registry = registry or default_registry()
        self.profiler = profiler
        self.history = history
        self.event_every = max(1, int(event_every))
        self.flops_per_step: float | None = None
        self._peak_flops: float | None = None
        self._last_done: float | None = None
        r = self.registry
        self._steps = r.counter(
            "train_steps_total", "completed train steps")
        self._divergence = r.counter(
            "train_divergence_total",
            "steps whose loss or grad norm was non-finite")
        self._data_wait = r.histogram(
            "train_step_data_wait_ms",
            "host wait on the input pipeline per step",
            window=histogram_window)
        self._host_fetch = r.histogram(
            "train_step_host_fetch_ms",
            "host time producing each consumed batch (slice/decode/"
            "augment dispatch)",
            window=histogram_window)
        self._transfer = r.histogram(
            "train_step_transfer_ms",
            "host->device transfer dispatch time per consumed batch "
            "(the copy itself rides under compute)",
            window=histogram_window)
        self._device = r.histogram(
            "train_step_device_ms",
            "device time per step (block_until_ready bracketed; "
            "dispatch-to-ready latency under metrics_lag)",
            window=histogram_window)
        # no per-step checkpoint histogram: most steps' hook is a no-op;
        # checkpoint_save_ms (training/checkpoint.py) times the saves
        self._sps = r.gauge(
            "train_steps_per_sec", "instantaneous steps per second")
        self._loss = r.gauge("train_loss", "last step's loss")
        self._mfu = r.gauge(
            "train_mfu", "model FLOP utilization (0..1)")
        self._comms_bytes_per_step: float | None = None
        self._comms_bytes = r.gauge(
            "train_step_comms_bytes",
            "bytes moved per device per compiled step (trace-time "
            "static, ring-algorithm model)")
        self._comms_calls = r.gauge(
            "train_step_comms_calls",
            "collective ops per compiled step (trace-time static)")
        self._overlap_ms = r.gauge(
            "train_step_comms_overlap_ms",
            "per-step wall clock hidden by the chunked ring schedule "
            "(monolithic minus chunked step time, block_until_ready "
            "bracketed; 0 until measured)")
        self._overlap_frac = r.gauge(
            "train_step_comms_overlap_frac",
            "overlap window as a fraction of the monolithic step time "
            "(0..1; 0 until measured)")

    # -- wiring ----------------------------------------------------------
    def set_flops_per_step(self, flops: float | None) -> None:
        self.flops_per_step = flops

    def new_attempt(self) -> None:
        """Reset the inter-step clock at a loop or attempt boundary
        (``train_loop`` calls it on entry), so the first step after a
        restart does not report steps/s over the restart's gap."""
        self._last_done = None

    def _mfu_of(self, steps_per_sec: float) -> float | None:
        if not self.flops_per_step:
            return None
        if self._peak_flops is None:
            try:
                from ..training.trainer import peak_flops_per_chip

                self._peak_flops = peak_flops_per_chip()
            except Exception:  # noqa: BLE001 — no MFU rather than no step
                self._peak_flops = float("nan")
        if not math.isfinite(self._peak_flops):
            return None
        return self.flops_per_step * steps_per_sec / self._peak_flops

    def record_compile(self, duration_ms: float,
                       flops: float | None) -> None:
        """Step 1, the port's counterpart of an AOT compile: the first run
        (kernel libraries loaded, cuBLAS heuristics, allocator warm-up)
        with its FLOPs counted."""
        self.registry.counter(
            "train_compiles_total", "AOT train-step compiles").inc()
        events.emit("compile", duration_ms=round(duration_ms, 3),
                    flops=flops)

    def set_comms_per_step(self, profile: dict,
                           graph: dict | None = None) -> None:
        """Publish one step's collective profile (``timeline.py:170-225``).

        ``profile`` is a comms accounting delta (``{(op, axis): (calls,
        bytes)}``, ``parallel.mesh.CommsAccounting.delta``) around step 1;
        an empty delta (world 1) leaves the series untouched unless
        ``graph`` reports GSPMD traffic (never, in the port).

        ``graph`` is a census summary (``analysis.graph.census.
        graph_remainder``: ``graph_bytes`` / ``declared_bytes`` /
        ``ad_bytes``, plus ``gspmd_bytes`` where given): the traffic the
        helpers cannot see (autograd's collectives) lands on
        ``collective_graph_bytes_total{source="ad"}`` (published at every
        census, 0 included) and rides the ``comms_profile`` event. The
        dict is plain floats: obs stays importable without torch."""
        calls = sum(c for c, _ in profile.values())
        nbytes = sum(b for _, b in profile.values())
        graph = dict(graph) if graph else {}
        if graph:
            # one declaration of the counter family, shared with the
            # ntxent-audit CLI; census.py imports torch only inside its
            # functions, so this lazy import keeps obs torch-free
            from ..analysis.graph.census import publish_graph_census

            publish_graph_census(
                float(graph.get("ad_bytes") or 0.0),
                float(graph.get("gspmd_bytes") or 0.0),
                registry=self.registry)
        if not calls and not graph.get("gspmd_bytes"):
            return
        self._comms_bytes_per_step = float(nbytes)
        self._comms_bytes.set(nbytes)
        self._comms_calls.set(calls)
        fields = {}
        for key in ("graph_bytes", "ad_bytes", "gspmd_bytes"):
            if graph.get(key) is not None:
                fields[key] = float(graph[key])
        events.emit("comms_profile", calls=int(calls),
                    bytes=float(nbytes),
                    by_op={f"{op}|{ax}": {"calls": int(c),
                                          "bytes": float(b)}
                           for (op, ax), (c, b) in sorted(profile.items())},
                    **fields)

    def set_comms_overlap(self, overlap_ms: float,
                          monolithic_ms: float | None = None,
                          chunked_ms: float | None = None,
                          chunks: int | None = None) -> None:
        """Publish one measured overlap window (``trainer.
        measure_comms_overlap``: the strip's step minus the chunked
        ring's, clamped at 0). The fraction needs ``monolithic_ms``."""
        ms = max(float(overlap_ms), 0.0)
        self._overlap_ms.set(ms)
        fields = {"overlap_ms": round(ms, 3)}
        if monolithic_ms and monolithic_ms > 0.0:
            frac = min(max(ms / float(monolithic_ms), 0.0), 1.0)
            self._overlap_frac.set(frac)
            fields["overlap_frac"] = round(frac, 4)
            fields["monolithic_ms"] = round(float(monolithic_ms), 3)
        if chunked_ms is not None:
            fields["chunked_ms"] = round(float(chunked_ms), 3)
        if chunks is not None:
            fields["chunks"] = int(chunks)
        events.emit("comms_overlap", **fields)

    # -- per step --------------------------------------------------------
    def record_step(self, step: int, loss: float,
                    data_wait_s: float, device_s: float,
                    hook_s: float = 0.0, ok: bool | None = None,
                    grad_norm: float | None = None,
                    host_fetch_s: float | None = None,
                    transfer_s: float | None = None) -> None:
        """One completed step. ``ok=None``: a step without the in-step
        guard. ``host_fetch_s``/``transfer_s`` split the pipeline's time
        for the batch this step consumed (``DevicePrefetcher.
        last_timing``; they ran under earlier steps), while
        ``data_wait_s`` is what this step blocked; ``host_fetch_s=None``
        records the whole wait as host fetch, ``transfer_s=None`` leaves
        the transfer series alone. Under ``metrics_lag=1`` records come
        one step after dispatch and ``device_s`` is dispatch to ready."""
        now = time.perf_counter()
        if self._last_done is not None:
            wall_s = max(now - self._last_done, 1e-9)
        else:
            wall_s = max(data_wait_s + device_s + hook_s, 1e-9)
        self._last_done = now
        steps_per_sec = 1.0 / wall_s

        self._steps.inc()
        self._data_wait.observe(data_wait_s * 1e3)
        if host_fetch_s is None:
            host_fetch_s = data_wait_s
        self._host_fetch.observe(host_fetch_s * 1e3)
        if transfer_s is not None:
            self._transfer.observe(transfer_s * 1e3)
        self._device.observe(device_s * 1e3)
        self._sps.set(steps_per_sec)
        if math.isfinite(loss):
            self._loss.set(loss)
        mfu = self._mfu_of(steps_per_sec)
        if mfu is not None:
            self._mfu.set(mfu)

        diverged = not math.isfinite(loss) or (ok is False)
        if diverged:
            self._divergence.inc()
        if step % self.event_every == 0 or diverged:
            fields = dict(step=int(step), loss=float(loss),
                          data_wait_ms=round(data_wait_s * 1e3, 3),
                          host_fetch_ms=round(host_fetch_s * 1e3, 3),
                          device_ms=round(device_s * 1e3, 3),
                          checkpoint_ms=round(hook_s * 1e3, 3),
                          steps_per_sec=round(steps_per_sec, 4))
            if transfer_s is not None:
                fields["transfer_ms"] = round(transfer_s * 1e3, 3)
            if self._comms_bytes_per_step is not None:
                fields["comms_bytes"] = self._comms_bytes_per_step
            if mfu is not None:
                fields["mfu"] = round(mfu, 4)
            if grad_norm is not None:
                fields["grad_norm"] = float(grad_norm)
            if ok is not None:
                fields["ok"] = bool(ok)
            events.emit("step", **fields)
        if diverged and ok is None:
            # an unguarded step: nothing else records it
            events.emit("divergence", action="observed", step=int(step),
                        loss=float(loss), guarded=False)

        if self.history is not None:
            self.history.record("train_step_device_ms", device_s * 1e3)
            self.history.record("train_steps_per_sec", steps_per_sec)
            self.history.record("train_loss", loss)  # non-finite: dropped
            self.history.maybe_spill()

        if self.profiler is not None:
            self.profiler.on_step(int(step), device_s * 1e3)

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.close()
