"""Worker-replica supervision: spawn, health-check, eject, restart.
Counterpart of ``ntxent_tpu/serving/fleet.py`` (stdlib). It supervises
the embed workers and, with ``chaos_channel="shard"``, the retrieval
tier's shard processes.

``ServingFleet`` owns the worker PROCESSES the way ``crashsim`` owns
training lineages: each worker is a subprocess (the port's serve,
``python -m ntxent_tpu_torch.cli``, with ``--port-file`` +
``--watch-ckpt``), its stdout goes to a
per-worker log, its bound port is published through a port file, and a
single monitor thread runs the supervision loop:

* **liveness**: a dead process (SIGKILL, OOM, crash) is detected by
  ``poll()`` and restarted after ``RetryPolicy`` backoff — the same
  restart-with-backoff vocabulary the training Supervisor uses, with
  the per-worker restart count as the backoff ordinal;
* **health**: each tick probes ``/readyz`` (readiness distinct from
  liveness — a warming worker is alive but takes no traffic) and feeds
  ``WorkerPool.set_health``, so the router's routing table is never
  more than one poll behind reality. The router's own forward failures
  land in the same ``consecutive_failures`` counter;
* **ejection**: ``eject_after`` consecutive failures (probe or
  forward) SIGKILLs the worker and schedules a restart — a wedged-but-
  listening worker is indistinguishable from a slow one except by this
  counter, which is why slowworker chaos drives exactly this path;
* **fleet chaos**: ``FaultPlan``'s ``killworker@K`` / ``slowworker@K``
  fire on the K-th supervision tick — counted from the first tick
  where every worker is ready, so a plan hits a SERVING fleet at a
  deterministic point rather than a booting one — via
  ``FaultInjector.on_fleet_tick``: SIGKILL (no cleanup, the crash the
  retry budget must hide) and SIGSTOP-for-a-while (the gray failure
  health checks must catch).

The fleet mutates the pool; the router only reads it. Everything here
imports no torch — supervision must never pay the workers' import
and device-init latency.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

from ..obs import events as obs_events
from ..obs.registry import MetricsRegistry
from ..resilience.retry import RetryPolicy
from .router import WorkerPool

logger = logging.getLogger(__name__)

__all__ = ["ManagedWorker", "ServingFleet"]


class ManagedWorker:
    """One supervised worker subprocess (mutated by the monitor only)."""

    def __init__(self, worker_id: str, cmd: list[str], port_file: Path,
                 log_path: Path):
        self.worker_id = worker_id
        self.cmd = cmd
        self.port_file = port_file
        self.log_path = log_path
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.restarts = 0
        self.restart_at: float | None = None
        self.slow_until: float | None = None

    @property
    def url(self) -> str | None:
        return f"http://127.0.0.1:{self.port}" if self.port else None

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ServingFleet:
    """Spawn and supervise N workers; keep a ``WorkerPool`` truthful.

    ``make_cmd(worker_id, port_file) -> list[str]`` builds the worker's
    argv (the CLI passes serve flags through; tests pass any process
    that writes its port to ``port_file`` and answers ``/readyz``).
    """

    def __init__(self, make_cmd, n_workers: int, workdir,
                 pool: WorkerPool | None = None,
                 poll_s: float = 0.5,
                 eject_after: int = 3,
                 health_timeout_s: float = 2.0,
                 max_restarts: int = 8,
                 backoff: RetryPolicy | None = None,
                 injector=None,
                 slowworker_s: float = 3.0,
                 env: dict | None = None,
                 registry: MetricsRegistry | None = None,
                 attach: bool = False,
                 chaos_channel: str = "fleet"):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.make_cmd = make_cmd
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.pool = pool if pool is not None else WorkerPool()
        self.poll_s = float(poll_s)
        self.eject_after = int(eject_after)
        self.health_timeout_s = float(health_timeout_s)
        self.max_restarts = int(max_restarts)
        self.backoff = backoff or RetryPolicy(
            max_attempts=max_restarts + 1, base_delay_s=0.5,
            multiplier=2.0, max_delay_s=15.0, jitter=0.1)
        self.injector = injector
        self.chaos_channel = str(chaos_channel)
        # The shard fleet's events carry ``channel="shard"``: the router's
        # log holds both fleets' events, whose worker ids (w0, w1, ...)
        # collide. The embed fleet's events are the JAX package's.
        self._tag = ({} if self.chaos_channel == "fleet"
                     else {"channel": self.chaos_channel})
        self.slowworker_s = float(slowworker_s)
        self.env = env
        self.registry = registry if registry is not None \
            else self.pool.registry
        r = self.registry
        self._spawns = r.counter("fleet_worker_spawns_total",
                                 "worker processes launched")
        self._worker_restarts = r.counter(
            "fleet_worker_restarts_total",
            "workers relaunched after death or ejection")
        self._ejections = r.counter(
            "fleet_worker_ejections_total",
            "workers killed after consecutive health failures")
        self._chaos_armed = False
        self._chaos_kills = 0
        self._chaos_slows = 0
        # Attach mode (router replication):
        # a REPLICA router observes the same worker pool a primary
        # fleet owns. It discovers workers from the primary's port
        # files and probes /readyz, but never spawns, kills, ejects, or
        # restarts — process supervision stays with the one fleet that
        # created the processes. Worker membership is fixed at attach
        # time (the primary's w*.port files present then).
        self.attach = bool(attach)
        if self.attach:
            found = sorted(self.workdir.glob("w*.port"))
            self.workers = [
                ManagedWorker(pf.stem, cmd=None, port_file=pf,
                              log_path=self.workdir
                              / f"{pf.stem}.attached.log")
                for pf in found
            ] or [
                ManagedWorker(f"w{i}", cmd=None,
                              port_file=self.workdir / f"w{i}.port",
                              log_path=self.workdir
                              / f"w{i}.attached.log")
                for i in range(int(n_workers))
            ]
        else:
            self.workers = [
                ManagedWorker(f"w{i}",
                              cmd=None,  # built at spawn (fresh file)
                              port_file=self.workdir / f"w{i}.port",
                              log_path=self.workdir / f"w{i}.log")
                for i in range(int(n_workers))
            ]
        # Dynamic membership: the autoscaler adds/retires
        # workers from the aggregator thread while the monitor thread
        # iterates — membership mutations and iteration both go
        # through this lock (iteration via workers_snapshot()).
        self._workers_lock = threading.Lock()
        self._next_ordinal = int(n_workers)
        # Wired by the CLI when --autoscale is on: the controller the
        # drainworker@T chaos action targets, and the flash-crowd hook
        # spike@T fires (serving/autoscale.py / scripts/loadgen.py).
        self.autoscaler = None
        self.on_spike = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def workers_snapshot(self) -> list[ManagedWorker]:
        """Stable view of the (now mutable) membership list."""
        with self._workers_lock:
            return list(self.workers)

    # -- process control ---------------------------------------------------
    def _spawn(self, worker: ManagedWorker) -> None:
        worker.port_file.unlink(missing_ok=True)
        worker.port = None
        worker.restart_at = None
        worker.slow_until = None
        worker.cmd = self.make_cmd(worker.worker_id, worker.port_file)
        try:
            log = open(worker.log_path, "ab")
            try:
                worker.proc = subprocess.Popen(
                    worker.cmd, stdout=log, stderr=subprocess.STDOUT,
                    env=self.env)
            finally:
                log.close()  # the child holds its own fd now
        except OSError as e:
            # A failed launch (fork/exec ENOMEM, transient FS trouble)
            # must reschedule, not strand the worker: restart_at was
            # cleared above and proc is None, so without this no later
            # tick would ever look at the worker again — silently lost
            # capacity.
            worker.proc = None
            logger.error("fleet: spawn of %s failed: %r",
                         worker.worker_id, e)
            self._schedule_restart(worker, f"spawn failed: {e}")
            return
        self._spawns.inc()
        obs_events.emit("fleet", action="spawn",
                        worker=worker.worker_id, pid=worker.proc.pid,
                        restarts=worker.restarts, **self._tag)
        logger.info("fleet: spawned %s (pid %d)", worker.worker_id,
                    worker.proc.pid)

    def _kill(self, worker: ManagedWorker) -> None:
        if worker.proc is not None and worker.proc.poll() is None:
            try:
                worker.proc.kill()
                worker.proc.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass

    def _schedule_restart(self, worker: ManagedWorker,
                          reason: str) -> None:
        # The failure count belonged to the incarnation that just died;
        # the replacement must boot with a clean slate or the eject
        # check fires again before its port file even appears.
        self.pool.clear_failures(worker.worker_id)
        worker.restarts += 1
        if worker.restarts > self.max_restarts:
            logger.error("fleet: %s exceeded %d restarts (%s) — leaving "
                         "it down", worker.worker_id, self.max_restarts,
                         reason)
            worker.restart_at = None
            return
        delay = self.backoff.delay_for(min(worker.restarts,
                                           self.backoff.max_attempts))
        worker.restart_at = time.monotonic() + delay
        self._worker_restarts.inc()
        obs_events.emit("fleet", action="restart_scheduled",
                        worker=worker.worker_id, reason=reason,
                        restart=worker.restarts,
                        max_restarts=self.max_restarts,
                        delay_s=round(delay, 3), **self._tag)
        logger.warning("fleet: %s down (%s) — restart %d/%d in %.2fs",
                       worker.worker_id, reason, worker.restarts,
                       self.max_restarts, delay)

    # -- dynamic membership (the autoscaler's surface) ---------------------
    def add_worker(self) -> ManagedWorker | None:
        """Spawn one NEW worker through the normal supervision path
        (fresh ordinal, port file, /readyz probing, restart budget).
        The caller gates pool-size bounds; this only creates. Returns
        None in attach mode — a replica router must never spawn
        processes the primary owns."""
        if self.attach:
            logger.warning("fleet: add_worker ignored in attach mode")
            return None
        with self._workers_lock:
            worker_id = f"w{self._next_ordinal}"
            self._next_ordinal += 1
            worker = ManagedWorker(
                worker_id, cmd=None,
                port_file=self.workdir / f"{worker_id}.port",
                log_path=self.workdir / f"{worker_id}.log")
            self.workers.append(worker)
        self._spawn(worker)
        return worker

    def retire_worker(self, worker_id: str,
                      grace_s: float = 5.0) -> bool:
        """Permanently remove one worker: membership first (so the
        monitor never reads its death as a crash and restarts it), then
        the pool entry (no more routes), then SIGTERM with a background
        SIGKILL fallback after ``grace_s``. The CALLER owns the zero-
        5xx part — this must only run once the victim is drained (no
        in-flight requests), which is the autoscale controller's drain
        state machine's job."""
        with self._workers_lock:
            worker = next((w for w in self.workers
                           if w.worker_id == worker_id), None)
            if worker is None:
                return False
            self.workers.remove(worker)
        self.pool.remove(worker_id)
        obs_events.emit("fleet", action="retire", worker=worker_id,
                        pid=worker.pid, **self._tag)
        logger.info("fleet: retiring %s (pid %s)", worker_id, worker.pid)
        proc = worker.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
            except OSError:
                pass

            def _reap() -> None:
                try:
                    proc.wait(timeout=grace_s)
                except subprocess.TimeoutExpired:
                    try:
                        proc.kill()
                        proc.wait(timeout=5.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass

            # The reap must not stall the calling thread (the federation
            # tick the controller rides): TERM now, KILL later if the
            # worker ignores it.
            threading.Thread(target=_reap, daemon=True,
                             name=f"ntxent-fleet-reap-{worker_id}"
                             ).start()
        worker.port_file.unlink(missing_ok=True)
        return True

    # -- health ------------------------------------------------------------
    def _probe(self, worker: ManagedWorker) -> None:
        """One /readyz probe; updates the pool and the failure count."""
        if worker.port is None:
            try:
                text = worker.port_file.read_text().strip()
                worker.port = int(text) if text else None
            except (OSError, ValueError):
                worker.port = None
            if worker.port is None:
                return  # still booting: not a failure, not ready
            self.pool.upsert(worker.worker_id, worker.url)
        try:
            req = urllib.request.Request(worker.url + "/readyz")
            with urllib.request.urlopen(
                    req, timeout=self.health_timeout_s) as resp:
                body = json.loads(resp.read())
            self.pool.set_health(worker.worker_id, alive=True, ready=True,
                                 checkpoint_step=body.get(
                                     "checkpoint_step"))
        except urllib.error.HTTPError as e:
            # 503 = alive but warming/draining: healthy process, no
            # traffic. Anything else odd counts as a failure.
            try:
                body = json.loads(e.read())
            except Exception:  # noqa: BLE001
                body = {}
            if e.code == 503:
                self.pool.set_health(worker.worker_id, alive=True,
                                     ready=False,
                                     checkpoint_step=body.get(
                                         "checkpoint_step"))
            else:
                self.pool.set_health(worker.worker_id, alive=True,
                                     ready=False)
                self.pool.report_failure(worker.worker_id,
                                         f"readyz http {e.code}",
                                         kind="probe")
        except (urllib.error.URLError, OSError, ValueError) as e:
            # a timeout of a live worker marks it busy, not gone (logged:
            # JAX's fleet neither marks nor logs it)
            alive = worker.alive()
            busy = alive and isinstance(getattr(e, "reason", e),
                                        TimeoutError)
            self.pool.set_health(worker.worker_id, alive=alive, ready=False,
                                 busy=busy)
            if busy:
                obs_events.emit("fleet", action="probe_timeout",
                                worker=worker.worker_id,
                                timeout_s=self.health_timeout_s,
                                **self._tag)
            self.pool.report_failure(worker.worker_id, repr(e),
                                     kind="probe")
            if self.attach:
                # The primary may have restarted this worker on a NEW
                # port: forget the cached one so the next tick re-reads
                # the port file the primary republished.
                worker.port = None

    # -- chaos -------------------------------------------------------------
    def _apply_chaos(self) -> None:
        if self.injector is None:
            return
        if not self._chaos_armed:
            # Chaos ordinals count from the first tick where EVERY
            # worker is ready: a plan like killworker@20 must hit a
            # serving fleet at a deterministic point, not a booting one
            # at whatever tick the workers' start happened to finish on.
            if sum(1 for w in self.pool.workers()
                   if w.ready) < len(self.workers_snapshot()):
                return
            self._chaos_armed = True
        if self.chaos_channel == "shard":
            # A shard fleet pulls its OWN ordinal stream: killshard@3
            # means "3 ticks after the shard plane armed", independent
            # of how many embed-fleet ticks the same injector served.
            actions = self.injector.on_shard_tick()
        else:
            actions = self.injector.on_fleet_tick()
        for action in actions:
            if action.startswith("spike"):
                # Flash crowd: no process to signal — the
                # CLI wires on_spike to a loadgen burst against the
                # router so the AUTOSCALER is what gets exercised.
                hook = self.on_spike
                if hook is None:
                    logger.warning("fleet chaos: %s due but no spike "
                                   "hook wired (--autoscale off?)",
                                   action)
                    continue
                logger.warning("fleet chaos: firing flash-crowd hook "
                               "(%s)", action)
                try:
                    hook(action)
                except Exception:  # noqa: BLE001 — chaos must not take
                    # down supervision.
                    logger.exception("fleet chaos: spike hook failed")
                continue
            if action.startswith("drainworker"):
                ctl = self.autoscaler
                if ctl is None:
                    logger.warning("fleet chaos: %s due but no "
                                   "autoscaler attached", action)
                    continue
                logger.warning("fleet chaos: forcing a drain-down (%s)",
                               action)
                ctl.force_drain(reason="chaos")
                continue
            live = [w for w in self.workers_snapshot() if w.alive()]
            if not live:
                logger.warning("fleet chaos: %s due but no live worker",
                               action)
                continue
            if action.startswith(("killworker", "killshard")):
                target = live[self._chaos_kills % len(live)]
                self._chaos_kills += 1
                logger.warning("fleet chaos: SIGKILL %s (pid %s)",
                               target.worker_id, target.pid)
                try:
                    os.kill(target.pid, signal.SIGKILL)
                except OSError:
                    pass
            elif action.startswith(("slowworker", "lagshard")):
                target = live[self._chaos_slows % len(live)]
                self._chaos_slows += 1
                logger.warning("fleet chaos: SIGSTOP %s for %.1fs "
                               "(pid %s)", target.worker_id,
                               self.slowworker_s, target.pid)
                try:
                    os.kill(target.pid, signal.SIGSTOP)
                    target.slow_until = (time.monotonic()
                                         + self.slowworker_s)
                except OSError:
                    pass

    # -- the supervision loop ----------------------------------------------
    def tick(self) -> None:
        """One supervision cycle (public: tests drive it directly)."""
        if self.attach:
            # Probe-only: a replica must never kill/eject/restart
            # processes the primary owns — health observation is the
            # whole job. (Its own forward failures still accumulate in
            # the shared pool entry and gate ITS routing via ready.)
            for worker in self.workers_snapshot():
                self._probe(worker)
            return
        self._apply_chaos()
        now = time.monotonic()
        for worker in self.workers_snapshot():
            if worker.slow_until is not None and now >= worker.slow_until:
                try:
                    os.kill(worker.pid, signal.SIGCONT)
                except (OSError, TypeError):
                    pass
                worker.slow_until = None
            if not worker.alive():
                if worker.proc is not None and worker.restart_at is None:
                    rc = worker.proc.poll()
                    self.pool.set_health(worker.worker_id, alive=False,
                                         ready=False)
                    obs_events.emit("fleet", action="death",
                                    worker=worker.worker_id, rc=rc,
                                    **self._tag)
                    self._schedule_restart(worker, f"exited rc={rc}")
                    worker.proc = None
                    # Flight dump AT the death: the event
                    # tail — health probes, the death, the scheduled
                    # restart — is the postmortem, captured now rather
                    # than reconstructed. No-op without an installed
                    # event log.
                    obs_events.dump_flight(
                        reason=f"worker_death:{worker.worker_id}:"
                               f"rc={rc}")
                if worker.restart_at is not None \
                        and now >= worker.restart_at:
                    self._spawn(worker)
                continue
            self._probe(worker)
            entry = next((w for w in self.pool.workers()
                          if w.worker_id == worker.worker_id), None)
            if entry is not None \
                    and entry.consecutive_failures >= self.eject_after:
                self._ejections.inc()
                logger.warning(
                    "fleet: ejecting %s after %d consecutive failures "
                    "(last: %s)", worker.worker_id,
                    entry.consecutive_failures, entry.last_error)
                obs_events.emit("fleet", action="eject",
                                worker=worker.worker_id,
                                failures=entry.consecutive_failures,
                                last_error=entry.last_error, **self._tag)
                self.pool.set_health(worker.worker_id, alive=False,
                                     ready=False)
                self._kill(worker)
                self._schedule_restart(worker, "ejected")
                worker.proc = None
                obs_events.dump_flight(
                    reason=f"worker_eject:{worker.worker_id}")

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — supervision must survive
                # any single bad tick (a worker dying mid-probe, a
                # filesystem hiccup on a port file).
                logger.exception("fleet: supervision tick failed")

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingFleet":
        if self._thread is not None:
            raise RuntimeError("fleet already started")
        if not self.attach:
            for worker in self.workers:
                self._spawn(worker)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ntxent-fleet-monitor")
        self._thread.start()
        return self

    def wait_ready(self, n: int | None = None,
                   timeout_s: float = 120.0) -> bool:
        """Block until ``n`` workers (default: all) pass /readyz."""
        want = len(self.workers_snapshot()) if n is None else int(n)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if sum(1 for w in self.pool.workers() if w.ready) >= want:
                return True
            time.sleep(0.1)
        return False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_s * 4 + 5.0)
            self._thread = None
        workers = self.workers_snapshot()
        for worker in workers:
            if worker.proc is not None and worker.proc.poll() is None:
                worker.proc.terminate()
        deadline = time.monotonic() + 5.0
        for worker in workers:
            if worker.proc is None:
                continue
            try:
                worker.proc.wait(timeout=max(0.1, deadline
                                             - time.monotonic()))
            except subprocess.TimeoutExpired:
                self._kill(worker)
