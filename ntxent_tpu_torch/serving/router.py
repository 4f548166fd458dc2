"""Fault-tolerant router tier: many workers, one front door.
Counterpart of ``ntxent_tpu/serving/router.py`` (stdlib and numpy),
with its retrieval surface (``/search``, ``/index``, ``/index/insert``,
``/embed?store=true``) over ``ntxent_tpu_torch/retrieval``.

One ``EmbeddingServer`` is a single point of failure, a single queue,
and a restart-equals-outage deployment model. ``FleetRouter`` is the
stdlib-HTTP tier that fixes all three: it
spreads ``/embed`` load over N worker replicas, retries failed
forwards on the surviving workers, sheds load with the existing 429 +
Retry-After semantics when every worker is saturated, serves repeated
rows from the ``EmbeddingCache`` without any worker seeing them, and
canaries new-checkpoint workers at a configurable traffic fraction
with automatic rollback on an error-rate breach.

Failure semantics per forwarded request (the per-request retry budget
that turns a worker SIGKILL into zero client-visible 5xx):

* connection errors and worker 5xx count against the worker
  (``WorkerPool.report_failure`` — the fleet supervisor ejects after
  consecutive failures) and the request retries on a DIFFERENT worker,
  up to ``retries`` extra attempts;
* a worker 429 is saturation, not failure: the router tries another
  worker, and only when every attempted worker is saturated does the
  client see a 429 carrying the largest Retry-After observed;
* worker 4xx (bad request, 413, 504) is the CLIENT's problem and
  passes through verbatim on the first occurrence — retrying a 400 on
  another replica would just fail twice;
* budget exhausted on 5xx: the client receives the WORKER's status
  code and error body (never a synthetic router error that hides the
  cause); with no ready workers at all the answer is an immediate 503,
  never a hang. A worker whose last /readyz probe only timed out (alive,
  its listener slow under load) still takes requests when no ready
  worker remains (``WorkerPool.pick``): the JAX router answers those
  503.

Canary state machine (one rollout at a time, owned by the pool lock):

  ``trusted`` — all ready workers serve the trusted step: plain
  least-in-flight routing.
  ``canarying`` — some ready worker reports a step newer than the
  trusted one (the staggered watcher put it there): the router routes
  ``canary_fraction`` of requests to the new-step cohort and counts
  outcomes. 429s are neutral (saturation says nothing about the
  model).
  promote — at ``canary_min_requests`` outcomes with error rate <=
  ``canary_max_error_rate`` the new step becomes trusted (and the
  cache flushes: embeddings from the old model must not outlive it).
  rollback — on breach the step is marked bad, every worker serving
  it gets ``POST /rollback`` (worker.py reverts and blocklists), and
  routing is old-cohort-only again — "canary rollback restores
  old-checkpoint routing".

Request identity: the router mints ``X-Request-Id`` at its edge and
forwards it, so one id threads cache -> route -> worker queue ->
device chunk in the exported trace; a cache hit emits a ``fleet.cache``
slice under the same id — a cached answer explains itself instead of
looking like a mysteriously fast worker.

Retrieval surface (``attach_index``): ``POST /search``
embeds the query rows through the fleet and answers top-k ids+scores
from the checkpoint-step-versioned ANN index (``retrieval/``)
— the version MATCHING the step that embedded the query, so a rollout
window's laggard-served queries search the space they were embedded
in. ``POST /embed?store=true`` and ``POST /index/insert`` feed the
index, trust-gated exactly like cache inserts (a canary model's
vectors must not survive its own rollback). The rollout state machine
drives index versions: promote cuts searches to the new step's index
and rebuilds it by background re-embedding, a fleet-wide rollback
(every ready worker reverting below the trusted step) demotes the
trusted step AND restores the prior index version, and a drift-reason
canary breach marks the live index stale, forcing a rebuild.

Admission control (``TenantAdmission``): per-tenant token
buckets keyed on the ``X-Tenant`` request header (bare requests share
the default tenant) meter ``/embed`` AND ``/search`` by row count, so
saturation degrades per tenant (the over-quota tenant 429s, everyone
else keeps their rate) instead of FIFO. Exhaustion answers 429 +
``Retry-After`` — the same shed contract the worker queue uses — and
the ``tenant`` label is cardinality-bounded router-side: at most
``max_tenants`` tracked values, the rest melt into ``other``.
"""

from __future__ import annotations

import functools
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..obs import events as _events
from ..obs import trace as _trace
from ..obs.exporters import PROMETHEUS_CONTENT_TYPE, choose_format
from ..obs.registry import MetricsRegistry
from ..obs.slo import AlertStore
from .cache import EmbeddingCache, row_key
from .limits import MAX_BODY_BYTES

logger = logging.getLogger(__name__)

__all__ = ["WorkerEntry", "WorkerPool", "FleetRouter", "TokenBucket",
           "TenantAdmission"]


def _step_header(headers) -> int | None:
    """Parse the worker's ``X-Checkpoint-Step`` response label. The
    worker stamps it at reply time, so it names the model that ACTUALLY
    served — the pool's health-probe view lags a hot swap by up to a
    poll interval, and cache/canary accounting must not mislabel that
    window's responses."""
    raw = headers.get("X-Checkpoint-Step") if headers is not None else None
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        return None


class TokenBucket:
    """One tenant's admission budget: ``rate`` tokens/s refill toward a
    ``burst`` cap (monotonic clock; float tokens so fractional rates
    work). ``try_take`` is the whole API — atomic under the owner's
    lock (``TenantAdmission`` serializes callers; a bare bucket in
    tests is single-threaded)."""

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0.0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        # Default burst = 1 second of rate (and never below one token,
        # or a sub-1/s quota could not admit ANY request).
        self.burst = max(1.0, float(burst if burst is not None else rate))
        self.tokens = self.burst
        self._stamp = time.monotonic()

    def try_take(self, cost: float = 1.0,
                 now: float | None = None) -> tuple[bool, float]:
        """Spend ``cost`` tokens if available. Returns ``(admitted,
        retry_after_s)`` — the wait is 0.0 on admit, else the refill
        time until ``cost`` tokens would exist. (A cost past the burst
        cap can never be admitted by waiting; the uncapped hint is
        still monotone and nonzero, which beats advertising an instant
        retry that will 429 forever.)"""
        now = time.monotonic() if now is None else now
        elapsed = max(0.0, now - self._stamp)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self._stamp = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True, 0.0
        return False, (cost - self.tokens) / self.rate


class TenantAdmission:
    """Per-tenant token-bucket quotas over the router's request paths.

    ``quotas`` pins named tenants to explicit ``(rate, burst)``; any
    other tenant gets the default quota, lazily. Cardinality is
    bounded HERE, not at the scrape: clients pick their own
    ``X-Tenant`` values, so past ``max_tenants`` distinct names every
    new tenant shares one ``"other"`` bucket and label value — an
    adversarial header can neither explode the registry nor mint
    itself a fresh budget per request.
    """

    OTHER = "other"

    def __init__(self, default_rate: float = 100.0,
                 default_burst: float | None = None,
                 quotas: dict[str, tuple[float, float | None]]
                 | None = None,
                 registry: MetricsRegistry | None = None,
                 max_tenants: int = 32,
                 default_tenant: str = "default"):
        self.default_rate = float(default_rate)
        self.default_burst = default_burst
        self.default_tenant = str(default_tenant)
        self.max_tenants = int(max_tenants)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._buckets: dict[str, TokenBucket] = {}
        self._counters: dict[tuple[str, str], object] = {}
        self._pinned = set()
        for name, (rate, burst) in sorted((quotas or {}).items()):
            self._buckets[str(name)] = TokenBucket(rate, burst)
            self._pinned.add(str(name))

    def _normalize(self, tenant: str | None) -> str:
        tenant = (tenant or "").strip()
        if not tenant:
            return self.default_tenant
        # Exposition-legal label value, bounded length: the header is
        # attacker-controlled wire input.
        tenant = "".join(c if c.isalnum() or c in "-_.:" else "_"
                         for c in tenant[:64])
        return tenant or self.default_tenant

    def _bucket_locked(self, tenant: str) -> tuple[str, TokenBucket]:
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            return tenant, bucket
        if len(self._buckets) >= self.max_tenants:
            bucket = self._buckets.get(self.OTHER)
            if bucket is None:
                bucket = self._buckets[self.OTHER] = TokenBucket(
                    self.default_rate, self.default_burst)
            return self.OTHER, bucket
        bucket = self._buckets[tenant] = TokenBucket(
            self.default_rate, self.default_burst)
        return tenant, bucket

    def _count_locked(self, outcome: str, tenant: str) -> None:
        counter = self._counters.get((outcome, tenant))
        if counter is None:
            name = f"tenant_{outcome}_total"
            counter = self._counters[(outcome, tenant)] = \
                self.registry.counter(
                    name, f"requests {outcome} by the per-tenant "
                          "admission buckets",
                    labels={"tenant": tenant})
        counter.inc()

    def admit(self, tenant: str | None,
              cost: float = 1.0,
              now: float | None = None) -> tuple[bool, float]:
        """Meter one request of ``cost`` rows for ``tenant``. Returns
        ``(admitted, retry_after_s)`` and counts the outcome under the
        (bounded) tenant label."""
        name = self._normalize(tenant)
        with self._lock:
            name, bucket = self._bucket_locked(name)
            ok, retry_after = bucket.try_take(cost, now=now)
            self._count_locked("admitted" if ok else "rejected", name)
        return ok, retry_after

    def snapshot(self) -> dict:
        """Tenant -> remaining tokens (observability surface; the
        authoritative counters live in the registry)."""
        with self._lock:
            return {name: round(b.tokens, 3)
                    for name, b in sorted(self._buckets.items())}


class WorkerEntry:
    """One worker replica as the router sees it (mutated under the
    pool's lock; plain attributes — this is a record, not an actor)."""

    def __init__(self, worker_id: str, url: str):
        self.worker_id = worker_id
        self.url = url.rstrip("/")
        self.alive = False
        self.ready = False
        # Draining: still alive and probing healthy, but the
        # autoscaler has marked it for retirement — selection skips it,
        # its in-flight requests complete, and the controller SIGTERMs
        # only once inflight hits zero (or the drain deadline passes).
        self.draining = False
        # Busy: alive, but its last /readyz probe timed out (a listener
        # slow under load, not a dead or warming worker). Not ready;
        # selection falls back to it only when no ready worker remains.
        self.busy = False
        self.checkpoint_step: int | None = None
        self.inflight = 0
        self.consecutive_failures = 0
        # What produced the latest failure ("probe" | "forward"): a
        # healthy /readyz probe is evidence against a PROBE-failure
        # streak only — it says nothing about /embed, so it must not
        # wipe router-reported forward failures before the fleet's
        # eject check ever sees them.
        self.last_failure_kind: str | None = None
        self.last_error: str | None = None

    def snapshot(self) -> dict:
        return {"url": self.url, "alive": self.alive, "ready": self.ready,
                "draining": self.draining,
                "checkpoint_step": self.checkpoint_step,
                "inflight": self.inflight,
                "consecutive_failures": self.consecutive_failures,
                "last_error": self.last_error}


class WorkerPool:
    """Thread-safe worker table + selection + canary state machine.

    The fleet supervisor (fleet.py) writes membership and health; the
    router reads selections and reports per-request outcomes. Both the
    router's forward failures and the supervisor's health-probe
    failures land in ``consecutive_failures`` — one ejection signal,
    two observers. Resets are evidence-matched: a successful forward
    clears the counter outright, while a passing /readyz probe clears
    it only when the streak is probe-originated (a listening worker
    that 500s every /embed must still reach the eject threshold).
    """

    def __init__(self, canary_fraction: float = 0.25,
                 canary_min_requests: int = 20,
                 canary_max_error_rate: float = 0.1,
                 shadow_max_drift: float | None = None,
                 shadow_min_samples: int = 8,
                 registry: MetricsRegistry | None = None):
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError(f"canary_fraction must be in (0, 1], got "
                             f"{canary_fraction}")
        self.canary_fraction = float(canary_fraction)
        self.canary_min_requests = int(canary_min_requests)
        self.canary_max_error_rate = float(canary_max_error_rate)
        # Shadow drift gate: when set, a canary may only
        # promote once its mirrored-traffic drift p99 is at or under
        # this bound (see serving/shadow.py); a breach rolls back even
        # with a clean error rate.
        self.shadow_max_drift = (float(shadow_max_drift)
                                 if shadow_max_drift is not None
                                 else None)
        self.shadow_min_samples = int(shadow_min_samples)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerEntry] = {}
        self.trusted_step: int | None = None
        # Fired (outside the lock) when the FIRST checkpoint step is
        # adopted as trusted via set_health — there was no canary to
        # decide, so this is the router's only signal to flush
        # random-init-weight embeddings out of its cache.
        self.on_trusted_adopt = None
        # Fired (outside the lock, as (new_step, old_step)) when the
        # trusted step DEMOTES: every ready worker reports a step older
        # than the trusted one — the fleet was force-rolled-back
        # beneath the router (operator /rollback broadcast, checkpoint
        # dir rewound). Without demotion the router would gate cache/
        # index inserts against a step nobody serves forever; with it
        # the cache flushes and the retrieval tier restores the prior
        # index version.
        self.on_trusted_rollback = None
        self.bad_steps: set[int] = set()
        self._canary_step: int | None = None
        self._canary_ok = 0
        self._canary_err = 0
        self._canary_drift: list[float] = []
        # What the last promote/rollback verdict was based on — the
        # router's alert path reads this right after observe()/
        # observe_drift() returns a decision (the decision tuple
        # itself stays (action, step): existing consumers unpack it).
        self.last_verdict: dict = {}
        self._rr = 0  # request counter driving the canary fraction
        r = self.registry
        self._ready_gauge = r.gauge("fleet_workers_ready",
                                    "workers passing /readyz")
        self._alive_gauge = r.gauge("fleet_workers_alive",
                                    "workers with a live process")
        self._trusted_gauge = r.gauge(
            "fleet_trusted_step",
            "checkpoint step the router currently trusts "
            "(-1 = none yet)")
        self._trusted_gauge.set(-1)
        self._canary_requests = r.counter(
            "fleet_canary_requests_total",
            "requests routed to a canary-step worker")
        self._canary_errors = r.counter(
            "fleet_canary_errors_total",
            "canary-routed requests that failed (5xx/unreachable)")
        self._promotions = r.counter(
            "fleet_promotions_total",
            "canary steps promoted to trusted")
        self._rollbacks = r.counter(
            "fleet_rollbacks_total",
            "canary steps rolled back on error-rate breach")
        self._shadow_breaches = r.counter(
            "fleet_shadow_breaches_total",
            "canary rollbacks forced by the drift bar "
            "(error rate alone would have promoted)")
        self._demotions = r.counter(
            "fleet_trusted_demotions_total",
            "trusted-step demotions (every ready worker reverted "
            "below the trusted step — a fleet-wide rollback)")

    # -- membership / health (the fleet supervisor's surface) -------------
    def upsert(self, worker_id: str, url: str) -> WorkerEntry:
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None or entry.url != url.rstrip("/"):
                prior = entry
                entry = WorkerEntry(worker_id, url)
                if prior is not None:
                    # A restarted incarnation (new port) inherits the
                    # dead one's last-reported step until its first
                    # probe overwrites it: the entry keeps pinning the
                    # trusted step through the restart window, so a
                    # lone crash can never read as a fleet-wide
                    # rollback (_maybe_demote_locked). Routing is
                    # unaffected — the entry starts not-ready.
                    entry.checkpoint_step = prior.checkpoint_step
                self._workers[worker_id] = entry
            self._update_gauges()
            return entry

    def remove(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)
            self._update_gauges()

    def set_health(self, worker_id: str, alive: bool, ready: bool,
                   checkpoint_step: int | None = None,
                   busy: bool = False) -> None:
        """A probe's verdict; ``busy``: the probe of a live worker timed
        out (see ``WorkerEntry.busy``)."""
        adopted: int | None = None
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None:
                return
            entry.alive = alive
            entry.ready = ready and alive
            entry.busy = busy and alive and not ready
            if checkpoint_step is not None:
                entry.checkpoint_step = int(checkpoint_step)
            if ready and alive \
                    and entry.last_failure_kind != "forward":
                # A passing probe closes a probe-failure streak. It is
                # NOT evidence that /embed works — a worker 500ing
                # every forward while answering /readyz 200 must still
                # accumulate toward ejection (only a successful forward
                # resets that streak).
                entry.consecutive_failures = 0
                entry.last_failure_kind = None
            if self.trusted_step is None \
                    and entry.checkpoint_step is not None:
                # First observed version becomes the trusted baseline —
                # there is nothing to canary against before it.
                self.trusted_step = adopted = entry.checkpoint_step
                self._trusted_gauge.set(self.trusted_step)
            demoted = self._maybe_demote_locked()
            self._update_gauges()
        if demoted is not None and self.on_trusted_rollback is not None:
            # Outside the lock for the same reason as the adopt hook:
            # the router flushes its cache and rolls the retrieval
            # index back to the restored step's version.
            new_step, old_step = demoted
            try:
                self.on_trusted_rollback(new_step, old_step)
            except Exception:  # noqa: BLE001 — a hook failure must not
                # poison health reporting.
                logger.exception("on_trusted_rollback hook failed")
        if adopted is not None and self.on_trusted_adopt is not None:
            # Outside the lock: the hook flushes the router's cache
            # (which takes its own lock) — any embeddings cached while
            # workers served random init must not outlive the first
            # real model.
            try:
                self.on_trusted_adopt(adopted)
            except Exception:  # noqa: BLE001 — a hook failure must not
                # poison health reporting.
                logger.exception("on_trusted_adopt hook failed")

    def _maybe_demote_locked(self) -> tuple[int, int] | None:
        """Detect a fleet-wide rollback (lock held): every KNOWN
        worker step is strictly older than the trusted one (with at
        least one worker ready), and no canary verdict is pending (an
        armed canary IS a worker at a newer step, so the two states
        cannot overlap). Demotes trusted to the newest step actually
        served and returns ``(new_step, old_step)``; None when nothing
        changed.

        Judging every entry's LAST-REPORTED step — not just live
        workers' — is what makes both failure windows safe: a
        warming/draining trusted-step worker still reports its step
        and pins trusted (the stagger window), and so does the ENTRY
        of a crashed trusted-step worker mid-restart (its step
        survives the death; a lone crash during a rollout must not
        read as an operator rollback). A genuine fleet-wide rollback
        updates every entry's reported step as the reverted workers
        answer /readyz. The cost is the conservative direction: a
        trusted-step worker that dies FOREVER (restart budget
        exhausted) pins trusted until its entry is removed — searches
        still answer (version-matched) and inserts stay gated, which
        beats spuriously flushing the cache and rolling the index
        back on a crash."""
        if self.trusted_step is None or self._canary_step is not None:
            return None
        known_steps = [w.checkpoint_step for w in self._workers.values()
                       if w.checkpoint_step is not None]
        ready_steps = [w.checkpoint_step for w in self._workers.values()
                       if w.ready and w.checkpoint_step is not None]
        if not ready_steps or not known_steps \
                or any(s >= self.trusted_step for s in known_steps):
            return None
        old = self.trusted_step
        self.trusted_step = max(ready_steps)
        self._trusted_gauge.set(self.trusted_step)
        self._demotions.inc()
        logger.warning("fleet rolled back beneath the router: trusted "
                       "step %d -> %d (every live worker reverted)",
                       old, self.trusted_step)
        return (self.trusted_step, old)

    def report_failure(self, worker_id: str, error: str = "",
                       kind: str = "forward") -> int:
        """A failed forward or health probe (``kind``: "forward" |
        "probe"); returns the consecutive count (the fleet ejects past
        its threshold)."""
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None:
                return 0
            entry.consecutive_failures += 1
            entry.last_failure_kind = kind
            entry.last_error = error or entry.last_error
            return entry.consecutive_failures

    def report_success(self, worker_id: str) -> None:
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is not None:
                entry.consecutive_failures = 0
                entry.last_failure_kind = None
                entry.last_error = None

    def clear_failures(self, worker_id: str) -> None:
        """Reset the consecutive-failure count but KEEP last_error (the
        post-mortem). The fleet calls this when it schedules a restart:
        the failures belonged to the dead incarnation, and carrying
        them over would insta-eject the replacement while it is still
        booting — before it can even publish its port."""
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is not None:
                entry.consecutive_failures = 0
                entry.last_failure_kind = None

    def _update_gauges(self) -> None:
        self._ready_gauge.set(sum(1 for w in self._workers.values()
                                  if w.ready))
        self._alive_gauge.set(sum(1 for w in self._workers.values()
                                  if w.alive))

    # -- drain-down (the autoscaler's surface) -----------------------------
    def set_draining(self, worker_id: str, draining: bool = True) -> bool:
        """Mark/unmark a worker draining (no new routes; in-flight
        completes). Returns False when the worker is unknown."""
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None:
                return False
            entry.draining = bool(draining)
            return True

    def inflight_of(self, worker_id: str) -> int:
        """In-flight request count for one worker (0 when unknown) —
        the drain state machine's completion signal."""
        with self._lock:
            entry = self._workers.get(worker_id)
            return entry.inflight if entry is not None else 0

    def routable_count(self) -> int:
        """Ready, non-draining workers — the pool size the autoscaler
        reasons about (a draining victim no longer carries load)."""
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if w.ready and not w.draining)

    # -- selection ---------------------------------------------------------
    def _is_canary(self, entry: WorkerEntry) -> bool:
        return (self.trusted_step is not None
                and entry.checkpoint_step is not None
                and entry.checkpoint_step > self.trusted_step
                and entry.checkpoint_step not in self.bad_steps)

    def pick(self, exclude: set[str] | None = None) -> WorkerEntry | None:
        """Least-in-flight selection with canary fractioning; None when
        no ready or busy worker remains (the router's immediate-503
        case). Increments the chosen worker's inflight (caller must
        ``done``).
        """
        exclude = exclude or set()
        with self._lock:
            # A draining worker is invisible to selection AND to canary
            # arming: it keeps probing ready (so the fleet does not
            # eject it mid-drain) while its in-flight requests finish,
            # but it must receive zero NEW routes — that is the whole
            # zero-5xx scale-down contract (serving/autoscale.py).
            all_ready = [w for w in self._workers.values()
                         if w.ready and not w.draining]
            if not all_ready:
                # A worker whose probe only timed out beats a 503: it is
                # alive and answers forwards, slowly. (A difference from
                # the JAX router, which answers 503: with one worker left
                # under load, a probe past its timeout turned into
                # client-visible 503s.)
                all_ready = [w for w in self._workers.values()
                             if w.busy and not w.draining]
            ready = [w for w in all_ready
                     if w.worker_id not in exclude]
            if not ready:
                return None
            # Canary ARMING considers every ready worker: a failover
            # retry that excludes the canary (its 5xx is exactly the
            # evidence being counted) must not reset the breach
            # accounting mid-verdict.
            armed = [w for w in all_ready if self._is_canary(w)]
            if armed:
                # One rollout at a time: canary the NEWEST new step.
                newest = max(w.checkpoint_step for w in armed)
                if self._canary_step != newest:
                    self._canary_step = newest
                    self._canary_ok = self._canary_err = 0
                    self._canary_drift = []
            else:
                self._canary_step = None
            canaries = [w for w in ready
                        if self._is_canary(w)
                        and w.checkpoint_step == self._canary_step]
            bad = [w for w in ready
                   if w.checkpoint_step in self.bad_steps]
            old = [w for w in ready if not self._is_canary(w)
                   and w not in bad]
            if canaries and old:
                self._rr += 1
                period = max(1, round(1.0 / self.canary_fraction))
                cohort = canaries if self._rr % period == 0 else old
            elif canaries:
                cohort = canaries  # nothing older is ready
            else:
                # A bad-step worker beats a 503; ``ready`` itself is the
                # last resort (every selectable worker is a non-newest
                # canary — traffic must still flow).
                cohort = old or bad or ready
            entry = min(cohort, key=lambda w: (w.inflight, w.worker_id))
            entry.inflight += 1
            return entry

    def done(self, worker_id: str) -> None:
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is not None and entry.inflight > 0:
                entry.inflight -= 1

    def canary_step(self) -> int | None:
        """The undecided canary step, if any (the shadow mirror's
        arming check)."""
        with self._lock:
            return self._canary_step

    def pick_step(self, step: int) -> WorkerEntry | None:
        """Least-in-flight ready worker AT a specific checkpoint step
        (the shadow mirror's canary target selection); None when no
        such worker is ready. Increments inflight (caller must
        ``done``)."""
        with self._lock:
            cohort = [w for w in self._workers.values()
                      if w.ready and not w.draining
                      and w.checkpoint_step == step]
            if not cohort:
                return None
            entry = min(cohort, key=lambda w: (w.inflight, w.worker_id))
            entry.inflight += 1
            return entry

    def allow_cache_insert(self, served_step: int | None) -> bool:
        """Only embeddings from the TRUSTED model may enter the cache:
        no inserts while a canary is undecided (a canary model's
        embeddings must not survive its own rollback), and a response
        from a non-trusted step (a promote/rollback raced the forward)
        must not poison the freshly flushed cache."""
        with self._lock:
            if self._canary_step is not None:
                return False
            if served_step is None or self.trusted_step is None:
                return True
            return served_step == self.trusted_step

    # -- canary accounting -------------------------------------------------
    def _drift_p99_locked(self) -> float | None:
        if not self._canary_drift:
            return None
        from ..obs.registry import quantile

        return quantile(sorted(self._canary_drift), 0.99)

    def _decide_locked(self, promote: bool,
                       verdict: dict) -> tuple[str, int]:
        """Finalize the pending canary (lock held): reset the verdict
        state and apply the decision. ``verdict`` lands in
        ``last_verdict`` for the router's alert path."""
        decided = self._canary_step
        self._canary_step = None
        self._canary_ok = self._canary_err = 0
        self._canary_drift = []
        self.last_verdict = {"step": decided, **verdict}
        if promote:
            self.trusted_step = decided
            self._trusted_gauge.set(decided)
            self._promotions.inc()
            logger.info("canary: promoted step %d (%s)", decided,
                        verdict)
            return ("promote", decided)
        self.bad_steps.add(decided)
        self._rollbacks.inc()
        logger.warning("canary: BREACH on step %d (%s) — rolling back",
                       decided, verdict)
        return ("rollback", decided)

    def observe(self, worker_id: str, step: int | None,
                ok: bool) -> tuple[str, int] | None:
        """Record one forwarded outcome (live canary traffic and
        shadow mirrors alike). Returns ``("promote", step)``,
        ``("rollback", step)``, or None. 429s must NOT be reported here
        (saturation is not model quality).

        With a drift bar configured (``shadow_max_drift``), the
        error-rate bar alone cannot promote: the verdict DEFERS until
        ``shadow_min_samples`` mirrored rows have been diffed (up to a
        cap — a fleet whose mirror produces nothing, e.g. shadow
        disabled or the canary shedding every mirror, must not pin an
        undecided canary forever)."""
        with self._lock:
            if (self._canary_step is None or step is None
                    or step != self._canary_step):
                return None
            self._canary_requests.inc()
            if ok:
                self._canary_ok += 1
            else:
                self._canary_err += 1
                self._canary_errors.inc()
            total = self._canary_ok + self._canary_err
            if total < self.canary_min_requests:
                return None
            rate = self._canary_err / total
            if rate > self.canary_max_error_rate:
                return self._decide_locked(False, {
                    "reason": "error_rate", "error_rate": round(rate, 4),
                    "bar": self.canary_max_error_rate,
                    "requests": total})
            if self.shadow_max_drift is not None:
                n = len(self._canary_drift)
                # Floor of 1: a percentile needs at least one sample —
                # min_samples=0 must mean "judge as soon as anything
                # arrives", never "judge an empty distribution".
                if n < max(1, self.shadow_min_samples):
                    if total < self.canary_min_requests * 4:
                        return None  # defer: wait for mirrored rows
                    logger.warning(
                        "canary: promoting step %d on error rate alone "
                        "— only %d/%d drift samples arrived after %d "
                        "outcomes (is the shadow mirror running?)",
                        self._canary_step, n, self.shadow_min_samples,
                        total)
                    return self._decide_locked(True, {
                        "reason": "error_rate_only",
                        "error_rate": round(rate, 4),
                        "drift_samples": n, "requests": total})
                p99 = self._drift_p99_locked()
                if p99 > self.shadow_max_drift:
                    self._shadow_breaches.inc()
                    return self._decide_locked(False, {
                        "reason": "shadow_drift",
                        "drift_p99": round(p99, 6),
                        "bar": self.shadow_max_drift,
                        "drift_samples": n, "requests": total})
                return self._decide_locked(True, {
                    "reason": "error_rate+drift",
                    "error_rate": round(rate, 4),
                    "drift_p99": round(p99, 6),
                    "drift_samples": n, "requests": total})
            return self._decide_locked(True, {
                "reason": "error_rate", "error_rate": round(rate, 4),
                "requests": total})

    def observe_drift(self, step: int | None,
                      samples: list[float]) -> tuple[str, int] | None:
        """Record mirrored-row drift samples for the undecided canary
        (serving/shadow.py). An already-over-the-bar p99 rolls back
        IMMEDIATELY — a drifted model must not keep taking canary
        traffic while the error-rate count ambles toward its minimum.
        Returns a decision tuple or None."""
        if not samples:
            return None
        with self._lock:
            if (self._canary_step is None or step is None
                    or step != self._canary_step):
                return None
            self._canary_drift.extend(float(s) for s in samples)
            # Bounded: the verdict needs a recent distribution, not
            # an unbounded history.
            if len(self._canary_drift) > 4096:
                self._canary_drift = self._canary_drift[-4096:]
            if self.shadow_max_drift is None:
                return None
            n = len(self._canary_drift)
            if n < max(1, self.shadow_min_samples):
                return None
            p99 = self._drift_p99_locked()
            if p99 > self.shadow_max_drift:
                self._shadow_breaches.inc()
                return self._decide_locked(False, {
                    "reason": "shadow_drift",
                    "drift_p99": round(p99, 6),
                    "bar": self.shadow_max_drift,
                    "drift_samples": n})
            return None

    # -- readers -----------------------------------------------------------
    def workers(self) -> list[WorkerEntry]:
        with self._lock:
            return list(self._workers.values())

    def workers_at_step(self, step: int) -> list[WorkerEntry]:
        with self._lock:
            return [w for w in self._workers.values()
                    if w.checkpoint_step == step]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "workers": {w.worker_id: w.snapshot()
                            for w in sorted(self._workers.values(),
                                            key=lambda w: w.worker_id)},
                "trusted_step": self.trusted_step,
                "bad_steps": sorted(self.bad_steps),
                "canary_step": self._canary_step,
                "canary_fraction": self.canary_fraction,
                "shadow_max_drift": self.shadow_max_drift,
                "canary_drift_samples": len(self._canary_drift),
                "last_verdict": dict(self.last_verdict),
            }


class FleetRouter:
    """HTTP front door over a ``WorkerPool`` (+ optional cache).

    Same lifecycle idiom as ``EmbeddingServer``: ``start()`` binds and
    returns (the fleet CLI owns the foreground loop); ``close()`` tears
    down. The router holds no model and compiles nothing — it can
    restart in milliseconds, which is exactly why the cache lives here
    and not in the workers.
    """

    def __init__(self, pool: WorkerPool,
                 cache: EmbeddingCache | None = None,
                 example_shape=None,
                 host: str = "127.0.0.1", port: int = 8080,
                 retries: int = 2,
                 forward_timeout_s: float = 30.0,
                 control_timeout_s: float = 5.0,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 registry: MetricsRegistry | None = None,
                 warm_rows: int = 32):
        self.pool = pool
        self.cache = cache
        # First-checkpoint adoption (None -> step) is a model change
        # with no canary verdict to hang the flush on: embeddings from
        # pre-checkpoint (random-init) weights must not survive it.
        # Demotion (a fleet-wide forced rollback) is equally a model
        # change — and additionally restores the prior index version.
        pool.on_trusted_adopt = self._on_trusted_adopt
        pool.on_trusted_rollback = self._on_trusted_rollback
        self.example_shape = (tuple(int(d) for d in example_shape)
                              if example_shape is not None else None)
        self.host, self.port = host, int(port)
        self.retries = int(retries)
        self.forward_timeout_s = float(forward_timeout_s)
        self.control_timeout_s = float(control_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        # Cache warming on promote: how many
        # hot rows to replay through the newly trusted model right
        # after the promote flush (0 disables — the cache then boots
        # cold exactly as before).
        self.warm_rows = int(warm_rows)
        self.registry = registry if registry is not None \
            else pool.registry
        r = self.registry
        self._requests = r.counter("fleet_requests_total",
                                   "requests arriving at the router")
        self._responses = r.counter("fleet_responses_total",
                                    "2xx responses sent by the router")
        self._cache_only = r.counter(
            "fleet_cache_only_responses_total",
            "requests answered entirely from the cache (no worker)")
        self._cache_warmed = r.counter(
            "fleet_cache_warmed_total",
            "hot rows replayed through a newly promoted model")
        self._forwards = r.counter("fleet_forwards_total",
                                   "forward attempts to workers")
        self._retries_ctr = r.counter(
            "fleet_retries_total",
            "forward attempts beyond the first (failover)")
        self._rejects: dict[str, object] = {}
        self._reject_lock = threading.Lock()
        self.latency = {
            stage: r.histogram("fleet_latency_ms",
                               "router latency by stage",
                               labels={"stage": stage})
            for stage in ("total", "forward")
        }
        # Fleet observability plane: all optional — a bare router
        # (tests) behaves exactly as without it.
        self.index = None           # retrieval.IndexManager (attach_index)
        self.shards = None          # retrieval.ShardFanout (attach_shards)
        self.run_id: str | None = None
        self.shadow = None          # ShadowMirror (attach_shadow)
        self.admission = None       # TenantAdmission
        self.aggregator = None      # obs.FleetAggregator -> /metrics/fleet
        self.history = None         # obs.MetricHistory -> /metrics/history
        self.alerts = AlertStore(registry=self.registry)  # -> /alerts
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._shutdown = threading.Event()

    def set_run_id(self, run_id: str | None) -> None:
        """Stamp the router's own run identity:
        the same ``serving_run_info`` info-metric pattern the workers
        publish, so a federated scrape or a merged trace correlates
        the router with its run — workers were labeled, the router
        was anonymous."""
        if not run_id:
            return
        self.run_id = str(run_id)
        self.registry.gauge(
            "serving_run_info",
            "router process identity (join key for cross-process "
            "correlation)", labels={"run_id": self.run_id}).set(1)

    def attach_index(self, manager) -> None:
        """Wire a ``retrieval.IndexManager``: ``POST /search`` /
        ``/index/insert`` / ``/embed?store=true`` go live, rollout
        decisions drive index versions, and the manager's background
        rebuilds re-embed through this router's forward path."""
        self.index = manager
        manager.reembed = self._reembed
        if self.pool.trusted_step is not None:
            # Attached after the fleet already adopted: the index must
            # version against the step actually serving.
            manager.activate(self.pool.trusted_step)

    def attach_shards(self, fanout) -> None:
        """Wire a ``retrieval.ShardFanout``: ``POST /search`` fans out
        to the shard plane and merges top-k; a dead shard degrades
        recall (``shards.degraded`` in the payload), never
        availability. The plane is VERSIONED: the rollout state machine
        drives it exactly like the in-process ``IndexManager`` —
        promote cuts every shard to the promoted step's generation,
        rollback restores the retained one fleet-wide, and the fan-out
        rejects any shard response carrying the wrong version, so a
        rollback can never serve mixed-model neighbors across shards.
        When an ``IndexManager`` is ALSO attached it stays the
        id/docstore authority and the shards mirror its inserts."""
        self.shards = fanout
        if self.pool.trusted_step is not None:
            # Attached after the fleet already adopted: the shard
            # plane must version against the step actually serving.
            fanout.activate(self.pool.trusted_step)

    def _on_trusted_adopt(self, step: int) -> None:
        if self.cache is not None:
            self.cache.clear(reason="adopt")
        if self.index is not None:
            self.index.activate(step)
        if self.shards is not None:
            self.shards.activate(step)

    def _on_trusted_rollback(self, new_step: int, old_step: int) -> None:
        """The fleet reverted beneath the router (WorkerPool demotion):
        embeddings of the demoted model must not outlive it, and the
        retrieval tier atomically restores the prior step's retained
        index version — the in-process index AND the shard plane."""
        if self.cache is not None:
            self.cache.clear(reason="rollback")
        if self.index is not None:
            self.index.rollback_to(new_step)
        if self.shards is not None:
            self.shards.rollback_to(new_step)
        _events.emit("rollout", action="trusted_demoted",
                     step=new_step, from_step=old_step)

    def _reembed(self, rows: np.ndarray) -> np.ndarray | None:
        """Embed input rows through the fleet for an index rebuild
        (runs on the manager's rebuild thread). Chunked under the body
        cap exactly like ``_warm_cache``; returns the stacked
        embeddings, or None when any chunk fails — a partial rebuild
        would silently shrink the index, so all-or-nothing."""
        x = np.asarray(rows, np.float32)
        rid = _trace.new_request_id()
        row_bytes = len(json.dumps(x[0].tolist())) + 2
        per = max(1, min(x.shape[0],
                         (self.max_body_bytes // 2) // row_bytes))
        out: list[np.ndarray] = []
        i = 0
        while i < x.shape[0]:
            chunk = x[i:i + per]
            body = json.dumps({"inputs": chunk.tolist()}).encode()
            code, payload, _, _served = self.forward(body, rid)
            if code == 413 and per > 1:
                per = max(1, per // 2)
                continue
            if code != 200 or not isinstance(payload, dict):
                logger.warning("retrieval rebuild: re-embed chunk "
                               "failed (%s)", code)
                return None
            try:
                emb = np.asarray(payload["embeddings"], np.float32)
                if emb.shape[0] != chunk.shape[0]:
                    raise ValueError("row-count mismatch")
            except (KeyError, TypeError, ValueError) as e:
                logger.warning("retrieval rebuild: malformed re-embed "
                               "response (%s)", e)
                return None
            out.append(emb)
            i += chunk.shape[0]
        return np.concatenate(out) if out else None

    def attach_shadow(self, mirror) -> None:
        """Wire a ShadowMirror: the router offers every successful
        trusted forward to it, and its verdicts take effect through
        the same decision path a live canary outcome uses."""
        self.shadow = mirror
        mirror.on_decision = self._handle_decision

    def _reject(self, reason: str) -> None:
        with self._reject_lock:
            counter = self._rejects.get(reason)
            if counter is None:
                counter = self._rejects[reason] = self.registry.counter(
                    "fleet_rejected_total",
                    "non-2xx router outcomes by reason",
                    labels={"reason": reason})
        counter.inc()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._httpd is not None:
            raise RuntimeError("router already started")
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _make_router_handler(self))
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ntxent-fleet-router")
        self._http_thread.start()
        logger.info("fleet router on http://%s:%d", self.host, self.port)
        return self

    def close(self) -> None:
        self._shutdown.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None

    # -- forwarding --------------------------------------------------------
    def _post(self, url: str, body: bytes, rid: str,
              timeout_s: float) -> tuple[int, bytes, int | None]:
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Request-Id": rid})
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.read(), _step_header(resp.headers)

    def _broadcast_rollback(self, step: int) -> None:
        """Tell every worker serving the breached step to revert (the
        staggered laggards get the bad step blocklisted before they
        ever adopt it — rollback() blocklists even when not serving)."""
        for entry in self.pool.workers():
            if not entry.alive:
                continue
            try:
                self._post(entry.url + "/rollback",
                           json.dumps({"step": step}).encode(),
                           _trace.new_request_id(),
                           self.control_timeout_s)
                logger.info("rollback of step %d sent to %s", step,
                            entry.worker_id)
            except (urllib.error.URLError, OSError, ValueError):
                logger.warning("rollback of step %d failed to reach %s "
                               "(its watcher will still refuse the step "
                               "once ejected/restarted)", step,
                               entry.worker_id)

    def _handle_decision(self, decision: tuple[str, int] | None) -> None:
        if decision is None:
            return
        action, step = decision
        verdict = dict(self.pool.last_verdict)
        if action == "promote":
            # A promote is the all-clear for any standing rollback
            # alert: the fleet accepted a successor model.
            if self.alerts.resolve("canary_rollback",
                                   reason=f"step {step} promoted"):
                _events.emit("alert", slo="canary_rollback",
                             state="resolved", kind="canary",
                             step=step)
        if action == "rollback":
            # A rollback IS an alert: typed event on the
            # JSONL stream, an /alerts entry, and a flight dump so the
            # postmortem tail (canary outcomes, shadow spans, the
            # breach itself) is captured AT the verdict. ONE fixed
            # alert name — the step rides the record's fields; a
            # per-step name would mint unbounded slo_alerts_total
            # label cardinality and an ever-growing firing set.
            reason = verdict.get("reason", "canary_breach")
            self.alerts.fire("canary_rollback",
                             reason=reason,
                             value=verdict.get("drift_p99",
                                               verdict.get("error_rate")),
                             threshold=verdict.get("bar"), step=step)
            _events.emit("alert", slo="canary_rollback",
                         state="firing", kind="canary", step=step,
                         **{k: v for k, v in verdict.items()
                            if k != "step"})
            _events.dump_flight(reason=f"canary_rollback:step{step}:"
                                       f"{reason}")
            # Broadcast off the request thread: the verdict fires
            # inside the handler of whichever client request tripped
            # the breach, and serial /rollback POSTs (up to
            # workers x control_timeout_s against a wedged worker)
            # must not stall that client's response. Routing is safe
            # immediately — observe() already blocklisted the step
            # under the pool lock before returning the decision.
            threading.Thread(
                target=self._broadcast_rollback, args=(step,),
                daemon=True, name="fleet-rollback").start()
            if self.cache is not None:
                self.cache.clear(reason="rollback")
            if self.index is not None:
                # Drop any candidate version warmed for the breached
                # step; a DRIFT-reason breach additionally marks the
                # live index stale (the spaces demonstrably moved) and
                # forces a rebuild.
                self.index.on_canary_rollback(
                    step, verdict.get("reason", "canary_breach"))
            if self.shards is not None:
                self.shards.on_canary_rollback(
                    step, verdict.get("reason", "canary_breach"))
        elif action == "promote":
            if self.cache is not None:
                # Embeddings from the previous model must not outlive
                # it — but the hot INPUTS are model-independent:
                # capture them before the flush and replay them through
                # the newly trusted model so the hottest traffic never
                # boots cold.
                hot = (self.cache.hot_keys(self.warm_rows)
                       if self.warm_rows > 0 else [])
                self.cache.clear(reason="promote")
                if hot:
                    # Off the deciding request's thread: the verdict
                    # fired inside whichever client handler tripped it,
                    # and a full re-forward of warm_rows rows must not
                    # stall that client's response.
                    threading.Thread(target=self._warm_cache,
                                     args=(hot,), daemon=True,
                                     name="fleet-cache-warm").start()
            if self.index is not None:
                # Cut searches over to the new step's version (created
                # empty, rebuilt in the background by re-embedding the
                # retained inputs through the now-trusted fleet); the
                # prior version stays retained for rollback.
                self.index.promote(step)
            if self.shards is not None:
                # Cut the WHOLE shard plane to the promoted step in one
                # broadcast: every shard opens a fresh generation at
                # ``step`` and retains the prior one, so a later
                # rollback restores the exact pre-promote fleet — no
                # shard can serve the old model's neighbors next to a
                # peer serving the new one.
                self.shards.promote(step)

    def _warm_cache(self, rows: list) -> int:
        """Replay hot input rows through the (now trusted) fleet and
        re-insert their fresh embeddings; returns rows warmed. Best
        effort: any failure just leaves those rows cold, exactly the
        pre-warming behavior.

        The replay is CHUNKED: workers 413 a body over their byte cap
        or a request over ``--max-request-rows``, and warm_rows hot
        rows of a production-sized model serialize to far more JSON
        than one request may carry. Chunks are sized from one row's
        measured JSON footprint against half the router's own body cap
        (the workers' default cap matches), and any 413 halves the
        chunk and retries — which also adapts to a row cap the router
        cannot see."""
        x = np.stack(rows).astype(np.float32)
        rid = _trace.new_request_id()
        t0 = time.monotonic()
        row_bytes = len(json.dumps(x[0].tolist())) + 2
        per = max(1, min(x.shape[0],
                         (self.max_body_bytes // 2) // row_bytes))
        warmed, status = 0, 200
        i = 0
        while i < x.shape[0]:
            chunk = x[i:i + per]
            body = json.dumps({"inputs": chunk.tolist()}).encode()
            code, payload, _, served_step = self.forward(body, rid)
            if code == 413 and per > 1:
                per = max(1, per // 2)  # cap tighter than estimated
                continue  # same rows, smaller chunks
            if code != 200:
                status = code
            elif isinstance(payload, dict):
                try:
                    emb = np.asarray(payload["embeddings"], np.float32)
                    if emb.shape[0] != chunk.shape[0]:
                        raise ValueError(f"{emb.shape[0]} rows for "
                                         f"{chunk.shape[0]} inputs")
                except (KeyError, TypeError, ValueError):
                    emb = None
                # The same trust gate as any insert, asked under the
                # cache's lock: a rollback or a fresh canary racing the
                # warm-up must not poison the cache.
                if emb is not None and self.pool.allow_cache_insert(
                        served_step):
                    self.cache.insert(chunk, emb, functools.partial(
                        self.pool.allow_cache_insert, served_step))
                    warmed += int(chunk.shape[0])
            i += chunk.shape[0]
        if warmed:
            self._cache_warmed.inc(warmed)
        _trace.emit_span("fleet.cache_warm",
                         (time.monotonic() - t0) * 1e3, request_id=rid,
                         rows=int(x.shape[0]), warmed=warmed,
                         status=status)
        if warmed:
            logger.info("cache warm after promote: replayed %d/%d hot "
                        "row(s)", warmed, int(x.shape[0]))
        else:
            logger.warning("cache warm after promote: nothing warmed "
                           "(status %s)", status)
        return warmed

    def forward(self, body: bytes, rid: str) -> tuple[int, dict,
                                                      dict | None,
                                                      int | None]:
        """Forward one /embed body with failover; returns ``(status,
        payload, payload_extra_headers, served_checkpoint_step)`` — the
        step of the worker that produced the answer (None on failure),
        which is what gates cache inserts. Never raises for worker-side
        trouble — every failure mode maps to a status."""
        tried: set[str] = set()
        attempts = 0
        last_5xx: tuple[str, int, dict] | None = None
        last_unreachable: str | None = None
        saturated_retry_after = 0.0
        saturated = False
        while attempts <= self.retries:
            entry = self.pool.pick(exclude=tried)
            if entry is None:
                break
            tried.add(entry.worker_id)
            attempts += 1
            self._forwards.inc()
            if attempts > 1:
                self._retries_ctr.inc()
            # Provisional attribution from the routing table; the
            # worker's own X-Checkpoint-Step reply label overrides it
            # (a hot swap between health probe and forward would
            # otherwise mislabel the response's model).
            step = entry.checkpoint_step
            t0 = time.monotonic()
            try:
                with _trace.span("fleet.forward", request_id=rid,
                                 worker=entry.worker_id, attempt=attempts):
                    status, payload, hdr_step = self._post(
                        entry.url + "/embed", body, rid,
                        self.forward_timeout_s)
                if hdr_step is not None:
                    step = hdr_step
            except urllib.error.HTTPError as e:
                hdr_step = _step_header(e.headers)
                if hdr_step is not None:
                    step = hdr_step
                raw = e.read()
                try:
                    detail = json.loads(raw)
                except ValueError:
                    detail = None
                if not isinstance(detail, dict):
                    # Valid-JSON-but-not-an-object bodies (a recycled
                    # port answering "busy" or null) must not crash the
                    # .get() consumers below — forward() never raises
                    # for worker-side trouble.
                    detail = {"error": raw.decode(errors="replace")[:500]}
                if e.code == 429:
                    # Saturation: not a worker failure, not a canary
                    # signal — try a sibling.
                    saturated = True
                    try:
                        retry_after = float(
                            detail.get("retry_after_s", 0.05))
                    except (TypeError, ValueError):
                        # Same recycled-port threat model as the
                        # non-dict guard above: a null/string value
                        # must not raise out of forward().
                        retry_after = 0.05
                    saturated_retry_after = max(saturated_retry_after,
                                                retry_after)
                    continue
                if e.code == 504:
                    # Deadline exceeded: the CLIENT's timeout_ms ran
                    # out (usually queue wait under load). The worker
                    # answered sanely — not a failure to eject on, not
                    # model-quality evidence for the canary (same
                    # neutrality as 429), and retrying would burn
                    # another full deadline past an already-expired
                    # one. Pass through.
                    self.pool.report_success(entry.worker_id)
                    return e.code, detail, None, step
                if e.code >= 500:
                    last_5xx = (entry.worker_id, e.code, detail)
                    self.pool.report_failure(
                        entry.worker_id, f"http {e.code}")
                    self._handle_decision(
                        self.pool.observe(entry.worker_id, step,
                                          ok=False))
                    continue
                # 4xx: the client's problem — pass through verbatim.
                # The worker itself is healthy, so the outcome still
                # counts toward a pending canary verdict — and a
                # verdict decided HERE must take effect like any other.
                self._handle_decision(
                    self.pool.observe(entry.worker_id, step, ok=True))
                self.pool.report_success(entry.worker_id)
                return e.code, detail, None, step
            except (urllib.error.URLError, OSError) as e:
                last_unreachable = entry.worker_id
                self.pool.report_failure(entry.worker_id, repr(e))
                self._handle_decision(
                    self.pool.observe(entry.worker_id, step, ok=False))
                continue
            finally:
                self.pool.done(entry.worker_id)
                self.latency["forward"].observe(
                    (time.monotonic() - t0) * 1e3)
            try:
                result = json.loads(payload)
                if not isinstance(result, dict):
                    raise ValueError("non-object JSON body")
            except ValueError:
                last_5xx = (entry.worker_id, 502,
                            {"error": "unparseable worker response"})
                self.pool.report_failure(entry.worker_id, "bad payload")
                # Garbage out of a canary is exactly the model-quality
                # evidence the verdict counts.
                self._handle_decision(
                    self.pool.observe(entry.worker_id, step, ok=False))
                continue
            self.pool.report_success(entry.worker_id)
            self._handle_decision(
                self.pool.observe(entry.worker_id, step, ok=True))
            if (self.shadow is not None and status == 200
                    and "embeddings" in result):
                # Off the critical path by construction: offer() only
                # enqueues (the mirror thread does the canary POST and
                # the diff). The embeddings ride as the parsed list —
                # the mirror converts once, on its own thread.
                self.shadow.offer(body, rid, step,
                                  result["embeddings"])
            return status, result, None, step
        if last_5xx is not None:
            worker_id, code, detail = last_5xx
            self._reject("worker_error")
            # Budget exhausted: surface the WORKER's status — the
            # router must not translate a diagnosable failure into a
            # generic one.
            return code, {"error": f"worker {worker_id} failed after "
                                   f"{attempts} attempt(s)",
                          "worker_error": detail.get("error"),
                          "worker": worker_id,
                          "attempts": attempts}, None, None
        if saturated:
            self._reject("saturated")
            return 429, {"error": "all workers saturated",
                         "retry_after_s": saturated_retry_after}, \
                {"Retry-After": f"{saturated_retry_after:.3f}"}, None
        if last_unreachable is not None:
            self._reject("unreachable")
            return 503, {"error": f"no worker reachable (last tried "
                                  f"{last_unreachable}, {attempts} "
                                  "attempt(s))"}, None, None
        self._reject("no_workers")
        return 503, {"error": "no ready workers"}, None, None

    # -- metrics -----------------------------------------------------------
    def metrics_dict(self) -> dict:
        out = {
            "run_id": self.run_id,
            "requests": int(self._requests.value),
            "responses": int(self._responses.value),
            "cache_only_responses": int(self._cache_only.value),
            "cache_warmed": int(self._cache_warmed.value),
            "forwards": int(self._forwards.value),
            "retries": int(self._retries_ctr.value),
            "latency_ms": {stage: h.snapshot_ms()
                           for stage, h in self.latency.items()},
            **self.pool.snapshot(),
        }
        if self.cache is not None:
            out["cache"] = self.cache.snapshot()
        if self.index is not None:
            out["index"] = self.index.snapshot()
        if self.shadow is not None:
            out["shadow"] = self.shadow.snapshot()
        if self.admission is not None:
            out["tenants"] = self.admission.snapshot()
        if self.aggregator is not None:
            out["federation"] = self.aggregator.snapshot()
        if self.history is not None:
            out["history"] = self.history.snapshot()
        firing = self.alerts.active()
        if firing:
            out["alerts_firing"] = [a["name"] for a in firing]
        return out


def _csv_cell(value) -> str:
    """One history point field as a CSV cell (empty for absent/None —
    a rollup never has missing stats, but raw/rollup share this path)."""
    if value is None:
        return ""
    if isinstance(value, float):
        return repr(value)
    return str(value)


def _make_router_handler(router: FleetRouter):
    pool = router.pool

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            route = urlparse(self.path).path
            if route == "/healthz":
                ready = sum(1 for w in pool.workers() if w.ready)
                self._reply(200 if ready else 503,
                            {"status": "routing" if ready
                             else "no_ready_workers",
                             "workers_ready": ready,
                             "trusted_step": pool.trusted_step})
            elif route == "/metrics":
                fmt = choose_format(self.path,
                                    self.headers.get("Accept"),
                                    default="json")
                if fmt == "prometheus":
                    self._reply_prometheus(
                        router.registry.render_prometheus())
                elif fmt == "state":
                    # The federation scrape view (obs/aggregate.py):
                    # raw registry state, histogram windows included,
                    # so a federating replica router can merge THIS
                    # router like any worker.
                    self._reply(200, router.registry.dump_state())
                else:
                    self._reply(200, router.metrics_dict())
            elif route == "/metrics/fleet":
                # The federated view: one merged scrape for
                # the whole fleet — workers + this router. Default is
                # Prometheus text (this endpoint exists FOR scrapers);
                # ?format=json returns the same merged registry's
                # collect() dict.
                if router.aggregator is None:
                    self._reply(503, {"error": "no federation "
                                               "aggregator attached"})
                    return
                merged = router.aggregator.merged(max_age_s=30.0)
                fmt = choose_format(self.path,
                                    self.headers.get("Accept"),
                                    default="prometheus")
                if fmt == "json":
                    self._reply(200, merged.collect())
                elif fmt == "state":
                    self._reply(200, merged.dump_state())
                else:
                    self._reply_prometheus(merged.render_prometheus())
            elif route == "/metrics/history":
                # The retained time-series plane: raw ring
                # + 10s/1m rollups per series. ?series=NAME selects
                # one series (else the store snapshot), ?step=raw|10s|1m
                # picks the resolution, ?window=SECONDS trims relative
                # to the newest sample, ?format=csv flattens for
                # spreadsheet triage (JSON otherwise).
                if router.history is None:
                    self._reply(503, {"error": "no metrics history "
                                               "attached"})
                    return
                query = parse_qs(urlparse(self.path).query)
                series = query.get("series", [None])[0]
                step = query.get("step", ["raw"])[0]
                window = query.get("window", [None])[0]
                fmt = query.get("format", ["json"])[0]
                if series is None:
                    self._reply(200, {
                        **router.history.snapshot(),
                        "series_names":
                            router.history.series_names(),
                    })
                    return
                try:
                    window_s = float(window) if window is not None \
                        else None
                    payload = router.history.query(series, step=step,
                                                   window_s=window_s)
                except KeyError:
                    self._reply(404, {"error": f"no series {series!r}",
                                      "series":
                                      router.history.series_names()})
                    return
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                if fmt == "csv":
                    self._reply_csv(series, payload["step"],
                                    payload["points"])
                else:
                    self._reply(200, payload)
            elif route == "/alerts":
                # SLO + canary-verdict breaches (obs/slo.py): active
                # alerts and the recent history ring.
                self._reply(200, router.alerts.snapshot())
            elif route == "/index":
                # Retrieval-tier state: versions, active step,
                # staleness, docstore depth; with a shard
                # plane attached, its per-shard health rides along.
                if router.index is None and router.shards is None:
                    self._reply(503, {"error": "no retrieval index "
                                               "attached"})
                else:
                    snap = router.index.snapshot() \
                        if router.index is not None else {}
                    if router.shards is not None:
                        snap["shard_plane"] = router.shards.snapshot()
                    self._reply(200, snap)
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})

        def _reply_prometheus(self, text: str) -> None:
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_csv(self, series: str, step: str,
                       points: list[dict]) -> None:
            # Raw points have (t, value); rollup points carry the full
            # bucket stats. Header comes from the first point's keys so
            # both shapes round-trip.
            cols = list(points[0].keys()) if points \
                else ["t", "value"]
            lines = [",".join(cols)]
            for p in points:
                lines.append(",".join(_csv_cell(p.get(c)) for c in cols))
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/csv")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Content-Disposition",
                             f"inline; filename={series}.{step}.csv")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            rid = (self.headers.get("X-Request-Id")
                   or _trace.new_request_id())
            t0 = time.monotonic()
            url = urlparse(self.path)
            route = url.path
            query = parse_qs(url.query)
            status = {"code": None, "rows": None, "k": None}

            def reply(code: int, payload: dict,
                      headers: dict | None = None) -> None:
                status["code"] = code
                merged = {"X-Request-Id": rid}
                if headers:
                    merged.update(headers)
                self._reply(code, payload, merged)
                if code < 300:
                    router._responses.inc()

            try:
                self._do_post(reply, rid, status, route, query)
            finally:
                if status["code"] is not None:
                    dur_ms = (time.monotonic() - t0) * 1e3
                    if route == "/embed":
                        router.latency["total"].observe(dur_ms)
                        _trace.emit_span("fleet.request", dur_ms,
                                         request_id=rid,
                                         status=status["code"],
                                         rows=status["rows"])
                    elif route == "/search":
                        # The search request's end-to-end span (embed
                        # forward + index scan) under the same id the
                        # worker chunks trace under.
                        _trace.emit_span("fleet.search", dur_ms,
                                         request_id=rid,
                                         status=status["code"],
                                         rows=status["rows"],
                                         k=status["k"])
                        if router.index is not None:
                            router.index.metrics.latency[
                                "search_request"].observe(dur_ms)
                    elif route == "/index/insert":
                        _trace.emit_span("fleet.insert", dur_ms,
                                         request_id=rid,
                                         status=status["code"],
                                         rows=status["rows"])

        def _do_post(self, reply, rid, status, route, query) -> None:
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if length > router.max_body_bytes:
                self.close_connection = True
                reply(413, {"error": f"body of {length} bytes exceeds "
                                     f"the {router.max_body_bytes}-byte "
                                     "cap"},
                      {"Connection": "close"})
                return
            body = self.rfile.read(length) if length > 0 else b""
            if route == "/search":
                router._requests.inc()
                self._do_search(reply, rid, body, status)
                return
            if route == "/index/insert":
                router._requests.inc()
                self._do_insert(reply, rid, body, status)
                return
            if route != "/embed":
                reply(404, {"error": f"no route {self.path!r}"})
                return
            router._requests.inc()
            store = (query.get("store", ["0"])[0].lower()
                     in ("1", "true", "yes"))
            parsed = self._parse_rows(body)
            # Admission meters by row count when the router can parse
            # the body (cost scales with the work a tenant asks for);
            # an unparseable pass-through body costs one token — the
            # worker owns its 400, but the forward is still work.
            cost = int(parsed[0].shape[0]) if parsed is not None else 1
            if not self._admit(reply, cost):
                return
            if parsed is None or (router.cache is None and not store):
                # Unparseable here (the worker owns the 400) or neither
                # cache nor store needs the rows: pure pass-through.
                code, payload, headers, _ = router.forward(body, rid)
                if isinstance(payload, dict) and "rows" in payload:
                    status["rows"] = payload.get("rows")
                if store and code == 200 and isinstance(payload, dict):
                    # store=true on rows the router could not parse for
                    # keying: the embed succeeded but nothing entered
                    # the index — say so instead of silently dropping.
                    payload["stored"] = 0
                reply(code, payload, headers)
                return
            x, timeout_ms = parsed
            status["rows"] = int(x.shape[0])
            code, payload, headers, served_step, emb = \
                self._embed_full(rid, x, timeout_ms)
            if store and code == 200 and emb is not None \
                    and isinstance(payload, dict):
                ids = self._index_store(x, emb, served_step)
                payload["stored"] = len(ids)
                payload["ids"] = ids
                if router.index is not None:
                    payload["index_step"] = router.index.active_step
            reply(code, payload, headers)

        def _do_search(self, reply, rid, body, status) -> None:
            """POST /search {"inputs": ..., "k": N}: embed through the
            fleet, answer top-k from the step-matched index version —
            or, when a shard plane is attached, fan out and merge
            (degraded beats down: a dead shard drops its lists' rows,
            the response says so, and the status stays 200)."""
            if router.index is None and router.shards is None:
                reply(503, {"error": "no retrieval index attached "
                                     "(start the fleet with "
                                     "--index-dir)"})
                return
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    # A top-level array/scalar body must be a 400, not
                    # an AttributeError that drops the connection.
                    raise ValueError("body is not a JSON object")
                k = int(req.get("k", 10))
                if not 1 <= k <= 1024:
                    raise ValueError(f"k={k} out of [1, 1024]")
            except (TypeError, ValueError) as e:
                reply(400, {"error": f"unparseable /search body: {e}"})
                return
            status["k"] = k
            # One parse for the whole request: k above, rows here.
            parsed = self._parse_rows_obj(req)
            if parsed is None:
                reply(400, {"error": "inputs not parseable as rows of "
                                     "the fleet's example shape"})
                return
            x, timeout_ms = parsed
            status["rows"] = int(x.shape[0])
            # /search rides the same per-tenant buckets as /embed:
            # the retrieval path embeds through the fleet
            # too, so an unmetered /search would be a quota bypass.
            if not self._admit(reply, int(x.shape[0])):
                return
            code, payload, headers, served_step, emb = \
                self._embed_full(rid, x, timeout_ms)
            if code != 200 or emb is None:
                reply(code, payload, headers)
                return
            if router.shards is not None:
                # Shard plane: every shard probes the same global
                # top-nprobe lists and contributes the ones it owns,
                # so the merged answer equals the unsharded scan when
                # all shards report — and shrinks by exactly the dead
                # shards' lists when they don't.
                res = router.shards.search(emb, k=k)
                reply(200, {
                    "ids": res["ids"].tolist(),
                    "scores": [[float(s) if np.isfinite(s) else None
                                for s in row]
                               for row in res["scores"]],
                    "k": k, "rows": int(x.shape[0]),
                    "index_rows": res["rows"],
                    "shards": res["shards"],
                    "index_step": res["version"],
                    "served_step": served_step})
                return
            index_dim = router.index.dim
            if index_dim is not None and emb.shape[-1] != index_dim:
                # Fleet/index width skew (a changed --proj-dim rolled
                # out over a persisted index): a config conflict the
                # client can see, never a ValueError that drops the
                # connection.
                reply(409, {"error": f"embedding width "
                                     f"{emb.shape[-1]} != index dim "
                                     f"{index_dim} (the fleet's model "
                                     "changed width; rebuild or "
                                     "re-create the index)"})
                return
            # prefer_step: query vectors must search the index version
            # of the SPACE they were embedded in — during a rollout
            # window a laggard-served query legitimately belongs to the
            # retained prior version.
            res = router.index.search(emb, k=k, prefer_step=served_step)
            reply(200, {"ids": res["ids"], "scores": res["scores"],
                        "k": k, "rows": int(x.shape[0]),
                        "index_step": res["step"],
                        "index_stale": res["stale"],
                        "index_rows": res["rows"],
                        "served_step": served_step})

        def _do_insert(self, reply, rid, body, status) -> None:
            """POST /index/insert {"inputs": ...}: embed + store. The
            insert is trust-gated (same rule as cache inserts); a gated
            request still answers 200 with stored=0 — rollout windows
            are normal operation, not client errors."""
            if router.index is None and router.shards is None:
                reply(503, {"error": "no retrieval index attached "
                                     "(start the fleet with "
                                     "--index-dir)"})
                return
            parsed = self._parse_rows(body)
            if parsed is None:
                reply(400, {"error": "inputs not parseable as rows of "
                                     "the fleet's example shape"})
                return
            x, timeout_ms = parsed
            status["rows"] = int(x.shape[0])
            code, payload, headers, served_step, emb = \
                self._embed_full(rid, x, timeout_ms)
            if code != 200 or emb is None:
                reply(code, payload, headers)
                return
            ids = self._index_store(x, emb, served_step)
            out = {"stored": len(ids), "ids": ids,
                   "rows": int(x.shape[0]),
                   "index_step": (router.index.active_step
                                  if router.index is not None else None),
                   "served_step": served_step}
            if not ids:
                out["reason"] = "not_trusted"
            reply(200, out)

        def _index_store(self, x, emb, served_step) -> list:
            """Trust-gated index insert; [] when gated, unattached, or
            rejected (wrong step/dim). Never raises — a bad payload
            must degrade to stored:0, not drop the connection. With a
            shard plane attached the rows ALSO fan out to their owner
            shards (the IndexManager, when present, stays the id
            authority; a bare shard plane allocates its own)."""
            if router.index is None and router.shards is None:
                return []
            if not pool.allow_cache_insert(served_step):
                return []
            step = served_step if served_step is not None \
                else pool.trusted_step
            ids: list = []
            try:
                if router.index is not None:
                    ids = router.index.insert(x, emb, step=step)
            except Exception:  # noqa: BLE001 — the embed already
                # succeeded; an index-side failure must not turn a
                # 200 into a dropped connection.
                logger.exception("index insert failed")
                ids = []
            if router.shards is not None:
                try:
                    if router.index is None:
                        ids = router.shards.insert_auto(emb)
                    elif ids:
                        router.shards.insert(
                            np.asarray(ids, np.int64), emb)
                except Exception:  # noqa: BLE001 — same contract as
                    # the local-index failure above.
                    logger.exception("shard insert failed")
            return ids

        def _admit(self, reply, cost: int) -> bool:
            """Per-tenant admission check (no-op without a configured
            ``TenantAdmission``). On exhaustion answers the same 429 +
            Retry-After contract the saturation path uses, so clients
            need one backoff implementation, not two."""
            adm = router.admission
            if adm is None:
                return True
            tenant = self.headers.get("X-Tenant")
            ok, retry_after = adm.admit(tenant, cost=max(1, cost))
            if ok:
                return True
            router._reject("tenant_quota")
            reply(429, {"error": "tenant over admission quota",
                        "tenant": adm._normalize(tenant),
                        "retry_after_s": round(retry_after, 3)},
                  {"Retry-After": str(max(1, int(retry_after + 0.999)))})
            return False

        def _parse_rows(self, body: bytes):
            """Best-effort parse for cache keying; None = pass through
            and let a worker produce the authoritative 400. Caching
            requires ``example_shape`` (without it a batchless single
            example is indistinguishable from a batch of smaller rows,
            and a wrong split would poison the cache)."""
            if router.example_shape is None:
                # Before the parse: a shape-less router passes bodies
                # through untouched and must not pay a full json.loads
                # per request just to discard the result.
                return None
            try:
                req = json.loads(body or b"{}")
            except ValueError:
                return None
            return self._parse_rows_obj(req)

        def _parse_rows_obj(self, req):
            """``_parse_rows`` on an already-parsed body (callers that
            needed other fields must not pay a second json.loads)."""
            if router.example_shape is None or not isinstance(req, dict):
                return None
            try:
                x = np.asarray(req["inputs"], dtype=np.float32)
                if x.shape == router.example_shape:
                    x = x[None]
                if x.shape[1:] != router.example_shape or x.shape[0] < 1:
                    return None
                timeout_ms = req.get("timeout_ms")
                return x, timeout_ms
            except (KeyError, TypeError, ValueError):
                return None

        def _embed_full(self, rid, x, timeout_ms):
            """Embed parsed rows through cache+fleet; returns ``(code,
            payload, headers, served_step, embeddings-or-None)`` — the
            shared engine behind /embed (cached path), /search query
            embedding, and the index insert surfaces. ``served_step``
            is None when every row came from the cache (the embeddings
            are then trusted-model by construction)."""
            cache = router.cache
            if cache is None:
                body = {"inputs": x.tolist()}
                if timeout_ms is not None:
                    body["timeout_ms"] = timeout_ms
                code, payload, headers, served_step = router.forward(
                    json.dumps(body).encode(), rid)
                if code != 200 or not isinstance(payload, dict):
                    return code, payload, headers, served_step, None
                try:
                    emb = np.asarray(payload["embeddings"], np.float32)
                    if emb.shape[0] != x.shape[0]:
                        raise ValueError(f"{emb.shape[0]} rows for "
                                         f"{x.shape[0]} inputs")
                except (KeyError, TypeError, ValueError) as e:
                    router._reject("bad_worker_payload")
                    return 502, {"error": f"malformed worker response: "
                                          f"{e}"}, None, served_step, \
                        None
                return code, payload, headers, served_step, emb
            t0 = time.monotonic()
            # The trusted step before the flush epoch, both before the
            # lookup: a promote sets the trusted step and then flushes,
            # so a reader between the two still sees this step here.
            trusted = pool.trusted_step
            generation = cache.generation
            hits, miss_idx = cache.lookup(x)
            _trace.emit_span("fleet.cache",
                             (time.monotonic() - t0) * 1e3,
                             request_id=rid, rows=int(x.shape[0]),
                             hits=len(hits), misses=len(miss_idx))
            if not miss_idx:
                # A full hit is single-model by construction (every row
                # came from the same cache generation) even if a flush
                # lands right now — no mixing possible, serve it.
                out = np.stack([hits[i] for i in range(x.shape[0])])
                router._cache_only.inc()
                return 200, {"embeddings": out.tolist(),
                             "dim": int(out.shape[-1]),
                             "rows": int(out.shape[0]),
                             "cache_hits": int(out.shape[0])}, \
                    None, None, out
            sub = {"inputs": x[miss_idx].tolist()}
            if timeout_ms is not None:
                sub["timeout_ms"] = timeout_ms
            code, payload, headers, served_step = router.forward(
                json.dumps(sub).encode(), rid)
            if code == 200 and hits and (
                    cache.generation != generation
                    or (served_step is not None
                        and trusted is not None
                        and served_step != trusted)):
                # The cached rows and the fetched rows came from
                # different models — one response must never mix two
                # embedding spaces. Two ways there: a flush
                # (promote/rollback/adopt — a MODEL change) landed
                # while the misses were in flight, or the forward hit a
                # worker off the step trusted at the lookup (a
                # post-promote laggard still on the old step, a canary,
                # or the new step of a promote whose flush has not run
                # yet) while the cache holds that step's rows.
                # Re-forward the whole request — a single worker reply
                # is internally consistent regardless of later flushes.
                hits = {}
                miss_idx = list(range(x.shape[0]))
                full = {"inputs": x.tolist()}
                if timeout_ms is not None:
                    full["timeout_ms"] = timeout_ms
                code, payload, headers, served_step = router.forward(
                    json.dumps(full).encode(), rid)
            if code != 200:
                return code, payload, headers, served_step, None
            try:
                fetched = np.asarray(payload["embeddings"],
                                     dtype=np.float32)
                if fetched.shape[0] != len(miss_idx):
                    raise ValueError(f"worker returned "
                                     f"{fetched.shape[0]} rows for "
                                     f"{len(miss_idx)} misses")
            except (KeyError, TypeError, ValueError) as e:
                router._reject("bad_worker_payload")
                return 502, {"error": f"malformed worker response: "
                                      f"{e}"}, None, served_step, None
            if pool.allow_cache_insert(served_step):
                # asked again under the cache's lock: a promote whose
                # flush lands while the rows are hashed drops them
                keys = [row_key(x[i]) for i in miss_idx]
                admitted = cache.insert(x[miss_idx], fetched,
                                        functools.partial(
                                            pool.allow_cache_insert,
                                            served_step), keys)
                # which rows entered the cache from which step (JAX's
                # router logs no such event)
                _events.emit("fleet", action="cache_insert", rid=rid,
                             step=served_step, trusted=trusted,
                             generation=generation, admitted=admitted,
                             keys=[k.hex()[:16] for k in keys])
            merged = np.empty((x.shape[0], fetched.shape[-1]),
                              dtype=np.float32)
            for j, i in enumerate(miss_idx):
                merged[i] = fetched[j]
            for i, vec in hits.items():
                merged[i] = vec
            return 200, {"embeddings": merged.tolist(),
                         "dim": int(merged.shape[-1]),
                         "rows": int(merged.shape[0]),
                         "cache_hits": len(hits)}, None, served_step, \
                merged

    return Handler
