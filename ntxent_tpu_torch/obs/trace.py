"""Span tracing over the typed event stream, counterpart of
``ntxent_tpu/obs/trace.py`` (stdlib).

Spans are one more typed event (``span``) on the ``EventLog`` hub, so
they ride the same JSONL file, the same run/attempt identity and the
same no-op path when no log is installed.

* **producers**: ``span(name, ...)`` is a context manager carrying ids
  and parents on a thread-local stack (nested spans link automatically
  within a thread); ``emit_span(name, dur_ms, ...)`` is the measured form
  for an interval whose start was a plain monotonic read (a request's
  queue wait, emitted by the batcher's worker at dispatch). Serving
  threads a ``request_id`` (minted at HTTP ingest, echoed as
  ``X-Request-Id``) through ``serve.request``, ``serve.queue_wait``,
  ``serve.batch`` and ``serve.device_chunk``.
* **consumer**: ``export_chrome_trace`` converts a run's JSONL into a
  Chrome-trace/Perfetto ``trace.json`` (``python -m
  ntxent_tpu_torch.obs.trace run.jsonl -o trace.json``): spans become
  complete (``ph="X"``) slices, ``step`` events a step slice with its
  data-wait/device/checkpoint children, every other event an instant on
  its thread's track.

Spans with a ``request_id`` share one track per request (up to
``REQUEST_LANES_MAX`` lanes, then hashed onto them); the rest track by
the emitting thread's name.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import uuid
import zlib

from . import events

__all__ = ["span", "emit_span", "current_span_id", "new_request_id",
           "export_chrome_trace", "validate_chrome_trace", "main"]

_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def new_request_id() -> str:
    """Request identity minted at serving ingest (the ``X-Request-Id``
    value). Same alphabet as span ids; kept as its own spelling so call
    sites say what they mean."""
    return uuid.uuid4().hex[:16]


def current_span_id() -> str | None:
    """Innermost open span on THIS thread (None outside any span)."""
    stack = _stack()
    return stack[-1][0] if stack else None


class span:
    """Context manager: one timed span, emitted as a ``span`` event on
    exit (so ``dur_ms`` is known and the record's own ``t`` marks the
    END; exporters recover the start as ``t - dur_ms/1e3``).

    Nesting is automatic within a thread (ids/parents ride a
    thread-local stack); pass ``parent_id`` explicitly to link across
    threads. Extra keyword attrs land verbatim on the event (and in the
    exported slice's ``args``). With no EventLog installed the emit is
    the hub's cheap no-op — the stack bookkeeping is a list append/pop.
    """

    def __init__(self, name: str, parent_id: str | None = None,
                 request_id: str | None = None, **attrs):
        self.name = str(name)
        self.span_id = new_span_id()
        self._explicit_parent = parent_id
        self.request_id = request_id
        self.attrs = attrs
        self._t0: float | None = None

    def __enter__(self) -> "span":
        stack = _stack()
        self.parent_id = (self._explicit_parent
                          if self._explicit_parent is not None
                          else (stack[-1][0] if stack else None))
        stack.append((self.span_id, self.name))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        stack = _stack()
        # Pop OUR frame even if an inner span leaked (never raise from
        # telemetry teardown).
        if stack and stack[-1][0] == self.span_id:
            stack.pop()
        elif stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == self.span_id:
                    del stack[i:]
                    break
        fields = dict(self.attrs)
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        emit_span(self.name, dur_ms, span_id=self.span_id,
                  parent_id=self.parent_id, request_id=self.request_id,
                  **fields)
        return None


def emit_span(name: str, dur_ms: float, span_id: str | None = None,
              parent_id: str | None = None, request_id: str | None = None,
              **attrs) -> None:
    """Emit one measured span ending NOW (the record's ``t`` is the end
    time; ``dur_ms`` reaches back to the start). The spelling for
    intervals bracketed by plain monotonic reads — a request's queue
    wait, a device chunk timed around a retry loop."""
    fields = {"name": str(name), "span_id": span_id or new_span_id(),
              "dur_ms": round(float(dur_ms), 3),
              "thread": threading.current_thread().name}
    if parent_id is not None:
        fields["parent_id"] = parent_id
    if request_id is not None:
        fields["request_id"] = request_id
    fields.update(attrs)
    events.emit("span", **fields)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------

# A serving log mints one request_id per request, and Perfetto draws one
# track per tid: distinct ids get their own lane up to this pool size,
# then hash onto the pool (request_id stays in every slice's args).
REQUEST_LANES_MAX = 64


class _Lanes:
    """name -> stable tid assignment plus the thread_name metadata
    records Perfetto uses to label tracks. The time axis is each record's
    ``t`` (a monotonic offset since the log opened), so wall-clock jumps
    cannot reorder a timeline."""

    pid = 1

    def __init__(self):
        self._tids: dict[str, int] = {}
        self.meta: list[dict] = []
        self._req_pool: list[int] = []
        self._req_map: dict[str, int] = {}

    @staticmethod
    def ts_us(rec: dict) -> float:
        return float(rec["t"]) * 1e6

    def tid(self, label: str) -> int:
        tid = self._tids.get(label)
        if tid is None:
            tid = self._tids[label] = len(self._tids) + 1
            self.meta.append({
                "ph": "M", "pid": self.pid, "tid": tid,
                "name": "thread_name",
                "args": {"name": label},
            })
        return tid

    def request_tid(self, request_id: str) -> int:
        tid = self._req_map.get(request_id)
        if tid is None:
            if len(self._req_pool) < REQUEST_LANES_MAX:
                tid = self.tid(f"req:{request_id}")
                self._req_pool.append(tid)
            else:
                # Stable across exports: crc32, not the salted hash().
                tid = self._req_pool[zlib.crc32(request_id.encode())
                                     % len(self._req_pool)]
            self._req_map[request_id] = tid
        return tid


def _span_events(rec: dict, lanes: _Lanes) -> list[dict]:
    dur_ms = float(rec.get("dur_ms", 0.0))
    end_us = lanes.ts_us(rec)
    tid = (lanes.request_tid(str(rec["request_id"]))
           if rec.get("request_id")
           else lanes.tid(str(rec.get("thread", "main"))))
    args = {k: v for k, v in rec.items()
            if k not in ("event", "t", "wall", "name", "dur_ms", "thread")}
    return [{
        "ph": "X", "pid": lanes.pid, "tid": tid, "cat": "span",
        "name": str(rec.get("name", "span")),
        "ts": round(end_us - dur_ms * 1e3, 3),
        "dur": round(max(dur_ms * 1e3, 0.001), 3),
        "args": args,
    }]


def _step_events(rec: dict, lanes: _Lanes) -> list[dict]:
    """One `step` record -> a step slice with its data-wait/device/
    checkpoint children laid out sequentially (the step record's
    breakdown is phase durations, not timestamps; sequential layout is
    exactly the host loop's order: fetch, dispatch/run, hook)."""
    tid = lanes.tid("train")
    parts = [("data_wait", float(rec.get("data_wait_ms", 0.0))),
             ("device", float(rec.get("device_ms", 0.0))),
             ("checkpoint", float(rec.get("checkpoint_ms", 0.0)))]
    total_ms = sum(d for _, d in parts)
    end_us = lanes.ts_us(rec)
    start_us = end_us - total_ms * 1e3
    args = {k: rec[k] for k in ("step", "loss", "steps_per_sec", "mfu",
                                "grad_norm", "ok", "attempt",
                                "comms_bytes", "host_fetch_ms",
                                "transfer_ms") if k in rec}
    out = [{
        "ph": "X", "pid": lanes.pid, "tid": tid, "cat": "step",
        "name": f"step {rec.get('step', '?')}",
        "ts": round(start_us, 3), "dur": round(max(total_ms * 1e3, 1), 3),
        "args": args,
    }]
    cursor = start_us
    for name, dur in parts:
        if dur <= 0:
            continue
        out.append({
            "ph": "X", "pid": lanes.pid, "tid": tid, "cat": "step_phase",
            "name": name, "ts": round(cursor, 3),
            "dur": round(dur * 1e3, 3), "args": {},
        })
        cursor += dur * 1e3
    return out


def _instant_event(rec: dict, lanes: _Lanes) -> dict:
    args = {k: v for k, v in rec.items() if k not in ("event", "t", "wall")}
    label = str(rec.get("thread", rec["event"]))
    name = rec["event"]
    if rec.get("action"):
        name = f"{name}:{rec['action']}"
    return {
        "ph": "i", "pid": lanes.pid, "tid": lanes.tid(label), "s": "t",
        "cat": rec["event"], "name": name,
        "ts": round(lanes.ts_us(rec), 3), "args": args,
    }


def _render_records(records: list[dict], lanes: _Lanes,
                    run_id: str | None,
                    run_ids: set[str]) -> list[dict]:
    out: list[dict] = []
    for rec in records:
        if "t" not in rec or "event" not in rec:
            continue
        if run_id is not None and rec.get("run_id") != run_id:
            continue
        if rec.get("run_id"):
            run_ids.add(rec["run_id"])
        kind = rec["event"]
        if kind == "span":
            out.extend(_span_events(rec, lanes))
        elif kind == "step":
            out.extend(_step_events(rec, lanes))
        else:
            out.append(_instant_event(rec, lanes))
    return out


def export_chrome_trace(jsonl_path: str, run_id: str | None = None) -> dict:
    """Convert an EventLog JSONL file into a Chrome-trace dict
    (``{"traceEvents": [...]}``) that Perfetto / chrome://tracing loads
    directly. ``run_id`` filters a file that several processes appended
    to (training + serving sharing one path keep distinct run ids)."""
    records = events.read_events(jsonl_path)
    lanes = _Lanes()
    run_ids: set[str] = set()
    trace_events = _render_records(records, lanes, run_id, run_ids)
    trace_events.sort(key=lambda e: e.get("ts", 0.0))
    return {
        "traceEvents": lanes.meta + trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": jsonl_path,
            "run_ids": sorted(run_ids),
            "exporter": "ntxent_tpu_torch.obs.trace",
        },
    }


def validate_chrome_trace(trace: dict) -> int:
    """Assert ``trace`` is a structurally legal Chrome-trace object
    (the schema Perfetto's JSON importer requires); returns the number
    of non-metadata events. Raises ``ValueError`` on the first
    violation — tests and the smoke scripts share this one rule."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("top level must be an object with 'traceEvents'")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    n = 0
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"traceEvents[{i}] has no phase 'ph'")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"traceEvents[{i}] ({ph}) has no 'name'")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"metadata traceEvents[{i}] needs args")
            continue
        n += 1
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}] ({ph}) has no numeric 'ts'")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            raise ValueError(f"traceEvents[{i}] ({ph}) needs int pid/tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"complete traceEvents[{i}] needs 'dur' >= 0")
        elif ph == "i":
            if ev.get("s") not in ("g", "p", "t"):
                raise ValueError(
                    f"instant traceEvents[{i}] needs scope s in g/p/t")
        else:
            raise ValueError(
                f"traceEvents[{i}]: exporter never emits phase {ph!r}")
    return n


def main(argv=None) -> int:
    """JSONL event log -> Perfetto-loadable trace.json (``python -m
    ntxent_tpu_torch.obs.trace``)."""
    p = argparse.ArgumentParser(
        prog="python -m ntxent_tpu_torch.obs.trace",
        description="Convert a run's typed JSONL event log (the serve "
                    "CLI's --log-jsonl) into a Chrome-trace file; open it "
                    "at https://ui.perfetto.dev or chrome://tracing.")
    p.add_argument("jsonl", help="path to a JSONL event log")
    p.add_argument("-o", "--output", default="trace.json",
                   help="output trace file (default: trace.json)")
    p.add_argument("--run-id", default=None,
                   help="keep only records from this run_id (a shared "
                        "log file carries one id per process)")
    args = p.parse_args(argv)
    try:
        trace = export_chrome_trace(args.jsonl, run_id=args.run_id)
    except OSError as e:
        print(f"trace: cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 1
    n = validate_chrome_trace(trace)
    if n == 0:
        print(f"trace: {args.jsonl} contained no exportable events"
              + (f" for run_id {args.run_id}" if args.run_id else ""),
              file=sys.stderr)
        return 1
    with open(args.output, "w") as f:
        json.dump(trace, f)
    spans = sum(1 for e in trace["traceEvents"] if e.get("cat") == "span")
    steps = sum(1 for e in trace["traceEvents"] if e.get("cat") == "step")
    print(f"trace: wrote {args.output} ({n} events: {spans} spans, "
          f"{steps} steps; load in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
