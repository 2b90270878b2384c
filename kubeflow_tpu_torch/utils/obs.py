"""Request-scoped tracing: spans, trace ids, a bounded ring, Chrome export.

The port's copy of `kubeflow_tpu/utils/obs.py`, the one tracing surface
every layer shares:

  * **Trace identity.** One request id threads through the whole stack:
    the model server assigns/honors `X-Request-Id`, the trainer uses its
    job name. Spans carry the id, so a single request's admit ->
    batch-gather -> prefill -> decode -> fetch timeline can be filtered
    out of process noise.
  * **Spans.** Host-side wall intervals with a name, a trace id, and
    small attrs. Two recording styles: `span(...)` as a context manager
    around synchronous work, and `Tracer.record(...)` for intervals
    measured externally (the serving engine times dispatch -> fetch
    itself: the card runs asynchronously, so a `with` block around a
    launch would lie).
  * **Bounded ring, zero hot-path cost.** Finished spans land in a
    process-local ring (`deque(maxlen=capacity)`). Spans never touch a
    tensor: recording is perf_counter arithmetic plus one append, so the
    train and decode loops add no host sync with tracing on.
    `TPK_TRACE=0` (or `tracer.enabled = False`) turns recording into a
    shared no-op object.
  * **Chrome trace export.** `chrome_trace()` renders the ring as Chrome
    trace-event JSON (`ph: "X"` complete events), loadable in
    chrome://tracing / Perfetto: `GET /debug/trace` on the model server.
"""

from __future__ import annotations

import os
import re
import threading
import time
import uuid
from collections import deque

#: ts values are microseconds since this process-local epoch (Chrome
#: trace wants a monotonic µs timeline, not wall time).
_EPOCH = time.perf_counter()

_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9._:-]")
_MAX_TRACE_ID = 128


def new_trace_id() -> str:
    """A fresh request/trace id (uuid4 hex — no coordination needed)."""
    return uuid.uuid4().hex


def perf_to_us(t: float) -> float:
    """A time.perf_counter() reading as microseconds on this process's
    span timeline (the `ts` unit chrome_trace exports)."""
    return (t - _EPOCH) * 1e6


def sanitize_trace_id(raw: str | None) -> str:
    """A caller-supplied id, made safe for logs/exposition: restricted
    charset, bounded length; empty/None gets a fresh id."""
    if not raw:
        return new_trace_id()
    return _TRACE_ID_RE.sub("_", str(raw))[:_MAX_TRACE_ID] or new_trace_id()


class Span:
    """A finished (or in-flight, inside `with`) host-side interval."""

    __slots__ = ("name", "trace_id", "attrs", "ts_us", "dur_us", "tid",
                 "_tracer", "_t0")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs
        self.ts_us = 0.0
        self.dur_us = 0.0
        self.tid = ""
        self._t0 = 0.0

    @property
    def dur_s(self) -> float:
        return self.dur_us / 1e6

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attrs (mid-span annotations)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.ts_us = (self._t0 - _EPOCH) * 1e6
        self.dur_us = (t1 - self._t0) * 1e6
        self.tid = threading.current_thread().name
        self._tracer._append(self)


class _NopSpan:
    """Shared do-nothing span — what `span()` hands out when tracing is
    disabled. One instance for the whole process: zero allocation on the
    disabled path."""

    __slots__ = ()
    name = ""
    trace_id = ""
    attrs: dict | None = None
    ts_us = dur_us = 0.0
    dur_s = 0.0
    tid = ""

    def set(self, **attrs) -> "_NopSpan":
        return self

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOP_SPAN = _NopSpan()


class Tracer:
    """Process-local span recorder with a bounded ring buffer."""

    def __init__(self, capacity: int = 4096, enabled: bool | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        if enabled is None:
            enabled = os.environ.get("TPK_TRACE", "1") != "0"
        self.enabled = bool(enabled)
        self._ring: deque[Span] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, trace_id: str = "", **attrs):
        """Context manager measuring the enclosed block. Returns the
        Span (its `dur_s` is valid after exit) — or the shared no-op
        when tracing is disabled."""
        if not self.enabled:
            return NOP_SPAN
        return Span(self, name, trace_id, attrs or None)

    def record(self, name: str, t0: float, t1: float, trace_id: str = "",
               **attrs) -> None:
        """Record an externally measured interval (`t0`/`t1` are
        time.perf_counter() readings)."""
        if not self.enabled:
            return
        sp = Span(self, name, trace_id, attrs or None)
        sp.ts_us = (t0 - _EPOCH) * 1e6
        sp.dur_us = max(t1 - t0, 0.0) * 1e6
        sp.tid = threading.current_thread().name
        self._append(sp)

    def _append(self, sp: Span) -> None:
        with self._lock:
            self._ring.append(sp)

    # -- export -------------------------------------------------------------

    def events(self, trace_id: str | None = None) -> list[dict]:
        """Spans as plain dicts, oldest first; optionally filtered to one
        trace id."""
        with self._lock:
            spans = list(self._ring)
        out = []
        for sp in spans:
            if trace_id is not None and sp.trace_id != trace_id:
                continue
            out.append({
                "name": sp.name, "trace_id": sp.trace_id,
                "ts_us": sp.ts_us, "dur_us": sp.dur_us, "tid": sp.tid,
                "attrs": dict(sp.attrs) if sp.attrs else {},
            })
        return out

    def chrome_trace(self, trace_id: str | None = None) -> dict:
        """The ring as a Chrome trace-event document (chrome://tracing /
        Perfetto's legacy JSON format): `ph: "X"` complete events, ts/dur
        in microseconds, the trace id and attrs under `args`."""
        pid = os.getpid()
        events = []
        for ev in self.events(trace_id):
            events.append({
                "name": ev["name"], "cat": "tpk", "ph": "X",
                "ts": round(ev["ts_us"], 3), "dur": round(ev["dur_us"], 3),
                "pid": pid, "tid": ev["tid"] or "main",
                "args": {"trace_id": ev["trace_id"], **ev["attrs"]},
            })
        # `now_us` stamps export time on this process's own µs timeline.
        # A fetcher that measured the request's RTT can estimate the
        # clock offset between its timeline and ours (midpoint method,
        # see merge_chrome_traces) — Chrome/Perfetto ignore unknown
        # top-level keys.
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "now_us": perf_to_us(time.perf_counter())}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: The process-global tracer. Read through `get_tracer()` / the module
#: helpers so tests can swap in a bounded/disabled instance.
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer (tests); returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def span(name: str, trace_id: str = "", **attrs):
    """Module-level convenience: a span on the process-global tracer."""
    return _TRACER.span(name, trace_id, **attrs)


def record(name: str, t0: float, t1: float, trace_id: str = "",
           **attrs) -> None:
    _TRACER.record(name, t0, t1, trace_id, **attrs)


def merge_chrome_traces(parts: list[dict]) -> dict:
    """Merge per-process Chrome trace documents onto ONE timeline.

    Each part is `{"process": name, "doc": chrome_trace() output,
    "offset_us": float, "err_us": float | None}` — `offset_us` shifts
    that process's span timestamps onto the merging process's timeline
    (add it to every `ts`), `err_us` is the honest uncertainty of that
    estimate (half the fetch RTT with the midpoint method; None means
    the part was NOT aligned — e.g. an old replica whose export lacks
    `now_us` — and rides un-shifted).

    Every process gets a synthetic pid (original pids can collide across
    hosts) plus a `ph: "M"` process_name metadata event, so Perfetto
    shows one labeled track per process. The alignment estimates are
    kept in the output under `clock_alignment` — the merged timeline is
    an ESTIMATE with a stated error bar, never presented as exact.
    """
    events: list[dict] = []
    alignment: dict[str, dict] = {}
    for pid, part in enumerate(parts):
        name = str(part.get("process") or f"proc{pid}")
        doc = part.get("doc") or {}
        offset_us = float(part.get("offset_us") or 0.0)
        err_us = part.get("err_us")
        alignment[name] = {
            "offset_us": round(offset_us, 3),
            "skew_err_us": (round(float(err_us), 3)
                            if err_us is not None else None),
            "aligned": err_us is not None,
        }
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        for ev in doc.get("traceEvents") or []:
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) + offset_us, 3)
            events.append(ev)
    events.sort(key=lambda ev: (ev.get("ph") != "M", ev.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "clock_alignment": alignment}


class FlightRecorder:
    """Bounded ring of per-request outcome records + chaos snapshots.

    The router drops one record per concluded request (trace id, replica
    trail including resumes, TTFT/e2e, outcome, shed/deadline reason) —
    a postmortem of the last-K requests that costs one dict append, no
    live debugger, no log scraping. `snapshot(reason)` freezes the tail
    at interesting moments (resume fired, replica ejected) so the
    context *around* a chaos event survives ring turnover.
    """

    def __init__(self, capacity: int = 512, snapshot_capacity: int = 16,
                 snapshot_tail: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.snapshot_tail = int(snapshot_tail)
        self._lock = threading.Lock()
        self._records: deque[dict] = deque(
            maxlen=self.capacity)  # guarded-by: _lock
        self._snapshots: deque[dict] = deque(
            maxlen=int(snapshot_capacity))  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def record(self, **fields) -> dict:
        """Append one concluded-request record; returns it (with its
        monotone `seq` stamped)."""
        rec = dict(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._records.append(rec)
        return rec

    def tail(self, n: int | None = None) -> list[dict]:
        """Most-recent-last copies of the last `n` records (all, when
        n is None)."""
        with self._lock:
            recs = list(self._records)
        if n is not None:
            recs = recs[-max(int(n), 0):] if n else []
        return [dict(r) for r in recs]

    def lookup(self, trace_id: str) -> dict | None:
        """The most recent record for `trace_id`, or None."""
        with self._lock:
            for rec in reversed(self._records):
                if rec.get("trace_id") == trace_id:
                    return dict(rec)
        return None

    def snapshot(self, reason: str, **context) -> dict:
        """Freeze the last `snapshot_tail` records under `reason` (e.g.
        ``resume:dec0``, ``eject:m1``) with a wall-clock stamp."""
        with self._lock:
            snap = {
                "reason": reason, "t_unix": time.time(),
                "context": dict(context),
                "records": [dict(r) for r in
                            list(self._records)[-self.snapshot_tail:]],
            }
            self._snapshots.append(snap)
        return snap

    def snapshots(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._snapshots]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._snapshots.clear()
