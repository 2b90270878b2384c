"""Resilience primitives of the trainer, its checkpoints and the server.

The port's copy of the parts of `kubeflow_tpu/utils/resilience.py` that
this package calls: `BackoffPolicy` (exponential backoff with jitter, the
delays of the `ExponentialBackoff` restart policy), `BackoffLimitExceeded`
(the typed failure of an exhausted restart budget) and `metrics`, the
process-global counters under the JAX package's names
(`tpk_restarts_total`, `tpk_retry_exhausted_total`,
`tpk_checkpoint_quarantined_total`, `tpk_checkpoint_tmp_swept_total`,
`tpk_data_wait_seconds_total`); and, for the server, `Deadline` (an
absolute budget on the monotonic clock with an injectable clock) and
`DeadlineExceeded` (its one typed expiry, 504 at the HTTP surface), and
the gauges, histograms (`DEFAULT_BUCKETS`) and prometheus exposition that
the server's `/metrics` renders (`tpk_deadline_expired_total`,
`tpk_shed_total`, `tpk_serve_request_latency_seconds`), byte-compatible
with the JAX package's. Retry budgets and `retry_call` have no caller in
this package and are not copied.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable


class DeadlineExceeded(TimeoutError):
    """A per-request/per-call budget expired (serve maps this to 504)."""


class BackoffLimitExceeded(RuntimeError):
    """A supervised retry loop exhausted its restart/attempt budget (the
    training-operator's `backoffLimit` failure, typed)."""


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff schedule with full jitter.

    `delay(attempt)` is the sleep before retry number `attempt` (0-based):
    base·multiplier^attempt, capped at `max_s`, then jittered down by up
    to `jitter` fraction (uniform). Pass a seeded `random.Random` for a
    deterministic schedule (tests); the default draws from the module rng.
    """

    initial_s: float = 0.05
    max_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        d = min(self.initial_s * self.multiplier ** max(attempt, 0),
                self.max_s)
        if self.jitter > 0:
            u = (rng or _RNG).random()
            d *= 1.0 - self.jitter * u
        return d


_RNG = random.Random()


class Deadline:
    """Absolute time budget on the monotonic clock.

    `Deadline(None)` never expires — callers thread one object through
    unconditionally instead of branching on "has a deadline". The clock is
    injectable so tests advance time without sleeping.
    """

    __slots__ = ("_clock", "_at")

    def __init__(self, budget_s: float | None,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._at = None if budget_s is None else clock() + float(budget_s)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> float | None:
        """Seconds left (may be <= 0), or None for a never-expiring one."""
        if self._at is None:
            return None
        return self._at - self._clock()

    def expired(self) -> bool:
        return self._at is not None and self._clock() >= self._at

    def bound(self, timeout: float) -> float:
        """`timeout` clipped to the remaining budget (for per-hop socket/
        wait timeouts under an end-to-end deadline)."""
        rem = self.remaining()
        return timeout if rem is None else min(timeout, max(rem, 0.0))

    def require(self, what: str = "operation",
                component: str = "") -> None:
        """Raise `DeadlineExceeded` (and count it) if the budget is gone."""
        if self.expired():
            if component:
                metrics.inc("tpk_deadline_expired_total",
                            component=component)
            raise DeadlineExceeded(f"deadline expired before {what}")


def _escape_label(value: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double-quote, and newline must be escaped or the line is invalid
    (and a crafted value could inject whole fake series). Backslash
    first — escaping it last would re-mangle the other escapes."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(lbl: tuple) -> str:
    """Render a sorted (key, value) label tuple as `k1="v1",k2="v2"`
    with spec-compliant value escaping (shared by snapshot and the
    exposition renderer so the two can't drift)."""
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in lbl)


def _fmt_value(v: float):
    return int(v) if float(v).is_integer() else v


#: Default histogram buckets, in seconds — latency-shaped (sub-ms to
#: 10 s), cumulative `le` rendering adds +Inf. Callers measuring
#: something else pass explicit buckets on first observe().
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class Counters:
    """Process-global labeled counters/gauges/histograms with prometheus
    rendering — the uniform metrics surface every resilience consumer
    increments."""

    def __init__(self):
        self._counts: dict[tuple, float] = {}  # guarded-by: _lock
        self._gauges: dict[tuple, float] = {}  # guarded-by: _lock
        # Histograms: family name -> bucket upper bounds (fixed at first
        # observe — every label set of a family shares one bucket
        # layout, as prometheus requires); (name, labels) -> [per-bucket
        # counts (NON-cumulative; +Inf implicit), sum, count].
        self._hist_buckets: dict[str, tuple] = {}  # guarded-by: _lock
        self._hists: dict[tuple, list] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + value

    def get(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counts.get(key, 0.0)

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        """Last-write-wins gauge (config knobs, live depths) rendered
        next to the counters with the proper prometheus TYPE."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = float(value)

    def get_gauge(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._gauges.get(key, 0.0)

    def observe(self, name: str, value: float,
                buckets: tuple | None = None, **labels: str) -> None:
        """Record one histogram observation. The family's bucket layout
        is fixed by the FIRST observe (explicit `buckets` or
        DEFAULT_BUCKETS); later calls reuse it — prometheus histograms
        cannot change buckets mid-flight."""
        value = float(value)
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            bkts = self._hist_buckets.get(name)
            if bkts is None:
                bkts = tuple(sorted(float(b) for b in
                                    (buckets or DEFAULT_BUCKETS)))
                self._hist_buckets[name] = bkts
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [[0] * len(bkts), 0.0, 0]
            counts, _, _ = h
            for i, le in enumerate(bkts):
                if value <= le:
                    counts[i] += 1
                    break
            # else: only the implicit +Inf bucket (== count) holds it.
            h[1] += value
            h[2] += 1

    def get_histogram(self, name: str, **labels: str) -> dict:
        """{"buckets": {le: CUMULATIVE count}, "sum", "count"} — the
        test/introspection view of one labeled series ("+Inf" included)."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            bkts = self._hist_buckets.get(name, ())
            h = self._hists.get(key)
            if h is None:
                return {"buckets": {}, "sum": 0.0, "count": 0}
            counts, total, n = list(h[0]), h[1], h[2]
        cum, out = 0, {}
        for le, c in zip(bkts, counts):
            cum += c
            out[le] = cum
        out["+Inf"] = n
        return {"buckets": out, "sum": total, "count": n}

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._counts.items()) + sorted(
                self._gauges.items())
            # Copy sum/count under the lock: the stored lists are live
            # and a concurrent observe() could tear the pair.
            hists = [(key, (h[1], h[2]))
                     for key, h in sorted(self._hists.items())]
        out = {
            name + ("{%s}" % _label_str(lbl) if lbl else ""): v
            for (name, lbl), v in items}
        for (name, lbl), (total, n) in hists:
            tag = "{%s}" % _label_str(lbl) if lbl else ""
            out[f"{name}_sum{tag}"] = total
            out[f"{name}_count{tag}"] = n
        return out

    def prometheus_text(self) -> str:
        lines = []
        seen: set[str] = set()
        with self._lock:
            items = ([(n, lbl, v, "counter")
                      for (n, lbl), v in sorted(self._counts.items())]
                     + [(n, lbl, v, "gauge")
                        for (n, lbl), v in sorted(self._gauges.items())])
            hists = [(n, lbl, list(h[0]), h[1], h[2])
                     for (n, lbl), h in sorted(self._hists.items())]
            hist_buckets = dict(self._hist_buckets)
        for name, lbl, v, kind in items:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} {kind}")
            tag = "{%s}" % _label_str(lbl) if lbl else ""
            lines.append(f"{name}{tag} {_fmt_value(v)}")
        for name, lbl, counts, total, n in hists:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} histogram")
            base = _label_str(lbl)
            cum = 0
            for le, c in zip(hist_buckets.get(name, ()), counts):
                cum += c
                tag = (base + "," if base else "") + f'le="{le:g}"'
                lines.append(f"{name}_bucket{{{tag}}} {cum}")
            tag = (base + "," if base else "") + 'le="+Inf"'
            lines.append(f"{name}_bucket{{{tag}}} {n}")
            suffix = "{%s}" % base if base else ""
            lines.append(f"{name}_sum{suffix} {_fmt_value(total)}")
            lines.append(f"{name}_count{suffix} {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Test hook — counters are process-global."""
        with self._lock:
            self._counts.clear()
            self._gauges.clear()
            self._hists.clear()
            self._hist_buckets.clear()


metrics = Counters()
