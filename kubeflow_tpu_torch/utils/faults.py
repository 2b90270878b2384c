"""Deterministic, seedable fault injection: the port's chaos fixture.

The port's copy of `kubeflow_tpu/utils/faults.py` (which imports no JAX,
but the port imports nothing of the JAX package). Code paths declare named
**injection points** (`register_point` at import, `fire(point, **ctx)` on
the hot path), and tests arm **policies** against them inside a scoped
harness:

    with faults.harness(seed=7) as h:
        h.arm("train.step", faults.FailN(1, match={"step": 4}))
        trainer.run()             # step 4 raises FaultError once
    assert h.counts["train.step"]["injected"] == 1

  * **Zero overhead disarmed**: `fire()` is one module-global `is None`
    check when no harness is active.
  * **Deterministic**: probabilistic policies draw from the harness's
    seeded rng in firing order, as the JAX package's do.
  * **Scoped**: the harness installs via context manager and uninstalls
    on exit even when the workload under test raises.

Policies: `FailN` (fail the first n matching firings), `FailProb` (fail
each matching firing with probability p), `Latency` (sleep before
proceeding). Every policy takes `match={...}` to restrict it to firings
whose context matches.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator


class FaultError(RuntimeError):
    """Default injected failure — a stand-in for 'the process died here'."""


#: name -> docstring; populated at import time by instrumented modules.
_POINTS: dict[str, str] = {}


def register_point(name: str, doc: str = "") -> str:
    """Declare an injection point (idempotent). Called at module import by
    instrumented code so `arm()` can reject typo'd names."""
    _POINTS.setdefault(name, doc)
    return name



class Policy:
    """Base: `match` filters firings by context equality on the given
    keys; non-matching firings pass through untouched (and uncounted)."""

    def __init__(self, match: dict | None = None):
        self.match = dict(match or {})

    def matches(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())

    def on_fire(self, rng, ctx: dict) -> BaseException | float | None:
        """Return an exception to inject, a float latency (seconds) to
        sleep, or None to pass through."""
        raise NotImplementedError

    def _make(self, ctx):
        """Instantiate this policy's `exc` (class or ready instance)."""
        if isinstance(self.exc, BaseException):
            return self.exc
        return self.exc(f"injected fault ({ctx.get('point')})")


class FailN(Policy):
    """Fail the first `n` matching firings with `exc`, then pass — the
    'transient error that heals' shape every retry loop is written for."""

    def __init__(self, n: int, exc: type[BaseException] | BaseException
                 = FaultError, match: dict | None = None):
        super().__init__(match)
        self.n = int(n)
        self.exc = exc
        self._left = int(n)

    def on_fire(self, rng, ctx):
        if self._left > 0:
            self._left -= 1
            return self._make(ctx)
        return None


class FailProb(Policy):
    """Fail each matching firing with probability `p`, drawing from the
    harness rng (deterministic per seed + firing order)."""

    def __init__(self, p: float, exc: type[BaseException] | BaseException
                 = FaultError, match: dict | None = None):
        super().__init__(match)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = float(p)
        self.exc = exc

    def on_fire(self, rng, ctx):
        if rng.random() < self.p:
            return self._make(ctx)
        return None


class Latency(Policy):
    """Sleep `seconds` before the protected operation proceeds — how
    deadline/overload behavior is exercised without a slow model."""

    def __init__(self, seconds: float, match: dict | None = None):
        super().__init__(match)
        self.seconds = float(seconds)

    def on_fire(self, rng, ctx):
        return self.seconds


class FaultHarness:
    """Holds armed policies and per-point firing counts. Thread-safe:
    instrumented code fires from worker threads (batcher, engine loop)."""

    def __init__(self, seed: int = 0):
        import random

        self.rng = random.Random(seed)
        self._armed: dict[str, list[Policy]] = {}
        self.counts: dict[str, dict[str, int]] = {}
        self._lock = threading.Lock()

    def arm(self, point: str, policy: Policy) -> "FaultHarness":
        """Attach `policy` to `point`. Unknown points raise — a typo'd
        name would otherwise arm a fault that can never fire."""
        if point not in _POINTS:
            raise ValueError(
                f"unknown injection point {point!r}; registered: "
                f"{sorted(_POINTS)}")
        with self._lock:
            self._armed.setdefault(point, []).append(policy)
        return self

    def fire(self, point: str, ctx: dict) -> None:
        with self._lock:
            policies = list(self._armed.get(point, ()))
            if not policies:
                return
            c = self.counts.setdefault(point,
                                       {"fired": 0, "injected": 0,
                                        "delayed": 0})
            c["fired"] += 1
            actions = []
            for p in policies:
                if not p.matches(ctx):
                    continue
                act = p.on_fire(self.rng, dict(ctx, point=point))
                if act is not None:
                    actions.append(act)
                    if isinstance(act, BaseException):
                        c["injected"] += 1
                    else:
                        c["delayed"] += 1
        # Sleep/raise OUTSIDE the lock: a Latency policy must not block
        # concurrent firings (that would serialize the very overload the
        # test is trying to create).
        for act in actions:
            if isinstance(act, BaseException):
                raise act
            time.sleep(act)


_ACTIVE: FaultHarness | None = None
_INSTALL_LOCK = threading.Lock()


def fire(point: str, **ctx: Any) -> None:
    """Hot-path hook. ONE global read + None check when disarmed — the
    whole production cost of the harness."""
    h = _ACTIVE
    if h is None:
        return
    h.fire(point, ctx)


def active() -> FaultHarness | None:
    return _ACTIVE


@contextlib.contextmanager
def _install(h: FaultHarness) -> Iterator[FaultHarness]:
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fault harness is already installed "
                               "(nesting would make injections ambiguous)")
        _ACTIVE = h
    try:
        yield h
    finally:
        _ACTIVE = None


@contextlib.contextmanager
def harness(seed: int = 0) -> Iterator[FaultHarness]:
    """`with faults.harness(seed=7) as h: h.arm(...)` — the test fixture."""
    with _install(FaultHarness(seed)) as h:
        yield h
