"""Resilience primitives the trainer and its checkpoints use.

The port's copy of the parts of `kubeflow_tpu/utils/resilience.py` that
training needs: `BackoffPolicy` (exponential backoff with jitter, the
delays of the `ExponentialBackoff` restart policy), `BackoffLimitExceeded`
(the typed failure of an exhausted restart budget) and `metrics`, the
process-global counters under the JAX package's names
(`tpk_restarts_total`, `tpk_retry_exhausted_total`,
`tpk_checkpoint_quarantined_total`, `tpk_checkpoint_tmp_swept_total`,
`tpk_data_wait_seconds_total`). Deadlines, retry budgets, gauges,
histograms and the prometheus exposition come with the server's
`/metrics`.
"""

from __future__ import annotations

import dataclasses
import random
import threading


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


class Counters:
    """Process-global labeled counters."""

    def __init__(self):
        self._counts: dict[tuple, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + value

    def get(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counts.get(key, 0.0)

    def reset(self) -> None:
        """Test hook: counters are process-global."""
        with self._lock:
            self._counts.clear()


metrics = Counters()
