"""Request coalescing batcher: many small concurrent predict calls become
one padded model call.

The port of `kubeflow_tpu/serve/batcher.py` (KServe's agent batcher moved
inside the server). Policy matches the reference's: flush at
`max_batch_size` or after `max_latency_ms`, whichever first, the window
anchored at the head item's enqueue time. The model runs on the batcher's
one worker thread, so coalesced calls reach the card in order on one
stream; an oversized request runs on its caller's thread, as in JAX.

Each item keeps its request's trace id; no span is recorded (the port
has no tracer yet).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Sequence

import numpy as np

from kubeflow_tpu_torch.utils import faults
from kubeflow_tpu_torch.utils.resilience import Deadline, DeadlineExceeded

_FP_PREDICT = faults.register_point(
    "serve.predict", "batcher worker, before the coalesced model call; "
                     "ctx: batch (total examples)")


class _Item:
    __slots__ = ("inputs", "future", "n", "deadline", "t_enq", "trace")

    def __init__(self, inputs: Sequence[np.ndarray],
                 deadline: Deadline | None = None, trace_id: str = ""):
        self.inputs = [np.asarray(x) for x in inputs]
        self.n = self.inputs[0].shape[0]
        self.deadline = deadline
        self.t_enq = time.monotonic()
        self.trace = trace_id
        self.future: Future = Future()

    def deliver(self, result=None, exc: BaseException | None = None) -> None:
        """Complete the future, tolerating a caller that already gave up:
        a cancelled future raises InvalidStateError on set_result, which
        would otherwise kill the worker for every other request."""
        try:
            if exc is not None:
                self.future.set_exception(exc)
            else:
                self.future.set_result(result)
        except InvalidStateError:
            pass  # caller abandoned (deadline/cancel): result is moot

    def expire_if_due(self) -> bool:
        """Resolve the future with DeadlineExceeded when the request's
        budget is gone: an expired item must not occupy device batch rows
        its caller will never read. A caller-side cancel counts as expiry
        too. No metrics here: the surface that returns the error counts
        each expired request once."""
        if self.future.cancelled():
            return True
        if self.deadline is not None and self.deadline.expired():
            self.deliver(exc=DeadlineExceeded(
                "request deadline expired in the admission queue"))
            return True
        return False

    def signature(self) -> tuple:
        """Items only coalesce when per-example shapes and dtypes agree:
        one malformed request must not poison a batch of valid ones."""
        return tuple((a.shape[1:], str(a.dtype)) for a in self.inputs)


class Batcher:
    """Coalesces concurrent predict calls into single model calls.

    `predict_fn` takes a list of stacked input arrays and returns a list of
    output arrays whose leading dim equals the total batch.
    """

    def __init__(self, predict_fn: Callable[[list[np.ndarray]], list],
                 max_batch_size: int = 32, max_latency_ms: float = 5.0):
        self._predict = predict_fn
        self.max_batch_size = max_batch_size
        self.max_latency_s = max_latency_ms / 1e3
        self._q: queue.Queue[_Item | None] = queue.Queue()
        self._pending: _Item | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpk-batcher")
        self._closed = False
        self._lock = threading.Lock()
        # guarded-by: _lock
        self.stats = {"batches": 0, "items": 0, "examples": 0}
        self._thread.start()

    def submit(self, inputs: Sequence[np.ndarray],
               deadline: Deadline | None = None,
               trace_id: str = "") -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        item = _Item(inputs, deadline, trace_id)
        if item.expire_if_due():
            return item.future
        if item.n > self.max_batch_size:
            # Oversized requests bypass coalescing; TorchModel chunks them.
            if item.future.set_running_or_notify_cancel():
                try:
                    faults.fire(_FP_PREDICT, batch=item.n)
                    item.deliver(self._predict(item.inputs))
                except BaseException as e:  # noqa: BLE001 - to caller
                    item.deliver(exc=e)
            return item.future
        self._q.put(item)
        return item.future

    def predict(self, inputs: Sequence[np.ndarray],
                timeout: float | None = 30.0) -> list:
        return self.submit(inputs).result(timeout)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=5.0)

    # -- worker -------------------------------------------------------------

    def _gather(self) -> list[_Item] | None:
        """Blocks for the first item, then drains until the size limit or
        until max_latency has elapsed since the FIRST item was ENQUEUED (a
        fixed deadline: trickling arrivals do not extend it, and time the
        head spent queued behind an in-flight batch counts). An expired
        window flushes at once, after sweeping every compatible waiter
        already queued into the same call."""
        first = self._pending or self._q.get()
        self._pending = None
        while first is not None and first.expire_if_due():
            # Expired while queued: its caller already got the 504.
            first = self._q.get()
        if first is None:
            return None
        batch, total = [first], first.n
        sig = first.signature()
        deadline = first.t_enq + self.max_latency_s
        while total < self.max_batch_size:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._q.get_nowait() if remaining <= 0
                       else self._q.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post sentinel for the outer loop
                break
            if nxt.expire_if_due():
                continue
            if nxt.signature() != sig or total + nxt.n > self.max_batch_size:
                self._pending = nxt  # incompatible/overflow: next batch's head
                break
            batch.append(nxt)
            total += nxt.n
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return
            # Claim each item (PENDING -> RUNNING): a caller-side cancel can
            # no longer race the dispatch, so "cancelled" means "never
            # computed".
            batch = [i for i in batch
                     if i.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                faults.fire(_FP_PREDICT, batch=sum(i.n for i in batch))
                stacked = [np.concatenate(parts)
                           for parts in zip(*(i.inputs for i in batch))]
                outs = self._predict(stacked)
            except BaseException as e:  # noqa: BLE001 - deliver to callers
                for item in batch:
                    item.deliver(exc=e)
                continue
            with self._lock:
                self.stats["batches"] += 1
                self.stats["items"] += len(batch)
                self.stats["examples"] += sum(i.n for i in batch)
            off = 0
            for item in batch:
                item.deliver([o[off:off + item.n] for o in outs])
                off += item.n
