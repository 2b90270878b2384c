"""Background input prefetcher: host data prep and H2D off the step loop.

The port of `kubeflow_tpu/data/prefetch.py`'s `Prefetcher`. One worker
thread pulls raw numpy batches, applies the optional host-side `transform`
and stages up to `depth` device-resident batches ahead of compute. On CUDA
each array is copied into pinned host memory and then to the device on a
side stream; the batch carries an event recorded after its copies, and
`next()` makes the consumer's current stream wait on that event (a
device-side wait, not a host sync) and marks the tensors as used by that
stream, so the caching allocator never hands their memory to the side
stream while a step still reads them. On the CPU the arrays become tensors
as they are.

Resume state: the worker snapshots the iterator's checkpoint state
alongside each batch as it pulls it, and `consumed_state()` returns the
snapshot paired with the batch most recently handed to the caller, not
the iterator's read-ahead position. A checkpoint taken after training
batch N therefore resumes at batch N+1 although the worker had already
pulled batches N+1..N+depth.

`depth=0` runs the same pull -> transform -> place inline on the calling
thread (no worker); the `data.next` fault point then fires there.

Failure semantics as in the JAX package: an exception raised while pulling
or preparing a batch on the worker (faults injected at `data.next`
included) is queued in order and re-raised from `next()` on the training
thread; the worker exits after queuing it. `close()` is idempotent, drains
the queue and joins the thread, and every trainer exit path calls it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from kubeflow_tpu_torch.data.loader import iterator_state
from kubeflow_tpu_torch.utils import faults, resilience

_LOG = logging.getLogger(__name__)

#: Fires before every raw-batch pull (ctx: n = 0-based pull index). With
#: depth >= 1 it fires on the worker thread; the injected error is still
#: delivered to the training thread at the matching `next()`.
_FP_NEXT = faults.register_point(
    "data.next", "before each raw-batch pull from the input iterator; "
    "ctx: n (0-based pull index)")

#: Thread-name prefix for every prefetch worker — the test suite's
#: thread-leak guard (tests/conftest.py) keys on it.
THREAD_NAME = "tpk-prefetch"

_STOP = object()  # sentinel: the wrapped iterator is exhausted


class _Failure:
    """An exception captured on the worker, queued in stream order."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Depth-K queue of device-placed batches.

    Args:
      it: the raw batch iterator (dicts of numpy arrays; checkpointable or
        a plain generator). The prefetcher takes ownership: nothing else
        may pull from it while it lives.
      depth: queue capacity. 0 = synchronous passthrough (no thread);
        K >= 1 lets the worker run up to K+1 batches ahead.
      device: where batches land (torch.device or string).
      transform: optional host-side per-batch transform applied before
        placement.
    """

    def __init__(self, it: Iterator[Any], *, depth: int, device,
                 transform: Callable[[dict], dict] | None = None):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self._it = iter(it)
        self._depth = int(depth)
        self._transform = transform
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device.type == "cuda" else None)
        # The worker's h2d_s writes race the training thread's reads.
        self._lock = threading.Lock()
        self._exc: BaseException | None = None
        self._exhausted = False
        self._closed = False
        # guarded-by: _lock
        self.data_wait_s = 0.0  # training-thread time spent inside next()
        # guarded-by: _lock
        self.h2d_s = 0.0        # wall time spent placing batches on device
        self._pulled = 0  # guarded-by: _lock; raw batches pulled
        self._thread: threading.Thread | None = None
        if self._depth:
            # Captured BEFORE the worker starts reading ahead: the floor
            # consumed_state() returns until a batch is consumed.
            self._consumed_state = iterator_state(self._it)
            self._q: queue.Queue = queue.Queue(maxsize=self._depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._worker, name=THREAD_NAME, daemon=True)
            self._thread.start()

    # -- placement -----------------------------------------------------------

    def _place(self, raw: dict) -> tuple[dict, Any]:
        """(batch of device tensors, event its copies complete on), after
        the transform."""
        if self._transform is not None:
            raw = self._transform(raw)
        t0 = time.perf_counter()
        if self._stream is None:
            out = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in raw.items()}
            event = None
        else:
            with torch.cuda.stream(self._stream):
                out = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .pin_memory().to(self._device, non_blocking=True)
                       for k, v in raw.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        dt = time.perf_counter() - t0
        with self._lock:
            self.h2d_s += dt
        return out, event

    def _hand_over(self, item: tuple[dict, Any]) -> dict:
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for x in batch.values():
                x.record_stream(consumer)
        return batch

    # -- worker --------------------------------------------------------------

    def _offer(self, item: Any) -> bool:
        """Blocking put that stays responsive to close(): a worker stuck
        on a full queue must observe the stop flag, not deadlock."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _pull(self) -> dict:
        with self._lock:
            n = self._pulled
        faults.fire(_FP_NEXT, n=n)
        raw = next(self._it)  # StopIteration propagates as-is
        with self._lock:
            self._pulled += 1
        return raw

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                raw = self._pull()
            except StopIteration:
                self._offer(_STOP)
                return
            except BaseException as e:
                self._offer(_Failure(e))
                return
            try:
                # Snapshot BEFORE reading ahead any further: this state
                # resumes at the batch after `raw`.
                state = iterator_state(self._it)
                item = (self._place(raw), state)
            except BaseException as e:
                self._offer(_Failure(e))
                return
            if not self._offer(item):
                return

    # -- consumer ------------------------------------------------------------

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        try:
            if self._depth == 0:
                if self._closed:
                    raise RuntimeError("Prefetcher is closed")
                return self._hand_over(self._place(self._pull()))
            if self._exc is not None:
                raise self._exc
            if self._exhausted:
                raise StopIteration
            if self._closed:
                # The queue was drained and the worker stopped — a bare
                # q.get() here would block forever.
                raise RuntimeError("Prefetcher is closed")
            item = self._q.get()
            if item is _STOP:
                self._exhausted = True
                raise StopIteration
            if isinstance(item, _Failure):
                self._exc = item.exc
                raise item.exc
            placed, self._consumed_state = item
            return self._hand_over(placed)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.data_wait_s += dt
            resilience.metrics.inc("tpk_data_wait_seconds_total", dt,
                                   component="train")

    next = __next__

    def consumed_state(self) -> Mapping[str, Any] | None:
        """Iterator resume state matching the batches handed out so far
        (None for plain generators). Safe to call after close()."""
        if self._depth == 0:
            return iterator_state(self._it)
        return self._consumed_state

    def close(self, timeout: float = 5.0) -> None:
        """Stop and join the worker (idempotent)."""
        self._closed = True
        if self._thread is None:
            return
        self._stop.set()
        try:  # unblock a worker waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout)
        if self._thread.is_alive():
            # Wedged inside next(self._it): keep the handle so a later
            # close() can retry the join, and make the leak visible.
            _LOG.warning(
                "prefetch worker did not exit within %.1fs (stuck in the "
                "input iterator?); thread left running, close() may be "
                "retried", timeout)
            return
        self._thread = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
