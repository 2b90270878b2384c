"""Checkpoints and auto-resume for the port's training state.

The port of `kubeflow_tpu/train/checkpoint.py`'s `CheckpointManager`
interface (the JAX package writes through orbax; the card has no orbax).
The format is this package's own: one directory per step,

    <dir>/<step>/state.pt    torch.save of {"step", "count", "params"
                             {name: tensor}, "mu" [...], "nu" [...]}
    <dir>/<step>/data.json   the input iterator's resume state, if given

written into `<step>.tmp-<pid>` and published with `os.replace`, so a step
directory is whole or absent. A `*.tmp-*` directory found when a manager
starts is a torn write of a killed process and is swept. Restores load
with `torch.load(weights_only=True)` onto the state's device.

The save schedule is orbax's as the JAX trainer configures it: a step is
saved when it is past the latest saved step and either a multiple of
`interval` or the first save of the directory.

Async saves snapshot on the training thread and write on a worker thread.
The port's optimizer updates parameters and moments in place, so the
snapshot is a copy made before the next step runs: into reused pinned
host buffers by copies enqueued on the current stream (ordered before the
next step's in-place updates), which the writer waits for through an
event. One save is in flight at a time; `wait()` joins it and re-raises
its error.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any

import torch

from kubeflow_tpu_torch.utils import faults, resilience

_FP_SAVE = faults.register_point(
    "checkpoint.save", "before a checkpoint save lands; ctx: step")
_FP_RESTORE = faults.register_point(
    "checkpoint.restore", "before a checkpoint restore; ctx: step")

_LOG = logging.getLogger(__name__)

#: Subdirectory (inside the checkpoint root) where corrupt step dirs are
#: moved. Non-numeric, so the step scan ignores it; kept on disk for a
#: post-mortem of the torn write.
QUARANTINE_DIR = "quarantine"
STATE_FILE = "state.pt"
DATA_FILE = "data.json"
#: Marker of an in-flight step directory (`<step>.tmp-<pid>`).
_TMP_MARKER = ".tmp-"
#: Thread name of the async writer.
WRITER_THREAD = "tpk-checkpoint"


def _sweep_stale_tmp(directory: str) -> list[str]:
    """Delete torn `*.tmp-*` dirs under `directory`. At manager init no
    save of this directory can be in flight, so any is garbage from a
    killed attempt."""
    swept: list[str] = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return swept
    for name in entries:
        if _TMP_MARKER not in name:
            continue
        try:
            shutil.rmtree(os.path.join(directory, name))
        except OSError:
            continue
        swept.append(name)
    return swept


class CheckpointManager:
    """Saves and restores a `train.step.TrainState` (model parameters,
    AdamW moments and count, the step) plus the data iterator's state."""

    def __init__(self, directory: str, *, interval: int = 100,
                 keep: int | None = 3, async_save: bool = True):
        if interval < 1:
            raise ValueError(f"checkpoint interval must be >= 1, got "
                             f"{interval}")
        self.directory = str(directory)
        self.interval = int(interval)
        self._keep = keep
        self._async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        swept = _sweep_stale_tmp(self.directory)
        if swept:
            resilience.metrics.inc("tpk_checkpoint_tmp_swept_total",
                                   float(len(swept)), component="train")
            _LOG.warning("swept %d torn tmp dir(s) under %s: %s",
                         len(swept), self.directory, ", ".join(sorted(swept)))
        self._pending: int | None = None  # the step a writer is writing
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pinned: dict[tuple, torch.Tensor] = {}

    # -- steps ---------------------------------------------------------------

    def _disk_steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def all_steps(self) -> list[int]:
        """Saved steps, and the one being written."""
        # The writer publishes its step before it clears _pending, so
        # reading _pending first never misses a step in between.
        pending = self._pending
        steps = set(self._disk_steps())
        if pending is not None:
            steps.add(pending)
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """Whether `step` is on the save schedule — lets the trainer skip
        collecting iterator state on the steps that won't save."""
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self.interval == 0 or not steps

    # -- save ----------------------------------------------------------------

    def _host_copy(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        """A host copy of `t`: on CUDA into a reused pinned buffer by a
        copy enqueued on the current stream, on the CPU a clone."""
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t, non_blocking=True)
        return buf

    def _snapshot(self, state) -> tuple[dict, Any]:
        """(the state as host tensors, the event their copies end at)."""
        names = [n for n, _ in state.model.named_parameters()]
        payload = {
            "step": int(state.step),
            "count": int(state.opt_state.count),
            "params": {n: self._host_copy(("p", n), p) for n, p in
                       zip(names, state.params)},
            "mu": [self._host_copy(("mu", n), x)
                   for n, x in zip(names, state.opt_state.mu)],
            "nu": [self._host_copy(("nu", n), x)
                   for n, x in zip(names, state.opt_state.nu)],
        }
        event = None
        device = state.params[0].device
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return payload, event

    def _write(self, step: int, payload: dict, event, data_state) -> None:
        if event is not None:
            event.synchronize()
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}{_TMP_MARKER}{os.getpid()}"
        try:
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            if data_state is not None:
                with open(os.path.join(tmp, DATA_FILE), "w") as fh:
                    json.dump(data_state, fh)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()

    def _prune(self) -> None:
        if not self._keep:
            return
        for old in self._disk_steps()[:-self._keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def _write_async(self, step, payload, event, data_state) -> None:
        try:
            self._write(step, payload, event, data_state)
        except Exception as e:  # re-raised by wait()
            self._error = e
        finally:
            self._pending = None

    def maybe_save(self, step: int, state, *, data_state: Any = None,
                   force: bool = False) -> bool:
        """Save `state` as `step` if the schedule says so (or `force`).
        `data_state` is the input iterator's resume state, saved beside
        it. Returns whether a save started."""
        faults.fire(_FP_SAVE, step=step)
        if not force and not self.should_save(step):
            return False
        self.wait()  # one save in flight at a time; its buffers are reused
        if step in self.all_steps():
            raise ValueError(f"checkpoint step {step} already exists under "
                             f"{self.directory}")
        payload, event = self._snapshot(state)
        self._pending = step
        if not self._async_save:
            try:
                self._write(step, payload, event, data_state)
            finally:
                self._pending = None
            return True
        self._thread = threading.Thread(
            target=self._write_async, args=(step, payload, event, data_state),
            name=WRITER_THREAD, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        """Join the save in flight; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
        self._pinned.clear()

    # -- restore -------------------------------------------------------------

    def restore(self, state, step: int | None = None):
        """Load `step` (default: the latest) into `state` in place and
        return it; `state` untouched when no checkpoint exists. A file that
        does not load, or does not fit the state, raises before anything
        is copied."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state
        faults.fire(_FP_RESTORE, step=step)
        params = state.params
        device = params[0].device
        saved = torch.load(os.path.join(self.directory, str(step),
                                        STATE_FILE),
                           map_location=device, weights_only=True)
        names = [n for n, _ in state.model.named_parameters()]
        if list(saved["params"]) != names:
            raise ValueError(f"checkpoint step {step} holds parameters "
                             f"{list(saved['params'])[:4]}..., not the "
                             f"model's {names[:4]}...")
        srcs = [saved["params"][n] for n in names]
        for got, want in ((srcs, params), (saved["mu"], state.opt_state.mu),
                          (saved["nu"], state.opt_state.nu)):
            if len(got) != len(want) or any(
                    g.shape != w.shape or g.dtype != w.dtype
                    for g, w in zip(got, want)):
                raise ValueError(f"checkpoint step {step} does not fit the "
                                 "training state (shapes or dtypes differ)")
        with torch.no_grad():
            for got, want in ((srcs, params),
                              (saved["mu"], state.opt_state.mu),
                              (saved["nu"], state.opt_state.nu)):
                for g, w in zip(got, want):
                    w.copy_(g)
        state.step = int(saved["step"])
        state.opt_state.count = int(saved["count"])
        return state

    def quarantine_step(self, step: int) -> str | None:
        """Move `step`'s directory into `<root>/quarantine/` so the next
        latest_step() skips it. Returns the new path."""
        src = os.path.join(self.directory, str(step))
        if not os.path.isdir(src):
            return None
        qdir = os.path.join(self.directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, str(step))
        n = 1
        while os.path.exists(dst):
            dst = os.path.join(qdir, f"{step}.{n}")
            n += 1
        os.rename(src, dst)
        resilience.metrics.inc("tpk_checkpoint_quarantined_total",
                               component="train")
        return dst

    def restore_latest_good(self, state) -> tuple[Any, int | None,
                                                  list[int]]:
        """Restore the newest step that restores, quarantining any that
        raise (a torn write, a file that does not fit) and falling back
        to the next-newest. Returns (state, step, quarantined); (state,
        None, [...]) when nothing restorable remains."""
        quarantined: list[int] = []
        while True:
            step = self.latest_step()
            if step is None:
                return state, None, quarantined
            try:
                return self.restore(state, step), step, quarantined
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                dst = self.quarantine_step(step)
                if self.latest_step() == step:
                    raise RuntimeError(
                        f"checkpoint step {step} failed to restore and "
                        f"could not be quarantined under "
                        f"{self.directory}") from e
                quarantined.append(int(step))
                _LOG.warning(
                    "checkpoint step %s failed to restore (%s: %s); "
                    "quarantined to %s, falling back to the next-newest "
                    "step", step, type(e).__name__, e, dst)

    def restore_data_state(self, step: int | None = None) -> Any | None:
        """The saved input-iterator state, or None when the step has none
        or it is unreadable (the trainer then replays the stream)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        try:
            with open(os.path.join(self.directory, str(step),
                                   DATA_FILE)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None
