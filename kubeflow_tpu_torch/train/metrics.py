"""Step metrics and MFU accounting.

The port of `kubeflow_tpu/train/metrics.py`: per-window step time,
tokens/sec and MFU with the convention MFU = 6·N·tok/s ÷ (chips · peak
dense BF16 FLOP/s), and the JSONL metrics stream.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

# Peak dense BF16 FLOP/s per device. H100: NVIDIA H100 SXM data sheet
# (989 TFLOP/s without sparsity, at the 700 W limit).
PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 1e12,  # nominal, so MFU math stays finite in CPU tests
}


def peak_flops_per_chip(device=None) -> float:
    """The peak of `device` (default: CUDA device 0 when CUDA is up, else
    the CPU), keyed on `torch.cuda.get_device_name`. Unknown cards get
    the CPU's nominal figure, as in the JAX package."""
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    if dev is None or dev.type != "cuda":
        return PEAK_FLOPS["cpu"]
    kind = torch.cuda.get_device_name(dev).lower()
    for key, val in PEAK_FLOPS.items():
        if key in kind:
            return val
    return PEAK_FLOPS["cpu"]


@dataclasses.dataclass
class StepTimer:
    """Tracks smoothed step time / tokens/s / MFU across the training loop
    of one device (`peak`: its peak_flops_per_chip)."""

    num_params: int
    tokens_per_step: int
    peak: float
    warmup_steps: int = 2  # exclude the first (allocator-warming) steps
    _count: int = 0
    _total_time: float = 0.0
    _last: float | None = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, n_steps: int = 1) -> dict:
        """Close a timing window covering `n_steps` device steps (the trainer
        only blocks on logging steps, so a window spans several steps)."""
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        prev = self._count
        self._count += n_steps
        # Steps beyond the warmup threshold count toward the average.
        counted = self._count - max(prev, self.warmup_steps)
        if counted > 0:
            self._total_time += dt * (counted / n_steps)
        return self.snapshot(step_time=dt / max(n_steps, 1))

    def snapshot(self, step_time: float | None = None) -> dict:
        counted = max(self._count - self.warmup_steps, 0)
        avg = self._total_time / counted if counted else (step_time or 0.0)
        tps = self.tokens_per_step / avg if avg else 0.0
        model_flops = 6.0 * self.num_params * tps  # fwd+bwd matmul FLOPs
        mfu = model_flops / self.peak if avg else 0.0
        return {
            "step_time_s": step_time if step_time is not None else avg,
            "avg_step_time_s": avg,
            "tokens_per_sec": tps,
            "mfu": mfu,
        }


class MetricsLogger:
    """JSONL metrics stream. One JSON object per line, always with
    "step"."""

    def __init__(self, path: str | None = None, stream=None):
        self._fh = open(path, "a", buffering=1) if path else None
        self._stream = stream if stream is not None else sys.stdout

    def log(self, step: int, payload: dict):
        rec = {"step": int(step)}
        for k, v in payload.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                tolist = getattr(v, "tolist", None)
                rec[k] = tolist() if tolist is not None else str(v)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self._stream:
            print(line, file=self._stream, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
