"""The training runtime: what a training worker process runs.

The port of `kubeflow_tpu/train/trainer.py` for one process on one device:
a `TrainJobSpec` (the JAX package's field names and JSON) drives model and
dataset registries, the prefetching input pipeline, the eager train step
(flash attention forward and backward through the CUDA kernels on a GPU)
and the JSONL metrics stream with tokens/s and MFU.

    python -m kubeflow_tpu_torch.train.trainer --spec job.json [--device cpu]

The loop blocks on the device only at `log_every` boundaries. Features of
the JAX runtime that the port does not have yet are refused by name with
NotImplementedError, never ignored: a device mesh or a non-default
sharding strategy, FSDP, pipeline parallelism, LoRA, ring attention,
checkpoints, restart policies, profiler windows, the eval stream, the
fsdp compute dtype (`param_dtype`) and TPK_FAULT fault injection.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from kubeflow_tpu_torch.data.prefetch import Prefetcher
from kubeflow_tpu_torch.train.metrics import (MetricsLogger, StepTimer,
                                              peak_flops_per_chip)
from kubeflow_tpu_torch.train.optim import (AdamW, Schedule,
                                            join_schedules, linear_schedule,
                                            warmup_cosine_decay_schedule)
from kubeflow_tpu_torch.train.step import init_train_state, make_train_step
from kubeflow_tpu_torch.utils import registry
from kubeflow_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass
class TrainJobSpec:
    """Declarative training job, field for field the JAX package's (see
    `kubeflow_tpu/train/trainer.py` for each field's meaning). Fields of
    features the port does not have are kept so a JAX job spec parses;
    the Trainer refuses them when set."""

    model: str = "llama_tiny"
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    dataset: str = "synthetic_lm"
    dataset_kwargs: dict = dataclasses.field(default_factory=dict)
    strategy: str = "hybrid"
    mesh: dict = dataclasses.field(default_factory=dict)
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 64
    learning_rate: float = 1e-3
    warmup_steps: int = 0
    weight_decay: float = 0.0
    lr_schedule: str = "constant"  # constant | cosine | linear
    lr_final: float = 0.0
    max_grad_norm: float = 0.0
    accum_steps: int = 1
    grad_accum: int = 0
    fsdp: int = 0
    param_dtype: str | None = None
    seed: int = 0
    ring_attention: bool | str = False
    loss_impl: str = "full"
    loss_chunk: int = 1024
    pipeline: dict = dataclasses.field(default_factory=dict)
    lora: dict = dataclasses.field(default_factory=dict)
    checkpoint: dict = dataclasses.field(default_factory=dict)
    restart_policy: str = "Never"
    backoff_limit: int = 3
    prefetch: int = 2
    metrics_path: str | None = None
    profile: dict = dataclasses.field(default_factory=dict)
    profile_start_step: int = 0
    profile_stop_step: int = 0
    log_every: int = 10
    eval_dataset: str | None = None
    eval_dataset_kwargs: dict = dataclasses.field(default_factory=dict)
    eval_every: int = 0
    eval_batches: int = 8

    @classmethod
    def from_json(cls, text: str) -> "TrainJobSpec":
        data = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown TrainJobSpec fields: {sorted(unknown)}")
        return cls(**data)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _refuse_unported(spec: TrainJobSpec) -> None:
    """NotImplementedError, by name, for every spec feature not ported."""
    refused = [
        (spec.mesh, "mesh (a device mesh)"),
        (spec.strategy != "hybrid",
         f"strategy={spec.strategy!r} (sharding rules over a mesh)"),
        (spec.fsdp, "fsdp (FSDP master-state sharding)"),
        (spec.pipeline, "pipeline (pipeline parallelism)"),
        (spec.lora, "lora (LoRA fine-tuning)"),
        (spec.ring_attention,
         f"ring_attention={spec.ring_attention!r} (context parallelism)"),
        (spec.checkpoint.get("dir"), "checkpoint.dir (checkpoints and "
         "auto-resume)"),
        (spec.restart_policy != "Never",
         f"restart_policy={spec.restart_policy!r} (in-process restarts)"),
        (spec.profile or spec.profile_stop_step > spec.profile_start_step,
         "profile windows (profile / profile_start_step / "
         "profile_stop_step)"),
        (spec.eval_every > 0, "eval_every > 0 (the eval stream)"),
        (spec.param_dtype is not None,
         "param_dtype (the fsdp runtime's compute dtype)"),
        (os.environ.get("TPK_FAULT"), "TPK_FAULT (fault injection)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not supported by this "
                                      "package yet")


class Trainer:
    """Single-process trainer on one device (`device` None = CUDA; pass
    "cpu" to run on the CPU)."""

    def __init__(self, spec: TrainJobSpec, device=None):
        self.spec = spec
        _refuse_unported(spec)
        self.device = resolve_device(device)
        if spec.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got "
                             f"{spec.accum_steps}")
        if spec.grad_accum < 0:
            raise ValueError(f"grad_accum must be >= 0, got "
                             f"{spec.grad_accum}")
        if (spec.grad_accum and spec.accum_steps > 1
                and spec.grad_accum != spec.accum_steps):
            raise ValueError(
                f"grad_accum={spec.grad_accum} and its legacy alias "
                f"accum_steps={spec.accum_steps} disagree — set one")
        self.grad_accum = spec.grad_accum or spec.accum_steps
        if spec.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size {spec.batch_size} not divisible by "
                f"grad_accum/accum_steps {self.grad_accum}")
        if spec.eval_every < 0 or spec.eval_batches < 1:
            raise ValueError("eval_every must be >= 0 and eval_batches "
                             ">= 1")
        if spec.backoff_limit < 0:
            raise ValueError(f"backoff_limit must be >= 0, got "
                             f"{spec.backoff_limit}")
        if spec.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {spec.prefetch}")
        if spec.log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {spec.log_every}")
        model_kwargs = dict(spec.model_kwargs)
        # fp32 master weights, as the JAX config's default param_dtype.
        model_kwargs.setdefault("param_dtype", "float32")
        self.model, self.info = registry.build_model(
            spec.model, device=self.device, **model_kwargs)
        self.tx = AdamW(self._lr_schedule(), weight_decay=spec.weight_decay,
                        max_grad_norm=spec.max_grad_norm)
        self.logger = MetricsLogger(spec.metrics_path)

    def _lr_schedule(self) -> Schedule | float:
        spec = self.spec
        peak, warm = spec.learning_rate, spec.warmup_steps
        if spec.lr_schedule == "constant":
            if warm:
                return linear_schedule(0.0, peak, warm)
            return peak
        decay_steps = max(spec.steps - warm, 1)
        if spec.lr_schedule == "cosine":
            return warmup_cosine_decay_schedule(
                0.0, peak, warm, warm + decay_steps, end_value=spec.lr_final)
        if spec.lr_schedule == "linear":
            decay = linear_schedule(peak, spec.lr_final, decay_steps)
            if not warm:
                return decay
            return join_schedules([linear_schedule(0.0, peak, warm), decay],
                                  [warm])
        raise ValueError(
            f"lr_schedule {spec.lr_schedule!r}: constant | cosine | linear")

    def _data(self):
        spec = self.spec
        kwargs = dict(spec.dataset_kwargs)
        kwargs.setdefault("batch_size", spec.batch_size)
        kwargs.setdefault("seq_len", spec.seq_len)
        kwargs.setdefault("vocab_size", self.info["vocab_size"])
        kwargs.setdefault("seed", spec.seed)
        return registry.build_dataset(spec.dataset, **kwargs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> dict:
        spec = self.spec
        state = init_train_state(self.model, self.tx, seed=spec.seed)
        param_bytes = sum(p.numel() * p.element_size() for p in state.params)
        opt_bytes = sum(x.numel() * x.element_size()
                        for x in state.opt_state.mu + state.opt_state.nu)
        self.logger.log(0, {
            "event": "state_sharding", "fsdp": 0,
            "param_bytes_per_chip": param_bytes,
            "opt_state_bytes_per_chip": opt_bytes,
            "grad_accum_steps": self.grad_accum})
        step_fn = make_train_step(self.model, loss_impl=spec.loss_impl,
                                  loss_chunk=spec.loss_chunk,
                                  accum_steps=self.grad_accum)
        timer = StepTimer(num_params=self.info["num_params"],
                          tokens_per_step=spec.batch_size * spec.seq_len,
                          peak=peak_flops_per_chip(self.device))
        prefetch = Prefetcher(self._data(), depth=spec.prefetch,
                              device=self.device)
        # Per-window data-starvation accounting (data_wait_frac ~ 0 when the
        # prefetcher keeps up; -> 1 when input is the bottleneck).
        win = {"t0": 0.0, "wait": 0.0, "h2d": 0.0}

        def win_reset():
            win["t0"] = time.perf_counter()
            win["wait"] = prefetch.data_wait_s
            win["h2d"] = prefetch.h2d_s

        def win_metrics() -> dict:
            wall = time.perf_counter() - win["t0"]
            dw = prefetch.data_wait_s - win["wait"]
            return {
                "data_wait_s": round(dw, 6),
                "data_wait_frac": round(dw / wall, 4) if wall > 0 else 0.0,
                "data_h2d_s": round(prefetch.h2d_s - win["h2d"], 6),
            }

        last_metrics: dict = {}
        try:
            timer.start()
            win_reset()
            window = 0
            # The hot loop touches no device value between log boundaries,
            # so host data prep and kernel launches run ahead of the device.
            for step in range(spec.steps):
                batch = next(prefetch)
                state, metrics = step_fn(state, batch)
                window += 1
                if (step + 1) % spec.log_every == 0 or step + 1 == spec.steps:
                    self._sync()  # the designed per-window boundary
                    perf = timer.stop(n_steps=window)
                    window = 0
                    last_metrics = {
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "tokens_per_sec": perf["tokens_per_sec"],
                        "mfu": perf["mfu"],
                        "step_time_s": perf["step_time_s"],
                        **win_metrics(),
                    }
                    self.logger.log(step + 1, last_metrics)
                    timer.start()
                    win_reset()
            self.logger.log(spec.steps, {"event": "done", **last_metrics})
            return {"final_step": spec.steps, **last_metrics}
        finally:
            prefetch.close()


def main(argv: list[str] | None = None) -> int:
    """`python -m kubeflow_tpu_torch.train.trainer --spec job.json` — the
    worker entry point; --device cpu runs on the CPU."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--spec", required=True,
                        help="path to TrainJobSpec JSON")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    with open(args.spec) as fh:
        spec = TrainJobSpec.from_json(fh.read())
    result = Trainer(spec, device=args.device).run()
    print(json.dumps({"result": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
