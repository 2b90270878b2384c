"""The training runtime: what a JAXJob worker process runs.

The port of `kubeflow_tpu/train/trainer.py` for one process on one device:
a `TrainJobSpec` (the JAX package's field names and JSON) drives model and
dataset registries, the prefetching input pipeline, the eager train step
(flash attention forward and backward through the CUDA kernels on a GPU)
and the JSONL metrics stream with tokens/s and MFU; checkpoints with
auto-resume of the state and the data stream, the restart policies, the
eval stream, profiler windows and `TPK_FAULT` make it a restartable job
worker. `"lora": {"rank", "alpha", "targets"}` fine-tunes LoRA adapters on
a frozen base (adapter-only gradients and optimizer state); the trainer
never merges them (`train.lora.merge` does, for serving). It trains every
family the JAX trainer trains on one device: the Llama family, the
mixture-of-experts models (the Switch load-balance loss added to the loss
and logged as `aux_loss`) and the MLP on `mnist_like` (the classify loss).

    python -m kubeflow_tpu_torch.train.trainer [--spec job.json] [--device cpu]

Under the control plane (a JAXJob whose `command` is `["python3", "-m",
"kubeflow_tpu_torch.train.trainer"]`) the spec defaults to
`$TPK_WORKDIR/runtime.json`, the file the controller writes.

The loop blocks on the device only at log, eval, profile-close and save
boundaries. Features of the JAX runtime that the port does not have yet
are refused by name with NotImplementedError, never ignored: a device
mesh or a non-default sharding strategy, FSDP, pipeline parallelism,
ring attention, the fsdp compute dtype (`param_dtype`) and more than one
process (`TPK_NUM_PROCS` > 1). BERT is refused with a ValueError: the
reference trainer has no dataset that trains its classify head.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from kubeflow_tpu_torch.comms.bootstrap import initialize, read_env
from kubeflow_tpu_torch.controlplane.client import Client
from kubeflow_tpu_torch.data.loader import restore_iterator
from kubeflow_tpu_torch.data.prefetch import Prefetcher
from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.gpt2 import GPT2Config
from kubeflow_tpu_torch.models.llama import LORA_TARGETS, LlamaConfig
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from kubeflow_tpu_torch.train.metrics import (MetricsLogger, StepTimer,
                                              peak_flops_per_chip)
from kubeflow_tpu_torch.train.optim import (AdamW, Schedule,
                                            join_schedules, linear_schedule,
                                            warmup_cosine_decay_schedule)
from kubeflow_tpu_torch.train.step import (FSDP_WITH_LORA, init_train_state,
                                           make_eval_step, make_train_step)
from kubeflow_tpu_torch.utils import faults, registry, resilience
from kubeflow_tpu_torch.utils.devices import resolve_device

_LOG = logging.getLogger(__name__)

#: Fires at the top of every training step (ctx: step): arming FailN with
#: match={"step": K} is the in-process analog of TPK_FAULT's kill.
_FP_STEP = faults.register_point(
    "train.step", "top of each training step; ctx: step")


@dataclasses.dataclass
class TrainJobSpec:
    """Declarative training job, field for field the JAX package's (see
    `kubeflow_tpu/train/trainer.py` for each field's meaning). Fields of
    features the port does not have are kept so a JAX job spec parses;
    the Trainer refuses them when set. `checkpoint` is {"dir", "interval"
    (50), "keep" (3), "async_save" (true)}; `profile` is {"dir",
    "start_step", "num_steps" (3)}; `lora` is {"rank", "alpha" (16),
    "targets" ("attn" | "attn_mlp")}."""

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
        (spec.ring_attention,
         f"ring_attention={spec.ring_attention!r} (context parallelism)"),
        (spec.param_dtype is not None,
         "param_dtype (the fsdp runtime's compute dtype)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not supported by this "
                                      "package yet")


def _lora_model_kwargs(spec: TrainJobSpec) -> dict:
    """The model kwargs `spec.lora` injects, after the JAX trainer's
    checks (with its messages); {} without LoRA."""
    if not spec.lora:
        return {}
    unknown = set(spec.lora) - {"rank", "alpha", "targets"}
    if unknown:
        raise ValueError(f"unknown spec.lora keys {sorted(unknown)}; valid: "
                         "rank, alpha, targets")
    rank = int(spec.lora.get("rank", 0))
    if rank < 1:
        raise ValueError(f"lora.rank must be >= 1, got {rank}")
    targets = spec.lora.get("targets", "attn")
    if targets not in LORA_TARGETS:
        raise ValueError(f"lora.targets {targets!r}: attn | attn_mlp")
    if spec.pipeline:
        raise ValueError("LoRA doesn't compose with pipeline parallelism "
                         "(the stage forward has no adapter path)")
    if spec.fsdp:
        raise ValueError(FSDP_WITH_LORA)
    return {"lora_rank": rank,
            "lora_alpha": float(spec.lora.get("alpha", 16.0)),
            "lora_targets": targets}


#: JAX's refusal of FFN adapters on routed experts
#: (`kubeflow_tpu/train/trainer.py`).
MOE_LORA_REFUSAL = ("lora.targets='attn_mlp' is not supported on MoE "
                    "models (expert FFNs have no adapter path); use "
                    "targets='attn'")


def classify_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The JAX trainer's classify loss: softmax cross entropy on one-hot
    targets (optax's arithmetic: log-softmax in the logits' dtype, the
    fp32 one-hot product summed), the batch mean."""
    onehot = torch.nn.functional.one_hot(batch["targets"].long(),
                                         logits.shape[-1]).float()
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def _parse_fault(text: str) -> tuple[int | None, int]:
    """TPK_FAULT="step=K;signal=S" -> (K, S); (None, 9) when unset."""
    if not text:
        return None, 9
    kv = dict(part.split("=", 1) for part in text.split(";") if "=" in part)
    return int(kv.get("step", -1)), int(kv.get("signal", 9))


class Trainer:
    """Single-process trainer on one device (`device` None = CUDA; pass
    "cpu" to run on the CPU); the process env is read from TPK_*."""

    def __init__(self, spec: TrainJobSpec, device=None):
        self.spec = spec
        self.penv = initialize(read_env())
        lora_kwargs = _lora_model_kwargs(spec)
        self.trainable = "lora" if lora_kwargs else None
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
        if spec.restart_policy not in ("Never", "OnFailure",
                                       "ExponentialBackoff"):
            raise ValueError(
                f"restart_policy {spec.restart_policy!r}: Never | "
                "OnFailure | ExponentialBackoff")
        if spec.backoff_limit < 0:
            raise ValueError(f"backoff_limit must be >= 0, got "
                             f"{spec.backoff_limit}")
        if spec.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {spec.prefetch}")
        if spec.log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {spec.log_every}")
        if spec.profile_start_step < 0 or spec.profile_stop_step < 0:
            raise ValueError(
                "profile_start_step/profile_stop_step must be >= 0, got "
                f"{spec.profile_start_step}/{spec.profile_stop_step}")
        mcfg = registry.model_config(spec.model)
        if isinstance(mcfg, BertConfig):
            raise ValueError(
                f"training {spec.model!r} is refused: the reference trainer "
                "has no dataset that trains BERT's classify head (its "
                "classify loss takes [B] labels, and every registered "
                "dataset gives [B, S] token targets)")
        if isinstance(mcfg, GPT2Config):
            raise ValueError(
                f"training {spec.model!r} is refused: GPT-2 training is not "
                "ported yet (ROADMAP A8.1a); the port serves GPT-2")
        if lora_kwargs and not isinstance(mcfg, LlamaConfig):
            raise ValueError(f"spec.lora needs a Llama-family model; "
                             f"{spec.model!r} has no adapter path")
        if (lora_kwargs.get("lora_targets") == "attn_mlp"
                and hasattr(mcfg, "num_experts")):
            raise ValueError(MOE_LORA_REFUSAL)
        model_kwargs = {**spec.model_kwargs, **lora_kwargs}
        if any(f.name == "param_dtype" for f in dataclasses.fields(mcfg)):
            # fp32 master weights, as the JAX config's default param_dtype.
            model_kwargs.setdefault("param_dtype", "float32")
        self.model, self.info = registry.build_model(
            spec.model, device=self.device, **model_kwargs)
        self.lm = self.info["task"] == "lm"
        self.tx = AdamW(self._lr_schedule(), weight_decay=spec.weight_decay,
                        max_grad_norm=spec.max_grad_norm)
        self._event_client: Client | None = None
        self._ckpt = None
        if spec.checkpoint.get("dir"):
            self._ckpt = CheckpointManager(
                spec.checkpoint["dir"],
                interval=spec.checkpoint.get("interval", 50),
                keep=spec.checkpoint.get("keep", 3),
                async_save=spec.checkpoint.get("async_save", True))
        self.logger = MetricsLogger(spec.metrics_path)

    def _post_event(self, reason: str, message: str = "") -> None:
        """Best-effort event into the job's control-plane event log: only
        when launched by the control plane (TPK_SOCKET and TPK_JOB_NAME
        set), only from process 0, and never fatal."""
        sock = os.environ.get("TPK_SOCKET")
        job = os.environ.get("TPK_JOB_NAME")
        if not sock or not job or self.penv.process_id != 0:
            return
        try:
            if self._event_client is None:
                self._event_client = Client(sock, timeout=2.0, trace_id=job)
            self._event_client.post_event(job, reason, message)
        except Exception:
            _LOG.warning("could not post %s to the control plane at %s",
                         reason, sock, exc_info=True)
            if self._event_client is not None:
                self._event_client.close()
                self._event_client = None  # reconnect on the next event

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

    # -- data ---------------------------------------------------------------

    def _make_stream(self, name: str, kwargs: dict, seed_base: int):
        """A dataset with the model-derived defaults and this process's
        shard of the rows."""
        kwargs = dict(kwargs)
        kwargs.setdefault("batch_size", self.spec.batch_size)
        if self.lm:
            kwargs.setdefault("seq_len", self.spec.seq_len)
            kwargs.setdefault("vocab_size", self.info["vocab_size"])
        kwargs.setdefault("seed", seed_base + 7919 * self.penv.process_id)
        kwargs.setdefault("process_index", self.penv.process_id)
        kwargs.setdefault("process_count", self.penv.num_processes)
        return registry.build_dataset(name, **kwargs)

    def _data(self):
        return self._make_stream(self.spec.dataset,
                                 self.spec.dataset_kwargs, self.spec.seed)

    def _eval_data(self):
        """Validation stream. Defaults to the train dataset family,
        including its kwargs (a corpus path carries over), with a disjoint
        seed."""
        if self.spec.eval_dataset:
            name = self.spec.eval_dataset
            kwargs = self.spec.eval_dataset_kwargs
        else:
            name = self.spec.dataset
            kwargs = {**self.spec.dataset_kwargs,
                      **self.spec.eval_dataset_kwargs}
        return self._make_stream(name, kwargs, self.spec.seed + 104729)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- run ----------------------------------------------------------------

    def run(self) -> dict:
        """Supervised entry point: the training loop under the spec's
        restart policy. Every restart resumes through `_run_once`'s
        checkpoint auto-resume (the latest good state and the saved
        data-iterator position)."""
        spec = self.spec
        backoff = resilience.BackoffPolicy(initial_s=0.05, max_s=10.0)
        restarts = 0
        while True:
            try:
                return self._run_once()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if self._ckpt is not None:
                    # A save may be in flight; a restart (or the next
                    # manager on this directory) must not race it. Its own
                    # failure would only hide the original error.
                    try:
                        self._ckpt.wait()
                    except Exception:
                        _LOG.warning("checkpoint save failed", exc_info=True)
                if spec.restart_policy == "Never":
                    raise
                restarts += 1
                if restarts > spec.backoff_limit:
                    resilience.metrics.inc("tpk_retry_exhausted_total",
                                           component="train")
                    raise resilience.BackoffLimitExceeded(
                        f"training failed {restarts} times "
                        f"(backoff_limit={spec.backoff_limit}, "
                        f"restart_policy={spec.restart_policy}): "
                        f"{type(e).__name__}: {e}") from e
                resilience.metrics.inc("tpk_restarts_total",
                                       component="train")
                delay = (backoff.delay(restarts - 1)
                         if spec.restart_policy == "ExponentialBackoff"
                         else 0.0)
                self.logger.log(0, {
                    "event": "restarting", "attempt": restarts,
                    "backoff_s": round(delay, 3),
                    "error": f"{type(e).__name__}: {e}"})
                if delay:
                    time.sleep(delay)

    def _profile_window(self, start_step: int) -> tuple:
        """(start, stop, dir) of the profiler window, clamped to the run;
        (None, None, None) when there is none. The dict form (dir,
        start_step, num_steps) wins over the flat profile_start_step /
        profile_stop_step, whose directory defaults to
        $TPK_WORKDIR/profile, else beside metrics_path."""
        spec = self.spec
        prof = spec.profile
        prof_dir = prof.get("dir")
        if prof_dir and prof.get("start_step") is not None:
            start = max(int(prof["start_step"]), start_step)
            stop = min(start + int(prof.get("num_steps", 3)), spec.steps)
            if start < spec.steps:
                return start, stop, prof_dir
        elif spec.profile_stop_step > spec.profile_start_step:
            base = (os.environ.get("TPK_WORKDIR")
                    or (os.path.dirname(spec.metrics_path)
                        if spec.metrics_path else "")
                    or ".")
            prof_dir = prof_dir or os.path.join(base, "profile")
            start = max(spec.profile_start_step, start_step)
            stop = min(spec.profile_stop_step, spec.steps)
            if start < stop:
                return start, stop, prof_dir
        return None, None, None

    def _to_device(self, raw: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in raw.items()}

    def _run_once(self) -> dict:
        spec = self.spec
        state = init_train_state(self.model, self.tx, seed=spec.seed,
                                 trainable=self.trainable)
        start_step = 0
        if self._ckpt is not None:
            # A torn latest step (SIGKILL mid-save) is quarantined and the
            # next-newest good one restored.
            state, latest, quarantined = self._ckpt.restore_latest_good(state)
            for bad in quarantined:
                self.logger.log(int(bad), {
                    "event": "checkpoint_quarantined", "step": int(bad)})
            if latest is not None:
                start_step = int(latest)
                self.logger.log(start_step, {"event": "restored"})

        param_bytes = sum(p.numel() * p.element_size() for p in state.params)
        opt_bytes = sum(x.numel() * x.element_size()
                        for x in state.opt_state.mu + state.opt_state.nu)
        self.logger.log(start_step, {
            "event": "state_sharding", "fsdp": 0,
            "param_bytes_per_chip": param_bytes,
            "opt_state_bytes_per_chip": opt_bytes,
            "grad_accum_steps": self.grad_accum})
        step_fn = make_train_step(self.model,
                                  loss_fn=None if self.lm else classify_loss,
                                  loss_impl=spec.loss_impl,
                                  loss_chunk=spec.loss_chunk,
                                  accum_steps=self.grad_accum,
                                  trainable=self.trainable)
        eval_step = make_eval_step(self.model) if spec.eval_every else None
        # One persistent eval stream for the whole run (file-backed
        # corpora pay their packing in the constructor), rebuilt only when
        # exhausted.
        eval_iter_box: list = [None]

        def next_eval_batch():
            for _ in range(2):
                if eval_iter_box[0] is None:
                    eval_iter_box[0] = iter(self._eval_data())
                try:
                    return next(eval_iter_box[0])
                except StopIteration:
                    eval_iter_box[0] = None  # exhausted: fresh pass
            return None

        def run_eval(at_step: int) -> dict:
            # Device sums, fetched once per eval window.
            loss_sum = acc_sum = None
            seen = 0
            for _ in range(spec.eval_batches):
                raw = next_eval_batch()
                if raw is None:
                    break
                m = eval_step(state.params, self._to_device(raw))
                loss_sum = (m["loss"] if loss_sum is None
                            else loss_sum + m["loss"])
                acc_sum = (m["accuracy"] if acc_sum is None
                           else acc_sum + m["accuracy"])
                seen += 1
            if not seen:
                return {}
            totals = torch.stack([loss_sum, acc_sum]).tolist()  # 1 fetch
            out = {"eval_loss": totals[0] / seen,
                   "eval_accuracy": totals[1] / seen,
                   "eval_batches": seen}
            self.logger.log(at_step, out)
            return out

        # MFU counts every parameter, an MoE model's idle experts too, as
        # JAX's StepTimer does.
        timer = StepTimer(num_params=self.info["num_params"] or 0,
                          tokens_per_step=spec.batch_size * (
                              spec.seq_len if self.lm else 1),
                          peak=peak_flops_per_chip(self.device))
        prof_start, prof_stop, prof_dir = self._profile_window(start_step)
        profiler = None

        def pack_data_state():
            # The state paired with the batch the saved step trained on,
            # not the prefetcher's read-ahead; tagged with the world size
            # it is valid for.
            st = prefetch.consumed_state()
            if st is None:
                return None
            return {"process_count": self.penv.num_processes, "state": st,
                    "fsdp": spec.fsdp}

        data = iter(self._data())
        if start_step:
            saved = self._ckpt.restore_data_state()
            if saved is None:
                # Plain generators: replay the consumed batches.
                for _ in range(start_step):
                    next(data)
            elif isinstance(saved, dict) and "process_count" in saved:
                if saved["process_count"] == self.penv.num_processes:
                    restore_iterator(data, saved.get("state"))
                else:
                    # Another world size: the per-process shards changed,
                    # so the stream restarts.
                    self.logger.log(start_step, {
                        "event": "data_stream_restarted",
                        "reason": "world size changed"})
            else:
                restore_iterator(data, saved)

        # TPK_FAULT="step=K;signal=S" (set by the controller on one worker):
        # the worker kills itself at the top of step K.
        fault_step, fault_signal = _parse_fault(
            os.environ.get("TPK_FAULT", ""))
        # Created after the seek above, so read-ahead starts at the resume
        # position.
        prefetch = Prefetcher(data, depth=spec.prefetch, device=self.device)
        last_metrics: dict = {}
        last_eval: dict = {}
        # CheckpointSaved events are deferred one save boundary: a save in
        # flight is announced only once the next one has started (which
        # waits for it) or after the final wait().
        ckpt_event_pending: int | None = None
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
                "tpk_data_wait_seconds_total": round(
                    resilience.metrics.get("tpk_data_wait_seconds_total",
                                           component="train"), 6),
            }

        try:
            timer.start()
            win_reset()
            window = 0
            # The hot loop touches no device value between the log, eval,
            # profile-close and save boundaries, so host data prep and
            # kernel launches run ahead of the device.
            for step in range(start_step, spec.steps):
                faults.fire(_FP_STEP, step=step)
                if fault_step is not None and step == fault_step:
                    if self._ckpt is not None:
                        self._ckpt.wait()  # die with a consistent checkpoint
                    self.logger.log(step, {"event": "fault_injected",
                                           "signal": fault_signal})
                    os.kill(os.getpid(), fault_signal)
                if step == prof_start:
                    profiler = _start_profiler(self.device)
                batch = next(prefetch)
                state, metrics = step_fn(state, batch)
                window += 1
                if profiler is not None and step + 1 == prof_stop:
                    self._sync()  # drain, or the trace loses its tail
                    _stop_profiler(profiler, prof_dir, prof_start, prof_stop)
                    profiler = None
                if self._ckpt is not None:
                    # Iterator state only on the steps that save.
                    if self._ckpt.should_save(step + 1):
                        self._ckpt.maybe_save(step + 1, state,
                                              data_state=pack_data_state())
                        if ckpt_event_pending is not None:
                            self._post_event("CheckpointSaved",
                                             f"step {ckpt_event_pending}")
                        ckpt_event_pending = step + 1
                    else:
                        self._ckpt.maybe_save(step + 1, state)
                if eval_step is not None and (step + 1) % spec.eval_every == 0:
                    # Close the timing window first, so eval time never
                    # enters tokens/s and MFU.
                    if window:
                        self._sync()
                        timer.stop(n_steps=window)
                        window = 0
                    last_eval = run_eval(step + 1)
                    timer.start()
                    win_reset()
                if ((step + 1) % spec.log_every == 0
                        or step + 1 == spec.steps):
                    self._sync()  # the designed per-window boundary
                    if window:
                        perf = timer.stop(n_steps=window)
                        window = 0
                    else:  # an eval just closed this window
                        perf = timer.snapshot()
                    last_metrics = {
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "tokens_per_sec": perf["tokens_per_sec"],
                        "mfu": perf["mfu"],
                        "step_time_s": perf["step_time_s"],
                        **win_metrics(),
                    }
                    # MoE models report the router balance penalty too.
                    aux = float(metrics["aux_loss"])
                    if aux > 0:
                        last_metrics["aux_loss"] = aux
                    self.logger.log(step + 1, last_metrics)
                    timer.start()
                    win_reset()

            if self._ckpt is not None:
                if self._ckpt.latest_step() != spec.steps:
                    self._ckpt.maybe_save(spec.steps, state,
                                          data_state=pack_data_state(),
                                          force=True)
                self._ckpt.wait()
                # Everything is durable now: flush the deferred interior
                # event, then the final step's.
                if (ckpt_event_pending is not None
                        and ckpt_event_pending != self._ckpt.latest_step()):
                    self._post_event("CheckpointSaved",
                                     f"step {ckpt_event_pending}")
                self._post_event("CheckpointSaved",
                                 f"step {self._ckpt.latest_step()}")
            self.logger.log(spec.steps,
                            {"event": "done", **last_metrics, **last_eval})
            return {"final_step": spec.steps, **last_metrics, **last_eval}
        finally:
            # Every exit path (completion, a raising step, an interrupt)
            # closes the input worker and an open profiler window.
            prefetch.close()
            if profiler is not None:
                profiler.stop()


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, prof_dir: str, start: int, stop: int) -> str:
    """Close the window and write its Chrome trace; returns the path."""
    profiler.stop()
    os.makedirs(prof_dir, exist_ok=True)
    path = os.path.join(prof_dir, f"trace_steps_{start}-{stop}.json")
    profiler.export_chrome_trace(path)
    return path


def main(argv: list[str] | None = None) -> int:
    """`python -m kubeflow_tpu_torch.train.trainer [--spec job.json]` — the
    worker entry point. The spec defaults to $TPK_WORKDIR/runtime.json
    (the controller's); --device cpu runs on the CPU."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--spec", default=None,
                        help="path to TrainJobSpec JSON (default: "
                        "$TPK_WORKDIR/runtime.json)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    path = args.spec
    if path is None:
        workdir = os.environ.get("TPK_WORKDIR")
        if not workdir:
            parser.error("--spec is required when TPK_WORKDIR is not set")
        path = os.path.join(workdir, "runtime.json")
    with open(path) as fh:
        spec = TrainJobSpec.from_json(fh.read())
    result = Trainer(spec, device=args.device).run()
    print(json.dumps({"result": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
