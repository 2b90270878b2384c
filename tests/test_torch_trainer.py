"""The port's trainer entry point, data pipeline and metrics on the CPU.

A short llama_tiny run through `main()` (JSONL keys, step count, the done
line), every refusal of an unported spec feature by name, synthetic batches
byte-equal to the JAX package's, and the prefetcher's depth, failure and
close semantics. The shared conftest fails any test that leaks a
`tpk-prefetch` thread.
"""

import json
import threading

import numpy as np
import pytest
import torch

from kubeflow_tpu.data import synthetic as jsynthetic
from kubeflow_tpu_torch.data import synthetic as tsynthetic
from kubeflow_tpu_torch.data.prefetch import THREAD_NAME, Prefetcher
from kubeflow_tpu_torch.train import metrics as tmetrics
from kubeflow_tpu_torch.train import trainer as ttrainer
from kubeflow_tpu_torch.utils import obs, registry

STEP_KEYS = {"step", "loss", "grad_norm", "tokens_per_sec", "mfu",
             "step_time_s", "data_wait_s", "data_wait_frac", "data_h2d_s",
             "tpk_data_wait_seconds_total"}


def _spec(**kw):
    base = dict(model="llama_tiny", model_kwargs={"dtype": "float32"},
                steps=4, batch_size=4, seq_len=16, log_every=2,
                learning_rate=3e-3, dataset="learnable_lm")
    base.update(kw)
    return ttrainer.TrainJobSpec(**base)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_trainer_main_runs_on_cpu(tmp_path, capsys, prefetch):
    path = tmp_path / "job.json"
    metrics = tmp_path / "metrics.jsonl"
    path.write_text(_spec(prefetch=prefetch,
                          metrics_path=str(metrics)).to_json())
    assert ttrainer.main(["--spec", str(path), "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert lines[0]["event"] == "state_sharding"
    steps = [x for x in lines[1:] if "event" not in x]
    assert [x["step"] for x in steps] == [2, 4]
    for line in steps:
        # The span rollups of the JAX trainer's lines, under default
        # tracing (TPK_TRACE unset).
        spans = ({"span_step_ms", "span_fetch_ms"}
                 if obs.get_tracer().enabled else set())
        assert set(line) == STEP_KEYS | spans
        assert np.isfinite(line["loss"]) and line["tokens_per_sec"] > 0
    done = lines[-1]
    assert done["event"] == "done" and done["step"] == 4
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["result"]["final_step"] == 4
    assert not [t for t in threading.enumerate()
                if t.name.startswith(THREAD_NAME)]


def test_trainer_learns_a_learnable_task():
    result = ttrainer.Trainer(_spec(steps=30, log_every=10,
                                    learning_rate=1e-2),
                              device="cpu").run()
    assert result["loss"] < np.log(512) - 0.5


def test_trainer_prefetch_depths_train_identically():
    losses = [ttrainer.Trainer(_spec(prefetch=d), device="cpu").run()["loss"]
              for d in (0, 3)]
    assert losses[0] == losses[1]


@pytest.mark.parametrize("kw,what", [
    ({"mesh": {"data": 2}}, "mesh"),
    ({"strategy": "fsdp"}, "strategy"),
    ({"fsdp": 2}, "fsdp"),
    ({"pipeline": {"microbatches": 2}}, "pipeline"),
    ({"ring_attention": "ring"}, "ring_attention"),
    ({"param_dtype": "bfloat16"}, "param_dtype"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_unported_spec_features_are_refused_by_name(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        ttrainer.Trainer(_spec(**kw), device="cpu")


def test_spec_json_and_validation():
    spec = _spec(accum_steps=2)
    assert ttrainer.TrainJobSpec.from_json(spec.to_json()) == spec
    with pytest.raises(ValueError, match="unknown TrainJobSpec fields"):
        ttrainer.TrainJobSpec.from_json('{"model": "llama_tiny", "x": 1}')
    with pytest.raises(ValueError, match="disagree"):
        ttrainer.Trainer(_spec(accum_steps=2, grad_accum=4), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ttrainer.Trainer(_spec(batch_size=3, accum_steps=2), device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        ttrainer.Trainer(_spec(lr_schedule="step"), device="cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        ttrainer.Trainer(_spec(dataset="no_such_dataset"),
                         device="cpu").run()


@pytest.mark.parametrize("name,kw", [
    ("synthetic_lm", {"batch_size": 3, "seq_len": 17, "vocab_size": 100}),
    ("learnable_lm", {"batch_size": 2, "seq_len": 9, "vocab_size": 31}),
])
def test_synthetic_batches_are_byte_equal_to_jax(name, kw):
    jgen = {"synthetic_lm": jsynthetic.token_batches,
            "learnable_lm": jsynthetic.learnable_token_batches}[name]
    tgen = registry.build_dataset(name, seed=5, process_index=0, **kw)
    want = jgen(kw["batch_size"], kw["seq_len"], kw["vocab_size"], 5)
    for _ in range(3):
        got, ref = next(tgen), next(want)
        for key in ("inputs", "targets"):
            assert got[key].dtype == ref[key].dtype
            assert got[key].tobytes() == ref[key].tobytes()
    with pytest.raises(ValueError, match="sharded_by"):
        next(tsynthetic.token_batches(3, 4, 10, sharded_by=2))


def _numbered(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"bad batch {i}")
        yield {"inputs": np.full((2, 3), i, np.int32)}


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_order_exhaustion_and_counters(depth):
    with Prefetcher(_numbered(5), depth=depth, device="cpu") as pf:
        got = [int(b["inputs"][0, 0]) for b in pf]
        assert got == [0, 1, 2, 3, 4]
        assert pf.data_wait_s >= 0 and pf.h2d_s >= 0
    pf.close()  # idempotent


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_delivers_failures_in_order(depth):
    pf = Prefetcher(_numbered(5, fail_at=2), depth=depth, device="cpu")
    try:
        assert int(next(pf)["inputs"][0, 0]) == 0
        assert int(next(pf)["inputs"][0, 0]) == 1
        with pytest.raises(KeyError, match="bad batch 2"):
            next(pf)
    finally:
        pf.close()
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(_numbered(1), depth=-1, device="cpu")


def test_prefetcher_close_unblocks_a_full_queue():
    def endless():
        while True:
            yield {"inputs": np.zeros((1, 1), np.int32)}

    pf = Prefetcher(endless(), depth=1, device="cpu")
    batch = next(pf)
    assert isinstance(batch["inputs"], torch.Tensor)
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)


def test_metrics_timer_and_logger(tmp_path):
    assert tmetrics.peak_flops_per_chip("cpu") == 1e12
    timer = tmetrics.StepTimer(num_params=1000, tokens_per_step=10,
                               peak=tmetrics.peak_flops_per_chip("cpu"),
                               warmup_steps=1)
    timer.start()
    first = timer.stop()
    assert first["mfu"] >= 0
    timer.start()
    snap = timer.stop(n_steps=2)
    assert snap["tokens_per_sec"] > 0
    assert snap["mfu"] == pytest.approx(
        6 * 1000 * snap["tokens_per_sec"] / timer.peak)
    log = tmetrics.MetricsLogger(str(tmp_path / "m.jsonl"), stream=False)
    log.log(3, {"loss": torch.tensor(1.5), "event": "x"})
    log.close()
    assert json.loads((tmp_path / "m.jsonl").read_text()) == {
        "step": 3, "loss": 1.5, "event": "x"}
