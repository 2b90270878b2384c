"""The port's trainer as a restartable job worker, on the CPU (llama_tiny,
fp32, a few steps).

A run interrupted by an injected fault and resumed from its checkpoint
logs the fault-free run's losses exactly (prefetch 0 and 2; a replayed
generator and a seeked packed corpus); the restart policies retry under
their budget; TPK_FAULT kills a worker launched as the controller launches
it, and the relaunch resumes; the eval stream matches the JAX eval step on
converted weights; profile windows write Chrome traces; CheckpointSaved
events reach the control plane's socket one save late; the env contract
and the fault harness agree with the JAX package's copies.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.comms import bootstrap as jbootstrap
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.train import step as jstep
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu.utils import faults as jfaults
from kubeflow_tpu.utils import obs as jobs
from kubeflow_tpu_torch.comms import bootstrap
from kubeflow_tpu_torch.controlplane.client import Client, ControlPlaneError
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.train import step as tstep
from kubeflow_tpu_torch.train import trainer as ttrainer
from kubeflow_tpu_torch.utils import faults, resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for key in [k for k in os.environ if k.startswith("TPK_")]:
        monkeypatch.delenv(key)
    resilience.metrics.reset()
    yield


def _corpus(path, seed=0, n_docs=120):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        doc = rng.integers(1, 512, int(rng.integers(3, 40)), dtype=np.int32)
        doc[-1] = 0
        docs.append(doc)
    np.save(path, np.concatenate(docs))
    return str(path)


def _spec(tmp_path, dataset="learnable_lm", **kw):
    base = dict(model="llama_tiny", model_kwargs={"dtype": "float32",
                                                  "num_layers": 2},
                steps=8, batch_size=4, seq_len=16, log_every=1,
                learning_rate=3e-3, dataset=dataset,
                metrics_path=str(tmp_path / "metrics.jsonl"))
    if dataset == "packed_lm":
        base["dataset_kwargs"] = {"path": _corpus(tmp_path / "c.npy")}
    base.update(kw)
    return ttrainer.TrainJobSpec(**base)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _losses(recs):
    return {r["step"]: r["loss"] for r in recs
            if "loss" in r and "event" not in r}


@pytest.mark.parametrize("dataset", ["learnable_lm", "packed_lm"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_interrupted_run_resumes_with_the_fault_free_losses(
        tmp_path, dataset, prefetch):
    ref_dir, run_dir = tmp_path / "ref", tmp_path / "run"
    ref_dir.mkdir()
    run_dir.mkdir()
    ttrainer.Trainer(_spec(ref_dir, dataset, prefetch=prefetch),
                     device="cpu").run()
    spec = _spec(run_dir, dataset, prefetch=prefetch,
                 checkpoint={"dir": str(run_dir / "ck"), "interval": 3})
    with faults.harness(seed=0) as h:
        h.arm("train.step", faults.FailN(1, match={"step": 5}))
        with pytest.raises(faults.FaultError):
            ttrainer.Trainer(spec, device="cpu").run()
    result = ttrainer.Trainer(spec, device="cpu").run()
    ref = _losses(_records(ref_dir / "metrics.jsonl"))
    recs = _records(run_dir / "metrics.jsonl")
    assert [r["step"] for r in recs if r.get("event") == "restored"] == [3]
    got = {}
    for r in recs:  # the resumed run's lines overwrite the replayed steps
        if "loss" in r and "event" not in r:
            got[r["step"]] = r["loss"]
    assert got == ref
    assert result["loss"] == ref[8] and result["final_step"] == 8
    if dataset == "packed_lm":  # a seekable stream saves its state
        with open(run_dir / "ck" / "8" / "data.json") as fh:
            data = json.load(fh)
        assert data["process_count"] == 1 and data["fsdp"] == 0
        assert set(data["state"]) == {"epoch", "position", "seed"}


@pytest.mark.parametrize("policy", ["OnFailure", "ExponentialBackoff"])
def test_restart_policy_recovers_from_a_step_fault(tmp_path, policy):
    ref = ttrainer.Trainer(_spec(tmp_path / "x", metrics_path=None),
                           device="cpu").run()
    spec = _spec(tmp_path, restart_policy=policy, backoff_limit=2,
                 checkpoint={"dir": str(tmp_path / "ck"), "interval": 2})
    with faults.harness(seed=0) as h:
        h.arm("train.step", faults.FailN(1, match={"step": 5}))
        result = ttrainer.Trainer(spec, device="cpu").run()
    assert result["loss"] == ref["loss"]
    recs = _records(tmp_path / "metrics.jsonl")
    restarting = [r for r in recs if r.get("event") == "restarting"]
    assert len(restarting) == 1 and restarting[0]["attempt"] == 1
    assert "FaultError" in restarting[0]["error"]
    assert [r["step"] for r in recs if r.get("event") == "restored"] == [4]
    assert resilience.metrics.get("tpk_restarts_total",
                                  component="train") == 1


def test_backoff_limit_is_exhausted(tmp_path):
    spec = _spec(tmp_path, restart_policy="OnFailure", backoff_limit=2,
                 steps=3)
    with faults.harness(seed=0) as h:
        h.arm("train.step", faults.FailProb(1.0))
        with pytest.raises(resilience.BackoffLimitExceeded,
                           match="failed 3 times"):
            ttrainer.Trainer(spec, device="cpu").run()
    assert h.counts["train.step"]["injected"] == 3
    assert resilience.metrics.get("tpk_restarts_total",
                                  component="train") == 2
    assert resilience.metrics.get("tpk_retry_exhausted_total",
                                  component="train") == 1
    with pytest.raises(ValueError, match="restart_policy"):
        ttrainer.Trainer(_spec(tmp_path, restart_policy="Always"),
                         device="cpu")


def test_tpk_fault_kills_the_worker_and_the_relaunch_resumes(tmp_path):
    """Two launches as cpp/jaxjob.cc makes them: no --spec, runtime.json in
    TPK_WORKDIR, the TPK_* env; TPK_FAULT only on the first attempt."""
    spec = _spec(tmp_path, "packed_lm", steps=6, metrics_path=None,
                 checkpoint={"dir": str(tmp_path / "ck"), "interval": 2})
    (tmp_path / "runtime.json").write_text(spec.to_json())
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPK_")}
    env.update(TPK_NUM_PROCS="1", TPK_PROC_ID="0", TPK_JOB_NAME="job",
               TPK_WORKDIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.train.trainer",
           "--device", "cpu"]
    first = subprocess.run(cmd, env={**env, "TPK_FAULT": "step=3;signal=9"},
                           cwd=tmp_path, capture_output=True, text=True,
                           timeout=180)
    assert first.returncode == -signal.SIGKILL, first.stderr
    recs = [json.loads(x) for x in first.stdout.splitlines()]
    assert recs[-1] == {"step": 3, "event": "fault_injected", "signal": 9.0}
    again = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                           text=True, timeout=180)
    assert again.returncode == 0, again.stderr
    recs2 = [json.loads(x) for x in again.stdout.splitlines()]
    assert [r["step"] for r in recs2 if r.get("event") == "restored"] == [2]
    assert sorted(_losses(recs2)) == [3, 4, 5, 6]
    assert _losses(recs)[3] == _losses(recs2)[3]
    assert recs2[-1]["result"]["final_step"] == 6


def _jax_and_port_models():
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               attention_impl="flash")
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               param_dtype=torch.float32,
                               attention_impl="flash")
    jm = jl.Llama(jcfg)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jm.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    model = tl.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(params, tcfg))
    return jm, params, model


@pytest.mark.parametrize("masked", [False, True])
def test_eval_step_matches_jax_make_eval_step(masked):
    jm, params, model = _jax_and_port_models()
    rng = np.random.default_rng(3)
    batch = {"inputs": rng.integers(0, 512, (3, 24)).astype(np.int32),
             "targets": rng.integers(0, 512, (3, 24)).astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((3, 24)) > 0.3).astype(np.float32)
    # Plant the argmax on some targets so accuracy is not just 0.
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["inputs"]))
    batch["targets"][:, ::2] = logits.argmax(-1)[:, ::2].numpy()
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    want = jstep.make_eval_step(jm, mesh)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = tstep.make_eval_step(model)(
        None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got["accuracy"]) > 0.3
    for key in ("loss", "accuracy"):
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=1e-5), key


def test_eval_stream_in_the_trainer(tmp_path):
    path = _corpus(tmp_path / "e.npy", seed=4)
    spec = _spec(tmp_path, "packed_lm", eval_every=3, eval_batches=2,
                 eval_dataset="packed_lm",
                 eval_dataset_kwargs={"path": path})
    result = ttrainer.Trainer(spec, device="cpu").run()
    evals = [r for r in _records(tmp_path / "metrics.jsonl")
             if "eval_loss" in r and "event" not in r]
    assert [r["step"] for r in evals] == [3, 6]
    for r in evals:
        assert set(r) == {"step", "eval_loss", "eval_accuracy",
                          "eval_batches"}
        assert np.isfinite(r["eval_loss"]) and r["eval_batches"] == 2
    assert result["eval_loss"] == evals[-1]["eval_loss"]


def test_jsonl_keys_are_the_jax_trainers(tmp_path):
    """Step, eval and done lines carry the JAX trainer's keys under
    TPK_TRACE=0 (no span_* keys)."""
    _jsonl_keys_against_jax(tmp_path, "llama_tiny")


def test_jsonl_keys_are_the_jax_trainers_on_moe(tmp_path):
    """The same on moe_tiny: its step and done lines add aux_loss, as the
    JAX trainer's do."""
    _jsonl_keys_against_jax(tmp_path, "moe_tiny")
    assert all("aux_loss" in r for r in _records(tmp_path / "port.jsonl")
               if "loss" in r)


def _jsonl_keys_against_jax(tmp_path, model):
    kw = dict(model=model, steps=2, batch_size=2, seq_len=8,
              dataset="learnable_lm", log_every=1, eval_every=2,
              eval_batches=1)
    tracer = jobs.get_tracer()
    enabled, tracer.enabled = tracer.enabled, False
    try:
        jtrainer.Trainer(jtrainer.TrainJobSpec(
            metrics_path=str(tmp_path / "jax.jsonl"), **kw)).run()
    finally:
        tracer.enabled = enabled
    ttrainer.Trainer(ttrainer.TrainJobSpec(
        metrics_path=str(tmp_path / "port.jsonl"),
        model_kwargs={"dtype": "float32"}, **kw), device="cpu").run()

    def shapes(path):
        return [(r.get("event"), sorted(r)) for r in _records(path)]

    assert shapes(tmp_path / "port.jsonl") == shapes(tmp_path / "jax.jsonl")


@pytest.mark.parametrize("form", ["dict", "flat"])
def test_profile_window_writes_a_trace(tmp_path, monkeypatch, form):
    if form == "dict":
        kw = {"profile": {"dir": str(tmp_path / "p"), "start_step": 2,
                          "num_steps": 2}}
        where = tmp_path / "p"
    else:
        monkeypatch.setenv("TPK_WORKDIR", str(tmp_path))
        kw = {"profile_start_step": 2, "profile_stop_step": 10}
        where = tmp_path / "profile"
    ttrainer.Trainer(_spec(tmp_path, steps=5, **kw), device="cpu").run()
    name = "trace_steps_2-4.json" if form == "dict" else \
        "trace_steps_2-5.json"  # clamped to the run
    assert os.listdir(where) == [name]
    events = json.load(open(where / name))["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_profile_window_clamps_to_the_resumed_start():
    trainer = ttrainer.Trainer.__new__(ttrainer.Trainer)
    trainer.spec = ttrainer.TrainJobSpec(steps=10, profile={
        "dir": "d", "start_step": 2, "num_steps": 3})
    assert trainer._profile_window(0) == (2, 5, "d")
    assert trainer._profile_window(4) == (4, 7, "d")
    assert trainer._profile_window(10) == (None, None, None)
    trainer.spec = ttrainer.TrainJobSpec(steps=10, profile_start_step=3,
                                         profile_stop_step=3)
    assert trainer._profile_window(0) == (None, None, None)


class _FakeControlPlane:
    """A unix socket answering the newline-JSON protocol: records every
    request, answers ok (or an error for reason "Bad")."""

    def __init__(self, path):
        self.path, self.requests = path, []
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(4)
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                buf = b""
                while True:
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        req = json.loads(line)
                        self.requests.append(req)
                        ok = req.get("reason") != "Bad"
                        conn.sendall(json.dumps(
                            {"ok": ok, "error": "bad"}).encode() + b"\n")

    def close(self):
        self.sock.close()
        self.thread.join(5)


def test_checkpoint_saved_events_reach_the_control_plane(tmp_path,
                                                         monkeypatch):
    server = _FakeControlPlane(str(tmp_path / "cp.sock"))
    monkeypatch.setenv("TPK_SOCKET", server.path)
    monkeypatch.setenv("TPK_JOB_NAME", "job-a")
    try:
        spec = _spec(tmp_path, steps=6,
                     checkpoint={"dir": str(tmp_path / "ck"), "interval": 2})
        ttrainer.Trainer(spec, device="cpu").run()
    finally:
        server.close()
    # Saves at 1 (the directory's first), 2, 4 and the final 6; each event
    # is posted once the next save has started, the last two at the end.
    assert [(r["op"], r["name"], r["reason"], r["message"])
            for r in server.requests] == [
        ("event", "job-a", "CheckpointSaved", f"step {s}")
        for s in (1, 2, 4, 6)]
    assert all(r["trace"] == "job-a" and r["kind"] == "JAXJob"
               for r in server.requests)


def test_events_are_never_fatal_and_client_errors_are_typed(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("TPK_SOCKET", str(tmp_path / "absent.sock"))
    monkeypatch.setenv("TPK_JOB_NAME", "job-b")
    spec = _spec(tmp_path, steps=2,
                 checkpoint={"dir": str(tmp_path / "ck"), "interval": 1})
    assert ttrainer.Trainer(spec, device="cpu").run()["final_step"] == 2
    server = _FakeControlPlane(str(tmp_path / "cp.sock"))
    try:
        client = Client(server.path, timeout=2.0, trace_id="a b/c")
        client.post_event("j", "Fine", "m")
        with pytest.raises(ControlPlaneError, match="bad"):
            client.post_event("j", "Bad")
        client.close()
    finally:
        server.close()
    assert server.requests[0] == {"op": "event", "kind": "JAXJob",
                                  "name": "j", "type": "Normal",
                                  "reason": "Fine", "message": "m",
                                  "trace": "a_b_c"}


def test_more_than_one_process_is_refused_by_name(tmp_path, monkeypatch):
    monkeypatch.setenv("TPK_NUM_PROCS", "2")
    monkeypatch.setenv("TPK_PROC_ID", "0")
    monkeypatch.setenv("TPK_COORDINATOR", "127.0.0.1:1234")
    with pytest.raises(NotImplementedError,
                       match="TPK_NUM_PROCS=2: multi-process training"):
        ttrainer.Trainer(_spec(tmp_path), device="cpu")


@pytest.mark.parametrize("env", [
    {},
    {"TPK_NUM_PROCS": "1", "TPK_PROC_ID": "0"},
    {"TPK_NUM_PROCS": "4", "TPK_PROC_ID": "3", "TPK_COORDINATOR": "h:1",
     "TPK_NUM_SLICES": "2", "TPK_SLICE_ID": "1"},
    {"TPK_NUM_PROCS": "2", "TPK_PROC_ID": "0"},
    {"TPK_NUM_PROCS": "2", "TPK_PROC_ID": "2", "TPK_COORDINATOR": "h:1"},
    {"TPK_NUM_SLICES": "2", "TPK_SLICE_ID": "2"},
], ids=["empty", "one", "four", "no_coordinator", "bad_proc", "bad_slice"])
def test_read_env_agrees_with_jax(env):
    def outcome(mod):
        try:
            return dataclasses.asdict(mod.read_env(env))
        except ValueError as e:
            return str(e)

    assert outcome(bootstrap) == outcome(jbootstrap)


@pytest.mark.parametrize("seed", [0, 7])
def test_the_faults_copy_fires_as_jax_does(seed):
    from kubeflow_tpu_torch.utils import faults as tfaults

    def pattern(mod):
        point = mod.register_point("test.point", "a test point")
        out = []
        with mod.harness(seed=seed) as h:
            h.arm(point, mod.FailProb(0.4))
            h.arm(point, mod.FailN(2, match={"i": 5}))
            h.arm(point, mod.Latency(0.0, match={"i": 7}))
            for i in range(40):
                try:
                    mod.fire(point, i=i)
                    out.append(0)
                except mod.FaultError:
                    out.append(1)
            with pytest.raises(ValueError, match="unknown injection point"):
                h.arm("test.nope", mod.FailN(1))
            with pytest.raises(RuntimeError, match="already installed"):
                with mod.harness():
                    pass
        mod.fire(point, i=0)  # disarmed: a no-op
        return out, h.counts

    assert pattern(tfaults) == pattern(jfaults)
    assert tfaults.active() is None
    with pytest.raises(ValueError, match=r"p must be in \[0, 1\]"):
        tfaults.FailProb(1.5)


def test_main_reads_the_controllers_runtime_json(tmp_path, monkeypatch,
                                                 capsys):
    (tmp_path / "runtime.json").write_text(
        _spec(tmp_path, steps=2).to_json())
    with pytest.raises(SystemExit):
        ttrainer.main(["--device", "cpu"])
    assert "TPK_WORKDIR" in capsys.readouterr().err
    monkeypatch.setenv("TPK_WORKDIR", str(tmp_path))
    assert ttrainer.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["result"]["final_step"] == 2
