"""Training the MNIST MLP through the port's trainer against the JAX
trainer, fp32 on the CPU, and the trainer's BERT refusal.

`mnist_like` batches byte-equal to the JAX package's; `mnist_mlp` on
`mnist_like` through both trainers from the same initial weights (the JAX
trainer's own, converted): step losses within 1e-5 and the eval stream's
loss and accuracy equal; the classify loss against optax's. BERT is
refused before the first step, naming the reference's missing dataset.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.data import synthetic as jsynthetic
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import mlp as tmlp
from kubeflow_tpu_torch.models.convert import mlp_params_from_jax
from kubeflow_tpu_torch.train import trainer as ttrainer
from kubeflow_tpu_torch.utils import registry

LOSS_TOL = 1e-5


def test_mnist_like_batches_are_byte_equal_to_jax():
    tgen = registry.build_dataset("mnist_like", batch_size=5, seed=3,
                                  seq_len=16, process_index=0)
    want = jsynthetic.mnist_like(5, 3)
    for _ in range(3):
        got, ref = next(tgen), next(want)
        for key in ("inputs", "targets"):
            assert got[key].dtype == ref[key].dtype
            assert got[key].tobytes() == ref[key].tobytes()


def test_classify_loss_is_optax_softmax_cross_entropy():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    targets = rng.integers(0, 10, 6).astype(np.int32)
    want = optax.softmax_cross_entropy(
        logits, jax.nn.one_hot(targets, 10)).mean()
    got = ttrainer.classify_loss(torch.from_numpy(logits),
                                 {"targets": torch.from_numpy(targets)})
    assert abs(float(got) - float(want)) <= 1e-6


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_mnist_mlp_trains_as_the_jax_trainer(tmp_path, monkeypatch):
    """JAX's test point (batch 64, lr 1e-2) for 5 steps, an eval of 2
    batches at step 5: the port's trainer, started from the JAX trainer's
    initial weights, logs the same losses, eval loss and accuracy."""
    kw = dict(model="mnist_mlp", dataset="mnist_like", steps=5,
              batch_size=64, learning_rate=1e-2, log_every=1, eval_every=5,
              eval_batches=2)
    jinit = {}
    real_j = jtrainer.init_train_state

    def capture(*args, **kwargs):
        state = real_j(*args, **kwargs)
        jinit.update(jax.tree.map(np.asarray, state.params))
        return state

    monkeypatch.setattr(jtrainer, "init_train_state", capture)
    jtrainer.Trainer(jtrainer.TrainJobSpec(
        metrics_path=str(tmp_path / "jax.jsonl"), **kw)).run()
    real_t = ttrainer.init_train_state
    cfg = tmlp.MLPConfig()
    monkeypatch.setattr(
        ttrainer, "init_train_state",
        lambda model, tx, seed, trainable: real_t(
            model, tx, params=mlp_params_from_jax(jinit, cfg),
            trainable=trainable))
    result = ttrainer.Trainer(ttrainer.TrainJobSpec(
        metrics_path=str(tmp_path / "port.jsonl"), **kw), device="cpu").run()
    jrecs = _records(tmp_path / "jax.jsonl")
    trecs = _records(tmp_path / "port.jsonl")

    def steps(recs):
        return {r["step"]: r["loss"] for r in recs
                if "loss" in r and "event" not in r}

    want, got = steps(jrecs), steps(trecs)
    assert set(got) == set(want) == set(range(1, 6))
    for step in want:
        assert abs(got[step] - want[step]) <= LOSS_TOL, step
    jeval = [r for r in jrecs if "eval_loss" in r and "event" not in r]
    teval = [r for r in trecs if "eval_loss" in r and "event" not in r]
    assert len(teval) == len(jeval) == 1
    assert abs(teval[0]["eval_loss"] - jeval[0]["eval_loss"]) <= LOSS_TOL
    assert teval[0]["eval_accuracy"] == jeval[0]["eval_accuracy"]
    assert result["eval_accuracy"] == teval[0]["eval_accuracy"]


def test_mnist_mlp_learns_through_main(tmp_path, capsys):
    """`python -m kubeflow_tpu_torch.train.trainer --spec job.json` on
    mnist_mlp: 20 steps at JAX's test point; the loss falls, tokens/s
    counts examples, no aux_loss is logged."""
    path = tmp_path / "job.json"
    path.write_text(ttrainer.TrainJobSpec(
        model="mnist_mlp", dataset="mnist_like", steps=20, batch_size=64,
        learning_rate=1e-2, log_every=10).to_json())
    assert ttrainer.main(["--spec", str(path), "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    steps = [x for x in lines if "loss" in x and "event" not in x]
    assert [x["step"] for x in steps] == [10, 20]
    assert all("aux_loss" not in x and x["tokens_per_sec"] > 0
               for x in steps)
    assert np.isfinite(steps[-1]["loss"]) and steps[-1]["loss"] < np.log(10)


@pytest.mark.parametrize("model", ["bert_tiny", "bert_base"])
def test_bert_training_is_refused_naming_the_missing_dataset(model):
    spec = ttrainer.TrainJobSpec(model=model, steps=1, batch_size=2,
                                 seq_len=8)
    with pytest.raises(ValueError, match="no dataset that trains BERT's "
                       "classify head"):
        ttrainer.Trainer(spec, device="cpu")
