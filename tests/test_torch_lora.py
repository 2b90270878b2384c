"""LoRA fine-tuning on the port against the JAX package (fp32, CPU).

The adapters' forward, the adapter-only train step, the optimizer state
over the adapters, the merge and the trainer's `spec.lora`, each held
against its JAX twin on the same weights. B is drawn non-zero wherever
parity is checked (the zero init would make the adapters' forward vacuous).
Tolerances: logits 2e-4 as tests/test_torch_llama.py (fp32 matmuls summed
in another order); losses 1e-5 and grad norms 1e-4 relative as
tests/test_torch_train_step.py; merged weights 1e-6 (fp32 rounding of W +
s·B·A).
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.parallel.sharding import DEFAULT_RULES
from kubeflow_tpu.train import lora as jlora
from kubeflow_tpu.train import step as jstep
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.train import checkpoint as tckpt
from kubeflow_tpu_torch.train import lora as tlora
from kubeflow_tpu_torch.train import optim
from kubeflow_tpu_torch.train import step as tstep
from kubeflow_tpu_torch.train import trainer as ttrainer
from kubeflow_tpu_torch.utils import faults, registry, resilience

TOL = dict(atol=2e-4, rtol=2e-4)
LR = 1e-3
RANK = 4


def _cfgs(targets="attn_mlp", impl="naive", **kw):
    common = dict(num_layers=2, attention_impl=impl, lora_rank=RANK,
                  lora_alpha=8.0, lora_targets=targets, **kw)
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               param_dtype=jnp.float32, **common)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               param_dtype=torch.float32, **common)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    """The JAX model's init (numpy leaves) with every B drawn N(0, 0.05)."""
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(jm.init(jax.random.key(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for path, leaf in _flat(params).items():
        if path[-1].endswith("_lora_b"):
            _set(params, path, rng.normal(0, 0.05, leaf.shape).astype(
                np.float32))
    return jm, params


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _port(tcfg, params):
    model = tl.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(params, tcfg))
    return model


def _batch(b=4, s=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, 512, (b, s)).astype(np.int32),
            "targets": rng.integers(0, 512, (b, s)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- (a) the adapters' forward --------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("targets", ["attn", "attn_mlp"])
def test_lora_logits_match_jax(targets, impl):
    jcfg, tcfg = _cfgs(targets, impl)
    jm, params = _jax_params(jcfg)
    model = _port(tcfg, params)
    n_adapters = 2 * (2 if targets == "attn" else 5) * tcfg.num_layers
    assert len(tlora.partition(model)[0]) == n_adapters
    toks = _batch(b=2, s=12)["inputs"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # The adapters matter at this tolerance: the base alone is far off.
    base = tl.Llama(dataclasses.replace(tcfg, lora_rank=0), device="cpu")
    base.load_state_dict(tlora.partition(model)[1])
    with torch.no_grad():
        plain = base(torch.from_numpy(toks)).numpy()
    assert np.abs(plain - want).max() > 100 * TOL["atol"]


def test_zero_b_starts_at_the_base_model():
    _, tcfg = _cfgs()
    model = tl.Llama(tcfg, device="cpu").init_weights(3)
    train, frozen = tlora.partition(model)
    assert all(not p.any() for n, p in train.items() if n.endswith("_b"))
    assert all(p.std() > 0.01 for n, p in train.items() if n.endswith("_a"))
    base = tl.Llama(dataclasses.replace(tcfg, lora_rank=0), device="cpu")
    base.load_state_dict(frozen)
    toks = torch.from_numpy(_batch()["inputs"])
    with torch.no_grad():
        assert torch.equal(model(toks), base(toks))


def test_lora_on_int8_projections_is_refused():
    _, tcfg = _cfgs()
    from kubeflow_tpu_torch.serve.quant import quantize_model

    # Ported since (tests/test_torch_lora_int8.py holds it against JAX):
    # quantizing keeps the adapters float beside the int8 projections.
    model = tl.Llama(tcfg, device="cpu").init_weights(0)
    a = model.layers[0].attn.q_proj_lora_a.detach().clone()
    quantize_model(model, min_size=1)
    assert model.cfg.quantized_dense and model.cfg.lora_rank == tcfg.lora_rank
    assert type(model.layers[0].attn.q_proj).__name__ == "Int8Dense"
    assert torch.equal(model.layers[0].attn.q_proj_lora_a, a)
    with pytest.raises(ValueError, match="lora_targets"):
        tl.Llama(dataclasses.replace(tcfg, lora_targets="all"), device="cpu")


# -- (b) the adapter-only train step ---------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_lora_steps_match_jax(accum):
    """Three steps of JAX make_train_step(trainable="lora") on a one-device
    mesh and of the port's: losses, grad norms (the adapters') and the
    adapters after each step (Adam moves an element ~lr a step, so they are
    compared in units of lr, as tests/test_torch_train_step.py does: within
    5% of a step), and the port's frozen base bit-unchanged."""
    jcfg, tcfg = _cfgs()
    jm, params = _jax_params(jcfg)
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    tx = optax.adamw(LR)
    jparams = jax.tree.map(jnp.asarray, params)
    train_sub, _ = jlora.partition(dict(jparams))
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                              opt_state=tx.init(train_sub), tx=tx)
    jfn = jstep.make_train_step(jm, mesh, DEFAULT_RULES, trainable="lora",
                                accum_steps=accum)
    model = _port(tcfg, params)
    state = tstep.init_train_state(model, optim.AdamW(LR),
                                   params=model.state_dict(),
                                   trainable="lora")
    fn = tstep.make_train_step(model, accum_steps=accum, trainable="lora")
    base = {n: p.clone() for n, p in tlora.partition(model)[1].items()}
    for i in range(3):
        batch = _batch(seed=10 + i)
        jstate, jmet = jfn(jstate, batch)
        state, met = fn(state, _tbatch(batch))
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-5, i
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4), i
        assert met["step"] == int(jmet["step"]) == i + 1
        want = llama_params_from_jax(jax.tree.map(np.asarray,
                                                  jstate.params), tcfg)
        train = tlora.partition(model)[0]
        moved = np.concatenate([
            (np.abs(p.detach().numpy() - want[n].numpy()) / LR).ravel()
            for n, p in train.items()])
        assert np.mean(moved > 1e-2) < 1e-3, (i, np.mean(moved > 1e-2))
        assert moved.max() <= 0.05, (i, moved.max())
    for n, p in tlora.partition(model)[1].items():
        assert torch.equal(p, base[n]), n
        assert not p.requires_grad and p.grad is None


def test_lora_step_needs_a_lora_state():
    _, tcfg = _cfgs()
    model = tl.Llama(tcfg, device="cpu")
    full = tstep.init_train_state(model, optim.AdamW(LR), seed=0)
    fn = tstep.make_train_step(model, trainable="lora")
    with pytest.raises(ValueError, match="trainable"):
        fn(full, _tbatch(_batch()))
    with pytest.raises(ValueError, match="no \\*_lora_\\* parameters"):
        tstep.make_train_step(
            tl.Llama(dataclasses.replace(tcfg, lora_rank=0), device="cpu"),
            trainable="lora")
    with pytest.raises(ValueError, match="fsdp"):
        tstep.make_train_step(model, trainable="lora", fsdp=object())
    with pytest.raises(ValueError, match="trainable"):
        tstep.init_train_state(model, optim.AdamW(LR), trainable="all")


# -- (c) no weight gradient for the frozen base ----------------------------


class _WeightGradMatmuls(TorchDispatchMode):
    """Counts mm/addmm whose output has a frozen weight's shape (or its
    transpose): the weight-gradient products of the base."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.count = shapes, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.count += tuple(out.shape) in self.shapes
        return out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("lora_on", [True, False], ids=["lora", "full"])
def test_frozen_base_gets_no_weight_gradient(lora_on, remat):
    """48 rows (B 2 × S 24): no activation product has a weight's shape in
    llama_tiny, so every count is a weight gradient. With LoRA off (the
    red switch) the same count is one per projection and the head."""
    _, tcfg = _cfgs(remat=remat)
    if not lora_on:
        tcfg = dataclasses.replace(tcfg, lora_rank=0)
    model = tl.Llama(tcfg, device="cpu")
    trainable = "lora" if lora_on else None
    state = tstep.init_train_state(model, optim.AdamW(LR), seed=0,
                                   trainable=trainable)
    frozen = (tlora.partition(model)[1] if lora_on
              else dict(model.named_parameters()))
    shapes = set()
    for p in frozen.values():
        if p.dim() == 2:
            shapes |= {tuple(p.shape), tuple(p.shape)[::-1]}
    assert 48 not in {s for shape in shapes for s in shape}
    fn = tstep.make_train_step(model, trainable=trainable)
    batch = _tbatch(_batch(b=2, s=24))
    with _WeightGradMatmuls(shapes) as mode:
        fn(state, batch)
    if lora_on:
        assert mode.count == 0
        # .backward() too: the frozen base never gets a .grad.
        loss = tstep.cross_entropy_loss(model(batch["inputs"]),
                                        batch["targets"])
        loss.backward()
        train, base = tlora.partition(model)
        assert all(p.grad is None for p in base.values())
        assert all(p.grad is not None for p in train.values())
    else:
        assert mode.count == 7 * tcfg.num_layers + 1  # + the lm_head


# -- (d) the optimizer state covers the adapters only ----------------------


@pytest.mark.parametrize("targets", ["attn", "attn_mlp"])
def test_optimizer_state_covers_only_adapters(targets):
    _, tcfg = _cfgs(targets)
    model = tl.Llama(tcfg, device="cpu")
    state = tstep.init_train_state(model, optim.AdamW(LR), seed=0,
                                   trainable="lora")
    train, frozen = tlora.partition(model)
    assert len(train) == 2 * (2 if targets == "attn" else 5) * 2
    moments = state.opt_state.mu + state.opt_state.nu
    assert len(moments) == 2 * len(train)
    assert [tuple(m.shape) for m in state.opt_state.mu] == [
        tuple(p.shape) for p in train.values()]
    assert (sum(m.numel() for m in moments)
            < sum(p.numel() for p in frozen.values()) / 10)
    assert list(state.train_named) == list(train)
    whole = tlora.combine(train, frozen)
    assert whole.keys() == dict(model.named_parameters()).keys()
    assert all(whole[n] is p for n, p in model.named_parameters())


# -- (e) merge --------------------------------------------------------------


def test_merge_matches_jax_and_reproduces_the_adapted_logits():
    jcfg, tcfg = _cfgs()
    _, params = _jax_params(jcfg)
    base_cfg = dataclasses.replace(tcfg, lora_rank=0)
    want = llama_params_from_jax(
        jax.tree.map(np.asarray, jlora.merge(params, jcfg)), base_cfg)
    model = _port(tcfg, params)
    got = tlora.merge(model, tcfg)
    assert set(got) == set(want) == set(
        tl.Llama(base_cfg, device="cpu").state_dict())
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, atol=1e-6, rtol=1e-6)
    plain = tl.Llama(base_cfg, device="cpu")
    plain.load_state_dict(got)
    toks = torch.from_numpy(_batch(b=2, s=12)["inputs"])
    with torch.no_grad():
        torch.testing.assert_close(plain(toks), model(toks), **TOL)
    # Entries no adapter touches are the model's own tensors.
    assert got["embed"].data_ptr() == model.embed.data_ptr()


def test_merged_bf16_weights_keep_their_dtype():
    tcfg = dataclasses.replace(_cfgs()[1], dtype=torch.bfloat16,
                               param_dtype=None)
    model = tl.Llama(tcfg, device="cpu").init_weights(0)
    merged = tlora.merge(model.state_dict(), tcfg)
    assert merged["layers.0.attn.q_proj.weight"].dtype == torch.bfloat16
    assert merged["layers.0.input_norm.scale"].dtype == torch.float32
    assert not any(tlora.is_lora_path(k) for k in merged)
    # B is zero at init: the merge leaves every weight as it was.
    for k, v in merged.items():
        assert torch.equal(v, model.state_dict()[k]), k


# -- (f) the trainer's spec.lora --------------------------------------------


@pytest.fixture()
def _clean_env(monkeypatch):
    import os

    for key in [k for k in os.environ if k.startswith("TPK_")]:
        monkeypatch.delenv(key)
    resilience.metrics.reset()


def _spec(tmp_path, **kw):
    base = dict(model="llama_tiny",
                model_kwargs={"dtype": "float32", "num_layers": 2,
                              "attention_impl": "naive"},
                dataset="learnable_lm",
                lora={"rank": RANK, "alpha": 16.0, "targets": "attn"},
                batch_size=8, seq_len=16, learning_rate=1e-2, log_every=5,
                metrics_path=str(tmp_path / "m.jsonl"))
    base.update(kw)
    return ttrainer.TrainJobSpec(**base)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_lora_trainer_end_to_end_with_resume(tmp_path, _clean_env):
    """tests/test_lora.py's run on the port: 15 steps, then a second
    trainer to 30 that resumes from the saved step; the loss falls, the
    checkpoint's moments are the adapters' alone, and the eval stream runs
    the adapted model."""
    ckpt = {"dir": str(tmp_path / "ckpt"), "interval": 15}
    evals = dict(eval_every=15, eval_batches=2)
    result = ttrainer.Trainer(_spec(tmp_path, steps=15, checkpoint=ckpt,
                                    **evals), device="cpu").run()
    assert result["final_step"] == 15
    saved = torch.load(tmp_path / "ckpt" / "15" / tckpt.STATE_FILE,
                       weights_only=True)
    assert set(saved["mu"]) == set(saved["nu"]) == {
        n for n in saved["params"] if tlora.is_lora_path(n)}
    assert len(saved["mu"]) == 2 * 2 * 2
    trainer = ttrainer.Trainer(_spec(tmp_path, steps=30, checkpoint=ckpt,
                                     **evals), device="cpu")
    result = trainer.run()
    assert result["final_step"] == 30
    # The resumed run's one eval (step 30) read the eval stream's first two
    # batches with the trained adapters in place.
    stream = iter(trainer._eval_data())
    step = tstep.make_eval_step(trainer.model)
    want = np.mean([float(step(None, _tbatch(next(stream)))["loss"])
                    for _ in range(2)])
    assert result["eval_loss"] == pytest.approx(want, rel=1e-6)
    lines = _records(tmp_path / "m.jsonl")
    assert any(line.get("event") == "restored" for line in lines)
    first = next(line for line in lines
                 if line.get("step") == 5 and "loss" in line)
    assert result["loss"] < first["loss"]
    sharding = next(line for line in lines
                    if line.get("event") == "state_sharding")
    per_layer = RANK * 64 + 64 * RANK + RANK * 64 + 32 * RANK  # q, v
    assert sharding["opt_state_bytes_per_chip"] == 2 * 4 * 2 * per_layer


def test_interrupted_lora_run_resumes_with_the_fault_free_losses(
        tmp_path, _clean_env):
    ref_dir, run_dir = tmp_path / "ref", tmp_path / "run"
    ref_dir.mkdir()
    run_dir.mkdir()
    kw = dict(steps=8, log_every=1, lora={"rank": RANK,
                                          "targets": "attn_mlp"})
    ttrainer.Trainer(_spec(ref_dir, **kw), device="cpu").run()
    spec = _spec(run_dir, checkpoint={"dir": str(run_dir / "ck"),
                                      "interval": 3}, **kw)
    with faults.harness(seed=0) as h:
        h.arm("train.step", faults.FailN(1, match={"step": 5}))
        with pytest.raises(faults.FaultError):
            ttrainer.Trainer(spec, device="cpu").run()
    ttrainer.Trainer(spec, device="cpu").run()
    ref = {r["step"]: r["loss"] for r in _records(ref_dir / "m.jsonl")
           if "loss" in r and "event" not in r}
    recs = _records(run_dir / "m.jsonl")
    assert [r["step"] for r in recs if r.get("event") == "restored"] == [3]
    got = {r["step"]: r["loss"] for r in recs
           if "loss" in r and "event" not in r}
    assert got == ref


@pytest.mark.parametrize("kw,match", [
    ({"lora": {"rank": 0}}, "rank"),
    ({"lora": {"rank": 4, "targets": "everything"}}, "targets"),
    ({"lora": {"rank": 4}, "pipeline": {"microbatches": 2}}, "pipeline"),
    ({"lora": {"rnk": 4}}, "unknown spec.lora"),
    ({"lora": {"rank": 4}, "fsdp": 2}, "fsdp"),
], ids=["rank", "targets", "pipeline", "unknown_key", "fsdp"])
def test_lora_spec_rejections(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        ttrainer.Trainer(_spec(tmp_path, **kw), device="cpu")


def test_lora_needs_a_llama_family_model(tmp_path, monkeypatch):
    @dataclasses.dataclass(frozen=True)
    class MLPConfig:
        hidden: int = 8

    monkeypatch.setitem(registry._MODELS, "mlp", (MLPConfig, None))
    with pytest.raises(ValueError, match="Llama-family"):
        ttrainer.Trainer(_spec(tmp_path, model="mlp", model_kwargs={}),
                         device="cpu")
