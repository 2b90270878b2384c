"""Training the port's mixture-of-experts model against the JAX twin, fp32
on the CPU.

The routed block's Switch aux term against JAX's sown value (1e-6), its
output and gradients (x, router, the expert stacks, the shared expert)
against JAX's, at capacity 1.25 and 0.5 (drops), with the raw top-k mass
and a shared expert; the route-based gradients against the one-hot plain
version's; the no-grad (serving) forward bit-equal to the training one;
a dropped choice's zero expert gradient. Then `moe_tiny`'s
loss, aux and every gradient leaf against JAX's `make_train_step` loss
(full and chunked), remat off against each of the four policies (aux
counted once), accumulation over row slices, one whole update against
JAX's, LoRA on an MoE base through the trainer, the attn_mlp refusal in
JAX's words, and an interrupted job's resume.

Tolerances are `tests/test_torch_train_step.py`'s: loss 1e-5 absolute,
gradients 1e-4 rel-L2 per leaf (the two frameworks' fp32 matmuls and
reductions sum in other orders); aux 1e-6.
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

from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.parallel.sharding import DEFAULT_RULES
from kubeflow_tpu.train import step as jstep
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.train import optim
from kubeflow_tpu_torch.train import step as tstep
from kubeflow_tpu_torch.train import trainer as ttrainer
from kubeflow_tpu_torch.utils import faults

LOSS_TOL, GRAD_TOL, AUX_TOL = 1e-5, 1e-4, 1e-6
LR = 1e-3
#: Block cases: capacity 1.25 (the registry's), 0.5 (drops), the raw
#: top-k mass, and Qwen2-MoE's shared expert.
BLOCK_CASES = [
    ("cap1.25", dict()),
    ("cap0.5_drops", dict(capacity_factor=0.5)),
    ("raw_topk", dict(norm_topk_prob=False, capacity_factor=0.5)),
    ("shared", dict(shared_expert_size=96, norm_topk_prob=False)),
]


def configs(**kw):
    return (dataclasses.replace(jm.moe_tiny(), dtype=jnp.float32, **kw),
            dataclasses.replace(tm.moe_tiny(), dtype=torch.float32,
                                param_dtype=torch.float32, **kw))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _batch(b=2, s=16, seed=1, vocab=512):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the block ----------------------------------------------------------------

@pytest.fixture(scope="module", params=BLOCK_CASES, ids=lambda c: c[0])
def block(request):
    """(case, JAX params, port block, x, probe, JAX (y, aux, grads))."""
    name, kw = request.param
    jcfg, tcfg = configs(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jcfg.hidden_size)).astype(np.float32)
    probe = rng.standard_normal(x.shape).astype(np.float32)
    jblock = jm.MoEBlock(jcfg)
    params = fnn.meta.unbox(jblock.init(jax.random.key(2),
                                        jnp.asarray(x))["params"])

    def loss(p, xx):
        y, mut = jblock.apply({"params": p}, xx, mutable=["aux_loss"])
        aux = sum(jnp.sum(leaf) for leaf in jax.tree.leaves(mut))
        return jnp.sum(y * probe) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tblock = tm.MoEBlock(tcfg, device="cpu")
    tblock.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in params.items()})
    want = (np.asarray(y), float(aux),
            {"x": np.asarray(gx), **{k: np.asarray(v)
                                     for k, v in gp.items()}})
    return name, tblock, x, probe, want


def _block_grads(tblock, x, probe, plain=False):
    xt = torch.from_numpy(x).requires_grad_(True)
    fwd = tblock.forward_plain if plain else tblock.forward
    y, aux = fwd(xt, with_aux=True)
    loss = (y * torch.from_numpy(probe)).sum() + aux
    names = [n for n, _ in tblock.named_parameters()]
    grads = torch.autograd.grad(loss, [xt] + list(tblock.parameters()))
    return y.detach().numpy(), aux.item(), dict(zip(
        ["x"] + names, (g.numpy() for g in grads)))


def test_block_aux_output_and_grads_match_jax(block):
    name, tblock, x, probe, (want_y, want_aux, want_g) = block
    y, aux, grads = _block_grads(tblock, x, probe)
    assert abs(aux - want_aux) <= AUX_TOL
    assert aux > 0
    np.testing.assert_allclose(y, want_y, atol=2e-4, rtol=2e-4)
    assert set(grads) == set(want_g)
    for key, g in grads.items():
        assert _rel_l2(g, want_g[key]) <= GRAD_TOL, (name, key)


def test_block_route_grads_equal_the_plain_versions(block):
    """The adjoint gathers against the one-hot dispatch/combine einsums
    (`forward_plain`), both in the port: outputs, aux and every gradient."""
    _, tblock, x, probe, _ = block
    y, aux, grads = _block_grads(tblock, x, probe)
    py, paux, pgrads = _block_grads(tblock, x, probe, plain=True)
    np.testing.assert_allclose(y, py, atol=1e-6, rtol=1e-6)
    assert aux == paux
    for key, g in grads.items():
        assert _rel_l2(g, pgrads[key]) <= 1e-6, key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kw", [kw for _, kw in BLOCK_CASES],
                         ids=[name for name, _ in BLOCK_CASES])
def test_serving_forward_equals_the_training_forward(kw, dtype):
    """Without grad the block calls the dispatch and combine forwards
    directly, not through autograd's wrapper: its output and aux equal the
    training forward's bit for bit, drops included."""
    _, tcfg = configs(**kw)
    block = tm.MoEBlock(dataclasses.replace(tcfg, dtype=dtype), device="cpu")
    block.draw_weights(torch.Generator().manual_seed(6))
    x = torch.randn(2, 16, tcfg.hidden_size, generator=torch.Generator()
                    .manual_seed(7))
    with torch.no_grad():
        y, aux = block(x, with_aux=True)
    ty, taux = block(x, with_aux=True)
    assert ty.requires_grad and not y.requires_grad
    assert torch.equal(y, ty) and torch.equal(aux, taux)


def test_dropped_choice_gets_zero_expert_gradient():
    """A token whose every choice is dropped (capacity 0.5) reads zero rows:
    a loss on its output gives every expert stack and the router exactly
    zero gradient, as JAX's one-hot dispatch does, while its gradient
    still flows through the layer's residual (x + block(x)) whole."""
    _, tcfg = configs(capacity_factor=0.5)
    block = tm.MoEBlock(tcfg, device="cpu")
    block.draw_weights(torch.Generator().manual_seed(4))
    x = torch.randn(2, 16, tcfg.hidden_size, generator=torch.Generator()
                    .manual_seed(5))
    c = tm.expert_capacity(tcfg, 16)
    _, _, _, keep = tm.route(x, block.router, tcfg.experts_per_token, c)
    gone = (~keep).all(dim=-1).nonzero()
    assert len(gone), "the case must drop a token's every choice"
    b, s = gone[0].tolist()
    x.requires_grad_(True)
    out = x + block(x)
    params = [block.router, block.w_gate, block.w_up, block.w_down]
    grads = torch.autograd.grad(out[b, s].sum(), params + [x])
    for g in grads[:-1]:
        assert torch.count_nonzero(g) == 0
    want = torch.zeros_like(x)
    want[b, s] = 1.0
    assert torch.equal(grads[-1], want)


# -- the model through the train step -------------------------------------------

class _Recorder:
    """A stand-in optimizer that keeps the step's gradients."""

    def update(self, params, grads, opt_state, grad_norm=None):
        self.grads = [g.detach().clone() for g in grads]


def _pair(seed=0, **kw):
    jcfg, tcfg = configs(**kw)
    jmod = jm.MoELlama(jcfg)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jmod.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]))
    return jmod, params, tcfg


def _port(tcfg, params):
    model = tm.MoELlama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(params, tcfg))
    return model


def _jax_loss(jmod, loss_impl):
    """JAX `make_train_step`'s compute_loss (the sown aux collection summed
    into the loss), for value_and_grad."""

    def loss(p, batch):
        hidden = loss_impl == "chunked"
        out, mut = jmod.apply({"params": p}, batch["inputs"],
                              mutable=["aux_loss"], return_hidden=hidden)
        if hidden:
            head, vocab_major = jstep._unembed_head(p)
            main = jstep.chunked_cross_entropy(
                out, head, batch["targets"], chunk=40,
                head_is_vocab_major=vocab_major)
        else:
            main = jstep.cross_entropy_loss(out, batch["targets"])
        aux = jnp.zeros((), jnp.float32)
        for leaf in jax.tree.leaves(mut.get("aux_loss", {})):
            aux = aux + jnp.sum(leaf)
        return main + aux, aux

    return loss


def _port_step(model, loss_impl, batch, accum=1):
    """(loss, aux, {name: grad}) of one port train step."""
    rec = _Recorder()
    state = tstep.TrainState(step=0, model=model, opt_state=None, tx=rec)
    fn = tstep.make_train_step(model, loss_impl=loss_impl, loss_chunk=40,
                               accum_steps=accum)
    _, metrics = fn(state, _tbatch(batch))
    return (float(metrics["loss"]), float(metrics["aux_loss"]),
            dict(zip(state.train_named, (g.numpy() for g in rec.grads))))


@pytest.mark.parametrize("loss_impl,kw", [
    ("full", dict()),
    ("chunked", dict(capacity_factor=0.5)),
    ("full", dict(capacity_factor=0.5, norm_topk_prob=False,
                  shared_expert_size=96)),
], ids=["full_cap1.25", "chunked_cap0.5", "full_shared_raw"])
def test_loss_aux_and_grads_match_jax(loss_impl, kw):
    jmod, params, tcfg = _pair(**kw)
    batch = _batch()
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        _jax_loss(jmod, loss_impl), has_aux=True))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, batch))
    want = llama_params_from_jax(jax.tree.map(np.asarray, want_grads), tcfg)
    loss, aux, grads = _port_step(_port(tcfg, params), loss_impl, batch)
    assert abs(loss - float(want_loss)) <= LOSS_TOL
    assert abs(aux - float(want_aux)) <= AUX_TOL and aux > 0
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert _rel_l2(g, want[name].numpy()) <= GRAD_TOL, name


@pytest.mark.parametrize("policy", tl.REMAT_POLICIES)
def test_remat_policies_count_aux_once(policy):
    """Remat off against each policy: equal loss, aux (an output of the
    checkpointed function, never added again by the recompute) and
    gradients, with drops."""
    out = {}
    for remat in (False, True):
        _, tcfg = configs(capacity_factor=0.5, remat=remat,
                          remat_policy=policy)
        model = tm.MoELlama(tcfg, device="cpu").init_weights(3)
        out[remat] = _port_step(model, "full", _batch(seed=4))
    assert out[True][:2] == out[False][:2]
    for name, g in out[False][2].items():
        np.testing.assert_allclose(out[True][2][name], g, atol=1e-7,
                                   rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_update():
    """One JAX make_train_step update of moe_tiny (capacity 0.5) at
    accum_steps 2: (JAX params before, after, metrics, batch, port cfg)."""
    jmod, params, tcfg = _pair(capacity_factor=0.5)
    batch = _batch(b=4, seed=2)
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=jax.tree.map(jnp.asarray, params),
                              opt_state=optax.adamw(LR).init(params),
                              tx=optax.adamw(LR))
    fn = jstep.make_train_step(jmod, mesh, DEFAULT_RULES, accum_steps=2)
    new, metrics = fn(jstate, batch)
    return (params, jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, metrics), batch, tcfg)


def test_one_update_matches_jax_make_train_step(jax_update):
    """The whole step (2 row slices, their aux averaged, AdamW) against
    JAX's: loss, aux_loss, grad_norm, and the updated params within 1e-5.
    Adam's first step is about sign(g)·lr, so an element whose gradient
    is near zero may move differently: at most 1e-3 of the elements may
    pass 1e-5, and none Adam's 2·lr."""
    params, want_params, want, batch, tcfg = jax_update
    model = _port(tcfg, params)
    state = tstep.init_train_state(model, optim.AdamW(LR),
                                   params=model.state_dict())
    fn = tstep.make_train_step(model, accum_steps=2)
    _, metrics = fn(state, _tbatch(batch))
    assert abs(float(metrics["loss"]) - float(want["loss"])) <= LOSS_TOL
    assert abs(float(metrics["aux_loss"]) - float(want["aux_loss"])) \
        <= AUX_TOL
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(want["grad_norm"]), rel=GRAD_TOL)
    new = llama_params_from_jax(want_params, tcfg)
    diff = np.concatenate([
        np.abs(p.detach().numpy() - new[name].numpy()).ravel()
        for name, p in model.named_parameters()])
    assert np.mean(diff > 1e-5) < 1e-3, np.mean(diff > 1e-5)
    assert diff.max() <= 2.01 * LR


def test_row_slices_reproduce_the_full_batch():
    """Capacity is claimed per batch row, so with the aux coefficient at 0
    two row slices give the full batch's loss and gradients. The Switch
    term itself is a statistic of the whole (micro)batch: each slice adds
    its own, averaged, as JAX's scan does (held by the test above)."""
    _, tcfg = configs(capacity_factor=0.5, router_aux_coef=0.0)
    batch = _batch(b=4, seed=7)
    out = [_port_step(tm.MoELlama(tcfg, device="cpu").init_weights(8),
                      "full", batch, accum) for accum in (1, 2)]
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for name, g in out[0][2].items():
        np.testing.assert_allclose(out[1][2][name], g, atol=1e-7, rtol=1e-5,
                                   err_msg=name)


# -- the trainer ----------------------------------------------------------------

def _spec(tmp_path=None, **kw):
    base = dict(model="moe_tiny", model_kwargs={"dtype": "float32"},
                steps=4, batch_size=2, seq_len=16, log_every=1,
                learning_rate=3e-3, dataset="learnable_lm")
    if tmp_path is not None:
        base["metrics_path"] = str(tmp_path / "metrics.jsonl")
    base.update(kw)
    return ttrainer.TrainJobSpec(**base)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _losses(recs):
    return {r["step"]: (r["loss"], r["aux_loss"]) for r in recs
            if "loss" in r and "event" not in r}


def test_lora_attn_on_an_moe_base_trains():
    """spec.lora with targets 'attn' on moe_tiny: the base (routers and
    expert stacks included) stays bit-unchanged, the adapters move, and
    the step lines carry a positive aux_loss."""
    trainer = ttrainer.Trainer(_spec(steps=2, lora={"rank": 4}),
                               device="cpu")
    trainer.model.init_weights(0)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    real = ttrainer.init_train_state
    ttrainer.init_train_state = lambda model, tx, seed, trainable: real(
        model, tx, params=dict(before), trainable=trainable)
    try:
        result = trainer.run()
    finally:
        ttrainer.init_train_state = real
    assert result["aux_loss"] > 0
    moved = 0
    for name, p in trainer.model.named_parameters():
        if "_lora_" in name:
            moved += not torch.equal(p, before[name])
        else:
            assert torch.equal(p, before[name]), name
    assert moved and not any("mlp" in n and "_lora_" in n
                             for n in before)


def test_attn_mlp_adapters_on_moe_are_refused_with_jax_words():
    spec = dict(model="moe_tiny", steps=1, batch_size=2, seq_len=8,
                lora={"rank": 4, "targets": "attn_mlp"})
    with pytest.raises(ValueError) as jerr:
        jtrainer.Trainer(jtrainer.TrainJobSpec(**spec))
    with pytest.raises(ValueError) as terr:
        ttrainer.Trainer(ttrainer.TrainJobSpec(**spec), device="cpu")
    assert str(terr.value) == str(jerr.value) == ttrainer.MOE_LORA_REFUSAL


def test_interrupted_moe_job_resumes_on_the_fault_free_losses(tmp_path):
    """A moe_tiny job killed at step 5 and resumed from its step-3
    checkpoint logs the fault-free run's losses and aux_loss exactly."""
    ref_dir, run_dir = tmp_path / "ref", tmp_path / "run"
    ref_dir.mkdir()
    run_dir.mkdir()
    ttrainer.Trainer(_spec(ref_dir, steps=6), device="cpu").run()
    spec = _spec(run_dir, steps=6,
                 checkpoint={"dir": str(run_dir / "ck"), "interval": 3})
    with faults.harness(seed=0) as h:
        h.arm("train.step", faults.FailN(1, match={"step": 5}))
        with pytest.raises(faults.FaultError):
            ttrainer.Trainer(spec, device="cpu").run()
    ttrainer.Trainer(spec, device="cpu").run()
    recs = _records(run_dir / "metrics.jsonl")
    assert [r["step"] for r in recs if r.get("event") == "restored"] == [3]
    ref = _losses(_records(ref_dir / "metrics.jsonl"))
    assert _losses(recs) == ref and len(ref) == 6
