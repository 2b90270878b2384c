"""Port train step and optimizer against the JAX package (fp32, CPU).

One llama_tiny step on the same weights and batch, attention_impl="flash"
on both sides (the port's plain flash backward vs the Pallas kernels in
interpret mode): loss at 1e-5 and per-leaf gradients at 1e-4 rel-L2 — the
two frameworks' fp32 matmuls and reductions sum in different orders. The
optimizer alone is held against optax.adamw on identical gradients at
1e-6.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.parallel.sharding import DEFAULT_RULES
from kubeflow_tpu.train import step as jstep
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.train import optim
from kubeflow_tpu_torch.train import step as tstep

LR = 1e-3


def _cfgs(**kw):
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               attention_impl="flash", **kw)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               param_dtype=torch.float32,
                               attention_impl="flash", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    """JAX model + its initial params (numpy), and a mesh of one device."""
    jcfg, tcfg = _cfgs()
    jm = jl.Llama(jcfg)
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    params = fnn.meta.unbox(jm.init(jax.random.key(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    return jm, tcfg, mesh, jax.tree.map(np.asarray, params)


def _batch(b=4, s=24, seed=1, vocab=512):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _port_model(tcfg, params_np):
    model = tl.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(params_np, tcfg))
    return model


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("loss_impl", ["full", "chunked"])
def test_loss_and_grads_match_jax(setup, loss_impl):
    jm, tcfg, _, params = setup
    batch = _batch()

    def jloss(p):
        if loss_impl == "chunked":
            hidden = jm.apply({"params": p}, jnp.asarray(batch["inputs"]),
                              return_hidden=True)
            return jstep.chunked_cross_entropy(
                hidden, p["lm_head"]["kernel"], jnp.asarray(batch["targets"]),
                chunk=40)
        logits = jm.apply({"params": p}, jnp.asarray(batch["inputs"]))
        return jstep.cross_entropy_loss(logits, jnp.asarray(batch["targets"]))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    want = llama_params_from_jax(jax.tree.map(np.asarray, want_grads), tcfg)
    model = _port_model(tcfg, params)
    tb = _tbatch(batch)
    if loss_impl == "chunked":
        loss = tstep.chunked_cross_entropy(
            model(tb["inputs"], return_hidden=True),
            tstep._unembed_head(model), tb["targets"], chunk=40)
    else:
        loss = tstep.cross_entropy_loss(model(tb["inputs"]), tb["targets"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        assert _rel_l2(g.numpy(), want[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("loss_impl,accum", [("full", 1), ("chunked", 2)],
                         ids=["full", "chunked_accum2"])
def test_train_step_matches_jax_make_train_step(setup, loss_impl, accum):
    """The whole step against JAX make_train_step with optax.adamw: loss,
    grad_norm, the step count, and the post-step params in units of lr
    (Adam's first step is about sign(g)·lr, so an element whose gradient is
    near zero may move differently; almost all must agree)."""
    jm, tcfg, mesh, params = setup
    batch = _batch(seed=2)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              params=jax.tree.map(jnp.asarray, params),
                              opt_state=optax.adamw(LR).init(params),
                              tx=optax.adamw(LR))
    jfn = jstep.make_train_step(jm, mesh, DEFAULT_RULES, loss_impl=loss_impl,
                                loss_chunk=40, accum_steps=accum)
    jnew, jm_ = jfn(jstate, batch)
    want_params = llama_params_from_jax(jax.tree.map(np.asarray,
                                                     jnew.params), tcfg)
    model = _port_model(tcfg, params)
    state = tstep.init_train_state(model, optim.AdamW(LR),
                                   params=model.state_dict())
    fn = tstep.make_train_step(model, loss_impl=loss_impl, loss_chunk=40,
                               accum_steps=accum)
    state, metrics = fn(state, _tbatch(batch))
    assert abs(float(metrics["loss"]) - float(jm_["loss"])) <= 1e-5
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(jm_["grad_norm"]), rel=1e-4)
    assert metrics["step"] == int(jm_["step"]) == 1
    moved = np.concatenate([
        (np.abs(p.detach().numpy() - want_params[n].numpy()) / LR).ravel()
        for n, p in model.named_parameters()])
    assert np.mean(moved > 1e-2) < 1e-3, np.mean(moved > 1e-2)
    assert moved.max() <= 2.01


def test_accum_steps_reproduce_the_full_batch():
    """accum_steps=2 on batch B lands on the 1 x B step (fp32 sums of the
    micro-batch means equal the full mean up to rounding)."""
    _, tcfg = _cfgs()
    batch = _tbatch(_batch(seed=3))
    out = []
    for accum in (1, 2):
        model = tl.Llama(tcfg, device="cpu").init_weights(5)
        state = tstep.init_train_state(model, optim.AdamW(LR),
                                       params=model.state_dict())
        _, m = tstep.make_train_step(model, accum_steps=accum)(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    torch.cat([p.detach().ravel()
                               for p in model.parameters()])))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-5)
    torch.testing.assert_close(out[0][2], out[1][2], atol=1e-6, rtol=0)


def test_remat_gives_identical_grads():
    """torch.utils.checkpoint per DecoderLayer recomputes the same forward:
    the gradients are bit-identical with remat on and off."""
    grads = {}
    for remat in (False, True):
        _, tcfg = _cfgs(remat=remat)
        model = tl.Llama(tcfg, device="cpu").init_weights(3)
        tb = _tbatch(_batch(seed=4))
        loss = tstep.cross_entropy_loss(model(tb["inputs"]), tb["targets"])
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_fp32_params_cast_to_bf16_at_use():
    """param_dtype=float32 with dtype=bf16: fp32 storage, bf16 compute —
    the same logits as a bf16-stored copy of the same weights."""
    cfg = dataclasses.replace(tl.llama_tiny(), param_dtype="float32")
    m32 = tl.Llama(cfg, device="cpu").init_weights(0)
    assert m32.embed.dtype == torch.float32
    assert m32.layers[0].attn.q_proj.weight.dtype == torch.float32
    m16 = tl.Llama(tl.llama_tiny(), device="cpu")
    assert m16.embed.dtype == torch.bfloat16
    m16.load_state_dict({k: v.to(m16.state_dict()[k].dtype)
                         for k, v in m32.state_dict().items()})
    toks = torch.from_numpy(_batch()["inputs"])
    with torch.no_grad():
        assert torch.equal(m32(toks), m16(toks))


def test_make_train_step_refuses_unported():
    model = tl.Llama(_cfgs()[1], device="cpu")
    for kw, what in [({"pipeline": {"microbatches": 2}}, "pipeline"),
                     ({"fsdp": object()}, "FSDP"),
                     ({"mesh": object()}, "mesh")]:
        with pytest.raises(NotImplementedError, match=what):
            tstep.make_train_step(model, **kw)
    with pytest.raises(ValueError, match="loss_impl"):
        tstep.make_train_step(model, loss_impl="nope")


# -- the optimizer alone ------------------------------------------------------

SCHEDULES = {
    "constant": (0.05, 0.05),
    "warmup": (optax.linear_schedule(0.0, 0.05, 2),
               optim.linear_schedule(0.0, 0.05, 2)),
    "cosine": (optax.warmup_cosine_decay_schedule(0.0, 0.05, 1, 4,
                                                  end_value=0.01),
               optim.warmup_cosine_decay_schedule(0.0, 0.05, 1, 4,
                                                  end_value=0.01)),
    "linear": (optax.linear_schedule(0.05, 0.0, 3),
               optim.linear_schedule(0.05, 0.0, 3)),
    "join": (optax.join_schedules([optax.linear_schedule(0.0, 0.05, 1),
                                   optax.linear_schedule(0.05, 0.01, 3)],
                                  [1]),
             optim.join_schedules([optim.linear_schedule(0.0, 0.05, 1),
                                   optim.linear_schedule(0.05, 0.01, 3)],
                                  [1])),
}
# clip_by_global_norm ahead of adamw for these (max_norm 1.5 < the ~4.6
# global norm of the test's gradients, so it scales every step).
CLIPPED = {"constant", "cosine", "join"}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_matches_optax(schedule, mu_dtype):
    """Three updates on identical gradients: params, mu and nu at 1e-6
    (with clipping for the CLIPPED schedules)."""
    clip = 1.5 if schedule in CLIPPED else 0.0
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (3,), (2, 4, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jlr, tlr = SCHEDULES[schedule]
    tx = optax.adamw(jlr, weight_decay=1e-4,
                     mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = [jnp.asarray(p) for p in params]
    jst = tx.init(jp)
    port = optim.AdamW(tlr, mu_dtype=None if mu_dtype is None
                       else torch.bfloat16, max_grad_norm=clip)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tst = port.init(tp)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, jst = tx.update([jnp.asarray(g) for g in grads], jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = port.update(tp, [torch.from_numpy(g) for g in grads], tst)
    adam = jst[-1][0] if clip else jst[0]
    assert tst.count == int(adam.count) == 3
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    for got, want in zip(tst.mu, adam.mu):
        assert str(got.dtype).endswith(str(want.dtype))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=1e-6,
                                   rtol=1e-6)
    for got, want in zip(tst.nu, adam.nu):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("schedule", ["warmup", "cosine", "linear", "join"])
def test_schedules_match_optax(schedule):
    jlr, tlr = SCHEDULES[schedule]
    for count in range(8):
        assert tlr(count) == pytest.approx(float(jlr(count)), rel=1e-6,
                                           abs=1e-9)
