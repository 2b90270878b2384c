"""The four remat policies of the port's Llama (fp32, CPU).

"nothing", "dots", "dots_no_batch" and "save_attn" change what the forward
keeps for the backward, never a value: within the port each policy's loss
and gradients equal remat=False's bit for bit (the recompute runs the same
ops on the same inputs), and against the JAX model under the same
`nn.remat` policy they agree to 1e-5 (loss) and 1e-4 rel-L2 (gradients),
tests/test_torch_train_step.py's tolerances. A dispatch count over the
backward shows what each policy recomputes: "nothing" and "save_attn" the
projections of every layer, "dots" no matrix product, "dots_no_batch" no
projection but naive attention's two batched products.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.train import step as jstep
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.train import step as tstep

POLICIES = ("nothing", "dots", "dots_no_batch", "save_attn")
LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets="attn_mlp")


def _tcfg(impl="naive", lora=False, **kw):
    return dataclasses.replace(
        tl.llama_tiny(), dtype=torch.float32, param_dtype=torch.float32,
        attention_impl=impl, **(LORA if lora else {}), **kw)


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, 512, (3, 20)))
            for k in ("inputs", "targets")}


def _model(cfg, seed=3):
    """Weights from `seed`, every LoRA B drawn non-zero."""
    model = tl.Llama(cfg, device="cpu").init_weights(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_lora_b"):
                p.normal_(0.0, 0.05, generator=gen)
    return model


def _loss_and_grads(model, batch):
    loss = tstep.cross_entropy_loss(model(batch["inputs"]), batch["targets"])
    return loss.detach(), torch.autograd.grad(loss,
                                              list(model.parameters()))


@pytest.mark.parametrize("impl", ["naive", "flash"])
@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gives_remat_off_gradients_bit_for_bit(policy, lora, impl):
    batch = _batch()
    ref_loss, ref = _loss_and_grads(_model(_tcfg(impl, lora, remat=False)),
                                    batch)
    loss, grads = _loss_and_grads(
        _model(_tcfg(impl, lora, remat=True, remat_policy=policy)), batch)
    assert torch.equal(loss, ref_loss)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_under_the_same_policy(policy, lora):
    common = dict(dtype=jnp.float32, param_dtype=jnp.float32,
                  attention_impl="naive", remat=True, remat_policy=policy,
                  **(LORA if lora else {}))
    jm = jl.Llama(dataclasses.replace(jl.llama_tiny(), **common))
    params = fnn.meta.unbox(jm.init(jax.random.key(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    if lora:  # B non-zero, so the adapters' gradients are not vacuous
        rng = np.random.default_rng(0)
        for block in ("attn", "mlp"):
            sub = params["layers"][block]
            for key in [k for k in sub if k.endswith("_lora_b")]:
                sub[key] = jnp.asarray(rng.normal(
                    0, 0.05, sub[key].shape).astype(np.float32))
    batch = {k: v.numpy().astype(np.int32) for k, v in _batch().items()}

    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(batch["inputs"]))
        return jstep.cross_entropy_loss(logits, jnp.asarray(batch["targets"]))

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    tcfg = _tcfg("naive", lora, remat=True, remat_policy=policy)
    want = llama_params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    model = tl.Llama(tcfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    loss, grads = _loss_and_grads(model, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    for (name, _), g in zip(model.named_parameters(), grads):
        assert _rel_l2(g.numpy(), want[name].numpy()) <= 1e-4, name


class _Products(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def _backward_products(cfg) -> tuple[int, int]:
    model = _model(cfg)
    batch = _batch()
    loss = tstep.cross_entropy_loss(model(batch["inputs"]), batch["targets"])
    with _Products() as mode:
        torch.autograd.grad(loss, list(model.parameters()))
    return mode.mm, mode.bmm


@pytest.mark.parametrize("lora", [False, True], ids=["plain", "lora"])
def test_what_each_policy_recomputes(lora):
    """Products run in the backward beyond remat=False's. "nothing" reruns
    a layer's products (seven projections, two more per adapter) and naive
    attention's two bmm, all but the last: the recompute stops at the last
    tensor the backward needs, and down_proj's output (its LoRA delta's,
    with adapters) feeds only the residual add. "save_attn" checkpoints
    two regions, so o_proj, the first region's last product, is not rerun
    either. "dots_no_batch" reruns only the bmm, "dots" nothing."""
    layers = tl.llama_tiny().num_layers
    mm0, bmm0 = _backward_products(_tcfg(lora=lora, remat=False))
    products = 7 + 2 * 5 * lora  # a layer's, attention's bmm aside
    want = {"nothing": ((products - 1) * layers, 2 * layers),
            "save_attn": ((products - 2) * layers, 2 * layers),
            "dots_no_batch": (0, 2 * layers),
            "dots": (0, 0)}
    for policy, extra in want.items():
        mm, bmm = _backward_products(
            _tcfg(lora=lora, remat=True, remat_policy=policy))
        assert (mm - mm0, bmm - bmm0) == extra, policy


def test_unknown_remat_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        tl.Llama(_tcfg(remat=True, remat_policy="bogus"), device="cpu")
