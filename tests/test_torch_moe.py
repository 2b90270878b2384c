"""The port's mixture-of-experts model (models/moe.py) against the JAX
twin on the same weights, fp32, on the CPU: the routed block's outputs
(serving path and plain one-hot path), its expert choices, slots and
drops, `MoELlama` logits (a prompt padded as the JAX engine pads it too),
the registry entries, int8 codes and logits against `quantize_tree` and
`QuantizedModule`, the part-by-part int8 build, and the refusals of MLP
adapters on an MoE base.

Tolerance 2e-4, as tests/test_torch_llama.py: the two frameworks' fp32
matmuls and reductions sum in different orders. Int8 logits within 5e-3
rel-L2 of JAX's: JAX dequantizes the expert stacks before a float einsum,
the port puts the scale on the W8A16 op's fp32 output.
"""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import moe as jm
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve import quant as tq

TOL = dict(atol=2e-4, rtol=2e-4)
#: Gate values: fp32 softmax of router logits that differ in the last bit.
GATE_TOL = dict(atol=1e-6, rtol=1e-6)
#: Block cases: (id, config fields). "drops": capacity 4 of 16 tokens' 32
#: choices over 4 experts, so some choices must drop; "dropless": E/K,
#: capacity S; "shared": Qwen2-MoE's shared expert and raw top-k mass.
BLOCK_CASES = [
    ("drops", dict(capacity_factor=0.5)),
    ("dropless", dict(capacity_factor=2.0)),
    ("shared", dict(shared_expert_size=96, norm_topk_prob=False)),
]


def configs(**kw):
    """(JAX MoEConfig, port MoEConfig): moe_tiny in fp32 with `kw`."""
    return (dataclasses.replace(jm.moe_tiny(), dtype=jnp.float32, **kw),
            dataclasses.replace(tm.moe_tiny(), dtype=torch.float32, **kw))


def pair(seed=0, **kw):
    """(JAX MoELlama, its params as numpy, port MoELlama) on the same
    weights."""
    jcfg, tcfg = configs(**kw)
    jmod = jm.MoELlama(jcfg)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jmod.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]))
    tmod = tm.MoELlama(tcfg, device="cpu")
    tmod.load_state_dict(llama_params_from_jax(params, tcfg))
    return jmod, params, tmod.eval()


def tokens(b=2, s=12, seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def dispatch_from_route(experts, gates, slot, keep, e, c):
    """The one-hot [B,S,E,C] dispatch and combine of the serving path's
    assignment (what JAX's gshard_route builds)."""
    b, s, k = experts.shape
    dispatch = np.zeros((b, s, e, c), np.float32)
    combine = np.zeros((b, s, e, c), np.float32)
    for bi, si, j in np.ndindex(b, s, k):
        if keep[bi, si, j]:
            dispatch[bi, si, experts[bi, si, j], slot[bi, si, j]] = 1.0
            combine[bi, si, experts[bi, si, j], slot[bi, si, j]] = gates[
                bi, si, j]
    return dispatch, combine


@pytest.fixture(scope="module", params=BLOCK_CASES, ids=lambda c: c[0])
def block(request):
    """(case id, JAX block params, port MoEBlock, x [2, 16, H], JAX
    output)."""
    name, kw = request.param
    jcfg, tcfg = configs(**kw)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jcfg.hidden_size)).astype(np.float32)
    jblock = jm.MoEBlock(jcfg)
    params = fnn.meta.unbox(jblock.init(jax.random.key(2),
                                        jnp.asarray(x))["params"])
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    tblock = tm.MoEBlock(tcfg, device="cpu")
    tblock.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in params.items()})
    return name, params, tblock, x, want


def test_block_outputs_match_jax(block):
    name, _, tblock, x, want = block
    with torch.no_grad():
        got = tblock(torch.from_numpy(x)).numpy()
        plain = tblock.forward_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(plain, want, **TOL)


def test_block_routing_matches_jax(block):
    """Expert choices, slots and drops of the serving path, as one-hot
    dispatch and combine tensors, equal JAX's gshard_route; so does the
    plain version's. The drops case drops, the dropless one does not."""
    name, params, tblock, x, _ = block
    cfg = tblock.cfg
    c = tm.expert_capacity(cfg, x.shape[1])
    assert c == jm.expert_capacity(cfg, x.shape[1])
    jd, jc, jaux = jm.gshard_route(
        jnp.asarray(x), jnp.asarray(params["router"]), cfg.experts_per_token,
        c, renormalize=cfg.norm_topk_prob)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        experts, gates, slot, keep = (t.numpy() for t in tm.route(
            xt, tblock.router, cfg.experts_per_token, c,
            cfg.norm_topk_prob))
        pd, pc, paux = tm.gshard_route(xt, tblock.router,
                                       cfg.experts_per_token, c,
                                       cfg.norm_topk_prob)
    dispatch, combine = dispatch_from_route(experts, gates, slot, keep,
                                            cfg.num_experts, c)
    np.testing.assert_array_equal(dispatch, np.asarray(jd))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    # The gates differ by an ulp: XLA's and torch's fp32 router products
    # sum H terms in different orders.
    np.testing.assert_allclose(combine, np.asarray(jc), **GATE_TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **GATE_TOL)
    np.testing.assert_allclose(paux.item(), float(jaux), rtol=1e-6)
    dropped = int((~keep).sum())
    if name != "shared":  # capacity 1.25 there: a drop or not, by chance
        assert (dropped > 0) == (name == "drops"), dropped


def test_block_breaks_top_k_ties_to_the_lower_expert():
    """Equal router columns tie every token's probabilities: both
    packages choose the lower expert index first."""
    jcfg, tcfg = configs()
    router = np.random.default_rng(5).standard_normal(
        (jcfg.hidden_size, jcfg.num_experts)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    x = np.random.default_rng(6).standard_normal(
        (1, 8, jcfg.hidden_size)).astype(np.float32)
    jd, _, _ = jm.gshard_route(jnp.asarray(x), jnp.asarray(router), 2, 8)
    experts, _, slot, keep = tm.route(torch.from_numpy(x),
                                      torch.from_numpy(router), 2, 8)
    d, _ = dispatch_from_route(experts.numpy(), np.zeros(experts.shape),
                               slot.numpy(), keep.numpy(), 4, 8)
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert set(experts[0, :, 0].tolist()) <= {0, 1}


@pytest.fixture(scope="module")
def model():
    return pair()


@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 0.5},
                                {"shared_expert_size": 96,
                                 "norm_topk_prob": False,
                                 "attention_bias": True}],
                         ids=["mixtral_like", "drops", "qwen2_moe_like"])
def test_moe_llama_logits_match_jax(model, kw):
    jmod, params, tmod = pair(**kw) if kw else model
    toks = tokens()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_padded_prompt_matches_jax(model):
    """A 5-token prompt right-padded with zeros to its bucket of 16, as
    both engines pad it: the pad tokens route and claim capacity too, so
    the real positions' logits follow the bucket (drops at capacity 0.5),
    and the port's equal JAX's at every real position."""
    jmod, params, tmod = pair(capacity_factor=0.5)
    prompt = tokens(1, 5, seed=9)
    padded = np.zeros((1, 16), np.int32)
    padded[:, :5] = prompt
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(padded)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(padded)).numpy()
        alone = tmod(torch.from_numpy(prompt)).numpy()
    np.testing.assert_allclose(got[:, :5], want[:, :5], **TOL)
    assert np.abs(alone - got[:, :5]).max() > 1e-3  # the bucket mattered


def test_registry_entries_match_jax():
    from kubeflow_tpu.utils import registry as jr
    from kubeflow_tpu_torch.utils import registry as tr

    for name in ("moe_tiny", "mixtral_8x7b"):
        assert name in tr.list_models()
    module, info = tr.build_model("moe_tiny", device="cpu", vocab_size=64)
    _, jinfo = jr.build_model("moe_tiny", vocab_size=64)
    assert isinstance(module.layers[0].mlp, tm.MoEBlock)
    assert info["task"] == jinfo["task"] == "lm"
    assert (info["num_params"], info["active_params"]) == (
        jinfo["num_params"], jinfo["active_params"])
    assert info["active_params"] < info["num_params"]
    n = sum(p.numel() for p in module.parameters())
    assert n == info["num_params"]
    cfg = tr.model_config("mixtral_8x7b")
    jcfg = jm.mixtral_8x7b()
    assert (cfg.num_params, cfg.active_params) == (jcfg.num_params,
                                                   jcfg.active_params)
    assert cfg.num_params == 46_702_792_704


# -- int8 ----------------------------------------------------------------------

def _mlp_leaf(tree, name):
    return tree["layers"]["mlp"][name]


@pytest.mark.parametrize("min_size", [4096, 64])
@pytest.mark.parametrize("kw", [{}, {"shared_expert_size": 96,
                                     "norm_topk_prob": False}],
                         ids=["mixtral_like", "shared"])
def test_int8_codes_match_quantize_tree(kw, min_size):
    """Expert stacks and shared leaves: codes and scales equal JAX's
    `quantize_tree` (one scale per layer, expert and output column); the
    router stays fp32 in both; leaves under `min_size` stacked stay
    float in both (at 4096, the [2, 64, 1] shared gate)."""
    _, params, tmod = pair(**kw)
    qparams = jq.quantize_tree(params, min_size=min_size)
    tq.quantize_model(tmod, min_size=min_size)
    assert not isinstance(_mlp_leaf(qparams, "router"), jq.Int8Leaf)
    names = ["w_gate", "w_up", "w_down"] + (
        ["w_shared_gate", "w_shared_up", "w_shared_down", "shared_gate"]
        if kw else [])
    for i, layer in enumerate(tmod.layers):
        mlp = layer.mlp
        assert mlp.router.dtype == torch.float32
        assert layer.input_norm.scale.dtype == torch.float32
        for name in names:
            jleaf = _mlp_leaf(qparams, name)
            tleaf = getattr(mlp, name)
            if not isinstance(jleaf, jq.Int8Leaf):
                assert isinstance(tleaf, torch.nn.Parameter), name
                continue
            q = np.asarray(jleaf.q)[i]
            scale = np.asarray(jleaf.scale)[i]
            np.testing.assert_array_equal(
                tleaf.q.numpy(), np.swapaxes(q, -1, -2), err_msg=name)
            np.testing.assert_array_equal(
                tleaf.scale.numpy(), scale.reshape(tleaf.scale.shape),
                err_msg=name)
    assert isinstance(tmod.layers[0].mlp.w_gate, tq.Int8Experts)
    if kw and min_size == 64:
        assert isinstance(tmod.layers[0].mlp.shared_gate, tq.Int8Dense)


@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 0.5},
                                {"shared_expert_size": 96,
                                 "norm_topk_prob": False}],
                         ids=["mixtral_like", "drops", "shared"])
def test_int8_logits_match_quantized_module(kw):
    """The port's int8 model (expert stacks on the W8A16 op's plain
    version here) against JAX's QuantizedModule on quantize_tree's
    codes: within 5e-3 rel-L2 (the fixed-forward int8 bound)."""
    jmod, params, tmod = pair(**kw)
    qparams = jq.quantize_tree(params)
    tq.quantize_model(tmod)
    toks = tokens()
    want = np.asarray(jq.QuantizedModule(jmod, jnp.float32).apply(
        {"params": qparams}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(toks)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-3, rel


def test_int8_state_dict_round_trips_through_the_converter():
    """JAX's quantize_tree output, flattened to {"q", "scale"} pairs, loads
    into the port's int8 MoE model (quantized_dense) as the same codes
    the port's own quantize_model gives."""
    _, params, tmod = pair()
    qparams = jq.quantize_tree(params)
    flat = jax.tree.map(
        lambda leaf: ({"q": np.asarray(leaf.q), "scale": np.asarray(
            leaf.scale)} if isinstance(leaf, jq.Int8Leaf) else leaf),
        qparams, is_leaf=lambda x: isinstance(x, jq.Int8Leaf))
    qcfg = dataclasses.replace(tmod.cfg, quantized_dense=True)
    loaded = tm.MoELlama(qcfg, device="cpu")
    loaded.load_state_dict(llama_params_from_jax(flat, qcfg))
    own = tq.quantize_model(tmod).state_dict()
    for key, val in loaded.state_dict().items():
        torch.testing.assert_close(val, own[key], rtol=0, atol=0)


@pytest.mark.parametrize("name,kw", [
    ("moe_tiny", {}), ("moe_tiny", {"shared_expert_size": 96}),
    ("llama_tiny", {})])
def test_init_quantized_equals_quantize_model(name, kw):
    """A model built on the meta device and filled part by part from a
    seed equals quantize_model of init_weights from that seed."""
    from kubeflow_tpu_torch.utils import registry as tr

    kw = dict(kw, dtype="float32")
    ref, _ = tr.build_model(name, device="cpu", **kw)
    ref = tq.quantize_model(ref.init_weights(7))
    lazy, _ = tr.build_model(name, device="meta", **kw)
    tq.init_quantized(lazy, 7, "cpu")
    a, b = ref.state_dict(), lazy.state_dict()
    assert sorted(a) == sorted(b)
    for key in a:
        torch.testing.assert_close(b[key], a[key], rtol=0, atol=0)
    assert lazy.cfg.quantized_dense and lazy.device.type == "cpu"
    toks = torch.from_numpy(tokens(1, 8, vocab=512))
    with torch.no_grad():
        torch.testing.assert_close(lazy(toks), ref(toks), rtol=0, atol=0)


def test_registry_int8_bundle_builds_part_by_part(tmp_path):
    """A registry bundle with `quantize: int8` and no params.pt serves the
    same int8 weights as quantize_model of the seeded init."""
    from kubeflow_tpu_torch.serve import runtimes
    from kubeflow_tpu_torch.utils import registry as tr

    kw = {"dtype": "float32"}
    runtimes.export_for_serving(
        str(tmp_path), model="moe_tiny", model_kwargs=kw, seed=3,
        extra={"quantize": "int8",
               "generative": {"slots": 1, "max_len": 32, "chunk": 4,
                              "prefill_buckets": [8]}})
    served = runtimes.load_model(str(tmp_path), device="cpu")
    ref, _ = tr.build_model("moe_tiny", device="cpu", **kw)
    ref = tq.quantize_model(ref.init_weights(3)).state_dict()
    got = served._model.state_dict()
    assert sorted(got) == sorted(ref)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0)
    assert served.quantization["mode"] == "int8"
    served.load()
    try:
        out = served.generate({"input_ids": [5, 9, 2], "max_tokens": 4})
        assert len(out["output_ids"]) == 4
    finally:
        served.unload()


# -- refusals ------------------------------------------------------------------

def _jax_adapter_message():
    jcfg, _ = configs()
    x = jnp.zeros((1, 4, jcfg.hidden_size))
    with pytest.raises(ValueError) as err:
        jm.MoEBlock(jcfg).init(jax.random.key(0), x, adapter={})
    return str(err.value)


def test_mlp_adapters_are_refused_with_jax_words(tmp_path):
    """An adapter on the routed MLP: the block, multi-LoRA stacks and a
    PEFT import all raise JAX MoEBlock's message."""
    from kubeflow_tpu_torch.models.peft_import import load_peft_adapter
    from kubeflow_tpu_torch.serve.multilora import (build_adapter_stacks,
                                                    write_synthetic_adapter)

    message = _jax_adapter_message()
    assert message == tm.ADAPTER_REFUSAL
    _, _, tmod = pair()
    with pytest.raises(ValueError) as err:
        tmod.layers[0].mlp(torch.zeros(1, 4, 64), adapter={})
    assert str(err.value) == message
    ada = write_synthetic_adapter(tmod.cfg, str(tmp_path / "a"), seed=1,
                                  targets="attn_mlp")
    with pytest.raises(ValueError) as err:
        build_adapter_stacks({"a": ada}, tmod.cfg)
    assert str(err.value) == message
    with pytest.raises(ValueError) as err:
        load_peft_adapter(ada, tmod.cfg)
    assert str(err.value) == message
    attn = write_synthetic_adapter(tmod.cfg, str(tmp_path / "b"), seed=2)
    stacks, ids = build_adapter_stacks({"b": attn}, tmod.cfg)
    assert sorted(stacks) == ["q_proj", "v_proj"] and ids == {"b": 1}
    with open(os.path.join(attn, "adapter_config.json")) as f:
        assert json.load(f)["target_modules"] == ["q_proj", "v_proj"]


def test_trainer_refuses_moe_training_by_name():
    """Kept under its old name since MoE training landed: the trainer runs
    one moe_tiny step and logs a positive aux_loss (the Switch
    load-balance term), never a step without it
    (tests/test_torch_moe_train.py holds it against JAX)."""
    from kubeflow_tpu_torch.train import trainer as ttrainer

    spec = ttrainer.TrainJobSpec(model="moe_tiny", steps=1, batch_size=2,
                                 seq_len=8, dataset="synthetic_lm")
    result = ttrainer.Trainer(spec, device="cpu").run()
    assert result["final_step"] == 1
    assert np.isfinite(result["loss"]) and result["aux_loss"] > 0
