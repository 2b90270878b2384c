"""Port int8 weight quantization (`serve/quant.py` weight half) against the
JAX `quantize_tree` / `QuantizedModule` on the same weights (fp32, CPU),
the runtime's `quantize` key, and the port's own guard that an int8 decode
step makes no weight-shaped or cache-width multiply."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.ops import quant_matmul as tqm
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.serve.runtimes import export_for_serving, load_model

# fp32 on both sides; the JAX dot and the port's matmul sum in different
# orders, as the float model's parity tests allow (2e-4 there).
LOGITS_RTOL = 1e-5


def numpy_tree(tree):
    """A (possibly quantized) JAX param tree with numpy leaves and each
    Int8Leaf flattened to {"q", "scale"} — what the port's converter
    takes."""
    return jax.tree.map(
        lambda leaf: ({"q": np.asarray(leaf.q),
                       "scale": np.asarray(leaf.scale)}
                      if isinstance(leaf, jq.Int8Leaf) else np.asarray(leaf)),
        tree, is_leaf=lambda x: isinstance(x, jq.Int8Leaf))


def _pair(**kw):
    """(JAX module, JAX float params, port float model) on one init."""
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               num_layers=2, **kw)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=2, **kw)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(
        jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tl.Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(numpy_tree(params), tcfg))
    return jm, params, tm


@pytest.fixture(scope="module", params=["untied", "tied"])
def quantized(request):
    """(QuantizedModule, quantize_tree params, port model quantized in
    place from the same float weights)."""
    jm, params, tm = _pair(tie_embeddings=request.param == "tied")
    return jq.QuantizedModule(jm), jq.quantize_tree(params), \
        tq.quantize_model(tm)


def test_codes_and_scales_equal_quantize_tree(quantized):
    """Every Int8Leaf of quantize_tree, carried across by the converter,
    is bit-equal to what quantize_model made from the float weights —
    including k_proj/v_proj, whose per-layer weight (2048 elements) is
    below min_size but whose stacked [L, ...] leaf is not."""
    _, qparams, tm = quantized
    want = llama_params_from_jax(numpy_tree(qparams), tm.cfg)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    n_int8 = 0
    for name, tensor in got.items():
        assert tensor.dtype == want[name].dtype, name
        assert torch.equal(tensor, want[name]), name
        n_int8 += tensor.dtype == torch.int8
    expect = 7 * tm.cfg.num_layers + 1 + (tm.lm_head is not None)
    assert n_int8 == expect
    assert isinstance(tm.layers[0].attn.k_proj, tq.Int8Dense)


def test_embedding_scale_axis(quantized):
    """The embedding's scales are per vocab row ([V, 1] in JAX), also when
    it is the tied unembedding."""
    _, qparams, tm = quantized
    leaf = qparams["embed"]
    assert isinstance(leaf, jq.Int8Leaf)
    assert leaf.scale.shape == (tm.cfg.vocab_size, 1)
    np.testing.assert_array_equal(tm.embed.scale.numpy(),
                                  np.asarray(leaf.scale)[:, 0])
    np.testing.assert_array_equal(tm.embed.q.numpy(), np.asarray(leaf.q))


def test_quantized_bytes_equal_jax(quantized):
    _, qparams, tm = quantized
    assert tq.quantized_bytes(tm) == jq.quantized_bytes(qparams)


def test_int8_logits_match_quantized_module(quantized):
    jm, qparams, tm = quantized
    toks = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
    want = np.asarray(jm.apply({"params": qparams}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL,
                               atol=LOGITS_RTOL * np.abs(want).max())


def test_converted_tree_loads_into_a_quantized_dense_model(quantized):
    """Llama(cfg with quantized_dense) builds Int8Dense at every site; the
    converted quantize_tree state dict loads into it and gives the same
    logits as the model quantized in place."""
    _, qparams, tm = quantized
    fresh = tl.Llama(tm.cfg, device="cpu")
    fresh.load_state_dict(llama_params_from_jax(numpy_tree(qparams),
                                                tm.cfg))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (1, 9)))
    with torch.no_grad():
        assert torch.equal(fresh(toks), tm(toks))
    with pytest.raises(ValueError, match="float model"):
        fresh.init_weights(0)
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize_model(fresh)


def test_small_projections_stay_float():
    """The size rule is quantize_tree's: below min_size (stacked over the
    layers) a projection keeps its float weight; norm scales never
    quantize."""
    _, _, tm = _pair()
    tq.quantize_model(tm, min_size=8193)  # q_proj: 2 x 4096 elements
    attn = tm.layers[0].attn
    assert isinstance(attn.q_proj, tl.Dense)
    assert isinstance(attn.k_proj, tl.Dense)
    assert isinstance(tm.layers[0].mlp.gate_proj, tq.Int8Dense)
    assert tm.layers[0].input_norm.scale.dtype == torch.float32


# -- the guard: no weight-shaped or cache-width multiply in a decode step --


class _MulShapes(TorchDispatchMode):
    """Records the output shape of every aten multiply."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.mul, torch.ops.aten.mul_):
            self.shapes.append(tuple(out.shape))
        return out


def _decode_step_mul_shapes(tm):
    """One int8-weight decode step on an int8 KV cache of 2 rows x 16."""
    cfg = tm.cfg
    cache = tl.init_cache(cfg, 2, 16, kv_quant="int8", device="cpu")
    with torch.no_grad():
        tm(torch.tensor([[3, 9, 4, 1], [7, 7, 2, 5]]), cache=cache)
        rec = _MulShapes()
        with rec:
            tm(torch.tensor([[11], [12]]), cache=cache,
               cache_index=torch.tensor([4, 4], dtype=torch.int32))
    return rec.shapes


def _violations(tm, shapes):
    weights = {tuple(m.q.shape) for m in tm.modules()
               if isinstance(m, tq.Int8Dense)}
    weights |= {s[::-1] for s in weights}
    cache_width = (16, tm.cfg.num_kv_heads, tm.cfg.head_dim)
    return [s for s in shapes
            if s[-2:] in weights or s[-3:] == cache_width]


@pytest.fixture(scope="module")
def int8_model():
    _, _, tm = _pair()
    return tq.quantize_model(tm)


def test_decode_step_has_no_weight_shaped_multiply(int8_model):
    shapes = _decode_step_mul_shapes(int8_model)
    assert shapes, "the step made no multiply at all: the guard sees nothing"
    assert _violations(int8_model, shapes) == []


def test_guard_catches_a_weight_side_dequant(int8_model, monkeypatch):
    """Red switch: dequantizing the weight before the matmul (the JAX
    package's old placement) makes [out, in] multiplies the guard
    reports; so does dequantizing the cache before attention."""
    def weight_side(self, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), (self.q.float() * self.scale[:, None]
                                   ).to(cd))

    monkeypatch.setattr(tq.Int8Dense, "forward", weight_side)
    assert _violations(int8_model, _decode_step_mul_shapes(int8_model))
    monkeypatch.undo()

    real = tl.naive_attention

    def cache_side(q, k, v, *, k_scale=None, v_scale=None, **kw):
        if k_scale is not None:
            k = k * k_scale[..., None]
            v = v * v_scale[..., None]
        return real(q, k, v, **kw)

    monkeypatch.setattr(tl, "naive_attention", cache_side)
    assert _violations(int8_model, _decode_step_mul_shapes(int8_model))


# -- the runtime ------------------------------------------------------------

GEN = {"slots": 2, "max_len": 64, "chunk": 4, "prefill_buckets": [8, 16]}
KW = {"dtype": "float32", "num_layers": 2}


def test_runtime_quantize_serves_weight_only(tmp_path, monkeypatch):
    """quantize: int8 loads, quantizes, reports its bytes in the metadata
    and serves — without ever calling the W8A8 op."""
    def refuse(*a, **k):
        raise AssertionError("weight-only serving called int8_matmul")

    monkeypatch.setattr(tqm, "int8_matmul", refuse)
    monkeypatch.setattr(tqm, "_int8_matmul_plain", refuse)
    bundle = export_for_serving(str(tmp_path), model="llama_tiny",
                                model_kwargs=KW, seed=3,
                                extra={"generative": GEN, "quantize": "int8"})
    model = load_model(bundle, device="cpu")
    assert isinstance(model._model.layers[0].mlp.up_proj, tq.Int8Dense)
    md = model.metadata()
    assert md["quantize"]["mode"] == "int8"
    assert md["quantize"] == {"mode": "int8",
                              **tq.quantized_bytes(model._model)}
    assert md["quantize"]["quantized"] < 0.6 * md["quantize"]["full"]
    model.load()
    try:
        out = model.generate({"input_ids": [5, 9, 2], "max_tokens": 5})
        assert len(out["output_ids"]) == 5
    finally:
        model.unload()


def test_runtime_rejects_unknown_mode(tmp_path):
    bundle = export_for_serving(str(tmp_path), model="llama_tiny",
                                model_kwargs=KW,
                                extra={"generative": GEN, "quantize": "fp4"})
    with pytest.raises(ValueError, match="quantize"):
        load_model(bundle, device="cpu")
