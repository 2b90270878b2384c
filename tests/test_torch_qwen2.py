"""Qwen2 on the port's Llama trunk (QKV biases, `attention_bias`) against the
JAX package and `transformers` on the CPU: a tiny checkpoint in Qwen2-7B's
published config layout, written with the port's `save_safetensors`, with
biases drawn nonzero. The import against JAX's (tensors equal, logits
within 2e-4) and transformers' Qwen2 model; the bias's rounding point in
bf16 against the JAX model; int8 weights with float biases against
QuantizedModule on quantize_tree's codes; the engine with a multi-LoRA
adapter row against the JAX engine; the huggingface runtime's greedy ids
against transformers' generate."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.serve import generation as jg
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve import generation as tg
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter
from kubeflow_tpu_torch.serve.runtimes import load_model
from tests.test_torch_gemma import TINY_HF, TOL, HF_TOL, write_checkpoint
from tests.test_torch_rolling_window import _counters, _prompt, _run

#: Qwen/Qwen2-7B's config.json at the tests' widths.
QWEN2 = {"architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
         "bos_token_id": 1, "eos_token_id": 1, "hidden_act": "silu",
         "initializer_range": 0.02, "max_window_layers": 28,
         "model_type": "qwen2", "num_hidden_layers": 2, "rms_norm_eps": 1e-06,
         "rope_theta": 1000000.0, "sliding_window": 131072,
         "tie_word_embeddings": False, "torch_dtype": "bfloat16",
         "use_cache": True, "use_sliding_window": False, **TINY_HF}


@pytest.fixture(scope="module")
def qwen2(tmp_path_factory):
    """(checkpoint dir, the port model whose weights it holds)."""
    d = str(tmp_path_factory.mktemp("qwen2") / "ckpt")
    cfg = th.llama_config_from_hf(QWEN2, dtype="float32")
    model = tl.Llama(cfg, device="cpu").init_weights(3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".bias", ".scale")):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    return write_checkpoint(d, model, QWEN2), model


def _tokens(s=12, seed=9):
    return np.random.default_rng(seed).integers(0, 128, (2, s))


def _jax(d, **kw):
    return jh.build_from_hf(d, dtype=jnp.float32, param_dtype=jnp.float32,
                            **kw)


def test_config_maps_qwen2():
    cfg = th.llama_config_from_hf(QWEN2)
    assert cfg.attention_bias and not cfg.tie_embeddings
    # use_sliding_window false: the window is not a mask.
    assert (cfg.mask_kind, cfg.mask_window) == ("causal", 0)
    assert cfg.num_params == jh.llama_config_from_hf(QWEN2).num_params


def test_import_matches_jax(qwen2):
    d, model = qwen2
    cfg, sd = th.build_from_hf(d, dtype="float32")
    jmod, jcfg, params = _jax(d)
    assert cfg.attention_bias and jcfg.attention_bias
    ref = llama_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    assert sd["layers.0.attn.k_proj.bias"].shape == (16,)
    toks = _tokens()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_import_matches_transformers(qwen2):
    d, model = qwen2
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        d, torch_dtype=torch.float32, attn_implementation="eager").eval()
    toks = torch.from_numpy(_tokens())
    with torch.no_grad():
        np.testing.assert_allclose(model(toks).numpy(),
                                   hf(toks).logits.numpy(), **HF_TOL)


def test_bf16_bias_is_added_after_the_rounded_product(qwen2):
    """bf16 serving: the product is rounded to bf16, then the bias, cast
    to bf16, is added (DenseGeneral's order), so the port's q/k/v
    projections are bit-equal to JAX's on the same bf16 inputs."""
    d, _ = qwen2
    cfg, sd = th.build_from_hf(d, dtype="bfloat16")
    tm = tl.Llama(cfg, device="cpu")
    tm.load_state_dict(sd)
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    proj = tm.layers[0].attn.q_proj
    with torch.no_grad():
        got = proj(x)
    w = jnp.asarray(proj.weight.detach().float().numpy(), jnp.bfloat16)
    b = jnp.asarray(proj.bias.detach().float().numpy(), jnp.bfloat16)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = jnp.einsum("bsd,od->bso", xj, w) + b
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_keeps_biases_float_and_matches_jax(qwen2):
    d, _ = qwen2
    cfg, sd = th.build_from_hf(d, dtype="float32")
    tm = tl.Llama(cfg, device="cpu")
    tm.load_state_dict(sd)
    qt = tq.quantize_model(tm, min_size=512)
    q = qt.layers[1].attn.v_proj
    assert isinstance(q, tq.Int8Dense) and q.bias.dtype == torch.float32
    torch.testing.assert_close(q.bias, sd["layers.1.attn.v_proj.bias"])
    jmod, jcfg, params = _jax(d)
    qparams = jq.quantize_tree(params, min_size=512)
    assert not isinstance(qparams["layers"]["attn"]["v_proj"]["bias"],
                          jq.Int8Leaf)
    assert tq.quantized_bytes(qt) == jq.quantized_bytes(qparams)
    toks = _tokens(seed=5)
    want = np.asarray(jq.QuantizedModule(jmod, jnp.float32).apply(
        {"params": qparams}, jnp.asarray(toks)))
    with torch.no_grad():
        got = qt(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # A quantized model built from its own state dict takes the biases.
    again = tl.Llama(qt.cfg, device="cpu")
    again.load_state_dict(qt.state_dict())
    with torch.no_grad():
        np.testing.assert_array_equal(
            again(torch.from_numpy(toks)).numpy(), got)


def test_multilora_engine_matches_jax(qwen2, tmp_path):
    """A base row and an adapter row at once, then the adapter row alone,
    through the JAX engine and the port's on the same checkpoint and
    adapter: ids and counters equal."""
    d, model = qwen2
    ada = write_synthetic_adapter(model.cfg, str(tmp_path / "ada"), 21, r=8,
                                  alpha=400.0, targets="attn_mlp")
    jmod, jcfg, params = _jax(d)
    kw = dict(slots=2, max_len=32, chunk=4, prefill_buckets=(16,),
              adapters={"ada": ada})
    requests = [(_prompt(1, 9), dict(max_tokens=10)),
                (_prompt(2, 6), dict(max_tokens=12, adapter="ada"))]
    sides = {"port": tg.GenerationEngine(model, **kw),
             "jax": jg.GenerationEngine(jmod, params, jcfg, **kw)}
    out = {}
    try:
        for side, eng in sides.items():
            out[side] = (_run(eng, requests),
                         eng.submit(*requests[1][:1],
                                    **requests[1][1])["output_ids"],
                         _counters(eng))
    finally:
        for eng in sides.values():
            eng.close()
    assert out["port"] == out["jax"]
    base = tg.GenerationEngine(model, **dict(kw, adapters=None))
    try:
        plain = base.submit(requests[1][0], max_tokens=12)["output_ids"]
    finally:
        base.close()
    assert plain != out["port"][1]  # the adapter changes the ids


def test_runtime_serves_a_qwen2_bundle(qwen2, tmp_path):
    """The huggingface bundle through load_model: greedy ids equal
    transformers' generate on the same checkpoint."""
    d, _ = qwen2
    with open(os.path.join(d, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "name": "qwen2",
                   "model_overrides": {"dtype": "float32"},
                   "generative": {"slots": 2, "max_len": 32, "chunk": 4,
                                  "prefill_buckets": [16]}}, f)
    prompt = [3, 5, 7, 11]
    served = load_model(d, device="cpu")
    assert served.load()
    try:
        got = served.generate({"input_ids": prompt,
                               "max_tokens": 8})["output_ids"]
    finally:
        served.unload()
        os.remove(os.path.join(d, "model.json"))
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        d, torch_dtype=torch.float32).eval()
    with torch.no_grad():
        want = hf.generate(torch.tensor([prompt]), max_new_tokens=8,
                           do_sample=False, pad_token_id=0)[0, 4:].tolist()
    assert got == want
