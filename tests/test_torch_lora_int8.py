"""A config's own LoRA adapters on int8 projections (`lora_rank` with
`quantized_dense`) against JAX's `QuantizedModule` on the same weights,
fp32 on the CPU: logits within the Llama tests' 2e-4 and greedy ids equal
(a cache-free greedy loop on both sides), for the "attn" and "attn_mlp"
targets; then through an int8 generative registry bundle whose
model_kwargs carry lora_rank, its engine's greedy ids equal the same
loop's. The adapters are below quantize_tree's 4096-element size here,
so both packages keep them float."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.quant import Int8Dense, quantize_model
from kubeflow_tpu_torch.serve.runtimes import export_for_serving, load_model

TOL = dict(atol=2e-4, rtol=2e-4)
KW = {"num_layers": 2, "lora_rank": 4, "lora_alpha": 8.0}


def _pair(targets):
    """(JAX QuantizedModule, quantize_tree params, port float model, port
    int8 model) of one init with non-zero adapters."""
    kw = dict(KW, lora_targets=targets)
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32, **kw)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(
        jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + 0.05 * rng.normal(size=x.shape).astype(x.dtype)
                         if "lora_b" in str(path[-1]) else x), params)
    sd = llama_params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    port = tl.Llama(tcfg, device="cpu")
    port.load_state_dict(sd)
    port8 = tl.Llama(tcfg, device="cpu")
    port8.load_state_dict(sd)
    quantize_model(port8.eval())
    return jq.QuantizedModule(jm), jq.quantize_tree(params), port, port8


PROMPT, NEW, WIDTH = [5, 9, 2, 11], 6, 16


@pytest.fixture(scope="module", params=["attn", "attn_mlp"])
def pair(request):
    return _pair(request.param)


def _greedy(step, prompt=PROMPT, n=NEW):
    """Greedy ids of a cache-free loop: each step runs the causal model
    over the ids so far, right-padded to WIDTH (one shape, one compile),
    and takes the argmax at the last real position."""
    ids = list(prompt)
    for _ in range(n):
        x = np.zeros((1, WIDTH), np.int64)
        x[0, :len(ids)] = ids
        ids.append(int(np.argmax(step(x)[0, len(ids) - 1])))
    return ids[len(prompt):]


def _jax_step(qm, qtree):
    fn = jax.jit(lambda x: qm.apply({"params": qtree}, x))
    return lambda x: np.asarray(fn(jnp.asarray(x, jnp.int32)))


def _port_step(model):
    def step(x):
        with torch.no_grad():
            return model(torch.from_numpy(x)).numpy()
    return step


def test_logits_and_greedy_ids_match_jax(pair):
    qm, qtree, port, port8 = pair
    assert isinstance(port8.layers[0].attn.q_proj, Int8Dense)
    assert port8.layers[0].attn.q_proj_lora_a.dtype == torch.float32
    ids = np.random.default_rng(3).integers(0, 512, (2, WIDTH))
    jstep, step = _jax_step(qm, qtree), _port_step(port8)
    np.testing.assert_allclose(step(ids), jstep(ids), **TOL)
    assert _greedy(step) == _greedy(jstep)
    with torch.no_grad():  # the adapters matter: int8 minus LoRA differs
        base = step(ids)
        saved = {}
        for name, p in port8.named_parameters():
            if name.endswith("_lora_b"):
                saved[name] = p.clone()
                p.zero_()
        assert not np.allclose(base, step(ids), atol=1e-3)
        for name, p in port8.named_parameters():
            if name in saved:
                p.copy_(saved[name])


def test_int8_generative_bundle_with_lora_rank(tmp_path, pair):
    qm, qtree, port, _ = pair
    d = str(tmp_path / "b")
    export_for_serving(
        d, model="llama_tiny", params=port,
        model_kwargs={"dtype": "float32", **KW,
                      "lora_targets": port.cfg.lora_targets},
        extra={"quantize": "int8",
               "generative": {"slots": 2, "max_len": 32,
                              "prefill_buckets": [8]}})
    model = load_model(d, device="cpu")
    assert model.quantization["mode"] == "int8"
    model.load()
    try:
        got = model.generate({"input_ids": PROMPT, "max_tokens": NEW})
        assert got["output_ids"] == _greedy(_jax_step(qm, qtree))
    finally:
        model.unload()
