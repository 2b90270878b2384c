"""GPT-2 on the port (models/gpt2.py, hf_import.import_gpt2, the engine,
serve/quant.quantize_fixed) against the JAX package, both importing the
same HF directory, which the port's `save_safetensors` writes from weights
drawn with numpy (`gpt2_hf_tensors`: Conv1D layout, fused c_attn), so the
two importers are held too; `transformers` reads the same directory.

Tolerances (rel-L2 of fp32 logits): F32_TOL 1e-5 (the same math, fp32
rounding). Int8: codes and scales bit-equal to `quantize_tree`, logits
within F32_TOL of JAX's `QuantizedModule(dtype=float32)` (the same codes
dequantized in fp32) and within INT8_TOL 5e-3 of its default, which
dequantizes each weight to bf16 before a float matmul where the port
scales the W8A16 op's fp32 output (the A9.12 bound of
tests/test_torch_bert.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import gpt2 as jg
from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.serve import generation as jgen
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu.serve import runtimes as jrt
from kubeflow_tpu_torch.models import gpt2 as tg
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models.convert import gpt2_params_from_jax
from kubeflow_tpu_torch.models.llama import init_cache
from kubeflow_tpu_torch.serve import generation as tgen
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.serve.runtimes import load_model

F32_TOL = 1e-5
INT8_TOL = 5e-3
TINY = dict(vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hf_config(**widths) -> dict:
    return {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
            "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
            "n_inner": None, **widths}


def write_checkpoint(path, hf: dict, seed: int):
    """An HF GPT-2 dir of `hf`'s widths with numpy-drawn weights (tables
    N(0, 0.02), projections N(0, 1/fan_in), biases and LayerNorms
    perturbed so each term shows). Returns the port's fp32 config."""
    os.makedirs(path, exist_ok=True)
    cfg = th.gpt2_config_from_hf(hf, dtype="float32")
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in tg.GPT2(cfg, device="cpu").state_dict().items():
        if name in ("wte", "wpe"):
            arr = rng.normal(0, 0.02, p.shape)
        elif name.endswith(".weight"):
            arr = rng.normal(0, p.shape[1] ** -0.5, p.shape)
        elif name.endswith(".scale"):
            arr = 1 + rng.normal(0, 0.1, p.shape)
        else:
            arr = rng.normal(0, 0.05, p.shape)
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    th.save_safetensors(th.gpt2_hf_tensors(sd, cfg),
                        os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return cfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gpt2"))
    write_checkpoint(d, _hf_config(**TINY), seed=17)
    return d


def _models(path):
    cfg, sd = th.import_gpt2(path, dtype="float32")
    model = tg.GPT2(cfg, device="cpu")
    model.load_state_dict(sd)
    jcfg, jparams = jh.import_gpt2(path, dtype=jnp.float32)
    return model, jg.GPT2(jcfg), jcfg, jparams


def test_logits_and_cache_match_jax_and_transformers(ckpt):
    model, jmod, jcfg, jp = _models(ckpt)
    toks = np.random.default_rng(3).integers(0, 96, (2, 14))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    want = np.asarray(jmod.apply({"params": jp}, jnp.asarray(toks, jnp.int32)))
    assert rel_l2(got, want) <= F32_TOL
    hf = transformers.GPT2LMHeadModel.from_pretrained(
        ckpt, attn_implementation="eager").eval()
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    assert rel_l2(got, ref) <= 1e-4
    # Prefill 8, one decode step, then a continuation chunk of 4.
    cache = init_cache(model.cfg, 2, 32, device="cpu")
    jc = jg.init_cache(jcfg, 2, 32)
    with torch.no_grad():
        a, cache = model(torch.from_numpy(toks[:, :8]), cache=cache,
                         cache_index=torch.zeros(2, dtype=torch.int32))
        b, cache = model(torch.from_numpy(toks[:, 8:9]), cache=cache,
                         cache_index=torch.full((2,), 8, dtype=torch.int32))
        c, cache = model(torch.from_numpy(toks[:, 9:13]), cache=cache,
                         cache_index=torch.full((2,), 9, dtype=torch.int32),
                         positions=torch.arange(9, 13).expand(2, 4),
                         attend_full_cache=True)
    ja, jc = jmod.apply({"params": jp}, jnp.asarray(toks[:, :8], jnp.int32),
                        cache=jc, cache_index=jnp.zeros((2,), jnp.int32))
    jb_, jc = jmod.apply({"params": jp}, jnp.asarray(toks[:, 8:9], jnp.int32),
                         cache=jc, cache_index=jnp.full((2,), 8, jnp.int32))
    jcc, jc = jmod.apply({"params": jp}, jnp.asarray(toks[:, 9:13], jnp.int32),
                         cache=jc, cache_index=jnp.full((2,), 9, jnp.int32),
                         positions=jnp.broadcast_to(jnp.arange(9, 13), (2, 4)),
                         attend_full_cache=True)
    for g, w in ((a, ja), (b, jb_), (c, jcc)):
        assert rel_l2(g, w) <= F32_TOL
    assert rel_l2(c, want[:, 9:13]) <= F32_TOL  # cached == cache-free
    assert rel_l2(cache["k"][:, :, :13], np.asarray(jc["k"])[:, :, :13]) \
        <= F32_TOL
    # return_hidden gives ln_f's output; unembed finishes it.
    with torch.no_grad():
        hid = model(torch.from_numpy(toks), return_hidden=True)
        assert torch.allclose(model.unembed(hid), torch.from_numpy(got))
    hid_j = jmod.apply({"params": jp}, jnp.asarray(toks, jnp.int32),
                       return_hidden=True)[0]
    assert rel_l2(hid, hid_j) <= F32_TOL


def test_params_from_jax_equal_the_hf_import(ckpt):
    """convert.gpt2_params_from_jax over the flax tree that JAX's importer
    reads from the directory gives the port importer's state dict, tensor
    for tensor; a missing, left-over or mis-shaped leaf raises."""
    cfg, sd = th.import_gpt2(ckpt, dtype="float32")
    _, jparams = jh.import_gpt2(ckpt, dtype=jnp.float32)
    flat = jax.tree.map(np.asarray, jparams)
    got = gpt2_params_from_jax(flat, cfg)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="not consumed"):
        gpt2_params_from_jax(dict(flat, stray=np.zeros(3, np.float32)), cfg)
    missing = dict(flat)
    missing.pop("ln_f")
    with pytest.raises(ValueError, match="missing"):
        gpt2_params_from_jax(missing, cfg)
    with pytest.raises(ValueError, match="shape"):
        gpt2_params_from_jax(flat, dataclasses.replace(cfg, vocab_size=97))


def _bundle(src_dir, gen: dict, **spec):
    with open(os.path.join(src_dir, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "name": "gpt2",
                   "model_overrides": {"dtype": "float32",
                                       "param_dtype": "float32"},
                   "generative": gen, **spec}, f)
    return src_dir


def test_greedy_ids_through_load_model_equal_jax_runtime(tmp_path):
    """Greedy ids of the port's bundle equal the JAX runtime's on the same
    directory, across three seeds, with the JAX test's non-degeneracy
    guard; the paged engine gives the flat engine's ids."""
    gen = {"slots": 1, "max_len": 32, "chunk": 4, "prefill_buckets": [8]}
    nontrivial = 0
    for seed in (17, 18, 19):
        d = str(tmp_path / f"s{seed}")
        write_checkpoint(d, _hf_config(**TINY), seed)
        _bundle(d, gen)
        jmodel = jrt.load_model(d)
        model = load_model(d, device="cpu")
        assert isinstance(model._model, tg.GPT2)
        assert jmodel.load() and model.load()
        _bundle(d, dict(gen, kv_block_size=8))
        paged = load_model(d, device="cpu")
        assert paged.load()
        try:
            for prompt in ([5, 9, 2, 41], [17, 3], list(range(3, 15))):
                body = {"input_ids": prompt, "max_tokens": 8}
                want = jmodel.generate(body)["output_ids"]
                assert model.generate(body)["output_ids"] == want
                assert paged.generate(body)["output_ids"] == want
                nontrivial += len(set(want)) > 1
        finally:
            for m in (jmodel, model, paged):
                m.unload()
    assert nontrivial >= 1, "every reference degenerate: weak inputs"


def test_fixed_forward_bundle_equals_jax_runtime(ckpt):
    """Without a "generative" block a GPT-2 checkpoint serves full-forward
    logits behind :predict, as the JAX runtime's JAXModel does."""
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "seq_len": 12,
                   "batch_buckets": [1, 2], "warm_buckets": [1],
                   "model_overrides": {"dtype": "float32",
                                       "param_dtype": "float32"}}, f)
    try:
        jmodel, model = jrt.load_model(ckpt), load_model(ckpt, device="cpu")
        assert jmodel.load() and model.load()
        x = np.random.default_rng(4).integers(0, 96, (2, 12)).astype(np.int32)
        got, want = model.predict([x])[0], jmodel.predict([x])[0]
        assert got.shape == want.shape == (2, 12, 96)
        assert rel_l2(got, want) <= F32_TOL
    finally:
        os.remove(os.path.join(ckpt, "model.json"))


def test_engine_refuses_past_position_range(ckpt):
    model, jmod, jcfg, jp = _models(ckpt)  # n_positions 64
    with pytest.raises(ValueError, match="position range") as port:
        tgen.GenerationEngine(model, slots=1, max_len=128, chunk=4,
                              prefill_buckets=(8,))
    with pytest.raises(ValueError, match="position range") as ref:
        jgen.GenerationEngine(jmod, jp, jcfg, slots=1, max_len=128,
                              chunk=4, prefill_buckets=(8,))
    assert str(port.value).startswith(str(ref.value).split(";")[0])


@pytest.mark.parametrize("field,value", [
    ("activation_function", "relu"),
    ("scale_attn_weights", False),
    ("scale_attn_by_inverse_layer_idx", True),
    ("reorder_and_upcast_attn", True),
])
def test_config_refusals_match_jax(field, value):
    hf = dict(_hf_config(**TINY), **{field: value})
    with pytest.raises(ValueError) as port:
        th.config_from_hf(hf)
    with pytest.raises(ValueError) as ref:
        jh.gpt2_config_from_hf(hf)
    assert str(port.value) == str(ref.value)


def test_int8_codes_bit_equal_and_logits_near_jax(tmp_path):
    """quantize_fixed's codes and scales equal quantize_tree's, leaf by
    leaf (q/k/v one scale per (head, dim), o over (heads, dim), fc/proj
    per output, wte per vocab row, wpe per column once it reaches
    4096 elements; this config's 32 x 64 wpe stays float), and the int8
    logits sit within INT8_TOL of JAX's QuantizedModule."""
    d = str(tmp_path / "q")
    write_checkpoint(d, _hf_config(vocab_size=96, n_embd=64, n_layer=2,
                                   n_head=4, n_positions=32), seed=5)
    model, jmod, jcfg, jp = _models(d)
    tq.quantize_fixed(model)
    jtree = jq.quantize_tree(jp)
    assert isinstance(model.wte, tq.Int8Dense)
    assert isinstance(model.wpe, torch.nn.Parameter)
    assert not isinstance(jtree["wpe"], jq.Int8Leaf)
    leaf = jtree["wte"]
    assert np.array_equal(model.wte.q.numpy(), np.asarray(leaf.q))
    assert np.array_equal(model.wte.scale.numpy(),
                          np.asarray(leaf.scale)[:, 0])
    for i in range(2):
        blk, jblk = model.blocks[i], jtree[f"block_{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "fc", "proj"):
            mod, jl = getattr(blk, name), jblk[name]["kernel"]
            assert isinstance(mod, tq.Int8Dense) and isinstance(jl, jq.Int8Leaf)
            n_out = mod.q.shape[0]
            jq_ = np.asarray(jl.q).reshape(-1, n_out).T
            assert np.array_equal(mod.q.numpy(), jq_), name
            assert np.array_equal(mod.scale.numpy(),
                                  np.asarray(jl.scale).reshape(n_out)), name
            assert torch.equal(mod.bias, torch.from_numpy(
                np.array(jblk[name]["bias"]).reshape(n_out))), name
    toks = np.random.default_rng(9).integers(0, 96, (2, 12))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    jtoks = jnp.asarray(toks, jnp.int32)
    # The same codes dequantized in fp32 by JAX: the same function.
    want = jq.QuantizedModule(jmod, dtype=jnp.float32).apply(
        {"params": jtree}, jtoks)
    assert rel_l2(got, want) <= F32_TOL
    want = jq.QuantizedModule(jmod).apply({"params": jtree}, jtoks)
    assert rel_l2(got, want) <= INT8_TOL
    # The served int8 bundle: the same codes through the runtime.
    _bundle(d, {"slots": 1, "max_len": 32, "chunk": 4,
                "prefill_buckets": [8]}, quantize="int8")
    served = load_model(d, device="cpu")
    assert served.quantization["mode"] == "int8"
    assert isinstance(served._model.wte, tq.Int8Dense)


def test_engine_combinations_jax_refuses_are_refused(ckpt, tmp_path):
    """kv_quant (the JAX engine's decode scan fails on GPT-2 over a
    quantized pool) and multi-LoRA adapters or a folded peft_adapter (JAX's
    PEFT import takes only the Llama family) are refused with a ValueError
    at construction; the combinations JAX serves (a draft, a prefill/decode
    role pair, the host tier) serve the plain engine's ids."""
    from kubeflow_tpu_torch.models.llama import llama_tiny
    from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter

    model, jmod, jcfg, jp = _models(ckpt)
    kw = dict(slots=2, max_len=32, chunk=4, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="kv_quant.*GPT-2"):
        tgen.GenerationEngine(model, kv_block_size=8, kv_quant="int8", **kw)
    adapter = str(tmp_path / "ada")
    write_synthetic_adapter(dataclasses.replace(
        llama_tiny(), vocab_size=96, hidden_size=32, num_heads=4,
        num_kv_heads=4, head_dim=8, intermediate_size=128), adapter, 1)
    with pytest.raises(ValueError) as port:
        tgen.GenerationEngine(model, adapters={"a": adapter}, **kw)
    with pytest.raises(ValueError) as ref:
        jgen.GenerationEngine(jmod, jp, jcfg, adapters={"a": adapter}, **kw)
    assert str(port.value) == str(ref.value)
    assert "GPT2Config has no adapter path" in str(port.value)
    _bundle(ckpt, dict(kw), peft_adapter=adapter)
    with pytest.raises(ValueError, match="GPT2Config has no adapter path"):
        load_model(ckpt, device="cpu")
    os.remove(os.path.join(ckpt, "model.json"))

    prompt = list(range(3, 15))
    plain = tgen.GenerationEngine(model, **kw)
    spec = tgen.GenerationEngine(model, draft={"model": model, "gamma": 2},
                                 **kw)
    tier = tgen.GenerationEngine(model, kv_block_size=8, prefix_cache=4,
                                 kv_host_tier_blocks=16, **kw)
    pre = tgen.GenerationEngine(model, kv_block_size=8, role="prefill", **kw)
    dec = tgen.GenerationEngine(model, kv_block_size=8, role="decode", **kw)
    try:
        want = plain.submit(prompt, max_tokens=8)["output_ids"]
        assert spec.submit(prompt, max_tokens=8)["output_ids"] == want
        assert spec.stats_snapshot()["spec_dispatches"] > 0
        for _ in range(2):
            assert tier.submit(prompt, max_tokens=8)["output_ids"] == want
        assert tier.stats_snapshot()["prefix_hits"] == 1
        frame = pre.prefill_ship(prompt, max_tokens=8)
        assert dec.submit_remote(frame["shipment"])["output_ids"] == want
    finally:
        for e in (plain, spec, tier, pre, dec):
            e.close()


def test_registry_and_trainer():
    from kubeflow_tpu.utils import registry as jreg
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainJobSpec
    from kubeflow_tpu_torch.utils import registry as treg

    module, info = treg.build_model("gpt2_tiny", device="cpu")
    _, jinfo = jreg.build_model("gpt2_tiny")
    assert isinstance(module, tg.GPT2)
    assert {k: info[k] for k in ("task", "example_shape", "example_dtype",
                                 "num_params", "vocab_size")} == {
        k: jinfo[k] for k in ("task", "example_shape", "example_dtype",
                              "num_params", "vocab_size")}
    with pytest.raises(ValueError, match="GPT-2 training.*ROADMAP A8.1"):
        Trainer(TrainJobSpec(model="gpt2_tiny", steps=1), device="cpu")
