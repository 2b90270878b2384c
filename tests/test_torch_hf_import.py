"""HF Llama-family import onto the port (models/hf_import.py) against the
JAX importer and `transformers` on the same tiny checkpoints, in fp32:
the imported tensors equal the JAX import's (through models/convert.py)
bit for bit; logits match the JAX Llama and transformers' own model
(atol 2e-4, rtol 2e-3, the JAX test's bound; against the JAX model 1e-5);
tied embeddings, Llama 3.1 rope scaling, the Mistral and Qwen2 config
mappings, the huggingface serving runtime, and every refusal by name. The
Gemma 1/2/3 and Qwen2 importers are held in tests/test_torch_gemma.py and
tests/test_torch_qwen2.py."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models.moe import MoEConfig
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.runtimes import load_model

TOL = dict(atol=2e-4, rtol=2e-3)  # vs transformers (the JAX test's)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)  # vs the JAX model, same math
F32 = {"dtype": "float32"}


def _save(tmp, name, seed=0, **kw):
    cfg = transformers.LlamaConfig(**{
        "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "max_position_embeddings": 128, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
        "attn_implementation": "eager", **kw})
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(cfg).eval()
    d = str(tmp / name)
    model.save_pretrained(d, safe_serialization=True)
    return d, model


@pytest.fixture(scope="module")
def hf_llama(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("hf"), "llama")


def _port(path, **over):
    cfg, sd = th.import_llama(path, **{**F32, **over})
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    return cfg, sd, model.eval()


def _jax(path):
    jcfg, params = jh.import_llama(path, dtype=jnp.float32,
                                   param_dtype=jnp.float32, remat=False,
                                   attention_impl="naive")
    return jcfg, params


def _tokens(n, width, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, width))


def test_tensors_equal_the_jax_import(hf_llama):
    path, _ = hf_llama
    cfg, sd, _ = _port(path)
    jcfg, params = _jax(path)
    ref = llama_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


def test_logits_match_jax_and_transformers(hf_llama):
    path, tmodel = hf_llama
    cfg, _, model = _port(path)
    assert (cfg.num_kv_heads, cfg.num_layers, cfg.head_dim) == (2, 2, 16)
    jcfg, params = _jax(path)
    toks = _tokens(2, 17)
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
        ref = tmodel(torch.from_numpy(toks)).logits.numpy()
    jax_out = np.asarray(jl.Llama(jcfg).apply({"params": params},
                                              jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jax_out, **JAX_TOL)


def test_sharded_checkpoint_equals_single_file(hf_llama, tmp_path):
    path, tmodel = hf_llama
    d = str(tmp_path / "sharded")
    tmodel.save_pretrained(d, safe_serialization=True, max_shard_size="60KB")
    assert os.path.exists(os.path.join(d, th.INDEX_FILE))
    assert len(th.safetensors_files(d)) > 1
    _, single, _ = _port(path)
    _, sharded, _ = _port(d)
    assert sorted(single) == sorted(sharded)
    for k in single:
        assert torch.equal(single[k], sharded[k]), k


def test_tied_embeddings(tmp_path):
    path, tmodel = _save(tmp_path, "tied", seed=1, vocab_size=128,
                         hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2,
                         tie_word_embeddings=True)
    cfg, sd, model = _port(path)
    assert cfg.tie_embeddings and "lm_head.weight" not in sd
    jcfg, params = _jax(path)
    toks = np.arange(10)[None] % 128
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
        ref = tmodel(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, np.asarray(jl.Llama(jcfg).apply(
        {"params": params}, jnp.asarray(toks, jnp.int32))), **JAX_TOL)


def test_llama31_rope_scaling(tmp_path):
    """Llama 3.1's 'llama3' frequency remap, at lengths where the scaled
    low frequencies matter."""
    path, tmodel = _save(
        tmp_path, "l31", seed=2, vocab_size=128, hidden_size=32,
        intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=256,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64})
    cfg, _, model = _port(path)
    assert cfg.rope_scaling_factor == 8.0
    assert cfg.rope_scaling_original_max_len == 64
    toks = (np.arange(200)[None] * 7) % 128
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
        ref = tmodel(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=2e-3)
    jcfg, params = _jax(path)
    np.testing.assert_allclose(got, np.asarray(jl.Llama(jcfg).apply(
        {"params": params}, jnp.asarray(toks, jnp.int32))), **JAX_TOL)


BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2)


@pytest.mark.parametrize("name,hf", [
    ("llama3", dict(BASE, num_key_value_heads=1, rope_theta=500000.0,
                    max_position_embeddings=8192, rms_norm_eps=1e-6,
                    rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                  "original_max_position_embeddings": 8192})),
    ("mistral", dict(BASE, model_type="mistral", sliding_window=4096,
                     head_dim=8)),
    ("qwen2_window_off", dict(BASE, model_type="qwen2", sliding_window=4096,
                              use_sliding_window=False)),
    ("tied", dict(BASE, tie_word_embeddings=True)),
])
def test_config_mapping_equals_jax(name, hf):
    """Every LlamaConfig field both packages have maps to the same value
    (the dtypes aside)."""
    got = th.llama_config_from_hf(hf)
    ref = jh.llama_config_from_hf(hf)
    shared = (set(f for f in vars(got)) & set(f for f in vars(ref))) - {
        "dtype", "param_dtype"}
    assert len(shared) > 20
    for f in sorted(shared):
        assert getattr(got, f) == getattr(ref, f), f
    if name == "mistral":
        assert (got.mask_kind, got.mask_window) == ("sliding_window", 4096)


def test_mistral_serving_is_refused_by_name(tmp_path):
    """A Mistral checkpoint served past its window (8 of a 32-token
    context): build_from_hf maps `sliding_window`, the engine rolls its
    cache, and a 12-token prompt's 10 greedy ids equal
    transformers.MistralForCausalLM's generate (the JAX
    tests/test_mistral_import.py case). The name is kept for continuity
    from when the port refused such checkpoints by name; it now serves
    them."""
    from kubeflow_tpu_torch.serve.generation import GenerationEngine

    torch.manual_seed(9)
    hf = transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, rope_theta=10000.0,
        rms_norm_eps=1e-5, sliding_window=8,
        attn_implementation="eager")).eval()
    d = str(tmp_path / "mistral")
    hf.save_pretrained(d, safe_serialization=True)
    cfg, sd = th.build_from_hf(d, **F32)
    assert (cfg.mask_kind, cfg.mask_window) == ("sliding_window", 8)
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    prompt = [int(t) for t in np.random.default_rng(4).integers(0, 256, 12)]
    eng = GenerationEngine(model, slots=1, max_len=32, chunk=4,
                           prefill_buckets=(4,))
    try:
        assert eng._rolling == 8 and eng.decode_buckets == [8]
        got = eng.submit(prompt, max_tokens=10)["output_ids"]
    finally:
        eng.close()
    with torch.no_grad():
        ref = hf.generate(torch.tensor([prompt]), max_new_tokens=10,
                          do_sample=False, pad_token_id=0)[0, len(prompt):]
    assert got == ref.tolist()


def test_unsupported_configs_fail_loudly(hf_llama, tmp_path):
    with pytest.raises(ValueError, match="rope_scaling"):
        th.llama_config_from_hf(dict(BASE, rope_scaling={
            "rope_type": "yarn", "factor": 4.0}))
    with pytest.raises(ValueError, match="scan_layers"):
        th.llama_config_from_hf(BASE, scan_layers=True)
    # A Qwen2 config implies QKV biases: the import reads them and equals
    # the JAX import.
    path, _ = hf_llama
    d = str(tmp_path / "qwen")
    shutil.copytree(path, d)
    hf = json.load(open(os.path.join(d, "config.json")))
    hf.update(model_type="qwen2", architectures=["Qwen2ForCausalLM"])
    hf.pop("attention_bias")
    json.dump(hf, open(os.path.join(d, "config.json"), "w"))
    t = dict(th.load_safetensors(os.path.join(d, "model.safetensors")))
    gen = torch.Generator().manual_seed(3)
    for i in range(2):
        for p, n in (("q_proj", 64), ("k_proj", 32), ("v_proj", 32)):
            t[f"model.layers.{i}.self_attn.{p}.bias"] = torch.randn(
                n, generator=gen)
    th.save_safetensors(t, os.path.join(d, "model.safetensors"))
    cfg, sd = th.build_from_hf(d, **F32)
    assert cfg.attention_bias
    _, jcfg, params = jh.build_from_hf(d, dtype=jnp.float32,
                                       param_dtype=jnp.float32)
    ref = llama_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k


def test_missing_lm_head_fails_loudly(hf_llama, tmp_path):
    path, _ = hf_llama
    d = tmp_path / "broken"
    shutil.copytree(path, d)
    t = th.load_safetensors(str(d / "model.safetensors"))
    t.pop("lm_head.weight")
    th.save_safetensors(t, str(d / "model.safetensors"))
    with pytest.raises(KeyError, match="lm_head"):
        th.import_llama(str(d))
    with pytest.raises(KeyError, match="lm_head"):
        jh.import_llama(str(d))
    t.pop("model.layers.1.mlp.up_proj.weight")
    hf = json.load(open(d / "config.json"))
    hf["tie_word_embeddings"] = True
    json.dump(hf, open(d / "config.json", "w"))
    th.save_safetensors(t, str(d / "model.safetensors"))
    with pytest.raises(KeyError, match="layers.1.mlp.up_proj"):
        th.import_llama(str(d))


@pytest.mark.parametrize("arch,model_type,what,item", [
    ("MixtralForCausalLM", "mixtral", "Mixtral", "A8"),
    ("Qwen2MoeForCausalLM", "qwen2_moe", "Qwen2-MoE", "A8"),
    ("BertForSequenceClassification", "bert", "BERT", "A8"),
    ("GPT2LMHeadModel", "gpt2", "GPT-2", "A8"),
    ("T5ForConditionalGeneration", "t5", "T5", "A8"),
    ("UMT5ForConditionalGeneration", "umt5", "T5", "A8"),
    ("LongT5ForConditionalGeneration", "longt5", "T5 catch-all", "A8"),
])
def test_unported_families_are_refused_by_name(tmp_path, arch, model_type,
                                               what, item):
    hf = dict(BASE, architectures=[arch], model_type=model_type)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    if what == "BERT":
        # Ported since (import_bert, tests/test_torch_bert.py): BERT is
        # dispatched first and goes on to read its tensors.
        assert isinstance(th.config_from_hf(hf), th.BertConfig)
        with pytest.raises(FileNotFoundError, match="safetensors"):
            th.build_from_hf(str(tmp_path))
        return
    if what in ("Mixtral", "Qwen2-MoE"):
        # Ported since (models/moe.py, tests/test_torch_moe_import.py):
        # an MoE config is dispatched and goes on to read its tensors.
        hf.update(num_local_experts=4, num_experts=4, num_experts_per_tok=2,
                  moe_intermediate_size=32,
                  shared_expert_intermediate_size=64)
        with open(tmp_path / "config.json", "w") as f:
            json.dump(hf, f)
        assert isinstance(th.config_from_hf(hf), MoEConfig)
        with pytest.raises(FileNotFoundError, match="safetensors"):
            th.build_from_hf(str(tmp_path))
        return
    if what in ("GPT-2", "T5"):
        # Ported since (models/gpt2.py, models/t5.py; tests/test_torch_gpt2
        # .py, test_torch_t5.py): dispatched in JAX's order, right after
        # BERT, and the import goes on to read its tensors.
        hf.update(n_embd=64, n_layer=2, n_head=4, d_model=64, d_kv=16,
                  d_ff=128, num_layers=2, num_heads=4)
        with open(tmp_path / "config.json", "w") as f:
            json.dump(hf, f)
        want = th.GPT2Config if what == "GPT-2" else th.T5Config
        cfg = th.config_from_hf(hf)
        assert isinstance(cfg, want)
        if what == "T5":
            assert cfg.per_layer_rel_bias == (model_type == "umt5")
        with pytest.raises(FileNotFoundError, match="safetensors"):
            th.build_from_hf(str(tmp_path))
        with pytest.raises(FileNotFoundError):  # JAX's import reads too
            jh.build_from_hf(str(tmp_path))
        return
    # Other T5 variants: JAX's catch-all ValueError, after Qwen2-MoE.
    with pytest.raises(ValueError, match="unsupported T5-family "
                                         "architecture.*T5/MT5/UMT5"):
        th.build_from_hf(str(tmp_path))
    with pytest.raises(ValueError, match="unsupported T5-family "
                                         "architecture.*T5/MT5/UMT5"):
        jh.build_from_hf(str(tmp_path))


def _bundle(src, dst, **spec):
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "model.json"), "w") as f:
        json.dump({"format": "huggingface", **spec}, f)
    return str(dst)


GEN = {"slots": 2, "max_len": 64, "chunk": 4, "prefill_buckets": [16]}


def _hf_greedy(tmodel, prompt, n):
    with torch.no_grad():
        return tmodel.generate(torch.tensor([prompt]), max_new_tokens=n,
                               do_sample=False, pad_token_id=0
                               ).numpy()[0, len(prompt):].tolist()


def test_runtime_serves_the_checkpoint(hf_llama, tmp_path):
    """The huggingface format behind the engine: greedy ids equal
    transformers' generate and the JAX runtime's on the same bundle."""
    from kubeflow_tpu.serve.runtimes import load_model as jax_load

    path, tmodel = hf_llama
    d = _bundle(path, tmp_path / "b", name="llama-hf",
                model_overrides={"dtype": "float32",
                                 "param_dtype": "float32"},
                generative=GEN)
    prompt = [3, 5, 7]
    model = load_model(d, device="cpu")
    assert model.name == "llama-hf" and model.load()
    try:
        out = model.generate({"input_ids": prompt, "max_tokens": 6})
    finally:
        model.unload()
    assert out["output_ids"] == _hf_greedy(tmodel, prompt, 6)
    jmodel = jax_load(d)
    jmodel.load()
    try:
        ref = jmodel.generate({"input_ids": prompt, "max_tokens": 6})
    finally:
        jmodel.unload()
    assert out["output_ids"] == list(ref["output_ids"])


def test_runtime_checkpoint_key_and_int8(hf_llama, tmp_path):
    """`checkpoint` relative to the bundle; `quantize: int8` gives the
    registry path's int8 model (quantize_model on the same weights)."""
    from kubeflow_tpu_torch.serve.generation import GenerationEngine
    from kubeflow_tpu_torch.serve.quant import quantize_model

    path, _ = hf_llama
    d = tmp_path / "b"
    d.mkdir()
    shutil.copytree(path, d / "ckpt")
    with open(d / "model.json", "w") as f:
        json.dump({"format": "huggingface", "checkpoint": "ckpt",
                   "model_overrides": F32, "quantize": "int8",
                   "generative": GEN}, f)
    model = load_model(str(d), device="cpu")
    assert model.name == "b" and model.quantization["mode"] == "int8"
    model.load()
    _, _, ref_model = _port(path)
    engine = GenerationEngine(quantize_model(ref_model), **GEN)
    try:
        got = model.generate({"input_ids": [9, 4, 1], "max_tokens": 6})
        ref = engine.submit([9, 4, 1], max_tokens=6)
        assert got["output_ids"] == ref["output_ids"]
    finally:
        model.unload()
        engine.close()


def test_runtime_refusals(hf_llama, tmp_path):
    path, _ = hf_llama
    # A bundle without "generative" is no longer refused: it serves
    # full-forward logits as the JAX runtime's fixed forward does.
    from kubeflow_tpu.serve import runtimes as jrt

    plain = _bundle(path, tmp_path / "p", model_overrides=F32, seq_len=8)
    model, jmodel = load_model(plain, device="cpu"), jrt.load_model(plain)
    model.load(), jmodel.load()
    ids = _tokens(2, 8).astype(np.int32)
    np.testing.assert_allclose(model.predict([ids])[0],
                               jmodel.predict([ids])[0], **JAX_TOL)
    with open(os.path.join(plain, "model.json"), "w") as f:
        json.dump({"format": "onnx", "generative": GEN}, f)
    with pytest.raises(ValueError, match="huggingface"):
        load_model(plain, device="cpu")
    missing = _bundle(path, tmp_path / "m", model_overrides=F32,
                      generative=GEN, peft_adapter="no-such-adapter")
    with pytest.raises(FileNotFoundError, match="no-such-adapter"):
        load_model(missing, device="cpu")


def test_bundled_tokenizer_gives_text_and_eos(hf_llama, tmp_path):
    """A checkpoint dir carrying tokenizer.json serves text in and out;
    its eos is the default eos."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    path, _ = hf_llama
    d = _bundle(path, tmp_path / "tok", model_overrides=F32,
                generative=GEN)
    vocab = {"<unk>": 0, "a": 1, "b": 2, "c": 3, "d": 4, "</s>": 5}
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "eos_token": "</s>"}, f)
    model = load_model(d, device="cpu")
    assert model.eos_id == 5
    model.load()
    try:
        out = model.generate({"text": "a b c", "max_tokens": 4})
        direct = model.engine.submit([1, 2, 3], max_tokens=4, eos_id=5)
        assert out["output_ids"] == direct["output_ids"]
        assert isinstance(out["text"], str)
    finally:
        model.unload()
