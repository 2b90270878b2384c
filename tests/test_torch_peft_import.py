"""PEFT adapter import onto the port (models/peft_import.py) against the
JAX importer and `peft` itself, in fp32, on adapters `peft` writes: the
port's adapter parameters equal the JAX leaves (layouts aside) bit for
bit; the adapted and the folded-flat models' logits match the JAX adapted
model (1e-5) and peft's torch model (atol 3e-3, rtol 2e-2, the JAX test's
bound); the string form of target_modules, every refusal, and the
`peft_adapter` runtime's greedy ids against the JAX runtime's."""

import copy
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import peft
import pytest
import torch
import transformers

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.models import peft_import as jp
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models import peft_import as tp
from kubeflow_tpu_torch.train import lora as tlora

PEFT_TOL = dict(atol=3e-3, rtol=2e-2)
JAX_TOL = dict(atol=1e-5, rtol=1e-5)
MLP = ("q_proj", "v_proj", "gate_proj", "up_proj", "down_proj")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("peft")
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        attn_implementation="eager")
    torch.manual_seed(21)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(str(d / "base"), safe_serialization=True)
    return d, str(d / "base"), model


def _adapter(root, model, name, targets, seed=5, r=4, alpha=8):
    torch.manual_seed(seed)
    lcfg = peft.LoraConfig(r=r, lora_alpha=alpha, target_modules=targets,
                           lora_dropout=0.0, bias="none",
                           task_type="CAUSAL_LM")
    pm = peft.get_peft_model(copy.deepcopy(model), lcfg)
    with torch.no_grad():  # B starts at zero: parity would be vacuous
        for n, p in pm.named_parameters():
            if "lora_" in n:
                p.copy_(torch.randn_like(p) * 0.05)
    pm.eval()
    d = str(root / name)
    pm.save_pretrained(d)
    return d, pm


@pytest.fixture(scope="module")
def adapters(base):
    root, _, model = base
    return {"attn": _adapter(root, model, "attn", ["q_proj", "v_proj"]),
            "attn_mlp": _adapter(root, model, "attn_mlp", list(MLP), seed=6,
                                 r=8, alpha=32)}


def _cfg(path):
    return th.import_llama(path, dtype="float32")


def _jax(path):
    return jh.import_llama(path, dtype=jnp.float32, param_dtype=jnp.float32,
                           remat=False, attention_impl="naive")


@pytest.mark.parametrize("mode", ["attn", "attn_mlp"])
def test_leaves_equal_the_jax_import(base, adapters, mode):
    _, path, _ = base
    adir, _ = adapters[mode]
    cfg, _ = _cfg(path)
    acfg, leaves = tp.load_peft_adapter(adir, cfg)
    jcfg, _ = _jax(path)
    jacfg, jleaves = jp.load_peft_adapter(adir, jcfg)
    assert (acfg.lora_rank, acfg.lora_alpha, acfg.lora_targets) == (
        jacfg.lora_rank, jacfg.lora_alpha, jacfg.lora_targets) == (
        (4, 8.0, "attn") if mode == "attn" else (8, 32.0, "attn_mlp"))
    assert len(leaves) == len(jleaves) * cfg.num_layers
    for (_, group, leaf), val in jleaves.items():
        val = np.asarray(val)
        block = "attn" if group == "attn" else "mlp"
        for i in range(cfg.num_layers):
            got = leaves[f"layers.{i}.{block}.{leaf}"]
            if leaf.endswith("_lora_a"):  # JAX [L, in, r]; port [r, in]
                ref = val[i].T
            else:  # JAX [L, r, *out]; port [out, r]
                ref = val[i].reshape(val.shape[1], -1).T
            assert got.dtype == torch.float32
            assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(
                ref))), (i, leaf)


@pytest.mark.parametrize("mode", ["attn", "attn_mlp"])
def test_logits_match_jax_and_peft(base, adapters, mode):
    _, path, _ = base
    adir, pmodel = adapters[mode]
    cfg, sd = _cfg(path)
    acfg, asd = tp.attach_peft_adapter(adir, cfg, sd)
    adapted = tl.Llama(acfg, device="cpu")
    adapted.load_state_dict(asd)
    merged = tl.Llama(cfg, device="cpu")
    merged.load_state_dict(tlora.merge(asd, acfg))
    toks = np.random.default_rng(4).integers(0, 256, (2, 12))
    with torch.no_grad():
        got = adapted(torch.from_numpy(toks)).numpy()
        got_merged = merged(torch.from_numpy(toks)).numpy()
        ref = pmodel(torch.from_numpy(toks)).logits.numpy()
        base_out = tl.Llama(cfg, device="cpu")
        base_out.load_state_dict(sd)
        base_logits = base_out(torch.from_numpy(toks)).numpy()
    jcfg, params = _jax(path)
    jacfg, jparams = jp.attach_peft_adapter(adir, jcfg, params)
    jax_out = np.asarray(jl.Llama(jacfg).apply(
        {"params": jparams}, jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(got, ref, **PEFT_TOL)
    np.testing.assert_allclose(got_merged, ref, **PEFT_TOL)
    np.testing.assert_allclose(got, jax_out, **JAX_TOL)
    assert np.abs(base_logits - ref).max() > 10 * PEFT_TOL["atol"]


@pytest.mark.parametrize("pattern,mode", [
    (r".*\.(q_proj|v_proj)", "attn"),
    (r"model\.layers\.\d+\.(self_attn\.(q|v)_proj|mlp\.(gate|up|down)_proj)",
     "attn_mlp"),
    ("q_proj|v_proj", "attn"),
])
def test_string_target_modules_resolve_as_in_jax(base, adapters, tmp_path,
                                                 pattern, mode):
    _, path, _ = base
    src = adapters[mode][0]
    d = str(tmp_path / "a")
    shutil.copytree(src, d)
    ac = tp.read_adapter_config(d)
    ac["target_modules"] = pattern
    json.dump(ac, open(os.path.join(d, "adapter_config.json"), "w"))
    cfg, _ = _cfg(path)
    acfg, _ = tp.load_peft_adapter(d, cfg)
    jacfg, _ = jp.load_peft_adapter(d, _jax(path)[0])
    assert acfg.lora_targets == jacfg.lora_targets == mode


@pytest.mark.parametrize("patch,error,match", [
    ({"peft_type": "IA3"}, ValueError, "peft_type"),
    ({"use_rslora": True}, ValueError, "rslora"),
    ({"use_dora": True}, ValueError, "DoRA"),
    ({"target_modules": ["k_proj"]}, ValueError, "target_modules"),
    ({"target_modules": "o_proj"}, ValueError, "target_modules"),
    ({"bias": "lora_only"}, ValueError, "bias"),
    ({"modules_to_save": ["lm_head"]}, ValueError, "modules_to_save"),
    ({"alpha_pattern": {"q_proj": 16}}, ValueError, "alpha_pattern"),
    ({"rank_pattern": {"q_proj": 2}}, ValueError, "rank_pattern"),
    ({"r": 6}, ValueError, "lora_A"),
])
def test_rejections_match_jax(base, adapters, tmp_path, patch, error,
                              match):
    """Every adapter the JAX importer refuses, the port refuses by name
    too (a rank the tensors do not have included)."""
    _, path, _ = base
    d = str(tmp_path / "a")
    shutil.copytree(adapters["attn"][0], d)
    ac = tp.read_adapter_config(d)
    ac.update(patch)
    json.dump(ac, open(os.path.join(d, "adapter_config.json"), "w"))
    cfg, _ = _cfg(path)
    with pytest.raises(error, match=match):
        tp.load_peft_adapter(d, cfg)
    with pytest.raises(ValueError):
        jp.load_peft_adapter(d, _jax(path)[0])


def test_non_llama_base_and_missing_tensors(base, adapters, tmp_path):
    _, path, _ = base
    with pytest.raises(ValueError, match="Llama-family"):
        tp.load_peft_adapter(adapters["attn"][0], object())
    d = tmp_path / "a"
    shutil.copytree(adapters["attn"][0], d)
    f = str(d / "adapter_model.safetensors")
    t = th.load_safetensors(f)
    t.pop(next(k for k in t if "layers.1" in k and "lora_B" in k))
    th.save_safetensors(t, f)
    with pytest.raises(KeyError, match="layers.1"):
        tp.load_peft_adapter(str(d), _cfg(path)[0])
    with pytest.raises(FileNotFoundError):
        tp.load_peft_adapter(str(tmp_path / "none"), _cfg(path)[0])


def test_peft_adapter_runtime_matches_the_jax_runtime(base, adapters,
                                                      tmp_path):
    """model.json {"format": "huggingface", "peft_adapter": ...} (relative
    to the bundle) serves the folded model: greedy ids equal the JAX
    runtime's on the same bundle and peft's generate."""
    from kubeflow_tpu.serve.runtimes import load_model as jax_load
    from kubeflow_tpu_torch.serve.runtimes import load_model

    _, path, _ = base
    adir, pmodel = adapters["attn_mlp"]
    d = tmp_path / "bundle"
    shutil.copytree(path, d)
    shutil.copytree(adir, d / "adapter")
    with open(d / "model.json", "w") as f:
        json.dump({"format": "huggingface", "peft_adapter": "adapter",
                   "model_overrides": {"dtype": "float32",
                                       "param_dtype": "float32"},
                   "generative": {"slots": 1, "max_len": 16, "chunk": 4,
                                  "prefill_buckets": [4]}}, f)
    prompt = [7, 3, 11]
    model = load_model(str(d), device="cpu")
    model.load()
    try:
        out = model.generate({"input_ids": prompt, "max_tokens": 5})
        assert "adapters" not in model.metadata()  # folded, not stacked
    finally:
        model.unload()
    jmodel = jax_load(str(d))
    jmodel.load()
    try:
        ref = jmodel.generate({"input_ids": prompt, "max_tokens": 5})
    finally:
        jmodel.unload()
    with torch.no_grad():
        peft_ids = pmodel.generate(
            torch.tensor([prompt]), max_new_tokens=5, do_sample=False,
            pad_token_id=0).numpy()[0, len(prompt):].tolist()
    assert out["output_ids"] == list(ref["output_ids"]) == peft_ids
