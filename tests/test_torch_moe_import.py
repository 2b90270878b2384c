"""Hugging Face Mixtral and Qwen2-MoE checkpoints onto the port's MoE model
(`import_mixtral`, `import_qwen2_moe`, `build_from_hf`), against the JAX
importers and against transformers' own models, on synthetic checkpoints
written with the port's safetensors codec (fp32, CPU): the configs (both
pinned dropless, capacity E/K), every tensor, the logits, every JAX
refusal with JAX's words, and the `huggingface` runtime serving them
behind the generation engine, its greedy ids equal to transformers'."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import moe as tm
from kubeflow_tpu_torch.models.convert import llama_params_from_jax

TOL = dict(atol=2e-4, rtol=2e-4)

MIXTRAL = {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
           "vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16,
           "max_position_embeddings": 128, "rope_theta": 1e6,
           "rms_norm_eps": 1e-5, "num_local_experts": 4,
           "num_experts_per_tok": 2, "router_aux_loss_coef": 0.02,
           "sliding_window": None, "tie_word_embeddings": False,
           "torch_dtype": "float32"}
QWEN2_MOE = {"architectures": ["Qwen2MoeForCausalLM"],
             "model_type": "qwen2_moe", "vocab_size": 256,
             "hidden_size": 64, "intermediate_size": 160,
             "moe_intermediate_size": 48,
             "shared_expert_intermediate_size": 112,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 4, "max_position_embeddings": 128,
             "rope_theta": 1e6, "rms_norm_eps": 1e-6, "num_experts": 6,
             "num_experts_per_tok": 3, "norm_topk_prob": False,
             "decoder_sparse_step": 1, "mlp_only_layers": [],
             "use_sliding_window": False, "sliding_window": 64,
             "max_window_layers": 2, "tie_word_embeddings": False,
             "torch_dtype": "float32"}
FAMILIES = {"mixtral": MIXTRAL, "qwen2_moe": QWEN2_MOE}
IMPORTERS = {"mixtral": (th.import_mixtral, jh.import_mixtral),
             "qwen2_moe": (th.import_qwen2_moe, jh.import_qwen2_moe)}


def write(path, hf: dict, family: str, seed: int = 7) -> str:
    """A synthetic checkpoint of `hf`'s widths: the port model of the
    config `config_from_hf` gives, random weights (biases and norm scales
    drawn nonzero), written under the HF names."""
    cfg = th.config_from_hf(hf, dtype="float32")
    model = tm.causal_lm(cfg, device="cpu").init_weights(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.endswith((".scale", ".bias")):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    os.makedirs(path, exist_ok=True)
    th.save_safetensors(th.hf_tensors(model.state_dict(), cfg, family),
                        os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_ckpt")
    return {name: write(root / name, hf, name)
            for name, hf in FAMILIES.items()}


def _tokens(s=12, seed=9):
    return np.random.default_rng(seed).integers(0, 256, (2, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_import_matches_jax(checkpoints, name):
    """build_from_hf and the family's importer in both packages: the MoE
    config (dropless at E/K), every tensor, logits within TOL."""
    d = checkpoints[name]
    cfg, sd = th.build_from_hf(d, dtype="float32")
    jmod, jcfg, params = jh.build_from_hf(d, dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    assert isinstance(cfg, tm.MoEConfig)
    for field in ("num_experts", "experts_per_token", "capacity_factor",
                  "router_aux_coef", "norm_topk_prob", "shared_expert_size",
                  "intermediate_size", "attention_bias", "tie_embeddings",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "rope_theta", "rms_eps", "mask_kind", "attention_impl",
                  "max_seq_len", "vocab_size"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.capacity_factor == cfg.num_experts / cfg.experts_per_token
    ref = llama_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    assert sd["layers.0.mlp.router"].dtype == torch.float32
    port_import, _ = IMPORTERS[name]
    cfg2, sd2 = port_import(d, dtype="float32")
    assert cfg2 == cfg and sorted(sd2) == sorted(sd)
    model = tm.causal_lm(cfg, device="cpu")
    model.load_state_dict(sd)
    toks = _tokens()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _hf_model(d):
    import transformers

    return transformers.AutoModelForCausalLM.from_pretrained(
        d, torch_dtype=torch.float32).eval()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_import_matches_transformers(checkpoints, name):
    """The same checkpoint through transformers' model: dropless routing
    is its top-k mixture, so the logits agree within TOL."""
    d = checkpoints[name]
    cfg, sd = th.build_from_hf(d, dtype="float32")
    model = tm.causal_lm(cfg, device="cpu")
    model.load_state_dict(sd)
    toks = torch.from_numpy(_tokens(seed=11)).long()
    with torch.no_grad():
        want = _hf_model(d)(toks).logits
        got = model(toks)
    torch.testing.assert_close(got, want, **TOL)


def test_huggingface_runtime_serves_moe(checkpoints, tmp_path):
    """Each checkpoint as a `huggingface` bundle behind the generation
    engine: greedy ids of a prompt shorter than its bucket equal
    transformers' generate (dropless: the bucket's pad tokens claim no
    capacity a real token needs)."""
    from kubeflow_tpu_torch.serve.runtimes import load_model

    prompt = [5, 17, 3, 99, 42, 7, 1]
    for name, d in checkpoints.items():
        with open(os.path.join(d, "model.json"), "w") as f:
            json.dump({"format": "huggingface",
                       "model_overrides": {"dtype": "float32"},
                       "generative": {"slots": 2, "max_len": 64, "chunk": 4,
                                      "prefill_buckets": [16]}}, f)
        served = load_model(d, name=name, device="cpu")
        assert isinstance(served._model.layers[0].mlp, tm.MoEBlock)
        served.load()
        try:
            got = served.generate({"input_ids": prompt,
                                   "max_tokens": 8})["output_ids"]
        finally:
            served.unload()
        with torch.no_grad():
            out = _hf_model(d).generate(
                torch.tensor([prompt]), max_new_tokens=8, do_sample=False,
                pad_token_id=0)
        assert got == out[0, len(prompt):].tolist(), name


def _refusal(tmp_path, hf, tensors_from=None):
    """(port exception, JAX exception) of build_from_hf on a dir with
    config `hf` (and the tensors of checkpoint `tensors_from`)."""
    d = tmp_path / "bad"
    os.makedirs(d, exist_ok=True)
    with open(d / "config.json", "w") as f:
        json.dump(hf, f)
    if tensors_from:
        th.save_safetensors(th.load_safetensors_dir(tensors_from),
                            str(d / "model.safetensors"))
    errs = []
    for build in (th.build_from_hf, jh.build_from_hf):
        with pytest.raises(Exception) as err:
            build(str(d))
        errs.append(err.value)
    return errs


@pytest.mark.parametrize("case", ["mlp_only_layers", "decoder_sparse_step",
                                  "dense_labelled_moe"])
def test_qwen2_moe_refusals_match_jax(tmp_path, case):
    """JAX's refusals, raised by the port with the same type and words:
    dense layers interleaved into the trunk, a sparse step other than 1,
    and a dense Qwen2 checkpoint labelled qwen2_moe."""
    src = write(tmp_path / "dense", dict(
        QWEN2_MOE, architectures=["Qwen2ForCausalLM"], model_type="qwen2"),
        None)
    hf = {"mlp_only_layers": dict(QWEN2_MOE, mlp_only_layers=[1]),
          "decoder_sparse_step": dict(QWEN2_MOE, decoder_sparse_step=2),
          "dense_labelled_moe": QWEN2_MOE}[case]
    port, ref = _refusal(tmp_path, hf,
                         src if case == "dense_labelled_moe" else None)
    assert type(port) is type(ref) is ValueError
    assert str(port) == str(ref)


def test_importer_architecture_refusals_match_jax(checkpoints):
    for port_import, jax_import in IMPORTERS.values():
        other = (checkpoints["mixtral"] if port_import is th.import_qwen2_moe
                 else checkpoints["qwen2_moe"])
        errs = []
        for fn in (port_import, jax_import):
            with pytest.raises(ValueError) as err:
                fn(other)
            errs.append(str(err.value))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="not a Llama-family"):
        th.import_llama(checkpoints["qwen2_moe"])


def test_config_from_hf_without_tensors():
    """config_from_hf gives the MoE configs (JAX's, field for field) with
    no tensor read, takes MoE overrides, and refuses unknown ones."""
    cfg = th.config_from_hf(MIXTRAL, capacity_factor=1.25)
    assert isinstance(cfg, tm.MoEConfig) and cfg.capacity_factor == 1.25
    qcfg = th.config_from_hf(QWEN2_MOE)
    assert (qcfg.intermediate_size, qcfg.shared_expert_size,
            qcfg.attention_bias, qcfg.norm_topk_prob) == (48, 112, True,
                                                          False)
    assert qcfg.capacity_factor == 2.0 and qcfg.router_aux_coef == 0.001
    with pytest.raises(ValueError, match="not MoEConfig fields"):
        th.config_from_hf(MIXTRAL, num_expert=3)
    base = dataclasses.replace(qcfg, num_layers=24)
    assert base.num_params > 0


def test_qwen15_moe_widths_are_the_published_ones():
    """Qwen/Qwen1.5-MoE-A2.7B's published widths through config_from_hf:
    the config chip_smoke.py's phase 4l serves at 2 layers."""
    hf = dict(QWEN2_MOE, vocab_size=151936, hidden_size=2048,
              intermediate_size=5632, moe_intermediate_size=1408,
              shared_expert_intermediate_size=5632, num_hidden_layers=24,
              num_attention_heads=16, num_key_value_heads=16,
              num_experts=60, num_experts_per_tok=4,
              max_position_embeddings=8192)
    cfg = th.config_from_hf(hf)
    assert (cfg.head_dim, cfg.num_experts, cfg.experts_per_token) == (
        128, 60, 4)
    assert cfg.num_params == 14_315_784_192
    assert cfg.active_params == 2_689_173_504  # "A2.7B"
