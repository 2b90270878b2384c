"""The Gemma 1/2/3 config flags of the port's Llama trunk against the JAX
package on the CPU, in fp32, on the same weights (llama_params_from_jax),
with norm scales and biases drawn nonzero so the (1 + w) and bias paths
do work.

Each flag alone at llama_tiny's size: logits and the training loss's
gradients; whole tiny Gemma-2 (2 layers, window 8) and Gemma-3 (12 layers,
window 8) models: logits, the cache calls past the window (prefill,
continuation, decode with the per-layer band), the remat policies with
sandwich norms, the chunked loss under the final soft-cap; the importers
against the JAX importers and `transformers` on checkpoints written with
the port's `save_safetensors` and config.json in the published layout,
and every importer refusal with JAX's message. The engine's tests are in
tests/test_torch_gemma_engine.py.

Tolerance 2e-4 (tests/test_torch_llama.py's TOL): the two frameworks' fp32
matmuls and reductions sum in different orders."""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.train import step as jstep
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.train import step as tstep

TOL = dict(atol=2e-4, rtol=2e-4)
HF_TOL = dict(atol=2e-4, rtol=2e-3)  # vs transformers (the JAX test's)
WINDOW = 8
WIDTHS = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_heads=4, num_kv_heads=2, head_dim=8, max_seq_len=64,
              remat=False)
GEMMA = dict(norm_plus_one=True, embed_scale=True, mlp_act="gelu_tanh",
             tie_embeddings=True)
#: Gemma-2's flags at a tiny width; caps small enough to bite.
GEMMA2 = dict(WIDTHS, **GEMMA, num_layers=2, sandwich_norms=True,
              attn_softcap=2.0, final_softcap=3.0, query_pre_attn_scalar=16.0,
              sliding_pattern="even", mask_kind="sliding_window",
              mask_window=WINDOW, attention_impl="naive")
#: Gemma-3's: 12 layers, so layers 5 and 11 are full; a linear-scaled
#: global RoPE beside the local base.
GEMMA3 = dict(WIDTHS, **GEMMA, num_layers=12, sandwich_norms=True,
              qk_norm=True, query_pre_attn_scalar=16.0, sliding_pattern="5to1",
              mask_kind="sliding_window", mask_window=WINDOW,
              rope_theta=1e6, rope_theta_local=1e4,
              rope_global_scaling_factor=2.0, attention_impl="naive")
MODELS = {"gemma2": GEMMA2, "gemma3": GEMMA3}


def _noisy(params, seed=1, scale=0.3):
    """Norm scales and biases drawn away from their init (zero for (1 + w)
    norms and biases), so those paths are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key in ("scale", "bias"):
            return x + scale * rng.standard_normal(x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(kw, seed=0, noise_seed=1):
    """(JAX module, its params, the port's twin on the same weights)."""
    jm = jl.Llama(jl.LlamaConfig(**kw, dtype=jnp.float32,
                                 param_dtype=jnp.float32))
    params = _noisy(jax.tree.map(np.asarray, fnn.meta.unbox(jm.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"])),
        noise_seed)
    tm = tl.Llama(tl.LlamaConfig(**kw, dtype=torch.float32,
                                 param_dtype=torch.float32), device="cpu")
    tm.load_state_dict(llama_params_from_jax(params, tm.cfg))
    return jm, jax.tree.map(jnp.asarray, params), tm


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    return (request.param,) + _pair(MODELS[request.param])


def _tokens(b=2, s=12, seed=1, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _grads(jm, params, tm, toks, targets):
    """The full cross entropy's (JAX loss, logits and gradients on the
    port's names; port loss, logits and gradients by name), one JAX
    compile for both."""
    def jloss(p):
        logits = jm.apply({"params": p}, jnp.asarray(toks))
        return (jstep.cross_entropy_loss(logits, jnp.asarray(targets)),
                logits)
    (jl_, jlogits), jg_ = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    want = llama_params_from_jax(jax.tree.map(np.asarray, jg_), tm.cfg)
    logits = tm(torch.from_numpy(toks))
    loss = tstep.cross_entropy_loss(logits, torch.from_numpy(targets))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    return ((float(jl_), np.asarray(jlogits), want),
            (float(loss.detach()), logits.detach().numpy(),
             dict(zip(names, grads))))


def _hold_grads(jax_side, port_side):
    (jloss, jlogits, jgrads), (loss, logits, grads) = jax_side, port_side
    np.testing.assert_allclose(logits, jlogits, **TOL)
    assert abs(loss - jloss) <= 1e-5
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), **TOL,
                                   err_msg=name)


# -- each flag alone ----------------------------------------------------------

#: The eleven flags, each with what it needs to act (a window for the
#: pattern, a pattern for the local base); small caps so they bite.
FLAGS = [
    {"attention_bias": True}, {"norm_plus_one": True},
    {"embed_scale": True}, {"mlp_act": "gelu_tanh"},
    {"sandwich_norms": True}, {"attn_softcap": 1.0},
    {"final_softcap": 1.0}, {"query_pre_attn_scalar": 4.0},
    {"sliding_pattern": "even", "mask_kind": "sliding_window",
     "mask_window": 4},
    {"qk_norm": True},
    {"rope_theta_local": 100.0, "sliding_pattern": "even"},
]


@pytest.mark.parametrize("kw", FLAGS, ids=lambda kw: next(iter(kw)))
def test_flag_matches_jax(kw):
    """Logits and the loss's gradients against the JAX model."""
    tiny = dataclasses.asdict(tl.llama_tiny())
    base = {k: tiny[k] for k in ("vocab_size", "hidden_size",
                                 "intermediate_size", "num_layers",
                                 "num_heads", "num_kv_heads", "head_dim",
                                 "max_seq_len", "remat")}
    jm, params, tm = _pair(dict(base, **kw))
    _hold_grads(*_grads(jm, params, tm, _tokens(vocab=512),
                        _tokens(seed=2, vocab=512)))


# -- whole models ----------------------------------------------------------------

def test_full_forward_matches_jax(model):
    _, jm, params, tm = model
    toks = _tokens(s=20)  # past the window of 8
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sliding_flags_match_the_layer_types():
    assert tl.sliding_flags(tl.LlamaConfig(**GEMMA2)) == [True, False]
    kinds = tl.sliding_flags(tl.LlamaConfig(**GEMMA3))
    assert [i for i, k in enumerate(kinds) if not k] == [5, 11]
    # The causal view keeps Gemma-3's kinds (dual RoPE), not Gemma-2's.
    causal = dict(mask_kind="causal", mask_window=0)
    assert tl.sliding_flags(tl.LlamaConfig(**dict(GEMMA3, **causal))) == kinds
    assert tl.sliding_flags(tl.LlamaConfig(**dict(GEMMA2, **causal))) is None
    with pytest.raises(ValueError, match="all | even | 5to1"):
        tl.Llama(tl.LlamaConfig(**dict(GEMMA2, sliding_pattern="odd")),
                 device="cpu")
    with pytest.raises(ValueError, match="silu | gelu_tanh"):
        tl.Llama(tl.LlamaConfig(**dict(GEMMA2, mlp_act="relu")),
                 device="cpu")


def _cache_stages(jm, params, tm):
    """The engine's three cache calls past the window on a full-length
    cache of 32 rows, each against the JAX model making the same call:
    prefill of 12 tokens, a continuation of 6 at offset 12, then decode to
    position 24 at per-row offsets. {stage: (port, JAX) logits}, and the
    caches."""
    toks = _tokens(s=24, seed=5)
    jc = jl.init_cache(jm.cfg, 2, max_len=32)
    tc = tl.init_cache(tm.cfg, 2, max_len=32, device="cpu")
    assert "pos" not in tc and tc["k"].shape[2] == 32
    jp = {"params": params}
    apply = jax.jit(jm.apply, static_argnames=("attend_full_cache",))
    out = {}
    with torch.no_grad():
        want, jc = apply(jp, jnp.asarray(toks[:, :12]), cache=jc)
        got, tc = tm(torch.from_numpy(toks[:, :12]), cache=tc)
        out["prefill"] = (got.numpy(), np.asarray(want))
        idx = np.full((2,), 12, np.int32)
        pos = 12 + np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
        want, jc = apply(jp, jnp.asarray(toks[:, 12:18]), cache=jc,
                            cache_index=jnp.asarray(idx),
                            positions=jnp.asarray(pos),
                            attend_full_cache=True)
        got, tc = tm(torch.from_numpy(toks[:, 12:18]), cache=tc,
                     cache_index=torch.from_numpy(idx),
                     positions=torch.from_numpy(pos.copy()),
                     attend_full_cache=True)
        out["continuation"] = (got.numpy(), np.asarray(want))
        dec = []
        for i in range(18, 24):
            idx = np.full((2,), i, np.int32)
            want, jc = apply(jp, jnp.asarray(toks[:, i:i + 1]), cache=jc,
                             cache_index=jnp.asarray(idx))
            got, tc = tm(torch.from_numpy(toks[:, i:i + 1]), cache=tc,
                         cache_index=torch.from_numpy(idx))
            dec.append((got.numpy(), np.asarray(want)))
        out["decode"] = tuple(np.concatenate(x, axis=1) for x in zip(*dec))
    out["cache"] = (tc["k"].numpy(), np.asarray(jc["k"]))
    return out


@pytest.fixture(scope="module")
def stages(model):
    return model[0], _cache_stages(*model[1:])


@pytest.mark.parametrize("stage", ["prefill", "continuation", "decode",
                                   "cache"])
def test_cache_calls_past_the_window_match_jax(stages, stage):
    got, want = stages[1][stage]
    np.testing.assert_allclose(got, want, **TOL)


def test_the_band_reaches_the_decode_reads():
    """Decode past the window on a sliding layer must not see rows older
    than the window: zeroing those rows of layer 0 (sliding) leaves the
    logits unchanged, zeroing them on layer 1 (full) does not."""
    jm, params, tm = _pair(GEMMA2)
    toks = torch.from_numpy(_tokens(b=1, s=20, seed=6))
    cache = tl.init_cache(tm.cfg, 1, max_len=32, device="cpu")
    idx = torch.full((1,), 19, dtype=torch.int32)
    with torch.no_grad():
        tm(toks[:, :19], cache=cache)
        base = {n: c.clone() for n, c in cache.items()}
        ref = tm(toks[:, 19:], cache=cache, cache_index=idx)[0]
        logits = []
        for layer in (0, 1):
            cache = {n: c.clone() for n, c in base.items()}
            for name in ("k", "v"):
                cache[name][layer, :, :19 - WINDOW + 1] = 0
            logits.append(tm(toks[:, 19:], cache=cache, cache_index=idx)[0])
    torch.testing.assert_close(logits[0], ref, atol=0, rtol=0)
    assert not torch.allclose(logits[1], ref)


def test_flash_with_softcap_or_band_is_refused_as_jax():
    for cap in (2.0, 0.0):
        kw = dict(GEMMA2, attn_softcap=cap, attention_impl="flash")
        jm = jl.Llama(jl.LlamaConfig(**kw, dtype=jnp.float32))
        with pytest.raises(ValueError) as jerr:
            jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
        tm = tl.Llama(tl.LlamaConfig(**kw, dtype=torch.float32),
                      device="cpu").init_weights(0)
        with pytest.raises(ValueError) as terr:
            tm(torch.zeros((1, 8), dtype=torch.long))
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("policy", ["nothing", "dots", "save_attn"])
def test_remat_policies_match_jax(policy):
    """Gemma-2 under remat: the port's per-layer checkpoint (save_attn
    keeping the sandwich-normed attention output) against JAX's nn.remat,
    loss and gradients."""
    kw = dict(GEMMA2, remat=True, remat_policy=policy)
    _hold_grads(*_grads(*_pair(kw), _tokens(s=12), _tokens(s=12, seed=3)))


@pytest.mark.parametrize("chunk", [5, 64])
def test_chunked_loss_applies_the_final_cap_as_jax(chunk):
    """The training loss's chunked CE under Gemma-2's final soft-cap,
    against JAX's chunked_cross_entropy with the same cap: loss and
    gradients; and equal to the capped full loss."""
    jm, params, tm = _pair(GEMMA2)
    toks, targets = _tokens(s=12), _tokens(s=12, seed=3)

    def jloss(p):
        hidden = jm.apply({"params": p}, jnp.asarray(toks),
                          return_hidden=True)
        return jstep.chunked_cross_entropy(
            hidden, p["embed"], jnp.asarray(targets), chunk=chunk,
            head_is_vocab_major=True, final_softcap=jm.cfg.final_softcap)
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    want = llama_params_from_jax(jax.tree.map(np.asarray, want), tm.cfg)
    loss = tstep.chunked_cross_entropy(
        tm(torch.from_numpy(toks), return_hidden=True),
        tstep._unembed_head(tm), torch.from_numpy(targets), chunk=chunk,
        final_softcap=tm.cfg.final_softcap)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    with torch.no_grad():
        full = tstep.cross_entropy_loss(tm(torch.from_numpy(toks)),
                                        torch.from_numpy(targets))
    assert abs(float(loss) - float(full)) <= 1e-5


def test_train_step_carries_the_cap():
    """make_train_step's chunked loss reads the model's final_softcap: its
    loss equals the full loss, which the cap is part of."""
    _, _, tm = _pair(GEMMA2)
    from kubeflow_tpu_torch.train import optim
    batch = {"inputs": torch.from_numpy(_tokens(s=12)),
             "targets": torch.from_numpy(_tokens(s=12, seed=3))}
    with torch.no_grad():
        full = float(tstep.cross_entropy_loss(tm(batch["inputs"]),
                                              batch["targets"]))
    state = tstep.init_train_state(tm, optim.AdamW(1e-3),
                                   params=tm.state_dict())
    _, m = tstep.make_train_step(tm, loss_impl="chunked",
                                 loss_chunk=7)(state, batch)
    assert float(m["loss"]) == pytest.approx(full, abs=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS) + ["qwen2"])
def test_num_params_matches_jax(name):
    kw = MODELS.get(name) or dict(WIDTHS, num_layers=2, attention_bias=True)
    jcfg = jl.LlamaConfig(**kw)
    tcfg = tl.LlamaConfig(**kw)
    assert tcfg.num_params == jcfg.num_params
    tm = tl.Llama(tcfg, device="cpu")
    n = sum(p.numel() for p in tm.parameters())
    # The count is JAX's formula: projections, embeddings, the two block
    # norms and biases; the sandwich and qk norms are not in it.
    extra = sum(p.numel() for name_, p in tm.named_parameters()
                if "out_norm" in name_ or "q_norm" in name_
                or "k_norm" in name_)
    assert n - extra == tcfg.num_params


def test_init_weights_gives_jax_initial_leaves():
    kw = dict(GEMMA3, attention_bias=True)
    tm = tl.Llama(tl.LlamaConfig(**kw), device="cpu").init_weights(0)
    jm = jl.Llama(jl.LlamaConfig(**kw))
    params = fnn.meta.unbox(jm.init(jax.random.key(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    ref = llama_params_from_jax(jax.tree.map(np.asarray, params), tm.cfg)
    sd = tm.state_dict()
    for name, want in ref.items():
        if name.endswith((".scale", ".bias")):
            assert torch.equal(sd[name], want), name
    assert not sd["layers.0.attn.q_proj.bias"].any()
    assert not sd["layers.0.attn.q_norm.scale"].any()
    plain = tl.Llama(tl.llama_tiny(), device="cpu").init_weights(0)
    assert bool((plain.state_dict()["final_norm.scale"] == 1).all())


# -- importers ---------------------------------------------------------------------

#: config.json of each family in its published layout (google/gemma-7b,
#: google/gemma-2-9b, google/gemma-3-1b-pt), at the tests' widths.
TINY_HF = {"vocab_size": 128, "hidden_size": 32, "intermediate_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 8, "max_position_embeddings": 64}
HF_CONFIGS = {
    "gemma": {"architectures": ["GemmaForCausalLM"], "attention_bias": False,
              "attention_dropout": 0.0, "bos_token_id": 2, "eos_token_id": 1,
              "hidden_act": "gelu", "initializer_range": 0.02,
              "model_type": "gemma", "num_hidden_layers": 2,
              "pad_token_id": 0, "rms_norm_eps": 1e-06, "rope_scaling": None,
              "rope_theta": 10000.0, "torch_dtype": "bfloat16",
              "use_cache": True, **TINY_HF},
    "gemma2": {"architectures": ["Gemma2ForCausalLM"],
               "attention_bias": False, "attention_dropout": 0.0,
               "attn_logit_softcapping": 2.0, "bos_token_id": 2,
               "cache_implementation": "hybrid", "eos_token_id": 1,
               "final_logit_softcapping": 3.0,
               "hidden_act": "gelu_pytorch_tanh",
               "hidden_activation": "gelu_pytorch_tanh",
               "initializer_range": 0.02, "model_type": "gemma2",
               "num_hidden_layers": 2, "pad_token_id": 0,
               "query_pre_attn_scalar": 16, "rms_norm_eps": 1e-06,
               "rope_theta": 10000.0, "sliding_window": WINDOW,
               "sliding_window_size": WINDOW, "torch_dtype": "float32",
               "use_cache": True, **TINY_HF},
    "gemma3": {"architectures": ["Gemma3ForCausalLM"],
               "attention_bias": False, "attention_dropout": 0.0,
               "attn_logit_softcapping": None, "bos_token_id": 2,
               "cache_implementation": "hybrid", "eos_token_id": 1,
               "final_logit_softcapping": None,
               "hidden_activation": "gelu_pytorch_tanh",
               "initializer_range": 0.02, "model_type": "gemma3_text",
               "num_hidden_layers": 12, "pad_token_id": 0,
               "query_pre_attn_scalar": 16, "rms_norm_eps": 1e-06,
               "rope_local_base_freq": 10000,
               "rope_scaling": {"rope_type": "linear", "factor": 2.0},
               "rope_theta": 1000000, "sliding_window": WINDOW,
               "sliding_window_pattern": 6, "torch_dtype": "bfloat16",
               "use_cache": True, **TINY_HF},
}


def write_checkpoint(path: str, model, config: dict) -> str:
    """`model`'s weights under their HF names (the port's writer) and
    `config` as config.json, in `path`."""
    os.makedirs(path, exist_ok=True)
    sd = model.state_dict()
    th.save_safetensors({h: sd[n] for h, n in
                         th.llama_hf_names(model.cfg).items()},
                        os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{family: (dir, the port model whose weights it holds)}: the model
    of the config `config_from_hf` derives, random weights, norm scales
    drawn nonzero."""
    root = tmp_path_factory.mktemp("gemma_ckpt")
    out = {}
    for name, hf in HF_CONFIGS.items():
        cfg = th.config_from_hf(hf, dtype="float32")
        model = tl.Llama(cfg, device="cpu").init_weights(7)
        gen = torch.Generator().manual_seed(8)
        with torch.no_grad():
            for key, p in model.named_parameters():
                if key.endswith(".scale"):
                    p.add_(0.3 * torch.randn(p.shape, generator=gen))
        out[name] = (write_checkpoint(str(root / name), model, hf), model)
    return out


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_import_matches_jax(checkpoints, name):
    """build_from_hf in both packages: the config's flags, every tensor
    equal, logits within TOL."""
    d, model = checkpoints[name]
    cfg, sd = th.build_from_hf(d, dtype="float32")
    jmod, jcfg, params = jh.build_from_hf(d, dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    for field in ("norm_plus_one", "embed_scale", "mlp_act",
                  "sandwich_norms", "attn_softcap", "final_softcap",
                  "query_pre_attn_scalar", "sliding_pattern", "qk_norm",
                  "rope_theta_local", "rope_global_scaling_factor",
                  "mask_kind", "mask_window", "attention_impl",
                  "tie_embeddings"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    ref = llama_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref) == sorted(model.state_dict())
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    tm = tl.Llama(cfg, device="cpu")
    tm.load_state_dict(sd)
    toks = _tokens(s=12, seed=9)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_import_matches_transformers(checkpoints, name):
    """The same checkpoint through transformers' own model (eager
    attention), past the window of 8."""
    d, _ = checkpoints[name]
    cfg, sd = th.build_from_hf(d, dtype="float32")
    tm = tl.Llama(cfg, device="cpu")
    tm.load_state_dict(sd)
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        d, torch_dtype=torch.float32, attn_implementation="eager").eval()
    toks = torch.from_numpy(_tokens(s=12, seed=9).astype(np.int64))
    with torch.no_grad():
        want = hf(toks).logits.numpy()
        got = tm(toks).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


def _refusal_case(case: str):
    """(importer name, config changes) of each JAX importer refusal."""
    g1, g2, g3 = (HF_CONFIGS[k] for k in ("gemma", "gemma2", "gemma3"))
    return {
        "v2_named_v1": ("import_gemma", dict(g1, model_type="gemma2")),
        "v3_named_v1": ("import_gemma", dict(g1, model_type="gemma3_text")),
        "v2_arch_as_v1": ("import_gemma",
                          dict(g1, architectures=["Gemma2ForCausalLM"])),
        "not_gemma_as_v1": ("import_gemma",
                            dict(g1, architectures=["LlamaForCausalLM"],
                                 model_type="llama")),
        "v1_activation": ("import_gemma", dict(g1, hidden_act="relu")),
        "v1_untied": ("import_gemma", dict(g1, tie_word_embeddings=False)),
        "v3_as_v2": ("import_gemma2", dict(g2, model_type="gemma3")),
        "not_gemma_as_v2": ("import_gemma2",
                            dict(g2, architectures=["LlamaForCausalLM"],
                                 model_type="llama")),
        "v2_activation": ("import_gemma2",
                          dict(g2, hidden_activation="silu")),
        "v2_layer_types": ("import_gemma2", dict(g2, layer_types=[
            "full_attention", "sliding_attention"])),
        "v2_untied": ("import_gemma2", dict(g2, tie_word_embeddings=False)),
        "v3_multimodal": ("import_gemma3", dict(
            g3, architectures=["Gemma3ForConditionalGeneration"])),
        "v3_vision_config": ("import_gemma3",
                             dict(g3, vision_config={"hidden_size": 8})),
        "not_gemma_as_v3": ("import_gemma3",
                            dict(g3, architectures=["LlamaForCausalLM"],
                                 model_type="llama")),
        "v3_activation": ("import_gemma3",
                          dict(g3, hidden_activation="silu")),
        "v3_layer_types": ("import_gemma3", dict(g3, layer_types=[
            "sliding_attention"] * 12)),
        "v3_window_pattern": ("import_gemma3",
                              dict(g3, sliding_window_pattern=4)),
        "v3_rope_scaling": ("import_gemma3", dict(g3, rope_scaling={
            "rope_type": "llama3", "factor": 8.0})),
        "v3_untied": ("import_gemma3", dict(g3, tie_word_embeddings=False)),
        "other_gemma": ("build_from_hf", dict(
            g1, architectures=["RecurrentGemmaForCausalLM"],
            model_type="recurrent_gemma")),
    }[case]


REFUSALS = ["v2_named_v1", "v3_named_v1", "v2_arch_as_v1", "not_gemma_as_v1",
            "v1_activation", "v1_untied", "v3_as_v2", "not_gemma_as_v2",
            "v2_activation", "v2_layer_types", "v2_untied", "v3_multimodal",
            "v3_vision_config", "not_gemma_as_v3", "v3_activation",
            "v3_layer_types", "v3_window_pattern", "v3_rope_scaling",
            "v3_untied", "other_gemma"]


@pytest.mark.parametrize("case", REFUSALS)
def test_importer_refusals_match_jax(tmp_path, case):
    """Each refusal of the JAX importers, reproduced with its message
    before any tensor is read."""
    fn, config = _refusal_case(case)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config, f)
    with pytest.raises(ValueError) as jerr:
        getattr(jh, fn)(str(tmp_path))
    with pytest.raises(ValueError) as terr:
        getattr(th, fn)(str(tmp_path))
    assert str(terr.value) == str(jerr.value)


def test_gemma3_linear_scaling_reaches_the_global_table_only(checkpoints):
    """Gemma-3's linear rope_scaling becomes rope_global_scaling_factor and
    is shadowed before the Llama mapping (which would refuse 'linear');
    the local table stays unscaled."""
    d, model = checkpoints["gemma3"]
    cfg, _ = th.build_from_hf(d)
    assert cfg.rope_global_scaling_factor == 2.0
    assert cfg.rope_scaling_factor == 1.0
    assert (cfg.rope_theta, cfg.rope_theta_local) == (1e6, 1e4)
    local = tl.rope_table(cfg.head_dim, 64, 1e4)
    torch.testing.assert_close(model.rope_local_cos, local[0])
    scaled = tl.rope_table(cfg.head_dim, 64, 1e6, cfg)
    torch.testing.assert_close(model.rope_cos, scaled[0])
    assert not torch.allclose(scaled[0], tl.rope_table(8, 64, 1e6)[0])

