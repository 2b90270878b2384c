"""Port Llama against the JAX twin on the same weights (fp32, CPU).

Tolerance 2e-4, as tests/test_generate.py uses for cached vs full forward:
the two frameworks' fp32 matmuls and reductions sum in different orders.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.utils.devices import resolve_device

TOL = dict(atol=2e-4, rtol=2e-4)


def _pair(**kw):
    """(JAX module, JAX params, port module) on the same weights."""
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               num_layers=2, **kw)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=2, **kw)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(
        jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tl.Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": True},
                                {"rope_scaling_factor": 8.0,
                                 "rope_scaling_original_max_len": 16}],
                         ids=["untied", "tied", "llama3_rope_scaling"])
def test_full_forward_logits_match_jax(pair, kw):
    jm, params, tm = _pair(**kw) if kw else pair
    toks = _tokens()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_return_hidden_matches_jax(pair):
    jm, params, tm = pair
    toks = _tokens()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks),
                               return_hidden=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks), return_hidden=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_decode_and_continuation_match_jax(pair):
    """The engine's three cache calls, each against the JAX model making
    the same call: prefill at index 0, a continuation chunk at an offset
    (attend_full_cache), then per-token decode at per-row offsets."""
    jm, params, tm = pair
    toks = _tokens(s=16)
    jcache = jl.init_cache(jm.cfg, 2, max_len=32)
    tcache = tl.init_cache(tm.cfg, 2, max_len=32, device="cpu")
    jp = {"params": params}
    with torch.no_grad():
        want, jcache = jm.apply(jp, jnp.asarray(toks[:, :8]), cache=jcache)
        got, tcache = tm(torch.from_numpy(toks[:, :8]), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        idx = np.full((2,), 8, np.int32)
        pos = 8 + np.broadcast_to(np.arange(4, dtype=np.int32), (2, 4))
        want, jcache = jm.apply(jp, jnp.asarray(toks[:, 8:12]), cache=jcache,
                                cache_index=jnp.asarray(idx),
                                positions=jnp.asarray(pos),
                                attend_full_cache=True)
        got, tcache = tm(torch.from_numpy(toks[:, 8:12]), cache=tcache,
                         cache_index=torch.from_numpy(idx),
                         positions=torch.from_numpy(pos.copy()),
                         attend_full_cache=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for i in range(12, 16):
            idx = np.full((2,), i, np.int32)
            want, jcache = jm.apply(jp, jnp.asarray(toks[:, i:i + 1]),
                                    cache=jcache, cache_index=jnp.asarray(idx))
            got, tcache = tm(torch.from_numpy(toks[:, i:i + 1]), cache=tcache,
                             cache_index=torch.from_numpy(idx))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)


def test_flash_impl_matches_jax_flash():
    """attention_impl='flash' on both sides: the port's plain kernel
    version against the JAX Pallas kernel in interpret mode."""
    jm, params, tm = _pair(attention_impl="flash")
    toks = _tokens(s=20)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_packed_segments_match_jax(impl):
    """Packed documents: segment_ids confine attention and positions
    restart per document; flash runs the plain kernel version here."""
    jm, params, tm = _pair(attention_impl=impl)
    toks = _tokens(b=1, s=16)
    seg = np.array([[0] * 6 + [1] * 7 + [2] * 3], np.int32)
    pos = np.array([list(range(6)) + list(range(7)) + list(range(3))],
                   np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks),
                               positions=jnp.asarray(pos),
                               segment_ids=jnp.asarray(seg)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks), positions=torch.from_numpy(pos),
                 segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_converter_consumes_every_leaf_and_refuses_strays():
    jm, params, tm = _pair()
    flat = jax.tree.map(np.asarray, params)
    sd = llama_params_from_jax(flat, tm.cfg)
    assert set(sd) == set(tm.state_dict())
    extra = dict(flat, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        llama_params_from_jax(extra, tm.cfg)
    missing = dict(flat)
    missing.pop("final_norm")
    with pytest.raises(ValueError, match="missing"):
        llama_params_from_jax(missing, tm.cfg)
    wrong = dataclasses.replace(tm.cfg, hidden_size=32)
    with pytest.raises(ValueError, match="shape"):
        llama_params_from_jax(flat, wrong)


@pytest.mark.parametrize("kw", [
    {"lora_rank": 4, "quantized_dense": True},
    {"attention_impl": "ring"},
], ids=lambda kw: next(iter(kw)))
def test_unported_config_flags_are_refused(kw):
    if "lora_rank" in kw:
        # Ported since: a config's own LoRA on int8 projections builds and
        # gives JAX's QuantizedModule logits (tests/test_torch_lora_int8.py
        # holds greedy ids and the serving bundle).
        from kubeflow_tpu.serve import quant as jq
        from kubeflow_tpu_torch.serve.quant import quantize_model

        jm, params, tm = _pair(lora_rank=kw["lora_rank"])
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: x + 0.05 if "lora_b" in str(path[-1]) else x,
            params)
        tm.load_state_dict(llama_params_from_jax(
            jax.tree.map(np.asarray, params), tm.cfg))
        quantize_model(tm)
        assert tm.cfg.quantized_dense and tm.cfg.lora_rank == kw["lora_rank"]
        ids = np.random.default_rng(0).integers(0, 512, (2, 8))
        want = jq.QuantizedModule(jm).apply(
            {"params": jq.quantize_tree(params)}, jnp.asarray(ids))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        return
    cfg = dataclasses.replace(tl.llama_tiny(), **kw)
    with pytest.raises(NotImplementedError, match="not supported"):
        tl.Llama(cfg, device="cpu")


def test_unported_cache_layouts_are_refused():
    cfg = tl.llama_tiny()
    with pytest.raises(ValueError, match="must be one of"):
        tl.init_cache(cfg, 1, 16, kv_quant="int4", device="cpu")
    windowed = dataclasses.replace(cfg, mask_kind="sliding_window",
                                   mask_window=8)
    # Past the window the cache rolls: window rows and a position plane.
    rolling = tl.init_cache(windowed, 1, 16, device="cpu")
    assert rolling["k"].shape[2] == 8 and rolling["pos"].shape == (2, 1, 8)
    with pytest.raises(ValueError, match="rolling"):
        tl.init_cache(windowed, 1, 16, kv_quant="int8", device="cpu")


def test_string_dtype_and_device_selection():
    assert tl.LlamaConfig(dtype="float32").dtype is torch.float32
    with pytest.raises(ValueError, match="dtype"):
        tl.LlamaConfig(dtype="float8")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:  # the default is CUDA, never a silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tl.Llama(tl.llama_tiny())
