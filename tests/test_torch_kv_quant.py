"""Port quantized KV (`kv_quant`) against the JAX package on the CPU: the
row codec byte for byte, `naive_attention` with scale planes, one decode
step on an int8 or fp8 cache at model level, and the slice as a whole —
int8 weights plus a paged int8 KV pool served by the port's engine against
one JAX `GenerationEngine` over `QuantizedModule` + `quantize_tree`."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.ops.reference import naive_attention as jax_naive
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu.serve.generation import GenerationEngine as JaxEngine
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.ops.reference import naive_attention as torch_naive
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.serve.generation import GenerationEngine
from tests.test_torch_quant import numpy_tree

GEN = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16),
           kv_block_size=8, kv_quant="int8")
# Greedy ids must be equal; logprobs agree to 1e-4 (fp32 on both sides,
# summed in different orders through two layers and a 512-way softmax).
LOGPROB_TOL = 1e-4


def _rows(seed, shape=(2, 3, 24, 2, 16)):
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0
            ).astype(np.float32)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_row_codec_byte_equal_to_jax(mode):
    rows = _rows(0)
    rows[0, 0, 0] = 0.0  # an all-zero row: eps scale, exact zero codes
    jqv, jsv = jq.kv_quantize_rows(jnp.asarray(rows), mode)
    tqv, tsv = tq.kv_quantize_rows(torch.from_numpy(rows), mode)
    assert tqv.dtype == tq.kv_qdtype(mode) and tsv.dtype == torch.float32
    np.testing.assert_array_equal(tqv.view(torch.uint8).numpy(),
                                  np.asarray(jqv).view(np.uint8))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    back = tq.kv_dequantize_rows(tqv, tsv, torch.float32).numpy()
    want = np.asarray(jq.kv_dequantize_rows(jqv, jsv, jnp.float32))
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_naive_attention_with_scale_planes_matches_jax(mode):
    """Raw codes cast to fp32, the scales on scores and probabilities."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    kq, ks = jq.kv_quantize_rows(jnp.asarray(_rows(6, (2, 20, 2, 16))), mode)
    vq, vs = jq.kv_quantize_rows(jnp.asarray(_rows(7, (2, 20, 2, 16))), mode)
    pos_q = np.array([[5, 6, 7], [17, 18, 19]], np.int32)
    pos_kv = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    kw = dict(causal=True)
    want = np.asarray(jax_naive(
        jnp.asarray(q), kq.astype(jnp.float32), vq.astype(jnp.float32),
        positions_q=jnp.asarray(pos_q), positions_kv=jnp.asarray(pos_kv),
        k_scale=ks, v_scale=vs, **kw))

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    got = torch_naive(t(q), t(kq.astype(jnp.float32)),
                      t(vq.astype(jnp.float32)), positions_q=t(pos_q).long(),
                      positions_kv=t(pos_kv).long(), k_scale=t(ks),
                      v_scale=t(vs), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _float_pair():
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               num_layers=2)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=2)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(
        jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tl.Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(numpy_tree(params), tcfg))
    return jm, params, tm


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_decode_step_on_a_quantized_cache_matches_jax(mode):
    """Prefill 6 tokens into a quantized [2 x 16] cache, then one decode
    step at per-row offsets: logits and the cache's scale planes agree
    with the JAX model making the same calls (the codes are compared
    after dequantizing: a code may sit on a rounding boundary that fp32
    summation order moves)."""
    jm, params, tm = _float_pair()
    toks = np.random.default_rng(3).integers(0, 512, (2, 6)).astype(np.int32)
    step = np.array([[7], [9]], np.int32)
    idx = np.array([6, 6], np.int32)
    jcache = jl.init_cache(jm.cfg, 2, max_len=16, kv_quant=mode)
    tcache = tl.init_cache(tm.cfg, 2, max_len=16, kv_quant=mode, device="cpu")
    assert set(tcache) == set(jcache) == {"k", "v", "ks", "vs"}
    p = {"params": params}
    _, jcache = jm.apply(p, jnp.asarray(toks), cache=jcache)
    want, jcache = jm.apply(p, jnp.asarray(step), cache=jcache,
                            cache_index=jnp.asarray(idx))
    with torch.no_grad():
        tm(torch.from_numpy(toks), cache=tcache)
        got, _ = tm(torch.from_numpy(step), cache=tcache,
                    cache_index=torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    for name, sname in (("k", "ks"), ("v", "vs")):
        assert tcache[name].dtype == tq.kv_qdtype(mode)
        np.testing.assert_allclose(tcache[sname].numpy(),
                                   np.asarray(jcache[sname]), rtol=1e-5,
                                   atol=0)
        deq_t = tq.kv_dequantize_rows(tcache[name], tcache[sname],
                                      torch.float32).numpy()
        deq_j = np.asarray(jq.kv_dequantize_rows(jcache[name], jcache[sname],
                                                 jnp.float32))
        step_size = np.asarray(jcache[sname])[..., None] * (
            1.0 if mode == "int8" else 32.0)  # fp8: 3 mantissa bits at 448
        assert (np.abs(deq_t - deq_j) <= step_size * 1.001 + 1e-7).all()


# -- the slice as a whole -----------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """One JAX engine (QuantizedModule over quantize_tree, paged int8 KV)
    and the port's engine on the converted weights."""
    jm, params, _ = _float_pair()
    qparams = jq.quantize_tree(params)
    jeng = JaxEngine(jq.QuantizedModule(jm, jnp.float32), qparams, jm.cfg,
                     pipeline_depth=1, kv_blocks=24, **GEN)
    qcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=2, quantized_dense=True)
    tm = tl.Llama(qcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(numpy_tree(qparams), qcfg))
    teng = GenerationEngine(tm, kv_blocks=24, **GEN)
    yield jeng, teng
    jeng.close()
    teng.close()


@pytest.mark.parametrize("prompt", [
    pytest.param([5, 9, 2, 44, 7], id="short"),
    pytest.param(list(range(3, 40)), id="chunked"),
])
def test_quantized_paged_engine_matches_jax(engines, prompt):
    jeng, teng = engines
    want = jeng.submit(prompt, max_tokens=10)
    got = teng.submit(prompt, max_tokens=10)
    assert got["output_ids"] == want["output_ids"]
    np.testing.assert_allclose(got["output_logprobs"],
                               want["output_logprobs"], atol=LOGPROB_TOL,
                               rtol=0)
    assert teng.kv_info()["blocks_used"] == 0


def test_quantized_pool_layout(engines):
    _, teng = engines
    pool = teng._cache
    cfg = teng.cfg
    assert pool["k"].dtype == torch.int8 and pool["v"].dtype == torch.int8
    assert pool["k"].shape == (cfg.num_layers, 25, 8, cfg.num_kv_heads,
                               cfg.head_dim)
    assert pool["ks"].shape == pool["k"].shape[:-1]
    assert pool["ks"].dtype == torch.float32


def test_engine_refusals():
    _, _, tm = _float_pair()
    with pytest.raises(ValueError, match="must be one of"):
        GenerationEngine(tm, **{**GEN, "kv_quant": "int4"})
    with pytest.raises(ValueError, match="requires the paged KV"):
        GenerationEngine(tm, **{**GEN, "kv_block_size": 0})
