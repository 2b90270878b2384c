"""The serving engine on Gemma-2 and Gemma-3 against the JAX engine on the
CPU, in fp32, on the same weights (tests/test_torch_gemma.py's tiny
models: Gemma-2 at 2 layers, Gemma-3 at 12, a window of 8, norm scales
drawn nonzero): within the window (a causal view) and past it (the mask
kept, a full-length cache, the sliding layers' reads banded), flat and
paged, two requests at once and a prefix-cache hit, greedy ids and
counters equal to the JAX engine's and to the JAX model's uncached
rollout; the same past the window as a speculative target (flat and
paged), with int8 weights, and the int8 logits of both packages under
quantize_tree's norm threshold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import generation as jg
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serve import generation as tg
from kubeflow_tpu_torch.serve import quant as tq
from tests.test_torch_gemma import GEMMA2, GEMMA3, MODELS, TOL, _pair, _tokens
from tests.test_torch_generation import ref_greedy
from tests.test_torch_rolling_window import _counters, _prompt, _run

# -- the engine ----------------------------------------------------------------

#: Both engines' settings: prompts past the window of 8, one prompt bucket.
ENGINE = dict(slots=2, max_len=32, chunk=4, prefill_buckets=(16,),
              prefix_cache=4)
STORIES = [(name, where, paged) for name in sorted(MODELS)
           for where in ("past", "within") for paged in (False, True)]


def _served(name, where):
    """(JAX module, params, port module) of `name`: its window of 8 (past
    it at max_len 32), or 32 (within it), the weights shared."""
    jm, params, tm = _pair(MODELS[name])
    if where == "within":
        jm = jl.Llama(dataclasses.replace(jm.cfg, mask_window=32))
        tm = tl.config_view(tm, dataclasses.replace(tm.cfg, mask_window=32))
    return jm, params, tm


def _story(jm, params, tm, **kw):
    """Two requests at once (13 and 5 prompt tokens, 12 and 14 ids: both
    run past the window), then a prompt and one sharing its first 18
    tokens (a prefix hit at 16), through the JAX engine and the port's.
    {side: {"burst", "prefix", "counters", "rolling", "mask", "rows"}}."""
    requests = [(_prompt(3, 13), dict(max_tokens=12)),
                (_prompt(4, 5), dict(max_tokens=14))]
    head = _prompt(7, 18)
    sides = {"port": tg.GenerationEngine(tm, **kw),
             "jax": jg.GenerationEngine(jm, params, jm.cfg, **kw)}
    out = {"requests": requests}
    try:
        for side, eng in sides.items():
            cache = eng._cache if side == "port" else None
            out[side] = {
                "burst": _run(eng, requests),
                "prefix": [eng.submit(head + tail, max_tokens=8)[
                    "output_ids"] for tail in ([5, 9, 2], [7, 1])],
                "counters": _counters(eng), "rolling": eng._rolling,
                "mask": eng.cfg.mask_kind,
                "rows": None if cache is None else cache["k"].shape[2]}
    finally:
        for eng in sides.values():
            eng.close()
    return out


@pytest.fixture(scope="module", params=STORIES,
                ids=lambda p: f"{p[0]}-{p[1]}-{'paged' if p[2] else 'flat'}")
def story(request):
    name, where, paged = request.param
    jm, params, tm = _served(name, where)
    kw = dict(ENGINE, kv_block_size=8) if paged else ENGINE
    return request.param, (jm, params), _story(jm, params, tm, **kw)


def test_engine_ids_match_jax(story):
    _, (jm, params), out = story
    assert out["port"]["burst"] == out["jax"]["burst"]
    assert out["port"]["prefix"] == out["jax"]["prefix"]
    # And the JAX model's uncached greedy rollout under its own mask.
    prompt, kw = out["requests"][0]
    assert out["port"]["burst"][0] == ref_greedy(jm, params, prompt,
                                                 kw["max_tokens"])


def test_engine_counters_match_jax(story):
    _, _, out = story
    assert out["port"]["counters"] == out["jax"]["counters"]
    assert out["port"]["counters"]["prefix_hits"] >= 1


def test_engine_keeps_the_mask_past_the_window(story):
    """Past the window nothing rolls: the mask and the full-length cache
    stay. Within it the engine serves the causal view."""
    (_, where, paged), _, out = story
    port = out["port"]
    assert port["rolling"] == out["jax"]["rolling"] == 0
    assert port["mask"] == out["jax"]["mask"] == (
        "sliding_window" if where == "past" else "causal")
    assert port["rows"] == (8 if paged else ENGINE["max_len"])


def test_spec_target_past_the_window_matches_jax():
    """Gemma-2 past its window as a speculative target, with a noisy copy
    of itself as the draft (a window of 32: within max_len, served
    causal), flat and paged: ids and counters equal the JAX engine's."""
    jm, params, tm = _served("gemma2", "past")
    dj, dparams, dt = _pair(dict(GEMMA2, mask_window=32), noise_seed=5)
    requests = [(_prompt(10, 11), dict(max_tokens=12)),
                (_prompt(11, 7), dict(max_tokens=10))]
    out = {}
    for paged in (False, True):
        kw = dict(ENGINE, chunk=8, prefix_cache=0,
                  kv_block_size=8 if paged else 0)
        sides = {"port": tg.GenerationEngine(
                     tm, draft={"model": dt, "gamma": 3}, **kw),
                 "jax": jg.GenerationEngine(
                     jm, params, jm.cfg, draft={
                         "model": dj, "params": dparams, "cfg": dj.cfg,
                         "gamma": 3}, **kw)}
        try:
            for side, eng in sides.items():
                out[side, paged] = (_run(eng, requests), _counters(eng))
        finally:
            for eng in sides.values():
                eng.close()
        assert out["port", paged] == out["jax", paged]
        assert out["port", paged][1]["spec_dispatches"] > 0
    assert out["port", False][0] == out["port", True][0]


def test_int8_weights_past_the_window_match_jax():
    """Gemma-3 with int8 projections (min_size 512) past its window: the
    port's engine against the JAX engine on QuantizedModule with
    quantize_tree's codes."""
    jm, params, tm = _served("gemma3", "past")
    qparams = jq.quantize_tree(params, min_size=512)
    qt = tq.quantize_model(tm, min_size=512)
    requests = [(_prompt(12, 13), dict(max_tokens=12))]
    sides = {"port": tg.GenerationEngine(qt, **ENGINE),
             "jax": jg.GenerationEngine(jq.QuantizedModule(jm, jnp.float32),
                                        qparams, jm.cfg, **ENGINE)}
    try:
        got = {side: _run(eng, requests) for side, eng in sides.items()}
    finally:
        for eng in sides.values():
            eng.close()
    assert isinstance(qt.layers[0].attn.q_proj, tq.Int8Dense)
    assert got["port"] == got["jax"]


def test_int8_logits_agree_under_the_norm_threshold():
    """Below quantize_tree's min_size for the stacked norm scales (here
    [12, 8] qk-norms and [12, 32] block norms, under 4096) both packages
    keep every norm float and their int8 models agree; above it JAX
    quantizes the stacked norms and the port does not (serve/quant.py)."""
    jm, params, tm = _pair(GEMMA3)
    qparams = jq.quantize_tree(params)
    norms = [path for path, leaf in jax.tree_util.tree_flatten_with_path(
        qparams, is_leaf=lambda x: isinstance(x, jq.Int8Leaf))[0]
        if path[-1].key == "scale" and isinstance(leaf, jq.Int8Leaf)]
    assert not norms
    assert isinstance(qparams["layers"]["attn"]["q_proj"]["kernel"],
                      jq.Int8Leaf)
    qt = tq.quantize_model(tm)
    toks = _tokens(s=12, seed=4)
    want = np.asarray(jq.QuantizedModule(jm, jnp.float32).apply(
        {"params": qparams}, jnp.asarray(toks)))
    with torch.no_grad():
        got = qt(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert qt.layers[0].attn.q_norm.scale.dtype == torch.float32
