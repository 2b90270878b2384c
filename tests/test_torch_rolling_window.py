"""The port's rolling-window KV cache (models/llama.py `init_cache`,
`_update_cache_rolling`, the rolling branch of `Attention`; the rolling
mode of serve/generation.py) against the JAX package on the CPU, on the
same fp32 weights (llama_params_from_jax), at tests/test_rolling_window.py's
sizes: a sliding window of 8, a cache of 32.

The cache's layout and sentinel; `Llama.forward` on a rolling cache
against JAX's `Llama.apply`, logits and all three planes, through a padded
prefill, a continuation across the wrap, decode past the window and a
cache with stale rows past the index; the engine past the window (rolling)
and within it (a causal view), two concurrent slots at depth 1 and 2, a
prefix-cache hit past the window, ids and counters equal to the JAX
engine's; a slot reused by a shorter request; speculative decoding on a
rolling target with a noisy sliding-window draft within its window and an
adapter row; int8 weights through both paths; every refusal with JAX's
message. Greedy ids are also held to the JAX model's uncached rollout under
the sliding-window mask. The JAX engines are built once each."""

import dataclasses
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import generation as jg
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve import generation as tg
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter
from tests.test_torch_generation import ref_greedy
from tests.test_torch_spec_decode import _hold_admission

WINDOW = 8
#: tests/test_rolling_window.py's model.
WIDTHS = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
              max_seq_len=64, remat=False, mask_kind="sliding_window",
              mask_window=WINDOW)
#: The rolling engine (max_len past the window); prompt buckets clamp to 8.
ROLLING = dict(slots=2, max_len=32, chunk=4, prefill_buckets=(4, 16))
#: The counters held equal to the JAX engine's.
COUNTERS = ("requests", "prompt_tokens", "decode_tokens", "decode_dispatches",
            "prefill_chunks", "decode_fetch_overlapped",
            "decode_fetch_blocking", "admit_overlap",
            "decode_dead_slot_chunks", "decode_wasted_tokens", "prefix_hits",
            "prefix_hit_tokens", "prefix_misses", "prefix_stores",
            "spec_dispatches", "spec_proposed", "spec_accepted",
            "spec_demotions", "spec_readmissions", "spec_stale_rides")
#: Forward logits and cache planes: fp32, the same arithmetic.
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(window=WINDOW, num_layers=2, seed=0, noise=0.0):
    """(JAX module, its params, the port's twin on the same weights) at
    WIDTHS with sliding window `window`; `noise` > 0 perturbs the weights
    of seed 0 by that fraction of each leaf's std (a draft near the
    target)."""
    kw = dict(WIDTHS, mask_window=window, num_layers=num_layers)
    jm = jl.Llama(jl.LlamaConfig(**kw, dtype=jnp.float32,
                                 param_dtype=jnp.float32))
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jm.init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]))
    if noise:
        rng = np.random.default_rng(11)
        params = jax.tree.map(lambda x: x + noise * np.std(x) * (
            rng.standard_normal(x.shape).astype(np.float32)), params)
    tm = tl.Llama(tl.LlamaConfig(**kw, dtype=torch.float32), device="cpu")
    tm.load_state_dict(llama_params_from_jax(params, tm.cfg))
    return jm, jax.tree.map(jnp.asarray, params), tm


@pytest.fixture(scope="module")
def windowed():
    return _pair()


@pytest.fixture(scope="module")
def within(windowed):
    """The same weights with a window of 32: an engine of max_len 32 is
    within it."""
    jm, params, tm = windowed
    jcfg = dataclasses.replace(jm.cfg, mask_window=32)
    tcfg = dataclasses.replace(tm.cfg, mask_window=32)
    return jl.Llama(jcfg), params, tl.config_view(tm, tcfg)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, 128, n)]


def _run(engine, requests):
    """Submit (prompt, kwargs) requests at once, each on its own thread,
    every one admitted in the first pass; their output ids in order."""
    _hold_admission(engine, len(requests))
    out = [None] * len(requests)

    def run(i):
        prompt, kw = requests[i]
        out[i] = engine.submit(prompt, **kw)["output_ids"]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def _counters(engine) -> dict:
    s = engine.stats_snapshot()
    return {k: s[k] for k in COUNTERS}


# -- the cache and the model ---------------------------------------------------

def test_init_cache_layout_matches_jax(windowed):
    jm, _, tm = windowed
    for t in (32, WINDOW):
        jc = jl.init_cache(jm.cfg, 2, t)
        tc = tl.init_cache(tm.cfg, 2, t, device="cpu")
        assert sorted(jc) == sorted(tc)
        for name in jc:
            assert tuple(tc[name].shape) == jc[name].shape, name
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
    rolling = tl.init_cache(tm.cfg, 2, 32, device="cpu")
    assert rolling["k"].shape == (2, 2, WINDOW, 2, 8)
    assert rolling["pos"].dtype == torch.int32
    assert int(rolling["pos"][0, 0, 0]) == -(WINDOW + 1)
    assert "pos" not in tl.init_cache(tm.cfg, 2, WINDOW, device="cpu")


def _forward_stages(jm, params, tm):
    """One rolling cache of two rows through both packages: a padded
    prefill (row 0 five real tokens of eight), a continuation of six that
    crosses the wrap (row 0 padded again), four decode steps past the
    window, then one decode step after rewinding the index by three (rows
    past it are stale). {stage: ((JAX logits, cache), (port's))}."""
    rng = np.random.default_rng(1)
    sentinel = -(WINDOW + 1)
    jc = jl.init_cache(jm.cfg, 2, 32)
    tc = tl.init_cache(tm.cfg, 2, 32, device="cpu")

    def both(name, tokens, positions, index, full=False):
        nonlocal jc, tc
        kw = dict(attend_full_cache=full) if full else {}
        pos_kw = {} if positions is None else {"positions": positions}
        jl_out, jc = jm.apply(
            {"params": params}, jnp.asarray(tokens, jnp.int32), cache=jc,
            cache_index=jnp.asarray(index, jnp.int32),
            **{k: jnp.asarray(v, jnp.int32) for k, v in pos_kw.items()},
            **kw)
        with torch.no_grad():
            tl_out, tc = tm(
                torch.from_numpy(tokens), cache=tc,
                cache_index=torch.tensor(index, dtype=torch.int32),
                **{k: torch.from_numpy(v) for k, v in pos_kw.items()}, **kw)
        out[name] = ((np.asarray(jl_out), {n: np.asarray(c)
                                           for n, c in jc.items()}),
                     (tl_out.numpy(), {n: c.numpy().copy()
                                       for n, c in tc.items()}))

    out = {}
    lengths = np.array([5, 8])
    ar = np.arange(8)
    pos = np.where(ar[None] < lengths[:, None], ar[None], sentinel)
    both("prefill", rng.integers(0, 128, (2, 8)), pos, [0, 0])
    index = lengths
    lengths = np.array([4, 6])
    ar = np.arange(6)
    pos = np.where(ar[None] < lengths[:, None], index[:, None] + ar[None],
                   sentinel)
    both("continuation", rng.integers(0, 128, (2, 6)), pos, index, full=True)
    index = index + lengths
    for _ in range(4):
        both("decode", rng.integers(0, 128, (2, 1)), None, index)
        index = index + 1
    both("stale", rng.integers(0, 128, (2, 1)), None, index - 3)
    return out


@pytest.fixture(scope="module")
def stages(windowed):
    return _forward_stages(*windowed)


@pytest.mark.parametrize("stage", ["prefill", "continuation", "decode",
                                   "stale"])
def test_forward_on_rolling_cache_matches_jax(stages, stage):
    (jlog, jc), (tlog, tc) = stages[stage]
    np.testing.assert_allclose(tlog, jlog, **TOL)
    np.testing.assert_array_equal(tc["pos"], jc["pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name], jc[name], **TOL)
    if stage == "continuation":
        # The chunk wrapped: row 0 of batch row 1 holds position 8.
        assert tc["pos"][0, 1, 0] == WINDOW


@torch.no_grad()
def test_forward_reads_before_it_writes(windowed):
    """A continuation chunk of eight over a full window: its first query
    must still see the seven rows its own writes evict. Writing first
    (the causal cache's order) would change the logits."""
    jm, params, tm = windowed
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 128,
                                                              (1, 16)))
    full = tm(toks)
    cache = tl.init_cache(tm.cfg, 1, 32, device="cpu")
    zero = torch.zeros(1, dtype=torch.int32)
    tm(toks[:, :8], positions=torch.arange(8)[None], cache=cache,
       cache_index=zero)
    got, _ = tm(toks[:, 8:], positions=torch.arange(8, 16)[None],
                cache=cache, cache_index=zero + 8, attend_full_cache=True)
    torch.testing.assert_close(got, full[:, 8:], **TOL)


# -- the engine ---------------------------------------------------------------

def _engine_story(jm, params, tm, **kw):
    """The same requests through the JAX engine and the port's: two at
    once at depth 1, two others at depth 2 (the depth set on the idle
    engine), then a 21-token prompt and one sharing its first 18 tokens,
    which hits the prefix cache at 16. {side: (ids by run, counters)}."""
    runs = {1: [(_prompt(3, 13), dict(max_tokens=9)),
                (_prompt(4, 5), dict(max_tokens=12))],
            2: [(_prompt(5, 11), dict(max_tokens=10)),
                (_prompt(6, 3), dict(max_tokens=14))]}
    head = _prompt(7, 18)
    sides = {"port": tg.GenerationEngine(tm, **kw),
             "jax": jg.GenerationEngine(jm, params, jm.cfg, **kw)}
    out = {}
    try:
        for side, eng in sides.items():
            ids = {}
            for depth, requests in runs.items():
                eng.pipeline_depth = depth
                ids[depth] = _run(eng, requests)
            ids["prefix"] = [eng.submit(head + tail, max_tokens=8)[
                "output_ids"] for tail in ([5, 9, 2], [7, 1])]
            out[side] = (ids, _counters(eng))
    finally:
        for eng in sides.values():
            eng.close()
    out["requests"] = {**runs, "prefix": [(head + [5, 9, 2], {}),
                                          (head + [7, 1], {})]}
    return out


@pytest.fixture(scope="module")
def rolling_story(windowed):
    return _engine_story(*windowed, **ROLLING, prefix_cache=4)


@pytest.fixture(scope="module")
def within_story(within):
    return _engine_story(*within, **ROLLING, prefix_cache=4)


def test_engine_configuration(windowed, within):
    _, _, tm = windowed
    eng = tg.GenerationEngine(tm, **ROLLING)
    try:
        assert eng._rolling == WINDOW
        assert eng.prefill_buckets == [4, WINDOW]
        assert eng.decode_buckets == [WINDOW]
        assert eng.cfg.mask_kind == "sliding_window"
        assert sorted(eng._cache) == ["k", "pos", "v"]
        assert eng._cache["k"].shape[2] == WINDOW
    finally:
        eng.close()
    _, _, view = within
    eng = tg.GenerationEngine(view, **ROLLING)
    try:
        assert eng._rolling == 0
        assert eng.decode_buckets == [32]
        assert (eng.cfg.mask_kind, eng.cfg.attention_impl) == ("causal",
                                                               "auto")
        assert "pos" not in eng._cache
        # The caller's module keeps its windowed config; the engine's view
        # shares its weights.
        assert view.cfg.mask_kind == "sliding_window"
        assert view.layers[0].attn.cfg.mask_window == 32
        assert eng.model.layers[0].attn.cfg.mask_kind == "causal"
        assert eng.model.embed is view.embed
        assert (eng.model.layers[1].mlp.up_proj.weight
                is view.layers[1].mlp.up_proj.weight)
    finally:
        eng.close()


@pytest.mark.parametrize("kind", ["rolling", "within"])
@pytest.mark.parametrize("run", [1, 2, "prefix"])
def test_engine_ids_match_jax(request, kind, run):
    story = request.getfixturevalue(f"{kind}_story")
    assert story["port"][0][run] == story["jax"][0][run]


@pytest.mark.parametrize("kind", ["rolling", "within"])
def test_engine_counters_match_jax(request, kind):
    story = request.getfixturevalue(f"{kind}_story")
    assert story["port"][1] == story["jax"][1]
    counters = story["port"][1]
    assert counters["prefix_hits"] >= 1
    assert counters["prefix_hit_tokens"] >= 16
    assert counters["decode_fetch_overlapped"] > 0


@pytest.mark.parametrize("kind", ["rolling", "within"])
def test_engine_ids_match_the_windowed_rollout(request, kind):
    story = request.getfixturevalue(f"{kind}_story")
    jm, params, _ = request.getfixturevalue(
        "windowed" if kind == "rolling" else "within")
    for run in (1, 2, "prefix"):
        for (prompt, kw), got in zip(story["requests"][run],
                                     story["port"][0][run]):
            assert got == ref_greedy(jm, params, prompt,
                                     kw.get("max_tokens", 8)), (run, prompt)


def test_slot_reused_by_shorter_request(windowed):
    """One slot: a 20-token request, then a 6-token one. The insert copies
    the fragment's positions with its K/V; the slot's old positions (up
    to 29) would otherwise hide the new prompt's rows as stale."""
    jm, params, tm = windowed
    eng = tg.GenerationEngine(tm, **dict(ROLLING, slots=1))
    try:
        for prompt, n in ((_prompt(8, 20), 10), (_prompt(9, 6), 12)):
            got = eng.submit(prompt, max_tokens=n)["output_ids"]
            assert got == ref_greedy(jm, params, prompt, n)
    finally:
        eng.close()


def test_rolling_riders_wait(windowed, within):
    """A vanilla dispatch on a rolling cache carries no live row of the
    other sub-batch (a row a spec record holds): that row's write, parked
    at its own `disp`, would wrap onto its live window rows. The flat
    cache parks it, away from the context end."""
    engines = {kind: tg.GenerationEngine(m[2], **ROLLING)
               for kind, m in (("rolling", windowed), ("flat", within))}
    for eng in engines.values():
        eng.close()  # the loop stops; the slots below are the test's
        eng._slots[:] = [{"disp": 20}, {"disp": 5}]
    assert not engines["rolling"]._van_riders_fit([1])
    assert engines["rolling"]._van_riders_fit([0, 1])
    assert engines["flat"]._van_riders_fit([1])


def test_metadata_reads_the_window(windowed):
    tm = windowed[2]
    model = tg.GenerativeTorchModel("m", tm, generation=dict(ROLLING))
    model.load()
    try:
        md = model.metadata()
        assert md["decode_buckets"] == [WINDOW]
        assert md["paged_kv"] is None
    finally:
        model.unload()


# -- speculative decoding -----------------------------------------------------

@pytest.fixture(scope="module")
def spec_story(windowed, tmp_path_factory):
    """A rolling target with a draft near it (noisy weights, a sliding
    window of 32: within max_len, served through a causal view) and one
    adapter: a base row and an adapter row at once, then each alone,
    through the JAX engine and the port's."""
    jm, params, tm = windowed
    dj, dparams, dt = _pair(window=32, num_layers=2, noise=0.3)
    ada = write_synthetic_adapter(
        tm.cfg, str(tmp_path_factory.mktemp("ada") / "ada"), 21, r=8,
        alpha=400.0)
    kw = dict(slots=2, max_len=32, chunk=8, prefill_buckets=(8,),
              adapters={"ada": ada})
    requests = [(_prompt(10, 11), dict(max_tokens=12)),
                (_prompt(11, 7), dict(max_tokens=10, adapter="ada"))]
    sides = {"port": tg.GenerationEngine(
                 tm, draft={"model": dt, "gamma": 3}, **kw),
             "jax": jg.GenerationEngine(
                 jm, params, jm.cfg, draft={"model": dj, "params": dparams,
                                            "cfg": dj.cfg, "gamma": 3},
                 **kw)}
    out = {}
    try:
        for side, eng in sides.items():
            burst = _run(eng, requests)
            alone = [eng.submit(p, **k)["output_ids"] for p, k in requests]
            out[side] = (burst, alone, _counters(eng))
        out["draft_cfg"] = sides["port"]._spec["cfg"]
    finally:
        for eng in sides.values():
            eng.close()
    out["requests"], out["draft"] = requests, dt
    return out


def test_spec_rolling_target_matches_jax(spec_story):
    assert spec_story["port"] == spec_story["jax"]


def test_spec_rolling_target_reverts_rejections(windowed, spec_story):
    """Greedy ids equal the windowed rollout although proposals were
    rejected across the wrap (the revert of the rejected rows), and the
    rolling spec chain stayed at depth 1."""
    jm, params, _ = windowed
    burst, alone, counters = spec_story["port"]
    prompt, kw = spec_story["requests"][0]
    want = ref_greedy(jm, params, prompt, kw["max_tokens"])
    assert burst[0] == alone[0] == want
    assert burst[1] == alone[1]
    assert counters["spec_dispatches"] > 0
    assert 0 < counters["spec_accepted"] < counters["spec_proposed"]
    assert spec_story["draft_cfg"].mask_kind == "causal"
    assert spec_story["draft"].cfg.mask_kind == "sliding_window"


# -- int8 weights ---------------------------------------------------------------

@pytest.fixture(scope="module")
def quantized(windowed):
    """The windowed model with every projection int8 (min_size 512), in
    both packages."""
    jm, params, _ = windowed
    tm = _pair()[2]
    return jm, jq.quantize_tree(params, min_size=512), tq.quantize_model(
        tm, min_size=512)


@pytest.mark.parametrize("kind", ["rolling", "within"])
def test_int8_weights_serve(quantized, kind):
    jm, qparams, qt = quantized
    if kind == "within":
        jm = jl.Llama(dataclasses.replace(jm.cfg, mask_window=32))
        qt = tl.config_view(qt, dataclasses.replace(qt.cfg, mask_window=32))
    eng = tg.GenerationEngine(qt, **ROLLING)
    try:
        assert bool(eng._rolling) == (kind == "rolling")
        assert isinstance(eng.model.layers[0].attn.q_proj, tq.Int8Dense)
        assert eng.model.cfg.quantized_dense
        prompt = _prompt(12, 13)
        got = eng.submit(prompt, max_tokens=9)["output_ids"]
    finally:
        eng.close()
    assert got == ref_greedy(jq.QuantizedModule(jm, jnp.float32), qparams,
                             prompt, 9)


# -- refusals -----------------------------------------------------------------

def _refusal(case, jm, params, tm):
    """(JAX call, port call) of one refused configuration."""
    dj, dparams, dt = _pair(window=WINDOW, num_layers=1, seed=1)
    if case == "paged":
        kw = dict(ROLLING, kv_block_size=8)
        return (lambda: jg.GenerationEngine(jm, params, jm.cfg, **kw),
                lambda: tg.GenerationEngine(tm, **kw))
    if case == "kv_quant_cache":
        return (lambda: jl.init_cache(jm.cfg, 1, 32, kv_quant="int8"),
                lambda: tl.init_cache(tm.cfg, 1, 32, kv_quant="int8",
                                      device="cpu"))
    if case == "window_0":
        jc = dataclasses.replace(jm.cfg, mask_window=0)
        tc = dataclasses.replace(tm.cfg, mask_window=0)
        return (lambda: jg.GenerationEngine(jl.Llama(jc), params, jc,
                                            **ROLLING),
                lambda: tg.GenerationEngine(tl.config_view(tm, tc),
                                            **ROLLING))
    if case == "gamma":
        # A causal draft: only the rolling window's size is at fault.
        jc = dataclasses.replace(dj.cfg, mask_kind="causal", mask_window=0)
        tc = dataclasses.replace(dt.cfg, mask_kind="causal", mask_window=0)
        return (lambda: jg.GenerationEngine(
                    jm, params, jm.cfg, draft={
                        "model": jl.Llama(jc), "params": dparams, "cfg": jc,
                        "gamma": WINDOW}, **ROLLING),
                lambda: tg.GenerationEngine(
                    tm, draft={"model": tl.config_view(dt, tc),
                               "gamma": WINDOW}, **ROLLING))
    if case == "draft_past_window":
        return (lambda: jg.GenerationEngine(
                    jm, params, jm.cfg, draft={
                        "model": dj, "params": dparams, "cfg": dj.cfg},
                    **ROLLING),
                lambda: tg.GenerationEngine(tm, draft={"model": dt},
                                            **ROLLING))
    if case == "paged_spec":
        return (lambda: jg.build_spec_decode(
                    jm, dj, gamma=3, n_spec=1, max_len=32,
                    rolling_window=WINDOW, kv_block_size=8),
                lambda: tg.build_spec_decode(
                    tm, dt, gamma=3, n_spec=1, kv_block_size=8))
    assert case == "paged_fns"
    return (lambda: jg.build_engine_fns(
                jm, jm.cfg, max_len=32, chunk=4, prefill_buckets=(8,),
                offset_writes=False, rolling_window=WINDOW, kv_block_size=8),
            lambda: tg.build_engine_fns(
                tm, max_len=32, chunk=4, prefill_buckets=(8,),
                kv_block_size=8))


@pytest.mark.parametrize("case", ["paged", "kv_quant_cache", "window_0",
                                  "gamma", "draft_past_window", "paged_spec",
                                  "paged_fns"])
def test_refusals_match_jax(windowed, case):
    jax_call, port_call = _refusal(case, *windowed)
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as terr:
        port_call()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("length", [WINDOW - 1, WINDOW, WINDOW + 1, 32])
def test_one_rolling_rule(windowed, length):
    """`rolling_window` decides the cache's layout, and the builders follow
    it: a rolling cache past the window, a flat one within it, where the
    device functions refuse the windowed model (its causal view serves
    it)."""
    tm = windowed[2]
    window = tl.rolling_window(tm.cfg, length)
    cache = tl.init_cache(tm.cfg, 1, length, device="cpu")
    assert window == (WINDOW if length > WINDOW else 0)
    assert ("pos" in cache) == bool(window)
    assert cache["k"].shape[2] == (window or length)
    kw = dict(max_len=length, chunk=4, prefill_buckets=(4,))
    if window:
        assert tg.build_engine_fns(tm, **kw)["frag_len"] > window
    else:
        with pytest.raises(ValueError, match="served through its causal "
                                             "view"):
            tg.build_engine_fns(tm, **kw)
        causal = tg._causal_config(tm.cfg)
        fns = tg.build_engine_fns(tl.config_view(tm, causal), **kw)
        assert "pos" not in tl.init_cache(causal, 1, fns["frag_len"],
                                          device="cpu")
