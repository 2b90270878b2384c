"""The port's prefix cache (serve/generation.py: flat fragments, paged
block references with zero-copy hits and copy-on-write forks, quantized
pools, adapter keys) against the JAX engine on the CPU, on the same fp32
weights (llama_params_from_jax).

Ports of the JAX package's cases: counters and exact output, the LRU at
its cap, skipped boundary stores, a no-op re-store, adapter-keyed
isolation, the hash-collision verify (tests/test_prefix_cache.py); the
same output on reuse, the offset-write headroom, the bounded LRU
(tests/test_generate_buckets.py); a zero-copy hit with a CoW fork and
cache blocks reclaimed under pool pressure, the hit evicted last
(tests/test_paged_kv.py); quantized CoW with refcounts conserved and
`kv_dequant_fallbacks` (tests/test_kv_quant.py); the cache keyed by
adapter (tests/test_multilora.py). Then the port's own traps (a hit's
fragment is never written in place; a hit runs no first-chunk prefill)
and one request sequence through the JAX engine and the port, flat, paged
and int8-paged: equal greedy ids and equal prefix counters."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve.generation import GenerationEngine as JaxEngine
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.generation import GenerationEngine
from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter
from tests.test_torch_generation import ref_greedy

#: The JAX prefix-cache tests' engine: one slot, one 8-token bucket.
FLAT = dict(slots=1, max_len=64, chunk=4, prefill_buckets=(8,))
#: The JAX paged tests' engine (tests/test_paged_kv.py `_engine`).
PAGED = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8,),
             pipeline_depth=1, kv_block_size=8)
#: The counters the parity test holds equal to the JAX engine's.
COUNTERS = ("prefix_hits", "prefix_hit_tokens", "prefix_misses",
            "prefix_stores", "kv_cow_copies", "prefix_zero_copy_hits",
            "kv_dequant_fallbacks", "prefill_chunks", "requests",
            "prompt_tokens")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               num_layers=2)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=2)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(
        jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tl.Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def adapter_dir(pair, tmp_path_factory):
    """A synthetic q/v adapter whose scale (alpha/r = 50) moves the tiny
    model's K/V well clear of the base's."""
    return write_synthetic_adapter(
        pair[2].cfg, str(tmp_path_factory.mktemp("ada") / "ada"), 21, r=8,
        alpha=400.0)


def _engine(pair, base=FLAT, **kw):
    return GenerationEngine(pair[2], **{**base, **kw})


def _cold(pair, prompt, n, base=FLAT, **kw):
    """Greedy ids of `prompt` on a fresh engine without a prefix cache."""
    eng = _engine(pair, base, **kw)
    try:
        return eng.submit(prompt, max_tokens=n)["output_ids"]
    finally:
        eng.close()


def _rng_prompt(seed, n):
    return list(map(int, np.random.default_rng(seed).integers(1, 512, n)))


def _evict_all(eng) -> None:
    while eng._prefix_lru:
        eng._prefix_evict(next(iter(eng._prefix_lru)))


# -- tests/test_prefix_cache.py -----------------------------------------------

def test_hit_miss_counters_and_exact_output(pair):
    """A cold admission counts a miss; a shared-head resubmit hits the
    longest chunk-boundary prefix strictly shorter than the prompt, and
    the continuation still greedy-decodes like the uncached reference."""
    jm, params, _ = pair
    head = [7, 3, 11, 2, 9, 1, 4, 4, 30, 8, 2, 5, 19, 6, 1, 3]  # 2 chunks
    eng = _engine(pair, prefix_cache=8)
    try:
        eng.submit(head + [40, 2], max_tokens=4)
        assert eng.stats["prefix_misses"] == 1
        assert eng.stats["prefix_hits"] == 0
        out = eng.submit(head + [12, 33, 5], max_tokens=8)
        assert eng.stats["prefix_hits"] == 1
        assert eng.stats["prefix_hit_tokens"] >= 16
        assert out["output_ids"] == ref_greedy(jm, params,
                                               head + [12, 33, 5], 8)
    finally:
        eng.close()


def test_lru_eviction_at_cap(pair):
    """The cache never exceeds its cap; the oldest entry goes (an evicted
    head no longer hits, a resident one does), and the length index
    shrinks with it."""
    eng = _engine(pair, prefix_cache=2)
    heads = [[i + 1] * 6 for i in range(4)]  # one boundary per admission
    try:
        for h in heads:
            eng.submit(h, max_tokens=2)
        assert len(eng._prefix_lru) <= 2
        assert sum(len(v) for v in eng._prefix_lens.values()) <= 2
        hits0 = eng.stats["prefix_hits"]
        eng.submit(heads[0] + [50], max_tokens=2)  # evicted long ago
        assert eng.stats["prefix_hits"] == hits0
        eng.submit(heads[3] + [50], max_tokens=2)  # still resident
        assert eng.stats["prefix_hits"] == hits0 + 1
    finally:
        eng.close()


def test_immediately_evicted_boundary_stores_skipped(pair):
    """A 3-chunk admission at cap 1 stores one fragment (the final
    boundary, the only one that can survive)."""
    eng = _engine(pair, prefix_cache=1)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 60, 22)]
    try:
        eng.submit(prompt, max_tokens=2)
        assert eng.stats["prefix_stores"] == 1
        assert len(eng._prefix_lru) == 1
        (aid, n, _h), = eng._prefix_lru
        assert (aid, n) == (0, len(prompt))
    finally:
        eng.close()


def test_noop_restore_does_not_copy(pair):
    """Re-admitting an identical prompt touches the LRU without a store."""
    eng = _engine(pair, prefix_cache=4)
    prompt = [9, 9, 2, 4, 1, 7, 7, 3, 6, 6]
    try:
        eng.submit(prompt, max_tokens=2)
        stores = eng.stats["prefix_stores"]
        eng.submit(prompt, max_tokens=2)
        assert eng.stats["prefix_stores"] == stores
    finally:
        eng.close()


@pytest.mark.parametrize("base", [pytest.param(FLAT, id="flat"),
                                  pytest.param(PAGED, id="paged")])
def test_adapter_keyed_isolation(pair, adapter_dir, base):
    """A prefix computed under an adapter holds its K/V deltas and never
    serves the base: cross-adapter lookups miss and the base stream stays
    the adapter-free reference; a same-adapter extension hits, and a
    cached resubmit equals the cold one."""
    jm, params, _ = pair
    prompt = list(range(2, 18))  # 2 chunks
    eng = _engine(pair, base, prefix_cache=8, adapters={"ada": adapter_dir})
    try:
        out_a = eng.submit(prompt + [40], max_tokens=5, adapter="ada")
        hits = eng.stats["prefix_hits"]
        out_base = eng.submit(prompt + [40], max_tokens=5)
        assert eng.stats["prefix_hits"] == hits
        assert out_base["output_ids"] == ref_greedy(jm, params,
                                                    prompt + [40], 5)
        assert out_a["output_ids"] != out_base["output_ids"]
        eng.submit(prompt + [40, 12], max_tokens=5, adapter="ada")
        assert eng.stats["prefix_hits"] == hits + 1
        rerun = eng.submit(prompt + [40], max_tokens=5, adapter="ada")
        assert rerun["output_ids"] == out_a["output_ids"]
    finally:
        eng.close()


@pytest.mark.parametrize("base", [pytest.param(FLAT, id="flat"),
                                  pytest.param(PAGED, id="paged")])
def test_hash_collision_entry_never_serves_wrong_tokens(pair, base):
    """A fabricated same-(aid, len, hash) entry is rejected by the token
    verify (a collision costs a miss, never a wrong prefix). Paged, the
    store that then overwrites it drops the displaced entry's block
    references: after everything is evicted the pool is whole."""
    jm, params, _ = pair
    eng = _engine(pair, base, prefix_cache=4)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]  # one full chunk boundary
    try:
        eng.submit(prompt, max_tokens=2)
        ((aid, n, _h), (kt, payload)), = list(eng._prefix_lru.items())
        fake = tuple([99] * n)
        eng._prefix_lru.clear()
        eng._prefix_lru[(aid, n, hash(fake))] = (kt, payload)
        eng._prefix_lens = {aid: {n: 1}}
        hits0 = eng.stats["prefix_hits"]
        out = eng.submit(list(fake) + [7], max_tokens=4)
        assert eng.stats["prefix_hits"] == hits0  # the verify rejected it
        assert out["output_ids"] == ref_greedy(jm, params,
                                               list(fake) + [7], 4)
        (key, (kt2, _)), = [(k, v) for k, v in eng._prefix_lru.items()
                            if k[1] == n]
        assert kt2 == fake  # the real prefix displaced the collision
        if eng._paged:
            _evict_all(eng)
            assert eng._kv_alloc.free_blocks == eng._kv_alloc.n_blocks
    finally:
        eng.close()


# -- tests/test_generate_buckets.py ---------------------------------------------

def test_prefix_cache_reuse_same_output(pair):
    """A request sharing a long head with an earlier one admits through
    the cache (fewer chunks run) and produces the exact greedy
    continuation."""
    jm, params, _ = pair
    head = [7, 3, 11, 2, 9, 1, 4, 4, 30, 8, 2, 5, 19, 6, 1, 3,
            22, 9, 9, 1, 7, 2, 13, 5]  # 24 tokens = 3 full 8-chunks
    want = _cold(pair, head + [12, 33], 8)
    warm = _engine(pair, prefix_cache=8)
    try:
        warm.submit(head + [40, 2, 6], max_tokens=4)
        chunks = warm.stats["prefill_chunks"]
        assert warm.stats["prefix_hits"] == 0
        got = warm.submit(head + [12, 33], max_tokens=8)["output_ids"]
        assert warm.stats["prefix_hits"] == 1
        assert warm.stats["prefix_hit_tokens"] >= 24
        assert warm.stats["prefill_chunks"] - chunks == 1
    finally:
        warm.close()
    assert got == want == ref_greedy(jm, params, head + [12, 33], 8)


def test_prefix_cache_offset_write_headroom(pair):
    """With the largest prefill bucket equal to max_len no prompt chunks,
    yet a hit resumes `extend` with a bucket-wide write at a nonzero
    offset: the fragment needs its headroom (without it the write runs
    past the fragment)."""
    jm, params, _ = pair
    head = [7, 3, 11, 2, 9, 1, 4, 4, 30, 8] * 4  # 40 tokens
    suffix = [40, 2, 6, 9, 1, 22, 5, 13, 2, 17]
    kw = dict(prefill_buckets=(8, 64))
    want = _cold(pair, head + suffix, 8, **kw)
    warm = _engine(pair, prefix_cache=8, **kw)
    try:
        warm.submit(head, max_tokens=2)  # stores the 40-token prefix
        got = warm.submit(head + suffix, max_tokens=8)["output_ids"]
        assert warm.stats["prefix_hits"] == 1
    finally:
        warm.close()
    assert got == want == ref_greedy(jm, params, head + suffix, 8)


def test_prefix_cache_lru_bounded(pair):
    eng = _engine(pair, prefix_cache=2)
    try:
        for i in range(5):
            eng.submit([i + 1] * 10, max_tokens=2)
        assert len(eng._prefix_lru) <= 2
    finally:
        eng.close()


# -- tests/test_paged_kv.py -----------------------------------------------------

def test_prefix_zero_copy_hit_and_cow_fork(pair):
    """A paged hit maps the fully committed blocks into the new table by
    reference and forks only the partial tail block; the continued request
    equals the reference, and a block-aligned hit forks nothing."""
    jm, params, _ = pair
    eng = _engine(pair, PAGED, slots=4, prefix_cache=4, seed=5,
                  kv_blocks=24)
    base = list(range(2, 22))  # 20 tokens: 2 full blocks + a 4-row tail
    try:
        r1 = eng.submit(base, max_tokens=6)
        assert r1["output_ids"] == ref_greedy(jm, params, base, 6)
        assert eng.kv_blocks_used > 0  # the cache's references
        r2 = eng.submit(base + [31, 32], max_tokens=6)
        assert r2["output_ids"] == ref_greedy(jm, params, base + [31, 32], 6)
        s = eng.stats
        assert s["prefix_hits"] == 1
        assert s["prefix_zero_copy_hits"] == 1  # 2 shared full blocks
        assert s["kv_cow_copies"] == 1  # the forked tail block
        aligned = base[:16]
        r3 = eng.submit(aligned + [40], max_tokens=4)
        assert r3["output_ids"] == ref_greedy(jm, params, aligned + [40], 4)
        assert eng.stats["kv_cow_copies"] == 1
        _evict_all(eng)
        assert eng.kv_blocks_used == 0
    finally:
        eng.close()


def test_prefix_cache_blocks_reclaimed_under_pressure(pair):
    """Cached prefix blocks yield to live traffic: when the pool cannot
    cover an admission, LRU entries are evicted (their blocks freed)
    instead of the admission waiting forever, and no reference leaks."""
    jm, params, _ = pair
    eng = _engine(pair, PAGED, prefix_cache=8, kv_blocks=6)
    try:
        p1 = list(range(2, 20))  # 18 tokens -> 3 blocks
        eng.submit(p1, max_tokens=4)
        assert eng.kv_blocks_used >= 3
        p2 = list(range(30, 55))  # needs 5 blocks: only with the cache's
        out = eng.submit(p2, max_tokens=8, timeout=120)
        assert out["output_ids"] == ref_greedy(jm, params, p2, 8)
        cached = {b for _, bl in eng._prefix_lru.values() for b in bl}
        assert eng.kv_blocks_used == len(cached)
        p3 = list(range(60, 85))
        out = eng.submit(p3, max_tokens=8, timeout=120)
        assert out["output_ids"] == ref_greedy(jm, params, p3, 8)
    finally:
        eng.close()


def test_kv_fits_evicts_the_hit_last(pair):
    """Under pressure `_kv_fits` evicts the entries that are not the
    admission's hit first, an entry newer than the hit included, and keeps
    the hit's discount (a zero-copy hit, not a cold run); an admission
    that fits only without its hit's discount evicts the hit too and runs
    cold. The JAX engine makes the same evictions, and gives the same ids
    and counters."""
    head = _rng_prompt(7, 16)
    others = [_rng_prompt(8 + i, 16) for i in range(2)]
    second = head + [5, 6, 7]

    def story(eng):
        # An 8-block pool: head + [1] leaves 3 blocks in the cache (entries
        # at 8, 16 and 17 tokens), each other prompt 2 more; `second`
        # needs 4, 2 of them shared with the 16-token entry, its hit.
        eng.submit(head + [1], max_tokens=2)
        for o in others:
            eng.submit(o, max_tokens=2)
        kept = eng.submit(second, max_tokens=12)["output_ids"]
        keys = {(k[1], v[0]) for k, v in eng._prefix_lru.items()}
        after_keep = dict(eng.stats_snapshot())
        eng.submit(_rng_prompt(20, 16), max_tokens=2)
        # 45 tokens + 12 need all 8 blocks: keeping the 19-token hit (2
        # shared) leaves too few to reclaim, so the hit goes as well.
        gone = eng.submit(second + _rng_prompt(21, 26),
                          max_tokens=12)["output_ids"]
        return kept, gone, keys, after_keep, eng.stats_snapshot()

    kw = dict(prefix_cache=8, kv_blocks=8)
    eng = _engine(pair, PAGED, **kw)
    try:
        got = story(eng)
        assert eng._kv_alloc.n_blocks == 8
    finally:
        eng.close()
    jm, params, _ = pair
    jeng = JaxEngine(jm, params, jm.cfg, **{**PAGED, **kw})
    try:
        want = story(jeng)
    finally:
        jeng.close()
    kept, gone, keys, after_keep, final = got
    assert (16, tuple(head)) in keys  # the hit stayed
    assert (17, tuple(head + [1])) not in keys  # a newer entry went
    assert after_keep["prefix_hits"] == 1  # and the hit kept its discount
    assert after_keep["prefix_zero_copy_hits"] == 1
    assert final["prefix_hits"] == 1  # the 45-token request ran cold
    assert kept == ref_greedy(jm, params, second, 12)
    assert (kept, gone, keys) == want[:3]
    for key in COUNTERS:
        assert after_keep[key] == want[3][key], key
        assert final[key] == want[4][key], key


# -- tests/test_kv_quant.py -----------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_prefix_cow_and_refcount_conservation(pair, mode):
    """A quantized hit maps full blocks zero-copy and forks the partial
    tail with its scale rows; the fragment rebuild is the one counted
    dequant; the resumed stream equals a fresh recompute's ids (logprobs
    within 0.05: the hit attends dequantized prompt rows); and after
    everything retires and is evicted the pool is whole."""
    kw = dict(max_len=64, chunk=4, prefill_buckets=(8, 16), kv_block_size=8,
              slots=2, kv_blocks=24, seed=0, kv_quant=mode)
    eng = GenerationEngine(pair[2], prefix_cache=2, **kw)
    try:
        p1 = _rng_prompt(21, 17)  # 17 tokens: a partial tail block
        eng.submit(p1 + [5], max_tokens=4)
        s = eng.stats_snapshot()
        cow0, fb0 = s["kv_cow_copies"], s["kv_dequant_fallbacks"]
        probe = p1 + [5, 9, 9]
        r = eng.submit(probe, max_tokens=4)
        s = eng.stats_snapshot()
        assert s["prefix_hits"] >= 1
        assert s["kv_cow_copies"] > cow0
        assert s["kv_dequant_fallbacks"] == fb0 + 1
        fresh = GenerationEngine(pair[2], **kw)
        try:
            ref = fresh.submit(probe, max_tokens=4)
        finally:
            fresh.close()
        assert r["output_ids"] == ref["output_ids"]
        np.testing.assert_allclose(r["output_logprobs"],
                                   ref["output_logprobs"], rtol=0,
                                   atol=0.05)
        _evict_all(eng)
        assert eng._kv_alloc.used_blocks == 0
        assert eng._kv_alloc.free_blocks == eng._kv_alloc.n_blocks
    finally:
        eng.close()


# -- tests/test_multilora.py -----------------------------------------------------

def test_multilora_prefix_cache_keyed_by_adapter(pair, adapter_dir):
    """The same prompt under the adapter, then the base, on one cached
    engine: each equals its own cacheless engine's ids, and a same-adapter
    resubmit may hit without changing the output."""
    kw = dict(slots=2, max_len=32, chunk=4, prefill_buckets=(4, 8),
              adapters={"ada": adapter_dir})
    prompt = list(range(2, 12))  # spans chunk boundaries
    ref = GenerationEngine(pair[2], **kw)
    try:
        want_a = ref.submit(prompt, max_tokens=5, adapter="ada")["output_ids"]
        want_base = ref.submit(prompt, max_tokens=5)["output_ids"]
    finally:
        ref.close()
    eng = GenerationEngine(pair[2], prefix_cache=4, **kw)
    try:
        out_a = eng.submit(prompt, max_tokens=5, adapter="ada")
        out_base = eng.submit(prompt, max_tokens=5)
        assert out_a["output_ids"] == want_a
        assert out_base["output_ids"] == want_base
        again = eng.submit(prompt, max_tokens=5, adapter="ada")
        assert again["output_ids"] == want_a
        assert eng.stats["prefix_hits"] == 1
    finally:
        eng.close()


# -- the port's own traps ----------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_hit_fragment_is_never_written_in_place(pair, depth):
    """`extend` writes into the fragment it is given, so a hit extends a
    clone: Q resumes at P's 8-token boundary and stores its own final
    prefix; R resumes at the same boundary; S then hits Q's final prefix,
    whose rows past 8 R must not have overwritten."""
    p = _rng_prompt(40, 20)
    q = p[:8] + _rng_prompt(41, 12)
    r = p[:8] + _rng_prompt(42, 12)
    s = q + [77]
    eng = _engine(pair, prefix_cache=8, pipeline_depth=depth)
    try:
        for prompt in (p, q, r):
            eng.submit(prompt, max_tokens=3)
        got = eng.submit(s, max_tokens=6)["output_ids"]
        assert eng.stats["prefix_hits"] == 3
        assert eng.stats["prefix_hit_tokens"] == 8 + 8 + len(q)
    finally:
        eng.close()
    assert got == _cold(pair, s, 6)


@pytest.mark.parametrize("base", [pytest.param(FLAT, id="flat"),
                                  pytest.param(PAGED, id="paged")])
def test_hit_runs_no_first_chunk_prefill(pair, base):
    """A miss runs its first chunk through `prefill` (flash attention on
    the card); a hit at a chunk boundary runs none and one chunk fewer."""
    head = _rng_prompt(50, 16)
    eng = _engine(pair, base, prefix_cache=4)
    calls = []
    real = eng._fns["prefill"]
    eng._fns["prefill"] = lambda *a: calls.append(1) or real(*a)
    try:
        eng.submit(head + [3, 4], max_tokens=2)
        assert (len(calls), eng.stats["prefill_chunks"]) == (1, 3)
        eng.submit(head + [5, 6], max_tokens=2)
        assert (len(calls), eng.stats["prefill_chunks"]) == (1, 4)
        assert eng.stats["prefix_hit_tokens"] == 16
    finally:
        eng.close()


# -- the same requests through the JAX engine ----------------------------------------

HEAD = _rng_prompt(90, 16)
A = HEAD + _rng_prompt(91, 5)
#: (prompt, adapter): a miss, a second turn hitting A's whole prompt (21 =
#: 2 blocks + a 5-row tail: a CoW fork), hits at the 16-token boundary, an
#: unrelated prompt that evicts, a repeat, and two requests under an
#: adapter.
PARITY_REQUESTS = [
    (A, None), (A + _rng_prompt(94, 7), None),
    (HEAD + _rng_prompt(92, 9), None), (HEAD + _rng_prompt(93, 20), None),
    (_rng_prompt(95, 30), None), (HEAD + _rng_prompt(92, 9), None),
    (A, "ada"), (HEAD + _rng_prompt(96, 3), "ada")]
PARITY = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16),
              prefix_cache=4, pipeline_depth=1)


@pytest.mark.parametrize("pool", ["flat", "paged", "int8"])
def test_counter_parity_with_jax(pair, adapter_dir, pool):
    """One request sequence, one at a time, through the JAX engine and the
    port: equal greedy ids after every request and equal prefix, CoW,
    zero-copy, dequant-fallback and chunk counters at the end."""
    kw = dict(PARITY)
    reqs = PARITY_REQUESTS
    if pool != "flat":
        kw.update(kv_block_size=8, kv_blocks=24)
    if pool == "int8":
        kw["kv_quant"] = "int8"
        reqs = [r for r in reqs if r[1] is None]
    else:
        kw["adapters"] = {"ada": adapter_dir}
    jm, params, tm = pair
    sides = {"port": GenerationEngine(tm, **kw),
             "jax": JaxEngine(jm, params, jm.cfg, **kw)}
    out = {}
    try:
        for side, eng in sides.items():
            ids = [eng.submit(p, max_tokens=4, adapter=a)["output_ids"]
                   for p, a in reqs]
            s = eng.stats_snapshot()
            out[side] = (ids, {k: s[k] for k in COUNTERS},
                         eng.kv_info() and {k: eng.kv_info()[k] for k in (
                             "blocks_free", "blocks_used")})
    finally:
        for eng in sides.values():
            eng.close()
    assert out["port"] == out["jax"]
    counters = out["port"][1]
    assert counters["prefix_hits"] >= 3 and counters["prefix_misses"] >= 2
    if pool != "flat":
        assert counters["kv_cow_copies"] >= 1
        assert counters["prefix_zero_copy_hits"] >= 3
    assert counters["kv_dequant_fallbacks"] == (
        counters["prefix_hits"] if pool == "int8" else 0)
