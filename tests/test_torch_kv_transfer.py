"""The port's KV wire format and host tier (serve/kv_transfer.py and the
paged engine's spill and restore) against the JAX package on the CPU.

Frames packed by the port are byte-identical to the JAX package's for the
same arrays, bfloat16 and float8 included (the port never needs
ml_dtypes), and each side reads the other's; malformed frames are refused
by both; `HostKVTier` runs one sequence of puts, probes and takes with the
JAX tier's results and counters. Through the engine: pool -> wire -> pool
is byte-identical (fp32, bf16 and an int8 pool's fmt 3), and the JAX
engine's host-tier cases (refcounts conserved with a CoW fork after a
restore, the tier's LRU under pool pressure, a restore skipped when the
admission would not fit) give the JAX engine's ids and counters on the
same weights (fp32, llama_params_from_jax)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import kv_transfer as jkv
from kubeflow_tpu.serve.generation import GenerationEngine as JaxEngine
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve import kv_transfer as tkv
from kubeflow_tpu_torch.serve.generation import GenerationEngine

GEN = dict(max_len=64, chunk=4, prefill_buckets=(8, 16), kv_block_size=8,
           slots=2, kv_blocks=24, seed=0)
#: The engine stats the tier cases hold equal to the JAX engine's.
TIER_STATS = ("prefix_hits", "prefix_hit_tokens", "prefix_misses",
              "prefix_stores", "kv_cow_copies", "prefix_zero_copy_hits",
              "kv_spilled_blocks", "kv_restored_blocks",
              "kv_dequant_fallbacks", "prefill_chunks")

#: (numpy dtype, torch dtype) of every payload type a shipment carries:
#: full-precision pools, fp8/int8 codes, fp32 scale planes, an RNG key.
DTYPES = [
    pytest.param(np.dtype(np.float32), torch.float32, id="float32"),
    pytest.param(np.dtype(ml_dtypes.bfloat16), torch.bfloat16,
                 id="bfloat16"),
    pytest.param(np.dtype(ml_dtypes.float8_e4m3fn), torch.float8_e4m3fn,
                 id="float8_e4m3fn"),
    pytest.param(np.dtype(np.int8), torch.int8, id="int8"),
    pytest.param(np.dtype(np.uint32), torch.uint32, id="uint32"),
]


def _bits(seed, np_dtype, shape=(2, 3, 8, 2, 16)) -> np.ndarray:
    """Random finite values of `np_dtype` (drawn in float32, then cast, so
    every dtype holds ordinary numbers)."""
    rng = np.random.default_rng(seed)
    if np_dtype.kind in "iu":
        info = np.iinfo(np_dtype)
        return rng.integers(max(info.min, -100), min(info.max, 100), shape,
                            dtype=np.int64).astype(np_dtype)
    return (rng.standard_normal(shape) * 3).astype(np.float32).astype(
        np_dtype)


def _as_torch(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    """The same bytes as a torch tensor, without numpy knowing the type."""
    raw = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8).copy())
    return raw.view(dt).reshape(a.shape)


def _raw(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


# -- the frame ----------------------------------------------------------------

@pytest.mark.parametrize("np_dtype,dt", DTYPES)
def test_frames_byte_identical_to_jax(np_dtype, dt):
    """The port packs torch tensors (or numpy arrays) into the JAX frame,
    byte for byte, and reads it back byte for byte."""
    a = _bits(1, np_dtype)
    meta = {"fmt": 1, "tokens": [1, 2, 3], "nested": {"a": None}}
    want = jkv.pack_shipment(meta, {"k": a, "rng_key": a[0, 0, 0]})
    got = tkv.pack_shipment(meta, {"k": _as_torch(a, dt),
                                   "rng_key": _as_torch(a[0, 0, 0], dt)})
    assert got == want
    assert tkv.pack_shipment(meta, {"k": a, "rng_key": a[0, 0, 0]}) == want
    meta2, arrays = tkv.unpack_shipment(got)
    assert meta2 == meta and tkv.peek_meta(got) == meta
    assert arrays["k"].dtype == dt and tuple(arrays["k"].shape) == a.shape
    assert _raw(arrays["k"]) == a.tobytes()


@pytest.mark.parametrize("np_dtype,dt", DTYPES)
def test_frames_cross_read(np_dtype, dt):
    """A JAX frame read by the port and a port frame read by JAX give the
    same bytes, dtypes and shapes."""
    a = _bits(2, np_dtype, (3, 5, 4))
    _, back = tkv.unpack_shipment(jkv.pack_shipment({"fmt": 3}, {"v": a}))
    assert back["v"].dtype == dt and _raw(back["v"]) == a.tobytes()
    meta, back_j = jkv.unpack_shipment(
        tkv.pack_shipment({"fmt": 3}, {"v": _as_torch(a, dt)}))
    assert meta == {"fmt": 3}
    assert back_j["v"].dtype == np_dtype and back_j["v"].shape == a.shape
    assert back_j["v"].tobytes() == a.tobytes()


def test_empty_and_zero_dim_arrays_round_trip():
    frame = tkv.pack_shipment({}, {"e": torch.zeros(0, 4),
                                   "s": torch.tensor(7, dtype=torch.int32)})
    assert frame == jkv.pack_shipment(
        {}, {"e": np.zeros((0, 4), np.float32), "s": np.int32(7)})
    _, arrays = tkv.unpack_shipment(frame)
    assert tuple(arrays["e"].shape) == (0, 4)
    assert tuple(arrays["s"].shape) == (1,) and int(arrays["s"][0]) == 7


def test_unpack_refuses_malformed():
    """Every malformed frame the JAX test refuses, refused by both sides,
    plus a dtype name neither knows."""
    good = tkv.pack_shipment({"fmt": 1}, {"k": torch.zeros(4)})
    alien = good.replace(b'"float32"', b'"float99"')
    for bad in (b"", b"garbage-bytes", good[:10], good[:-3],
                good + b"trailing", b"TPKV9\n" + good[6:], alien):
        for side in (tkv, jkv):
            with pytest.raises(side.ShipmentError):
                side.unpack_shipment(bad)
    for side in (tkv, jkv):
        with pytest.raises(side.ShipmentError):
            side.peek_meta(b"not a shipment")
        with pytest.raises(side.ShipmentError):
            side.unpack_shipment("not-bytes")


def test_rewrite_meta_splices_header_only():
    a = _bits(3, np.dtype(np.float32), (2, 3, 8, 2, 4))
    data = jkv.pack_shipment({"fmt": 1, "tokens": [5, 6]}, {"k": a})
    stamped = tkv.rewrite_meta(data, resume_skip=7)
    assert stamped == jkv.rewrite_meta(data, resume_skip=7)
    meta, arrays = tkv.unpack_shipment(stamped)
    assert meta == {"fmt": 1, "tokens": [5, 6], "resume_skip": 7}
    assert _raw(arrays["k"]) == a.tobytes()
    for bad in (b"", b"junk", data[:16]):
        with pytest.raises(tkv.ShipmentError):
            tkv.rewrite_meta(bad, resume_skip=1)


# -- the host tier -------------------------------------------------------------

def _tier_story(mod) -> list:
    """The JAX test's sequence of tier operations, with every result and
    counter snapshot along the way."""
    tier = mod.HostKVTier(10)
    log = [tier.put(0, (1, 2), 4, b"a"), tier.put(0, (1, 2, 3), 4, b"b"),
           tier.put(0, (9,), 4, b"c"), tier.stats_snapshot(),
           tier.probe_longest(0, [1, 2, 3, 4]),
           tier.probe_longest(0, [1, 2, 3]),
           tier.probe_longest(1, [1, 2, 3, 4]),
           tier.take(0, (1, 2, 3)), tier.take(0, (1, 2, 3)),
           tier.stats_snapshot(), tier.put(0, (7, 7), 11, b"x"),
           tier.stats_snapshot(), tier.put(2, (5, 6), 2, b"y"),
           tier.take(2, (5, 7)), tier.put(2, (5, 6), 2, b"y"),
           tier.resident_blocks, tier.stats_snapshot()]
    with pytest.raises(ValueError):
        mod.HostKVTier(0)
    return log


def test_host_tier_lru_and_counters_equal_jax():
    port = _tier_story(tkv)
    assert port == _tier_story(jkv)
    s = port[3]
    assert s["resident_blocks"] == 8 and s["evicted_blocks"] == 4
    assert port[4:7] == [3, None, None]
    assert port[7] == (4, b"b") and port[8] is None
    assert port[11]["rejected_blocks"] == 11
    assert port[13] is None


# -- through the engine ----------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The JAX llama_tiny (fp32, 2 layers) and the port's on its weights."""
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


def _port(pair, **kw):
    return GenerationEngine(pair[2], **{**GEN, **kw})


def _jax(pair, **kw):
    jm, params, _ = pair
    return JaxEngine(jm, params, jm.cfg, **{**GEN, **kw})


def rng_prompt(seed, n):
    return list(map(int, np.random.default_rng(seed).integers(1, 512, n)))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_pool_wire_pool_byte_identity(pair, kind):
    """Committed blocks gather -> pack -> unpack -> scatter into fresh
    blocks -> gather again byte-identically (an int8 pool as fmt 3: codes
    and scale planes); the frame the engine's gather packs is the frame
    JAX packs for the same bytes."""
    tm = pair[2]
    kw = {"kv_quant": "int8"} if kind == "int8" else {}
    if kind == "bfloat16":
        tm = tl.Llama(dataclasses.replace(tm.cfg, dtype=torch.bfloat16),
                      device="cpu").init_weights(3)
    eng = GenerationEngine(tm, **{**GEN, "prefix_cache": 1, **kw})
    try:
        eng.submit(rng_prompt(3, 17), max_tokens=2)
        (kt, blocks), = eng._prefix_lru.values()
        table = torch.tensor(blocks)
        g1 = eng._fns["export_blocks"](eng._cache, table)
        assert set(g1) == ({"k", "v", "ks", "vs"} if kw else {"k", "v"})
        meta = {"fmt": 3 if kw else 1, "tokens": list(kt), **(
            {"kv_quant": "int8"} if kw else {})}
        payload = tkv.pack_shipment(meta, g1)
        as_numpy = {n: np.frombuffer(_raw(t), dtype=jkv._dtype_of(
            tkv._NAMES[t.dtype])).reshape(tuple(t.shape))
            for n, t in g1.items()}
        assert payload == jkv.pack_shipment(meta, as_numpy)
        meta2, arrays = tkv.unpack_shipment(payload)
        assert meta2 == meta
        fresh = eng._kv_alloc.alloc(len(blocks))
        assert set(fresh).isdisjoint(blocks)
        eng._fns["import_blocks"](eng._cache, arrays, torch.tensor(fresh))
        g2 = eng._fns["export_blocks"](eng._cache, torch.tensor(fresh))
        for n in g1:
            assert g2[n].dtype == g1[n].dtype
            assert _raw(g2[n]) == _raw(g1[n])
        eng._kv_alloc.decref(fresh)
    finally:
        eng.close()


def _stats(eng) -> dict:
    s = eng.stats_snapshot()
    return {k: s[k] for k in TIER_STATS}


def _tier_counts(eng) -> dict:
    return eng._host_tier.stats_snapshot()


def _refcount_story(eng) -> dict:
    """The JAX test's sequence: p1's prefixes spill as two other prompts
    crowd the cache, then a probe extending p1's 18-token prefix restores
    it and forks its partial tail; then everything is evicted."""
    p1 = rng_prompt(21, 17)
    out = {"ids": [eng.submit(p, max_tokens=4)["output_ids"] for p in (
        p1 + [5], rng_prompt(22, 17) + [6], rng_prompt(23, 17) + [7])]}
    out["spilled"] = dict(_stats(eng))
    out["ids"].append(eng.submit(p1 + [5, 9, 9], max_tokens=4)["output_ids"])
    out["stats"] = _stats(eng)
    while eng._prefix_lru:
        eng._prefix_evict(next(iter(eng._prefix_lru)))
    out["tier"] = _tier_counts(eng)
    out["used"] = eng._kv_alloc.used_blocks
    return out


def test_refcount_conservation_and_cow_after_restore(pair):
    kw = dict(prefix_cache=2, kv_host_tier_blocks=64, kv_blocks=20)
    eng = _port(pair, **kw)
    try:
        got = _refcount_story(eng)
        assert eng._kv_alloc.free_blocks == eng._kv_alloc.n_blocks
    finally:
        eng.close()
    jeng = _jax(pair, **kw)
    try:
        want = _refcount_story(jeng)
    finally:
        jeng.close()
    assert got == want
    assert got["spilled"]["kv_spilled_blocks"] > 0
    s = got["stats"]
    assert s["kv_restored_blocks"] > 0 and s["prefix_hits"] >= 1
    assert s["kv_cow_copies"] > got["spilled"]["kv_cow_copies"]
    assert got["used"] == 0
    tier = got["tier"]
    assert (tier["spilled_blocks"] == tier["restored_blocks"]
            + tier["evicted_blocks"] + tier["resident_blocks"])
    fresh = _port(pair, kv_blocks=20)
    try:  # restored K/V is right: a cold engine gives the same tokens
        assert fresh.submit(rng_prompt(21, 17) + [5, 9, 9],
                            max_tokens=4)["output_ids"] == got["ids"][-1]
    finally:
        fresh.close()


def _lru_story(eng) -> dict:
    ids = [eng.submit(p, max_tokens=2)["output_ids"] for p in (
        rng_prompt(31, 17) + [1], rng_prompt(32, 17) + [2],
        rng_prompt(33, 17) + [3])]
    return {"ids": ids, "tier": _tier_counts(eng), "stats": _stats(eng)}


def test_tier_lru_under_pool_pressure(pair):
    """A tier smaller than the spilled set evicts its oldest prefix."""
    kw = dict(prefix_cache=1, kv_host_tier_blocks=4, kv_blocks=20)
    eng = _port(pair, **kw)
    try:
        got = _lru_story(eng)
    finally:
        eng.close()
    jeng = _jax(pair, **kw)
    try:
        assert got == _lru_story(jeng)
    finally:
        jeng.close()
    tier = got["tier"]
    assert tier["resident_blocks"] <= 4 and tier["evicted_blocks"] > 0


def _skip_story(eng) -> dict:
    p18 = rng_prompt(61, 18)  # boundaries at 16 and 18 (partial tail)
    eng.submit(p18, max_tokens=2)
    while eng._prefix_lru:  # evict everything: spill to the tier
        eng._prefix_evict(next(iter(eng._prefix_lru)))
    before = (eng._kv_alloc.free_blocks, eng._host_tier.resident_blocks)
    r = eng.submit(p18 + [9, 9], max_tokens=4, timeout=60.0)
    return {"before": before, "ids": r["output_ids"], "stats": _stats(eng)}


def test_restore_skipped_when_admission_would_not_fit(pair):
    """Livelock guard: restoring the 18-token spill (3 blocks) plus the
    20-token admission's reserve (3 less 2 zero-copy) needs 4 blocks of a
    3-block pool, so the admission runs cold and completes."""
    kw = dict(prefix_cache=2, kv_host_tier_blocks=16, kv_blocks=3,
              prefill_buckets=(8,))
    eng = _port(pair, **kw)
    try:
        got = _skip_story(eng)
    finally:
        eng.close()
    jeng = _jax(pair, **kw)
    try:
        assert got == _skip_story(jeng)
    finally:
        jeng.close()
    assert got["before"][0] == 3 and got["before"][1] > 0
    assert got["stats"]["kv_restored_blocks"] == 0
    fresh = _port(pair, kv_blocks=8, prefill_buckets=(8,))
    try:
        assert fresh.submit(rng_prompt(61, 18) + [9, 9],
                            max_tokens=4)["output_ids"] == got["ids"]
    finally:
        fresh.close()


def test_host_tier_refusals_and_metadata(pair):
    with pytest.raises(ValueError, match="needs the paged KV cache"):
        GenerationEngine(pair[2], max_len=64, prefill_buckets=(8, 16),
                         kv_host_tier_blocks=8)
    eng = _port(pair, prefix_cache=2, kv_host_tier_blocks=16)
    try:
        assert eng.kv_spill_blocks == 0
        assert eng.kv_info()["host_tier"] == {
            "spilled_blocks": 0, "restored_blocks": 0, "evicted_blocks": 0,
            "rejected_blocks": 0, "resident_blocks": 0, "entries": 0}
    finally:
        eng.close()
    flat = _port(pair, kv_block_size=0)
    try:
        assert flat.kv_spill_blocks is None and flat.kv_info() is None
    finally:
        flat.close()
