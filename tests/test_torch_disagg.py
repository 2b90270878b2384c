"""Disaggregated prefill/decode roles in the port (serve/generation.py
`prefill_ship`, `submit_remote`, the "prefill" and "decode" roles, and the
KV frame's fmt 2) against the JAX package on the CPU, on the same fp32
weights (tests/test_torch_kv_transfer.py's `pair`, GEN's paged engine).

Against JAX: fmt-2 frames byte-identical to JAX's for the same arrays and
read by both sides; a greedy shipment of a chunked prompt with the JAX
prefill engine's meta (key by key, the first logprob within 1e-5) and its
committed K/V rows within the fp32 tolerance; the port's pair decoding the
JAX pair's ids; a JAX frame's `rng_key` refused by name. Inside the port
(the JAX tests of tests/test_kv_transfer.py, test_kv_quant.py and
test_spec_decode.py): a seeded sampled stream through the pair bit-equal
to the unified engine at depth 1 and 2, a greedy chunked prompt through
unified engines, role discipline and every compatibility refusal with
JAX's messages, head-of-line stashing on remote admission, a never-fits
shed, fmt 3's identity and wire savings, fmt 2's identity and refusals, an
adapter named in the frame, and `resume_skip` on `decode_remote_stream`."""

import threading
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu.serve import kv_transfer as jkv
from kubeflow_tpu.serve.generation import GenerationEngine as JaxEngine
from kubeflow_tpu_torch.serve import kv_transfer as tkv
from kubeflow_tpu_torch.serve.generation import (ENGINE_ROLES,
                                                 GenerationEngine,
                                                 GenerativeTorchModel,
                                                 KVCapacityExceeded)
from kubeflow_tpu_torch.serve.kv_transfer import (ShipmentError, peek_meta,
                                                  rewrite_meta)
from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter
from kubeflow_tpu_torch.serve.paging import blocks_for
from tests.test_torch_kv_transfer import (  # noqa: F401 (pair: a fixture)
    DTYPES, GEN, _as_torch, _bits, _raw, pair, rng_prompt)

#: The fp32 tolerance of the port's cache comparisons against JAX.
KV_TOL = dict(atol=1e-5, rtol=1e-5)
#: A spec engine's draft: the target itself (every proposal accepted).
GAMMA = 3


def _port(pair, **kw):
    return GenerationEngine(pair[2], **{**GEN, **kw})


def _jax(pair, **kw):
    jm, params, _ = pair
    return JaxEngine(jm, params, jm.cfg, **{**GEN, **kw})


def _ship(engine, prompt, **kw) -> dict:
    try:
        return engine.prefill_ship(prompt, **kw)
    finally:
        engine.close()


def _decode(engine, shipment, **kw) -> dict:
    try:
        return engine.submit_remote(shipment, **kw), engine.stats_snapshot()
    finally:
        engine.close()


# -- the frame ------------------------------------------------------------------

@pytest.mark.parametrize("np_dtype,dt", [DTYPES[0], DTYPES[1]])
def test_fmt2_frames_byte_identical_and_cross_read(np_dtype, dt):
    """A fmt-2 frame (target and draft blocks, a draft section in the
    meta, an RNG key) packs to JAX's bytes and each side reads the
    other's."""
    k, v = _bits(1, np_dtype), _bits(2, np_dtype)
    dk, dv = _bits(3, np_dtype, (1, 3, 8, 2, 16)), _bits(
        4, np_dtype, (1, 3, 8, 2, 16))
    key = np.arange(16, dtype=np.uint8)
    meta = {"fmt": 2, "tokens": [1, 2, 3], "committed": 3,
            "draft": {"block_size": 8, "vocab_size": 512, "n_blocks": 3,
                      "kv_shape": [8, 2, 16], "num_layers": 1,
                      "dtype": str(np_dtype)}}
    arrays = {"k": k, "v": v, "draft_k": dk, "draft_v": dv, "rng_key": key}
    want = jkv.pack_shipment(meta, arrays)
    got = tkv.pack_shipment(meta, {n: _as_torch(a, dt) if n != "rng_key"
                                   else torch.from_numpy(a)
                                   for n, a in arrays.items()})
    assert got == want
    meta_t, back = tkv.unpack_shipment(want)
    assert meta_t == meta
    for name, a in arrays.items():
        assert _raw(back[name]) == a.tobytes()
    meta_j, back_j = jkv.unpack_shipment(got)
    assert meta_j == meta
    for name, a in arrays.items():
        assert back_j[name].dtype == a.dtype
        assert back_j[name].tobytes() == a.tobytes()


# -- against the JAX pair -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair(pair):
    """A greedy chunked prompt through the JAX pair: (prompt, shipment,
    decode output)."""
    prompt = rng_prompt(11, 30)
    ship = _ship(_jax(pair, role="prefill"), prompt, max_tokens=8)
    out, _ = _decode(_jax(pair, role="decode", seed=9), ship["shipment"])
    return prompt, ship, out


def test_greedy_shipment_matches_jax(pair, jax_pair):
    prompt, jship, jout = jax_pair
    ship = _ship(_port(pair, role="prefill"), prompt, max_tokens=8)
    assert ship["kv_blocks"] == jship["kv_blocks"] == blocks_for(30, 8)
    assert ship["first_token"] == jship["first_token"]
    meta, arrays = tkv.unpack_shipment(ship["shipment"])
    jmeta, jarrays = jkv.unpack_shipment(jship["shipment"])
    assert set(meta) == set(jmeta)
    for key in meta:
        if key == "first_logprob":
            assert meta[key] == pytest.approx(jmeta[key], abs=1e-5)
        else:
            assert meta[key] == jmeta[key], key
    # The generator state differs by design (module docstring); the blocks
    # do not, row for committed row.
    assert set(arrays) == set(jarrays) == {"k", "v", "rng_key"}
    assert arrays["rng_key"].dtype == torch.uint8
    assert jarrays["rng_key"].dtype == np.uint32
    for name in ("k", "v"):
        got, want = arrays[name].numpy(), jarrays[name]
        assert got.shape == want.shape
        n = len(prompt)
        np.testing.assert_allclose(
            got.reshape(got.shape[0], -1, *got.shape[3:])[:, :n],
            want.reshape(want.shape[0], -1, *want.shape[3:])[:, :n],
            **KV_TOL)
    out, stats = _decode(_port(pair, role="decode", seed=9),
                         ship["shipment"])
    assert out["output_ids"] == jout["output_ids"]
    np.testing.assert_allclose(out["output_logprobs"],
                               jout["output_logprobs"], atol=1e-4, rtol=0)
    assert stats["prefill_chunks"] == 0 and stats["remote_admits"] == 1


def test_jax_frame_rng_key_refused_by_name(pair, jax_pair):
    """JAX ships `jax.random.key_data` (uint32): adopting it into a
    torch.Generator would be a silent reseed, so it is refused by name,
    before anything is queued."""
    eng = _port(pair, role="decode")
    try:
        with pytest.raises(ShipmentError, match="rng_key"):
            eng.submit_remote(jax_pair[1]["shipment"])
        assert eng._kv_alloc.used_blocks == 0
        assert eng.stats_snapshot()["remote_admits"] == 0
    finally:
        eng.close()


# -- inside the port ------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_sampled_pair_identical_to_unified(pair, depth):
    """The identity pin: a seeded sampled stream through prefill_ship ->
    frame -> a decode engine of another seed is token- and
    logprob-identical to the unified engine on the prefill engine's seed;
    the caller's timeout rides the frame; the prefill engine never decodes
    and its pool drains."""
    prompt = rng_prompt(7, 21)
    uni = _port(pair, seed=5, pipeline_depth=depth)
    try:
        ref = uni.submit(prompt, max_tokens=10, temperature=0.8)
    finally:
        uni.close()
    pre = _port(pair, seed=5, role="prefill", pipeline_depth=depth)
    try:
        ship = pre.prefill_ship(prompt, max_tokens=10, temperature=0.8,
                                timeout=77.0)
        sp = pre.stats_snapshot()
        assert pre._kv_alloc.used_blocks == 0
        assert all(s is None for s in pre._slots)
    finally:
        pre.close()
    assert ship["kv_blocks"] == blocks_for(len(prompt), 8)
    assert peek_meta(ship["shipment"])["timeout"] == 77.0
    assert sp["kv_blocks_shipped"] == ship["kv_blocks"]
    assert sp["kv_shipment_bytes"] == len(ship["shipment"])
    assert sp["decode_dispatches"] == 0 and sp["requests"] == 1
    out, s = _decode(_port(pair, seed=999, role="decode",
                           pipeline_depth=depth), ship["shipment"])
    assert out["output_ids"] == ref["output_ids"]
    assert out["output_logprobs"] == ref["output_logprobs"]
    assert s["prefill_chunks"] == 0 and s["remote_admits"] == 1
    assert s["kv_blocks_received"] == ship["kv_blocks"]


def test_greedy_chunked_prompt_through_unified_engines(pair):
    """A prompt of two prefill chunks, greedy: a unified engine ships it
    and another unified engine admits it, with the ids and logprobs of a
    local submit."""
    prompt = rng_prompt(11, 30)
    uni = _port(pair, seed=2)
    try:
        ref = uni.submit(prompt, max_tokens=8)
        ship = uni.prefill_ship(prompt, max_tokens=8)
    finally:
        uni.close()
    out, s = _decode(_port(pair, seed=2), ship["shipment"])
    assert out["output_ids"] == ref["output_ids"]
    assert out["output_logprobs"] == ref["output_logprobs"]
    assert s["prefill_chunks"] == 0


def test_roles_and_their_refusals(pair):
    """The JAX engine's role checks and messages: an unknown role, a role
    on a flat engine, a local generate on either role, prefill work on a
    decode engine, decode work on a prefill engine, and the wire paths of
    a flat engine."""
    tm = pair[2]
    flat = dict(slots=1, max_len=32, chunk=4, prefill_buckets=(8,))
    for make in (lambda **kw: GenerationEngine(tm, **flat, **kw),
                 lambda **kw: JaxEngine(pair[0], pair[1], pair[0].cfg,
                                        **flat, **kw)):
        with pytest.raises(ValueError) as e:
            make(role="bogus")
        assert str(e.value) == f"role 'bogus': must be one of {ENGINE_ROLES}"
        with pytest.raises(ValueError, match="needs the paged KV cache"):
            make(role="decode")
    eng = GenerationEngine(tm, **flat)
    try:
        assert eng.role == "unified"
        with pytest.raises(RuntimeError, match="paged"):
            eng.prefill_ship([1, 2, 3])
        with pytest.raises(RuntimeError, match="paged"):
            eng.submit_remote(b"anything")
    finally:
        eng.close()
    pre, dec = _port(pair, role="prefill"), _port(pair, role="decode")
    try:
        for role_eng in (pre, dec):
            with pytest.raises(RuntimeError, match="refuses a local"):
                role_eng.submit([1, 2, 3], max_tokens=2)
        with pytest.raises(RuntimeError, match="refuses prefill"):
            dec.prefill_ship([1, 2, 3])
        with pytest.raises(RuntimeError, match="refuses decode"):
            pre.submit_remote(b"x")
        with pytest.raises(ValueError, match="outside"):
            pre.prefill_ship([600])
    finally:
        pre.close()
        dec.close()


@pytest.fixture(scope="module")
def frames(pair):
    """{name: frame}: fmt 1 (greedy, 9 tokens), fmt 3 (an int8 pool's) and
    fmt 2 (a self-draft spec engine's) of one prompt."""
    prompt = rng_prompt(1, 9)
    out = {"fmt1": _ship(_port(pair, role="prefill"), prompt,
                         max_tokens=4)["shipment"],
           "fmt3": _ship(_port(pair, role="prefill", kv_quant="int8"),
                         prompt, max_tokens=4)["shipment"],
           "fmt2": _ship(_port(pair, role="prefill",
                               draft={"model": pair[2], "gamma": GAMMA}),
                         prompt, max_tokens=4)["shipment"]}
    return out


#: (frame, how it is changed, the decode engine's extra settings, the
#: refusal's words): every check of submit_remote, with JAX's messages.
REFUSALS = [
    ("fmt1", dict(fmt=9), {}, "unknown shipment fmt 9"),
    ("fmt3", {}, {}, "kv_quant='none'"),
    ("fmt3", {}, {"kv_quant": "fp8"}, "mixed-precision"),
    ("fmt2", {}, {}, "no draft model"),
    ("fmt1", {}, {"kv_block_size": 16, "kv_blocks": 12}, "block_size"),
    ("fmt1", dict(vocab_size=1000), {}, "vocab"),
    ("fmt1", dict(tokens=list(range(1, 70))), {}, "does not fit max_len"),
    ("fmt1", dict(tokens=list(range(1, 20))), {}, "blocks shaped"),
    ("fmt2", dict(draft={"block_size": 8}), {"draft": True},
     "draft section"),
    ("fmt2", "drop draft_k", {"draft": True}, "missing draft_'k'"),
    ("fmt1", "drop v", {}, "missing 'v'"),
    ("fmt1", "garbage", {}, "bad shipment magic"),
]


@pytest.mark.parametrize("frame,change,kw,words", REFUSALS,
                         ids=[f"{r[0]}-{r[3]}" for r in REFUSALS])
def test_frame_refusals(pair, frames, frame, change, kw, words):
    data = frames[frame]
    if change == "garbage":
        data = b"TPKV0\n" + data[6:]
    elif isinstance(change, str):
        meta, arrays = tkv.unpack_shipment(data)
        del arrays[change.split()[1]]
        data = tkv.pack_shipment(meta, arrays)
    elif change:
        data = rewrite_meta(data, **change)
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft"] = {"model": pair[2], "gamma": GAMMA}
    eng = _port(pair, role="decode", **kw)
    try:
        with pytest.raises(ShipmentError, match=words):
            eng.submit_remote(data)
        assert eng._kv_alloc.used_blocks == 0
    finally:
        eng.close()


def test_remote_admission_stashes_head_of_line(pair):
    """Two shipments whose worst cases together exceed the decode pool:
    the second waits at the head of the line until the first retires, and
    both complete."""
    pre = _port(pair, role="prefill")
    try:
        ships = [pre.prefill_ship(rng_prompt(s, 17), max_tokens=40)
                 for s in (41, 42)]
    finally:
        pre.close()
    # 17 + 40 tokens -> 8 blocks of 8 each: a 12-block pool holds one.
    dec = _port(pair, role="decode", kv_blocks=12)
    outs: dict = {}

    def run(tag, ship):
        outs[tag] = dec.submit_remote(ship["shipment"])

    try:
        t1 = threading.Thread(target=run, args=("a", ships[0]))
        t1.start()
        deadline = time.monotonic() + 20
        while not any(dec._slots) and time.monotonic() < deadline:
            time.sleep(0.002)
        assert any(dec._slots), "first shipment never admitted"
        t2 = threading.Thread(target=run, args=("b", ships[1]))
        t2.start()
        stashed = False
        while time.monotonic() < deadline and "b" not in outs:
            if dec._kv_stash:
                stashed = True
                break
            time.sleep(0.002)
        t1.join(timeout=60)
        t2.join(timeout=60)
        assert stashed, "second shipment never waited in the stash"
        assert [len(outs[t]["output_ids"]) for t in "ab"] == [40, 40]
        s = dec.stats_snapshot()
        assert s["remote_admits"] == 2 and s["prefill_chunks"] == 0
        assert dec._kv_alloc.used_blocks == 0
    finally:
        dec.close()


def test_remote_never_fits_sheds(pair):
    ship = _ship(_port(pair, role="prefill"), rng_prompt(51, 17),
                 max_tokens=40)
    dec = _port(pair, role="decode", kv_blocks=4)
    try:
        with pytest.raises(KVCapacityExceeded, match="pool has 4"):
            dec.submit_remote(ship["shipment"])
    finally:
        dec.close()


def test_fmt3_identity_and_wire_savings(pair, frames):
    """An int8 pair: fmt 3 with its kv_quant, a sampled stream bit-equal to
    the int8 unified engine's, at most 0.55x the fmt-1 bytes of the same
    prompt; and a fmt-1 frame into an int8 decode engine, encoded at
    import, gives the int8 unified engine's greedy ids."""
    prompt = rng_prompt(7, 21)
    uni = _port(pair, seed=5, kv_quant="int8")
    try:
        ref = uni.submit(prompt, max_tokens=10, temperature=0.8)
        greedy = uni.submit(prompt, max_tokens=6)
    finally:
        uni.close()
    ship = _ship(_port(pair, seed=5, role="prefill", kv_quant="int8"),
                 prompt, max_tokens=10, temperature=0.8)
    meta = peek_meta(ship["shipment"])
    assert meta["fmt"] == 3 and meta["kv_quant"] == "int8"
    out, _ = _decode(_port(pair, seed=999, role="decode", kv_quant="int8"),
                     ship["shipment"])
    assert out["output_ids"] == ref["output_ids"]
    assert out["output_logprobs"] == ref["output_logprobs"]
    plain = _ship(_port(pair, seed=5, role="prefill"), prompt,
                  max_tokens=6)
    assert peek_meta(plain["shipment"])["fmt"] == 1
    assert len(ship["shipment"]) <= 0.55 * len(plain["shipment"])
    out1, _ = _decode(_port(pair, role="decode", kv_quant="int8"),
                      plain["shipment"])
    assert out1["output_ids"] == greedy["output_ids"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_fmt2_identity(pair, temperature):
    """A spec pair (the target as its own draft): fmt 2 with the draft's
    identity, the decode engine speculating from the shipped draft blocks
    with no prefill chunk and no replay, ids and logprobs equal to the
    unified spec engine's on the same seed, both pools drained."""
    draft = {"model": pair[2], "gamma": GAMMA}
    prompt = [5, 9, 2, 7, 3]
    uni = _port(pair, draft=draft, seed=5)
    try:
        ref = uni.submit(prompt, max_tokens=12, temperature=temperature)
    finally:
        uni.close()
    pre = _port(pair, draft=draft, seed=5, role="prefill")
    try:
        ship = pre.prefill_ship(prompt, max_tokens=12,
                                temperature=temperature)
        assert pre._kv_alloc.used_blocks == 0
    finally:
        pre.close()
    meta, arrays = tkv.unpack_shipment(ship["shipment"])
    assert meta["fmt"] == 2
    cfg = pair[2].cfg
    kv_shape = [8, cfg.num_kv_heads, cfg.head_dim]
    assert meta["draft"] == {"block_size": 8, "vocab_size": cfg.vocab_size,
                             "n_blocks": 1, "kv_shape": kv_shape,
                             "num_layers": cfg.num_layers,
                             "dtype": "float32"}
    assert tuple(arrays["draft_k"].shape) == (cfg.num_layers, 1, *kv_shape)
    dec = _port(pair, draft=draft, seed=999, role="decode")
    replays: list = []
    real = dec._draft_replay
    dec._draft_replay = lambda ids: replays.append(ids) or real(ids)
    out, s = _decode(dec, ship["shipment"])
    assert out["output_ids"] == ref["output_ids"]
    assert out["output_logprobs"] == ref["output_logprobs"]
    assert s["spec_dispatches"] > 0 and s["prefill_chunks"] == 0
    assert replays == [] and dec._kv_alloc.used_blocks == 0


def test_fmt1_into_a_draft_engine_replays_the_draft(pair, frames):
    """A frame without a draft section on a draft engine: the draft
    replays the prompt there, and the engine still speculates, with the
    greedy ids of the fmt-2 frame's decode."""
    draft = {"model": pair[2], "gamma": GAMMA}
    outs = []
    for name in ("fmt2", "fmt1"):
        dec = _port(pair, draft=draft, role="decode")
        replays: list = []
        real = dec._draft_replay
        dec._draft_replay = lambda ids: replays.append(ids) or real(ids)
        out, s = _decode(dec, frames[name])
        assert s["spec_dispatches"] > 0 and s["prefill_chunks"] == 0
        assert len(replays) == (name == "fmt1")
        outs.append(out["output_ids"])
    assert outs[0] == outs[1]


def test_adapter_named_in_the_frame(pair, tmp_path):
    """The frame names the request's adapter: a decode engine holding it
    decodes the unified engine's ids for that adapter; one without
    adapters, or without that one, refuses it by name before anything is
    queued."""
    ada = write_synthetic_adapter(pair[2].cfg, str(tmp_path / "ada"), 21,
                                  r=8, alpha=400.0)
    prompt = rng_prompt(3, 12)
    uni = _port(pair, adapters={"ada": ada})
    try:
        ref = uni.submit(prompt, max_tokens=6, adapter="ada")
        base = uni.submit(prompt, max_tokens=6)
    finally:
        uni.close()
    assert ref["output_ids"] != base["output_ids"]
    pre = _port(pair, adapters={"ada": ada}, role="prefill")
    try:
        ship = pre.prefill_ship(prompt, max_tokens=6, adapter="ada")
        assert pre.stats_snapshot()["adapter_requests"] == {"ada": 1}
    finally:
        pre.close()
    assert peek_meta(ship["shipment"])["adapter"] == "ada"
    out, _ = _decode(_port(pair, adapters={"ada": ada}, role="decode"),
                     ship["shipment"])
    assert out["output_ids"] == ref["output_ids"]
    for kw, words in (({}, "no adapters configured"),
                      ({"adapters": {"other": ada}}, "unknown adapter")):
        dec = _port(pair, role="decode", **kw)
        try:
            with pytest.raises(ValueError, match=words):
                dec.submit_remote(ship["shipment"])
        finally:
            dec.close()


def test_resume_skip_on_decode_remote_stream(pair):
    """The resume cursor: the same frame with `resume_skip` k replays the
    seeded sampled stream and leaves its first k tokens out of the chunk
    events; the final event carries the whole output. A cursor outside
    [0, max_tokens] is refused."""
    ship = _ship(_port(pair, seed=5, role="prefill"), rng_prompt(13, 9),
                 max_tokens=10, temperature=0.7)["shipment"]
    model = GenerativeTorchModel("m", pair[2],
                                 generation={**GEN, "seed": 222,
                                             "role": "decode"})
    model.load()

    def run(frame):
        chunks, final = [], None
        for ev in model.decode_remote_stream(frame):
            if ev.get("done"):
                final = ev
            else:
                chunks.extend(ev["tokens"])
        return chunks, final

    try:
        assert model.metadata()["role"] == "decode"
        full, fin1 = run(ship)
        assert full == fin1["output_ids"] and len(full) == 10
        tail, fin2 = run(rewrite_meta(ship, resume_skip=4))
        assert tail == full[4:]
        assert fin2["output_ids"] == fin1["output_ids"]
        assert fin2["output_logprobs"] == fin1["output_logprobs"]
        for skip in (11, -1):
            with pytest.raises(ValueError, match="resume_skip"):
                list(model.decode_remote_stream(
                    rewrite_meta(ship, resume_skip=skip)))
        plain = model.decode_remote(ship)
        assert plain["output_ids"] == full
    finally:
        model.unload()
