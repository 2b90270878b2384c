"""The port's speculative decoding (serve/generation.py `spec_acceptance`,
`build_spec_decode` and the engine's spec sub-batch) against the JAX
package on the CPU, on the same fp32 weights (llama_params_from_jax).

Ports of tests/test_spec_decode.py's cases (all but the mesh and the
disaggregation ones): greedy output identical to vanilla decode with the
target as its own draft and with a weak draft, temperature rows through
rejection sampling, the top-k/top-p fallback, chunked long-prompt
admission, a mixed batch, mixed traffic that keeps speculating, the vocab
refusal, stale rides, paged equal to flat, depth 2 with a weak draft, the
paged pool's accounting, and the acceptance law. Greedy ids are held to the
JAX model's uncached rollout. Then the module against JAX's
`build_spec_decode` on one spec chunk (rows written near the end of the
bucket, where both clamp the write), the `_update_rows` clamp against
JAX's, a request whose budget ends at max_len, and one request sequence
through the JAX spec engine and the port, flat and paged at depth 1 and 2
with an adapter row: equal greedy ids and equal spec and decode counters.
The JAX engines are tiny and built once each."""

import dataclasses
import threading
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import generation as jg
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve import generation as tg
from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter
from kubeflow_tpu_torch.serve.paging import blocks_for
from kubeflow_tpu_torch.utils.resilience import Deadline, DeadlineExceeded
from tests.test_torch_generation import ref_greedy

#: The JAX spec tests' engine (tests/test_spec_decode.py `_engine`).
BASE = dict(slots=2, max_len=64, chunk=8, prefill_buckets=(8,))
PAGED = dict(kv_block_size=8, kv_blocks=40)
#: The logprob tolerance of the JAX spec tests.
LP_TOL = dict(rtol=1e-4, atol=1e-5)
#: Counters the cross-package parity test holds equal.
COUNTERS = ("spec_dispatches", "spec_proposed", "spec_accepted",
            "spec_demotions", "spec_readmissions", "spec_stale_rides",
            "decode_tokens", "decode_dispatches", "decode_dead_slot_chunks",
            "decode_wasted_tokens", "decode_fetch_overlapped",
            "decode_fetch_blocking", "prefill_chunks", "requests")


def _pair(num_layers=2, seed=0):
    """(JAX module, its params, the port's twin on the same weights): the
    llama_tiny widths in fp32."""
    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               num_layers=num_layers)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=num_layers)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(jm.init(jax.random.key(seed),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tl.Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def target():
    return _pair()


@pytest.fixture(scope="module")
def weak():
    """A draft of one layer from another seed: it disagrees with the
    target almost everywhere."""
    return _pair(num_layers=1, seed=7)


@pytest.fixture(scope="module")
def near(target):
    """A draft of the target's weights with noise: it agrees with the
    target often but not always."""
    jm, params, _ = target
    rng = np.random.default_rng(11)
    nparams = jax.tree.map(
        lambda x: x + 0.3 * np.std(x) * rng.standard_normal(x.shape).astype(
            np.float32), jax.tree.map(np.asarray, params))
    tm = tl.Llama(target[2].cfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(nparams, tm.cfg))
    return jm, jax.tree.map(jnp.asarray, nparams), tm


@pytest.fixture(scope="module")
def adapter_dir(target, tmp_path_factory):
    return write_synthetic_adapter(
        target[2].cfg, str(tmp_path_factory.mktemp("ada") / "ada"), 21, r=8,
        alpha=400.0)


def _engine(model, draft=None, gamma=3, **kw):
    cfg = {**BASE, **kw}
    if draft is not None:
        cfg["draft"] = {"model": draft, "gamma": gamma}
    return tg.GenerationEngine(model, **cfg)


def _run(engine, *requests):
    """Submit (prompt, kwargs) requests at once, each on its own thread,
    and return their results in order."""
    results = [None] * len(requests)

    def run(i):
        prompt, kw = requests[i]
        try:
            results[i] = engine.submit(prompt, **kw)
        except Exception as e:  # asserted below
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    for r in results:
        assert isinstance(r, dict), r
    return results


def _hold_admission(engine, n):
    """Admit nothing until `n` requests wait, then admit as usual: every
    request of a burst enters the first admission pass, so the schedule
    that follows does not depend on thread timing (the JAX and the port
    engines expose the same `_queue` and `_admit_waiting`)."""
    real = engine._admit_waiting

    def admit(overlap):
        while engine._queue.qsize() < n:
            time.sleep(0.002)
        engine._admit_waiting = real
        real(overlap)
    engine._admit_waiting = admit
    time.sleep(0.1)  # a pass already under way (idle: 50 ms) ends first


# -- tests/test_spec_decode.py ------------------------------------------------

def test_spec_greedy_identical_self_draft(target):
    """Draft = target: every proposal is accepted and the output equals
    greedy decoding exactly (ids and logprobs of the vanilla engine)."""
    jm, params, tm = target
    want = ref_greedy(jm, params, [5, 9, 2], 24)
    vanilla = _engine(tm)
    spec = _engine(tm, draft=tm)
    try:
        ref = vanilla.submit([5, 9, 2], max_tokens=24)
        out = spec.submit([5, 9, 2], max_tokens=24)
        s = spec.stats_snapshot()
    finally:
        vanilla.close()
        spec.close()
    assert out["output_ids"] == ref["output_ids"] == want
    np.testing.assert_allclose(out["output_logprobs"],
                               ref["output_logprobs"], **LP_TOL)
    assert s["spec_dispatches"] > 0 and s["spec_proposed"] > 0
    assert s["spec_accepted"] == s["spec_proposed"]


def test_spec_greedy_identical_weak_draft(target, weak):
    """A different draft only costs acceptance, never correctness."""
    jm, params, tm = target
    spec = _engine(tm, draft=weak[2], gamma=4)
    try:
        out = spec.submit([11, 4], max_tokens=20)
        s = spec.stats_snapshot()
    finally:
        spec.close()
    assert out["output_ids"] == ref_greedy(jm, params, [11, 4], 20)
    assert s["spec_accepted"] < s["spec_proposed"]


def test_spec_temperature_decodes_speculatively(target):
    """temperature > 0 (no top-k/p) takes the spec path by rejection
    sampling; with draft = target p_t/p_d is 1 up to float noise."""
    _, _, tm = target
    spec = _engine(tm, draft=tm)
    try:
        out = spec.submit([5, 9, 2], max_tokens=12, temperature=0.8)
        s = spec.stats_snapshot()
    finally:
        spec.close()
    assert len(out["output_ids"]) == 12
    assert s["spec_dispatches"] > 0
    assert s["spec_accepted"] >= 0.5 * s["spec_proposed"]


def test_spec_topk_topp_requests_fall_back(target):
    _, _, tm = target
    spec = _engine(tm, draft=tm)
    try:
        for kw in (dict(top_p=0.9), dict(top_k=5)):
            out = spec.submit([5, 9, 2], max_tokens=8, temperature=0.8, **kw)
            assert len(out["output_ids"]) == 8
        s = spec.stats_snapshot()
    finally:
        spec.close()
    assert s["spec_dispatches"] == 0 and s["decode_dispatches"] > 0


def test_spec_long_prompt_chunked_admission(target):
    """A 20-token prompt over 8-token buckets reaches the draft cache by
    the same chunked replay."""
    jm, params, tm = target
    prompt = [int(t) for t in np.random.default_rng(0).integers(1, 60, 20)]
    spec = _engine(tm, draft=tm)
    try:
        out = spec.submit(prompt, max_tokens=12)
    finally:
        spec.close()
    assert out["output_ids"] == ref_greedy(jm, params, prompt, 12)


def test_spec_acceptance_preserves_target_distribution():
    """The emitted marginal at position 0 is the target's tempered softmax
    however wrong the draft: 20000 trials from a seeded generator (the JAX
    test's distributions, sizes and bound)."""
    v, gamma, n = 16, 3, 20000
    rng = np.random.default_rng(0)
    tlogits = torch.from_numpy(
        rng.normal(0, 2.0, (1, gamma + 1, v)).astype(np.float32))
    dlogits = torch.from_numpy(
        rng.normal(0, 2.0, (1, gamma, v)).astype(np.float32))
    temp = 0.7
    gen = torch.Generator().manual_seed(42)
    # Each trial's draft proposes from its own tempered distribution.
    drafts = torch.multinomial(torch.softmax(dlogits[0] / temp, -1), n,
                               replacement=True, generator=gen).T
    out, k, nxt = tg.spec_acceptance(
        drafts, dlogits.expand(n, -1, -1), tlogits.expand(n, -1, -1),
        torch.full((n,), temp), gen)
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    want = torch.softmax(tlogits[0, 0] / temp, -1).numpy()
    np.testing.assert_allclose(emp, want, atol=0.015)
    assert out.shape == (n, gamma + 1) and bool((k <= gamma).all())
    assert torch.equal(out.gather(1, k[:, None])[:, 0], nxt)


def test_spec_mixed_batch_stays_correct(target):
    """A top-p request beside a greedy one: the greedy ids stay those of
    greedy decoding."""
    jm, params, tm = target
    spec = _engine(tm, draft=tm)
    try:
        g, s = _run(spec, ([5, 9, 2], dict(max_tokens=24)),
                    ([8, 1], dict(max_tokens=16, temperature=0.9,
                                  top_p=0.9)))
    finally:
        spec.close()
    assert g["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 24)
    assert len(s["output_ids"]) == 16


def test_spec_mixed_traffic_keeps_speculating(target):
    """A top-p request decodes in its own vanilla sub-batch while the
    greedy one speculates beside it and is never demoted."""
    jm, params, tm = target
    spec = _engine(tm, draft=tm, chunk=4)
    _hold_admission(spec, 2)
    try:
        g, s = _run(spec, ([5, 9, 2], dict(max_tokens=48)),
                    ([8, 1], dict(max_tokens=16, temperature=0.9,
                                  top_p=0.9)))
        st = spec.stats_snapshot()
    finally:
        spec.close()
    assert g["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 48)
    assert len(s["output_ids"]) == 16
    assert st["spec_dispatches"] > 0 and st["spec_accepted"] > 0, st
    assert st["spec_demotions"] == 0 and st["spec_readmissions"] == 0, st
    assert st["decode_dispatches"] > st["spec_dispatches"], st


def test_spec_rejects_vocab_mismatch(target):
    _, _, tm = target
    other = tl.Llama(dataclasses.replace(tm.cfg, vocab_size=1024),
                     device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _engine(tm, draft=other)


def test_spec_stale_ride_excludes_unworthy_from_readmission(target,
                                                            monkeypatch):
    """A demoted slot whose replay can never pay rides the spec chunks of
    a fresh request with stale draft rows, and its ids stay exact. The
    first spec-eligible rounds are forced to the vanilla sub-batch (which
    demotes the greedy row) and `_readmit_worthwhile` is forced False, as
    in the JAX test; vanilla fetches are slowed so that the long request
    is still running when the fresh one arrives."""
    jm, params, tm = target
    spec = _engine(tm, draft=tm, chunk=4)
    spec._readmit_worthwhile = lambda st: False
    real_split, real_fetch = spec._spec_batch, spec._fetch_chunk
    calls = {"n": 0}

    def gated_split(active, van_covered, spec_chain):
        calls["n"] += 1
        parts, fb = real_split(active, van_covered, spec_chain)
        if calls["n"] <= 3 and not spec_chain:
            return [], parts + fb
        return parts, fb

    def slow_fetch(rec, overlapped):
        time.sleep(0.01)
        real_fetch(rec, overlapped)

    spec._spec_batch, spec._fetch_chunk = gated_split, slow_fetch
    _hold_admission(spec, 2)
    results = {}

    def sampled_then_greedy():
        results["s"] = spec.submit([8, 1], max_tokens=12, temperature=0.9,
                                   top_p=0.9)
        results["c"] = spec.submit([4, 4, 1], max_tokens=16)

    try:
        t = threading.Thread(target=sampled_then_greedy)
        t.start()
        results["a"] = spec.submit([5, 9, 2], max_tokens=48)
        t.join(timeout=180)
        s = spec.stats_snapshot()
    finally:
        spec.close()
    assert results["a"]["output_ids"] == ref_greedy(jm, params, [5, 9, 2],
                                                    48)
    assert results["c"]["output_ids"] == ref_greedy(jm, params, [4, 4, 1],
                                                    16)
    assert s["spec_demotions"] >= 1, s
    assert s["spec_stale_rides"] >= 1, s
    assert s["spec_readmissions"] == 0, s
    assert s["spec_dispatches"] > 0, s


def test_spec_demoted_row_is_readmitted(target):
    """The same forced demotion with re-admission allowed: the demoted
    greedy row replays its history into the draft cache once it may, and
    speculates again with every proposal accepted (draft = target), so the
    replayed draft rows are exact."""
    jm, params, tm = target
    spec = _engine(tm, draft=tm, chunk=8)
    real_split = spec._spec_batch
    calls = {"n": 0}

    def gated_split(active, van_covered, spec_chain):
        calls["n"] += 1
        parts, fb = real_split(active, van_covered, spec_chain)
        if calls["n"] <= 1 and not spec_chain:
            return [], parts + fb
        return parts, fb

    spec._spec_batch = gated_split
    try:
        out = spec.submit([5, 9, 2], max_tokens=40)
        s = spec.stats_snapshot()
    finally:
        spec.close()
    assert out["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 40)
    assert (s["spec_demotions"], s["spec_readmissions"]) == (1, 1), s
    assert s["spec_accepted"] == s["spec_proposed"] > 0, s


@pytest.mark.parametrize("pool", ["flat", "paged"])
@pytest.mark.parametrize("spec", [False, True])
def test_pending_first_tokens_reach_the_first_dispatch(target, pool, spec):
    """At depth 2 an admission's first token stays on the device until its
    host copy is seen; on the card the first dispatch after the admission
    often finds it so, with no record in flight to carry from. Polling is
    switched off here so that every first token is pending at its first
    dispatch: the dispatch must take it from the device, for spec and
    vanilla rows alike."""
    jm, params, tm = target
    eng = _engine(tm, draft=tm if spec else None, pipeline_depth=2,
                  **(PAGED if pool == "paged" else {}))
    eng._poll_pending_first = lambda: None
    _hold_admission(eng, 2)
    try:
        outs = _run(eng, ([5, 9, 2], dict(max_tokens=12)),
                    ([17, 3, 3, 8, 1], dict(max_tokens=9)))
    finally:
        eng.close()
    assert outs[0]["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 12)
    assert outs[1]["output_ids"] == ref_greedy(jm, params, [17, 3, 3, 8, 1],
                                               9)


@pytest.mark.parametrize("depth", [1, 2])
def test_spec_rows_stream_and_expire(target, depth):
    """Streaming and deadlines on spec rows: `on_tokens` sees every
    emitted token in order, done last; a spec row whose deadline passes
    mid-decode (spec fetches slowed on the host) fails with
    DeadlineExceeded and frees its slot and its target and draft blocks,
    while its neighbour's ids stay greedy decoding's."""
    jm, params, tm = target
    eng = _engine(tm, draft=tm, pipeline_depth=depth, chunk=4, **PAGED)
    real_fetch = eng._fetch_spec_chunk

    def slow_fetch(rec, inflight, overlapped):
        time.sleep(0.03)
        real_fetch(rec, inflight, overlapped)

    eng._fetch_spec_chunk = slow_fetch
    calls = []
    try:
        out = eng.submit([5, 9, 2], max_tokens=12,
                         on_tokens=lambda toks, done: calls.append(
                             (list(toks), done)))
        assert [t for toks, _ in calls for t in toks] == out["output_ids"]
        assert [done for _, done in calls] == [False] * (
            len(calls) - 1) + [True]
        results = {}

        def late():
            try:
                eng.submit([8, 1, 4], max_tokens=40,
                           deadline=Deadline(0.15))
            except DeadlineExceeded as e:
                results["late"] = e

        t = threading.Thread(target=late)
        t.start()
        results["ok"] = eng.submit([11, 4], max_tokens=20)
        t.join(timeout=60)
        assert isinstance(results.get("late"), DeadlineExceeded)
        for _ in range(100):  # the slot frees at the next chunk boundary
            if eng.kv_blocks_used == 0:
                break
            time.sleep(0.02)
        assert eng.kv_blocks_used == 0
        assert eng.stats_snapshot()["spec_dispatches"] > 0
    finally:
        eng.close()
    assert out["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 12)
    assert results["ok"]["output_ids"] == ref_greedy(jm, params, [11, 4],
                                                     20)


def test_spec_paged_identical_to_flat(target):
    """The draft's own blocks in the shared pool decode token- and
    logprob-identically to the flat draft cache, greedy and at
    temperature (the same seed, so the same draws)."""
    _, _, tm = target
    outs = []
    for kw in ({}, PAGED):
        eng = _engine(tm, draft=tm, **kw)
        try:
            outs.append([eng.submit(p, max_tokens=n, temperature=t)
                         for p, n, t in (([5, 9, 2], 24, 0.0),
                                         ([8, 1, 4], 16, 0.7))])
            s = eng.stats_snapshot()
        finally:
            eng.close()
        assert s["spec_dispatches"] > 0 and s["spec_accepted"] > 0, s
    for flat, paged in zip(*outs):
        assert paged["output_ids"] == flat["output_ids"]
        np.testing.assert_allclose(paged["output_logprobs"],
                                   flat["output_logprobs"], **LP_TOL)


def test_spec_depth2_weak_draft_identical(target):
    """Depth 2 with a weak draft of the target's widths: chained spec
    chunks over-dispatch on the all-accepted carry and are doomed at their
    fetch, and the ids still equal depth-1 vanilla decoding's, flat and
    paged."""
    jm, params, tm = target
    _, _, wt = _pair(seed=1)
    vanilla = _engine(tm, pipeline_depth=1)
    try:
        ref = vanilla.submit([5, 9, 2], max_tokens=32)
    finally:
        vanilla.close()
    assert ref["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 32)
    for kw in ({}, PAGED):
        spec = _engine(tm, draft=wt, pipeline_depth=2, **kw)
        try:
            out = spec.submit([5, 9, 2], max_tokens=32)
            s = spec.stats_snapshot()
        finally:
            spec.close()
        assert out["output_ids"] == ref["output_ids"], kw
        np.testing.assert_allclose(out["output_logprobs"],
                                   ref["output_logprobs"], **LP_TOL)
        assert s["spec_dispatches"] > 0, s
        assert s["spec_accepted"] < s["spec_proposed"], s
        assert s["decode_wasted_tokens"] > 0, s  # doomed chained records


def test_spec_paged_pool_accounting(target):
    """Draft blocks are freed with their slot, and mid-request the slot
    holds both footprints."""
    _, _, tm = target
    eng = _engine(tm, draft=tm, **PAGED)
    peak = {"used": 0}

    def watch(toks, done):
        peak["used"] = max(peak["used"], eng.kv_blocks_used)

    try:
        eng.submit([5, 9, 2], max_tokens=16, on_tokens=watch)
        assert eng.kv_blocks_used == 0
        assert peak["used"] >= 2 * blocks_for(3 + 16, 8), peak
        g, s = _run(eng, ([5, 9, 2], dict(max_tokens=16)),
                    ([8, 1], dict(max_tokens=8, temperature=0.9,
                                  top_p=0.9)))
        assert len(g["output_ids"]) == 16 and len(s["output_ids"]) == 8
        assert eng.kv_blocks_used == 0, eng.stats_snapshot()
    finally:
        eng.close()
    # A spec-able request of 8 blocks is shed by a pool of 12: its draft
    # doubles the reservation. A top-k one of the same size is served.
    eng = _engine(tm, draft=tm, kv_block_size=8, kv_blocks=12)
    try:
        with pytest.raises(tg.KVCapacityExceeded):
            eng.submit(list(range(1, 40)), max_tokens=24)
        out = eng.submit(list(range(1, 40)), max_tokens=24, top_k=3,
                         temperature=0.5)
        assert len(out["output_ids"]) == 24
        assert eng.kv_blocks_used == 0
    finally:
        eng.close()


# -- the module against JAX's build_spec_decode -------------------------------

def test_update_rows_clamps_as_dynamic_update_slice():
    """Five rows asked at T - 2 land at T - 5, as JAX's write puts them;
    a row asked in range lands where asked."""
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((2, 12, 2, 4)).astype(np.float32)
    rows = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    index = np.array([10, 3], np.int32)
    want = np.asarray(jl._update_rows(jnp.asarray(cache), jnp.asarray(rows),
                                      jnp.asarray(index)))
    got = torch.from_numpy(cache.copy())
    tl._update_rows(got, torch.from_numpy(rows), torch.from_numpy(index))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0, 7:], rows[0])


@pytest.mark.parametrize("paged", [False, True])
def test_spec_chunk_matches_jax(target, weak, paged):
    """One spec chunk (2 steps, gamma 3) over a 16-row bucket from the
    same caches and inputs, greedy rows at per-row indices, one near the
    bucket's end (its verify write is clamped back by both): equal tokens
    and accepted counts, logprobs and both caches within fp32 noise."""
    jm, params, tm = target
    wj, wparams, wt = weak
    gamma, n_spec, bucket, max_len = 3, 2, 16, 32
    rng = np.random.default_rng(5)
    tcache = {n: rng.standard_normal((2, 2, max_len, 2, 16)).astype(
        np.float32) for n in ("k", "v")}
    dcache = {n: rng.standard_normal((1, 2, max_len, 2, 16)).astype(
        np.float32) for n in ("k", "v")}
    last = np.array([7, 300], np.int32)
    index = np.array([3, bucket - 2], np.int32)
    temp = np.zeros((2,), np.float32)
    make = jg.build_spec_decode(jm, wj, gamma=gamma, n_spec=n_spec,
                                max_len=max_len)
    jc, jd, jt, jlp, jacc = jax.jit(make(bucket))(
        params, wparams, jax.tree.map(jnp.asarray, tcache),
        jax.tree.map(jnp.asarray, dcache), jnp.asarray(last),
        jnp.asarray(index), jnp.asarray(temp), jax.random.key(0))
    tc = {n: torch.from_numpy(a.copy()) for n, a in tcache.items()}
    dc = {n: torch.from_numpy(a.copy()) for n, a in dcache.items()}
    args = (torch.from_numpy(last).long(), torch.from_numpy(index).long(),
            torch.from_numpy(temp), torch.Generator().manual_seed(0))
    with torch.inference_mode():
        if paged:
            # The flat caches laid out as pools of 8-row blocks (block 0 the
            # NULL block), each row's bucket through its own table.
            pool = {n: torch.zeros((c.shape[0], 9, 8) + c.shape[3:])
                    for n, c in tc.items()}
            dpool = {n: torch.zeros((c.shape[0], 9, 8) + c.shape[3:])
                     for n, c in dc.items()}
            tables = torch.tensor([[1, 2], [3, 4]])
            dtables = torch.tensor([[5, 6], [7, 8]])
            for p, c, tb in ((pool, tc, tables), (dpool, dc, dtables)):
                for n in p:
                    tg._scatter_view(p[n], c[n][:, :, :bucket], tb)
            fn = tg.build_spec_decode(tm, wt, gamma=gamma, n_spec=n_spec,
                                      kv_block_size=8)(bucket)
            pool, dpool, toks, lps, acc = fn(pool, dpool, tables, dtables,
                                             *args)
            for p, c, tb in ((pool, tc, tables), (dpool, dc, dtables)):
                for n in p:
                    c[n][:, :, :bucket] = tg._gather_view(p[n], tb)
        else:
            fn = tg.build_spec_decode(tm, wt, gamma=gamma,
                                      n_spec=n_spec)(bucket)
            tc, dc, toks, lps, acc = fn(tc, dc, *args)
    assert toks.shape == (2, n_spec, gamma + 1)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    kept = np.arange(gamma + 1)[None, None] <= np.asarray(jacc)[..., None]
    np.testing.assert_array_equal(np.where(kept, toks.numpy(), 0),
                                  np.where(kept, np.asarray(jt), 0))
    np.testing.assert_allclose(np.where(kept, lps.numpy(), 0),
                               np.where(kept, np.asarray(jlp), 0),
                               rtol=1e-4, atol=1e-5)
    for got, want in ((tc, jc), (dc, jd)):
        for n in ("k", "v"):
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       rtol=1e-4, atol=1e-5)


def test_spec_budget_to_max_len(target):
    """A request whose prompt and budget fill max_len: the spec row falls
    back to the vanilla sub-batch near the context end, and the ids are
    greedy decoding's to the last one."""
    jm, params, tm = target
    prompt = [int(t) for t in np.random.default_rng(9).integers(1, 500, 41)]
    want = ref_greedy(jm, params, prompt, 23)
    for kw in ({}, PAGED):
        spec = _engine(tm, draft=tm, **kw)
        try:
            out = spec.submit(prompt, max_tokens=23)
            s = spec.stats_snapshot()
        finally:
            spec.close()
        assert out["output_ids"] == want, kw
        assert s["spec_dispatches"] > 0 and s["decode_dispatches"] > \
            s["spec_dispatches"], s


# -- one request sequence through both packages -------------------------------

PARITY_REQUESTS = (([5, 9, 2], dict(max_tokens=24)),
                   ([11, 4, 7], dict(max_tokens=20, adapter="ada")),
                   (list(range(3, 23)), dict(max_tokens=12)))


@pytest.mark.parametrize("pool,depth", [("flat", 1), ("flat", 2),
                                        ("paged", 1), ("paged", 2)])
def test_counter_parity_with_jax(target, near, adapter_dir, pool, depth):
    """The same requests through the JAX spec engine and the port (a draft
    near the target, so some proposals are accepted and some not;
    multi-LoRA with one adapter row): first
    the three at once (all admitted in one pass, the third waiting for a
    slot), then each alone; equal greedy ids and equal spec and decode
    counters."""
    jm, params, tm = target
    wj, wparams, wt = near
    kw = dict(BASE, pipeline_depth=depth, adapters={"ada": adapter_dir})
    if pool == "paged":
        kw.update(PAGED)
    sides = {"port": tg.GenerationEngine(
                 tm, draft={"model": wt, "gamma": 3}, **kw),
             "jax": jg.GenerationEngine(
                 jm, params, jm.cfg, draft={"model": wj, "params": wparams,
                                            "cfg": wj.cfg, "gamma": 3},
                 **kw)}
    out = {}
    try:
        for side, eng in sides.items():
            _hold_admission(eng, len(PARITY_REQUESTS))
            burst = [r["output_ids"] for r in _run(eng, *PARITY_REQUESTS)]
            alone = [eng.submit(p, **k)["output_ids"]
                     for p, k in PARITY_REQUESTS]
            s = eng.stats_snapshot()
            out[side] = (burst, alone, {k: s[k] for k in COUNTERS},
                         eng.kv_blocks_used)
    finally:
        for eng in sides.values():
            eng.close()
    assert out["port"] == out["jax"]
    burst, alone, counters, used = out["port"]
    assert burst == alone
    assert burst[0] == ref_greedy(jm, params, PARITY_REQUESTS[0][0], 24)
    assert counters["spec_dispatches"] > 0
    assert 0 < counters["spec_accepted"] < counters["spec_proposed"]
    assert used in (None, 0)
