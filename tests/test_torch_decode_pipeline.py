"""The port engine's overlapped scheduler (`pipeline_depth`, default 2):
keeping decode chunks in flight changes when the host blocks, never what is
emitted.

Port twins of tests/test_decode_pipeline.py (the dispatch-count guard,
greedy ids across depths with slot reuse, seeded sampling at depth 1 and
the single-stream depth-2 replay, EOS reconciliation of dead chunks,
admission overlapping decode, max_tokens=1 without a decode fetch, depth
validation), then across packages: the JAX engine at depth 2 and the port
at depth 2 on converted weights give the same greedy ids on flat, paged and
int8-KV pools, and the port at depth 1 is bit-equal to a synchronous
prefill -> chunk -> chunk replay of its own device functions.
"""

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
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu.serve.generation import GenerationEngine as JaxEngine
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.generation import (GenerationEngine,
                                                 GenerativeTorchModel,
                                                 build_engine_fns)
from tests.test_torch_generation import ref_greedy
from tests.test_torch_quant import numpy_tree

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
PROMPTS = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40))]
BUDGETS = [6, 9, 5]


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, its fp32 params, the port model on the same weights)."""
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
def golden(tiny):
    """ref_greedy of PROMPTS at BUDGETS (the JAX model's uncached rollout),
    computed once."""
    jm, params, _ = tiny
    return [ref_greedy(jm, params, p, b) for p, b in zip(PROMPTS, BUDGETS)]


def _engine(tm, **kw):
    return GenerationEngine(tm, **{**ENGINE, **kw})


def _concurrent(engine, prompts, budgets) -> list:
    results = [None] * len(prompts)

    def run(i):
        results[i] = engine.submit(prompts[i], max_tokens=budgets[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return results


def test_dispatch_count_guard_pipelined_vs_sync(tiny):
    """The guard: for a 6-chunk generation the synchronous engine blocks on
    every fetch; the pipelined one overlaps all but the drain. A loop that
    quietly re-serialises flips these counters."""
    jm, params, tm = tiny
    prompt, chunks = [5, 9, 2], 6
    # The prefill's first token, 5 full chunks and 1 token of a 6th.
    budget = 1 + (chunks - 1) * 4 + 1
    want = ref_greedy(jm, params, prompt, budget)
    counts = {}
    for depth in (1, 2):
        eng = _engine(tm, slots=1, pipeline_depth=depth)
        try:
            assert eng.submit(prompt, max_tokens=budget)["output_ids"] == want
            counts[depth] = eng.stats_snapshot()
        finally:
            eng.close()
    sync, piped = counts[1], counts[2]
    assert sync["decode_dispatches"] == chunks
    assert sync["decode_fetch_blocking"] == chunks
    assert sync["decode_fetch_overlapped"] == 0
    assert piped["decode_fetch_blocking"] <= 2, piped
    assert piped["decode_fetch_overlapped"] >= chunks - 2, piped
    # Budget gating: no runaway speculation past max_tokens.
    assert piped["decode_dispatches"] <= chunks + 1, piped
    assert piped["decode_tokens"] == sync["decode_tokens"]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_greedy_matches_sync_multi_request(tiny, golden, depth):
    """3 concurrent requests on 2 slots (the 37-token prompt admits through
    prefill, extend_mid and extend): slot reuse with chunks in flight keeps
    every stream equal to the JAX model's uncached rollout."""
    _, _, tm = tiny
    eng = _engine(tm, pipeline_depth=depth)
    try:
        results = _concurrent(eng, PROMPTS, BUDGETS)
        assert [r["output_ids"] for r in results] == golden
        stats = eng.stats_snapshot()
        assert stats["requests"] == 3
        assert stats["prefill_chunks"] == 1 + 1 + 3
        assert eng.throughput() > 0
        assert eng.inflight_depth == 0
    finally:
        eng.close()


def test_depth1_seeded_sampling_deterministic_and_depth2_single_stream(tiny):
    """Depth 1: the same seed gives the same sampled stream across engines.
    A single budget-bounded request takes the same draws in the same order
    at depth 2 (each chunk's draws are enqueued in chunk order, and no
    chunk is dead before the budget), so its stream matches too."""
    _, _, tm = tiny
    streams = {}
    for label, depth in (("d1a", 1), ("d1b", 1), ("d2", 2)):
        eng = _engine(tm, slots=1, pipeline_depth=depth, seed=7)
        try:
            out = eng.submit([5, 9, 2], max_tokens=8, temperature=0.8,
                             top_p=0.9)
            streams[label] = (out["output_ids"], out["output_logprobs"])
            assert len(out["output_ids"]) == 8
        finally:
            eng.close()
    assert streams["d1a"] == streams["d1b"]
    assert streams["d2"] == streams["d1a"]


def test_eos_reconciles_dead_speculation_and_slot_reuse(tiny):
    """EOS lands in chunk 2 while chunk 3 is in flight: the request stops
    exactly at EOS (the dead chunk's rows dropped and counted), and the
    freed slot then serves a new request correctly although the dead
    chunk wrote into its tail."""
    jm, params, tm = tiny
    eng = _engine(tm, slots=1, pipeline_depth=2)
    try:
        free = ref_greedy(jm, params, [5, 9, 2], 12)
        eos = free[5]  # token 1 is the prefill's; 2-5 chunk 1, 6-9 chunk 2
        assert eos not in free[:5], "pick another EOS position"
        out = eng.submit([5, 9, 2], max_tokens=12, eos_id=eos)
        assert out["output_ids"] == free[:6]
        deadline = time.monotonic() + 5.0
        while (eng.stats_snapshot()["decode_dead_slot_chunks"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)  # the loop drains the dead chunk after it
        stats = eng.stats_snapshot()
        assert stats["decode_dead_slot_chunks"] >= 1
        assert stats["decode_wasted_tokens"] >= eng.chunk
        out2 = eng.submit([7, 7, 1], max_tokens=6)
        assert out2["output_ids"] == ref_greedy(jm, params, [7, 7, 1], 6)
    finally:
        eng.close()


def test_admission_overlaps_inflight_decode(tiny):
    """Request B admitted while A's chunks are in flight is right and is
    counted as an overlapped admission."""
    jm, params, tm = tiny
    # A decodes 25 chunks, so B lands mid-stream even on a loaded machine.
    eng = _engine(tm, pipeline_depth=2, max_len=128)
    try:
        results = {}

        def run_a():
            results["a"] = eng.submit([5, 9, 2], max_tokens=100)

        ta = threading.Thread(target=run_a)
        ta.start()
        deadline = time.monotonic() + 10.0
        while (eng.stats_snapshot()["decode_dispatches"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.002)
        results["b"] = eng.submit([8, 1, 4], max_tokens=8)
        ta.join(timeout=120)
        assert not ta.is_alive()
        assert results["a"]["output_ids"] == ref_greedy(
            jm, params, [5, 9, 2], 100, width=128)
        assert results["b"]["output_ids"] == ref_greedy(jm, params,
                                                        [8, 1, 4], 8)
        assert eng.stats_snapshot()["admit_overlap"] >= 1
    finally:
        eng.close()


def test_max_tokens_1_finishes_without_decode_fetch(tiny):
    """A 1-token request at depth 2 finishes on its deferred first token:
    no decode chunk is dispatched or fetched for it."""
    jm, params, tm = tiny
    eng = _engine(tm, slots=1, pipeline_depth=2)
    try:
        out = eng.submit([5, 9, 2], max_tokens=1)
        assert out["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 1)
        stats = eng.stats_snapshot()
        assert stats["decode_dispatches"] == 0
        assert stats["decode_fetch_blocking"] == 0
    finally:
        eng.close()


def test_pipeline_depth_validation_and_default(tiny):
    _, _, tm = tiny
    with pytest.raises(ValueError, match="pipeline_depth"):
        _engine(tm, pipeline_depth=0)
    model = GenerativeTorchModel("m", tm, generation=dict(ENGINE))
    model.load()
    try:
        assert model.engine.pipeline_depth == 2
        assert model.metadata()["pipeline_depth"] == 2
        assert model.metadata()["inflight_depth"] == 0  # idle
        stats = model.metadata()["stats"]
        for key in ("decode_fetch_overlapped", "decode_fetch_blocking",
                    "admit_overlap", "decode_dead_slot_chunks",
                    "decode_wasted_tokens", "host_stall_seconds"):
            assert key in stats, key
    finally:
        model.unload()
    model = GenerativeTorchModel("m", tm, generation={**ENGINE,
                                                      "pipeline_depth": 1})
    model.load()
    try:
        assert model.engine.pipeline_depth == 1
    finally:
        model.unload()


# -- across packages ----------------------------------------------------------

POOLS = {
    "flat": {},
    "paged": {"kv_block_size": 8, "kv_blocks": 24},
    "int8_kv": {"kv_block_size": 8, "kv_blocks": 24, "kv_quant": "int8"},
}


@pytest.mark.parametrize("pool", list(POOLS))
def test_depth2_greedy_equals_jax_engine(tiny, pool):
    """The JAX GenerationEngine(pipeline_depth=2) and the port at depth 2,
    on weights carried across by models/convert.py (quantize_tree weights
    for the int8-KV pool), give the same greedy ids for concurrent
    mixed-length requests."""
    jm, params, tm = tiny
    kw = POOLS[pool]
    if pool == "int8_kv":
        qparams = jq.quantize_tree(params)
        jeng = JaxEngine(jq.QuantizedModule(jm, jnp.float32), qparams,
                         jm.cfg, pipeline_depth=2, **ENGINE, **kw)
        qcfg = dataclasses.replace(tm.cfg, quantized_dense=True)
        port = tl.Llama(qcfg, device="cpu")
        port.load_state_dict(llama_params_from_jax(numpy_tree(qparams),
                                                   qcfg))
    else:
        jeng = JaxEngine(jm, params, jm.cfg, pipeline_depth=2, **ENGINE,
                         **kw)
        port = tm
    teng = GenerationEngine(port, pipeline_depth=2, **ENGINE, **kw)
    try:
        want = _concurrent(jeng, PROMPTS, BUDGETS)
        got = _concurrent(teng, PROMPTS, BUDGETS)
        assert ([r["output_ids"] for r in got]
                == [r["output_ids"] for r in want])
        if pool != "flat":
            assert teng.kv_info()["blocks_used"] == 0
    finally:
        jeng.close()
        teng.close()


def test_depth1_sampled_equals_synchronous_replay(tiny):
    """Depth 1 is the synchronous loop bit for bit: one sampled request
    (top-k, so the truncating chunk) gives the ids and logprobs of
    build_engine_fns driven by hand, prefill -> insert -> chunk -> chunk,
    with a generator of the same seed."""
    _, _, tm = tiny
    prompt, budget, seed = [5, 9, 2, 44], 9, 11
    temp, top_k, top_p = 0.8, 20, 1.0
    eng = _engine(tm, pipeline_depth=1, seed=seed)
    try:
        out = eng.submit(prompt, max_tokens=budget, temperature=temp,
                         top_k=top_k, top_p=top_p)
    finally:
        eng.close()

    fns = build_engine_fns(tm, max_len=64, chunk=4, prefill_buckets=(8, 16))
    gen = torch.Generator().manual_seed(seed)
    ids, lps = [], []
    with torch.inference_mode():
        toks = np.zeros((1, 8), np.int64)
        toks[0, :len(prompt)] = prompt
        frag, tok0, lp0 = fns["prefill"](
            torch.from_numpy(toks), len(prompt),
            torch.tensor([temp]), torch.tensor([top_k]),
            torch.tensor([top_p]), gen)
        cache = fns["insert"](tl.init_cache(tm.cfg, 2, 64, device="cpu"),
                              frag, 0)
        ids.append(int(tok0[0]))
        lps.append(float(lp0[0]))
        last = torch.tensor([int(tok0[0]), 0])
        idx = torch.tensor([len(prompt), 0])
        decode = fns["make_decode"](True, 64)
        args = (torch.tensor([temp, 0.0]), torch.tensor([top_k, 0]),
                torch.tensor([top_p, 1.0]))
        while len(ids) < budget:
            cache, chunk_toks, chunk_lps = decode(cache, last, idx, *args,
                                                  gen)
            ids += [int(t) for t in chunk_toks[0]]
            lps += [float(v) for v in chunk_lps[0]]
            last, idx = chunk_toks[:, -1], idx + 4
    assert out["output_ids"] == ids[:budget]
    assert out["output_logprobs"] == lps[:budget]
