"""Port paged KV cache: the block allocator (the JAX test's cases, on the
port's copy and on the JAX original side by side), paged decode against
the port's flat engine (token- and logprob-identical, greedy and seeded),
admission by free blocks (a transient shortage queues head of line), the
shed of a request the pool can never hold (KVCapacityExceeded; HTTP 503
with Retry-After), and the engine's refusals."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from kubeflow_tpu.serve import paging as jax_paging
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serve import paging as torch_paging
from kubeflow_tpu_torch.serve.generation import (GenerationEngine,
                                                 GenerativeTorchModel,
                                                 KVCapacityExceeded)
from kubeflow_tpu_torch.serve.server import ModelServer

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
PAGING = [pytest.param(jax_paging, id="jax"),
          pytest.param(torch_paging, id="port")]


@pytest.fixture(scope="module")
def tm():
    cfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                              num_layers=2)
    return tl.Llama(cfg, device="cpu").init_weights(0)


def _engine(tm, **kw):
    return GenerationEngine(tm, **{**ENGINE, **kw})


# -- allocator (pure host) ----------------------------------------------------

@pytest.mark.parametrize("paging", PAGING)
def test_allocator_alloc_free_refcount(paging):
    a = paging.BlockAllocator(8, 16)
    assert a.free_blocks == 8 and a.used_blocks == 0
    ids = a.alloc(3)
    assert len(ids) == 3 and 0 not in ids  # NULL block never handed out
    assert a.free_blocks == 5 and a.used_blocks == 3
    assert all(a.refcount(b) == 1 for b in ids)
    a.incref(ids[:2])
    assert a.decref(ids) == 1  # only the unshared block frees
    assert a.free_blocks == 6
    assert a.refcount(ids[0]) == 1 and a.refcount(ids[2]) == 0
    assert a.decref(ids[:2]) == 2
    assert a.free_blocks == 8 and a.used_blocks == 0


@pytest.mark.parametrize("paging", PAGING)
def test_allocator_exhaustion_all_or_nothing_and_errors(paging):
    a = paging.BlockAllocator(4, 8)
    assert a.alloc(5) is None          # all-or-nothing: nothing taken
    assert a.free_blocks == 4
    ids = a.alloc(4)
    assert a.alloc(1) is None and a.can_alloc(0)
    a.decref(ids)
    assert a.free_blocks == 4
    with pytest.raises(ValueError):
        a.decref([ids[0]])             # double free is loud
    with pytest.raises(ValueError):
        a.incref([99])                 # unallocated id
    assert paging.blocks_for(0, 8) == 0
    assert paging.blocks_for(1, 8) == 1
    assert paging.blocks_for(17, 8) == 3


def test_port_allocator_hands_out_the_jax_order():
    """LIFO reuse, id for id, through one interleaved sequence."""
    logs = []
    for paging in (jax_paging, torch_paging):
        a, log = paging.BlockAllocator(6, 4), []
        x = a.alloc(2)
        y = a.alloc(3)
        a.decref(x)
        log += [x, y, a.alloc(1), a.alloc(2), a.free_blocks]
        logs.append(log)
    assert logs[0] == logs[1]


# -- paged against flat -------------------------------------------------------

def test_paged_equals_flat_greedy_and_seeded(tm):
    """The gathered view runs the flat chunk on the same rows, so output is
    token- and logprob-identical, for a short prompt and one that chunks
    (prefill + extend_mid + extend), greedy and sampled under one seed."""
    flat = _engine(tm, seed=7)
    paged = _engine(tm, seed=7, kv_block_size=8)
    try:
        for prompt in ([5, 9, 2], list(range(3, 40))):
            for kw in ({}, {"temperature": 0.8, "top_k": 20}):
                a = flat.submit(prompt, max_tokens=12, **kw)
                b = paged.submit(prompt, max_tokens=12, **kw)
                assert a["output_ids"] == b["output_ids"], kw
                assert a["output_logprobs"] == b["output_logprobs"], kw
        # every block back at retirement
        assert paged.kv_info()["blocks_used"] == 0
    finally:
        flat.close()
        paged.close()


def test_paged_concurrent_requests_match_solo(tm):
    """Three concurrent greedy requests on two slots: each stream equals
    its solo run (rows never see each other's blocks)."""
    prompts = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40))]
    eng = _engine(tm, kv_block_size=8)
    try:
        solo = [eng.submit(p, max_tokens=9)["output_ids"] for p in prompts]
        out = [None] * 3

        def run(i):
            out[i] = eng.submit(prompts[i], max_tokens=9)["output_ids"]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert out == solo
        assert eng.kv_info() == {"block_size": 8, "blocks": 16,
                                 "blocks_free": 16, "blocks_used": 0}
    finally:
        eng.close()


# -- exhaustion ---------------------------------------------------------------

def test_transient_shortage_queues_then_completes(tm):
    """Each request reserves 5 of the pool's 8 blocks (20 prompt + 20
    budget rows of 8): the second waits at the head of the line while a
    slot is free, and completes once the first retires. Admission asks
    the pool first (`_kv_fits`, as the JAX engine does), so the wait shows
    as a refusal there."""
    eng = _engine(tm, kv_block_size=8, kv_blocks=8)
    grants = []
    real = eng._kv_fits
    eng._kv_fits = lambda req: grants.append(real(req)) or grants[-1]
    prompts = [list(range(1, 21)), list(range(30, 50))]
    try:
        solo = [eng.submit(p, max_tokens=20)["output_ids"] for p in prompts]
        grants.clear()
        out = [None, None]

        def run(i):
            out[i] = eng.submit(prompts[i], max_tokens=20)["output_ids"]

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert out == solo
        assert False in grants  # the second request did wait for blocks
        assert eng.kv_info()["blocks_free"] == 8
    finally:
        eng.close()


def test_never_fits_is_refused_at_submit(tm):
    eng = _engine(tm, kv_block_size=8, kv_blocks=4)
    try:
        with pytest.raises(KVCapacityExceeded, match="KV blocks"):
            eng.submit(list(range(1, 30)), max_tokens=8)
        assert isinstance(KVCapacityExceeded("x"), RuntimeError)
        assert len(eng.submit([1, 2], max_tokens=4)["output_ids"]) == 4
    finally:
        eng.close()


def test_never_fits_is_503_with_retry_after_over_http(tm):
    model = GenerativeTorchModel("g", tm, generation={
        **ENGINE, "kv_block_size": 8, "kv_blocks": 4})
    server = ModelServer()
    server.register(model)
    model.load()
    port = server.start_background(0)
    base = f"http://127.0.0.1:{port}"
    try:
        req = urllib.request.Request(
            base + "/v1/models/g:generate", method="POST",
            data=json.dumps({"input_ids": list(range(1, 30)),
                             "max_tokens": 8}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "1"
        assert "KV blocks" in json.loads(err.value.read())["error"]
        with urllib.request.urlopen(base + "/v2/models/g", timeout=60) as r:
            md = json.loads(r.read())
        assert md["paged_kv"] == {"block_size": 8, "blocks": 4,
                                  "blocks_free": 4, "blocks_used": 0}
        assert md["kv_quant"] == "none"
    finally:
        server.stop()


# -- refusals -----------------------------------------------------------------

def test_block_size_must_divide_max_len_and_buckets(tm):
    with pytest.raises(ValueError, match="must divide max_len"):
        _engine(tm, kv_block_size=12)
    with pytest.raises(ValueError, match="every decode bucket"):
        _engine(tm, max_len=128, kv_block_size=32, decode_buckets=(48,))


def test_flat_engine_is_the_default(tm):
    eng = _engine(tm, kv_block_size=0, kv_blocks=0)
    try:
        assert not eng._paged and eng.kv_info() is None
        assert set(eng._cache) == {"k", "v"}
        assert eng._cache["k"].shape[1:3] == (2, 64)
    finally:
        eng.close()
