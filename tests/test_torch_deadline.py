"""Request deadlines on the port: `Deadline` against the JAX package's
under one injected clock; the timeout header's statuses against the JAX
server's; 504 streamed (a terminal error frame once the stream is open)
and unstreamed, counted once each in tpk_deadline_expired_total; an
expired waiter never admitted; and an expired running request's slot (and,
paged, its blocks) freed at the next chunk boundary at depth 1 and 2, while
a live neighbour's and a later admission's greedy ids equal the JAX
model's rollout."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.utils import resilience as jres
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.generation import (GenerationEngine,
                                                 GenerativeTorchModel)
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import ModelServer
from kubeflow_tpu_torch.utils import resilience as tres
from tests.test_torch_generation import ref_greedy

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
POOLS = {"flat": {}, "paged": {"kv_block_size": 8, "kv_blocks": 24}}
#: Host seconds each decode chunk (4 tokens) is held back, so that a
#: request's deadline passes while it runs, and one that ran to its end
#: would take far longer than any bound below.
CHUNK_S = 0.1


@pytest.fixture(scope="module")
def tiny():
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


def _slow(engine, seconds=CHUNK_S):
    """Hold every decode chunk of `engine` back by `seconds` on the host."""
    def wrap(fn):
        def chunk(*args):
            time.sleep(seconds)
            return fn(*args)
        return chunk

    engine._decode = {k: wrap(f) for k, f in engine._decode.items()}
    return engine


# -- Deadline against the JAX copy --------------------------------------------


@pytest.mark.parametrize("budget,steps", [
    (5.0, [0.0, 2.0, 2.9, 0.2]), (0.5, [0.1, 0.5]), (1e-3, [0.0, 1e-3]),
    (30.0, [10.0, 25.0])])
def test_deadline_matches_jax_under_one_clock(budget, steps):
    now = [100.0]
    port = tres.Deadline(budget, clock=lambda: now[0])
    ref = jres.Deadline(budget, clock=lambda: now[0])
    for dt in steps:
        now[0] += dt
        assert port.remaining() == pytest.approx(ref.remaining())
        assert port.expired() == ref.expired()
        for t in (0.0, 0.3, 2.0, 300.0):
            assert port.bound(t) == pytest.approx(ref.bound(t))
        if ref.expired():
            with pytest.raises(tres.DeadlineExceeded, match="the op"):
                port.require("the op")
        else:
            port.require("the op")
    assert issubclass(tres.DeadlineExceeded, TimeoutError)
    never = tres.Deadline.never()
    assert never.remaining() is None and not never.expired()
    assert never.bound(7.0) == 7.0


# -- the header, against the JAX server ---------------------------------------


def _http(base, path, body, headers=None):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _PortEcho(Model):
    """Generates nothing; reports whether a Deadline rode in, and honours
    one like the engine does (raises DeadlineExceeded once it passed)."""

    def generate(self, payload):
        dl = payload.get("_deadline")
        assert dl is None or isinstance(dl, tres.Deadline)
        if payload.get("sleep"):
            time.sleep(payload["sleep"])
            if dl is not None and dl.expired():
                raise tres.DeadlineExceeded("expired")
        return {"num_output_tokens": 1, "saw_deadline": dl is not None}


@pytest.fixture(scope="module")
def servers():
    """The JAX server (this file's one) and the port's, each with an echo
    model at "echo"."""
    from kubeflow_tpu.serve import Model as JModel
    from kubeflow_tpu.serve import ModelServer as JServer

    class JaxEcho(JModel):
        def generate(self, payload):
            dl = payload.get("_deadline")
            if payload.get("sleep"):
                time.sleep(payload["sleep"])
            return {"num_output_tokens": 1, "saw_deadline": dl is not None}

    jsrv, tsrv = JServer(), ModelServer()
    jsrv.repo.register(JaxEcho("echo"))
    echo = _PortEcho("echo")
    echo.load()
    tsrv.register(echo)
    jport, tport = jsrv.start_background(), tsrv.start_background(0)
    yield f"http://127.0.0.1:{jport}", f"http://127.0.0.1:{tport}", tsrv
    jsrv.stop()
    tsrv.stop()


@pytest.mark.parametrize("value", [
    "soon", "nan", "inf", "-inf", "-5", "0", "", "1e400", "0x10", "250",
    "2500.5", "30000"])
def test_header_statuses_match_jax(servers, value):
    """Malformed budgets are 400 on both servers; valid ones (each far
    longer than the echo takes) are answered alike."""
    jbase, tbase, _ = servers
    hdr = {"X-Request-Timeout-Ms": value}
    want = _http(jbase, "/v1/models/echo:generate", {"input_ids": [1]}, hdr)
    got = _http(tbase, "/v1/models/echo:generate", {"input_ids": [1]}, hdr)
    assert got[0] == want[0]
    if want[0] == 400:
        assert "X-Request-Timeout-Ms" in json.loads(got[1])["error"]
    else:
        assert json.loads(got[1]) == json.loads(want[1])


def test_wire_deadline_field_is_stripped_as_in_jax(servers):
    jbase, tbase, _ = servers
    for hdr in ({}, {"X-Request-Timeout-Ms": "30000"}):
        body = {"input_ids": [1, 2], "_deadline": 123}
        want = _http(jbase, "/v1/models/echo:generate", body, hdr)
        got = _http(tbase, "/v1/models/echo:generate", body, hdr)
        assert got == want and got[0] == 200


def test_504_matches_jax_and_counts_once(servers):
    jbase, tbase, _ = servers
    jres.metrics.reset()
    tres.metrics.reset()
    hdr = {"X-Request-Timeout-Ms": "60"}
    body = {"input_ids": [1], "sleep": 0.3}
    want = _http(jbase, "/v1/models/echo:generate", body, hdr)
    got = _http(tbase, "/v1/models/echo:generate", body, hdr)
    assert got[0] == want[0] == 504
    assert "deadline" in json.loads(got[1])["error"].lower()
    for m in (jres.metrics, tres.metrics):
        assert m.get("tpk_deadline_expired_total", component="serve") == 1


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def llm(tiny, servers):
    """A slowed port model behind the port server as "llm", depth 2."""
    _, _, tm = tiny
    _, tbase, tsrv = servers
    model = GenerativeTorchModel("llm", tm, generation={
        **ENGINE, "tokenizer": "bytes"})
    model.load()
    _slow(model.engine)
    tsrv.register(model)
    yield tbase, model


def _frames(base, body, headers):
    req = urllib.request.Request(base + "/v1/models/llm:generate",
                                 data=json.dumps(body).encode(),
                                 method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(ln) for ln in r.read().splitlines()]


def _settled(engine, live: int = 0, timeout: float = 10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if (sum(s is not None for s in engine._slots) == live
                and engine.inflight_depth == 0 and engine._queue.empty()):
            return True
        time.sleep(0.01)
    return False


def test_504_streamed_and_unstreamed_free_the_slot(llm):
    """A 56-token request (14 chunks, 1.4 s): unstreamed under 150 ms it is
    504 at the deadline; streamed under 400 ms its first frame goes out
    at admission, so the stream ends in one terminal error frame. Each is
    counted once, and each frees its slot at the next boundary, far short
    of its budget of tokens."""
    base, model = llm
    tres.metrics.reset()
    before = model.engine.stats_snapshot()["decode_tokens"]
    body = {"input_ids": [5, 9, 2], "max_tokens": 56}
    t0 = time.monotonic()
    code, raw = _http(base, "/v1/models/llm:generate", body,
                      {"X-Request-Timeout-Ms": "150"})
    assert code == 504 and time.monotonic() - t0 < 0.15 + 2 * CHUNK_S + 0.4
    assert "deadline" in json.loads(raw)["error"]
    assert _settled(model.engine)
    frames = _frames(base, {**body, "stream": True},
                     {"X-Request-Timeout-Ms": "400"})
    assert frames[0]["tokens"] and "error" not in frames[0]
    assert set(frames[-1]) == {"model_name", "error"}
    assert "DeadlineExceeded" in frames[-1]["error"]
    assert not any(f.get("done") for f in frames)
    assert tres.metrics.get("tpk_deadline_expired_total",
                            component="serve") == 2
    assert _settled(model.engine)
    decoded = model.engine.stats_snapshot()["decode_tokens"] - before
    assert decoded < 56


def test_expired_waiter_is_never_admitted(tiny):
    """One slot, held by a long request: a waiter whose deadline passes in
    the queue raises DeadlineExceeded at its deadline and is never
    admitted (no prefill, no prompt tokens)."""
    _, _, tm = tiny
    eng = _slow(GenerationEngine(tm, **{**ENGINE, "slots": 1}))
    try:
        holder = threading.Thread(  # 10 chunks: 1 s
            target=eng.submit, args=([5, 9, 2],), kwargs={"max_tokens": 40})
        holder.start()
        t0 = time.monotonic()
        while eng._slots[0] is None and time.monotonic() - t0 < 10:
            time.sleep(0.005)
        t0 = time.monotonic()
        with pytest.raises(tres.DeadlineExceeded):
            eng.submit([7, 7, 7, 7], max_tokens=4,
                       deadline=tres.Deadline(0.08))
        assert time.monotonic() - t0 < 0.08 + 0.5
        holder.join(timeout=30)
        assert _settled(eng)
        stats = eng.stats_snapshot()
        assert stats["requests"] == 1 and stats["prompt_tokens"] == 3
    finally:
        eng.close()


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("depth", [1, 2])
def test_expired_running_request_frees_its_slot(tiny, depth, pool):
    """A live request beside one whose deadline passes while it decodes:
    at the next chunk boundary the expired one's slot is empty (its blocks
    back in the pool) while the live one runs on; at depth 2 the chunk in
    flight that still carried it is dropped at its fetch. A request
    admitted into the freed slot (its insert behind that chunk) and the
    live neighbour give the JAX rollout's greedy ids. The engine counts
    no expiry."""
    jm, params, tm = tiny
    eng = _slow(GenerationEngine(tm, pipeline_depth=depth, **ENGINE,
                                 **POOLS[pool]))
    tres.metrics.reset()
    live_prompt, late_prompt = [17, 3, 3, 8, 1], [11, 4, 9]
    out = {}

    def run(key, prompt, n, **kw):
        try:
            out[key] = eng.submit(prompt, max_tokens=n, **kw)
        except Exception as e:  # asserted below
            out[key] = e

    try:
        live = threading.Thread(target=run, args=("live", live_prompt, 40))
        live.start()
        t0 = time.monotonic()
        # 56 tokens: 14 chunks, 1.4 s, if it ran to its end.
        run("expired", [5, 9, 2], 56, deadline=tres.Deadline(0.2))
        assert isinstance(out["expired"], tres.DeadlineExceeded)
        assert time.monotonic() - t0 < 0.2 + 0.5
        # Within a few chunks: only the live request holds a slot.
        t1 = time.monotonic()
        while (sum(s is not None for s in eng._slots) != 1
               and time.monotonic() - t1 < 5):
            time.sleep(0.005)
        assert sum(s is not None for s in eng._slots) == 1
        assert all(s is None or s["req"]["input_ids"] == live_prompt
                   for s in eng._slots)
        if pool == "paged":
            assert eng.kv_blocks_used == eng._need_blocks(5, 40)
        late = threading.Thread(target=run, args=("late", late_prompt, 9))
        late.start()
        live.join(timeout=60)
        late.join(timeout=60)
        assert out["live"]["output_ids"] == ref_greedy(jm, params,
                                                       live_prompt, 40)
        assert out["late"]["output_ids"] == ref_greedy(jm, params,
                                                       late_prompt, 9)
        assert _settled(eng)
        stats = eng.stats_snapshot()
        if depth == 2:
            assert stats["decode_dead_slot_chunks"] >= 1
            assert stats["decode_wasted_tokens"] >= ENGINE["chunk"]
        else:
            assert stats["decode_dead_slot_chunks"] == 0
        if pool == "paged":
            assert eng.kv_blocks_used == 0
        assert tres.metrics.get("tpk_deadline_expired_total",
                                component="serve") == 0
    finally:
        eng.close()
