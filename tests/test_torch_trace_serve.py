"""Spans and the request log of the port's server (serve/server.py,
serve/generation.py, serve/batcher.py) beside the JAX server's, on the
same fp32 llama_tiny weights at depth 1:

* the same requests with the same X-Request-Ids give, per id, the same
  spans (names, order, attrs other than times) on the flat, paged,
  speculative and disaggregated (:prefill then :decode) paths;
* /debug/trace answers valid Chrome trace JSON, filtered by ?trace_id=;
* a wire-supplied "_trace" cannot spoof the request's id;
* tracing adds nothing to an engine run: the aten ops dispatched over a
  whole request are the same with tracing on and off (the port's twin of
  tests/test_trace_serve.py's decode span-overhead guard), and its spans
  are chunk-granular;
* the JSONL request log's lines equal the JAX server's for one request
  sequence: the same keys in the same order, methods, paths, models,
  statuses (a drain's 503 included), body sizes, and bodies in "all"
  mode."""

import json
import time
import urllib.error
import urllib.request

import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.utils import obs as jobs
from kubeflow_tpu_torch.serve import generation as tg
from kubeflow_tpu_torch.serve.server import ModelServer, RequestLogger
from kubeflow_tpu_torch.utils import obs as tobs
from tests.test_torch_spec_decode import _pair

FLAT = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16),
            pipeline_depth=1)
PAGED = dict(FLAT, kv_block_size=8, kv_blocks=24)
SPEC = dict(slots=2, max_len=64, chunk=8, prefill_buckets=(8,),
            pipeline_depth=1)
LONG = list(range(3, 23))  # 20 tokens: a prefill and an extend chunk


@pytest.fixture(scope="module")
def servers():
    """{"jax": (base, server), "port": (base, server)}: "flat", "paged"
    and "spec" (its own weights as its draft, gamma 3) on each."""
    from kubeflow_tpu.serve import ModelServer as JServer
    from kubeflow_tpu.serve import generation as jg

    jm, params, tm = _pair()
    jsrv, tsrv = JServer(), ModelServer()
    for name, gen in (("flat", FLAT), ("paged", PAGED)):
        jsrv.repo.register(jg.GenerativeJAXModel(name, jm, params, jm.cfg,
                                                 generation=dict(gen)))
        tsrv.repo.register(tg.GenerativeTorchModel(name, tm,
                                                   generation=dict(gen)))
    jspec = jg.GenerativeJAXModel("spec", jm, params, jm.cfg)
    jspec.engine = jg.GenerationEngine(
        jm, params, jm.cfg, draft={"model": jm, "params": params,
                                   "cfg": jm.cfg, "gamma": 3}, **SPEC)
    tspec = tg.GenerativeTorchModel("spec", tm)
    tspec.engine = tg.GenerationEngine(tm, draft={"model": tm, "gamma": 3},
                                       **SPEC)
    for model, srv in ((jspec, jsrv), (tspec, tsrv)):
        model.ready = True
        srv.repo.register(model)
    out = {"jax": (f"http://127.0.0.1:{jsrv.start_background()}", jsrv),
           "port": (f"http://127.0.0.1:{tsrv.start_background(0)}", tsrv)}
    yield out
    jsrv.stop()
    tsrv.stop()


def _post(url, data: bytes, headers=None):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post_json(url, body, rid=None):
    return _post(url, json.dumps(body).encode(),
                 {"X-Request-Id": rid} if rid else None)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _spans(tracer, rid):
    return [(e["name"], e["attrs"]) for e in tracer.events(rid)]


def test_spans_per_id_equal_jax(servers):
    """flat (short and chunked prompts), paged, spec and a disaggregated
    pair: per id, the same span names in the same order with the same
    attrs."""
    tracers = {"jax": jobs.get_tracer(), "port": tobs.get_tracer()}
    for t in tracers.values():
        t.clear()
    seen = {}
    for side, (base, _) in servers.items():
        for rid, model, body in (
                ("f1", "flat", {"input_ids": [5, 9, 2, 44],
                                "max_tokens": 6}),
                ("f2", "flat", {"input_ids": LONG, "max_tokens": 5}),
                ("p1", "paged", {"input_ids": LONG, "max_tokens": 6}),
                ("s1", "spec", {"input_ids": [5, 9, 2], "max_tokens": 8})):
            code, raw, _ = _post_json(f"{base}/v1/models/{model}:generate",
                                      body, rid)
            assert code == 200, raw
        code, frame, _ = _post_json(f"{base}/v1/models/paged:prefill",
                                    {"input_ids": LONG[:13],
                                     "max_tokens": 5}, "r-pre")
        assert code == 200, frame
        code, raw, hdrs = _post(f"{base}/v1/models/paged:decode", frame,
                                {"X-Request-Id": "r-dec"})
        assert code == 200 and hdrs["X-Request-Id"] == "r-dec", raw
        seen[side] = {rid: _spans(tracers[side], rid) for rid in (
            "f1", "f2", "p1", "s1", "r-pre", "r-dec")}
    assert seen["port"] == seen["jax"]
    port = seen["port"]
    assert [n for n, _ in port["f1"]] == [
        "serve.admit", "serve.batch_gather", "serve.prefill",
        "serve.decode_chunk", "serve.fetch", "serve.decode_chunk",
        "serve.fetch"]
    assert port["f1"][0][1] == {"path": "/v1/models/flat:generate",
                                "admitted": True}
    assert port["f2"][2][1]["prompt_tokens"] == len(LONG)
    assert any(a.get("spec") for n, a in port["s1"]
               if n == "serve.decode_chunk")
    assert [n for n, _ in port["r-pre"]] == [
        "serve.admit", "serve.batch_gather", "serve.prefill"]
    assert port["r-dec"][2] == ("serve.prefill",
                                {"slot": 0, "prompt_tokens": 13})


def test_debug_trace_is_chrome_json_filtered_by_id(servers):
    base, _ = servers["port"]
    tobs.get_tracer().clear()
    rid = "trace-e2e-abc123"
    code, raw, hdrs = _post_json(f"{base}/v1/models/flat:generate",
                                 {"input_ids": [5, 9, 2, 44],
                                  "max_tokens": 6}, rid)
    assert code == 200 and hdrs["X-Request-Id"] == rid
    doc = _get(f"{base}/debug/trace")
    assert set(doc) == {"traceEvents", "displayTimeUnit", "now_us"}
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0 and "trace_id" in ev["args"]
    mine = [ev for ev in doc["traceEvents"] if ev["args"]["trace_id"] == rid]
    first = {n: min(ev["ts"] for ev in mine if ev["name"] == n)
             for n in {ev["name"] for ev in mine}}
    assert (first["serve.admit"] <= first["serve.batch_gather"]
            <= first["serve.prefill"] <= first["serve.decode_chunk"])
    filtered = _get(f"{base}/debug/trace?trace_id={rid}")["traceEvents"]
    assert filtered == mine
    assert _get(f"{base}/debug/trace?trace_id=none")["traceEvents"] == []


def test_wire_supplied_trace_field_cannot_spoof(servers):
    base, _ = servers["port"]
    tobs.get_tracer().clear()
    code, _, hdrs = _post_json(f"{base}/v1/models/flat:generate",
                               {"input_ids": [5, 9, 2], "max_tokens": 2,
                                "_trace": "spoofed"})
    assert code == 200
    assigned = hdrs["X-Request-Id"]
    ids = {ev["args"]["trace_id"]
           for ev in tobs.get_tracer().chrome_trace()["traceEvents"]}
    assert "spoofed" not in ids and assigned in ids


class _OpLog(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_tracing_adds_no_op_to_an_engine_run():
    """One greedy request, tracing on and off: the same ops dispatched by
    the worker's admissions, dispatches and fetches, the same ids, and a
    handful of spans per request (never one per token)."""
    _, _, tm = _pair()
    engine = tg.GenerationEngine(tm, **FLAT)
    ops: list = []
    for name in ("_admit", "_dispatch_chunk", "_fetch_chunk"):
        real = getattr(engine, name)

        def logged(*a, _real=real, **kw):
            with _OpLog(ops):
                return _real(*a, **kw)
        setattr(engine, name, logged)

    def run(enabled):
        prev = tobs.set_tracer(tobs.Tracer(capacity=64, enabled=enabled))
        ops.clear()
        try:
            out = engine.submit([5, 9, 2, 44], max_tokens=8,
                                trace_id="decode-guard")
            return out["output_ids"], list(ops), \
                tobs.get_tracer().events("decode-guard")
        finally:
            tobs.set_tracer(prev)

    try:
        run(True)  # the same warm state for both runs below
        ids_on, ops_on, spans_on = run(True)
        ids_off, ops_off, spans_off = run(False)
    finally:
        engine.close()
    assert ids_on == ids_off and ops_on == ops_off and ops_on
    assert spans_off == []
    names = [s["name"] for s in spans_on]
    assert names.count("serve.decode_chunk") == names.count("serve.fetch")
    assert 0 < names.count("serve.decode_chunk") <= 8 // 4 + 1
    assert len(spans_on) <= 2 + 2 * (8 // 4 + 1)


def _wait_lines(path, n, timeout=10.0):
    """Wait until the log at `path` holds `n` lines: both servers write a
    request's line after its response went out, so a client that swaps
    the logger on the response alone races the last line."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        with open(path) as f:
            if f.read().count("\n") >= n:
                return
        time.sleep(0.01)


def _log_lines(path):
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    for rec in lines:
        assert rec["latency_ms"] >= 0 and rec["ts"] > 0
    return [[(k, v) for k, v in rec.items() if k not in ("ts", "latency_ms")]
            for rec in lines]


def test_request_log_lines_equal_jax(servers, tmp_path):
    """One request sequence into both servers' loggers: one line per
    inference POST, none for GETs, probes or repository calls."""
    from kubeflow_tpu.serve.server import RequestLogger as JLogger

    got, frames = {}, {}
    for side, (base, srv) in servers.items():
        cls = JLogger if side == "jax" else RequestLogger
        meta = cls(str(tmp_path / f"{side}.jsonl"))
        full = cls(str(tmp_path / f"{side}-all.jsonl"), mode="all")
        srv.request_logger = meta
        try:
            gen = {"input_ids": [5, 9, 2], "max_tokens": 3}
            assert _post_json(f"{base}/v1/models/flat:generate",
                              gen)[0] == 200
            assert _post_json(f"{base}/v1/models/flat:generate",
                              {"input_ids": []})[0] == 400
            _get(f"{base}/v2/health/ready")
            _get(f"{base}/v2/models/flat")
            assert _post_json(f"{base}/v2/models/flat/infer", {
                "inputs": [{"name": "ids", "shape": [1, 4],
                            "datatype": "INT32", "data": [5, 9, 2, 7]}]
            })[0] == 200
            assert _post_json(f"{base}/v1/models/nope:predict",
                              {"instances": [[1]]})[0] == 404
            assert _post_json(f"{base}/v2/repository/index", {})[0] == 200
            code, frame, _ = _post_json(f"{base}/v1/models/paged:prefill",
                                        gen)
            assert code == 200
            assert _post(f"{base}/v1/models/paged:decode", frame)[0] == 200
            frames[side] = len(frame)
            srv.begin_drain()
            try:
                assert _post_json(f"{base}/v2/models/flat/generate",
                                  gen)[0] == 503
            finally:
                srv.end_drain()
            _wait_lines(tmp_path / f"{side}.jsonl", 7)
            srv.request_logger = full
            assert _post_json(f"{base}/v1/models/flat:generate",
                              dict(gen, temperature=0.0))[0] == 200
            assert _post(f"{base}/v1/models/flat:predict", b"{bad")[0] == 400
            _wait_lines(tmp_path / f"{side}-all.jsonl", 2)
        finally:
            srv.request_logger = None
            meta.close()
            full.close()
        got[side] = (_log_lines(tmp_path / f"{side}.jsonl"),
                     _log_lines(tmp_path / f"{side}-all.jsonl"))
        # A frame's size differs by its generator state (the port ships a
        # torch.Generator's): each :decode line counts its own frame.
        decode = got[side][0][5]
        assert decode[4] == ("request_bytes", frames[side])
        decode[4] = ("request_bytes", "frame")
    assert got["port"] == got["jax"]
    meta, full = got["port"]
    assert [dict(r)["status"] for r in meta] == [200, 400, 200, 404, 200,
                                                 200, 503]
    assert [k for k, _ in meta[0]] == ["method", "path", "model", "status",
                                       "request_bytes"]
    assert dict(full[0])["request"] == {"input_ids": [5, 9, 2],
                                        "max_tokens": 3, "temperature": 0.0}
    assert dict(full[1])["request"] is None


def test_request_log_mode_is_checked():
    with pytest.raises(ValueError, match="metadata | all"):
        RequestLogger("/dev/null", mode="everything")
