"""The port server's request surface beside the JAX server's: admission
shedding and readiness degrading and recovering, draining with
X-Tpk-Draining, X-Request-Id echoed and sanitised, the v1/v2 routes, the
model repository (background load, reload, unload, index, a failed load
answering 503, a version swap with its grace window and a rollback), and
/metrics: every family the port renders has the JAX server's name, type
and labels, and the families only the JAX server renders are exactly
those of the features the port refuses."""

import dataclasses
import json
import re
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
from kubeflow_tpu_torch.serve.generation import GenerativeTorchModel
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.runtimes import export_for_serving
from kubeflow_tpu_torch.serve.server import (AdmissionController,
                                             ModelRepository, ModelServer)
from kubeflow_tpu_torch.utils import resilience as tres
from tests.test_torch_generation import hf_checkpoint, ref_greedy

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
KW = {"dtype": "float32", "num_layers": 2}

#: The JAX engine's /metrics families of features the port refuses at
#: the bundle (serve/generation.py `_UNPORTED`): none renders one.
REFUSED_FAMILIES: set = set()


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


class _PortSlow(Model):
    """Sleeps as asked, then honours the request's deadline as the engine
    does (the port bounds a request by its model's `submit`, the JAX server
    by its own wait)."""

    def generate(self, payload):
        time.sleep(payload.get("sleep", 0.0))
        dl = payload.get("_deadline")
        if dl is not None and dl.expired():
            raise tres.DeadlineExceeded("expired")
        return {"num_output_tokens": 1}


@pytest.fixture(scope="module")
def servers(tiny):
    """{"jax": (base, server), "port": (base, server)}: each with "llm" (a
    generative model on the same weights: this file's one JAX engine) and
    "slow" (sleeps as asked), behind admission of one request at a time
    with a 2 s retry window."""
    from kubeflow_tpu.serve import AdmissionController as JAdmission
    from kubeflow_tpu.serve import Model as JModel
    from kubeflow_tpu.serve import ModelServer as JServer
    from kubeflow_tpu.serve.generation import GenerativeJAXModel

    class JaxSlow(JModel):
        def generate(self, payload):
            time.sleep(payload.get("sleep", 0.0))
            return {"num_output_tokens": 1}

    jm, params, tm = tiny
    jsrv = JServer(admission=JAdmission(max_inflight=1, retry_after_s=2.0))
    jsrv.repo.register(GenerativeJAXModel("llm", jm, params, jm.cfg,
                                          generation=dict(ENGINE)))
    jsrv.repo.register(JaxSlow("slow"))
    tsrv = ModelServer(admission=AdmissionController(max_inflight=1,
                                                     retry_after_s=2.0))
    tsrv.repo.register(GenerativeTorchModel("llm", tm,
                                            generation=dict(ENGINE)))
    tsrv.repo.register(_PortSlow("slow"))
    out = {"jax": (f"http://127.0.0.1:{jsrv.start_background()}", jsrv),
           "port": (f"http://127.0.0.1:{tsrv.start_background(0)}", tsrv)}
    yield out
    jsrv.stop()
    tsrv.stop()


def _http(method, url, body=None, headers=None):
    req = urllib.request.Request(
        url, method=method, headers=headers or {},
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw, code, hdrs = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        raw, code, hdrs = e.read(), e.code, e.headers
    ctype = hdrs.get("Content-Type", "")
    return code, (json.loads(raw or b"{}") if "json" in ctype
                  else raw.decode()), hdrs


def _wait(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return pred()


# -- admission and draining ---------------------------------------------------


def _shed_story(base, srv, metrics) -> list:
    """The JAX fault test's overload story, recorded as observations."""
    metrics.reset()
    seen, first = [], []
    t = threading.Thread(target=lambda: first.append(_http(
        "POST", f"{base}/v1/models/slow:generate",
        {"input_ids": [1], "sleep": 2.0})))
    t.start()
    assert _wait(lambda: srv.admission.inflight == 1)
    # Full but not rejecting: readiness holds.
    seen.append(_http("GET", f"{base}/v2/health/ready")[0])
    code, body, hdrs = _http("POST", f"{base}/v1/models/llm:generate",
                             {"input_ids": [3, 4], "max_tokens": 2})
    seen.append((code, body, hdrs["Retry-After"]))
    # The OpenAI facade sits behind the same gate, in its own envelope.
    code, body, hdrs = _http("POST", f"{base}/openai/v1/chat/completions",
                             {"model": "slow", "messages": []})
    seen.append((code, body, hdrs["Retry-After"]))
    seen.append(_http("GET", f"{base}/v2/health/ready")[:2])
    seen.append(_http("GET", f"{base}/v2/health/live")[:2])
    t.join(timeout=10)
    seen.append(first[0][:2])
    seen.append(_http("GET", f"{base}/v2/health/ready")[:2])
    seen.append(metrics.get("tpk_shed_total", component="serve"))
    text = _http("GET", f"{base}/metrics")[1]
    seen.append('tpk_shed_total{component="serve"} 2' in text)
    seen.append("tpk_serve_inflight 0" in text)
    return seen


def test_shed_and_readiness_match_jax(servers):
    want = _shed_story(*servers["jax"], jres.metrics)
    got = _shed_story(*servers["port"], tres.metrics)
    assert got == want
    assert got[1][0] == 503 and "overloaded" in got[1][1]["error"]
    assert got[2][1]["error"]["type"] == "overloaded_error"
    assert got[3] == (503, {"error": "shedding: admission queue full"})
    assert got[-3:] == [2, True, True]


def test_admission_bound_holds_under_contention():
    """64 threads (more than cores) race try_acquire/release with a tiny
    switch interval: never more than max_inflight inside, every shed
    counted, nothing left held."""
    import sys

    adm = AdmissionController(max_inflight=3)
    tres.metrics.reset()
    inside, peak, sheds = [0], [0], [0]
    lock = threading.Lock()

    def worker():
        for _ in range(300):
            if not adm.try_acquire():
                with lock:
                    sheds[0] += 1
                continue
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            with lock:
                inside[0] -= 1
            adm.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert peak[0] <= 3 and adm.inflight == 0 and sheds[0] > 0
    assert tres.metrics.get("tpk_shed_total", component="serve") == sheds[0]


def _drain_story(base, srv) -> list:
    srv.begin_drain()
    try:
        seen = []
        for path, body in (("/v1/models/llm:generate", {"input_ids": [1]}),
                           ("/openai/v1/completions",
                            {"model": "llm", "prompt": [1]})):
            code, body, hdrs = _http("POST", base + path, body)
            seen.append((code, body, hdrs["Retry-After"],
                         hdrs["X-Tpk-Draining"]))
        seen.append(_http("GET", f"{base}/v2/health/ready")[:2])
    finally:
        srv.end_drain()
    seen.append(_http("GET", f"{base}/v2/health/ready")[:2])
    code, body, _ = _http("POST", f"{base}/v1/models/llm:generate",
                          {"input_ids": [5, 9, 2], "max_tokens": 4})
    seen.append((code, body["output_ids"]))
    return seen


def test_drain_matches_jax(servers):
    want = _drain_story(*servers["jax"])
    got = _drain_story(*servers["port"])
    assert got == want
    assert got[0] == (503, {"error": "replica draining"}, "1", "1")
    assert got[2] == (503, {"error": "draining"})


# -- request ids and routes ---------------------------------------------------


@pytest.mark.parametrize("rid", [
    "abc-123", "req.7:x_y", "a b/c\"<>é", "x" * 300, "", None])
def test_request_id_echoed_and_sanitised_as_jax(servers, rid):
    """The port echoes the id on every response; the JAX server's error
    responses drop their headers, so the two are compared on a 200."""
    hdr = {} if rid is None else {"X-Request-Id": rid}
    ids = [_http("GET", servers[side][0] + "/v2/health/live",
                 headers=hdr)[2]["X-Request-Id"] for side in ("jax", "port")]
    ids.append(_http("GET", servers["port"][0] + "/v2/models/nope",
                     headers=hdr)[2]["X-Request-Id"])
    if rid:
        assert ids[2] == ids[1] == ids[0]
    else:  # a fresh uuid4 hex each
        assert all(re.fullmatch(r"[0-9a-f]{32}", i) for i in ids)


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/v1/models", None),
    ("GET", "/v1/models/llm", None),
    ("GET", "/v1/models/nope", None),
    ("GET", "/v2/models/llm/ready", None),
    ("GET", "/v2/models/nope/ready", None),
    ("POST", "/v2/repository/index", {}),
    ("POST", "/v2/repository/models/nope/unload", {}),
    ("POST", "/v2/models/llm/generate",
     {"input_ids": [5, 9, 2], "max_tokens": 6}),
    ("POST", "/v2/models/nope/generate", {"input_ids": [1]}),
    ("POST", "/v1/models/llm:generate", {"input_ids": []}),
    ("POST", "/v1/models/llm:generate", {"max_tokens": 2}),
    ("POST", "/v1/models/slow:generate", {"input_ids": [1]}),
    ("GET", "/v1/models/llm:generate", None),
    ("GET", "/v2/health/nope", None),
])
def test_routes_match_jax(servers, method, path, body):
    """Statuses equal; bodies equal where they carry no latency, and
    greedy ids equal on the generate routes."""
    want = _http(method, servers["jax"][0] + path, body)
    got = _http(method, servers["port"][0] + path, body)
    assert got[0] == want[0], (got[:2], want[:2])
    if got[0] == 200 and isinstance(want[1], dict) and \
            "output_ids" in want[1]:
        assert got[1]["output_ids"] == want[1]["output_ids"]
        assert set(got[1]) == set(want[1])
    elif got[0] in (200, 202):
        assert got[1] == want[1]


def test_v2_generate_equals_v1_generate(servers):
    base = servers["port"][0]
    body = {"input_ids": [5, 9, 2], "max_tokens": 6}
    v1 = _http("POST", f"{base}/v1/models/llm:generate", body)[1]
    v2 = _http("POST", f"{base}/v2/models/llm/generate", body)[1]
    assert v1["output_ids"] == v2["output_ids"] and v2["model_name"] == "llm"


# -- /metrics -----------------------------------------------------------------


def _families(text: str) -> dict:
    """{family: (type, sorted label keys over its samples)}."""
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
            labels.setdefault(name, set())
        elif line and not line.startswith("#"):
            sample = line.split(" ")[0]
            name, _, rest = sample.partition("{")
            fam = next(f for f in (name, re.sub(r"_(bucket|sum|count)$", "",
                                                name)) if f in types)
            labels[fam] |= set(re.findall(r'(\w+)="', rest))
    return {n: (types[n], tuple(sorted(labels[n]))) for n in types}


def test_metrics_families_match_jax(servers):
    scrapes = {}
    for side, metrics in (("jax", jres.metrics), ("port", tres.metrics)):
        base, _ = servers[side]
        metrics.reset()
        assert _http("POST", f"{base}/v1/models/llm:generate",
                     {"input_ids": [5, 9, 2], "max_tokens": 6})[0] == 200
        assert _http("POST", f"{base}/v1/models/slow:generate",
                     {"input_ids": [1], "sleep": 0.3},
                     {"X-Request-Timeout-Ms": "50"})[0] == 504
        t0 = time.monotonic()
        code, text, hdrs = _http("GET", f"{base}/metrics")
        assert code == 200 and time.monotonic() - t0 < 5
        assert hdrs["Content-Type"] == "text/plain; version=0.0.4"
        scrapes[side] = text
    jax_f, port_f = _families(scrapes["jax"]), _families(scrapes["port"])
    for name, spec in port_f.items():
        assert jax_f.get(name) == spec, name
    assert set(jax_f) - set(port_f) == REFUSED_FAMILIES
    for must in ('tpk_deadline_expired_total{component="serve"} 1',
                 'tpk_engine_role{model="llm",role="unified"} 1',
                 'tpk_kv_quant_mode{model="llm",mode="none"} 1',
                 'tpk_serve_request_latency_seconds_count{model="llm"} 1',
                 'tpk_engine_decode_tokens_total{model="llm"} '):
        assert must in scrapes["port"], must


#: The speculative-decoding series of one model.
SPEC_SERIES = ("tpk_engine_spec_dispatch_total", "tpk_spec_proposed_total",
               "tpk_spec_accepted_total", "tpk_spec_stale_rides_total",
               "tpk_spec_accept_rate")


def test_spec_metrics_and_metadata_match_jax(tiny, tmp_path):
    """A model with `generative.draft` (the target's own weights as an HF
    checkpoint) beside a draft-less one, on a JAX server and on the port's:
    after the same greedy requests, the spec series of /metrics are equal,
    value for value, and so is metadata's "speculative"; the draft-less
    model renders its counters at 0 and no accept-rate gauge."""
    from kubeflow_tpu.serve import ModelServer as JServer
    from kubeflow_tpu.serve.generation import GenerativeJAXModel

    jm, params, tm = tiny
    ckpt = hf_checkpoint(tm, tmp_path / "draft")
    draft = {"checkpoint": ckpt, "gamma": 3}
    jsrv, tsrv = JServer(), ModelServer(max_inflight=0)
    jsrv.repo.register(GenerativeJAXModel("spec", jm, params, jm.cfg,
                                          generation={**ENGINE, "draft": {
                                              **draft, "model_overrides": {
                                                  "dtype": jnp.float32}}}))
    jsrv.repo.register(GenerativeJAXModel("plain", jm, params, jm.cfg,
                                          generation=dict(ENGINE)))
    tsrv.repo.register(GenerativeTorchModel("spec", tm, generation={
        **ENGINE, "draft": {**draft, "model_overrides": {
            "dtype": "float32"}}}))
    tsrv.repo.register(GenerativeTorchModel("plain", tm,
                                            generation=dict(ENGINE)))
    out = {}
    try:
        for side, srv in (("jax", jsrv), ("port", tsrv)):
            base = f"http://127.0.0.1:{srv.start_background(0)}"
            ids = [_http("POST", f"{base}/v1/models/spec:generate",
                         {"input_ids": p, "max_tokens": n})[1]["output_ids"]
                   for p, n in (([5, 9, 2], 10), ([11, 4], 8))]
            _http("POST", f"{base}/v1/models/plain:generate",
                  {"input_ids": [1, 2], "max_tokens": 4})
            text = _http("GET", f"{base}/metrics")[1]
            series = sorted(
                line for line in text.splitlines()
                if any(line.startswith(f"{m}{{") or line.startswith(
                    f"# TYPE {m} ") for m in SPEC_SERIES))
            md = [_http("GET", f"{base}/v2/models/{m}")[1]["speculative"]
                  for m in ("spec", "plain")]
            out[side] = (ids, series, md)
    finally:
        jsrv.stop()
        tsrv.stop()
    assert out["port"] == out["jax"]
    ids, series, md = out["port"]
    assert md == [True, False]
    assert 'tpk_spec_accept_rate{model="spec"} 1' in series
    assert not any('rate{model="plain"}' in line for line in series)
    assert 'tpk_spec_proposed_total{model="plain"} 0' in series
    assert ids[0] == ref_greedy(jm, params, [5, 9, 2], 10)


def test_paged_engine_renders_the_pool_gauges(tiny):
    _, _, tm = tiny
    srv = ModelServer(max_inflight=0)
    srv.repo.register(GenerativeTorchModel("p", tm, generation={
        **ENGINE, "kv_block_size": 8, "kv_blocks": 12}))
    try:
        text = srv.prometheus_text()
    finally:
        srv.stop()
    assert "# TYPE tpk_kv_blocks_free gauge" in text
    assert 'tpk_kv_blocks_free{model="p"} 12' in text
    assert 'tpk_kv_blocks_used{model="p"} 0' in text
    assert "tpk_serve_inflight" not in text  # admission off


# -- the model repository -----------------------------------------------------


def _bundle(path, seed=3) -> str:
    return export_for_serving(str(path), model="llama_tiny",
                              model_kwargs=KW, seed=seed,
                              extra={"generative": dict(ENGINE)})


@pytest.fixture()
def repo_server(monkeypatch):
    monkeypatch.setattr(ModelRepository, "UNLOAD_GRACE_S", 0.3)
    srv = ModelServer(device="cpu")
    base = f"http://127.0.0.1:{srv.start_background(0)}"
    yield base, srv
    srv.stop()


def _ready_dir(base, name, model_dir, timeout=60.0):
    def landed():
        code, body, _ = _http("GET", f"{base}/v2/models/{name}/ready")
        return code == 200 and body["model_dir"] == model_dir
    return _wait(landed, timeout)


def test_repository_load_reload_unload_index(repo_server, tmp_path):
    base, srv = repo_server
    d1, d2 = _bundle(tmp_path / "v1"), _bundle(tmp_path / "v2", seed=4)
    url = f"{base}/v2/repository/models/m"
    assert _http("POST", f"{url}/load", {"model_dir": d1})[:2] == (
        202, {"name": "m", "state": "LOADING"})
    assert _ready_dir(base, "m", d1)
    gen = {"input_ids": [5, 9, 2], "max_tokens": 5}
    first = _http("POST", f"{base}/v1/models/m:generate", gen)[1]
    v1 = srv.repo.get("m")
    # Latest intent wins: two loads in a row land the second.
    _http("POST", f"{url}/load", {"model_dir": d1})
    assert _http("POST", f"{url}/load", {"model_dir": d2})[0] == 202
    assert _ready_dir(base, "m", d2)
    assert _http("POST", f"{base}/v1/models/m:generate",
                 gen)[1]["output_ids"] != first["output_ids"]
    assert _wait(lambda: v1.engine is None)  # unloaded after its grace
    # A bodyless load re-loads from the recorded directory, synchronously.
    v2 = srv.repo.get("m")
    assert _http("POST", f"{url}/load")[:2] == (
        200, {"name": "m", "state": "READY"})
    assert srv.repo.get("m") is not v2 and srv.repo.get("m").ready
    assert _http("POST", f"{base}/v2/repository/index", {})[1] == [
        {"name": "m", "state": "READY"}]
    assert _http("POST", f"{url}/unload")[:2] == (
        200, {"name": "m", "state": "UNAVAILABLE"})
    assert _http("GET", f"{base}/v2/models/m/ready")[0] == 503
    assert _http("GET", f"{base}/v1/models/m")[0] == 503
    assert _http("GET", f"{base}/v2/health/ready")[:2] == (
        503, {"error": "models loading"})
    assert _http("POST", f"{base}/v2/repository/index", {})[1] == [
        {"name": "m", "state": "UNAVAILABLE"}]
    assert _http("POST", f"{base}/v1/models/m:generate", gen)[0] == 400
    assert _http("POST", f"{base}/v2/repository/models/x/unload")[0] == 404
    assert _http("POST", f"{base}/v2/repository/models/x/load")[0] == 404


def test_failed_background_load_answers_503(repo_server, tmp_path, servers):
    """As on the JAX server: the failed load's error on /v2/models/{name},
    503, until a load succeeds."""
    base, _ = repo_server
    bad = str(tmp_path / "missing")
    for b in (base, servers["jax"][0]):
        assert _http("POST", f"{b}/v2/repository/models/bad/load",
                     {"model_dir": bad})[0] == 202
        assert _wait(lambda: _http("GET", f"{b}/v2/models/bad")[0] == 503)
        code, body, _ = _http("GET", f"{b}/v2/models/bad")
        assert code == 503
        assert body["error"].startswith("model 'bad' failed to load: ")
    d = _bundle(tmp_path / "good")
    _http("POST", f"{base}/v2/repository/models/bad/load", {"model_dir": d})
    assert _ready_dir(base, "bad", d)


def test_version_swap_grace_and_rollback(repo_server, tmp_path):
    """A replaced version serves on for UNLOAD_GRACE_S, then is unloaded;
    re-registered within the window (a rollback), it stays loaded and the
    version it replaced goes instead."""
    _, srv = repo_server
    d = _bundle(tmp_path / "b")
    srv.load(d, name="m")
    v1 = srv.repo.get("m")
    from kubeflow_tpu_torch.serve.runtimes import load_model

    v2 = srv.repo.register(load_model(d, name="m", device="cpu"),
                           model_dir=d)
    assert v1.engine is not None and v2.ready
    assert _wait(lambda: v1.engine is None, 5)
    v3 = srv.repo.register(load_model(d, name="m", device="cpu"))
    srv.repo.register(v2)  # rollback inside v2's grace window
    # v3's timer started after v2's: once it has fired, so has v2's.
    assert _wait(lambda: v3.engine is None, 10)
    time.sleep(ModelRepository.UNLOAD_GRACE_S)
    assert srv.repo.get("m") is v2 and v2.engine is not None
    assert v2.engine.submit([5, 9, 2], max_tokens=3)["num_output_tokens"] == 3
