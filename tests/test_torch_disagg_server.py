"""The port's :prefill and :decode routes (serve/server.py) beside the JAX
server's PrefillHandler and DecodeHandler on the CPU, on the same fp32
weights: a unified paged model serves both routes on each server.

:prefill answers `application/x-tpk-kv`; :decode answers the :generate
shape, plain or as ndjson when the :prefill body streamed, with the JAX
handlers' ids; a frame that cannot be read, a model with no paged pool and
a model that is not generative get 400; a frame the decode pool can never
hold gets 503 with Retry-After; the frame's trace becomes the response's
X-Request-Id unless the caller sent one; the deadline header is honoured;
a role pair of the port answers as the unified model does; and the new
/metrics rows and the shipment-bytes histogram have JAX's names and
types."""

import json
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu.utils import resilience as jres
from kubeflow_tpu_torch.serve.generation import GenerativeTorchModel
from kubeflow_tpu_torch.serve.kv_transfer import rewrite_meta
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.server import (KV_SHIPMENT_CONTENT_TYPE,
                                             ModelServer)
from kubeflow_tpu_torch.utils import resilience as tres
from tests.test_torch_kv_transfer import (  # noqa: F401 (pair: a fixture)
    GEN, pair, rng_prompt)
from tests.test_torch_serving_surface import _families

FLAT = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
#: The rows this slice adds, as each server renders them.
NEW_FAMILIES = ("tpk_engine_remote_admits_total",
                "tpk_kv_blocks_shipped_total",
                "tpk_kv_blocks_received_total", "tpk_kv_shipment_bytes",
                "tpk_engine_prefill_chunks_total", "tpk_engine_role")


class _Plain(Model):
    """A model that is not generative."""


@pytest.fixture(scope="module")
def servers(pair):
    """{"jax": base, "port": base}: "llm" (unified, paged) on each; on the
    port also "tiny" (decode role, a pool of 4 blocks), "flat" (no pool),
    "plain" (not generative) and a prefill/decode pair "pre"/"dec"."""
    from kubeflow_tpu.serve import ModelServer as JServer
    from kubeflow_tpu.serve.generation import GenerativeJAXModel

    jm, params, tm = pair
    gen = {k: v for k, v in GEN.items() if k != "seed"}
    jsrv = JServer()
    jsrv.repo.register(GenerativeJAXModel("llm", jm, params, jm.cfg,
                                          generation=dict(gen)))
    tsrv = ModelServer()
    for name, g in (("llm", gen), ("tiny", dict(gen, kv_blocks=4,
                                                 role="decode")),
                    ("flat", FLAT), ("pre", dict(gen, role="prefill")),
                    ("dec", dict(gen, role="decode"))):
        model = GenerativeTorchModel(name, tm, generation=g)
        model.load()
        tsrv.repo.register(model)
    tsrv.repo.register(_Plain("plain"))
    out = {"jax": f"http://127.0.0.1:{jsrv.start_background()}",
           "port": f"http://127.0.0.1:{tsrv.start_background(0)}"}
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


def _prefill(base, model, body, headers=None):
    return _post(f"{base}/v1/models/{model}:prefill",
                 json.dumps(body).encode(), headers)


def _decode(base, model, frame, headers=None):
    return _post(f"{base}/v1/models/{model}:decode", frame, {
        "Content-Type": KV_SHIPMENT_CONTENT_TYPE, **(headers or {})})


def _ndjson(raw: bytes) -> list:
    return [json.loads(line) for line in raw.decode().splitlines() if line]


BODY = {"input_ids": rng_prompt(3, 21), "max_tokens": 7}


def test_prefill_then_decode_plain_and_streamed_match_jax(servers):
    got = {}
    for side, base in servers.items():
        code, frame, hdrs = _prefill(base, "llm", BODY)
        assert code == 200, frame
        assert hdrs["Content-Type"] == KV_SHIPMENT_CONTENT_TYPE
        code, raw, hdrs = _decode(base, "llm", frame)
        assert code == 200 and hdrs["Content-Type"].startswith(
            "application/json"), raw
        plain = json.loads(raw)
        code, frame_s, _ = _prefill(base, "llm", dict(BODY, stream=True))
        assert code == 200
        code, raw, hdrs = _decode(base, "llm", frame_s)
        assert code == 200
        assert hdrs["Content-Type"] == "application/x-ndjson"
        events = _ndjson(raw)
        assert events[-1]["done"] is True
        assert [t for ev in events[:-1] for t in ev["tokens"]] == \
            events[-1]["output_ids"] == plain["output_ids"]
        assert {ev["model_name"] for ev in events} == {"llm"}
        got[side] = plain
    assert got["port"]["output_ids"] == got["jax"]["output_ids"]
    assert set(got["port"]) == set(got["jax"])
    assert len(got["port"]["output_ids"]) == BODY["max_tokens"]


def test_role_pair_answers_as_the_unified_model(servers):
    base = servers["port"]
    code, frame, _ = _prefill(base, "pre", BODY)
    assert code == 200
    code, raw, _ = _decode(base, "dec", frame)
    _, ref, _ = _decode(base, "llm", _prefill(base, "llm", BODY)[1])
    assert code == 200
    assert json.loads(raw)["output_ids"] == json.loads(ref)["output_ids"]
    code, raw, _ = _post(f"{base}/v1/models/pre:generate",
                         json.dumps(BODY).encode())
    assert code == 400 and b"refuses a local generate" in raw
    code, raw, _ = _decode(base, "pre", frame)
    assert code == 400 and b"refuses decode" in raw
    code, raw, _ = _prefill(base, "dec", BODY)
    assert code == 400 and b"refuses prefill" in raw


@pytest.mark.parametrize("case", ["truncated", "not a frame", "flat",
                                  "plain"])
def test_bad_requests_get_400(servers, case):
    base = servers["port"]
    frame = _prefill(base, "llm", BODY)[1]
    if case == "truncated":
        code, raw, _ = _decode(base, "llm", frame[:-9])
        assert b"truncated shipment payload" in raw
    elif case == "not a frame":
        code, raw, _ = _decode(base, "llm", b"GET / HTTP/1.1")
        assert b"bad KV shipment" in raw
    elif case == "flat":
        code, raw, _ = _prefill(base, "flat", BODY)
        assert b"paged" in raw
        assert _decode(base, "flat", frame)[0] == 400
    else:
        code, raw, _ = _prefill(base, "plain", BODY)
        assert b"cannot prefill-ship" in raw
        assert _decode(base, "plain", frame)[0] == 400
    assert code == 400


def test_a_frame_that_can_never_fit_sheds_503(servers):
    base = servers["port"]
    frame = _prefill(base, "llm", dict(BODY, max_tokens=40))[1]
    tres.metrics.reset()
    code, raw, hdrs = _decode(base, "tiny", frame)
    assert code == 503 and hdrs["Retry-After"] == "1"
    assert b"pool has 4" in raw
    assert tres.metrics.get("tpk_shed_total", component="serve") == 1


def test_trace_adoption_and_deadline(servers):
    base = servers["port"]
    frame = rewrite_meta(_prefill(base, "llm", BODY)[1], trace="caller-7")
    code, _, hdrs = _decode(base, "llm", frame)
    assert code == 200 and hdrs["X-Request-Id"] == "caller-7"
    code, _, hdrs = _decode(base, "llm", frame, {"X-Request-Id": "mine-1"})
    assert code == 200 and hdrs["X-Request-Id"] == "mine-1"
    code, raw, _ = _decode(base, "llm", frame,
                           {"X-Request-Timeout-Ms": "0"})
    assert code == 400 and b"X-Request-Timeout-Ms" in raw
    code, raw, _ = _prefill(base, "llm", BODY,
                            {"X-Request-Timeout-Ms": "-1"})
    assert code == 400 and b"X-Request-Timeout-Ms" in raw
    tres.metrics.reset()
    code, raw, _ = _decode(base, "llm", rewrite_meta(frame, max_tokens=60),
                           {"X-Request-Timeout-Ms": "1"})
    assert code == 504, raw
    assert tres.metrics.get("tpk_deadline_expired_total",
                              component="serve") == 1


def test_metrics_rows_match_jax(servers):
    """After one :prefill and one :decode on each server, the new rows and
    the shipment-bytes histogram have JAX's names and types (and label
    keys), and the counters read what each engine did."""
    scrapes = {}
    for side, metrics in (("jax", jres.metrics), ("port", tres.metrics)):
        base = servers[side]
        metrics.reset()
        frame = _prefill(base, "llm", BODY)[1]
        assert _decode(base, "llm", frame)[0] == 200
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            scrapes[side] = r.read().decode()
    jax_f, port_f = _families(scrapes["jax"]), _families(scrapes["port"])
    for name in NEW_FAMILIES:
        assert name in jax_f and port_f.get(name) == jax_f[name], name
    assert jax_f["tpk_kv_shipment_bytes"][0] == "histogram"
    text = scrapes["port"]
    for row in ('tpk_engine_remote_admits_total{model="llm"} ',
                'tpk_kv_blocks_shipped_total{model="llm"} ',
                'tpk_kv_blocks_received_total{model="llm"} '):
        assert row in text, row
    assert 'tpk_engine_role{model="pre",role="prefill"} 1' in text
    assert "tpk_kv_shipment_bytes_count 1" in text
    assert "tpk_kv_shipment_bytes_count 1" in scrapes["jax"]
