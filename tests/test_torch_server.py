"""Port HTTP server (standard library) in process, on the CPU, over a
torch-registry bundle."""

import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from kubeflow_tpu_torch.serve.runtimes import export_for_serving, load_model
from kubeflow_tpu_torch.serve.server import ModelServer

GEN = {"slots": 2, "max_len": 64, "chunk": 4, "prefill_buckets": [8, 16]}
KW = {"dtype": "float32", "num_layers": 2}


def _http(method, url, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, method=method, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    bundle = str(tmp_path_factory.mktemp("torchbundle"))
    export_for_serving(bundle, model="llama_tiny", model_kwargs=KW, seed=3,
                       extra={"generative": GEN})
    server = ModelServer()
    model = server.load(bundle, name="g", device="cpu")
    port = server.start_background(0)
    yield f"http://127.0.0.1:{port}", model
    server.stop()
    assert model.engine is None  # stop() unloaded it


def test_health_and_model_listing(served):
    base, _ = served
    assert _http("GET", base + "/v2/health/live") == (200, {"live": True})
    assert _http("GET", base + "/v2/health/ready") == (200, {"ready": True})
    assert _http("GET", base + "/v1/models") == (200, {"models": ["g"]})
    status, md = _http("GET", base + "/v2/models/g")
    assert status == 200 and md["generative"] and md["max_len"] == 64
    assert md["decode_buckets"] == [64] and md["pipeline_depth"] == 2
    assert _http("GET", base + "/v2/models/nope")[0] == 404


def test_generate_equals_engine_submit(served):
    base, model = served
    status, out = _http("POST", base + "/v1/models/g:generate",
                        {"input_ids": [5, 9, 2], "max_tokens": 6})
    assert status == 200 and out["model_name"] == "g"
    direct = model.engine.submit([5, 9, 2], max_tokens=6)
    assert out["output_ids"] == direct["output_ids"]
    assert out["num_output_tokens"] == 6 and out["num_input_tokens"] == 3
    assert "decode_tokens_per_sec" in out


def test_bad_requests(served):
    base, _ = served
    url = base + "/v1/models/g:generate"
    assert _http("POST", url, {"input_ids": []})[0] == 400
    assert _http("POST", url, {"input_ids": "abc"})[0] == 400
    assert _http("POST", url, {"input_ids": [1], "top_p": 0})[0] == 400
    assert _http("POST", base + "/v1/models/nope:generate",
                 {"input_ids": [1]})[0] == 404
    assert _http("POST", url, {"input_ids": [1]},
                 {"X-Request-Timeout-Ms": "soon"})[0] == 400
    # No adapters on this engine: a request's adapter is a bad request.
    assert _http("POST", url, {"input_ids": [1], "adapter": "a"})[0] == 400
    req = urllib.request.Request(url, method="POST", data=json.dumps(
        {"input_ids": [1], "max_tokens": 3, "stream": True}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/x-ndjson"
        events = [json.loads(ln) for ln in r.read().splitlines()]
    assert events[-1]["done"] is True
    assert [t for ev in events[:-1] for t in ev["tokens"]] == \
        events[-1]["output_ids"]


def test_bundle_round_trip_with_params(tmp_path):
    """params.pt written by export_for_serving is what load_model serves."""
    first = load_model(_bundle(tmp_path / "a"), device="cpu")
    sd = first._model.state_dict()
    d = export_for_serving(str(tmp_path / "b"), model="llama_tiny",
                           model_kwargs=KW, params=sd, seed=99,
                           extra={"generative": GEN})
    again = load_model(d, device="cpu")
    for name, tensor in again._model.state_dict().items():
        assert torch.equal(tensor, sd[name]), name


def _bundle(path, **extra):
    return export_for_serving(str(path), model="llama_tiny", model_kwargs=KW,
                              seed=3, extra={"generative": GEN, **extra})


def test_bundles_this_package_cannot_serve_are_refused(tmp_path):
    jax_bundle = _bundle(tmp_path / "jax")
    spec = json.load(open(os.path.join(jax_bundle, "model.json")))
    spec["format"] = "jax-registry"
    json.dump(spec, open(os.path.join(jax_bundle, "model.json"), "w"))
    with pytest.raises(ValueError, match="jax-registry"):
        load_model(jax_bundle, device="cpu")
    orbax = _bundle(tmp_path / "orbax")
    os.makedirs(os.path.join(orbax, "params"))
    with pytest.raises(ValueError, match="orbax"):
        load_model(orbax, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        load_model(_bundle(tmp_path / "q", quantize="fp4"), device="cpu")
    # A bundle without "generative" is no longer refused: it loads and
    # predicts as the JAX runtime's fixed forward on the same weights.
    import jax
    import numpy as np

    from kubeflow_tpu.serve import runtimes as jrt
    from kubeflow_tpu_torch.models.convert import llama_params_from_jax
    from kubeflow_tpu_torch.utils.registry import model_config

    jdir = str(tmp_path / "jp")
    jrt.export_for_serving(jdir, model="llama_tiny", model_kwargs=KW,
                           seed=3, batch_buckets=(2,))
    jmodel = jrt.load_model(jdir)
    jmodel.load()
    cfg = model_config("llama_tiny", **KW)
    sd = llama_params_from_jax(
        jax.tree.map(np.asarray, jmodel.apply_and_params()[1]), cfg)
    plain = export_for_serving(str(tmp_path / "p"), model="llama_tiny",
                               model_kwargs=KW, params=sd,
                               batch_buckets=(2,))
    model = load_model(plain, device="cpu")
    model.load()
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    np.testing.assert_allclose(model.predict([ids])[0],
                               jmodel.predict([ids])[0], atol=2e-4,
                               rtol=2e-4)
