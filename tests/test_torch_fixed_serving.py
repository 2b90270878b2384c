"""Fixed-forward serving on the port (serve/batcher.py, serve/model.py's
TorchModel, serve/explain.py, the registry runtime and the :predict,
/infer and :explain routes) against the JAX twins on the CPU: the JAX
batcher, JAXModel, explainers and tornado server on the same inputs and
weights. The JAX tests' own cases (tests/test_serve.py,
tests/test_batcher_tail.py, tests/test_explain.py) are repeated on the
port. Outputs are fp32 here: predictions and attributions agree within
1e-5 relative (IG's sum runs in another order: its attributions within
1e-4 absolute, its completeness gap within 1e-3 of JAX's)."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serve import JAXModel
from kubeflow_tpu.serve import ModelServer as JaxServer
from kubeflow_tpu.serve import explain as jex
from kubeflow_tpu.serve import runtimes as jrt
from kubeflow_tpu.serve.model import Model as JaxModelBase
from kubeflow_tpu_torch.models import mlp as tm
from kubeflow_tpu_torch.models.convert import mlp_params_from_jax
from kubeflow_tpu_torch.serve import explain as tex
from kubeflow_tpu_torch.serve.batcher import Batcher
from kubeflow_tpu_torch.serve.model import Model, TorchModel
from kubeflow_tpu_torch.serve.runtimes import export_for_serving, load_model
from kubeflow_tpu_torch.serve.server import ModelServer
from kubeflow_tpu_torch.utils import faults
from kubeflow_tpu_torch.utils.resilience import Deadline, DeadlineExceeded

RTOL = 1e-5
MLP_KW = {"in_dim": 8, "hidden": [16], "num_classes": 3}


def _http(method, url, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, method=method, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- batcher ------------------------------------------------------------------


def test_batcher_coalesces_concurrent_requests():
    calls = []

    def predict(inputs):
        calls.append(inputs[0].shape[0])
        return [inputs[0] + 1]

    b = Batcher(predict, max_batch_size=64, max_latency_ms=30.0)
    futs, threads = [], []

    def submit(i):
        futs.append((i, b.submit([np.full((2, 3), i, np.float32)])))

    for i in range(8):
        t = threading.Thread(target=submit, args=(i,))
        threads.append(t)
        t.start()
    for t in threads:
        t.join(timeout=10)
    for i, f in futs:
        out = f.result(timeout=10)[0]
        assert out.shape == (2, 3) and np.all(out == i + 1)
    assert sum(calls) == 16
    assert len(calls) < 8  # at least some coalescing happened
    assert b.stats["examples"] == 16 and b.stats["items"] == 8
    b.close()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit([np.zeros((1, 3))])


def test_batcher_propagates_errors():
    def predict(inputs):
        raise ValueError("boom")

    b = Batcher(predict, max_batch_size=4, max_latency_ms=1.0)
    with pytest.raises(ValueError, match="boom"):
        b.predict([np.zeros((1, 2))])
    with pytest.raises(ValueError, match="boom"):  # oversized: caller thread
        b.predict([np.zeros((5, 2))])
    b.close()


def test_batcher_isolates_incompatible_shapes():
    def predict(inputs):
        if inputs[0].shape[1] != 3:
            raise ValueError("bad shape reached the model")
        return [inputs[0] * 2]

    b = Batcher(predict, max_batch_size=64, max_latency_ms=20.0)
    good1 = b.submit([np.ones((1, 3), np.float32)])
    bad = b.submit([np.ones((1, 5), np.float32)])
    good2 = b.submit([np.ones((2, 3), np.float32)])
    assert good1.result(10)[0].shape == (1, 3)
    assert good2.result(10)[0].shape == (2, 3)
    with pytest.raises(ValueError):
        bad.result(10)
    b.close()


def test_expired_items_take_no_rows_and_cancelled_callers_are_tolerated():
    rows = []
    release = threading.Event()

    def predict(inputs):
        rows.append(inputs[0].shape[0])
        if len(rows) == 1:
            release.wait(10.0)
        return [inputs[0]]

    b = Batcher(predict, max_batch_size=8, max_latency_ms=1.0)
    x = np.zeros((1, 2), np.float32)
    try:
        head = b.submit([x])
        while not rows:
            time.sleep(0.001)
        expired = b.submit([x], deadline=Deadline(0.01))
        cancelled = b.submit([x])
        live = b.submit([x])
        assert cancelled.cancel()
        time.sleep(0.05)  # the deadline passes while the head runs
        release.set()
        assert live.result(10)[0].shape == (1, 2)
        head.result(10)
        with pytest.raises(DeadlineExceeded):
            expired.result(10)
        assert rows == [1, 1]  # only `live` rode the second call
        gone = b.submit([x], deadline=Deadline(-1.0))  # expired at submit
        with pytest.raises(DeadlineExceeded):
            gone.result(1)
    finally:
        release.set()
        b.close()


def test_batcher_fault_point():
    b = Batcher(lambda inputs: [inputs[0]], max_batch_size=4,
                max_latency_ms=1.0)
    try:
        with faults.harness(seed=1) as h:
            h.arm("serve.predict", faults.FailN(1, match={"batch": 2}))
            with pytest.raises(faults.FaultError):
                b.predict([np.zeros((2, 2))])
            assert b.predict([np.zeros((2, 2))])[0].shape == (2, 2)
        assert h.counts["serve.predict"]["injected"] == 1
    finally:
        b.close()


def test_waiters_during_inflight_batch_flush_without_fresh_window():
    """tests/test_batcher_tail.py's mechanism check on the port: two
    requests that outwait the 400 ms window behind an executing batch go
    out as one immediate batch."""
    calls = []
    release = threading.Event()
    first_running = threading.Event()

    def predict(inputs):
        calls.append(inputs[0].shape[0])
        if len(calls) == 1:
            first_running.set()
            release.wait(10.0)
        return [inputs[0]]

    b = Batcher(predict, max_batch_size=8, max_latency_ms=400.0)
    x = np.zeros((1, 4), np.float32)
    try:
        f1 = b.submit([x])
        assert first_running.wait(10.0)
        t0 = time.monotonic()
        f2, f3 = b.submit([x]), b.submit([x])
        time.sleep(0.45)
        release.set()
        for f in (f1, f2, f3):
            f.result(timeout=10)
        waited = time.monotonic() - t0
        assert calls == [1, 2], calls
        assert waited < 0.45 + 0.3, waited
    finally:
        b.close()


def test_tail_latency_bound_under_steady_load():
    """tests/test_batcher_tail.py's steady-load bound on the port."""

    def predict(inputs):
        time.sleep(0.15)
        return [inputs[0]]

    b = Batcher(predict, max_batch_size=4, max_latency_ms=120.0)
    lat: list[float] = []
    lock = threading.Lock()

    def client():
        x = np.zeros((1, 4), np.float32)
        t0 = time.monotonic()
        b.submit([x]).result(timeout=30)
        with lock:
            lat.append(time.monotonic() - t0)

    try:
        for _ in range(3):
            threads = [threading.Thread(target=client) for _ in range(7)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
    finally:
        b.close()
    assert len(lat) == 21
    arr = np.sort(np.asarray(lat))
    p50 = float(arr[len(arr) // 2])
    p99 = float(arr[min(int(len(arr) * 0.99), len(arr) - 1)])
    assert p99 < 0.38, (p50, p99)
    assert p99 <= 2.5 * p50 + 0.05, (p50, p99)


# -- TorchModel -----------------------------------------------------------------


class _Lin(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, x):
        return x @ self.w


def _pair(buckets, warm, w=None):
    w = np.arange(9, dtype=np.float32).reshape(3, 3) if w is None else w
    jm = JAXModel("lin", lambda p, x: x @ p["w"], {"w": jnp.asarray(w)},
                  input_spec=[((3,), "float32")], batch_buckets=buckets,
                  warm_buckets=warm)
    tmod = TorchModel("lin", lambda m, x: m(x), _Lin(w),
                      input_spec=[((3,), "float32")], batch_buckets=buckets,
                      warm_buckets=warm)
    return jm, tmod


def test_torch_model_buckets_pad_split_and_stats_equal_jax():
    jm, tmod = _pair((4, 2, 2), (2, 3))
    assert tmod.batch_buckets == jm.batch_buckets == [2, 4]
    assert tmod.warm_buckets == jm.warm_buckets == [2]
    for m in (jm, tmod):
        with pytest.raises(RuntimeError, match="not loaded"):
            m.predict([np.zeros((1, 3), np.float32)])
        m.load()
    assert tmod.stats == jm.stats
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 10):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        [want], [got] = jm.predict([x]), tmod.predict([x])
        assert got.shape == want.shape == (n, 3)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    jstats, stats = dict(jm.stats), dict(tmod.stats)
    jstats.pop("predict_s"), stats.pop("predict_s")
    assert stats == jstats == {"requests": 6, "examples": 18,
                               "padded_examples": 2, "compiles": 2}
    spec2 = [((3,), "float32")] * 2
    two = (JAXModel("add", lambda p, x, y: x + y, {}, spec2, (2,), ()),
           TorchModel("add", lambda m, x, y: x + y, _Lin(np.eye(
               3, dtype=np.float32)), spec2, (2,), ()))
    for m in two:
        m.load()
        with pytest.raises(ValueError, match="disagree on batch size"):
            m.predict([np.zeros((2, 3)), np.zeros((3, 3))])
    with pytest.raises(TypeError, match="per-example shape"):
        tmod.predict([np.zeros((2, 4), np.float32)])
    assert tmod.metadata() == dict(jm.metadata(), platform="pytorch-cuda")
    tmod.unload()
    assert not tmod.ready and tmod.load()  # the weights stay
    np.testing.assert_allclose(tmod.predict([x])[0], want, rtol=RTOL)


def test_token_ids_are_checked_on_the_host():
    tmod = TorchModel("ids", lambda m, x: m(x.float()), _Lin(np.eye(
        3, dtype=np.float32)), input_spec=[((3,), "int32")],
        batch_buckets=(2,), warm_buckets=(), vocab_size=10)
    tmod.load()
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        tmod.predict([np.array([[1, 2, 10]])])


# -- registry bundles against the JAX runtime ------------------------------------


def _jax_mlp_bundle(d, seed=7, **extra):
    jrt.export_for_serving(d, model="mnist_mlp", model_kwargs=MLP_KW,
                           batch_buckets=(1, 2, 4), seed=seed, extra=extra)
    jmodel = jrt.load_model(d, name="clf")
    jmodel.load()
    return jmodel


def _port_like(jmodel, d, **extra):
    """A port bundle holding the JAX model's weights."""
    cfg = tm.MLPConfig(**MLP_KW)
    _, params = jmodel.apply_and_params()
    sd = mlp_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    export_for_serving(d, model="mnist_mlp", params=sd,
                       model_kwargs=MLP_KW, batch_buckets=(1, 2, 4),
                       extra=extra)
    model = load_model(d, name="clf", device="cpu")
    model.load()
    return model


def test_export_load_serve_roundtrip_equals_jax(tmp_path):
    jmodel = _jax_mlp_bundle(str(tmp_path / "jax"))
    model = _port_like(jmodel, str(tmp_path / "port"))
    assert isinstance(model, TorchModel)
    assert model.input_spec == jmodel.input_spec == [((8,), "float32")]
    assert model.batch_buckets == jmodel.batch_buckets
    assert model.warm_buckets == jmodel.warm_buckets
    srv = ModelServer()
    srv.repo.register(model)
    port = srv.start_background()
    try:
        x = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
        code, body = _http("POST", f"http://127.0.0.1:{port}/v1/models/"
                           "clf:predict", {"instances": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(body["predictions"],
                                   jmodel.predict([x])[0], rtol=RTOL)
    finally:
        srv.stop()


def test_registry_seed_init_and_refusals(tmp_path):
    d = str(tmp_path / "seeded")
    export_for_serving(d, model="mnist_mlp", model_kwargs=MLP_KW, seed=3)
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_model(d)
    a, b = load_model(d, device="cpu"), load_model(d, device="cpu")
    a.load(), b.load()
    x = np.ones((2, 8), np.float32)
    np.testing.assert_array_equal(a.predict([x])[0], b.predict([x])[0])
    gen = str(tmp_path / "gen")
    export_for_serving(gen, model="llama_tiny", model_kwargs={
        "dtype": "float32", "num_layers": 1},
        extra={"generative": {"max_len": 32},
               "explainer": {"method": "occlusion"}})
    with pytest.raises(ValueError, match="does not support explainers"):
        load_model(gen, device="cpu")
    bad = str(tmp_path / "bad")
    export_for_serving(bad, model="mnist_mlp", model_kwargs=MLP_KW,
                       extra={"explainer": {"method": "anchors"}})
    with pytest.raises(ValueError, match="unknown explainer"):
        load_model(bad, device="cpu")


def test_llama_registry_fixed_forward_equals_the_module(tmp_path):
    d = str(tmp_path / "lm")
    export_for_serving(d, model="llama_tiny", model_kwargs={
        "dtype": "float32", "num_layers": 2}, batch_buckets=(2, 4), seed=5)
    model = load_model(d, device="cpu")
    model.load()
    assert model.input_spec == [((16,), "int32")]
    ids = np.random.default_rng(1).integers(0, 512, (3, 16)).astype(np.int32)
    [got] = model.predict([ids])
    with torch.no_grad():
        want = model.apply_and_params()[1](torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


# -- explainers -------------------------------------------------------------------


class _Count7(torch.nn.Module):
    """Class-1 logit counts occurrences of token 7: occluding a 7 drops
    it by exactly 1 (the JAX test's ground truth)."""

    def forward(self, toks):
        is7 = (toks == 7).float().sum(-1)
        return torch.stack([8.0 - is7, is7], -1)


def _count7():
    m = TorchModel("count7", lambda mod, x: mod(x), _Count7(),
                   input_spec=[((6,), "int32")], batch_buckets=(1, 8),
                   warm_buckets=(1,))
    m.load()
    return m


def test_occlusion_exact_ground_truth_and_jax_equal():
    model = _count7()
    model.attach_explainer(tex.OcclusionExplainer(baseline_id=0))
    toks = np.array([[1, 7, 2, 7, 3, 4]], np.int32)
    [out] = model.explain(toks)
    assert out["target"] == 0
    np.testing.assert_allclose(out["attributions"], [0, -1, 0, -1, 0, 0],
                               atol=1e-5)
    # 7 variants a row through buckets (1, 8): the split and padding path.
    assert model.stats["padded_examples"] >= 1


def test_occlusion_refuses_sequence_heads():
    m = TorchModel("seq", lambda mod, x: torch.zeros(x.shape[0], x.shape[1],
                                                     4),
                   torch.nn.Linear(1, 1), input_spec=[((6,), "int32")],
                   batch_buckets=(8,), warm_buckets=())
    m.load()
    m.attach_explainer(tex.OcclusionExplainer())
    with pytest.raises(ValueError, match="class logits"):
        m.explain(np.zeros((1, 6), np.int32))
    with pytest.raises(ValueError, match=r"integer token batches \[B, S\]"):
        m.explain(np.zeros((1, 6), np.float32))


def _ig_pair(steps=64):
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(8, 16)).astype(np.float32)
    w2 = rng.normal(size=(16, 3)).astype(np.float32)
    jm = JAXModel("mlp", lambda p, x: jnp.tanh(x @ p["w1"]) @ p["w2"],
                  {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
                  input_spec=[((8,), "float32")], batch_buckets=(2,),
                  warm_buckets=())

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w1 = torch.nn.Parameter(torch.from_numpy(w1))
            self.w2 = torch.nn.Parameter(torch.from_numpy(w2))

        def forward(self, x):
            return torch.tanh(x @ self.w1) @ self.w2

    tmod = TorchModel("mlp", lambda m, x: m(x), Net(),
                      input_spec=[((8,), "float32")], batch_buckets=(2,),
                      warm_buckets=())
    for m, ex in ((jm, jex), (tmod, tex)):
        m.load()
        m.attach_explainer(ex.IntegratedGradientsExplainer(steps=steps))
    return jm, tmod, rng.normal(size=(2, 8)).astype(np.float32)


def test_integrated_gradients_completeness_and_jax_equal():
    jm, tmod, x = _ig_pair()
    outs, jouts = tmod.explain(x), jm.explain(x)
    for out, jout in zip(outs, jouts):
        span = abs(out["target_logit"] - out["baseline_logit"])
        assert abs(out["completeness_gap"]) <= 0.02 * max(span, 1.0)
        assert np.isclose(sum(out["attributions"]),
                          out["target_logit"] - out["baseline_logit"],
                          atol=0.02 * max(span, 1.0))
        assert out["method"] == jout["method"]
        assert out["target"] == jout["target"]
        for key in ("target_logit", "baseline_logit"):
            assert np.isclose(out[key], jout[key], rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(out["attributions"],
                                   jout["attributions"], atol=1e-4)
        assert abs(out["completeness_gap"] - jout["completeness_gap"]) < 1e-3


def test_build_explainer_dispatch():
    assert isinstance(tex.build_explainer({"method": "occlusion"}),
                      tex.OcclusionExplainer)
    ig = tex.build_explainer({"method": "integrated_gradients", "steps": 8})
    assert isinstance(ig, tex.IntegratedGradientsExplainer) and ig.steps == 8
    with pytest.raises(ValueError) as err:
        tex.build_explainer({"method": "anchors"})
    with pytest.raises(ValueError) as jerr:
        jex.build_explainer({"method": "anchors"})
    assert str(err.value) == str(jerr.value)


# -- the routes against the JAX server ------------------------------------------


class _Slow(Model):
    """Sleeps, then doubles (the port's); its JAX twin below."""

    def predict(self, inputs):
        time.sleep(0.3)
        return [np.asarray(inputs[0]) * 2]


class _JaxSlow(JaxModelBase):
    def predict(self, inputs):
        time.sleep(0.3)
        return [np.asarray(inputs[0]) * 2]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The same IG-explained MLP bundle on the JAX server and the port's,
    plus a slow model on each."""
    tmp = tmp_path_factory.mktemp("fixed")
    ex = {"explainer": {"method": "integrated_gradients", "steps": 16}}
    jmodel = _jax_mlp_bundle(str(tmp / "jax"), **ex)
    model = _port_like(jmodel, str(tmp / "port"), **ex)
    jsrv, srv = JaxServer(), ModelServer()
    jsrv.repo.register(jmodel)
    jsrv.repo.register(_JaxSlow("slow"))
    srv.repo.register(model)
    srv.repo.register(_Slow("slow"))
    bases = [f"http://127.0.0.1:{s.start_background()}" for s in (jsrv, srv)]
    yield bases, (jsrv, srv), (jmodel, model)
    jsrv.stop()
    srv.stop()


def _both(servers, method, path, body=None, headers=None):
    (jbase, base), _, _ = servers
    return (_http(method, jbase + path, body, headers),
            _http(method, base + path, body, headers))


def _close(got, want):
    """JSON bodies equal, floats within RTOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float):
        assert np.isclose(got, want, rtol=RTOL, atol=1e-6), (got, want)
    else:
        assert got == want


def test_predict_infer_and_metadata_equal_jax(servers):
    x = np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32)
    (jc, jb), (c, b) = _both(servers, "POST", "/v1/models/clf:predict",
                             {"instances": x.tolist()})
    assert c == jc == 200
    _close(b, jb)
    v2 = {"id": "r1", "inputs": [{"name": "input_0", "shape": [3, 8],
                                  "datatype": "FP32",
                                  "data": x.ravel().tolist()}]}
    (jc, jb), (c, b) = _both(servers, "POST", "/v2/models/clf/infer", v2)
    assert c == jc == 200
    _close(b, jb)
    assert list(b) == list(jb) and list(b["outputs"][0]) == list(
        jb["outputs"][0])
    np.testing.assert_allclose(np.reshape(b["outputs"][0]["data"], (3, 3)),
                               _http("POST", servers[0][1]
                                     + "/v1/models/clf:predict",
                                     {"instances": x.tolist()})[1]
                               ["predictions"], rtol=RTOL)
    (jc, jb), (c, b) = _both(servers, "GET", "/v2/models/clf")
    assert c == jc == 200 and b == dict(jb, platform="pytorch-cuda")


@pytest.mark.parametrize("path,body,same_msg", [
    ("/v1/models/clf:predict", {"inputs": []}, True),
    ("/v2/models/clf/infer", {"instances": [[0.0] * 8]}, True),
    ("/v1/models/clf:explain", {}, True),
    ("/v1/models/nope:predict", {"instances": [[1.0]]}, True),
    # JAX's 400 carries XLA's TypeError text, the port's its own.
    ("/v1/models/clf:explain", {"instances": [[0.0] * 5]}, False),
], ids=["predict-400", "infer-400", "explain-400", "predict-404",
        "explain-shape-400"])
def test_error_statuses_equal_jax(servers, path, body, same_msg):
    (jc, jb), (c, b) = _both(servers, "POST", path, body)
    assert c == jc, (b, jb)
    if same_msg:
        assert b == jb


def test_explain_equals_jax_and_501_without_explainer(servers):
    x = np.random.default_rng(3).normal(size=(2, 8)).astype(np.float32)
    (jc, jb), (c, b) = _both(servers, "POST", "/v1/models/clf:explain",
                             {"instances": x.tolist()})
    assert c == jc == 200
    for out, jout in zip(b["explanations"], jb["explanations"]):
        assert out["target"] == jout["target"]
        np.testing.assert_allclose(out["attributions"],
                                   jout["attributions"], atol=1e-4)
    (jc, jb), (c, b) = _both(servers, "POST", "/v1/models/slow:explain",
                             {"instances": [[1.0]]})
    assert c == jc == 501 and b == jb


def test_deadline_gives_504_as_jax(servers):
    hdr = {"X-Request-Timeout-Ms": "50"}
    (jc, jb), (c, b) = _both(servers, "POST", "/v1/models/slow:predict",
                             {"instances": [[1.0]]}, hdr)
    assert c == jc == 504 and b == jb
    (jc, jb), (c, b) = _both(servers, "POST", "/v2/models/slow/infer", {
        "inputs": [{"name": "x", "shape": [1, 1], "datatype": "FP32",
                    "data": [1.0]}]}, hdr)
    assert c == jc == 504 and b == jb
    time.sleep(0.4)  # let the expired calls end: their slots ride them
    _, (jsrv, srv), _ = servers
    assert srv.admission.inflight == 0


def test_metrics_rows_equal_jax(servers):
    def rows(text):
        return {ln.split(" ")[0] for ln in text.splitlines()
                if ln.startswith("tpk_serve_") and 'model="clf"' in ln}

    (jbase, base), _, _ = servers
    for b in (jbase, base):
        _http("POST", b + "/v1/models/clf:predict",
              {"instances": [[0.5] * 8]})
    texts = [urllib.request.urlopen(b + "/metrics", timeout=10).read()
             .decode() for b in (jbase, base)]
    assert rows(texts[1]) == rows(texts[0]) != set()


def test_version_swap_closes_the_old_batcher(tmp_path):
    d = str(tmp_path / "v")
    export_for_serving(d, model="mnist_mlp", model_kwargs=MLP_KW, seed=1)
    srv = ModelServer()
    try:
        srv.load(d, name="m", device="cpu")
        old = srv.repo.batcher("m")
        srv.load(d, name="m")
        new = srv.repo.batcher("m")
        assert new is not old and old._closed
        assert not old._thread.is_alive()
        x = np.zeros((1, 8), np.float32)
        assert new.predict([x])[0].shape == (1, 3)
    finally:
        srv.stop()


def test_generative_model_predict_is_full_forward_logits_as_jax(tmp_path):
    """:predict on a generative bundle: fp32 full-forward logits, no
    cache, equal to GenerativeJAXModel.predict on the same weights, over
    HTTP through the model's batcher."""
    from kubeflow_tpu.serve.generation import GenerativeJAXModel
    from kubeflow_tpu_torch.models.convert import llama_params_from_jax
    from kubeflow_tpu_torch.utils.registry import model_config

    import flax.linen as fnn

    from kubeflow_tpu.utils import registry as jreg

    kw = {"dtype": "float32", "num_layers": 2}
    jmodule, info = jreg.build_model("llama_tiny", **kw)
    params = fnn.meta.unbox(jmodule.init(
        jax.random.key(4), np.zeros((1, 8), np.int32))["params"])
    jgen = GenerativeJAXModel("g", jmodule, params, info["config"],
                              generation={"max_len": 32})
    sd = llama_params_from_jax(jax.tree.map(np.asarray, params),
                               model_config("llama_tiny", **kw))
    d = export_for_serving(str(tmp_path / "p"), model="llama_tiny",
                           model_kwargs=kw, params=sd,
                           extra={"generative": {"max_len": 32,
                                                 "prefill_buckets": [8]}})
    srv = ModelServer()
    try:
        model = srv.load(d, name="g", device="cpu")
        base = f"http://127.0.0.1:{srv.start_background()}"
        ids = np.random.default_rng(5).integers(0, 512, (2, 8))
        code, body = _http("POST", base + "/v1/models/g:predict",
                           {"instances": ids.tolist()})
        assert code == 200
        want = jgen.predict([ids])[0]
        np.testing.assert_allclose(body["predictions"], want, atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(model.predict([ids])[0], want,
                                   atol=2e-4, rtol=2e-4)
        with pytest.raises(ValueError, match=r"\[0, 512\)"):
            model.predict([np.full((1, 4), 512)])
    finally:
        srv.stop()


def test_listen_backlog_holds_a_burst_of_connections():
    """A burst of concurrent clients fits the listen queue while the
    server is busy accepting: with socketserver's backlog of 5 the 7th
    handshake is dropped and its client retries a second later (a 16-row
    one-request-each burst took ~1 s on the card for that alone)."""
    import socket

    from kubeflow_tpu_torch.serve.server import _HTTPServer

    app = ModelServer()
    srv = _HTTPServer(("127.0.0.1", 0), app)  # nothing accepts
    socks = []
    try:
        for _ in range(20):
            s = socket.socket()
            socks.append(s)
            s.settimeout(0.5)
            s.connect(srv.server_address)
    finally:
        for s in socks:
            s.close()
        srv.server_close()
        app.stop()
