"""The port's InferenceGraphs (kubeflow_tpu_torch/serve/graph.py) beside the
JAX package's: the ten cases of tests/test_serve_graph.py on both
executors (sequence, switch with and without a default, the three
ensemble merges, splitter validation and weights, nesting, validation
errors, the recursion guards, a graph served over HTTP), the splitter's
picks equal to JAX's GraphExecutor under one seed, and graph predictions
through :predict and /infer equal to the JAX server's, with the graph
bypassing the batcher."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeflow_tpu.serve import Model as JModel
from kubeflow_tpu.serve import ModelServer as JServer
from kubeflow_tpu.serve import graph as jgraph
from kubeflow_tpu_torch.serve import graph as tgraph
from kubeflow_tpu_torch.serve.model import Model as TModel
from kubeflow_tpu_torch.serve.server import ModelServer as TServer

GRAPHS = pytest.mark.parametrize("g", [jgraph, tgraph], ids=["jax", "port"])


def _registry_predict(registry):
    def predict(name, payload):
        return registry[name](payload)
    return predict


@GRAPHS
def test_sequence_chains_outputs(g):
    fns = {"a": lambda p: p + "a", "b": lambda p: p + "b"}
    ex = g.GraphExecutor(
        {"root": "seq",
         "nodes": {"seq": {"type": "sequence",
                           "steps": [{"model": "a"}, {"model": "b"}]}}},
        _registry_predict(fns))
    assert ex("x") == "xab"


@GRAPHS
def test_switch_routes_by_field_with_default(g):
    fns = {"en": lambda p: "english", "xx": lambda p: "fallback"}
    ex = g.GraphExecutor(
        {"root": "sw",
         "nodes": {"sw": {"type": "switch", "field": "lang",
                          "cases": {"en": {"model": "en"}},
                          "default": {"model": "xx"}}}},
        _registry_predict(fns))
    assert ex({"lang": "en"}) == "english"
    assert ex({"lang": "fr"}) == ex({}) == "fallback"
    ex2 = g.GraphExecutor(
        {"root": "sw",
         "nodes": {"sw": {"type": "switch", "field": "lang",
                          "cases": {"en": {"model": "en"}}}}},
        _registry_predict(fns))
    with pytest.raises(g.GraphError, match="no case"):
        ex2({"lang": "fr"})


@GRAPHS
def test_ensemble_merges(g):
    fns = {"m1": lambda p: [np.array([2.0, 4.0])],
           "m2": lambda p: [np.array([4.0, 8.0])]}
    spec = {"root": "e",
            "nodes": {"e": {"type": "ensemble",
                            "members": [{"model": "m1"}, {"model": "m2"}],
                            "merge": "average"}}}
    np.testing.assert_allclose(
        g.GraphExecutor(spec, _registry_predict(fns))(None)[0], [3.0, 6.0])
    spec["nodes"]["e"]["merge"] = "concat"
    np.testing.assert_allclose(
        g.GraphExecutor(spec, _registry_predict(fns))(None)[0],
        [2.0, 4.0, 4.0, 8.0])
    spec["nodes"]["e"]["merge"] = "all"
    assert g.GraphExecutor(spec, _registry_predict(fns))(None) == [
        [2.0, 4.0], [4.0, 8.0]]
    spec["nodes"]["e"]["merge"] = "median"
    with pytest.raises(g.GraphError, match="merge"):
        g.GraphExecutor(spec, _registry_predict(fns))(None)


@GRAPHS
def test_splitter_weight_validation(g):
    for targets, weights in (([{"model": "a"}, {"model": "b"}], [0, 0]),
                             ([{"model": "a"}], [-1]),
                             ([{"model": "a"}], [1, 2])):
        with pytest.raises(g.GraphError, match="weights"):
            g.GraphExecutor(
                {"root": "s",
                 "nodes": {"s": {"type": "splitter", "targets": targets,
                                 "weights": weights}}}, lambda n, p: p)


@GRAPHS
def test_splitter_respects_weights(g):
    hits = {"v1": 0, "v2": 0}

    def mk(name):
        def fn(p):
            hits[name] += 1
            return name
        return fn

    ex = g.GraphExecutor(
        {"root": "s",
         "nodes": {"s": {"type": "splitter",
                         "targets": [{"model": "v1"}, {"model": "v2"}],
                         "weights": [0.9, 0.1]}}},
        _registry_predict({"v1": mk("v1"), "v2": mk("v2")}), seed=0)
    for _ in range(300):
        ex(None)
    assert hits["v1"] > 200 and hits["v2"] > 5


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_splitter_picks_equal_jax(seed):
    """One spec and seed: the same targets in the same order."""
    spec = {"root": "s",
            "nodes": {"s": {"type": "splitter",
                            "targets": [{"model": "a"}, {"model": "b"},
                                        {"node": "n"}],
                            "weights": [0.5, 0.3, 0.2]},
                      "n": {"type": "sequence",
                            "steps": [{"model": "c"}]}}}
    picks = {}
    for side, g in (("jax", jgraph), ("port", tgraph)):
        ex = g.GraphExecutor(spec, lambda name, p: name, seed=seed)
        picks[side] = [ex(None) for _ in range(200)]
    assert picks["port"] == picks["jax"]
    assert set(picks["port"]) == {"a", "b", "c"}


@GRAPHS
def test_nested_nodes_and_validation(g):
    fns = {"a": lambda p: p + 1, "b": lambda p: p * 10}
    ex = g.GraphExecutor(
        {"root": "outer",
         "nodes": {"outer": {"type": "sequence",
                             "steps": [{"model": "a"}, {"node": "inner"}]},
                   "inner": {"type": "sequence",
                             "steps": [{"model": "b"}]}}},
        _registry_predict(fns))
    assert ex(1) == 20
    for spec, match in (
            ({"root": "nope", "nodes": {}}, "root"),
            ({"root": "s", "nodes": {"s": {"type": "sequence",
                                           "steps": [{"node": "ghost"}]}}},
             "unknown node"),
            ({"root": "s", "nodes": {"s": {"type": "wat"}}}, "unknown type"),
            ({"root": "s", "nodes": {"s": {"type": "sequence",
                                           "steps": [{"x": 1}]}}},
             "target needs"),
            ({"root": "s", "nodes": {"s": {"type": "switch"}}}, "field"),
            ({"root": "s", "nodes": {"s": {"type": "ensemble"}}},
             "members")):
        with pytest.raises(g.GraphError, match=match):
            g.GraphExecutor(spec, lambda n, p: p)
    ex = g.GraphExecutor(
        {"root": "a",
         "nodes": {"a": {"type": "sequence", "steps": [{"node": "a"}]}}},
        lambda n, p: p)
    with pytest.raises(g.GraphError, match="depth"):
        ex(None)


def _models(g):
    """Doubler and AddOne for the package `g` belongs to."""
    base = JModel if g is jgraph else TModel

    class Doubler(base):
        def predict(self, inputs):
            return [np.asarray(inputs[0]) * 2]

    class AddOne(base):
        def predict(self, inputs):
            return [np.asarray(inputs[0]) + 1]

    return Doubler, AddOne


@GRAPHS
def test_mutual_recursion_capped_and_self_reference_rejected(g):
    srv = JServer() if g is jgraph else TServer()
    a = g.GraphModel("ga", {"root": "s", "nodes": {
        "s": {"type": "sequence", "steps": [{"model": "gb"}]}}}, srv.repo)
    b = g.GraphModel("gb", {"root": "s", "nodes": {
        "s": {"type": "sequence", "steps": [{"model": "ga"}]}}}, srv.repo)
    srv.repo.register(a)
    srv.repo.register(b)
    with pytest.raises(g.GraphError, match="depth"):
        a.predict({"instances": [[1.0]]})
    loop = g.GraphModel("loop", {"root": "s", "nodes": {
        "s": {"type": "sequence", "steps": [{"model": "loop"}]}}}, srv.repo)
    with pytest.raises(g.GraphError, match="itself"):
        loop.predict([np.array([1.0])])
    srv.stop()


SPECS = {
    "pipeline": {"root": "seq", "nodes": {"seq": {
        "type": "sequence", "steps": [{"model": "dbl"}, {"model": "inc"}]}}},
    "router": {"root": "sw", "nodes": {"sw": {
        "type": "switch", "field": "mode",
        "cases": {"double": {"model": "dbl"}},
        "default": {"model": "inc"}}}},
    "vote": {"root": "e", "nodes": {"e": {
        "type": "ensemble", "members": [{"model": "dbl"},
                                        {"model": "inc"}],
        "merge": "average"}}},
    "ab": {"root": "s", "nodes": {"s": {
        "type": "splitter", "targets": [{"model": "dbl"}, {"model": "inc"}],
        "weights": [0.5, 0.5]}}},
}


@pytest.fixture(scope="module")
def servers():
    out = {}
    for side, g, srv in (("jax", jgraph, JServer()),
                         ("port", tgraph, TServer())):
        doubler, add_one = _models(g)
        srv.repo.register(doubler("dbl"))
        srv.repo.register(add_one("inc"))
        for name, spec in SPECS.items():
            srv.repo.register(g.GraphModel(name, spec, srv.repo, seed=3))
        port = srv.start_background(0)
        out[side] = (f"http://127.0.0.1:{port}", srv)
    yield out
    for _, srv in out.values():
        srv.stop()


def _post(url, body):
    req = urllib.request.Request(url, method="POST",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


#: (path, body) sent in this order to both servers.
REQUESTS = [
    ("/v1/models/pipeline:predict", {"instances": [[1.0, 2.0]]}),
    ("/v1/models/router:predict", {"instances": [[3.0]], "mode": "double"}),
    ("/v1/models/router:predict", {"instances": [[3.0]], "mode": "other"}),
    ("/v1/models/router:predict", {"instances": [[3.0]]}),
    ("/v1/models/vote:predict", {"instances": [[1.0, 5.0]]}),
    *[("/v1/models/ab:predict", {"instances": [[float(i)]]})
      for i in range(6)],
    ("/v2/models/router/infer", {
        "inputs": [{"name": "x", "shape": [1, 2], "datatype": "FP32",
                    "data": [1.0, 4.0]}],
        "parameters": {"mode": "double"}, "id": "r1"}),
    ("/v2/models/vote/infer", {
        "inputs": [{"name": "x", "shape": [2, 1], "datatype": "FP64",
                    "data": [1.0, 2.0]}]}),
    ("/v1/models/pipeline:predict", {}),
]


def test_graph_predictions_over_http_equal_jax(servers):
    got = {side: [_post(base + path, body) for path, body in REQUESTS]
           for side, (base, _) in servers.items()}
    assert got["port"] == got["jax"]
    codes = [c for c, _ in got["port"]]
    assert codes == [200] * (len(REQUESTS) - 1) + [400]
    assert got["port"][0][1] == {"predictions": [[3.0, 5.0]]}
    assert got["port"][1][1] == {"predictions": [[6.0]]}
    assert got["port"][4][1] == {"predictions": [[2.0, 8.0]]}
    # The graph ran on the worker pool, never through a batcher.
    batchers = servers["port"][1].repo._batchers
    assert all(batchers[n].stats["items"] == 0 for n in SPECS)


def test_graph_metadata_equals_jax(servers):
    docs = []
    for base, _ in servers.values():
        with urllib.request.urlopen(f"{base}/v2/models/vote",
                                    timeout=10) as r:
            docs.append(json.loads(r.read()))
    assert docs[0] == docs[1]
    assert docs[1]["platform"] == "tpk-inference-graph"
