"""The port's v2 gRPC data plane (kubeflow_tpu_torch/serve/grpc_server.py)
beside the JAX package's, over real channels on the CPU.

In one process both packages' protoc gencode registers the same
`open_inference.proto` in protobuf's default pool, so their message
classes may be one and the same; interoperation is therefore shown by
bytes: the two clients put the same bytes on the wire, and the two
servers answer one request with the same bytes. Then: the port's client
against the port's server, JAX's client against the port's server and
the port's client against JAX's server; live/ready/metadata; an unknown
model, a bad dtype, the raw all-or-nothing rule and a mis-sized raw
payload; a BF16 raw round trip without ml_dtypes; the shared admission
gate (RESOURCE_EXHAUSTED, readiness), the client deadline
(DEADLINE_EXCEEDED, counted once) and a drain (UNAVAILABLE); the request
id's spans; /tpk.Metrics/Prometheus; and a graph through ModelInfer."""

import json
import threading
import time
import urllib.request

import grpc
import numpy as np
import pytest
import torch

from kubeflow_tpu.serve import Model as JModel
from kubeflow_tpu.serve import ModelServer as JServer
from kubeflow_tpu.serve import grpc_server as jgs
from kubeflow_tpu_torch.serve import grpc_server as tgs
from kubeflow_tpu_torch.serve import open_inference_pb2 as pb
from kubeflow_tpu_torch.serve.graph import GraphModel
from kubeflow_tpu_torch.serve.model import Model as TModel
from kubeflow_tpu_torch.serve.server import AdmissionController, ModelServer
from kubeflow_tpu_torch.utils import faults, obs, resilience

MODEL_INFER = "/inference.GRPCInferenceService/ModelInfer"


class _PortEcho(TModel):
    def predict(self, inputs):
        return [np.asarray(inputs[0]) * 2]


class _JaxEcho(JModel):
    def predict(self, inputs):
        return [np.asarray(inputs[0]) * 2]


class _PortNeg(TModel):
    def predict(self, inputs):
        return [-np.asarray(inputs[0])]


class _PortBf16(TModel):
    """Returns its input as a torch bfloat16 tensor."""

    def predict(self, inputs):
        return [torch.from_numpy(np.asarray(inputs[0])).to(torch.bfloat16)]


@pytest.fixture(scope="module")
def servers():
    """{"jax": (http base, server, grpc port), "port": ...}: "echo" (x * 2)
    on both; on the port also "bf16", "neg" and a graph "g" switching
    between "echo" and "neg"."""
    jsrv = JServer()
    jsrv.repo.register(_JaxEcho("echo"))
    tsrv = ModelServer(admission=AdmissionController(max_inflight=1,
                                                     retry_after_s=2.0))
    tsrv.repo.register(_PortEcho("echo"))
    tsrv.repo.register(_PortBf16("bf16"))
    tsrv.repo.register(_PortNeg("neg"))
    tsrv.repo.register(GraphModel("g", {"root": "s", "nodes": {"s": {
        "type": "switch", "field": "mode", "cases": {"x": {"model": "echo"}},
        "default": {"model": "neg"}}}}, tsrv.repo))
    out = {}
    for side, srv in (("jax", jsrv), ("port", tsrv)):
        base = f"http://127.0.0.1:{srv.start_background(0)}"
        out[side] = (base, srv, srv.start_grpc(0))
    yield out
    jsrv.stop()
    tsrv.stop()


def _client(mod, port):
    return mod.InferenceClient(f"127.0.0.1:{port}")


X = np.asarray([[1.0, 2.0], [3.0, -4.5]], np.float32)


@pytest.mark.parametrize("client_mod,server_side", [
    (tgs, "port"), (jgs, "port"), (tgs, "jax")],
    ids=["port-port", "jax-port", "port-jax"])
def test_live_ready_metadata_infer_across_packages(servers, client_mod,
                                                   server_side):
    base, srv, port = servers[server_side]
    client = _client(client_mod, port)
    try:
        assert client.server_live() and client.server_ready()
        assert client.model_ready("echo")
        assert client.model_metadata("echo").name == "echo"
        for raw in (False, True):
            (out,) = client.infer("echo", [X], raw=raw)
            np.testing.assert_array_equal(out, X * 2)
            assert out.dtype == np.float32
        (ints,) = client.infer("echo", [np.arange(6, dtype=np.int64)
                                        .reshape(2, 3)])
        np.testing.assert_array_equal(ints, np.arange(6).reshape(2, 3) * 2)
        # gRPC and HTTP reach the same model: the HTTP counters advance.
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert 'tpk_serve_requests_total{model="echo"}' in \
                r.read().decode()
    finally:
        client.close()


class _Capture:
    """A gRPC server whose ModelInfer records the raw request bytes and
    answers empty."""

    def __init__(self):
        from concurrent import futures

        self.seen = []
        handler = grpc.method_handlers_generic_handler(
            "inference.GRPCInferenceService", {
                "ModelInfer": grpc.unary_unary_rpc_method_handler(
                    self._infer, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)})
        self.server = grpc.server(futures.ThreadPoolExecutor(2))
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def _infer(self, raw, context):
        self.seen.append(raw)
        return b""


def test_clients_put_the_same_bytes_on_the_wire():
    cap = _Capture()
    arrays = [X, np.arange(4, dtype=np.int32).reshape(1, 4),
              np.asarray([True, False])]
    try:
        for mod in (jgs, tgs):
            for raw in (False, True):
                c = _client(mod, cap.port)
                c.infer("m", arrays, raw=raw, request_id="rid-1")
                c.close()
    finally:
        cap.server.stop(0)
    jax_typed, jax_raw, port_typed, port_raw = cap.seen
    assert port_typed == jax_typed and port_raw == jax_raw
    assert jax_typed != jax_raw


def test_servers_answer_the_same_bytes(servers):
    req = pb.ModelInferRequest(model_name="echo", id="q7")
    t = req.inputs.add(name="x", datatype="FP32", shape=[2, 2])
    t.contents.fp32_contents.extend(X.ravel().tolist())
    answers = []
    for side in ("jax", "port"):
        ch = grpc.insecure_channel(f"127.0.0.1:{servers[side][2]}")
        rpc = ch.unary_unary(MODEL_INFER,
                             request_serializer=lambda b: b,
                             response_deserializer=lambda b: b)
        answers.append(rpc(req.SerializeToString()))
        ch.close()
    assert answers[1] == answers[0]
    resp = pb.ModelInferResponse.FromString(answers[1])
    assert resp.id == "q7" and resp.outputs[0].datatype == "FP32"


def test_unknown_model_bad_dtype_and_raw_rules(servers):
    _, _, port = servers["port"]
    client = _client(tgs, port)
    try:
        with pytest.raises(grpc.RpcError) as e:
            client.infer("nope", [X])
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
        with pytest.raises(grpc.RpcError) as e:
            client.model_metadata("nope")
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
        cases = []
        req = pb.ModelInferRequest(model_name="echo")
        req.inputs.add(name="x", datatype="COMPLEX64", shape=[1])
        cases.append(req)
        req = pb.ModelInferRequest(model_name="echo")
        req.inputs.add(name="x", datatype="FP32", shape=[2, 2])
        req.raw_input_contents.append(b"\x00" * 4)  # 1 float, shape says 4
        cases.append(req)
        req = pb.ModelInferRequest(model_name="echo")
        req.inputs.add(name="a", datatype="FP32", shape=[1])
        req.inputs.add(name="b", datatype="FP32", shape=[1])
        req.raw_input_contents.append(b"\x00" * 4)  # one raw for two inputs
        cases.append(req)
        req = pb.ModelInferRequest(model_name="echo")
        req.inputs.add(name="x", datatype="BF16", shape=[1])  # typed BF16
        cases.append(req)
        for req in cases:
            with pytest.raises(grpc.RpcError) as e:
                client._call("ModelInfer", req, pb.ModelInferResponse)
            assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT, req
    finally:
        client.close()


def test_bf16_raw_round_trip_without_ml_dtypes(servers):
    """A torch bfloat16 tensor goes out as BF16 raw bytes (the bytes
    ml_dtypes would give), comes back from a model returning bfloat16 as
    BF16, and decodes to fp32 holding the same values."""
    import ml_dtypes  # the JAX stack's bf16, for the reference bytes only

    vals = torch.tensor([[1.5, -2.25, 3.0e-3], [65504.0, -0.0, 7.0]],
                        dtype=torch.bfloat16)
    dt, shape, raw = tgs._encode(vals)
    assert (dt, shape) == ("BF16", [2, 3])
    assert raw == vals.float().numpy().astype(ml_dtypes.bfloat16).tobytes()
    _, _, port = servers["port"]
    client = _client(tgs, port)
    try:
        (out,) = client.infer("bf16", [vals], request_id="bf16-rt")
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, vals.float().numpy())
        resp = client._call("ModelInfer", _bf16_request(raw),
                            pb.ModelInferResponse)
        assert resp.outputs[0].datatype == "BF16"
        assert resp.raw_output_contents[0] == raw
    finally:
        client.close()


def _bf16_request(raw):
    req = pb.ModelInferRequest(model_name="bf16")
    req.inputs.add(name="x", datatype="BF16", shape=[2, 3])
    req.raw_input_contents.append(raw)
    return req


def test_request_id_spans_and_trailing_metadata(servers):
    _, _, port = servers["port"]
    obs.get_tracer().clear()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    rpc = ch.unary_unary(MODEL_INFER,
                         request_serializer=lambda m: m.SerializeToString(),
                         response_deserializer=pb.ModelInferResponse.FromString)
    req = pb.ModelInferRequest(model_name="echo")
    req.inputs.add(name="x", datatype="FP32", shape=[1, 2]) \
        .contents.fp32_contents.extend([1.0, 2.0])
    _, call = rpc.with_call(req, metadata=(("x-request-id", "grpc-req-7"),))
    ch.close()
    assert ("x-request-id", "grpc-req-7") in tuple(call.trailing_metadata())
    evs = obs.get_tracer().events("grpc-req-7")
    names = [e["name"] for e in evs]
    assert names == ["serve.admit", "serve.batch_gather", "serve.predict"]
    assert evs[0]["attrs"] == {"path": "grpc.ModelInfer", "admitted": True}


def test_metrics_rpc_serves_the_http_scrape(servers):
    base, _, port = servers["port"]
    client = _client(tgs, port)
    try:
        text = client.metrics(timeout=10)
    finally:
        client.close()
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        http = r.read().decode()

    def families(t):
        return {line.split()[2] for line in t.splitlines()
                if line.startswith("# TYPE ")}

    assert families(text) == families(http)
    assert "tpk_serve_requests_total" in families(text)


def test_graph_through_model_infer(servers):
    """A graph takes the parameters as routing fields and runs on the
    worker pool, around the batcher."""
    _, srv, port = servers["port"]
    client = _client(tgs, port)
    try:
        req = pb.ModelInferRequest(model_name="g")
        req.parameters["mode"].string_param = "x"
        req.inputs.add(name="x", datatype="FP32", shape=[2, 2])
        req.raw_input_contents.append(X.tobytes())
        resp = client._call("ModelInfer", req, pb.ModelInferResponse)
        out = tgs.tensor_to_numpy(resp.outputs[0], resp.raw_output_contents[0])
        np.testing.assert_array_equal(out, X * 2)
        del req.parameters["mode"]
        resp = client._call("ModelInfer", req, pb.ModelInferResponse)
        out = tgs.tensor_to_numpy(resp.outputs[0], resp.raw_output_contents[0])
        np.testing.assert_array_equal(out, -X)  # the default case
    finally:
        client.close()
    assert srv.repo.batcher("g").stats["items"] == 0


def test_shed_deadline_and_drain_statuses(servers):
    """The port server's gate holds one request: a second is shed with
    RESOURCE_EXHAUSTED while ServerReady degrades; a client deadline
    shorter than the work answers DEADLINE_EXCEEDED, counted once, and the
    slot rides the work to its end; a drain answers UNAVAILABLE."""
    base, srv, port = servers["port"]
    client = _client(tgs, port)
    x = np.asarray([[1.0, 2.0]], np.float32)
    try:
        resilience.metrics.reset()
        with faults.harness() as h:
            h.arm("serve.predict", faults.Latency(1.0))
            req = urllib.request.Request(
                f"{base}/v1/models/echo:predict", method="POST",
                data=json.dumps({"instances": [[1, 2]]}).encode())
            t = threading.Thread(target=lambda: urllib.request.urlopen(
                req, timeout=30).read())
            t.start()
            t0 = time.monotonic()
            while srv.admission.inflight < 1 and time.monotonic() - t0 < 5:
                time.sleep(0.01)
            with pytest.raises(grpc.RpcError) as e:
                client.infer("echo", [x])
            assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            assert client.server_ready() is False
            t.join(timeout=10)
        assert resilience.metrics.get("tpk_shed_total",
                                      component="serve_grpc") == 1
        with faults.harness() as h:
            h.arm("serve.predict", faults.Latency(0.5))
            with pytest.raises(grpc.RpcError) as e:
                client.infer("echo", [x], timeout=0.05)
            assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED

            def expiries():
                return resilience.metrics.get("tpk_deadline_expired_total",
                                              component="serve_grpc")
            t0 = time.monotonic()
            while expiries() < 1 and time.monotonic() - t0 < 5:
                time.sleep(0.05)
            assert expiries() == 1
        t0 = time.monotonic()
        while srv.admission.inflight > 0 and time.monotonic() - t0 < 5:
            time.sleep(0.02)
        assert srv.admission.inflight == 0
        srv.begin_drain()
        try:
            with pytest.raises(grpc.RpcError) as e:
                client.infer("echo", [x])
            assert e.value.code() == grpc.StatusCode.UNAVAILABLE
            assert "draining" in e.value.details()
            assert client.server_ready() is False
        finally:
            srv.end_drain()
        time.sleep(2.1)  # the shed's readiness window
        np.testing.assert_array_equal(client.infer("echo", [x])[0], x * 2)
        assert client.server_ready() is True
    finally:
        client.close()


def test_start_grpc_names_the_missing_package(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc":
            raise ImportError("No module named 'grpc'")
        return real(name, *a, **kw)

    srv = ModelServer()
    monkeypatch.setattr(builtins, "__import__", no_grpc)
    with pytest.raises(RuntimeError, match="grpcio"):
        srv.start_grpc(0)
    monkeypatch.undo()
    assert srv.grpc_port is None
    srv.stop()
