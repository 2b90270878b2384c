"""gRPC data plane: the Open Inference Protocol v2 over grpcio.

The port of `kubeflow_tpu/serve/grpc_server.py`: the gRPC half of the
model server, sharing the HTTP server's ModelRepository, batchers,
admission gate and readiness rule, so both protocols reach one loaded
model. Service stubs are hand-rolled with
`grpc.method_handlers_generic_handler` over the checked-in protoc gencode
(`open_inference_pb2.py`); the wire format is the generated stubs'.
`ModelServer.start_grpc` (and `--grpc-port`) import this module lazily:
the HTTP server runs without grpcio.

Tensor encoding: typed `contents` fields or packed little-endian
`raw_input_contents`, both directions, as the public protocol has them.
Outputs always go raw. BF16 has no typed field and travels raw only; its
bytes are reinterpreted with torch (numpy has no bfloat16 without
ml_dtypes), decoded to fp32 arrays holding the same values, and a torch
bfloat16 tensor is sent as BF16.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import TYPE_CHECKING

import grpc
import numpy as np
import torch

from kubeflow_tpu_torch.serve import open_inference_pb2 as pb
from kubeflow_tpu_torch.serve.model import Model, _v2_dtype, v2_to_numpy_dtype
from kubeflow_tpu_torch.utils import obs
from kubeflow_tpu_torch.utils.resilience import (Deadline, DeadlineExceeded,
                                                 metrics as res_metrics)

if TYPE_CHECKING:  # server.py imports this module lazily
    from kubeflow_tpu_torch.serve.server import ModelServer

SERVICE = "inference.GRPCInferenceService"

# v2 datatype -> InferTensorContents field (the numpy<->v2 names live in
# serve/model.py, shared with REST). FP16/BF16 have no typed contents
# field in the protocol: raw encoding only.
_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents", "INT16": "int_contents",
    "INT32": "int_contents", "INT64": "int64_contents",
    "UINT8": "uint_contents", "UINT16": "uint_contents",
    "UINT32": "uint_contents", "UINT64": "uint64_contents",
    "FP16": None, "BF16": None,
    "FP32": "fp32_contents", "FP64": "fp64_contents",
}


def _bf16_to_numpy(raw: bytes, shape: tuple) -> np.ndarray:
    """Little-endian bfloat16 bytes as an fp32 array of the same values."""
    if len(raw) % 2:
        raise ValueError(f"BF16 raw contents of {len(raw)} bytes")
    t = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
    if t.numel() != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"BF16 raw contents hold {t.numel()} values, "
                         f"shape {list(shape)} needs "
                         f"{int(np.prod(shape, dtype=np.int64))}")
    return t.reshape(shape).float().numpy()


def tensor_to_numpy(tensor, raw: bytes | None) -> np.ndarray:
    """One protocol tensor (with its raw bytes, if the message has them)
    as a numpy array; BF16 comes back as fp32 (see the module doc)."""
    dt = tensor.datatype.upper()
    if dt not in _CONTENTS_FIELD:
        raise ValueError(f"unsupported datatype {tensor.datatype!r}")
    shape = tuple(tensor.shape)
    if dt == "BF16":
        if raw is None or not len(raw):
            raise ValueError("BF16 tensors must use raw_input_contents")
        return _bf16_to_numpy(raw, shape)
    np_dtype = np.dtype(v2_to_numpy_dtype(dt))
    if raw is not None and len(raw):
        return np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    field = _CONTENTS_FIELD[dt]
    if field is None:
        raise ValueError(f"{dt} tensors must use raw_input_contents")
    vals = getattr(tensor.contents, field)
    return np.asarray(list(vals), dtype=np_dtype).reshape(shape)


def _encode(arr) -> tuple[str, list[int], bytes]:
    """(v2 datatype, shape, little-endian bytes) of a numpy array or a
    torch tensor; a dtype outside the protocol (e.g. complex) ships as
    FP32 rather than mislabeled bytes."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", list(t.shape), t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    arr = np.asarray(arr)
    dt = _v2_dtype(str(arr.dtype))
    if v2_to_numpy_dtype(dt) != str(arr.dtype):
        arr = arr.astype(np.float32)
        dt = "FP32"
    return dt, list(arr.shape), np.ascontiguousarray(arr).tobytes()


def numpy_to_tensor(name: str, arr):
    """(InferOutputTensor, raw bytes). Outputs use raw_output_contents:
    one copy instead of per-element typed fields, and FP16/BF16 keep their
    dtype."""
    dt, shape, raw = _encode(arr)
    out = pb.ModelInferResponse.InferOutputTensor(
        name=name, datatype=dt, shape=shape)
    return out, raw


class InferenceServicer:
    """The five open-inference RPCs over a ModelServer's repository."""

    def __init__(self, server: "ModelServer"):
        self.server = server
        self.repo = server.repo

    def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    def ServerReady(self, request, context):
        # The HTTP probe's rule (ModelServer.readiness), so the two
        # surfaces cannot drift.
        return pb.ServerReadyResponse(ready=self.server.readiness()[0])

    def _model(self, name, context):
        try:
            return self.repo.get(name)
        except Exception:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"model {name!r} not found")

    def ModelReady(self, request, context):
        model = self._model(request.name, context)
        return pb.ModelReadyResponse(ready=bool(model.ready))

    def ModelMetadata(self, request, context):
        model = self._model(request.name, context)
        md = model.metadata()
        resp = pb.ModelMetadataResponse(
            name=md.get("name", request.name), versions=["1"],
            platform=md.get("platform", "pytorch-cuda"))
        for t in md.get("inputs", []):
            resp.inputs.add(name=t["name"], datatype=t["datatype"],
                            shape=[int(s) for s in t["shape"]])
        for t in md.get("outputs", []):
            resp.outputs.add(name=t["name"], datatype=t["datatype"],
                             shape=[int(s) for s in t["shape"]])
        return resp

    def Metrics(self, request: bytes, context) -> bytes:
        """Prometheus text over gRPC (`/tpk.Metrics/Prometheus`): the same
        rendering as HTTP /metrics, so a gRPC-only deployment still gets
        the full scrape. Raw bytes through identity (de)serializers: the
        message needs no schema."""
        return self.server.prometheus_text().encode()

    def ModelInfer(self, request, context):
        # Trace identity, shared with the HTTP plane: the caller's
        # x-request-id metadata (or a fresh id), echoed in the trailing
        # metadata and carried by this request's spans.
        rid = next((v for k, v in (context.invocation_metadata() or ())
                    if k.lower() == "x-request-id"), None)
        trace_id = obs.sanitize_trace_id(rid)
        context.set_trailing_metadata((("x-request-id", trace_id),))
        if self.server.draining:
            # The HTTP drain's 503 + DRAINING_HEADER: UNAVAILABLE (not
            # RESOURCE_EXHAUSTED, which is overload) so a router retries
            # on a surviving replica.
            context.abort(grpc.StatusCode.UNAVAILABLE, "replica draining")
        # The HTTP handlers' admission gate: gRPC is no side door around
        # --max-inflight.
        adm = self.server.admission
        with obs.span("serve.admit", trace_id=trace_id,
                      path="grpc.ModelInfer") as sp:
            shed = adm is not None and not adm.try_acquire(
                component="serve_grpc")
            sp.set(admitted=not shed)
        if shed:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                          "server overloaded: admission queue full")
        # An expired request's claimed work may still be running when the
        # abort unwinds: _infer parks its future here and the admission
        # slot is released when that work ends.
        ride: list = []
        try:
            return self._infer(request, context, ride, trace_id)
        finally:
            if adm is not None:
                if ride:
                    ride[0].add_done_callback(lambda _f: adm.release())
                else:
                    adm.release()

    def _infer(self, request, context, ride, trace_id=""):
        name = request.model_name
        model = self._model(name, context)
        if not model.ready:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"model {name!r} not ready")
        nraw = len(request.raw_input_contents)
        if nraw and nraw != len(request.inputs):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "raw_input_contents is all-or-nothing: one entry per input")
        try:
            inputs = []
            for i, tensor in enumerate(request.inputs):
                raw = request.raw_input_contents[i] if nraw else None
                inputs.append(tensor_to_numpy(tensor, raw))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        params = {k: _param_value(v)
                  for k, v in request.parameters.items()}
        # Parity with the HTTP /infer: a custom preprocess sees the same
        # v2-shaped body either way.
        if type(model).preprocess is not Model.preprocess:
            body = model.preprocess({
                "id": request.id, "parameters": params,
                "inputs": [{
                    "name": t.name, "datatype": t.datatype,
                    "shape": list(t.shape), "data": arr,
                } for t, arr in zip(request.inputs, inputs)]})
            inputs = [np.asarray(
                t["data"],
                dtype=v2_to_numpy_dtype(t.get("datatype", "FP32"))
            ).reshape(t["shape"]) for t in body.get("inputs", [])]
            if not inputs:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "preprocess returned no inputs")
        # gRPC's own deadline (client-set) maps onto the shared Deadline
        # clock, as the HTTP timeout header does: an expired request frees
        # its batch row.
        rem = context.time_remaining()
        deadline = Deadline(rem) if rem is not None else None
        fut = None
        t0 = time.monotonic()
        try:
            if getattr(model, "wants_raw_payload", False):
                # Graphs take the whole payload and bypass the batcher, but
                # run bounded on the server's worker pool, as over HTTP.
                payload = dict(params)
                payload["instances"] = inputs[0]
                fut = self.server.executor.submit(model.predict, payload)
                out = fut.result(
                    timeout=deadline.bound(120.0) if deadline else 120)
                outs = [out.get("instances")
                        if isinstance(out, dict) else out]
            else:
                fut = self.repo.batcher(name).submit(
                    inputs, deadline=deadline, trace_id=trace_id)
                outs = fut.result(
                    timeout=deadline.bound(120.0) if deadline else 120)
            outs = model.postprocess(outs)
        except (DeadlineExceeded, futures.TimeoutError) as e:
            # Abandon queued work (a cancel lands only before the claim);
            # running work keeps the admission slot until it ends.
            if fut is not None and not fut.cancel():
                ride.append(fut)
            if (isinstance(e, DeadlineExceeded)
                    or (deadline is not None and deadline.expired())):
                # This surface aborts at most once a request and the inner
                # layers never count: one increment per expiry.
                res_metrics.inc("tpk_deadline_expired_total",
                                component="serve_grpc")
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                              f"request deadline exceeded "
                              f"({type(e).__name__})")
            # A timeout raised by the work with budget left is a server
            # fault, not an expired deadline.
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        except Exception as e:  # surfaced as a gRPC status
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        self.server.observe(name, int(np.asarray(inputs[0]).shape[0]),
                            time.monotonic() - t0)
        resp = pb.ModelInferResponse(model_name=name, id=request.id)
        # Every output raw (one entry per tensor): the protocol's
        # all-or-nothing rule holds by construction.
        for j, arr in enumerate(outs):
            tensor, raw_bytes = numpy_to_tensor(f"output_{j}", arr)
            resp.outputs.append(tensor)
            resp.raw_output_contents.append(raw_bytes)
        return resp


def _param_value(p):
    """InferParameter oneof -> python value."""
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else None


def _unary(fn, req_cls, resp_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn, request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString)


def build_grpc_server(server: "ModelServer", port: int = 0,
                      max_workers: int = 8):
    """Returns (grpc.Server, bound port), serving on 127.0.0.1 with gRPC's
    default message limits (4 MiB received). A failed bind raises."""
    servicer = InferenceServicer(server)
    handlers = grpc.method_handlers_generic_handler(SERVICE, {
        "ServerLive": _unary(servicer.ServerLive, pb.ServerLiveRequest,
                             pb.ServerLiveResponse),
        "ServerReady": _unary(servicer.ServerReady, pb.ServerReadyRequest,
                              pb.ServerReadyResponse),
        "ModelReady": _unary(servicer.ModelReady, pb.ModelReadyRequest,
                             pb.ModelReadyResponse),
        "ModelMetadata": _unary(servicer.ModelMetadata,
                                pb.ModelMetadataRequest,
                                pb.ModelMetadataResponse),
        "ModelInfer": _unary(servicer.ModelInfer, pb.ModelInferRequest,
                             pb.ModelInferResponse),
    })
    metrics_handlers = grpc.method_handlers_generic_handler(
        "tpk.Metrics", {
            "Prometheus": grpc.unary_unary_rpc_method_handler(
                servicer.Metrics,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b),
        })
    gserver = grpc.server(futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix="tpk-grpc"))
    gserver.add_generic_rpc_handlers((handlers, metrics_handlers))
    bound = gserver.add_insecure_port(f"127.0.0.1:{port}")
    if bound == 0:
        # Advertising a dead port would leave the replica ready over HTTP
        # while gRPC clients are refused forever.
        raise RuntimeError(f"cannot bind gRPC port {port}")
    return gserver, bound


class InferenceClient:
    """A minimal typed client over the same generic handlers (the
    reference's InferenceGRPCClient)."""

    def __init__(self, target: str):
        self._channel = grpc.insecure_channel(target)

    def _call(self, method, req, resp_cls, metadata=None, timeout=None):
        rpc = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)
        return rpc(req, metadata=metadata, timeout=timeout)

    def server_live(self) -> bool:
        return self._call("ServerLive", pb.ServerLiveRequest(),
                          pb.ServerLiveResponse).live

    def server_ready(self) -> bool:
        """The gRPC readiness probe: the HTTP /v2/health/ready rule."""
        return self._call("ServerReady", pb.ServerReadyRequest(),
                          pb.ServerReadyResponse).ready

    def model_ready(self, name: str) -> bool:
        return self._call("ModelReady", pb.ModelReadyRequest(name=name),
                          pb.ModelReadyResponse).ready

    def model_metadata(self, name: str):
        return self._call("ModelMetadata",
                          pb.ModelMetadataRequest(name=name),
                          pb.ModelMetadataResponse)

    def metrics(self, timeout: float | None = None) -> str:
        """The server's Prometheus text over the gRPC plane; `timeout`
        bounds the RPC."""
        rpc = self._channel.unary_unary(
            "/tpk.Metrics/Prometheus",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        return rpc(b"", timeout=timeout).decode()

    def infer(self, name: str, arrays: list, *, raw: bool = False,
              request_id: str | None = None,
              timeout: float | None = None) -> list[np.ndarray]:
        """`arrays` are numpy arrays or torch tensors. `request_id` rides as
        x-request-id metadata (the server echoes it in the trailing
        metadata and stamps it on the request's spans); `timeout` is the
        RPC's deadline."""
        enc = [_encode(a) for a in arrays]
        # raw_input_contents is all-or-nothing; FP16/BF16 force raw.
        use_raw = raw or any(_CONTENTS_FIELD.get(dt) is None
                             for dt, _, _ in enc)
        req = pb.ModelInferRequest(model_name=name)
        for i, ((dt, shape, data), a) in enumerate(zip(enc, arrays)):
            t = req.inputs.add(name=f"input_{i}", datatype=dt, shape=shape)
            if use_raw:
                req.raw_input_contents.append(data)
            else:
                vals = np.frombuffer(data, np.dtype(v2_to_numpy_dtype(dt)))
                getattr(t.contents, _CONTENTS_FIELD[dt]).extend(
                    vals.tolist())
        resp = self._call("ModelInfer", req, pb.ModelInferResponse,
                          metadata=(("x-request-id", request_id),)
                          if request_id else None, timeout=timeout)
        outs = []
        for j, t in enumerate(resp.outputs):
            raw_out = (resp.raw_output_contents[j]
                       if j < len(resp.raw_output_contents) else None)
            outs.append(tensor_to_numpy(t, raw_out))
        return outs

    def close(self):
        self._channel.close()
