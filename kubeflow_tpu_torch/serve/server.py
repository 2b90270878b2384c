"""HTTP model server for the generative surface, on the standard library.

The port of the generative part of `kubeflow_tpu/serve/server.py` (and,
through serve/openai_api.py, of its OpenAI routes) onto
`http.server.ThreadingHTTPServer`: one thread per connection, the engine
doing its own batching across them.

    GET  /v2/health/live | /v2/health/ready
    GET  /v1/models                        {"models": [...]}
    GET  /v1/models/{name}                 readiness (503 until loaded)
    GET  /v2/models/{name}[/ready]         metadata / readiness + model_dir
    POST /v1/models/{name}:generate        {"input_ids": [...] | "text",
    POST /v2/models/{name}/generate         "max_tokens", "temperature",
                                            "top_k", "top_p", "eos_id",
                                            "stream"}
    POST /v1/models/{name}:prefill         the :generate body in, a KV
                                            shipment out
                                            (application/x-tpk-kv)
    POST /v1/models/{name}:decode          a KV shipment in, the :generate
                                            response out (ndjson when the
                                            :prefill body streamed)
    POST /v1/models/{name}:predict         {"instances": [...]} ->
                                            {"predictions": [...]}
    POST /v2/models/{name}/infer           open-inference tensors in and out
    POST /v1/models/{name}:explain         {"instances": [...]} ->
                                            {"explanations": [...]}
    POST /v2/repository/models/{name}/load | /unload
    POST /v2/repository/index
    GET  /metrics                          prometheus text format
    GET  /debug/trace[?trace_id=ID]        the span ring as Chrome trace JSON
    POST /openai/v1/completions | /openai/v1/chat/completions
    GET  /openai/v1/models

and, with `--grpc-port`, the open-inference v2 gRPC service
(serve/grpc_server.py: ServerLive, ServerReady, ModelReady, ModelMetadata,
ModelInfer) plus `/tpk.Metrics/Prometheus`, behind the same repository,
admission gate and readiness rule.

Request keys, responses, statuses and metric names are the JAX server's.
`"stream": true` answers `application/x-ndjson` in HTTP/1.1 chunks, one
event a chunk: a failure before the first frame gets a clean status, one
after it a terminal `{"model_name", "error"}` frame. `X-Request-Timeout-Ms`
is the request's deadline (504 at expiry, counted once in
`tpk_deadline_expired_total{component="serve"}`); `X-Request-Id` is echoed
(the caller's, sanitised, else the trace a :decode frame carries, else a
fresh one) and carried by the request's spans (utils/obs.py: admit,
batch-gather, prefill, decode-chunk, fetch, predict), which
`/debug/trace?trace_id=` returns. Bad requests get 400, unknown
models 404, features this package does not port 501, and a shed 503 with
`Retry-After` (the admission bound, a drain, or a request the paged KV pool
can never hold). `--request-log PATH` appends one JSONL line per
inference POST (`RequestLogger`; `--request-log-mode all` adds the body).

`:predict` and `/infer` go through the model's coalescing `Batcher`
(serve/batcher.py; one a model, flushed at `--max-batch-size` examples or
`--max-latency-ms` after its head request), `:explain` through the
server's worker pool; a generative model answers them with full-forward
logits. An InferenceGraph (serve/graph.py, `wants_raw_payload`) takes the
whole body instead and runs on the worker pool, around the batcher.

Admission: at most `max_inflight` inference requests run at once. As in
the JAX server, a request that expires while its batcher or pool work
runs keeps its slot until that work ends. On the generative routes the
handler thread is the work, and `submit` returns at the deadline while the
engine drops the request at its next chunk boundary, so `max_inflight`
bounds the work to within one decode chunk.

Run: python -m kubeflow_tpu_torch.serve.server --model-dir DIR --name NAME
     [--model-dir DIR2 --name NAME2] [--storage-uri file://DIR3] --port 8080
     --max-inflight 256 --max-batch-size 32 --max-latency-ms 5 --device cuda
     [--grpc-port 8081] [--request-log PATH [--request-log-mode all]]

(--storage-uri sources are named after the --model-dir ones, in order.)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from kubeflow_tpu_torch.serve import storage
from kubeflow_tpu_torch.serve.batcher import Batcher
from kubeflow_tpu_torch.serve.generation import KVCapacityExceeded
from kubeflow_tpu_torch.serve.headers import (DEADLINE_HEADER,
                                              DRAINING_HEADER,
                                              REQUEST_ID_HEADER)
from kubeflow_tpu_torch.serve.kv_transfer import ShipmentError, peek_meta
from kubeflow_tpu_torch.serve.model import Model, _v2_dtype, v2_to_numpy_dtype
from kubeflow_tpu_torch.serve.runtimes import load_model
from kubeflow_tpu_torch.utils import obs
from kubeflow_tpu_torch.utils.resilience import (Deadline, DeadlineExceeded,
                                                 metrics as res_metrics)

#: GenerationEngine stats -> /metrics series, rendered per model on every
#: scrape: the JAX server's rows for every stat this engine keeps, with
#: their names and types, the prefix cache's and the host tier's included
#: (counters at 0 while those features are off). The "__name__" rows read
#: an engine attribute; one that is None (the pool gauges of a flat
#: engine, the spill gauge without a tier) is not rendered.
_ENGINE_METRICS = (
    ("requests", "tpk_engine_requests_total", "counter"),
    ("prompt_tokens", "tpk_engine_prompt_tokens_total", "counter"),
    ("decode_tokens", "tpk_engine_decode_tokens_total", "counter"),
    ("decode_dispatches", "tpk_decode_dispatch_total", "counter"),
    ("prefix_hits", "tpk_engine_prefix_hits_total", "counter"),
    ("prefix_hit_tokens", "tpk_engine_prefix_hit_tokens_total", "counter"),
    ("prefix_misses", "tpk_engine_prefix_misses_total", "counter"),
    ("host_stall_seconds", "tpk_engine_host_stall_seconds_total",
     "counter"),
    ("admit_overlap", "tpk_admit_overlap_total", "counter"),
    ("decode_fetch_blocking", "tpk_engine_decode_fetch_blocking_total",
     "counter"),
    ("decode_fetch_overlapped",
     "tpk_engine_decode_fetch_overlapped_total", "counter"),
    ("decode_wasted_tokens", "tpk_engine_decode_wasted_tokens_total",
     "counter"),
    # Speculative decoding: dispatches, proposals and acceptances, and
    # demoted rows riding with stale draft rows. The accept rate is
    # computed at the scrape and only once proposals have flowed: no rate
    # for a draft-less or idle engine, never a fake 0.
    ("spec_dispatches", "tpk_engine_spec_dispatch_total", "counter"),
    ("spec_proposed", "tpk_spec_proposed_total", "counter"),
    ("spec_accepted", "tpk_spec_accepted_total", "counter"),
    ("spec_stale_rides", "tpk_spec_stale_rides_total", "counter"),
    ("__spec_accept_rate__", "tpk_spec_accept_rate", "gauge"),
    # Paged prefix hits served as zero-copy block references, and the
    # copy-on-write forks of their partial tail blocks.
    ("kv_cow_copies", "tpk_kv_cow_copies_total", "counter"),
    ("prefix_zero_copy_hits", "tpk_prefix_zero_copy_hits_total",
     "counter"),
    # The pool gauges exist only where a pool does (paged engines).
    ("__kv_free__", "tpk_kv_blocks_free", "gauge"),
    ("__kv_used__", "tpk_kv_blocks_used", "gauge"),
    # Disaggregated roles: prefill chunks (a decode-role engine's stay 0),
    # remote admissions, and the KV blocks shipped and received.
    ("prefill_chunks", "tpk_engine_prefill_chunks_total", "counter"),
    ("remote_admits", "tpk_engine_remote_admits_total", "counter"),
    ("kv_blocks_shipped", "tpk_kv_blocks_shipped_total", "counter"),
    ("kv_blocks_received", "tpk_kv_blocks_received_total", "counter"),
    # The host tier: blocks spilled and restored, and those resident.
    ("kv_spilled_blocks", "tpk_kv_spilled_blocks_total", "counter"),
    ("kv_restored_blocks", "tpk_kv_restored_blocks_total", "counter"),
    ("__kv_spill__", "tpk_kv_spill_blocks", "gauge"),
    # Prefix-hit fragment rebuilds on a quantized pool: the one full-width
    # dequant the design allows (decode never pays it).
    ("kv_dequant_fallbacks", "tpk_kv_dequant_fallbacks_total",
     "counter"),
    # Live in-flight dispatch count (0 when drained; stuck at <= 1 means
    # the pipeline re-serialised) vs the configured ceiling.
    ("__inflight__", "tpk_decode_inflight_depth", "gauge"),
    ("__depth__", "tpk_engine_pipeline_depth", "gauge"),
)

_ENGINE_ATTRS = {"__kv_free__": "kv_blocks_free",
                 "__kv_used__": "kv_blocks_used",
                 "__kv_spill__": "kv_spill_blocks",
                 "__inflight__": "inflight_depth",
                 "__depth__": "pipeline_depth"}


class HTTPError(Exception):
    """A response status with its message (the body's error)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Surface:
    """The error bodies of a family of routes: the native one here, the
    OpenAI envelope in serve/openai_api.py."""

    def error_body(self, status: int, message: str) -> dict:
        return {"error": message}

    def shed_body(self) -> dict:
        return {"error": "server overloaded: admission queue full"}

    def capacity_body(self, message: str) -> dict:
        """503 body of a paged-KV capacity shed or a drain rejection."""
        return {"error": message}


NATIVE = Surface()


class Route:
    """`fn(handler, *groups)` for `method` on paths matching `pattern`.
    `gated` routes pass the admission gate first."""

    def __init__(self, method: str, pattern: str, fn, *, gated=False,
                 surface: Surface = NATIVE):
        self.method, self.fn, self.gated = method, fn, gated
        self.pattern = re.compile(pattern + "$")
        self.surface = surface


class AdmissionController:
    """Bounded admission for the inference data plane (the KServe/Knative
    containerConcurrency behaviour, in-process): at most `max_inflight`
    inference requests admitted at once; beyond that the server sheds
    (503 + Retry-After), and readiness degrades while it is rejecting.
    Merely being full does not degrade readiness: a long request on a
    small replica must not pull it from the endpoints when nothing was
    rejected."""

    def __init__(self, max_inflight: int = 256,
                 retry_after_s: float = 1.0):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{max_inflight}")
        self.max_inflight = int(max_inflight)
        self.retry_after_s = float(retry_after_s)
        self._inflight = 0  # guarded-by: _lock
        self._last_shed = -float("inf")  # guarded-by: _lock
        self._lock = threading.Lock()

    def try_acquire(self, component: str = "serve") -> bool:
        with self._lock:
            if self._inflight >= self.max_inflight:
                self._last_shed = time.monotonic()
                res_metrics.inc("tpk_shed_total", component=component)
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1

    def note_shed(self, component: str = "serve") -> None:
        """Record an out-of-band shed (a request the paged KV pool can
        never hold) like a queue-full rejection: counter and readiness
        window."""
        with self._lock:
            self._last_shed = time.monotonic()
        res_metrics.inc("tpk_shed_total", component=component)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def shedding(self) -> bool:
        """True while at capacity AND a request was rejected within the
        last `retry_after_s`: a full-but-quiet replica stays ready and
        recovers the moment load drains."""
        with self._lock:
            return (self._inflight >= self.max_inflight
                    and time.monotonic() - self._last_shed
                    <= self.retry_after_s)


class ModelRepository:
    """Name -> Model with load/unload: the multi-model surface of the
    repository API, with one coalescing Batcher a model (its `predict`
    behind `max_batch_size` and `max_latency_ms`)."""

    #: Seconds a replaced model version stays loaded after a swap so
    #: in-flight requests against it finish (class attr: tests shrink it).
    UNLOAD_GRACE_S = 10.0

    def __init__(self, device=None, max_batch_size: int = 32,
                 max_latency_ms: float = 5.0):
        self.device = device
        self.max_batch_size = max_batch_size
        self.max_latency_ms = max_latency_ms
        self._models: dict[str, Model] = {}
        self._batchers: dict[str, Batcher] = {}
        self._dirs: dict[str, str] = {}
        self._load_errors: dict[str, str] = {}
        # Async-load intents: name -> wanted model_dir ("" = unload was
        # requested mid-load; the worker discards its result).
        self._want: dict[str, str] = {}
        self._inflight: set[str] = set()
        # Grace-window timers of replaced versions -> the version each
        # will unload.
        self._timers: dict[threading.Timer, Model] = {}
        self._lock = threading.Lock()

    def register(self, model: Model, *, load: bool = True,
                 model_dir: str | None = None) -> Model:
        if load and not model.ready:
            model.load()
        with self._lock:
            old = self._models.get(model.name)
            self._models[model.name] = model
            if model_dir:
                self._dirs[model.name] = model_dir
            old_batcher = self._batchers.pop(model.name, None)
            self._batchers[model.name] = Batcher(
                model.predict, max_batch_size=self.max_batch_size,
                max_latency_ms=self.max_latency_ms)
        if old_batcher is not None:
            old_batcher.close()
        if old is not None and old is not model:
            # The replaced version keeps its engine for a grace window so
            # requests that grabbed it just before the swap finish; the
            # callback re-checks the live registration, since a rollback
            # may have re-registered the same object meanwhile.
            timer = threading.Timer(self.UNLOAD_GRACE_S,
                                    self._deferred_unload,
                                    args=(model.name, old))
            timer.daemon = True
            with self._lock:
                self._timers[timer] = old
            timer.start()
        if load and not model.ready:
            # A stale grace timer of an earlier swap may have unloaded this
            # object between the check above and the install; now that it
            # is live every later timer spares it, so one re-load closes
            # the race.
            model.load()
        return model

    def _deferred_unload(self, name: str, old: Model) -> None:
        # Check and unload under the lock, serialised with a rollback's
        # install; the re-load at the end of register covers the rest.
        with self._lock:
            for timer, m in list(self._timers.items()):
                if m is old:
                    del self._timers[timer]
            if self._models.get(name) is old:
                return  # rolled back: old is live again
            old.unload()

    def get(self, name: str) -> Model:
        try:
            return self._models[name]
        except KeyError:
            raise HTTPError(404, f"model {name!r} not found") from None

    def batcher(self, name: str) -> Batcher:
        self.get(name)
        return self._batchers[name]

    def names(self) -> list[str]:
        return sorted(self._models)

    def load(self, name: str) -> Model:
        """(Re)load by name: from its recorded model dir if registered that
        way, else by flipping the in-process model's lifecycle."""
        with self._lock:
            model_dir = self._dirs.get(name)
        if model_dir:
            model = load_model(model_dir, name=name, device=self.device)
            return self.register(model, model_dir=model_dir)
        model = self.get(name)
        model.load()
        return model

    def load_async(self, name: str, model_dir: str) -> None:
        """Load a model from `model_dir` on a background thread (the
        TrainedModel path: the control plane's POST returns at once and
        polls /v2/models/{name}/ready). Latest intent wins: a newer
        model_dir, or an unload, arriving mid-load supersedes the result
        in flight."""
        with self._lock:
            self._want[name] = model_dir
            self._load_errors.pop(name, None)
            if name in self._inflight:
                return  # the worker re-checks _want when it finishes
            self._inflight.add(name)

        def work():
            while True:
                with self._lock:
                    target = self._want.get(name, "")
                    if not target:  # unloaded / intent cleared mid-load
                        self._inflight.discard(name)
                        return
                try:
                    model = load_model(target, name=name, device=self.device)
                    model.load()
                except Exception as e:
                    # Decided under the lock that releases _inflight: a
                    # concurrent load_async either sees this worker in
                    # flight (and it loops on the new intent) or gone.
                    with self._lock:
                        if self._want.get(name, "") == target:
                            self._load_errors[name] = (
                                f"{type(e).__name__}: {e}")
                            self._inflight.discard(name)
                            return
                    continue  # intent changed while failing: retry
                with self._lock:
                    if self._want.get(name, "") != target:
                        model.unload()
                        continue  # newer dir (or unload) requested: redo
                self.register(model, model_dir=target)
                with self._lock:
                    want_now = self._want.get(name, "")
                    if want_now == target:
                        self._inflight.discard(name)
                        return
                if not want_now:  # unload arrived during register
                    self.get(name).unload()
                    with self._lock:
                        if not self._want.get(name, ""):
                            self._inflight.discard(name)
                            return
                # newer dir requested: loop to load it

        threading.Thread(target=work, daemon=True,
                         name=f"tpk-load-{name}").start()

    def loading_error(self, name: str) -> str | None:
        with self._lock:
            return self._load_errors.get(name)

    def model_dir(self, name: str) -> str | None:
        with self._lock:
            return self._dirs.get(name)

    def unload(self, name: str) -> None:
        with self._lock:
            in_flight = name in self._inflight
            self._want[name] = ""  # cancels an in-flight load
            self._load_errors.pop(name, None)
            known = name in self._models
        if not known:
            if in_flight:
                return  # cancelled before it ever registered
            raise HTTPError(404, f"model {name!r} not found")
        self.get(name).unload()

    def close(self) -> None:
        """Unload every model, the replaced versions still in their grace
        window included (their timers are cancelled)."""
        with self._lock:
            timers, self._timers = self._timers, {}
            models = list(self._models.values())
            batchers = list(self._batchers.values())
        for batcher in batchers:
            batcher.close()
        for timer, old in timers.items():
            timer.cancel()
            old.unload()
        for model in models:
            model.unload()


# -- handlers -----------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # keep request logs off stderr
        pass

    # -- plumbing ------------------------------------------------------------

    def _respond(self, status: int, body: bytes, content_type: str,
                 headers=()) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header(REQUEST_ID_HEADER, self.trace_id)
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)
        self._responded = True

    def write_json(self, obj, status: int = 200, headers=()) -> None:
        self._respond(status, json.dumps(obj).encode(), "application/json",
                      headers)

    def body_json(self) -> dict:
        try:
            body = json.loads(self.raw_body or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"bad JSON: {e}") from None
        if not isinstance(body, dict):
            raise HTTPError(400, "request body must be a JSON object")
        return body

    @property
    def app(self) -> "ModelServer":
        return self.server.app

    @property
    def repo(self) -> ModelRepository:
        return self.server.app.repo

    def send_response(self, code, message=None):
        self.status_sent = code  # the request log's status
        super().send_response(code, message)

    def _handle(self, method: str) -> None:
        self.t_start = time.monotonic()
        self.trace_id = obs.sanitize_trace_id(
            self.headers.get(REQUEST_ID_HEADER))
        self._responded = False
        self.status_sent = None
        length = int(self.headers.get("Content-Length") or 0)
        self.raw_body = self.rfile.read(length) if length else b""
        path = self.path_only = urlsplit(self.path).path
        route, groups, allowed = None, (), False
        for r in self.app.routes:
            m = r.pattern.match(path)
            if m:
                allowed = True
                if r.method == method:
                    route, groups = r, m.groups()
                    break
        self.surface = route.surface if route else NATIVE
        try:
            self._route(route, groups, allowed, path)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True  # the client went away
        logger = self.app.request_logger
        if (logger is not None and route is not None and method == "POST"
                and path.endswith(RequestLogger.SUFFIXES)):
            logger.log(self, groups[0] if groups else None)

    def _route(self, route, groups, allowed, path) -> None:
        try:
            if route is None:
                raise HTTPError(405 if allowed else 404,
                                "Method Not Allowed" if allowed
                                else f"no route {path}")
            if route.gated:
                self._gated(route.fn, groups)
            else:
                route.fn(self, *groups)
        except Exception as e:
            if self._responded:  # a stream's status line is already out
                self.close_connection = True
                return
            if isinstance(e, HTTPError):
                status, msg = e.status, str(e)
            elif isinstance(e, NotImplementedError):
                status, msg = 501, str(e)
            else:  # the server keeps serving; the caller sees why
                status, msg = 500, f"{type(e).__name__}: {e}"
            self.write_json(self.surface.error_body(status, msg), status)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    # -- resilience (deadline + admission) -----------------------------------

    def request_deadline(self) -> Deadline | None:
        """The request's end-to-end budget from DEADLINE_HEADER (None
        when the client set none)."""
        raw = self.headers.get(DEADLINE_HEADER)
        if raw is None:
            return None
        try:
            ms = float(raw)
            # NaN/inf would defeat every expiry comparison downstream.
            if not math.isfinite(ms) or ms <= 0:
                raise ValueError
        except ValueError:
            raise HTTPError(
                400, f"{DEADLINE_HEADER} must be a positive number of "
                     f"milliseconds, got {raw!r}") from None
        return Deadline(ms / 1e3)

    def _gated(self, fn, groups) -> None:
        """Run an inference route behind the admission gate: a drain
        rejection or a shed (503 written here), else the route with a
        guaranteed release. Every inference route goes through this one
        gate, so none is a side door around --max-inflight."""
        if self.app.draining:
            # Not an overload shed: DRAINING_HEADER tells a router to
            # retry elsewhere. Requests already admitted run to the end.
            self.write_json(self.surface.capacity_body("replica draining"),
                            503, (("Retry-After", "1"),
                                  (DRAINING_HEADER, "1")))
            return
        adm = self.app.admission
        with obs.span("serve.admit", trace_id=self.trace_id,
                      path=self.path_only) as sp:
            admitted = adm is None or adm.try_acquire()
            sp.set(admitted=admitted)
        if not admitted:
            self.write_json(self.surface.shed_body(), 503, (
                ("Retry-After", str(max(int(adm.retry_after_s), 1))),))
            return
        self.slot_rides_with: Future | None = None
        try:
            fn(self, *groups)
        finally:
            if adm is not None:
                rides = self.slot_rides_with
                if rides is None:
                    adm.release()
                else:
                    # The request expired while its work runs: the slot
                    # is freed when the work ends (at once if it never
                    # started), so max_inflight bounds concurrent work.
                    rides.add_done_callback(lambda _f: adm.release())

    def await_bounded(self, fut: Future, deadline: Deadline | None):
        """The result of batcher or pool work under the request's
        deadline: 504 at expiry (counted here once per request), whether
        the work raised DeadlineExceeded (the batcher's queue pruning) or
        the clock ran out here. An expired request's pending work is
        cancelled; running work keeps the admission slot until it ends."""
        rem = None if deadline is None else deadline.remaining()
        try:
            return fut.result(None if rem is None else max(rem, 0.0))
        except TimeoutError as e:
            if deadline is None or not (isinstance(e, DeadlineExceeded)
                                        or deadline.expired()):
                # A timeout raised by the work itself with budget left is
                # a server fault, not an expired deadline.
                raise
            if not fut.cancel() and not fut.done():
                self.slot_rides_with = fut
            res_metrics.inc("tpk_deadline_expired_total", component="serve")
            raise HTTPError(504, f"request deadline exceeded "
                                 f"({type(e).__name__})") from e

    def write_capacity_shed(self, msg: str) -> None:
        """The shed path of paged-KV capacity refusals on every surface:
        counted like a queue-full rejection (tpk_shed_total and the
        readiness window), answered 503 + Retry-After in the surface's
        envelope."""
        adm = self.app.admission
        if adm is not None:
            adm.note_shed("serve")
        else:
            res_metrics.inc("tpk_shed_total", component="serve")
        self.write_json(self.surface.capacity_body(msg), 503,
                        (("Retry-After", "1"),))

    def run_bounded(self, fn, payload: dict):
        """`fn(payload)` (a blocking generate): its deadline expiry is 504,
        counted here once per request (the engine never counts). The
        call returns at expiry: `submit` wakes at the deadline."""
        try:
            return fn(payload)
        except DeadlineExceeded as e:
            res_metrics.inc("tpk_deadline_expired_total", component="serve")
            raise HTTPError(504, f"request deadline exceeded "
                                 f"({type(e).__name__})") from e

    def pump_stream(self, it, content_type: str, render, render_error,
                    headers=()) -> bool:
        """Drive a blocking event generator into a chunked HTTP response,
        one event a chunk; shared by the ndjson :generate stream and the
        OpenAI SSE surfaces. A failure before the first event is a clean
        status (504 on expiry, the capacity shed's 503, 400 for a bad
        request, else 500); after it, one terminal `render_error` frame.
        A client disconnect closes the generator (the engine decodes the
        request on to its end). `render(ev, first) -> (text, done)`.
        Returns False when nothing was streamed (a shed was written)."""
        end = object()

        def step():
            try:
                return "ev", next(it, end)
            except DeadlineExceeded as e:
                return "expired", f"{type(e).__name__}: {e}"
            except KVCapacityExceeded as e:  # before RuntimeError: a shed
                return "shed", str(e)
            except NotImplementedError:
                raise
            except (ValueError, RuntimeError) as e:
                return "badreq", f"{type(e).__name__}: {e}"
            except Exception as e:
                return "err", f"{type(e).__name__}: {e}"

        kind, ev = step()
        if kind == "expired":
            # Streams count their expiry here, once per request.
            res_metrics.inc("tpk_deadline_expired_total", component="serve")
            raise HTTPError(504, ev)
        if kind == "shed":
            self.write_capacity_shed(ev)
            return False
        if kind in ("badreq", "err"):
            raise HTTPError(400 if kind == "badreq" else 500, ev)
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header(REQUEST_ID_HEADER, self.trace_id)
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self._responded = True
        first = True
        try:
            while ev is not end:
                if kind != "ev":
                    if kind == "expired":
                        # The status line is out: the 504 becomes the
                        # terminal frame, still one expired request.
                        res_metrics.inc("tpk_deadline_expired_total",
                                        component="serve")
                    self._chunk(render_error(ev))
                    break
                text, done = render(ev, first)
                first = False
                self._chunk(text)
                if done:
                    break
                kind, ev = step()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            it.close()
            self.close_connection = True
        return True

    def _chunk(self, text: str) -> None:
        """One HTTP/1.1 chunk (hex length, CRLF, data, CRLF), flushed."""
        data = text.encode()
        if data:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()


# -- routes -------------------------------------------------------------------


def _health(h: _Handler, kind: str) -> None:
    if kind == "ready":
        ready, why = h.app.readiness()
        if not ready:
            raise HTTPError(503, why)
    h.write_json({"live" if kind == "live" else "ready": True})


def _list_models(h: _Handler) -> None:
    h.write_json({"models": h.repo.names()})


def _v1_model(h: _Handler, name: str) -> None:
    model = h.repo.get(name)
    if not model.ready:
        raise HTTPError(503, f"model {name!r} not ready")
    h.write_json({"name": name, "ready": model.ready})


def _v2_model(h: _Handler, name: str, sub: str | None) -> None:
    # A failed background load answers here, so a controller polling
    # readiness sees the error, but never at the expense of a live model:
    # a previous version still registered reports its own state.
    if name not in h.repo.names():
        err = h.repo.loading_error(name)
        if err:
            raise HTTPError(503, f"model {name!r} failed to load: {err}")
    model = h.repo.get(name)
    if sub == "/ready":
        if not model.ready:
            raise HTTPError(503, f"model {name!r} not ready")
        # model_dir tells a version-aware client (the TrainedModel
        # controller) "old version still serving" from "my load landed".
        h.write_json({"name": name, "ready": True,
                      "model_dir": h.repo.model_dir(name)})
    else:
        h.write_json(model.metadata())


def _generate_body(h: _Handler) -> dict:
    """A :generate-shaped request body with the request's Deadline under
    "_deadline" and its trace id under "_trace"."""
    body = h.body_json()
    # "_deadline"/"_trace" are in-process fields only: a wire-supplied one
    # would reach the engine as a non-Deadline or a spoofed trace.
    body.pop("_deadline", None)
    body["_trace"] = h.trace_id
    deadline = h.request_deadline()
    if deadline is not None:
        # The engine checks this object at admission and at every chunk
        # boundary: an expired request frees its decode slot.
        body["_deadline"] = deadline
    return body


def _generate(h: _Handler, name: str) -> None:
    """:generate and /v2/models/{name}/generate: the generative data plane.
    The engine batches concurrent requests itself."""
    model = h.repo.get(name)
    gen = getattr(model, "generate", None)
    if gen is None:
        raise HTTPError(400, f"model {name!r} is not generative")
    body = _generate_body(h)
    t0 = time.monotonic()
    if body.get("stream"):
        _generate_stream(h, name, model, body, t0)
        return
    out = _inference(h, gen, body)
    if out is None:
        return
    h.app.observe(name, out.get("num_output_tokens", 0),
                  time.monotonic() - t0)
    h.write_json({"model_name": name, **out})


def _generate_stream(h: _Handler, name: str, model, body: dict,
                     t0: float) -> None:
    """"stream": true: newline-delimited JSON events, one chunk each."""
    stream_fn = getattr(model, "generate_stream", None)
    if stream_fn is None:
        raise HTTPError(400, f"model {name!r} does not stream")
    _ndjson_stream(h, name, stream_fn(body), t0)


def _ndjson_stream(h: _Handler, name: str, events, t0: float) -> None:
    """A generate-shaped event stream as ndjson, one chunk an event."""
    tokens_out = 0

    def render(ev, first):
        nonlocal tokens_out
        tokens_out += len(ev.get("tokens", ()))
        return (json.dumps({"model_name": name, **ev}) + "\n",
                bool(ev.get("done")))

    def render_error(msg):
        return json.dumps({"model_name": name, "error": msg}) + "\n"

    if h.pump_stream(events, "application/x-ndjson", render, render_error):
        h.app.observe(name, tokens_out, time.monotonic() - t0)


#: Content type of a KV shipment (serve/kv_transfer.py's frame), which a
#: router relays opaquely from a :prefill to a :decode.
KV_SHIPMENT_CONTENT_TYPE = "application/x-tpk-kv"


def _inference(h: _Handler, fn, *args, **kwargs) -> dict | None:
    """`fn(*args, **kwargs)` under the request's bounds: 504 at its
    deadline, the capacity shed's 503 (None returned; the shed is
    written), 400 for a bad request."""
    try:
        return h.run_bounded(lambda _: fn(*args, **kwargs), None)
    except KVCapacityExceeded as e:
        # Paged-KV exhaustion is an overload shed, not a bad request.
        h.write_capacity_shed(str(e))
        return None
    except NotImplementedError:
        raise
    except (ValueError, RuntimeError) as e:
        raise HTTPError(400, str(e)) from None


def _prefill(h: _Handler, name: str) -> None:
    """:prefill: the :generate body in, the prefill engine's KV shipment
    out; its pool holds nothing of the request once the bytes are sent."""
    model = h.repo.get(name)
    ship = getattr(model, "prefill_ship", None)
    if ship is None:
        raise HTTPError(400, f"model {name!r} cannot prefill-ship (not "
                             "generative, or no paged KV pool)")
    body = _generate_body(h)
    t0 = time.monotonic()
    out = _inference(h, ship, body)
    if out is None:
        return
    h.app.observe(name, out.get("num_input_tokens", 0),
                  time.monotonic() - t0)
    h._respond(200, out["shipment"], KV_SHIPMENT_CONTENT_TYPE)


def _decode(h: _Handler, name: str) -> None:
    """:decode: a KV shipment in, the :generate response out (streamed as
    ndjson when the :prefill body asked to stream, a flag the frame's
    `extra` carries). The engine admits the blocks straight into decode."""
    model = h.repo.get(name)
    dec = getattr(model, "decode_remote", None)
    if dec is None:
        raise HTTPError(400, f"model {name!r} cannot decode a shipment "
                             "(not generative, or no paged KV pool)")
    shipment = h.raw_body
    try:
        meta = peek_meta(shipment)
    except ShipmentError as e:
        raise HTTPError(400, f"bad KV shipment: {e}") from None
    if meta.get("trace") and REQUEST_ID_HEADER not in h.headers:
        # A router stamps the caller's trace id into the frame: a :decode
        # without an X-Request-Id of its own joins the caller's trace.
        h.trace_id = obs.sanitize_trace_id(str(meta["trace"]))
    deadline = h.request_deadline()
    t0 = time.monotonic()
    if (meta.get("extra") or {}).get("stream"):
        _ndjson_stream(h, name, model.decode_remote_stream(
            shipment, deadline=deadline, trace_id=h.trace_id), t0)
        return
    out = _inference(h, dec, shipment, deadline=deadline,
                     trace_id=h.trace_id)
    if out is None:
        return
    h.app.observe(name, out.get("num_output_tokens", 0),
                  time.monotonic() - t0)
    h.write_json({"model_name": name, **out})


def _v1_body(h: _Handler, model) -> tuple[dict, list]:
    """The v1 body after the model's preprocess, and its "instances"; 400
    without them."""
    body = model.preprocess(h.body_json())
    instances = body.get("instances")
    if instances is None:
        raise HTTPError(400, 'v1 request needs "instances"')
    return body, instances


def _spec_dtype(model):
    spec = getattr(model, "input_spec", None)
    return spec[0][1] if spec else None


def _predict(h: _Handler, name: str) -> None:
    """:predict: the v1 instances stacked along batch dim 0 in the model's
    input dtype, through its batcher."""
    model = h.repo.get(name)
    deadline = h.request_deadline()
    body, instances = _v1_body(h, model)
    t0 = time.monotonic()
    if getattr(model, "wants_raw_payload", False):
        # InferenceGraphs take the whole body (routing fields included)
        # around the batcher: per-request routing cannot survive
        # cross-request coalescing.
        out = h.await_bounded(h.app.executor.submit(model.predict, body),
                              deadline)
        preds = out.get("instances") if isinstance(out, dict) else out
        h.app.observe(name, len(instances), time.monotonic() - t0)
        h.write_json({"predictions": np.asarray(preds).tolist()})
        return
    inputs = [np.asarray(instances, dtype=_spec_dtype(model))]
    outs = h.await_bounded(h.repo.batcher(name).submit(
        inputs, deadline=deadline, trace_id=h.trace_id), deadline)
    outs = model.postprocess(outs)
    h.app.observe(name, len(instances), time.monotonic() - t0)
    preds = outs[0] if isinstance(outs, (list, tuple)) else outs
    h.write_json({"predictions": np.asarray(preds).tolist()})


def _infer(h: _Handler, name: str) -> None:
    """/v2/models/{name}/infer: open-inference tensors through the
    model's batcher; outputs in the JAX server's field order."""
    model = h.repo.get(name)
    deadline = h.request_deadline()
    body = model.preprocess(h.body_json())
    tensors = body.get("inputs")
    if not tensors:
        raise HTTPError(400, 'v2 request needs "inputs"')
    inputs = [np.asarray(t["data"], dtype=v2_to_numpy_dtype(
        t.get("datatype", "FP32"))).reshape(t["shape"]) for t in tensors]
    t0 = time.monotonic()
    if getattr(model, "wants_raw_payload", False):
        # Graph path: the first tensor becomes "instances", the v2
        # request's parameters ride along as routing fields.
        payload = dict(body.get("parameters") or {})
        payload["instances"] = inputs[0]
        out = h.await_bounded(h.app.executor.submit(model.predict, payload),
                              deadline)
        outs = [out.get("instances") if isinstance(out, dict) else out]
    else:
        outs = h.await_bounded(h.repo.batcher(name).submit(
            inputs, deadline=deadline, trace_id=h.trace_id), deadline)
    outs = model.postprocess(outs)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    h.app.observe(name, int(inputs[0].shape[0]), time.monotonic() - t0)
    h.write_json({
        "model_name": name, "id": body.get("id", ""),
        "outputs": [{
            "name": f"output_{i}", "shape": list(np.shape(o)),
            "datatype": _v2_dtype(str(np.asarray(o).dtype)),
            "data": np.asarray(o).ravel().tolist(),
        } for i, o in enumerate(outs)]})


def _explain(h: _Handler, name: str) -> None:
    """:explain: the model's attached explainer (serve/explain.py) on the
    server's worker pool; 501 when it has none, 400 for instances it
    refuses."""
    model = h.repo.get(name)
    deadline = h.request_deadline()
    _, instances = _v1_body(h, model)
    t0 = time.monotonic()
    try:
        arr = np.asarray(instances, dtype=_spec_dtype(model))
        out = h.await_bounded(h.app.executor.submit(model.explain, arr),
                              deadline)
    except NotImplementedError as e:
        raise HTTPError(501, str(e)) from None
    except (ValueError, TypeError) as e:
        # TypeError: an instance of the wrong per-example shape.
        raise HTTPError(400, str(e)) from None
    h.app.observe(name, len(out), time.monotonic() - t0)
    h.write_json({"explanations": out})


def _repository(h: _Handler, name: str, verb: str) -> None:
    if verb == "load":
        # {"model_dir": ...} attaches a new model to this running server
        # (the TrainedModel path) in the background: 202 now, then poll
        # /v2/models/{name}/ready. A bodyless load re-loads a known model
        # synchronously.
        model_dir = h.body_json().get("model_dir")
        if model_dir:
            h.repo.load_async(name, model_dir)
            h.write_json({"name": name, "state": "LOADING"}, 202)
            return
        h.repo.load(name)
    else:
        h.repo.unload(name)
    h.write_json({"name": name, "state":
                  "READY" if verb == "load" else "UNAVAILABLE"})


def _repository_index(h: _Handler) -> None:
    out = []
    for name in h.repo.names():
        m = h.repo.get(name)
        out.append({"name": name,
                    "state": "READY" if m.ready else "UNAVAILABLE"})
    h.write_json(out)


def _metrics(h: _Handler) -> None:
    h._respond(200, h.app.prometheus_text().encode(),
               "text/plain; version=0.0.4")


def _debug_trace(h: _Handler) -> None:
    """GET /debug/trace[?trace_id=ID]: the process's span ring as Chrome
    trace-event JSON (chrome://tracing, Perfetto), filtered to one request
    id when asked."""
    tid = parse_qs(urlsplit(h.path).query).get("trace_id")
    h.write_json(obs.get_tracer().chrome_trace(tid[-1] if tid else None))


class RequestLogger:
    """The inference request log (the KServe agent logger's role): one
    JSONL line per inference POST, on the JAX server's path suffixes, with
    its keys (ts, method, path, model, status as sent, latency_ms from the
    request's start, request_bytes; the body too under mode "all"),
    appended to a local file."""

    SUFFIXES = (":predict", ":generate", ":prefill", ":decode", "/infer",
                "/generate")

    def __init__(self, path: str, mode: str = "metadata"):
        if mode not in ("metadata", "all"):
            raise ValueError(f"request log mode {mode!r}: metadata | all")
        self.mode = mode
        self._fh = open(path, "a", buffering=1)
        self._lock = threading.Lock()

    def log(self, h: _Handler, model: str | None) -> None:
        rec = {
            "ts": time.time(),
            "method": h.command,
            "path": h.path_only,
            "model": model,
            "status": h.status_sent,
            "latency_ms": round((time.monotonic() - h.t_start) * 1e3, 3),
            "request_bytes": len(h.raw_body),
        }
        if self.mode == "all":
            try:
                rec["request"] = json.loads(h.raw_body or b"{}")
            except ValueError:  # not JSON (a :decode frame), or not UTF-8
                rec["request"] = None
        with self._lock:
            self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's listen backlog of 5 drops the connections of a burst
    # past it, which the clients retry a second later; 128 is tornado's
    # (the JAX server's) default.
    request_queue_size = 128

    def __init__(self, addr, app: "ModelServer"):
        super().__init__(addr, _Handler)
        self.app = app


class ModelServer:
    """A ModelRepository behind the HTTP server, with admission control,
    draining and the metrics surface."""

    def __init__(self, host: str = "127.0.0.1",
                 repo: ModelRepository | None = None,
                 admission: AdmissionController | None = None,
                 max_inflight: int = 256, device=None,
                 max_batch_size: int = 32, max_latency_ms: float = 5.0,
                 request_logger: RequestLogger | None = None):
        self.host = host
        self.request_logger = request_logger
        self.repo = repo or ModelRepository(
            device=device, max_batch_size=max_batch_size,
            max_latency_ms=max_latency_ms)
        # :explain runs here so an expired request hands back a future
        # whose end frees its admission slot.
        self.executor = ThreadPoolExecutor(
            max_workers=min(32, (os.cpu_count() or 1) + 4),
            thread_name_prefix="tpk-serve-work")
        # max_inflight=0 turns admission control off; an explicit
        # controller wins over the knob.
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, got "
                             f"{max_inflight}")
        self.admission = admission
        if admission is None and max_inflight > 0:
            self.admission = AdmissionController(max_inflight)
        self._counters: dict[str, dict] = {}
        self._lock = threading.Lock()
        # A plain bool: one writer (the drain trigger), reads under the GIL.
        self._draining = False
        self._http: _HTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._grpc = None
        self.grpc_port: int | None = None
        self.routes = self._routes()

    def _routes(self) -> list[Route]:
        from kubeflow_tpu_torch.serve import openai_api

        return openai_api.routes() + [
            Route("GET", r"/v1/models", _list_models),
            Route("GET", r"/v1/models/([^/:]+)", _v1_model),
            Route("POST", r"/v1/models/([^/:]+):generate", _generate,
                  gated=True),
            Route("POST", r"/v2/models/([^/]+)/generate", _generate,
                  gated=True),
            Route("POST", r"/v1/models/([^/:]+):prefill", _prefill,
                  gated=True),
            Route("POST", r"/v1/models/([^/:]+):decode", _decode,
                  gated=True),
            Route("GET", r"/v2/health/(live|ready)", _health),
            Route("POST", r"/v2/repository/models/([^/]+)/(load|unload)",
                  _repository),
            Route("POST", r"/v2/repository/index", _repository_index),
            Route("GET", r"/v2/models/([^/]+)(/ready)?", _v2_model),
            Route("GET", r"/metrics", _metrics),
            Route("POST", r"/v1/models/([^/:]+):predict", _predict,
                  gated=True),
            Route("POST", r"/v1/models/([^/:]+):explain", _explain,
                  gated=True),
            Route("POST", r"/v2/models/([^/]+)/infer", _infer, gated=True),
            Route("GET", r"/debug/trace", _debug_trace),
        ]

    # -- models --------------------------------------------------------------

    @property
    def models(self) -> dict[str, Model]:
        return {n: self.repo.get(n) for n in self.repo.names()}

    def register(self, model: Model) -> None:
        """Register `model` as it is (loaded or not)."""
        self.repo.register(model, load=False)

    def load(self, model_dir: str, name: str | None = None,
             device=None) -> Model:
        """Load a bundle, build its engine, and register it (with its
        directory, for the repository's reload)."""
        if device is not None:
            self.repo.device = device
        model = load_model(model_dir, name=name, device=self.repo.device)
        return self.repo.register(model, model_dir=model_dir)

    # -- draining and readiness ----------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Enter draining: readiness goes 503, new inference requests are
        rejected 503 + DRAINING_HEADER, in-flight ones run to the end."""
        self._draining = True

    def end_drain(self) -> None:
        """Abort a drain: admission and readiness recover."""
        self._draining = False

    def readiness(self) -> tuple[bool, str]:
        """Not ready while draining, while any model is loading, or while
        the replica is actively shedding (rejections within the last
        retry_after_s)."""
        if self._draining:
            return False, "draining"
        for name in self.repo.names():
            try:
                model = self.repo.get(name)
            except HTTPError:
                continue  # unloaded between names() and get()
            if not model.ready:
                return False, "models loading"
        if self.admission is not None and self.admission.shedding:
            return False, "shedding: admission queue full"
        return True, ""

    # -- metrics -------------------------------------------------------------

    def observe(self, model: str, examples: int, seconds: float) -> None:
        with self._lock:
            c = self._counters.setdefault(
                model, {"requests": 0, "examples": 0, "seconds": 0.0})
            c["requests"] += 1
            c["examples"] += examples
            c["seconds"] += seconds
        res_metrics.observe("tpk_serve_request_latency_seconds", seconds,
                            model=model)

    def prometheus_text(self) -> str:
        lines = [
            "# TYPE tpk_serve_requests_total counter",
            "# TYPE tpk_serve_examples_total counter",
            "# TYPE tpk_serve_request_seconds_total counter",
        ]
        with self._lock:
            for model, c in sorted(self._counters.items()):
                tag = f'{{model="{model}"}}'
                lines += [
                    f"tpk_serve_requests_total{tag} {c['requests']}",
                    f"tpk_serve_examples_total{tag} {c['examples']}",
                    f"tpk_serve_request_seconds_total{tag} {c['seconds']:.6f}",
                ]
        if self.admission is not None:
            lines += [
                "# TYPE tpk_serve_inflight gauge",
                f"tpk_serve_inflight {self.admission.inflight}",
            ]
        lines += self._engine_metric_lines()
        # The shared resilience counters (deadline expiries, sheds) and
        # the latency histogram render on the same scrape.
        return "\n".join(lines) + "\n" + res_metrics.prometheus_text()

    def _engine_metric_lines(self) -> list[str]:
        """Per-model generation-engine series (see _ENGINE_METRICS)."""
        rows = []
        for name in self.repo.names():
            try:
                engine = getattr(self.repo.get(name), "engine", None)
            except HTTPError:
                continue  # unloaded between names() and get()
            if engine is None:
                continue
            rows.append((name, engine, engine.stats_snapshot()))
        lines: list[str] = []
        for stat_key, metric, kind in _ENGINE_METRICS:
            typed = False
            for name, engine, stats in rows:
                if stat_key in _ENGINE_ATTRS:
                    val = getattr(engine, _ENGINE_ATTRS[stat_key], None)
                elif stat_key == "__spec_accept_rate__":
                    proposed = stats.get("spec_proposed") or 0
                    val = (stats.get("spec_accepted", 0) / proposed
                           if proposed else None)
                else:
                    val = stats.get(stat_key)
                if val is None:
                    continue
                if not typed:
                    lines.append(f"# TYPE {metric} {kind}")
                    typed = True
                v = (int(val) if float(val).is_integer()
                     else round(float(val), 6))
                lines.append(f'{metric}{{model="{name}"}} {v}')
        # Labeled presence gauges, one series a model: the engine's role
        # and its KV quantization mode ("none" rendered too).
        for metric, attr, label in (("tpk_engine_role", "role", "role"),
                                    ("tpk_kv_quant_mode", "kv_quant",
                                     "mode")):
            typed = False
            for name, engine, _ in rows:
                value = getattr(engine, attr, None)
                if not value:
                    continue
                if not typed:
                    lines.append(f"# TYPE {metric} gauge")
                    typed = True
                lines.append(f'{metric}{{model="{name}",{label}="{value}"}} 1')
        return lines

    # -- serving -------------------------------------------------------------

    def start_background(self, port: int = 0) -> int:
        """Serve on a background thread; returns the bound port."""
        self._http = _HTTPServer((self.host, port), self)
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True, name="http-server")
        self._thread.start()
        return self._http.server_address[1]

    def start_grpc(self, port: int = 0) -> int:
        """Serve the open-inference v2 gRPC protocol (serve/grpc_server.py)
        over this server's repository; returns the bound port. Raises
        RuntimeError, naming the packages, when grpcio or protobuf is not
        installed."""
        try:
            import google.protobuf  # noqa: F401
            import grpc  # noqa: F401
        except ImportError as e:
            raise RuntimeError(f"gRPC serving needs the grpcio and protobuf "
                               f"packages: {e}") from e
        from kubeflow_tpu_torch.serve.grpc_server import build_grpc_server

        self._grpc, self.grpc_port = build_grpc_server(self, port)
        self._grpc.start()
        return self.grpc_port

    def stop(self) -> None:
        """Stop serving (gRPC after a 1 s grace, then HTTP), close the
        request log, then unload every model (joins engine threads)."""
        grpc_drained = None
        if self._grpc is not None:
            grpc_drained = self._grpc.stop(grace=1.0)
            self._grpc = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._thread.join(timeout=10.0)
            self._http = None
        # The pool last, after the gRPC grace: in-flight RPCs may still
        # submit to it.
        if grpc_drained is not None:
            grpc_drained.wait(1.5)
        self.executor.shutdown(wait=False, cancel_futures=True)
        if self.request_logger is not None:
            self.request_logger.close()
        self.repo.close()


def start(argv: list[str] | None = None) -> tuple[ModelServer, int]:
    """The command line's server, started in the background: parse
    `argv`, fetch each --storage-uri under $TMPDIR/tpk-models/<i>
    (serve/storage.py; a local directory is served in place), load every
    model and start the HTTP server. Returns (server, bound port)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-dir", action="append", default=[],
                   help="model bundle dir (repeatable; see runtimes.py)")
    p.add_argument("--storage-uri", action="append", default=[],
                   help="uri to materialize, then serve (file://, pvc://, "
                        "an archive, #sha256= pins; repeatable)")
    p.add_argument("--name", action="append", default=[],
                   help="override name for the i-th model")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-inflight", type=int, default=256,
                   help="admitted-request cap before 503 shedding "
                        "(0 disables admission control)")
    p.add_argument("--max-batch-size", type=int, default=32,
                   help="a batcher's flush size, in examples")
    p.add_argument("--max-latency-ms", type=float, default=5.0,
                   help="a batcher's window after its head request")
    p.add_argument("--device", default="cuda")
    p.add_argument("--request-log", default=None,
                   help="JSONL inference request log path")
    p.add_argument("--request-log-mode", default="metadata",
                   choices=["metadata", "all"])
    p.add_argument("--grpc-port", type=int, default=None,
                   help="also serve the v2 open-inference gRPC protocol")
    args = p.parse_args(argv)
    if not args.model_dir and not args.storage_uri:
        p.error("give at least one --model-dir or --storage-uri")
    dirs = list(args.model_dir)
    for i, uri in enumerate(args.storage_uri):
        dirs.append(storage.download(uri, os.path.join(
            tempfile.gettempdir(), "tpk-models", str(i))))
    logger = (RequestLogger(args.request_log, args.request_log_mode)
              if args.request_log else None)
    server = ModelServer(host=args.host, max_inflight=args.max_inflight,
                         device=args.device,
                         max_batch_size=args.max_batch_size,
                         max_latency_ms=args.max_latency_ms,
                         request_logger=logger)
    for i, d in enumerate(dirs):
        name = args.name[i] if i < len(args.name) else None
        model = server.load(d, name=name)
        print(json.dumps({"event": "model_loaded", "name": model.name,
                          "load_time_s": model.load_time_s}), flush=True)
    if args.grpc_port is not None:
        # Before HTTP: a replica never serves HTTP alone as if gRPC were up.
        bound = server.start_grpc(args.grpc_port)
        print(json.dumps({"event": "grpc_serving", "port": bound}),
              flush=True)
    port = server.start_background(args.port)
    print(json.dumps({"event": "serving", "port": port}), flush=True)
    return server, port


def main(argv: list[str] | None = None) -> int:
    server, _ = start(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
