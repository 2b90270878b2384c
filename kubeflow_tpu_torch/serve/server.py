"""HTTP model server for the generative surface, on the standard library.

The port of the generative part of `kubeflow_tpu/serve/server.py` onto
`http.server.ThreadingHTTPServer` (one thread per connection; the engine
does its own batching across them):

    GET  /v2/health/live | /v2/health/ready
    GET  /v1/models                      {"models": [...]}
    GET  /v2/models/{name}               model metadata
    POST /v1/models/{name}:generate      {"input_ids": [...], "max_tokens",
                                          "temperature", "top_k", "top_p",
                                          "eos_id"}

Responses and request keys match the JAX server's :generate. Bad requests
get 400, unknown models 404, features this package does not port 501, and
a request the paged KV pool can never hold 503 with `Retry-After: 1` (a
shed, as in the JAX server: the request is valid, the pool too small).

Run: python -m kubeflow_tpu_torch.serve.server --model-dir DIR --name NAME
     --port 8080 --device cuda
"""

from __future__ import annotations

import argparse
import json
import re
import signal
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubeflow_tpu_torch.serve.generation import KVCapacityExceeded
from kubeflow_tpu_torch.serve.model import Model
from kubeflow_tpu_torch.serve.runtimes import load_model

#: The JAX server's request-deadline header; deadlines are not ported.
DEADLINE_HEADER = "X-Request-Timeout-Ms"

_GENERATE = re.compile(r"^/v1/models/([^/:]+):generate$")
_MODEL = re.compile(r"^/v2/models/([^/:]+)$")


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Handler(BaseHTTPRequestHandler):
    server: "_HTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # keep request logs off stderr
        pass

    def _send(self, status: int, obj, headers=()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _model(self, name: str) -> Model:
        model = self.server.models.get(name)
        if model is None:
            raise _HTTPError(404, f"model {name!r} not found")
        return model

    def _dispatch(self, route) -> None:
        headers = ()
        try:
            status, obj = route()
        except _HTTPError as e:
            status, obj = e.status, {"error": str(e)}
        except NotImplementedError as e:
            status, obj = 501, {"error": str(e)}
        except KVCapacityExceeded as e:  # before RuntimeError: a shed
            status, obj = 503, {"error": str(e)}
            headers = (("Retry-After", "1"),)
        except (ValueError, RuntimeError) as e:
            status, obj = 400, {"error": str(e)}
        except Exception:  # the server keeps serving; the caller sees why
            status, obj = 500, {"error": traceback.format_exc()}
        self._send(status, obj, headers)

    def do_GET(self):
        self._dispatch(self._get)

    def do_POST(self):
        self._dispatch(self._post)

    def _get(self):
        path = self.path.split("?", 1)[0]
        models = self.server.models
        if path == "/v2/health/live":
            return 200, {"live": True}
        if path == "/v2/health/ready":
            if not models or not all(m.ready for m in models.values()):
                raise _HTTPError(503, "not ready")
            return 200, {"ready": True}
        if path == "/v1/models":
            return 200, {"models": sorted(models)}
        m = _MODEL.match(path)
        if m:
            return 200, self._model(m.group(1)).metadata()
        raise _HTTPError(404, f"no route {path}")

    def _post(self):
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        m = _GENERATE.match(self.path.split("?", 1)[0])
        if not m:
            raise _HTTPError(404, f"no route {self.path}")
        name = m.group(1)
        model = self._model(name)
        if self.headers.get(DEADLINE_HEADER) is not None:
            raise NotImplementedError(
                f"request deadlines ({DEADLINE_HEADER}) are not supported "
                "by this package yet")
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise _HTTPError(400, f"bad JSON: {e}") from None
        if not isinstance(body, dict):
            raise _HTTPError(400, "request body must be a JSON object")
        gen = getattr(model, "generate", None)
        if gen is None:
            raise _HTTPError(400, f"model {name!r} is not generative")
        return 200, {"model_name": name, **gen(body)}


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, models: dict):
        super().__init__(addr, _Handler)
        self.models = models


class ModelServer:
    """Holds the loaded models and the HTTP server in front of them."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self.models: dict[str, Model] = {}
        self._http: _HTTPServer | None = None
        self._thread: threading.Thread | None = None

    def register(self, model: Model) -> None:
        self.models[model.name] = model

    def load(self, model_dir: str, name: str | None = None,
             device=None) -> Model:
        """Load a bundle, build its engine, and register it."""
        model = load_model(model_dir, name=name, device=device)
        model.load()
        self.register(model)
        return model

    def start_background(self, port: int = 0) -> int:
        """Serve on a background thread; returns the bound port."""
        self._http = _HTTPServer((self.host, port), self.models)
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True, name="http-server")
        self._thread.start()
        return self._http.server_address[1]

    def stop(self) -> None:
        """Stop serving, then unload every model (joins engine threads)."""
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._thread.join(timeout=10.0)
            self._http = None
        for model in self.models.values():
            model.unload()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-dir", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    server = ModelServer(host=args.host)
    model = server.load(args.model_dir, name=args.name, device=args.device)
    port = server.start_background(args.port)
    print(f"serving {model.name!r} on {args.host}:{port}", flush=True)
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
