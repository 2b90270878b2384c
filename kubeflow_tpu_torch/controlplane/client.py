"""The worker's client of the C++ control plane (`cpp/server.cc`).

The port's copy of the part of `kubeflow_tpu/controlplane/client.py` a
training worker uses: one newline-delimited JSON request over the control
plane's unix socket and `post_event`, through which the trainer appends
CheckpointSaved events to its job's event log. One attempt per call, as
the JAX trainer configures its client (`max_attempts=1`); retries,
deadlines and leader redirects come with the SDK's port.
"""

from __future__ import annotations

import json
import re
import socket
from typing import Any

_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9._:-]")
_MAX_TRACE_ID = 128


class ControlPlaneError(RuntimeError):
    pass


class Client:
    """A connection to the control plane's socket, opened on first use."""

    def __init__(self, socket_path: str = "/tmp/tpk.sock",
                 timeout: float = 30.0, trace_id: str | None = None):
        self.socket_path = socket_path
        self.timeout = timeout
        # The caller's trace identity rides on every request, as the JAX
        # client sends it (the server records it in its dispatch trace).
        self.trace_id = (_TRACE_ID_RE.sub("_", trace_id)[:_MAX_TRACE_ID]
                         if trace_id else None)
        self._sock: socket.socket | None = None
        self._buf = b""

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        self._buf = b""

    def request(self, **req: Any) -> dict:
        """Send one request line and read one response line; raises
        ControlPlaneError when the server answers not ok, OSError when
        the socket fails (the connection is then reset)."""
        if self.trace_id:
            req.setdefault("trace", self.trace_id)
        try:
            if self._sock is None:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(self.timeout)
                s.connect(self.socket_path)
                self._sock = s
            self._sock.sendall(json.dumps(req).encode() + b"\n")
            while b"\n" not in self._buf:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ConnectionError(
                        "connection closed by control plane")
                self._buf += chunk
        except OSError:
            # A timeout or half-read leaves request/response pairing
            # undefined on this connection.
            self.close()
            raise
        line, self._buf = self._buf.split(b"\n", 1)
        resp = json.loads(line)
        if not resp.get("ok"):
            raise ControlPlaneError(resp.get("error", "unknown error"))
        return resp

    def post_event(self, name: str, reason: str, message: str = "",
                   type_: str = "Normal", kind: str = "JAXJob") -> None:
        """Append one event to a job's event log."""
        self.request(op="event", kind=kind, name=name, type=type_,
                     reason=reason, message=message)
