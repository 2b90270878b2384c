"""Request trace identity.

The port's copy of the trace-id helpers of `kubeflow_tpu/utils/obs.py`:
every request carries one id (the caller's `X-Request-Id`, sanitised, or
a fresh one), echoed on its response. Spans and `/debug/trace` are not
ported yet.
"""

from __future__ import annotations

import re
import uuid

_TRACE_ID_RE = re.compile(r"[^A-Za-z0-9._:-]")
_MAX_TRACE_ID = 128


def new_trace_id() -> str:
    """A fresh request/trace id (uuid4 hex — no coordination needed)."""
    return uuid.uuid4().hex


def sanitize_trace_id(raw: str | None) -> str:
    """A caller-supplied id, made safe for logs/exposition: restricted
    charset, bounded length; empty/None gets a fresh id."""
    if not raw:
        return new_trace_id()
    return _TRACE_ID_RE.sub("_", str(raw))[:_MAX_TRACE_ID] or new_trace_id()
