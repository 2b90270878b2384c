"""OpenAI-compatible serving surface (completions + chat), under /openai.

The port of `kubeflow_tpu/serve/openai_api.py` onto the port's server
(serve/server.py), in front of the generation engine:

  POST /openai/v1/completions        {"model", "prompt", ...}
  POST /openai/v1/chat/completions   {"model", "messages": [...], ...}
  GET  /openai/v1/models

Both POST surfaces support "stream": true as server-sent events
(`data: {...}\n\n`, terminated by `data: [DONE]\n\n`) riding the engine's
chunk-granular streaming, and `stop` sequences (text-level truncation —
the engine decodes on; vLLM stops the sampler, we stop the surface).
Chat prompts use the model tokenizer's chat template when it has one,
else a plain role-prefixed transcript. Errors, sheds included, use the
OpenAI error envelope. The namespace is prefixed (/openai) so the v1
protocol keeps /v1/models. Bodies are the JAX surface's field for field.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any

from kubeflow_tpu_torch.serve.generation import KVCapacityExceeded
from kubeflow_tpu_torch.serve.server import HTTPError, Route, Surface


class _OpenAISurface(Surface):
    """The OpenAI error envelope: SDK clients parse error.message and
    error.type, not a bare string."""

    def error_body(self, status: int, message: str) -> dict:
        return {"error": {
            "message": message, "type": ("invalid_request_error"
                                         if status < 500
                                         else "internal_error"),
            "code": status}}

    def shed_body(self) -> dict:
        return {"error": {
            "message": "server overloaded: admission queue full",
            "type": "overloaded_error", "code": 503}}

    def capacity_body(self, message: str) -> dict:
        return {"error": {"message": message, "type": "overloaded_error",
                          "code": 503}}


OPENAI = _OpenAISurface()


def _lookup(h, name):
    try:
        return h.repo.get(name)
    except HTTPError:
        return None  # repo.get 404s on unknown names


def _adapters_of(model) -> list:
    eng = getattr(model, "engine", None)
    if eng is None or not hasattr(eng, "adapter_names"):
        return []
    return eng.adapter_names()


def _adapter_owners(h, adapter_name: str) -> list:
    """Loaded models that carry an adapter of this name."""
    out = []
    for n in h.repo.names():
        m = _lookup(h, n)
        if m is not None and adapter_name in _adapters_of(m):
            out.append(m)
    return out


def _generative(h, name: str):
    """Resolve an OpenAI model id to (model, adapter | None). The vLLM
    multi-LoRA convention: a loaded LoRA adapter's name is a servable model
    id — "<base>:<adapter>", or the bare adapter name when unambiguous —
    routed to the base engine with that adapter selected per request (its
    engine's `adapters`, serve/multilora.py). A bare name resolves to a
    registered model first; an engine without adapters resolves none."""
    model = _lookup(h, name or "")
    adapter = None
    if model is None and name:
        base_name, _, ad = name.partition(":")
        if ad:
            cand = _lookup(h, base_name)
            if cand is not None and ad in _adapters_of(cand):
                model, adapter = cand, ad
        else:
            hits = _adapter_owners(h, name)
            if len(hits) == 1:
                model, adapter = hits[0], name
            elif len(hits) > 1:
                raise HTTPError(
                    400, f"adapter name {name!r} is ambiguous (loaded on "
                         "multiple models); use '<base>:<adapter>'")
    if model is None:
        raise HTTPError(404, f"model {name!r} not found")
    if getattr(model, "generate", None) is None:
        raise HTTPError(400, f"model {name!r} is not generative")
    return model, adapter


def _payload_from(body: dict) -> dict:
    if body.get("n", 1) != 1:
        raise HTTPError(400, "n > 1 is not supported")
    payload: dict[str, Any] = {
        "max_tokens": int(body.get("max_tokens", 16)),
        "temperature": float(body.get("temperature", 1.0)),
        "top_p": float(body.get("top_p", 1.0)),
    }
    if body.get("top_k") is not None:  # common extension
        payload["top_k"] = int(body["top_k"])
    return payload


def _stop_list(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if (not isinstance(stop, list) or len(stop) > 4
            or not all(isinstance(s, str) and s for s in stop)):
        raise HTTPError(400, "stop must be a non-empty string or up to 4 "
                             "of them")
    return stop


def _truncate_at_stop(text: str, stops: list[str]) -> tuple[str, bool]:
    """(text up to the earliest stop sequence — excluded, per OpenAI —
    and whether one matched)."""
    cut = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (cut < 0 or i < cut):
            cut = i
    return (text[:cut], True) if cut >= 0 else (text, False)


def _chat_ids_or_text(model, messages: list) -> dict:
    """messages -> generate payload. HF tokenizers with a chat template
    render it; otherwise a plain role-prefixed transcript with a trailing
    assistant cue."""
    if (not isinstance(messages, list) or not messages
            or not all(isinstance(m, dict) for m in messages)):
        raise HTTPError(400, "messages must be a non-empty array of objects")
    tok = getattr(model, "tokenizer", None)
    if hasattr(tok, "apply_chat_template") and getattr(
            tok, "chat_template", None):
        ids = tok.apply_chat_template(messages, tokenize=True,
                                      add_generation_prompt=True)
        return {"input_ids": list(ids)}
    text = "\n".join(
        f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages)
    return {"text": text + "\nassistant:"}


def _finish_reason(out: dict, max_tokens: int, stopped: bool) -> str:
    if stopped:
        return "stop"
    return "length" if out.get("num_output_tokens", 0) >= max_tokens \
        else "stop"


def _token_strings(model, ids: list) -> list[str]:
    """Byte-faithful per-token strings: multi-byte UTF-8 split across
    byte tokens must stay identifiable (OpenAI renders such tokens as
    bytes:0x..), and special tokens must not vanish — so NOT the
    skip-special full decode."""
    tok = getattr(model, "tokenizer", None)
    if tok == "bytes":
        return [chr(t) if 32 <= t < 127 else
                (f"bytes:{t:#04x}" if 0 <= t < 256 else str(t))
                for t in ids]
    if hasattr(tok, "convert_ids_to_tokens"):
        return [str(s) for s in tok.convert_ids_to_tokens(ids)]
    if hasattr(tok, "decode"):
        return [tok.decode([t]) for t in ids]
    return [str(t) for t in ids]


def _usage(out: dict) -> dict:
    p = out.get("num_input_tokens", 0)
    c = out.get("num_output_tokens", 0)
    return {"prompt_tokens": p, "completion_tokens": c,
            "total_tokens": p + c}


class _Completions:
    """POST /openai/v1/completions; `_Chat` overrides the per-surface
    parts."""

    object_name = "text_completion"

    def make_payload(self, model, body: dict) -> dict:
        prompt = body.get("prompt")
        if isinstance(prompt, list) and prompt and all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in prompt):
            return {"input_ids": prompt}
        if isinstance(prompt, list) and len(prompt) == 1 and isinstance(
                prompt[0], str):
            prompt = prompt[0]
        if isinstance(prompt, str):
            return {"text": prompt}
        raise HTTPError(400, "prompt must be a string or a token-id array")

    def choice(self, out_text, finish, lp=None):
        return {"index": 0, "text": out_text, "logprobs": lp,
                "finish_reason": finish}

    def logprobs_obj(self, model, out):
        return {"tokens": _token_strings(model, out.get("output_ids", [])),
                "token_logprobs": out.get("output_logprobs", []),
                "top_logprobs": None, "text_offset": None}

    def wants_logprobs(self, body):
        # Legacy completions semantics: logprobs is an int, and 0 is a
        # VALID request (chosen-token logprobs, zero alternatives).
        return body.get("logprobs") is not None

    def delta_choice(self, delta, first, finish):
        return {"index": 0, "text": delta, "logprobs": None,
                "finish_reason": finish}

    def __call__(self, h) -> None:
        body = h.body_json()
        name = body.get("model", "")
        model, adapter = _generative(h, name)
        stops = _stop_list(body)
        if stops and getattr(model, "tokenizer", None) is None:
            raise HTTPError(400, "stop sequences need a tokenizer-bundled "
                                 "model")
        try:
            payload = {**self.make_payload(model, body),
                       **_payload_from(body)}
            if adapter is not None:
                payload["adapter"] = adapter
        except HTTPError:
            raise
        except (TypeError, ValueError) as e:
            # Malformed fields (max_tokens: "abc", temperature: null, ...)
            # are the client's fault: 400 invalid_request_error.
            raise HTTPError(400, f"invalid request field: {e}") from None
        deadline = h.request_deadline()
        if deadline is not None:
            # In-process deadline propagation, as on :generate: the engine
            # frees the decode slot at expiry.
            payload["_deadline"] = deadline
        # The payload is rebuilt from whitelisted fields, so a wire
        # "_trace" cannot ride in: the engine's spans carry X-Request-Id.
        payload["_trace"] = h.trace_id
        rid = f"{'chatcmpl' if 'chat' in self.object_name else 'cmpl'}-" \
              f"{uuid.uuid4().hex[:24]}"
        t0 = time.monotonic()
        if body.get("stream"):
            if self.wants_logprobs(body):
                raise HTTPError(400, "logprobs with stream is not supported")
            self._stream(h, name, model, payload, rid, stops, t0)
            return
        try:
            out = h.run_bounded(model.generate, payload)
        except KVCapacityExceeded as e:
            # The native shed, in the OpenAI envelope.
            h.write_capacity_shed(str(e))
            return
        except NotImplementedError:
            raise
        except (ValueError, RuntimeError) as e:
            raise HTTPError(400, str(e)) from None
        text, stopped = _truncate_at_stop(out.get("text", ""), stops)
        finish = _finish_reason(out, payload["max_tokens"], stopped)
        # Chosen-token logprobs on request (no top-N alternatives; with
        # stop truncation the list covers every sampled token, which may
        # extend past the text cut).
        lp = (self.logprobs_obj(model, out)
              if self.wants_logprobs(body) else None)
        h.app.observe(name, out.get("num_output_tokens", 0),
                      time.monotonic() - t0)
        h.write_json({
            "id": rid, "object": self.object_name,
            "created": int(time.time()), "model": name,
            "choices": [self.choice(text, finish, lp)],
            "usage": _usage(out),
        })

    def _stream(self, h, name, model, payload, rid, stops, t0):
        it = model.generate_stream(payload)
        base = {"id": rid, "object": self.object_name + ".chunk",
                "created": int(time.time()), "model": name}
        # With stop sequences, text goes out through a pending buffer that
        # always withholds the last max(len(stop))-1 chars: a stop spanning
        # chunk boundaries can still be excluded (sent text cannot be
        # retracted), and each search scans only the bounded buffer.
        hold = max((len(s) for s in stops), default=1) - 1
        pending = ""
        tokens_out = 0
        stopped = False

        def sse(obj) -> str:
            return "data: " + json.dumps(obj) + "\n\n"

        def emit_text(delta: str, final: bool) -> str:
            nonlocal pending, stopped
            if not stops:
                return delta
            pending += delta
            whole, hit = _truncate_at_stop(pending, stops)
            if hit:
                pending, stopped = "", True
                return whole
            if final:
                out, pending = pending, ""
                return out
            keep = min(hold, len(pending))
            out = pending[:len(pending) - keep] if keep else pending
            pending = pending[len(pending) - keep:] if keep else ""
            return out

        def render(ev, first):
            nonlocal tokens_out
            frames = ""
            done = bool(ev.get("done"))
            delta = emit_text(ev.get("text_delta", ""), done)
            tokens_out += len(ev.get("tokens", ()))
            if delta:
                frames += sse({**base, "choices": [
                    self.delta_choice(delta, first, None)]})
            elif first and not done:
                frames += sse({**base, "choices": [
                    self.delta_choice("", True, None)]})
            if done or stopped:
                finish = _finish_reason(ev if done else {},
                                        payload["max_tokens"], stopped)
                frames += sse({**base, "usage": _usage(ev) if done else None,
                               "choices": [self.delta_choice("", False,
                                                             finish)]})
                frames += "data: [DONE]\n\n"
                return frames, True
            return frames, False

        def render_error(msg):
            return "data: " + json.dumps({"error": {
                "message": msg, "type": "internal_error"}}) + "\n\n"

        streamed = h.pump_stream(it, "text/event-stream", render,
                                 render_error,
                                 (("Cache-Control", "no-cache"),))
        if stopped:
            it.close()  # stop consuming; the engine finishes on its own
        if streamed:
            h.app.observe(name, tokens_out, time.monotonic() - t0)


class _Chat(_Completions):
    object_name = "chat.completion"

    def make_payload(self, model, body: dict) -> dict:
        return _chat_ids_or_text(model, body.get("messages"))

    def choice(self, out_text, finish, lp=None):
        c = {"index": 0, "finish_reason": finish,
             "message": {"role": "assistant", "content": out_text}}
        if lp is not None:
            c["logprobs"] = lp
        return c

    def logprobs_obj(self, model, out):
        toks = _token_strings(model, out.get("output_ids", []))
        # bytes/top_logprobs are part of the chat schema: strict SDK
        # consumers construct models from these keys.
        return {"content": [
            {"token": s, "logprob": lp, "bytes": None, "top_logprobs": []}
            for s, lp in zip(toks, out.get("output_logprobs", []))]}

    def wants_logprobs(self, body):
        return bool(body.get("logprobs"))

    def delta_choice(self, delta, first, finish):
        d: dict = {"content": delta} if delta else {}
        if first:
            d["role"] = "assistant"
        return {"index": 0, "delta": d, "finish_reason": finish}


def _models(h) -> None:
    data = []
    for n in h.repo.names():
        data.append({"id": n, "object": "model", "owned_by": "tpukit"})
        # LoRA adapters list as servable models (vLLM convention).
        for ad in _adapters_of(_lookup(h, n)):
            data.append({"id": f"{n}:{ad}", "object": "model",
                         "owned_by": "tpukit", "parent": n})
    h.write_json({"object": "list", "data": data})


def routes() -> list[Route]:
    # The generative routes pass the same admission gate as the native
    # data plane: the facade is no side door around --max-inflight.
    return [
        Route("POST", r"/openai/v1/completions", _Completions(),
              gated=True, surface=OPENAI),
        Route("POST", r"/openai/v1/chat/completions", _Chat(), gated=True,
              surface=OPENAI),
        Route("GET", r"/openai/v1/models", _models, surface=OPENAI),
    ]
