"""The OpenAI-compatible routes (/openai/v1/*) of the port's server beside
the JAX server's, on the same weights with the "bytes" tokenizer: the cases
of tests/test_openai_api.py (completions from text and from token ids,
chat, SSE streams, stop sequences streamed and not, bad fields, the models
list and its errors, logprobs and their zero and stream rules). Bodies
match field for field except ids, timestamps and latencies; logprobs
within 1e-4."""

import dataclasses
import json
import urllib.error
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.generation import GenerativeTorchModel
from kubeflow_tpu_torch.serve.server import ModelServer

GEN = {"slots": 2, "max_len": 64, "chunk": 4, "prefill_buckets": (8, 16),
       "tokenizer": "bytes"}
#: Fields that differ between any two responses.
VOLATILE = {"id", "created"}


@pytest.fixture(scope="module")
def bases():
    """(JAX server URL, port server URL), each serving "llm"."""
    from kubeflow_tpu.serve import ModelServer as JServer
    from kubeflow_tpu.serve.generation import GenerativeJAXModel

    jcfg = dataclasses.replace(jl.llama_tiny(), dtype=jnp.float32,
                               num_layers=2)
    tcfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                               num_layers=2)
    jm = jl.Llama(jcfg)
    params = fnn.meta.unbox(
        jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = tl.Llama(tcfg, device="cpu")
    tm.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    jsrv = JServer()
    jsrv.repo.register(GenerativeJAXModel("llm", jm, params, jcfg,
                                          generation=dict(GEN)))
    tsrv = ModelServer()
    tsrv.repo.register(GenerativeTorchModel("llm", tm, generation=dict(GEN)))
    yield (f"http://127.0.0.1:{jsrv.start_background()}",
           f"http://127.0.0.1:{tsrv.start_background(0)}")
    jsrv.stop()
    tsrv.stop()


def _http(method, url, body=None):
    req = urllib.request.Request(url, method=method,
                                 data=json.dumps(body).encode()
                                 if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _sse(url, body):
    req = urllib.request.Request(url, method="POST",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        assert "text/event-stream" in r.headers["Content-Type"]
        raw = r.read().decode()
    events = [ln[len("data: "):] for ln in raw.split("\n\n")
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def _same(got, want, path="") -> None:
    """Field-for-field equality, ids and timestamps aside, floats within
    1e-4 (fp32 on two stacks)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k not in VOLATILE:
                _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-4), path
    else:
        assert got == want, path


def _both(bases, method, path, body=None):
    want = _http(method, bases[0] + path, body)
    got = _http(method, bases[1] + path, body)
    assert got[0] == want[0], (got, want)
    _same(got[1], want[1])
    return got


@pytest.mark.parametrize("body", [
    {"prompt": "hi", "max_tokens": 6, "temperature": 0},
    {"prompt": ["hello"], "max_tokens": 9, "temperature": 0},
    {"prompt": [5, 9, 2], "max_tokens": 4, "temperature": 0},
    {"prompt": "hi", "max_tokens": 20, "temperature": 0, "top_p": 1.0},
], ids=["text", "text_list", "ids", "long"])
def test_completions(bases, body):
    code, out = _both(bases, "POST", "/openai/v1/completions",
                      {"model": "llm", **body})
    assert code == 200 and out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "length"
    u = out["usage"]
    assert u["completion_tokens"] == body["max_tokens"]
    assert u["total_tokens"] == u["prompt_tokens"] + body["max_tokens"]
    assert out["id"].startswith("cmpl-")


def test_chat_completions(bases):
    code, out = _both(
        bases, "POST", "/openai/v1/chat/completions",
        {"model": "llm", "max_tokens": 5, "temperature": 0,
         "messages": [{"role": "system", "content": "be brief"},
                      {"role": "user", "content": "hi"}]})
    assert code == 200 and out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    assert out["id"].startswith("chatcmpl-")


@pytest.mark.parametrize("surface", ["completions", "chat/completions"])
def test_sse_stream(bases, surface):
    body = {"model": "llm", "max_tokens": 6, "temperature": 0,
            "stream": True}
    if surface == "completions":
        body["prompt"] = "hi"
    else:
        body["messages"] = [{"role": "user", "content": "hi"}]
    want = _sse(bases[0] + f"/openai/v1/{surface}", body)
    got = _sse(bases[1] + f"/openai/v1/{surface}", body)
    obj = ("text_completion" if surface == "completions"
           else "chat.completion") + ".chunk"
    assert all(c["object"] == obj for c in got)
    _same(got[-1], want[-1])
    assert got[-1]["usage"]["completion_tokens"] == 6

    def text(chunks):
        if surface == "completions":
            return "".join(c["choices"][0]["text"] for c in chunks)
        return "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)

    assert text(got) == text(want)
    # Greedy: the stream joins to the unstreamed text.
    _, ref = _http("POST", bases[1] + f"/openai/v1/{surface}",
                   {**body, "stream": False})
    choice = ref["choices"][0]
    assert text(got) == choice.get("text", choice.get("message", {}).get(
        "content"))


def test_stop_sequences(bases):
    """Output truncated before the earliest stop, finish_reason "stop",
    streamed and not, on both servers; a two-character stop withheld
    across chunk boundaries."""
    url = "/openai/v1/completions"
    _, ref = _http("POST", bases[0] + url, {"model": "llm", "prompt": "hi",
                                            "max_tokens": 24,
                                            "temperature": 0})
    text = ref["choices"][0]["text"]
    assert len(text) >= 3
    for stop in (text[len(text) // 2], text[len(text) // 2:
                                            len(text) // 2 + 2]):
        expected = text[:text.find(stop)]
        body = {"model": "llm", "prompt": "hi", "max_tokens": 24,
                "temperature": 0, "stop": stop}
        _, out = _both(bases, "POST", url, body)
        assert out["choices"][0]["text"] == expected
        assert out["choices"][0]["finish_reason"] == "stop"
        for base in bases:
            chunks = _sse(base + url, {**body, "stop": [stop],
                                       "stream": True})
            assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
            assert "".join(c["choices"][0]["text"]
                           for c in chunks) == expected


@pytest.mark.parametrize("path,body", [
    ("completions", {"model": "llm", "prompt": "x", "max_tokens": "abc"}),
    ("chat/completions", {"model": "llm", "messages": ["hi"]}),
    ("completions", {"model": "llm", "prompt": [5, "x"]}),
    ("completions", {"model": "llm", "prompt": "x", "temperature": None}),
    ("completions", {"model": "llm", "prompt": "x", "stop": ["a"] * 5}),
    ("completions", {"model": "nope", "prompt": "x"}),
    ("completions", {"model": "llm", "prompt": "x", "n": 3}),
    ("completions", {"model": "llm", "prompt": "hi", "stream": True,
                     "logprobs": 1}),
], ids=["max_tokens", "messages", "prompt", "temperature", "stop", "model",
        "n", "stream_logprobs"])
def test_errors_in_the_openai_envelope(bases, path, body):
    code, out = _both(bases, "POST", f"/openai/v1/{path}", body)
    assert code in (400, 404)
    assert out["error"]["type"] == "invalid_request_error"
    assert out["error"]["code"] == code and out["error"]["message"]


def test_models_list(bases):
    code, out = _both(bases, "GET", "/openai/v1/models")
    assert code == 200 and out["data"] == [
        {"id": "llm", "object": "model", "owned_by": "tpukit"}]


@pytest.mark.parametrize("path,body", [
    ("completions", {"prompt": "hi", "max_tokens": 5, "logprobs": 1}),
    ("completions", {"prompt": "hi", "max_tokens": 3, "logprobs": 0}),
    ("chat/completions", {"max_tokens": 3, "logprobs": True,
                          "messages": [{"role": "user", "content": "hi"}]}),
], ids=["completions", "zero", "chat"])
def test_logprobs(bases, path, body):
    code, out = _both(bases, "POST", f"/openai/v1/{path}",
                      {"model": "llm", "temperature": 0, **body})
    assert code == 200
    lp = out["choices"][0]["logprobs"]
    if path == "completions":
        assert len(lp["token_logprobs"]) == body["max_tokens"]
        assert all(-30 < v <= 0.0 for v in lp["token_logprobs"])
        # Byte-faithful token strings: never a bare U+FFFD.
        assert all("�" not in t for t in lp["tokens"])
    else:
        content = lp["content"]
        assert len(content) == 3
        assert all(c["logprob"] <= 0.0 and c["top_logprobs"] == []
                   and "bytes" in c for c in content)
