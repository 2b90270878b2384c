"""Streaming on the port: the engine's `on_tokens` callback (tokens before
done, joined equal to the output, at depth 1 and 2, flat and paged),
`GenerativeTorchModel.generate_stream` against
`GenerativeJAXModel.generate_stream` on the same weights (greedy ids,
event keys, text deltas that join to the full text, with the "bytes"
tokenizer and with an HF tokenizer built here and loaded through each
package's `load_bundled_tokenizer`), and ndjson over HTTP (chunked framing,
content type, keep-alive after a stream, a mid-stream error frame, clean
400 and 503 before a stream, and a client disconnect that leaves the server
serving)."""

import dataclasses
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import tokenizer_util as jtok
from kubeflow_tpu.serve.generation import GenerativeJAXModel
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve import tokenizer_util as ttok
from kubeflow_tpu_torch.serve.generation import (GenerationEngine,
                                                 GenerativeTorchModel)
from kubeflow_tpu_torch.serve.server import ModelServer
from tests.test_torch_generation import ref_greedy

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
PROMPTS = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40))]
BUDGETS = [9, 6, 5]
POOLS = {"flat": {}, "paged": {"kv_block_size": 8, "kv_blocks": 24}}


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, its fp32 params, the port model on the same weights)."""
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
    return jm, params, tm


@pytest.fixture(scope="module")
def golden(tiny):
    jm, params, _ = tiny
    return [ref_greedy(jm, params, p, b) for p, b in zip(PROMPTS, BUDGETS)]


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_on_tokens_order(tiny, golden, depth, pool):
    """Three concurrent requests on two slots: each callback stream joins
    to the request's output (its first token at depth 2 comes late, from a
    poll or a fetch, and must come exactly once and first), done=True only
    on the last call, and that call lands before submit() returns. Rows of
    chunks dispatched past a request's end never reach its callback."""
    _, _, tm = tiny
    eng = GenerationEngine(tm, pipeline_depth=depth, **ENGINE, **POOLS[pool])
    calls = [[] for _ in PROMPTS]
    results = [None] * len(PROMPTS)

    def run(i):
        def cb(tokens, done):
            calls[i].append((list(tokens), done, results[i] is None))

        results[i] = eng.submit(PROMPTS[i], max_tokens=BUDGETS[i],
                                on_tokens=cb)

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, res in enumerate(results):
            streamed = [t for toks, _, _ in calls[i] for t in toks]
            assert streamed == res["output_ids"] == golden[i]
            assert [d for _, d, _ in calls[i]] == (
                [False] * (len(calls[i]) - 1) + [True])
            assert all(before for _, _, before in calls[i])
        if pool == "paged":
            assert eng.kv_blocks_used == 0
    finally:
        eng.close()


def test_engine_callback_errors_are_swallowed(tiny, golden):
    _, _, tm = tiny
    eng = GenerationEngine(tm, **ENGINE)

    def broken(tokens, done):
        raise RuntimeError("consumer gone")

    try:
        out = eng.submit(PROMPTS[0], max_tokens=BUDGETS[0], on_tokens=broken)
        assert out["output_ids"] == golden[0]
    finally:
        eng.close()


# -- generate_stream against the JAX model ------------------------------------


def _hf_tokenizer_dir(path) -> str:
    """A byte-level BPE tokenizer of the tiny model's vocabulary (512),
    trained here on a short text with multi-byte characters, saved as an HF
    checkpoint's tokenizer files."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    text = ("the quick brown fox jumps over the lazy dog; naïve café "
            "crème brûlée, 東京 and Zürich — ∑ λ → ∞. ") * 20
    tok.train_from_iterator(
        [text], trainers.BpeTrainer(
            vocab_size=512,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=tok).save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def models(tiny, tmp_path_factory):
    """The JAX model wrapper (this file's one JAX engine) and the port's,
    both at depth 2 with the "bytes" tokenizer, and the HF tokenizer as
    each package loads it."""
    jm, params, tm = tiny
    gen = {**ENGINE, "tokenizer": "bytes"}
    jmodel = GenerativeJAXModel("llm", jm, params, jm.cfg, generation=gen)
    tmodel = GenerativeTorchModel("llm", tm, generation=gen)
    jmodel.load()
    tmodel.load()
    d = _hf_tokenizer_dir(tmp_path_factory.mktemp("hf_tok"))
    hf = {"jax": jtok.load_bundled_tokenizer(d, "llm"),
          "port": ttok.load_bundled_tokenizer(d, "llm")}
    assert hf["jax"] is not None and hf["port"] is not None
    yield jmodel, tmodel, hf
    jmodel.unload()
    tmodel.unload()


@pytest.mark.parametrize("body", [
    {"input_ids": [5, 9, 2], "max_tokens": 11},
    {"text": "naïve café", "max_tokens": 14},
    {"text": "東京", "max_tokens": 7, "eos_id": 3},
], ids=["ids", "text", "text_eos"])
@pytest.mark.parametrize("tokenizer", ["bytes", "hf"])
def test_generate_stream_matches_jax(models, tokenizer, body):
    jmodel, tmodel, hf = models
    if tokenizer == "hf":
        jmodel.tokenizer, tmodel.tokenizer = hf["jax"], hf["port"]
    try:
        want = list(jmodel.generate_stream(dict(body)))
        got = list(tmodel.generate_stream(dict(body)))
    finally:
        jmodel.tokenizer = tmodel.tokenizer = "bytes"
    for events in (want, got):
        assert events[-1]["done"] is True
        assert all(set(ev) == {"tokens", "text_delta"} for ev in events[:-1])
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        assert streamed == events[-1]["output_ids"]
        # Windowed incremental detokenization telescopes exactly.
        assert "".join(ev["text_delta"] for ev in events) == \
            events[-1]["text"]
    assert set(got[-1]) == set(want[-1])
    assert got[-1]["output_ids"] == want[-1]["output_ids"]
    assert got[-1]["text"] == want[-1]["text"]
    assert got[-1]["num_input_tokens"] == want[-1]["num_input_tokens"]
    np.testing.assert_allclose(got[-1]["output_logprobs"],
                               want[-1]["output_logprobs"], atol=1e-4)


def test_generate_text_matches_jax(models):
    jmodel, tmodel, _ = models
    body = {"text": "crème brûlée", "max_tokens": 10}
    want, got = jmodel.generate(dict(body)), tmodel.generate(dict(body))
    assert set(got) == set(want)
    assert got["output_ids"] == want["output_ids"]
    assert got["text"] == want["text"]


# -- ndjson over HTTP ---------------------------------------------------------


@pytest.fixture(scope="module")
def served(models, tiny):
    """The port's model behind the port's server, beside a paged model
    whose pool (4 blocks of 8) cannot hold a 30-token prompt."""
    _, tmodel, _ = models
    _, _, tm = tiny
    small = GenerativeTorchModel("small", tm, generation={
        **ENGINE, "kv_block_size": 8, "kv_blocks": 4})
    small.load()
    server = ModelServer()
    server.register(tmodel)
    server.register(small)
    port = server.start_background(0)
    yield port, tmodel
    server.stop()


def _raw(port, request: bytes, sock=None):
    """Send one request, return (socket, status line, headers, raw body
    bytes up to the chunked terminator or Content-Length)."""
    sock = sock or socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall(request)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(65536)
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.decode().split("\r\n")
    headers = {k.lower(): v.strip() for k, v in
               (ln.split(":", 1) for ln in lines[1:])}
    if headers.get("transfer-encoding") == "chunked":
        while not rest.endswith(b"0\r\n\r\n"):
            rest += sock.recv(65536)
    else:
        n = int(headers["content-length"])
        while len(rest) < n:
            rest += sock.recv(65536)
    return sock, lines[0], headers, rest


def _post(path, body, host="127.0.0.1:0") -> bytes:
    data = json.dumps(body).encode()
    return (f"POST {path} HTTP/1.1\r\nHost: {host}\r\nContent-Type: "
            f"application/json\r\nContent-Length: {len(data)}\r\n\r\n"
            ).encode() + data


def _dechunk(raw: bytes) -> list[bytes]:
    """The chunks of a chunked body; asserts the framing (hex length, CRLF,
    data, CRLF) and the zero-length terminator."""
    chunks = []
    while True:
        size, raw = raw.split(b"\r\n", 1)
        n = int(size, 16)
        if n == 0:
            assert raw == b"\r\n"
            return chunks
        chunks.append(raw[:n])
        assert raw[n:n + 2] == b"\r\n"
        raw = raw[n + 2:]


def test_ndjson_framing_and_keep_alive(served, tiny):
    port, _ = served
    jm, params, _ = tiny
    sock, status, headers, raw = _raw(port, _post(
        "/v1/models/llm:generate",
        {"input_ids": [5, 9, 2], "max_tokens": 10, "stream": True}))
    assert status == "HTTP/1.1 200 OK"
    assert headers["content-type"] == "application/x-ndjson"
    assert "content-length" not in headers
    assert headers["x-request-id"]
    chunks = _dechunk(raw)
    events = [json.loads(c) for c in chunks]
    assert all(c.endswith(b"\n") and c.count(b"\n") == 1 for c in chunks)
    assert all(ev["model_name"] == "llm" for ev in events)
    assert events[-1]["done"] is True and len(events) >= 3
    streamed = [t for ev in events[:-1] for t in ev["tokens"]]
    assert streamed == events[-1]["output_ids"] == ref_greedy(
        jm, params, [5, 9, 2], 10)
    # Keep-alive survives the stream: the next request on this socket.
    _, status, _, raw = _raw(port, _post(
        "/v2/models/llm/generate", {"input_ids": [5, 9, 2],
                                    "max_tokens": 10}), sock)
    assert status == "HTTP/1.1 200 OK"
    assert json.loads(raw)["output_ids"] == streamed
    sock.close()


def _http(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_pre_stream_failures_are_clean_statuses(served):
    port, _ = served
    code, _, body = _http(port, "/v1/models/llm:generate", {"stream": True})
    assert code == 400 and "input_ids" in json.loads(body)["error"]
    code, headers, body = _http(port, "/v1/models/small:generate", {
        "input_ids": list(range(1, 30)), "max_tokens": 8, "stream": True})
    assert code == 503 and headers["Retry-After"] == "1"
    assert "KV blocks" in json.loads(body)["error"]
    code, _, body = _http(port, "/v1/models/llm:generate", {
        "input_ids": [1, 2], "stream": True, "adapter": "a"})
    assert code == 400 and "adapter" in json.loads(body)["error"]


def test_mid_stream_failure_is_a_terminal_error_frame(served):
    """The decode chunk fails after the first token went out: the status
    line is already 200, so the failure is one last {"model_name", "error"}
    frame, and the stream still ends with its terminator."""
    port, tmodel = served
    engine = tmodel.engine
    saved = dict(engine._decode)

    def fail(*args):
        raise RuntimeError("injected decode failure")

    engine._decode.update({k: fail for k in saved})
    try:
        sock, status, _, raw = _raw(port, _post(
            "/v1/models/llm:generate",
            {"input_ids": [5, 9, 2], "max_tokens": 10, "stream": True}))
        sock.close()
    finally:
        engine._decode.update(saved)
    assert status == "HTTP/1.1 200 OK"
    events = [json.loads(c) for c in _dechunk(raw)]
    assert events[0]["tokens"] and "error" not in events[0]
    assert set(events[-1]) == {"model_name", "error"}
    assert "injected decode failure" in events[-1]["error"]


def test_client_disconnect_leaves_the_server_serving(served):
    port, tmodel = served
    before = tmodel.engine.stats_snapshot()["requests"]
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall(_post("/v1/models/llm:generate", {
        "input_ids": [5, 9, 2], "max_tokens": 50, "stream": True}))
    assert sock.recv(64).startswith(b"HTTP/1.1 200")
    sock.close()
    code, _, body = _http(port, "/v1/models/llm:generate",
                          {"input_ids": [7, 1], "max_tokens": 4})
    assert code == 200 and len(json.loads(body)["output_ids"]) == 4
    # The abandoned request was admitted and decoded on (no cancellation).
    t0 = time.monotonic()
    while (tmodel.engine.stats_snapshot()["requests"] < before + 2
           and time.monotonic() - t0 < 30):
        time.sleep(0.01)
    assert tmodel.engine.stats_snapshot()["requests"] == before + 2
