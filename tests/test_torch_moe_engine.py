"""The serving engine on an MoE model against the JAX engine on the CPU,
in fp32, on the same weights (tests/test_torch_moe.py's moe_tiny at
capacity 0.5, so every prefill bucket drops choices and the pad tokens'
claims decide which): flat and paged, pipeline depth 1 and 2, two
requests at once and a prefix-cache hit, greedy ids and counters equal to
the JAX engine's; attention-only multi-LoRA adapters on the MoE base with
ids equal to the JAX engine's; an MoE bundle over the HTTP server."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import pytest

from kubeflow_tpu.serve import generation as jg
from kubeflow_tpu_torch.serve import generation as tg
from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter
from tests.test_torch_moe import pair
from tests.test_torch_rolling_window import _counters, _prompt, _run

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16),
              prefix_cache=4)
STORIES = [(paged, depth) for paged in (False, True) for depth in (1, 2)]


@pytest.fixture(scope="module")
def moe():
    """(JAX module, params on the device, port module): drops at every
    bucket (capacity 0.5 of 8 or 16 tokens)."""
    jmod, params, tmod = pair(capacity_factor=0.5)
    return jmod, jax.tree.map(jnp.asarray, params), tmod


def _story(jmod, params, tmod, **kw):
    """Two requests at once (13 and 5 prompt tokens, 10 and 12 ids), then
    a 21-token prompt and one sharing its first 18 tokens (a hit at the
    16-token boundary, then a continuation chunk), through both engines.
    {side: {"burst", "prefix", "counters"}}."""
    requests = [(_prompt(3, 13), dict(max_tokens=10)),
                (_prompt(4, 5), dict(max_tokens=12))]
    head = _prompt(7, 18)
    sides = {"port": tg.GenerationEngine(tmod, **kw),
             "jax": jg.GenerationEngine(jmod, params, jmod.cfg, **kw)}
    out = {}
    try:
        for side, eng in sides.items():
            out[side] = {
                "burst": _run(eng, requests),
                "prefix": [eng.submit(head + tail, max_tokens=8)[
                    "output_ids"] for tail in ([5, 9, 2], [7, 1])],
                "counters": _counters(eng)}
    finally:
        for eng in sides.values():
            eng.close()
    return out


@pytest.fixture(scope="module", params=STORIES,
                ids=lambda p: f"{'paged' if p[0] else 'flat'}-depth{p[1]}")
def story(request, moe):
    paged, depth = request.param
    kw = dict(ENGINE, pipeline_depth=depth)
    if paged:
        kw["kv_block_size"] = 8
    return _story(*moe, **kw)


def test_engine_ids_match_jax(story):
    assert story["port"]["burst"] == story["jax"]["burst"]
    assert story["port"]["prefix"] == story["jax"]["prefix"]


def test_engine_counters_match_jax(story):
    assert story["port"]["counters"] == story["jax"]["counters"]
    assert story["port"]["counters"]["prefix_hits"] >= 1


def test_attention_adapters_on_moe_match_jax(moe, tmp_path):
    """Two attention-only PEFT adapters over the MoE base, a base row and
    one row under each, on two slots at depth 2: ids equal the JAX
    engine's (whose routed MLP gets no adapter either)."""
    jmod, params, tmod = moe
    dirs = {name: write_synthetic_adapter(tmod.cfg, str(tmp_path / name),
                                          seed, r=4)
            for name, seed in (("ada", 1), ("adb", 2))}
    requests = [(_prompt(5, 9), dict(max_tokens=8)),
                (_prompt(6, 14), dict(max_tokens=8, adapter="ada")),
                (_prompt(8, 6), dict(max_tokens=8, adapter="adb"))]
    kw = dict(ENGINE, prefix_cache=0, pipeline_depth=2)
    sides = {"port": tg.GenerationEngine(tmod, adapters=dirs, **kw),
             "jax": jg.GenerationEngine(jmod, params, jmod.cfg,
                                        adapters=dirs, **kw)}
    try:
        got = {side: _run(eng, requests) for side, eng in sides.items()}
        stats = sides["port"].stats_snapshot()
    finally:
        for eng in sides.values():
            eng.close()
    assert got["port"] == got["jax"]
    assert stats["adapter_requests"] == {"ada": 1, "adb": 1}


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_moe_bundle_serves_over_http(moe, tmp_path):
    """moe_tiny's registry bundle with the test's weights behind the
    port's server: :generate gives the engine's greedy ids, and the model
    is an MoE one."""
    from kubeflow_tpu_torch.models.moe import MoEBlock
    from kubeflow_tpu_torch.serve.runtimes import export_for_serving
    from kubeflow_tpu_torch.serve.server import ModelServer

    _, _, tmod = moe
    export_for_serving(
        str(tmp_path), model="moe_tiny", params=tmod,
        model_kwargs={"dtype": "float32", "capacity_factor": 0.5},
        extra={"generative": dict(ENGINE, prefill_buckets=[8, 16])})
    server = ModelServer()
    model = server.load(str(tmp_path), name="m", device="cpu")
    port = server.start_background(0)
    try:
        prompt = _prompt(3, 13)
        body = _post(f"http://127.0.0.1:{port}/v1/models/m:generate",
                     {"input_ids": prompt, "max_tokens": 6})
        assert isinstance(model.engine.model.layers[0].mlp, MoEBlock)
        engine = tg.GenerationEngine(tmod, **ENGINE)
        try:
            want = engine.submit(prompt, max_tokens=6)["output_ids"]
        finally:
            engine.close()
        assert body["output_ids"] == want
    finally:
        server.stop()
