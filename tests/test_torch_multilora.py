"""Multi-LoRA serving on the port (serve/multilora.py, the adapter path of
models/llama.py and serve/generation.py) against the JAX package, in fp32
on the CPU, with two adapters `peft` writes over one tiny HF Llama: "ada"
(rank 4, q/v) and "adb" (rank 2, q/v and the MLP), so the stacks pad
ranks and zero-fill projections. The stacks equal the JAX stacks; the
forward with per-row adapters matches the JAX model's (1e-5) and a base
row is bit-equal to the model without adapters; every request's greedy
ids equal the JAX engine's, in a mixed concurrent batch, at depth 1 and 2,
flat and paged; then the rejections, adapters as OpenAI model ids, runtime
bundles (relative adapter dirs, int8 weights against the JAX engine, the
registry format), `adapter_requests` and a stream with an adapter. (The
JAX file's prefix-cache case is in tests/test_torch_prefix_cache.py.)"""

import copy
import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import peft
import pytest
import torch
import transformers
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.models import llama as jl
from kubeflow_tpu.serve import multilora as jml
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.serve import multilora as tml
from kubeflow_tpu_torch.serve.generation import (GenerationEngine,
                                                 GenerativeTorchModel)

ENGINE = dict(slots=2, max_len=32, chunk=4, prefill_buckets=(4, 8))
# (prompt, adapter): a 12-token prompt admits through prefill + extend.
REQUESTS = [([7, 3, 11], None), ([7, 3, 11], "ada"), ([7, 3, 11], "adb"),
            (list(range(2, 14)), "adb"), (list(range(2, 14)), None),
            ([9, 2, 7, 5], "ada")]
MAX_TOKENS = 6
JAX_TOL = dict(atol=1e-5, rtol=1e-5)


def _adapter(root, model, name, seed, targets, r):
    torch.manual_seed(seed)
    lcfg = peft.LoraConfig(r=r, lora_alpha=8, target_modules=list(targets),
                           lora_dropout=0.0, bias="none",
                           task_type="CAUSAL_LM")
    pm = peft.get_peft_model(copy.deepcopy(model), lcfg)
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_" in n:
                p.copy_(torch.randn_like(p) * 0.08)
    pm.eval()
    d = str(root / name)
    pm.save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("multilora")
    torch.manual_seed(31)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        attn_implementation="eager")).eval()
    base = str(root / "base")
    model.save_pretrained(base, safe_serialization=True)
    dirs = {"ada": _adapter(root, model, "ada", 101, ("q_proj", "v_proj"), 4),
            "adb": _adapter(root, model, "adb", 202,
                            ("q_proj", "v_proj", "gate_proj", "up_proj",
                             "down_proj"), 2)}
    return base, dirs


def _jax_base(base):
    return jh.import_llama(base, dtype=jnp.float32, param_dtype=jnp.float32,
                           remat=False, attention_impl="naive")


def _port_model(base):
    cfg, sd = th.import_llama(base, dtype="float32")
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module")
def jax_ids(setup):
    """Each request's greedy ids from one JAX engine with both adapters."""
    from kubeflow_tpu.serve.generation import GenerationEngine as JEngine

    base, dirs = setup
    cfg, params = _jax_base(base)
    eng = JEngine(jl.Llama(cfg), params, cfg, adapters=dirs, **ENGINE)
    try:
        return [list(eng.submit(p, max_tokens=MAX_TOKENS, temperature=0.0,
                                adapter=ad)["output_ids"])
                for p, ad in REQUESTS]
    finally:
        eng.close()


def test_stacks_equal_jax(setup):
    base, dirs = setup
    cfg = _port_model(base).cfg
    stacks, ids = tml.build_adapter_stacks(dirs, cfg)
    jstacks, jids = jml.build_adapter_stacks(dirs, _jax_base(base)[0])
    assert ids == jids == {"ada": 1, "adb": 2}
    assert sorted(stacks) == sorted(jstacks) == sorted(
        ["q_proj", "v_proj", "gate_proj", "up_proj", "down_proj"])
    for m, ab in stacks.items():
        ja, jb = np.asarray(jstacks[m]["a"]), np.asarray(jstacks[m]["b"])
        assert torch.equal(ab["a"], torch.from_numpy(ja))
        assert torch.equal(ab["b"], torch.from_numpy(
            jb.reshape(*jb.shape[:3], -1)))
        assert not ab["a"][:, 0].any() and not ab["b"][:, 0].any()  # base
        # adb has rank 2 of the widest 4: its padded rank is zero.
        assert not ab["a"][:, 2, :, 2:].any() and not ab["b"][:, 2, 2:].any()
    for m in ("gate_proj", "up_proj", "down_proj"):  # ada leaves them
        assert not stacks[m]["a"][:, 1].any()
    # alpha/r folded into b: adb's alpha 8 over rank 2.
    raw = th.load_safetensors(os.path.join(dirs["adb"],
                                           "adapter_model.safetensors"))
    b0 = next(v for k, v in raw.items()
              if "layers.0.mlp.down_proj.lora_B" in k)
    assert torch.equal(stacks["down_proj"]["b"][0, 2, :2], b0.T * 4.0)
    assert tml.stack_bytes(stacks) == sum(
        t.numel() * 4 for ab in stacks.values() for t in ab.values())


def test_forward_with_adapters_matches_jax(setup):
    """Per-row adapters in one batch: ids (0, ada, adb) — the port's
    logits against the JAX Llama's with the same stacks; the base row
    bit-equal to the model without adapters, and stacks with gathered
    rows (`adapter_rows`) equal to stacks with ids."""
    base, dirs = setup
    model = _port_model(base)
    stacks, _ = tml.build_adapter_stacks(dirs, model.cfg)
    jcfg, params = _jax_base(base)
    jstacks, _ = jml.build_adapter_stacks(dirs, jcfg)
    toks = np.random.default_rng(2).integers(0, 256, (3, 9))
    ids = np.array([0, 1, 2])
    with torch.no_grad():
        got = model(torch.from_numpy(toks), adapter=stacks,
                    adapter_ids=torch.from_numpy(ids))
        rows = tl.adapter_rows(stacks, torch.from_numpy(ids), torch.float32)
        again = model(torch.from_numpy(toks), adapter=rows)
        plain = model(torch.from_numpy(toks))
    ref = jl.Llama(jcfg).apply({"params": params},
                               jnp.asarray(toks, jnp.int32), adapter=jstacks,
                               adapter_ids=jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **JAX_TOL)
    assert torch.equal(got, again)
    assert torch.equal(got[0], plain[0])
    assert (got[1:] - plain[1:]).abs().max() > 1e-2
    with pytest.raises(ValueError, match="adapter_ids"):
        model(torch.from_numpy(toks), adapter=rows,
              adapter_ids=torch.from_numpy(ids))


def _run_all(engine, requests, **kw):
    """Submit every request at once; their results in order."""
    results = [None] * len(requests)

    def run(i):
        prompt, ad = requests[i]
        try:
            results[i] = engine.submit(prompt, max_tokens=MAX_TOKENS,
                                       adapter=ad, **kw)
        except Exception as e:  # asserted below
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, res in enumerate(results):
        assert isinstance(res, dict), f"request {i}: {res!r}"
    return results


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_mixed_batch_ids_equal_the_jax_engine(setup, jax_ids, depth, paged):
    """Six concurrent requests (base, ada, adb, a long prompt under adb and
    as base) on two slots: each one's greedy ids equal the JAX engine's."""
    base, dirs = setup
    kw = dict(ENGINE, pipeline_depth=depth)
    if paged:
        kw.update(kv_block_size=4)
    engine = GenerationEngine(_port_model(base), adapters=dirs, **kw)
    try:
        results = _run_all(engine, REQUESTS)
        assert [r["output_ids"] for r in results] == jax_ids
        stats = engine.stats_snapshot()
        assert stats["adapter_requests"] == {"ada": 2, "adb": 2}
        assert stats["requests"] == len(REQUESTS)
        assert engine.adapter_names() == ["ada", "adb"]
        if paged:
            assert engine.kv_info()["blocks_used"] == 0
        if depth == 2:
            assert stats["decode_fetch_overlapped"] > 0
    finally:
        engine.close()


def test_adapters_change_the_ids(jax_ids):
    assert jax_ids[1] != jax_ids[0] and jax_ids[2] != jax_ids[0]
    assert jax_ids[3] != jax_ids[4]


def test_engine_without_adapters_equals_base_rows(setup, jax_ids):
    """A base-only engine gives the base requests' ids: the base rows of
    the mixed batch above are those of an engine that has no adapters."""
    base, _ = setup
    engine = GenerationEngine(_port_model(base), **ENGINE)
    try:
        base_reqs = [(p, None) for p, ad in REQUESTS if ad is None]
        got = [r["output_ids"] for r in _run_all(engine, base_reqs)]
        assert got == [ids for ids, (_, ad) in zip(jax_ids, REQUESTS)
                       if ad is None]
        assert "adapter_requests" not in engine.stats_snapshot()
        assert engine.adapter_names() == []
    finally:
        engine.close()


#: aten ops one decode chunk dispatches on an adapter-free engine (chunk
#: 4, 2 rows, a 64-row bucket, 2 layers of bf16 llama_tiny): the count the
#: engine had before it served adapters (tests/test_torch_gpu_kernels.py
#: holds it on the card).
DECODE_CHUNK_OPS = 964


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _chunk_ops(engine, rows=None):
    args = [torch.tensor([5, 7]), torch.tensor([3, 9]), torch.zeros(2),
            torch.zeros(2, dtype=torch.long), torch.ones(2)]
    with torch.inference_mode(), _OpLog() as log:
        engine._decode[(64, False)](engine._cache, *args, engine._gen, rows)
    return log.ops


def test_adapter_free_decode_chunk_dispatches_what_it_did(tmp_path):
    """No adapters: the chunk's ops are exactly the engine's old ones.
    With adapters: two bmm per adapted projection, layer and step, the
    gather done once outside the chunk."""
    from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter

    model = tl.Llama(dataclasses.replace(tl.llama_tiny(), num_layers=2),
                     device="cpu").init_weights(0)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
    engine = GenerationEngine(model, **kw)
    try:
        assert len(_chunk_ops(engine)) == DECODE_CHUNK_OPS
    finally:
        engine.close()
    dirs = {"a": write_synthetic_adapter(model.cfg, str(tmp_path / "a"), 1,
                                         r=4, targets="attn_mlp")}
    engine = GenerationEngine(model, adapters=dirs, **kw)
    try:
        rows = engine._adapter_rows(np.array([0, 1]))
        ops = _chunk_ops(engine, rows)
        assert ops.count("aten.bmm.default") == 2 * 5 * 2 * 4
        assert "aten.index_select.default" not in ops
    finally:
        engine.close()


def test_rejections(setup, tmp_path):
    base, dirs = setup
    model = _port_model(base)
    engine = GenerationEngine(model, adapters={"ada": dirs["ada"]},
                              **ENGINE)
    try:
        with pytest.raises(ValueError, match="unknown adapter 'nope'"):
            engine.submit([1, 2], adapter="nope")
    finally:
        engine.close()
    noeng = GenerationEngine(model, **ENGINE)
    try:
        with pytest.raises(ValueError, match="no adapters"):
            noeng.submit([1, 2], adapter="ada")
    finally:
        noeng.close()
    with pytest.raises(FileNotFoundError, match="missing"):
        GenerationEngine(model, adapters={"x": str(tmp_path / "missing")},
                         **ENGINE)
    bad = str(tmp_path / "rslora")
    shutil.copytree(dirs["ada"], bad)
    ac = json.load(open(os.path.join(bad, "adapter_config.json")))
    ac["use_rslora"] = True
    json.dump(ac, open(os.path.join(bad, "adapter_config.json"), "w"))
    with pytest.raises(ValueError, match="rslora"):
        GenerationEngine(model, adapters={"x": bad}, **ENGINE)


def _post(url, body):
    req = urllib.request.Request(url, method="POST",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_openai_adapter_as_model_id(setup, jax_ids):
    """'<base>:<adapter>' and the bare adapter name route to the base
    engine with the adapter; /openai/v1/models lists the adapters."""
    from kubeflow_tpu_torch.serve.server import ModelServer

    base, dirs = setup
    srv = ModelServer()
    gm = GenerativeTorchModel("llm", _port_model(base), generation={
        **ENGINE, "adapters": dirs, "tokenizer": "bytes"})
    srv.repo.register(gm)
    port = srv.start_background()
    url = f"http://127.0.0.1:{port}/openai/v1"
    try:
        with urllib.request.urlopen(f"{url}/models", timeout=30) as r:
            data = json.loads(r.read())["data"]
        assert [m["id"] for m in data] == ["llm", "llm:ada", "llm:adb"]
        assert all(m["parent"] == "llm" for m in data[1:])
        body = {"prompt": REQUESTS[1][0], "max_tokens": MAX_TOKENS,
                "temperature": 0}
        outs = {m: _post(f"{url}/completions", {**body, "model": m})
                for m in ("llm", "llm:ada", "ada")}
        text = {m: o["choices"][0]["text"] for m, o in outs.items()}
        assert text["llm:ada"] == text["ada"] != text["llm"]
        expect = bytes(jax_ids[1]).decode("utf-8", errors="replace")
        assert text["ada"] == expect
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/completions", {**body, "model": "llm:nope"})
        assert e.value.code == 404
        assert gm.metadata()["adapters"] == ["ada", "adb"]
    finally:
        srv.stop()


def _hf_bundle(base, dst, **spec):
    shutil.copytree(base, dst)
    with open(os.path.join(dst, "model.json"), "w") as f:
        json.dump({"format": "huggingface",
                   "model_overrides": {"dtype": "float32",
                                       "param_dtype": "float32"}, **spec}, f)
    return str(dst)


def test_runtime_bundle_with_relative_adapter_dirs(setup, jax_ids, tmp_path):
    from kubeflow_tpu_torch.serve.runtimes import load_model

    base, dirs = setup
    d = _hf_bundle(base, tmp_path / "bundle", generative={
        **ENGINE, "adapters": {"ada": "adapters/ada", "adb": dirs["adb"]}})
    shutil.copytree(dirs["ada"], os.path.join(d, "adapters", "ada"))
    model = load_model(d, device="cpu")
    model.load()
    try:
        assert model.metadata()["adapters"] == ["ada", "adb"]
        for (prompt, ad), ids in zip(REQUESTS[:3], jax_ids[:3]):
            out = model.generate({"input_ids": prompt, "max_tokens":
                                  MAX_TOKENS, "adapter": ad})
            assert out["output_ids"] == ids
        stats = model.metadata()["stats"]
        assert stats["adapter_requests"] == {"ada": 1, "adb": 1}
    finally:
        model.unload()


def test_int8_bundle_with_adapters_matches_the_jax_engine(setup, tmp_path):
    """int8 weights and adapters on one bundle: the port's runtime and the
    JAX runtime serve it with the same greedy ids."""
    from kubeflow_tpu.serve.runtimes import load_model as jax_load
    from kubeflow_tpu_torch.serve.runtimes import load_model

    base, dirs = setup
    d = _hf_bundle(base, tmp_path / "q", quantize="int8",
                   generative={**ENGINE, "adapters": dirs})
    prompts = REQUESTS[:4]
    model = load_model(d, device="cpu")
    model.load()
    jmodel = jax_load(d)
    jmodel.load()
    try:
        assert model.quantization["mode"] == "int8"
        for prompt, ad in prompts:
            body = {"input_ids": prompt, "max_tokens": MAX_TOKENS,
                    "adapter": ad}
            assert model.generate(body)["output_ids"] == list(
                jmodel.generate(body)["output_ids"]), (prompt, ad)
    finally:
        model.unload()
        jmodel.unload()


def test_registry_bundle_passes_adapters_through(setup, jax_ids, tmp_path):
    """The torch-registry format hands `adapters` to the engine as given;
    llama_tiny at 2 layers has the tiny HF model's widths."""
    from kubeflow_tpu_torch.serve.runtimes import (export_for_serving,
                                                   load_model)

    base, dirs = setup
    d = export_for_serving(
        str(tmp_path / "r"), model="llama_tiny", params=_port_model(base),
        model_kwargs={"dtype": "float32", "num_layers": 2,
                      "vocab_size": 256, "max_seq_len": 64,
                      "rope_theta": 10000.0},
        extra={"generative": {**ENGINE, "adapters": dirs}})
    model = load_model(d, device="cpu")
    model.load()
    try:
        assert model.metadata()["adapters"] == ["ada", "adb"]
        out = model.generate({"input_ids": REQUESTS[2][0],
                              "max_tokens": MAX_TOKENS, "adapter": "adb"})
        assert out["output_ids"] == jax_ids[2]
    finally:
        model.unload()


def test_stream_with_an_adapter(setup, jax_ids):
    base, dirs = setup
    gm = GenerativeTorchModel("llm", _port_model(base),
                              generation={**ENGINE, "adapters": dirs})
    gm.load()
    try:
        events = list(gm.generate_stream({
            "input_ids": REQUESTS[3][0], "max_tokens": MAX_TOKENS,
            "adapter": "adb"}))
        assert events[-1]["done"] is True
        streamed = [t for ev in events[:-1] for t in ev["tokens"]]
        assert streamed == events[-1]["output_ids"] == jax_ids[3]
        with pytest.raises(ValueError, match="unknown adapter"):
            list(gm.generate_stream({"input_ids": [1], "adapter": "zz"}))
    finally:
        gm.unload()
