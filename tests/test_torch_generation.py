"""Port generation engine: greedy output against the JAX model's uncached
rollout on the same weights, EOS, and seeded sampling (within the port:
the two packages draw different random bits, so sampled ids are never
compared across them)."""

import dataclasses
import json
import os
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jl
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import llama as tl
from kubeflow_tpu_torch.models.convert import llama_params_from_jax
from kubeflow_tpu_torch.serve.generation import (GenerationEngine,
                                                 GenerativeTorchModel,
                                                 sample_tokens)

ENGINE = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def tiny():
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


def ref_greedy(model, params, ids, n, width=64):
    """Uncached full-forward argmax rollout — the decode golden. The input
    is right-padded to a fixed width so one compiled forward serves every
    step; the model is causal, so padding after a position cannot change
    that position's logits."""
    fwd = jax.jit(lambda p, t: model.apply({"params": p}, t))
    toks = list(ids)
    for _ in range(n):
        buf = np.zeros((1, width), np.int32)
        buf[0, :len(toks)] = toks
        logits = fwd(params, jnp.asarray(buf))
        toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
    return toks[len(ids):]


def hf_checkpoint(model, path) -> str:
    """`model`'s weights as a Hugging Face Llama checkpoint (config.json
    and one safetensors file, the port's writer) at `path`."""
    cfg = model.cfg
    os.makedirs(path, exist_ok=True)
    sd = model.state_dict()
    th.save_safetensors({h: sd[n] for h, n in th.llama_hf_names(cfg).items()},
                        os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim,
                   "max_position_embeddings": cfg.max_seq_len,
                   "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
                   "tie_word_embeddings": cfg.tie_embeddings,
                   "attention_bias": False, "torch_dtype": "float32"}, f)
    return str(path)


def test_engine_continuous_batching_matches_jax_rollout(tiny):
    """3 concurrent requests on 2 slots (the third waits for a free slot);
    the 37-token prompt is longer than the largest bucket, so it admits
    through prefill + extend_mid + extend."""
    jm, params, tm = tiny
    engine = GenerationEngine(tm, **ENGINE)
    try:
        prompts = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40))]
        budgets = [6, 9, 5]
        results = [None] * 3

        def run(i):
            results[i] = engine.submit(prompts[i], max_tokens=budgets[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in range(3):
            assert results[i] is not None, f"request {i} did not finish"
            expect = ref_greedy(jm, params, prompts[i], budgets[i])
            assert results[i]["output_ids"] == expect
            assert results[i]["num_output_tokens"] == budgets[i]
            assert len(results[i]["output_logprobs"]) == budgets[i]
        stats = engine.stats_snapshot()
        assert stats["requests"] == 3
        assert stats["prefill_chunks"] == 1 + 1 + 3
        assert engine.throughput() > 0
    finally:
        engine.close()


def test_engine_eos_stops(tiny):
    jm, params, tm = tiny
    engine = GenerationEngine(tm, slots=1, max_len=64, chunk=4,
                              prefill_buckets=(8,))
    try:
        prompt = [5, 9, 2]
        free_run = ref_greedy(jm, params, prompt, 8)
        eos = free_run[2]  # pretend the 3rd generated token is EOS
        out = engine.submit(prompt, max_tokens=8, eos_id=eos)
        assert out["output_ids"] == free_run[:free_run.index(eos) + 1]
    finally:
        engine.close()


def test_seeded_sampling_is_deterministic(tiny):
    _, _, tm = tiny
    outs = []
    for _ in range(2):
        engine = GenerationEngine(tm, seed=7, **ENGINE)
        try:
            outs.append(engine.submit([5, 9, 2, 4], max_tokens=10,
                                      temperature=1.0, top_p=0.9)
                        ["output_ids"])
        finally:
            engine.close()
    assert outs[0] == outs[1]


def test_top_k_draws_stay_in_top_k():
    gen = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((4, 50)).astype(np.float32))
    top = logits.topk(5, dim=-1).indices
    for _ in range(20):
        tok = sample_tokens(logits, torch.full((4,), 2.0), gen,
                            top_k=torch.full((4,), 5), top_p=torch.ones(4))
        assert all(int(tok[r]) in top[r].tolist() for r in range(4))
    greedy = sample_tokens(logits, torch.zeros(4), gen)
    assert greedy.tolist() == logits.argmax(-1).tolist()


def test_engine_rejects_bad_requests(tiny):
    _, _, tm = tiny
    engine = GenerationEngine(tm, **ENGINE)
    try:
        for bad, match in (([], "non-empty"), ([600], "outside"),
                           (list(range(70)), "exceeds max_len")):
            with pytest.raises(ValueError, match=match):
                engine.submit(bad)
        with pytest.raises(ValueError, match="top_p"):
            engine.submit([1, 2], top_p=0.0)
    finally:
        engine.close()


@pytest.mark.parametrize("key,value", [
    ("prefix_cache", 4), ("draft", {"checkpoint": "x"}),
    ("kv_host_tier_blocks", 8),
    ("adapters", {"a": "dir"}), ("mesh", {"tensor": 2}),
    ("role", "decode"),
])
def test_unported_engine_features_are_refused(tiny, key, value, tmp_path):
    jm, params, tm = tiny
    if key == "prefix_cache":
        # The prefix cache is served now: the engine loads and serves, and
        # a repeated prompt hits.
        model = GenerativeTorchModel("m", tm,
                                     generation={**ENGINE, key: value})
        model.load()
        try:
            for _ in range(2):
                out = model.generate({"input_ids": list(range(3, 25)),
                                      "max_tokens": 4})
                assert len(out["output_ids"]) == 4
            stats = model.engine.stats_snapshot()
            assert (stats["prefix_misses"], stats["prefix_hits"]) == (1, 1)
        finally:
            model.unload()
        return
    if key == "draft":
        # Speculative decoding is served now: the bundle's draft loads from
        # its HF checkpoint and the engine speculates (draft = target: every
        # proposal accepted, the greedy ids the rollout's). A missing
        # checkpoint fails as the JAX model's load does; unknown keys are
        # refused before any checkpoint is read.
        from kubeflow_tpu.serve.generation import GenerativeJAXModel

        errors = []
        for make in (lambda g: GenerativeTorchModel("m", tm, generation=g),
                     lambda g: GenerativeJAXModel("m", jm, params, jm.cfg,
                                                  generation=g)):
            with pytest.raises(Exception) as err:
                make({**ENGINE, key: {"checkpoint": str(tmp_path / "x")}}
                     ).load()
            errors.append(type(err.value))
            with pytest.raises(ValueError, match="unknown generative.draft"):
                make({**ENGINE, key: {"checkpoint": str(tmp_path / "x"),
                                      "gama": 4}}).load()
        assert errors[0] is errors[1], errors
        ckpt = hf_checkpoint(tm, tmp_path / "draft")
        model = GenerativeTorchModel("m", tm, generation={
            **ENGINE, key: {"checkpoint": ckpt, "gamma": 3,
                            "model_overrides": {"dtype": "float32"}}})
        model.load()
        try:
            out = model.generate({"input_ids": [5, 9, 2], "max_tokens": 10})
            stats = model.engine.stats_snapshot()
            assert model.metadata()["speculative"] is True
            assert model.draft_info["bytes"] > 0
        finally:
            model.unload()
        assert out["output_ids"] == ref_greedy(jm, params, [5, 9, 2], 10)
        assert stats["spec_dispatches"] > 0
        assert stats["spec_accepted"] == stats["spec_proposed"] > 0
        return
    if key == "kv_host_tier_blocks":
        # Served on a paged engine; without kv_block_size the load fails
        # with the JAX engine's ValueError.
        model = GenerativeTorchModel("m", tm,
                                     generation={**ENGINE, key: value})
        with pytest.raises(ValueError, match="needs the paged KV cache"):
            model.load()
        return
    if key == "role":
        # Disaggregated roles are served now: a role needs the paged pool
        # (the JAX engine's ValueError at load), and a role engine refuses
        # a local generate.
        model = GenerativeTorchModel("m", tm,
                                     generation={**ENGINE, key: value})
        with pytest.raises(ValueError, match="needs the paged KV cache"):
            model.load()
        model = GenerativeTorchModel("m", tm, generation={
            **ENGINE, key: value, "kv_block_size": 8})
        model.load()
        try:
            assert model.metadata()["role"] == value
            with pytest.raises(RuntimeError, match="refuses a local"):
                model.generate({"input_ids": [1, 2], "max_tokens": 2})
        finally:
            model.unload()
        return
    if key == "adapters":
        # Multi-LoRA is served now: an adapter dir that does not exist
        # fails the load by name, never serves the base quietly.
        model = GenerativeTorchModel("m", tm,
                                     generation={**ENGINE, key: value})
        with pytest.raises(FileNotFoundError, match="dir"):
            model.load()
        return
    with pytest.raises(NotImplementedError, match="not supported"):
        GenerativeTorchModel("m", tm, generation={**ENGINE, key: value})


@pytest.mark.parametrize("key,value", [("adapter", "a")])
def test_unported_request_features_are_refused(tiny, key, value):
    """A request's adapter is served now; on an engine without adapters
    it is refused by name (400 at the server), as in JAX."""
    _, _, tm = tiny
    model = GenerativeTorchModel("m", tm, generation=dict(ENGINE))
    model.load()
    try:
        with pytest.raises(ValueError, match="no adapters configured"):
            model.generate({"input_ids": [1, 2], key: value})
    finally:
        model.unload()
