"""T5, Flan-T5 (gated, untied) and UMT5 on the port (models/t5.py,
hf_import.import_t5, serve/text2text.py, serve/quant.quantize_fixed)
against the JAX package, both importing the same HF directory, which the
port's `save_safetensors` writes from weights drawn with numpy
(`t5_hf_names`); `transformers` reads the same directory.

Tolerances (rel-L2, fp32): F32_TOL 1e-5 for the encoder output and the
teacher-forced logits (the same math, fp32 rounding); greedy tokens and
n_valid equal. Int8: codes and scales bit-equal to `quantize_tree`; logits
within F32_TOL of JAX's `QuantizedModule(dtype=float32)` (the same codes
dequantized in fp32) and within INT8_BF16_DEQUANT_TOL 2e-2 of its default,
which rounds each dequantized weight to bf16 before the float matmul.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.models import t5 as jt
from kubeflow_tpu.serve import ModelServer as JaxServer
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu.serve import runtimes as jrt
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models.convert import t5_params_from_jax
from kubeflow_tpu_torch.models import t5 as tt
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.serve.runtimes import load_model
from kubeflow_tpu_torch.serve.server import ModelServer
from kubeflow_tpu_torch.serve.text2text import Text2TextTorchModel

F32_TOL = 1e-5
INT8_BF16_DEQUANT_TOL = 2e-2
TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4,
            relative_attention_num_buckets=8,
            relative_attention_max_distance=16, decoder_start_token_id=0,
            eos_token_id=1)
VARIANTS = {
    "relu-tied": dict(architectures=["T5ForConditionalGeneration"],
                      model_type="t5", feed_forward_proj="relu",
                      tie_word_embeddings=True),
    "gated-untied": dict(architectures=["T5ForConditionalGeneration"],
                         model_type="t5", feed_forward_proj="gated-gelu",
                         tie_word_embeddings=False),
    "umt5": dict(architectures=["UMT5ForConditionalGeneration"],
                 model_type="umt5", feed_forward_proj="gated-gelu",
                 tie_word_embeddings=False),
}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def write_checkpoint(path, hf: dict, seed: int):
    """An HF T5-family dir of `hf`'s widths with numpy-drawn weights
    (`shared`, the tables and an untied head N(0, 1), projections N(0,
    1/fan_in), norm scales 1 + N(0, 0.1)). Returns the port's config."""
    os.makedirs(path, exist_ok=True)
    cfg = th.t5_config_from_hf(hf, dtype="float32")
    rng = np.random.default_rng(seed)
    tensors = {}
    shapes = {k: tuple(v.shape)
              for k, v in tt.T5(cfg, device="cpu").state_dict().items()}
    for port, name in th.t5_hf_names(cfg).items():
        shape = shapes[port]
        if port.endswith(".scale"):
            arr = 1 + rng.normal(0, 0.1, shape)
        elif port.endswith(".table") or port in ("shared", "lm_head.weight"):
            arr = rng.normal(0, 1.0, shape)
        else:
            arr = rng.normal(0, shape[1] ** -0.5, shape)
        tensors[name] = torch.from_numpy(arr.astype(np.float32))
    th.save_safetensors(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return cfg


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("t5")
    out = {}
    for i, (name, arch) in enumerate(VARIANTS.items()):
        d = str(root / name)
        write_checkpoint(d, dict(TINY, **arch), seed=11 + i)
        out[name] = d
    return out


def _models(path, **over):
    cfg, sd = th.build_from_hf(path, dtype="float32", **over)
    model = tt.T5(cfg, device="cpu")
    model.load_state_dict(sd)
    jmod, jcfg, jp = jh.build_from_hf(path, dtype=jnp.float32, **over)
    return model, jmod, jp


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.integers(2, 64, (2, 10))
    dec = rng.integers(2, 64, (2, 6))
    mask = np.ones_like(enc, bool)
    mask[1, 7:] = False
    return enc, dec, mask


@pytest.mark.parametrize("nb,md", [(32, 128), (8, 16)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_equals_jax(nb, md, bidirectional):
    rel = np.arange(-4 * md, 4 * md + 1)
    want = np.asarray(jt.relative_position_bucket(
        jnp.asarray(rel), bidirectional=bidirectional, num_buckets=nb,
        max_distance=md))
    got = tt.relative_position_bucket(
        torch.from_numpy(rel), bidirectional=bidirectional, num_buckets=nb,
        max_distance=md).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encoder_logits_and_greedy_match_jax(ckpts, variant):
    model, jmod, jp = _models(ckpts[variant])
    assert model.cfg.per_layer_rel_bias == (variant == "umt5")
    enc, dec, mask = _inputs(3)
    e, d, m = (torch.from_numpy(a) for a in (enc, dec, mask))
    je, jd, jm_ = (jnp.asarray(enc, jnp.int32), jnp.asarray(dec, jnp.int32),
                   jnp.asarray(mask))
    with torch.no_grad():
        got_enc = model.encode(e, m)
        got = model(e, d, m)
    want_enc = jmod.apply({"params": jp}, je, jm_, method=jt.T5.encode)
    want = jmod.apply({"params": jp}, je, jd, jm_)
    assert rel_l2(got_enc, want_enc) <= F32_TOL
    assert rel_l2(got, want) <= F32_TOL
    arch = transformers.UMT5ForConditionalGeneration if variant == "umt5" \
        else transformers.T5ForConditionalGeneration
    hf = arch.from_pretrained(ckpts[variant]).eval()
    with torch.no_grad():
        ref = hf(input_ids=e, attention_mask=m,
                 decoder_input_ids=d).logits.numpy()
    assert rel_l2(got, ref) <= 1e-4
    toks, n_valid = tt.greedy_generate(model, e, m, max_tokens=8)
    jtoks, jn = jt.greedy_generate(jmod, jp, je, jm_, max_tokens=8)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(jn))
    # The EOS rule: make the third emitted token of row 0 the EOS id.
    eos = int(toks[0, 2])
    model2, jmod2, jp2 = _models(ckpts[variant], eos_id=eos)
    toks2, n2 = tt.greedy_generate(model2, e, m, max_tokens=8)
    jtoks2, jn2 = jt.greedy_generate(jmod2, jp2, je, jm_, max_tokens=8)
    np.testing.assert_array_equal(toks2.numpy(), np.asarray(jtoks2))
    np.testing.assert_array_equal(n2.numpy(), np.asarray(jn2))
    assert int(n2[0]) <= 2 and (toks2[0, int(n2[0]):] == eos).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_params_from_jax_equal_the_hf_import(ckpts, variant):
    """convert.t5_params_from_jax over the flax tree that JAX's importer
    reads from the directory (UMT5's per-layer tables, the untied head)
    gives the port importer's state dict, tensor for tensor; a missing or
    left-over leaf raises."""
    cfg, sd = th.import_t5(ckpts[variant], dtype="float32")
    _, jparams = jh.import_t5(ckpts[variant], dtype=jnp.float32)
    flat = jax.tree.map(np.asarray, jparams)
    got = t5_params_from_jax(flat, cfg)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="not consumed"):
        t5_params_from_jax(dict(flat, stray=np.zeros(3, np.float32)), cfg)
    missing = dict(flat)
    missing.pop("dec_final_ln")
    with pytest.raises(ValueError, match="missing"):
        t5_params_from_jax(missing, cfg)


def _bundle(path, **spec):
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "name": "t5",
                   "model_overrides": {"dtype": "float32"},
                   "generative": {"in_buckets": [8, 16], "max_tokens": 8},
                   **spec}, f)
    return path


def _http(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, method=method, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_text2text_runtime_and_http_match_jax(ckpts):
    """Through load_model on the same bundle: equal ids, JAX's three
    refusals word for word, the metadata keys; then `:generate` over HTTP
    on both servers, `stream: true` a 400 "does not stream", and no engine
    rows in /metrics."""
    path = _bundle(ckpts["gated-untied"])
    jmodel, model = jrt.load_model(path), load_model(path, device="cpu")
    assert isinstance(model, Text2TextTorchModel)
    assert jmodel.load() and model.load()
    enc, _, _ = _inputs(13)
    for ids in (enc[0].tolist(), enc[1, :5].tolist(), list(range(2, 16))):
        for max_tokens in (8, 3):
            body = {"input_ids": ids, "max_tokens": max_tokens}
            got, want = model.generate(body), jmodel.generate(body)
            for key in ("output_ids", "num_input_tokens",
                        "num_output_tokens"):
                assert got[key] == want[key], key
    for body in ({"input_ids": list(range(20))},
                 {"input_ids": [3, 4], "max_tokens": 64},
                 {"input_ids": []}):
        with pytest.raises(ValueError) as port:
            model.generate(body)
        with pytest.raises(ValueError) as ref:
            jmodel.generate(body)
        assert str(port.value) == str(ref.value)
    md, jmd = model.metadata(), jmodel.metadata()
    assert sorted(md) == sorted(jmd)
    assert md["platform"] == "pytorch-cuda"
    assert md["task"] == jmd["task"] == "text2text_generation"
    assert sorted(md["stats"]) == sorted(jmd["stats"])
    assert md["stats"]["requests"] == jmd["stats"]["requests"]

    jsrv, srv = JaxServer(), ModelServer()
    jsrv.repo.register(jmodel)
    srv.repo.register(model)
    bases = [f"http://127.0.0.1:{s.start_background()}" for s in (jsrv, srv)]
    try:
        body = {"input_ids": enc[0].tolist(), "max_tokens": 6}
        (jc, jb), (c, b) = (_http("POST", f"{u}/v1/models/t5:generate",
                                  body) for u in bases)
        assert c == jc == 200
        assert json.loads(b)["output_ids"] == json.loads(jb)["output_ids"]
        (jc, jb), (c, b) = (_http("POST", f"{u}/v1/models/t5:generate",
                                  dict(body, stream=True)) for u in bases)
        assert c == jc == 400
        assert "does not stream" in b and "does not stream" in jb
        (_, jm_), (_, m) = (_http("GET", f"{u}/metrics") for u in bases)
        for text in (m, jm_):
            assert "tpk_engine_" not in text
    finally:
        jsrv.stop()
        srv.stop()
        os.remove(os.path.join(path, "model.json"))


def test_refusals_match_jax(ckpts, tmp_path):
    hf = dict(TINY, **dict(VARIANTS["relu-tied"],
                           feed_forward_proj="gated-silu"))
    with pytest.raises(ValueError) as port:
        th.config_from_hf(hf)
    with pytest.raises(ValueError) as ref:
        jh.t5_config_from_hf(hf)
    assert str(port.value) == str(ref.value)
    # A classic-T5 checkpoint that claims UMT5 fails on the missing
    # per-layer tables, by architecture alone too (a stale model_type).
    d = str(tmp_path / "mislabeled")
    write_checkpoint(d, dict(TINY, **VARIANTS["relu-tied"]), seed=4)
    for mtype in ("umt5", "t5"):
        cfg = json.load(open(f"{d}/config.json"))
        cfg.update(architectures=["UMT5ForConditionalGeneration"],
                   model_type=mtype)
        json.dump(cfg, open(f"{d}/config.json", "w"))
        with pytest.raises(KeyError, match="relative_attention_bias"):
            th.build_from_hf(d)
        with pytest.raises(KeyError, match="relative_attention_bias"):
            jh.build_from_hf(d)
    with pytest.raises(ValueError, match="T5Config has no adapter path"):
        load_model(_bundle(ckpts["relu-tied"], peft_adapter="ada"),
                   device="cpu")
    os.remove(os.path.join(ckpts["relu-tied"], "model.json"))


def test_int8_codes_bit_equal_and_logits_near_jax(tmp_path):
    """quantize_fixed's codes and scales equal quantize_tree's leaf by
    leaf (q/k/v one scale per (head, dim), o over (heads, dim), the FFN
    per output, `shared` per vocab row, an untied head per vocab column);
    the 8 x 4 tables stay float; logits against JAX's QuantizedModule
    (module docstring), and the served int8 bundle decodes."""
    d = str(tmp_path / "q")
    hf = dict(TINY, **VARIANTS["gated-untied"], vocab_size=128, d_model=64,
              d_kv=16, d_ff=128)
    write_checkpoint(d, hf, seed=7)
    model, jmod, jp = _models(d)
    tq.quantize_fixed(model)
    jtree = jq.quantize_tree(jp)

    def same(mod, leaf, rows_first=False):
        assert isinstance(mod, tq.Int8Dense) and isinstance(leaf, jq.Int8Leaf)
        n_out = mod.q.shape[0]
        q = np.asarray(leaf.q)
        q = q.reshape(n_out, -1) if rows_first else q.reshape(-1, n_out).T
        assert np.array_equal(mod.q.numpy(), q)
        assert np.array_equal(mod.scale.numpy(),
                              np.asarray(leaf.scale).reshape(n_out))

    same(model.shared, jtree["shared_embedding"], rows_first=True)
    same(model.lm_head, jtree["lm_head"])
    assert isinstance(model.enc_rel.table, torch.nn.Parameter)
    for i in range(2):
        for stack, jname in (("enc_attn", f"enc_{i}_attn"),
                             ("dec_self", f"dec_{i}_self"),
                             ("dec_cross", f"dec_{i}_cross")):
            for p in ("q", "k", "v", "o"):
                same(getattr(getattr(model, stack)[i], p),
                     jtree[jname][p]["kernel"])
        for stack, jname in (("enc_ffn", f"enc_{i}_ffn"),
                             ("dec_ffn", f"dec_{i}_ffn")):
            for p in ("wi_0", "wi_1", "wo"):
                same(getattr(getattr(model, stack)[i], p),
                     jtree[jname][p]["kernel"])
    enc, dec, mask = _inputs(5)
    enc, dec = enc * 2, dec * 2  # the wider vocab
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (enc, dec, mask)))
    jargs = (jnp.asarray(enc, jnp.int32), jnp.asarray(dec, jnp.int32),
             jnp.asarray(mask))
    # The same codes dequantized in fp32 by JAX: the same function.
    want = jq.QuantizedModule(jmod, dtype=jnp.float32).apply(
        {"params": jtree}, *jargs)
    assert rel_l2(got, want) <= F32_TOL
    # JAX's serving default dequantizes to bf16 first: T5's unscaled
    # scores over N(0, 1) embeddings amplify that rounding past GPT-2's
    # and BERT's (1.15e-2 measured here), so it is held at the bf16 bound.
    want = jq.QuantizedModule(jmod).apply({"params": jtree}, *jargs)
    assert rel_l2(got, want) <= INT8_BF16_DEQUANT_TOL
    served = load_model(_bundle(d, quantize="int8"), device="cpu")
    assert served.metadata()["quantize"]["mode"] == "int8"
    assert served.load()
    out = served.generate({"input_ids": enc[0].tolist()})
    assert len(out["output_ids"]) == out["num_output_tokens"] <= 8
