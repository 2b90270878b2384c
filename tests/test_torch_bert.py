"""BERT and the MNIST MLP on the port (models/bert.py, models/mlp.py,
models/convert.py, hf_import.import_bert, serve/quant.quantize_fixed)
against the JAX package on the same seeded weights and inputs.

Tolerances (rel-L2 of the head output): fp32 1e-5 (same math, fp32
rounding); bf16 2e-2 (the verify skill's bound: the two packages round
the same points but their bf16 kernels accumulate in different orders).
The int8 bundles are held against JAX's `QuantizedModule`: codes and
scales bit-equal to `quantize_tree`, weight bytes equal, and outputs
within INT8_TOL of it. JAX dequantizes each weight to bf16 before a float
matmul; the port feeds the raw codes to the W8A16 op and scales the fp32
output, so in fp32 the two differ by the bf16 rounding of the weights
(2^-9 relative per element, compounding over the layers: 2.1e-3 to
3.5e-3 measured at bert_tiny, 2.5e-3 for the MLP): INT8_TOL_F32 = 5e-3.
At bf16 compute that sits under the bf16 bound (5.5e-3 to 9.4e-3
measured), so INT8_TOL_BF16 = 2e-2.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import flax.linen as nn
from kubeflow_tpu.models import bert as jb
from kubeflow_tpu.models import hf_import as jh
from kubeflow_tpu.models import mlp as jm
from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu.utils import registry as jreg
from kubeflow_tpu_torch.models import bert as tb
from kubeflow_tpu_torch.models import hf_import as th
from kubeflow_tpu_torch.models import mlp as tm
from kubeflow_tpu_torch.models.convert import (bert_params_from_jax,
                                               mlp_params_from_jax)
from kubeflow_tpu_torch.serve import quant as tq
from kubeflow_tpu_torch.utils import registry as treg

F32_TOL = 1e-5
BF16_TOL = 2e-2
INT8_TOL_F32 = 5e-3
INT8_TOL_BF16 = 2e-2


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ids(b=3, s=16, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, 10:] = False
    return ids, mask


def _jax_bert(cfg, seed=0):
    """JAX Bert params with every leaf nudged off its init (biases and
    LayerNorms non-trivial)."""
    model = jb.Bert(cfg)
    ids, _ = _ids()
    params = nn.meta.unbox(model.init(jax.random.key(seed), ids)["params"])
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda x: x + 0.02 * jnp.asarray(rng.normal(size=x.shape), x.dtype),
        params)
    return model, params


def _port_bert(cfg_kw, params):
    cfg = dataclasses.replace(tb.bert_tiny(), **cfg_kw)
    model = tb.Bert(cfg, device="cpu")
    model.load_state_dict(bert_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return model.eval()


def _jdt(name):
    return getattr(jnp, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", list(tb.TASKS))
def test_heads_match_jax(task, dtype):
    jm_, params = _jax_bert(dataclasses.replace(
        jb.bert_tiny(), task=task, dtype=_jdt(dtype)))
    ids, mask = _ids()
    jx, jo = jm_.apply({"params": params}, ids, attention_mask=mask)
    port = _port_bert({"task": task, "dtype": dtype}, params)
    with torch.no_grad():
        tx, to = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert to.dtype == torch.float32 and tuple(to.shape) == jo.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_l2(to.numpy(), jo) <= tol
    assert rel_l2(tx.float().numpy(), np.asarray(jx, np.float32)) <= tol


@pytest.mark.parametrize("kw", [{"use_pooler": False},
                                {"hidden_act": "gelu_new"},
                                {"hidden_act": "relu"},
                                {"num_labels": 5}],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_config_variants_match_jax(kw):
    jm_, params = _jax_bert(dataclasses.replace(
        jb.bert_tiny(), dtype=jnp.float32, **kw))
    ids, mask = _ids(seed=2)
    _, jo = jm_.apply({"params": params}, ids, attention_mask=mask)
    port = _port_bert({"dtype": "float32", **kw}, params)
    with torch.no_grad():
        _, to = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert rel_l2(to.numpy(), jo) <= F32_TOL


def test_refusals():
    with pytest.raises(ValueError, match="unsupported hidden_act"):
        tb.Bert(dataclasses.replace(tb.bert_tiny(), hidden_act="silu"),
                device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        tb.Bert(dataclasses.replace(tb.bert_tiny(), task="qa"),
                device="cpu")
    _, params = _jax_bert(dataclasses.replace(jb.bert_tiny(),
                                              dtype=jnp.float32))
    flat = jax.tree.map(np.asarray, params)
    cfg = tb.bert_tiny()
    extra = dict(flat, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        bert_params_from_jax(extra, cfg)
    missing = dict(flat)
    missing.pop("pooler")
    with pytest.raises(ValueError, match="missing"):
        bert_params_from_jax(missing, cfg)
    with pytest.raises(ValueError, match="shape"):
        bert_params_from_jax(flat, dataclasses.replace(cfg, num_labels=3))


def _jax_mlp(cfg_kw, seed=0):
    cfg = jm.MLPConfig(**cfg_kw)
    model = jm.MLP(cfg)
    x = np.zeros((1, cfg.in_dim), np.float32)
    params = nn.meta.unbox(model.init(jax.random.key(seed), x)["params"])
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype),
        params)
    return model, params


@pytest.mark.parametrize("kw", [{"in_dim": 16, "hidden": (8,),
                                 "num_classes": 4},
                                {}], ids=["small", "mnist"])
def test_mlp_matches_jax(kw):
    jmodel, params = _jax_mlp(kw)
    cfg = tm.MLPConfig(**kw)
    port = tm.MLP(cfg, device="cpu")
    port.load_state_dict(mlp_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    x = np.random.default_rng(3).normal(size=(5, cfg.in_dim)).astype(
        np.float32)
    want = np.asarray(jmodel.apply({"params": params}, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert rel_l2(got, want) <= F32_TOL
    flat = jax.tree.map(np.asarray, params)
    flat.pop("head")
    with pytest.raises(ValueError, match="missing"):
        mlp_params_from_jax(flat, cfg)


#: Shrinks a full-size Llama entry: its example shape is the entry's own.
SMALL_LLAMA = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
               "num_layers": 1, "num_heads": 4, "num_kv_heads": 2,
               "head_dim": 16}


@pytest.mark.parametrize("name,kw", [
    ("mnist_mlp", {}), ("bert_tiny", {}), ("llama_tiny", {}),
    ("bert_base", {"vocab_size": 512, "num_layers": 1}),
    ("llama_1b", SMALL_LLAMA), ("llama3_8b", SMALL_LLAMA)],
    ids=lambda v: v if isinstance(v, str) else "")
def test_registry_info_matches_jax(name, kw):
    assert set(treg.list_models()) <= set(jreg.list_models())
    _, jinfo = jreg.build_model(name, **kw)
    _, info = treg.build_model(name, device="cpu", **kw)
    for key in ("task", "example_shape", "example_dtype"):
        assert info[key] == jinfo[key], key
    if "config" in jinfo:
        jcfg, cfg = jinfo["config"], info["config"]
        for f in dataclasses.fields(cfg):
            if f.name not in ("dtype", "param_dtype") and hasattr(jcfg,
                                                                  f.name):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


# -- import_bert ---------------------------------------------------------------

ARCHS = {"sequence_classification": "BertForSequenceClassification",
         "token_classification": "BertForTokenClassification",
         "fill_mask": "BertForMaskedLM",
         "embedding": "BertModel"}


def _hf_bert(tmp, task, seed=0, **kw):
    """A tiny transformers BERT of `task`'s head, saved in HF's layout."""
    cfg = transformers.BertConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, pad_token_id=0, **kw)
    torch.manual_seed(seed)
    model = getattr(transformers, ARCHS[task])(cfg).eval()
    with torch.no_grad():  # non-trivial biases and LayerNorms
        for p in model.parameters():
            p.add_(0.02 * torch.randn_like(p))
        if task == "fill_mask":
            model.tie_weights()
    d = str(tmp / f"{task}-{seed}")
    model.save_pretrained(d, safe_serialization=True)
    return d, model


def _same_config(cfg, jcfg):
    for f in dataclasses.fields(cfg):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("task", list(tb.TASKS))
def test_import_bert_matches_jax_and_transformers(tmp_path, task):
    d, hf_model = _hf_bert(tmp_path, task)
    cfg, sd = th.import_bert(d, dtype="float32")
    jcfg, params = jh.import_bert(d, dtype=jnp.float32)
    _same_config(cfg, jcfg)
    ref = bert_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    model = tb.Bert(cfg, device="cpu")
    model.load_state_dict(sd)
    ids, mask = _ids(b=2)
    with torch.no_grad():
        _, got = model(torch.from_numpy(ids), torch.from_numpy(mask))
        out = hf_model(input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask).long())
    if task == "embedding":
        return  # transformers' bare model has no pooling head to compare
    want = out.logits
    if task != "sequence_classification":  # padded positions: don't care
        got, want = got[torch.from_numpy(mask)], want[torch.from_numpy(mask)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-3)


def _rewrite(src, dst, fn, config=None):
    """Copy checkpoint `src` to `dst` with its tensors through `fn` and
    its config.json through `config`."""
    os.makedirs(dst)
    t = dict(th.load_safetensors_dir(src))
    th.save_safetensors(fn({k: v.clone() for k, v in t.items()}),
                        os.path.join(dst, "model.safetensors"))
    hf = th.read_hf_config(src)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(config(hf) if config else hf, f)
    return dst


def test_import_bert_prefix_pooler_and_headless_as_jax(tmp_path):
    d, _ = _hf_bert(tmp_path, "sequence_classification", seed=1)
    cases = {
        "noprefix": (lambda t: {k.removeprefix("bert."): v
                                for k, v in t.items()}, {}),
        "nopooler": (lambda t: {k: v for k, v in t.items()
                                if "pooler" not in k}, {}),
        "headless": (lambda t: {k: v for k, v in t.items()
                                if not k.startswith("classifier")},
                     {"allow_headless": True}),
    }
    for name, (fn, kw) in cases.items():
        p = _rewrite(d, str(tmp_path / name), fn)
        cfg, sd = th.import_bert(p, dtype="float32", **kw)
        jcfg, params = jh.import_bert(p, dtype=jnp.float32, **kw)
        _same_config(cfg, jcfg)
        ref = bert_params_from_jax(jax.tree.map(np.asarray, params), cfg)
        assert sorted(sd) == sorted(ref), name
        for k, v in ref.items():
            assert torch.equal(sd[k], v), (name, k)
    assert cfg.use_pooler is True
    assert th.import_bert(str(tmp_path / "nopooler"))[0].use_pooler is False


def _raises_like_jax(call_port, call_jax):
    """The same exception type and message (up to a ';', past which the
    JAX message names its flax module)."""
    with pytest.raises(Exception) as jerr:
        call_jax()
    with pytest.raises(type(jerr.value)) as err:
        call_port()
    assert str(err.value).split(";")[0] == str(jerr.value).split(";")[0]


@pytest.mark.parametrize("case", ["position", "activation", "arch",
                                  "untied", "headless"])
def test_import_bert_refusals_match_jax(tmp_path, case):
    task = "fill_mask" if case == "untied" else "sequence_classification"
    d, _ = _hf_bert(tmp_path, task, seed=2)
    fn, config = (lambda t: t), None
    if case == "position":
        config = lambda hf: dict(hf, position_embedding_type="relative_key")
    elif case == "activation":
        config = lambda hf: dict(hf, hidden_act="silu")
    elif case == "arch":
        config = lambda hf: dict(hf, architectures=[
            "BertForQuestionAnswering"])
    elif case == "untied":
        def fn(t):
            t["cls.predictions.decoder.weight"] = (
                t["bert.embeddings.word_embeddings.weight"] + 1.0)
            return t
    else:
        fn = lambda t: {k: v for k, v in t.items()
                        if not k.startswith("classifier")}
    p = _rewrite(d, str(tmp_path / case), fn, config)
    _raises_like_jax(lambda: th.import_bert(p), lambda: jh.import_bert(p))


def test_build_from_hf_dispatches_bert_first(tmp_path):
    d, _ = _hf_bert(tmp_path, "token_classification", seed=3)
    cfg, sd = th.build_from_hf(d, dtype="float32")
    assert isinstance(cfg, tb.BertConfig)
    assert cfg.task == "token_classification"
    assert sorted(sd) == sorted(th.import_bert(d)[1])
    hf = th.read_hf_config(d)
    assert th.config_from_hf(hf) == th.bert_config_from_hf(hf)
    jmod, jcfg, _ = jh.build_from_hf(d)
    assert isinstance(jmod, jb.Bert)
    _same_config(cfg, jcfg)


# -- int8 ------------------------------------------------------------------


def _codes(tree):
    """{path: (codes, scale)} of a quantize_tree result's Int8Leafs."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jq.Int8Leaf))[0]
    for path, leaf in flat:
        if isinstance(leaf, jq.Int8Leaf):
            out["/".join(str(k.key) for k in path)] = (
                np.asarray(leaf.q), np.asarray(leaf.scale))
    return out


def _port_leaf(path: str):
    """flax path of a BERT leaf -> (port module path, is a projection)."""
    parts = path.split("/")
    if parts[0].startswith("layer_"):
        return f"layers.{parts[0][6:]}.{parts[1]}", True
    if parts[-1] == "kernel":
        return parts[0], True
    return parts[0], False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", ["sequence_classification", "fill_mask"])
def test_int8_bert_matches_quantized_module(task, dtype):
    jm_, params = _jax_bert(dataclasses.replace(
        jb.bert_tiny(), task=task, dtype=_jdt(dtype)))
    qtree = jq.quantize_tree(params)
    port = _port_bert({"task": task, "dtype": dtype}, params)
    tq.quantize_fixed(port)
    codes = _codes(qtree)
    mods = dict(port.named_modules())
    quantized = {n for n, m in mods.items()
                 if isinstance(m, (tq.Int8Dense, tq.Int8Table))}
    assert len(quantized) == len(codes)
    for path, (q, scale) in codes.items():
        name, proj = _port_leaf(path)
        mod = mods[name]
        if proj:  # [out, in] codes; the flax kernel's input axes first
            assert isinstance(mod, tq.Int8Dense), path
            assert np.array_equal(mod.q.numpy().T.reshape(q.shape), q), path
        else:  # an embedding table, per-column scales
            assert isinstance(mod, tq.Int8Table), path
            assert np.array_equal(mod.q.numpy(), q), path
        assert np.array_equal(mod.scale.numpy(), scale.reshape(-1)), path
    assert tq.quantized_bytes(port) == jq.quantized_bytes(qtree)
    ids, mask = _ids(seed=4)
    want = jq.QuantizedModule(jm_).apply({"params": qtree}, ids,
                                         attention_mask=mask)[1]
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))[1]
    tol = INT8_TOL_F32 if dtype == "float32" else INT8_TOL_BF16
    assert rel_l2(got.numpy(), want) <= tol


def test_int8_mlp_matches_quantized_module():
    kw = {}
    jmodel, params = _jax_mlp(kw)
    qtree = jq.quantize_tree(params)
    cfg = tm.MLPConfig(**kw)
    port = tm.MLP(cfg, device="cpu")
    port.load_state_dict(mlp_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    tq.quantize_fixed(port)
    assert isinstance(port.dense_0, tq.Int8Dense)
    assert isinstance(port.dense_1, tq.Int8Dense)
    assert isinstance(port.head, tm.Dense)  # 128 x 10 < 4096 stays float
    codes = _codes(qtree)
    assert sorted(codes) == ["dense_0/kernel", "dense_1/kernel"]
    for name, (q, scale) in codes.items():
        mod = getattr(port, name.split("/")[0])
        assert np.array_equal(mod.q.numpy(), q.T)
        assert np.array_equal(mod.scale.numpy(), scale.reshape(-1))
    assert tq.quantized_bytes(port) == jq.quantized_bytes(qtree)
    x = np.random.default_rng(5).normal(size=(6, cfg.in_dim)).astype(
        np.float32)
    want = np.asarray(jq.QuantizedModule(jmodel).apply({"params": qtree}, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert rel_l2(got, want) <= INT8_TOL_F32


# -- huggingface bundles -----------------------------------------------------


def _bundle(d, **spec):
    with open(os.path.join(d, "model.json"), "w") as f:
        json.dump({"format": "huggingface", **spec}, f)
    return d


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_bert_bundle_predicts_as_jax(tmp_path, quantize):
    """A non-generative BERT bundle: the key mask from pad_token_id, the
    buckets and seq_len defaults, and predictions equal to the JAX
    runtime's (fp32 overrides; int8 within INT8_TOL_F32)."""
    from kubeflow_tpu.serve import runtimes as jrt
    from kubeflow_tpu_torch.serve.model import TorchModel
    from kubeflow_tpu_torch.serve.runtimes import load_model

    d, _ = _hf_bert(tmp_path, "sequence_classification", seed=4)
    spec = {"model_overrides": {"dtype": "float32"}, "seq_len": 16}
    if quantize:
        spec["quantize"] = quantize
    _bundle(d, **spec)
    jmodel = jrt.load_model(d, name="b")
    model = load_model(d, name="b", device="cpu")
    assert isinstance(model, TorchModel)
    assert model.input_spec == jmodel.input_spec == [((16,), "int32")]
    assert model.batch_buckets == jmodel.batch_buckets == [1, 2, 4, 8, 16, 32]
    assert model.warm_buckets == jmodel.warm_buckets == [1, 8]
    jmodel.load(), model.load()
    ids, _ = _ids(b=3)
    ids[1, 9:] = 0  # right-padded with pad_token_id
    want, got = jmodel.predict([ids])[0], model.predict([ids])[0]
    assert rel_l2(got, want) <= (INT8_TOL_F32 if quantize else F32_TOL)
    # the pad row equals the same row cut to its own length
    short = load_model(_bundle(d, **dict(spec, seq_len=9)), device="cpu")
    short.load()
    np.testing.assert_allclose(short.predict([ids[1:2, :9]])[0][0], got[1],
                               rtol=1e-4, atol=1e-5)
    if quantize:
        jbytes = jq.quantized_bytes(jmodel.apply_and_params()[1])
        assert {k: model.quantization[k] for k in jbytes} == jbytes
        assert model.quantization["quantized"] < jbytes["full"]


def test_llama_huggingface_bundle_without_generative_predicts_as_jax(
        tmp_path):
    from kubeflow_tpu.serve import runtimes as jrt
    from kubeflow_tpu_torch.serve.runtimes import load_model

    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(0)
    d = str(tmp_path / "llama")
    transformers.LlamaForCausalLM(cfg).save_pretrained(
        d, safe_serialization=True)
    _bundle(d, model_overrides={"dtype": "float32"}, seq_len=16)
    jmodel, model = jrt.load_model(d), load_model(d, device="cpu")
    assert model.batch_buckets == jmodel.batch_buckets == [1, 2, 4, 8]
    assert model.warm_buckets == jmodel.warm_buckets == [1]
    jmodel.load(), model.load()
    ids = np.random.default_rng(0).integers(0, 256, (3, 16)).astype(np.int32)
    np.testing.assert_allclose(model.predict([ids])[0],
                               jmodel.predict([ids])[0], atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        model.predict([np.full((1, 16), 256, np.int32)])
