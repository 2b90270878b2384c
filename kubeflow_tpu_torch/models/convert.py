"""Weights from the JAX models' flax param trees onto the port's modules:
the Llama, the MLP, BERT, GPT-2 and T5."""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.models.bert import BertConfig
from kubeflow_tpu_torch.models.gpt2 import GPT2Config
from kubeflow_tpu_torch.models.llama import LlamaConfig, lora_projections
from kubeflow_tpu_torch.models.mlp import MLPConfig
from kubeflow_tpu_torch.models.t5 import T5Config


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(_flatten(val, path))
        else:
            out["/".join(path)] = val
    return out


def _tensor(leaf, dtype) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # numpy has no native bf16
    return torch.from_numpy(np.array(arr)).to(dtype)  # a writable copy


def llama_params_from_jax(params_np, cfg: LlamaConfig) -> dict:
    """Map the flax Llama tree (numpy or array leaves, boxes already
    removed with `nn.meta.unbox`) to a state dict for `Llama(cfg)`.

    The flax trunk is an `nn.scan`, so every `layers/...` leaf carries a
    leading L axis. DenseGeneral kernels are [in..., out...]; nn.Linear
    weights are [out, in], hence the transposes. Projections and the
    embedding come out in cfg.storage_dtype (cfg.param_dtype, or cfg.dtype
    when that is None), norm scales in fp32. Raises on any leaf that is
    missing or left over.

    A tree from the JAX `quantize_tree` is taken too, with each `Int8Leaf`
    flattened to a {"q": codes, "scale": scales} pair: such a kernel maps
    onto an `Int8Dense`'s `q` (int8, the same transposes as the float
    kernel) and `scale` (fp32 per output channel: [L,1,H,Dh] -> [H*Dh] for
    q/k/v, [L,1,1,D] -> [D] for o_proj, [1,V] -> [V] for the head, [V,1] ->
    [V] for the embedding).

    The other families' leaves cross with the config's flags: QKV biases
    (`attn/{q,k,v}_proj/bias` [L, heads, hd] -> [heads*hd], in the storage
    dtype), qk-norm scales (`attn/{q,k}_norm/scale` [L, hd]) and sandwich
    norms (`attn_out_norm`, `mlp_out_norm` [L, D]), fp32.

    With `cfg.lora_rank` > 0 the adapters cross too: flax `*_lora_a`
    [L, in, r] becomes the port's A [r, in], `*_lora_b` [L, r, *out] (q's
    [L, r, H, Dh], v's [L, r, KH, Dh]) its B [out, r], in the storage
    dtype.

    An `MoEConfig`'s layers carry the routed MLP instead of the dense
    one (models/moe.py, the JAX layout kept): `mlp/router` [L, H, E] in
    fp32, `mlp/w_gate`/`w_up` [L, E, H, M] and `mlp/w_down` [L, E, M, H],
    and with a shared expert `mlp/w_shared_gate`/`w_shared_up` [L, H, Ms],
    `mlp/w_shared_down` [L, Ms, H] and `mlp/shared_gate` [L, H, 1]. An
    `Int8Leaf` expert stack becomes an `Int8Experts`' codes [E, out, in]
    and scales [E, out]; an int8 shared leaf an `Int8Dense`'s [out, in]
    codes and [out] scales.

    The layout transforms are linear, so the same call maps a JAX
    GRADIENT tree (same structure as the params) onto the port's
    parameter names: that is how the tests compare gradients."""
    flat = _flatten(params_np)
    d, v = cfg.hidden_size, cfg.vocab_size
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt, f32 = cfg.storage_dtype, torch.float32
    n, inter = cfg.num_layers, cfg.intermediate_size
    used = set()

    def take(path, dtype, shape):
        if path not in flat:
            raise ValueError(f"flax param {path!r} is missing")
        used.add(path)
        x = _tensor(flat[path], dtype)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"flax param {path!r} has shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")
        return x

    def kernel(path, shape, out_features):
        """(values, scale or None): a float kernel in the storage dtype, or
        an Int8Leaf's codes and its scales flattened to [(L,) out]."""
        if path + "/q" not in flat:
            return take(path, dt, shape), None
        q = take(path + "/q", torch.int8, shape)
        lead = (shape[0],) if path.startswith("layers/") else ()
        scale = take(path + "/scale", f32, np.shape(flat[path + "/scale"]))
        if scale.numel() != int(np.prod(lead)) * out_features:
            raise ValueError(f"flax param {path + '/scale'!r} has shape "
                             f"{tuple(scale.shape)}, expected "
                             f"{out_features} scales per kernel")
        return q, scale.reshape(*lead, out_features)

    sd = {}

    def put(key, values, scale, to_linear):
        """`key`.weight, or `key`.q and `key`.scale, of one module."""
        if scale is None:
            sd[key + ".weight"] = to_linear(values).contiguous()
        else:
            sd[key + ".q"] = to_linear(values).contiguous()
            sd[key + ".scale"] = scale.clone()

    layer_kernels = {  # name: (flax path, stacked shape, out, to [out, in])
        "attn.q_proj": ("attn/q_proj", (n, d, h, dh), h * dh,
                        lambda x: x.reshape(d, h * dh).T),
        "attn.k_proj": ("attn/k_proj", (n, d, kh, dh), kh * dh,
                        lambda x: x.reshape(d, kh * dh).T),
        "attn.v_proj": ("attn/v_proj", (n, d, kh, dh), kh * dh,
                        lambda x: x.reshape(d, kh * dh).T),
        "attn.o_proj": ("attn/o_proj", (n, h, dh, d), d,
                        lambda x: x.reshape(h * dh, d).T),
    }
    moe = hasattr(cfg, "num_experts")
    if not moe:
        layer_kernels.update({
            "mlp.gate_proj": ("mlp/gate_proj", (n, d, inter), inter,
                              lambda x: x.T),
            "mlp.up_proj": ("mlp/up_proj", (n, d, inter), inter,
                            lambda x: x.T),
            "mlp.down_proj": ("mlp/down_proj", (n, inter, d), d,
                              lambda x: x.T)})
    stacked = {name: (*kernel(f"layers/{path}/kernel", shape, out), fn)
               for name, (path, shape, out, fn) in layer_kernels.items()}
    routed = _moe_leaves(cfg, kernel, take) if moe else {}
    outs = {"q_proj": (h, dh), "v_proj": (kh, dh), "gate_proj": (inter,),
            "up_proj": (inter,), "down_proj": (d,)}
    ins = {"q_proj": d, "v_proj": d, "gate_proj": d, "up_proj": d,
           "down_proj": inter}
    r = cfg.lora_rank
    adapters = {}  # port name: (A [L, r, in], B [L, out, r])
    for proj in lora_projections(cfg):
        block, name = proj.split(".")
        out = outs[name]
        a = take(f"layers/{block}/{name}_lora_a", dt, (n, ins[name], r))
        b = take(f"layers/{block}/{name}_lora_b", dt, (n, r, *out))
        adapters[f"{block}.{name}"] = (a.transpose(1, 2),
                                       b.reshape(n, r, -1).transpose(1, 2))
    norms = {"input_norm": ("layers/input_norm/scale", d),
             "post_attn_norm": ("layers/post_attn_norm/scale", d)}
    if cfg.sandwich_norms:
        norms.update(attn_out_norm=("layers/attn_out_norm/scale", d),
                     mlp_out_norm=("layers/mlp_out_norm/scale", d))
    if cfg.qk_norm:
        norms.update({"attn.q_norm": ("layers/attn/q_norm/scale", dh),
                      "attn.k_norm": ("layers/attn/k_norm/scale", dh)})
    norms = {name: take(path, f32, (n, width))
             for name, (path, width) in norms.items()}
    biases = {}
    if cfg.attention_bias:
        biases = {f"attn.{p}": take(f"layers/attn/{p}/bias", dt,
                                    (n, heads, dh)).reshape(n, heads * dh)
                  for p, heads in (("q_proj", h), ("k_proj", kh),
                                   ("v_proj", kh))}
    embed, embed_scale = kernel("embed", (v, d), v)
    if embed_scale is None:
        sd["embed"] = embed
    else:
        put("embed", embed, embed_scale, lambda x: x)
    sd["final_norm.scale"] = take("final_norm/scale", f32, (d,))
    if not cfg.tie_embeddings:
        head, head_scale = kernel("lm_head/kernel", (d, v), v)
        put("lm_head", head, head_scale, lambda x: x.T)
    for i in range(n):
        p = f"layers.{i}."
        for name, (values, scale, to_linear) in stacked.items():
            put(p + name, values[i], None if scale is None else scale[i],
                to_linear)
        for name, (a, b) in adapters.items():
            sd[p + name + "_lora_a"] = a[i].contiguous()
            sd[p + name + "_lora_b"] = b[i].contiguous()
        for name, scales in norms.items():
            sd[p + name + ".scale"] = scales[i].clone()
        for name, bias in biases.items():
            sd[p + name + ".bias"] = bias[i].clone()
        for name, (values, scale, to_port) in routed.items():
            if scale is None:
                sd[p + name] = values[i].contiguous()
            else:
                sd[p + name + ".q"] = to_port(values[i]).contiguous()
                sd[p + name + ".scale"] = scale[i].clone()
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"flax params not consumed by the port: {extra}")
    return sd


def _moe_leaves(cfg, kernel, take) -> dict:
    """{port name under `layers.{i}.`: (values [L, ...], scales [L, out...]
    or None, codes to the port's layout)} of an MoE config's routed MLP:
    the fp32 router as it is, float expert and shared leaves in the JAX
    layout, int8 ones as [.., out, in] codes (`kernel` flattens their
    scales)."""
    n, d, m = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    e, ms = cfg.num_experts, cfg.shared_expert_size
    out = {"mlp.router": (take("layers/mlp/router", torch.float32,
                               (n, d, e)), None, None)}
    leaves = [("w_gate", (n, e, d, m), e * m), ("w_up", (n, e, d, m), e * m),
              ("w_down", (n, e, m, d), e * d)]
    if ms:
        leaves += [("w_shared_gate", (n, d, ms), ms),
                   ("w_shared_up", (n, d, ms), ms),
                   ("w_shared_down", (n, ms, d), d),
                   ("shared_gate", (n, d, 1), 1)]
    for name, shape, count in leaves:
        values, scale = kernel(f"layers/mlp/{name}", shape, count)
        if scale is not None and len(shape) == 4:
            scale = scale.reshape(n, e, -1)
        out[f"mlp.{name}"] = (values, scale, lambda x: x.transpose(-1, -2))
    return out


class _Taker:
    """Reads leaves of a flattened flax tree by path, checking each one's
    shape, and reports the leaves nothing read."""

    def __init__(self, params_np):
        self.flat = _flatten(params_np)
        self.used: set[str] = set()

    def __call__(self, path, shape, dtype=torch.float32) -> torch.Tensor:
        if path not in self.flat:
            raise ValueError(f"flax param {path!r} is missing")
        self.used.add(path)
        x = _tensor(self.flat[path], dtype)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"flax param {path!r} has shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")
        return x

    def dense(self, sd, key, path, n_in, n_out, kernel_shape=None,
              bias_shape=None, dtype=torch.float32):
        """`key`.weight [out, in] from a (Dense)General kernel whose input
        axes come first, and `key`.bias from its bias."""
        k = self(path + "/kernel", kernel_shape or (n_in, n_out), dtype)
        sd[key + ".weight"] = k.reshape(n_in, n_out).T.contiguous()
        sd[key + ".bias"] = self(path + "/bias", bias_shape or (n_out,),
                                 dtype).reshape(n_out)

    def done(self, sd) -> dict:
        extra = sorted(set(self.flat) - self.used)
        if extra:
            raise ValueError(f"flax params not consumed by the port: {extra}")
        return sd


def mlp_params_from_jax(params_np, cfg: MLPConfig) -> dict:
    """The flax MLP tree (`dense_{i}`, `head`: kernel [in, out], bias
    [out]) as a state dict for `MLP(cfg)`. Raises on a leaf that is
    missing, mis-shaped or left over."""
    take, sd = _Taker(params_np), {}
    dims = (cfg.in_dim, *cfg.hidden)
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        take.dense(sd, f"dense_{i}", f"dense_{i}", a, b)
    take.dense(sd, "head", "head", dims[-1], cfg.num_classes)
    return take.done(sd)


def bert_params_from_jax(params_np, cfg: BertConfig) -> dict:
    """The flax Bert tree as a state dict for `Bert(cfg)`, in
    cfg.param_dtype. q/k/v kernels [H, heads, hd] and biases [heads, hd],
    and the o kernel [heads, hd, H], flatten their head axes; every kernel
    is transposed to [out, in]. LayerNorm scale/bias keep their names.
    The task's head leaves (classifier, pooler unless `use_pooler` is off,
    or the MLM transform, LayerNorm and bias) must be there. Raises on a
    leaf that is missing, mis-shaped or left over."""
    take, sd = _Taker(params_np), {}
    h, nh, i = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
    hd, pd = h // nh, cfg.param_dtype
    for name, rows in (("word_embeddings", cfg.vocab_size),
                       ("position_embeddings", cfg.max_seq_len),
                       ("token_type_embeddings", cfg.type_vocab_size)):
        sd[name] = take(name, (rows, h), pd)

    def ln(key, path):
        sd[key + ".scale"] = take(path + "/scale", (h,))
        sd[key + ".bias"] = take(path + "/bias", (h,))

    ln("ln_embed", "ln_embed")
    for n in range(cfg.num_layers):
        p, key = f"layer_{n}/", f"layers.{n}."
        for proj in ("q", "k", "v"):
            take.dense(sd, key + proj, p + proj, h, h, (h, nh, hd),
                       (nh, hd), pd)
        take.dense(sd, key + "o", p + "o", h, h, (nh, hd, h), None, pd)
        take.dense(sd, key + "ffn_in", p + "ffn_in", h, i, dtype=pd)
        take.dense(sd, key + "ffn_out", p + "ffn_out", i, h, dtype=pd)
        ln(key + "ln_attn", p + "ln_attn")
        ln(key + "ln_ffn", p + "ln_ffn")
    if cfg.task in ("sequence_classification", "token_classification"):
        take.dense(sd, "classifier", "classifier", h, cfg.num_labels,
                   dtype=pd)
    if cfg.task == "sequence_classification" and cfg.use_pooler:
        take.dense(sd, "pooler", "pooler", h, h, dtype=pd)
    if cfg.task == "fill_mask":
        take.dense(sd, "mlm_transform", "mlm_transform", h, h, dtype=pd)
        ln("mlm_ln", "mlm_ln")
        sd["mlm_bias"] = take("mlm_bias", (cfg.vocab_size,), pd)
    return take.done(sd)


def gpt2_params_from_jax(params_np, cfg: GPT2Config) -> dict:
    """The flax GPT-2 tree (`wte`, `wpe`, `ln_f`, `block_{i}`) as a state
    dict for `GPT2(cfg)`: q/k/v kernels [H, heads, hd] and biases [heads,
    hd], the o_proj kernel [heads, hd, H], and the MLP's `fc`/`proj`
    kernels transposed to [out, in] with their biases, in
    cfg.storage_dtype; LayerNorm scale/bias in fp32. Raises on a leaf that
    is missing, mis-shaped or left over."""
    take, sd = _Taker(params_np), {}
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    i, dt = cfg.intermediate_size, cfg.storage_dtype
    sd["wte"] = take("wte", (cfg.vocab_size, h), dt)
    sd["wpe"] = take("wpe", (cfg.max_seq_len, h), dt)

    def ln(key, path):
        sd[key + ".scale"] = take(path + "/scale", (h,))
        sd[key + ".bias"] = take(path + "/bias", (h,))

    ln("ln_f", "ln_f")
    for n in range(cfg.num_layers):
        p, key = f"block_{n}/", f"blocks.{n}."
        for proj in ("q_proj", "k_proj", "v_proj"):
            take.dense(sd, key + proj, p + proj, h, h, (h, nh, hd), (nh, hd),
                       dt)
        take.dense(sd, key + "o_proj", p + "o_proj", h, h, (nh, hd, h),
                   None, dt)
        take.dense(sd, key + "fc", p + "fc", h, i, dtype=dt)
        take.dense(sd, key + "proj", p + "proj", i, h, dtype=dt)
        ln(key + "ln_1", p + "ln_1")
        ln(key + "ln_2", p + "ln_2")
    return take.done(sd)


def t5_params_from_jax(params_np, cfg: T5Config) -> dict:
    """The flax T5 tree as a state dict for `T5(cfg)`: q/k/v kernels
    [D, heads, dk] and o kernels [heads, dk, D] flatten their head axes and
    transpose to [out, in], the FFN kernels and an untied `lm_head` [D, V]
    transpose, `shared_embedding` is `shared`; these in cfg.storage_dtype,
    norm scales and the `rel_embedding` tables (each layer's under UMT5)
    in fp32. Raises on a leaf that is missing, mis-shaped or left over."""
    take, sd = _Taker(params_np), {}
    d, nh, dk, dt = cfg.d_model, cfg.num_heads, cfg.d_kv, cfg.storage_dtype
    inner = nh * dk
    sd["shared"] = take("shared_embedding", (cfg.vocab_size, d), dt)

    def kernel(key, path, n_in, n_out, shape):
        sd[key + ".weight"] = take(path + "/kernel", shape, dt).reshape(
            n_in, n_out).T.contiguous()

    def attn(key, path):
        for p in ("q", "k", "v"):
            kernel(f"{key}.{p}", f"{path}/{p}", d, inner, (d, nh, dk))
        kernel(f"{key}.o", f"{path}/o", inner, d, (nh, dk, d))

    def ffn(key, path):
        for p in (("wi_0", "wi_1") if cfg.gated else ("wi",)):
            kernel(f"{key}.{p}", f"{path}/{p}", d, cfg.d_ff, (d, cfg.d_ff))
        kernel(f"{key}.wo", f"{path}/wo", cfg.d_ff, d, (cfg.d_ff, d))

    def rel(key, path):
        sd[key + ".table"] = take(path + "/rel_embedding",
                                  (cfg.rel_buckets, nh))

    def ln(key, path):
        sd[key + ".scale"] = take(path + "/scale", (d,))

    if not cfg.per_layer_rel_bias:
        rel("enc_rel", "enc_rel")
        rel("dec_rel", "dec_rel")
    for n in range(cfg.num_layers):
        if cfg.per_layer_rel_bias:
            rel(f"enc_rels.{n}", f"enc_{n}_rel")
        attn(f"enc_attn.{n}", f"enc_{n}_attn")
        ln(f"enc_attn_ln.{n}", f"enc_{n}_attn_ln")
        ffn(f"enc_ffn.{n}", f"enc_{n}_ffn")
        ln(f"enc_ffn_ln.{n}", f"enc_{n}_ffn_ln")
    for n in range(cfg.num_decoder_layers):
        if cfg.per_layer_rel_bias:
            rel(f"dec_rels.{n}", f"dec_{n}_rel")
        attn(f"dec_self.{n}", f"dec_{n}_self")
        ln(f"dec_self_ln.{n}", f"dec_{n}_self_ln")
        attn(f"dec_cross.{n}", f"dec_{n}_cross")
        ln(f"dec_cross_ln.{n}", f"dec_{n}_cross_ln")
        ffn(f"dec_ffn.{n}", f"dec_{n}_ffn")
        ln(f"dec_ffn_ln.{n}", f"dec_{n}_ffn_ln")
    ln("enc_final_ln", "enc_final_ln")
    ln("dec_final_ln", "dec_final_ln")
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = take("lm_head", (d, cfg.vocab_size),
                                    dt).T.contiguous()
    return take.done(sd)
