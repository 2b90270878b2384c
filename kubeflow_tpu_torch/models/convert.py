"""Weights from the JAX Llama's flax param tree onto the port's modules."""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import LlamaConfig


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

    The layout transforms are linear, so the same call maps a JAX
    GRADIENT tree (same structure as the params) onto the port's
    parameter names: that is how the tests compare gradients."""
    flat = _flatten(params_np)
    d, v = cfg.hidden_size, cfg.vocab_size
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt, f32 = cfg.storage_dtype, torch.float32
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

    n = cfg.num_layers
    qk = take("layers/attn/q_proj/kernel", dt, (n, d, h, dh))
    kk = take("layers/attn/k_proj/kernel", dt, (n, d, kh, dh))
    vk = take("layers/attn/v_proj/kernel", dt, (n, d, kh, dh))
    ok = take("layers/attn/o_proj/kernel", dt, (n, h, dh, d))
    gk = take("layers/mlp/gate_proj/kernel", dt, (n, d, cfg.intermediate_size))
    uk = take("layers/mlp/up_proj/kernel", dt, (n, d, cfg.intermediate_size))
    dk = take("layers/mlp/down_proj/kernel", dt, (n, cfg.intermediate_size, d))
    inn = take("layers/input_norm/scale", f32, (n, d))
    pan = take("layers/post_attn_norm/scale", f32, (n, d))
    sd = {"embed": take("embed", dt, (v, d)),
          "final_norm.scale": take("final_norm/scale", f32, (d,))}
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = take("lm_head/kernel", dt, (d, v)).T.contiguous()
    for i in range(n):
        p = f"layers.{i}."
        sd[p + "attn.q_proj.weight"] = qk[i].reshape(d, h * dh).T.contiguous()
        sd[p + "attn.k_proj.weight"] = kk[i].reshape(d, kh * dh).T.contiguous()
        sd[p + "attn.v_proj.weight"] = vk[i].reshape(d, kh * dh).T.contiguous()
        sd[p + "attn.o_proj.weight"] = ok[i].reshape(h * dh, d).T.contiguous()
        sd[p + "mlp.gate_proj.weight"] = gk[i].T.contiguous()
        sd[p + "mlp.up_proj.weight"] = uk[i].T.contiguous()
        sd[p + "mlp.down_proj.weight"] = dk[i].T.contiguous()
        sd[p + "input_norm.scale"] = inn[i].clone()
        sd[p + "post_attn_norm.scale"] = pan[i].clone()
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"flax params not consumed by the port: {extra}")
    return sd
