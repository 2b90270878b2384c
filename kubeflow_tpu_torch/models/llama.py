"""Llama-class decoder-only transformer in PyTorch (serving and training).

The port of `kubeflow_tpu/models/llama.py`: GQA, RoPE (with llama3 scaling),
SwiGLU MLP, RMSNorm, tied or untied head, the KV-cache calling convention
the serving engine drives — prefill (S > 1 at cache_index 0), single-token
decode, and continuation chunks (`attend_full_cache`) — the training
forward with per-block rematerialisation under the four JAX remat policies,
and LoRA adapters on the attention (and MLP) projections.

The config flags of the other families on the same trunk, as in JAX:
Qwen2's QKV biases (`attention_bias`); Gemma's (1 + w) norms, sqrt(hidden)
embedding scale and GeGLU MLP; Gemma-2's sandwich norms, tanh soft-caps and
query_pre_attn_scalar; the alternating sliding/full layers of Gemma-2
("even") and Gemma-3 ("5to1"), with Gemma-3's qk-norms and dual RoPE bases.
Where JAX threads a traced per-layer flag through its scanned trunk, each
layer here gets its own static flag (`sliding_flags`).

Where weights live is `cfg.param_dtype`: None (the default) stores them in
`cfg.dtype`, the serving layout (bf16 weights: the JAX model keeps fp32
params but casts them to bf16 right before every matmul, so storing them in
bf16 computes the same forward); torch.float32 stores fp32 master weights
and casts them to `cfg.dtype` at each use, as the JAX config's
param_dtype=float32 does (the trainer sets it). RMSNorm scales are fp32
either way. The scanned trunk is an `nn.ModuleList`.

Differences from the JAX twin, by design:
  * the KV cache is updated IN PLACE (a functional copy of a multi-GB
    cache per layer is not affordable eagerly); `forward` still returns the
    cache it was given so call sites read like the JAX ones;
  * under `quantized_dense` the projections are `Int8Dense` modules and the
    embedding an `Int8Dense` table (serve/quant.py), built by
    `quantize_model` from a float model or loaded from a state dict;
  * features of later slices are refused with NotImplementedError, never
    ignored (`_check_supported`);
  * multi-LoRA serving takes each row's adapter factors gathered once
    (`adapter_rows`, an `AdapterRows`) as well as the stacks and ids, so
    the engine gathers once per decode chunk, not once per step.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from kubeflow_tpu_torch.ops.flash_attention import (MaskSpec,
                                                    cuda_flash_takes,
                                                    flash_attention)
from kubeflow_tpu_torch.ops.reference import naive_attention
from kubeflow_tpu_torch.serve.quant import (KV_QUANT_MODES, Int8Dense,
                                            kv_qdtype, kv_quantize_rows,
                                            quant_embed_lookup, quant_unembed)
from kubeflow_tpu_torch.utils.devices import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    # Llama-3.1 "llama3" rope scaling; factor == 1.0 disables it.
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_len: int = 8192
    # HF "linear" rope scaling (frequencies divided by the factor).
    rope_global_scaling_factor: float = 1.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # Storage dtype of the projections and the embedding: None = `dtype`
    # (serving); torch.float32 = fp32 master weights cast to `dtype` at
    # each use (training, the JAX default). Norm scales are always fp32.
    param_dtype: Any = None
    # Per-block rematerialisation while grad is enabled (the JAX nn.remat
    # of each DecoderLayer). What the forward keeps for the backward, by
    # policy: "nothing" the block's input; "dots" also every matrix
    # product's output; "dots_no_batch" only those without batch dims (the
    # projections and LoRA products, not naive attention's bmm);
    # "save_attn" the input and the attention block's output. The rest is
    # recomputed in the backward, the flash kernels included.
    remat: bool = True
    remat_policy: str = "nothing"
    # QKV projection biases (Qwen2; o_proj has none). Zero at init.
    attention_bias: bool = False
    # Gemma: RMSNorm applies (1 + w) with w zero at init; embeddings scale
    # by sqrt(hidden), the multiplier rounded to `dtype`; the MLP gate is
    # tanh-approximate GeLU ("gelu_tanh") instead of SiLU.
    norm_plus_one: bool = False
    embed_scale: bool = False
    mlp_act: str = "silu"  # silu | gelu_tanh
    # Gemma-2: norms on the attention and MLP outputs before the residual
    # adds; tanh soft-caps on the attention scores and the final logits
    # (0 = off); the score scale query_pre_attn_scalar^-0.5 (0 = head_dim).
    sandwich_norms: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_pre_attn_scalar: float = 0.0
    # Which layers a sliding_window mask bands: "all" (Mistral), "even"
    # (Gemma-2: layers 0, 2, ...) or "5to1" (Gemma-3: every 6th layer
    # full). Gemma-3 also norms the q/k heads ((1 + w) when norm_plus_one)
    # and has two RoPE bases: rope_theta_local on sliding layers (0 = one
    # table), rope_theta with rope_global_scaling_factor on full ones.
    sliding_pattern: str = "all"
    qk_norm: bool = False
    rope_theta_local: float = 0.0
    # LoRA: lora_rank > 0 adds (x @ A) @ B * alpha/rank to q_proj and
    # v_proj ("attn", PEFT's Llama default), and to gate/up/down_proj too
    # ("attn_mlp"). A [r, in], B [out, r] (PEFT's layouts), stored in
    # `storage_dtype`, applied in `dtype`; named `<proj>_lora_a/_b` beside
    # the projection, as the JAX leaves.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: str = "attn"
    quantized_dense: bool = False
    # auto | naive | flash (auto = flash on CUDA for standard positions or
    # segment ids, as the JAX auto on the TPU: the wgmma kernels for bf16 at
    # head_dim 64 or 128, the CUDA-core kernels for fp32/bf16/fp16 up to
    # 256; naive on the CPU)
    attention_impl: str = "auto"
    # Kept for signature parity with the JAX config; the CUDA kernel's
    # tiles are fixed by its design (ops/flash_attention.py).
    flash_block_q: int = 512
    flash_block_kv: int = 512
    mask_kind: str = "causal"
    mask_window: int = 0
    mask_prefix: int = 0

    def __post_init__(self):
        for field in ("dtype", "param_dtype"):
            val = getattr(self, field)
            if isinstance(val, str):
                try:
                    object.__setattr__(self, field, _DTYPES[val])
                except KeyError:
                    raise ValueError(f"{field} {val!r}: one of "
                                     f"{sorted(_DTYPES)}") from None

    @property
    def storage_dtype(self):
        """The dtype projections and the embedding are stored in."""
        return self.dtype if self.param_dtype is None else self.param_dtype

    @property
    def mask_spec(self):
        """MaskSpec for non-default masks, None for plain causal."""
        if self.mask_kind == "causal":
            return None
        return MaskSpec(self.mask_kind, window=self.mask_window,
                        prefix=self.mask_prefix)

    @property
    def num_params(self) -> int:
        """Parameter count as the JAX config counts it (for MFU)."""
        h, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        qkv = (h * self.num_heads * self.head_dim
               + 2 * h * self.num_kv_heads * self.head_dim)
        if self.attention_bias:
            qkv += (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        per_layer = qkv + self.num_heads * self.head_dim * h + 3 * h * m + 2 * h
        emb = v * h * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + emb + h


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny(vocab: int = 512) -> LlamaConfig:
    """Test-size config — same topology, toy dims."""
    return LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
        remat=False, flash_block_q=64, flash_block_kv=64)


def llama_1b() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=32768, hidden_size=2048, intermediate_size=5632,
        num_layers=16, num_heads=16, num_kv_heads=8, head_dim=128,
        max_seq_len=2048)


REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "save_attn")
LORA_TARGETS = ("attn", "attn_mlp")


def lora_projections(cfg: LlamaConfig) -> tuple[str, ...]:
    """The adapted projections of a layer, as `<block>.<proj>` names."""
    if cfg.lora_rank <= 0:
        return ()
    attn = ("attn.q_proj", "attn.v_proj")
    if cfg.lora_targets == "attn":
        return attn
    return attn + ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


MLP_ACTS = ("silu", "gelu_tanh")


def _check_supported(cfg: LlamaConfig) -> None:
    """Refuse, by name, every config flag this package does not port, and
    the values JAX refuses with a ValueError."""
    refused = [
        (cfg.attention_impl not in ("auto", "naive", "flash"),
         f"attention_impl={cfg.attention_impl!r} (ring/zigzag attention "
         "over a device mesh)"),
    ]
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: one of "
                         f"{list(REMAT_POLICIES)}")
    if cfg.lora_rank > 0 and cfg.lora_targets not in LORA_TARGETS:
        raise ValueError(f"lora_targets {cfg.lora_targets!r}: "
                         f"{' | '.join(LORA_TARGETS)}")
    if cfg.mlp_act not in MLP_ACTS:
        raise ValueError(f"mlp_act {cfg.mlp_act!r}: {' | '.join(MLP_ACTS)}")
    sliding_flags(cfg)  # raises on an unknown pattern that would be used
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not supported by this "
                                      "package yet")


def sliding_flags(cfg: LlamaConfig) -> list[bool] | None:
    """Each layer's kind (HF layer_types), True for a sliding layer, or
    None where the config has no per-layer kinds: they exist for an
    alternating `sliding_pattern` with a sliding-window mask or a local
    RoPE base. Gemma-3's dual RoPE needs them after the serving engine's
    causal view has dropped the mask, so they do not hang on the mask
    alone. JAX's traced flags, one static bool a layer."""
    if cfg.sliding_pattern == "all" or not (
            cfg.mask_kind == "sliding_window" or cfg.rope_theta_local):
        return None
    idx = range(cfg.num_layers)
    if cfg.sliding_pattern == "even":  # Gemma-2
        return [i % 2 == 0 for i in idx]
    if cfg.sliding_pattern == "5to1":  # Gemma-3: every 6th layer full
        return [(i + 1) % 6 != 0 for i in idx]
    raise ValueError(f"sliding_pattern {cfg.sliding_pattern!r}: "
                     "all | even | 5to1")


def config_view(module: nn.Module, cfg: LlamaConfig) -> nn.Module:
    """`module` under another config, without copying a weight: every
    module of the tree is a shallow copy sharing its parameters and buffers
    with the original, and each one that carries a config carries `cfg`
    (int8 projections stay `Int8Dense`). The original is unchanged: the
    engine serves a sliding-window model within its window through a
    causal view while the model itself keeps its windowed full forward."""
    view = copy.copy(module)
    view._modules = {name: None if child is None else config_view(child, cfg)
                     for name, child in module._modules.items()}
    if "cfg" in module.__dict__:
        view.cfg = cfg
    return view


class RMSNorm(nn.Module):
    """RMSNorm over the last dim in fp32 with an fp32 scale; `plus_one`
    (Gemma) applies (1 + scale), the scale zero at init."""

    def __init__(self, dim: int, eps: float, dtype, device,
                 plus_one: bool = False):
        super().__init__()
        self.eps, self.dtype, self.plus_one = eps, dtype, plus_one
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        scale = 1.0 + self.scale if self.plus_one else self.scale
        return (y * scale).to(self.dtype)


def _norm(cfg: LlamaConfig, dim: int, device) -> RMSNorm:
    return RMSNorm(dim, cfg.rms_eps, cfg.dtype, device, cfg.norm_plus_one)


def rope_table(head_dim: int, max_len: int, theta: float,
               cfg: LlamaConfig | None = None, device=None):
    """(cos, sin) [max_len, head_dim/2] fp32, with the config's linear and
    llama3 frequency scaling."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    if cfg is not None and cfg.rope_global_scaling_factor != 1.0:
        inv = inv / cfg.rope_global_scaling_factor
    if cfg is not None and cfg.rope_scaling_factor != 1.0:
        # Leave high frequencies alone, divide low ones by `factor`, and
        # interpolate in between (HF modeling_rope_utils "llama3").
        factor = cfg.rope_scaling_factor
        low = cfg.rope_scaling_low_freq_factor
        high = cfg.rope_scaling_high_freq_factor
        old_len = cfg.rope_scaling_original_max_len
        wavelen = 2 * math.pi / inv
        low_wl, high_wl = old_len / low, old_len / high
        smooth = ((old_len / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        scaled = (1 - smooth) * inv / factor + smooth * inv
        inv = torch.where(wavelen > low_wl, inv / factor,
                          torch.where(wavelen < high_wl, inv, scaled))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions):
    """x: [B, S, H, D]; positions: [B, S] absolute positions."""
    cos = cos[positions][:, :, None, :]
    sin = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: The Llama-only config fields that the serving path reads, with the
#: value a family without them stands for (GPT-2: causal, no window). JAX's
#: engine and init_cache read them through getattr with these defaults.
SERVING_DEFAULTS = {"mask_kind": "causal", "mask_window": 0,
                    "sliding_pattern": "all"}


def serving_field(cfg, name: str):
    """`cfg`'s field `name` of SERVING_DEFAULTS, or its default where the
    config has no such field."""
    return getattr(cfg, name, SERVING_DEFAULTS[name])


def rolling_window(cfg: LlamaConfig, length: int) -> int:
    """The window of the rolling cache that `cfg` gets at `length` rows (a
    sliding window on every layer, shorter than `length`), else 0. The one
    rule for whether a cache rolls: init_cache lays the cache out by it,
    the serving engine and its device functions read it, and attention
    follows the layout ("pos" in the cache)."""
    window = int(serving_field(cfg, "mask_window"))
    if (serving_field(cfg, "mask_kind") == "sliding_window"
            and serving_field(cfg, "sliding_pattern") == "all"
            and 0 < window < length):
        return window
    return 0


def init_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
               kv_quant: str = "none", device=None) -> dict:
    """Decode KV cache {"k","v"} of [L, B, T, KH, D] (the flat layout; the
    paged engine's pool is the same layout with B = blocks, T = block
    size). `kv_quant` "int8"/"fp8" stores K/V as codes of that type with
    per-row fp32 scale planes "ks"/"vs" of [L, B, T, KH].

    A sliding-window model whose window is shorter than the requested
    length (`rolling_window`) gets a ROLLING cache: T = window rows,
    written modulo the window, and a "pos" plane [L, B, window] of int32
    holding each row's absolute position (the sentinel -(window+1) for a
    row never written), so attention masks its reads exactly. A rolling
    cache never quantizes."""
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant {kv_quant!r}: must be one of "
                         f"{KV_QUANT_MODES}")
    t = max_len or cfg.max_seq_len
    cache = {}
    window = rolling_window(cfg, t)
    if window:
        if kv_quant != "none":
            raise ValueError("kv_quant does not compose with a rolling "
                             "sliding-window cache")
        t = window
        cache["pos"] = torch.full((cfg.num_layers, batch, t), -(window + 1),
                                  dtype=torch.int32, device=device)
    shape = (cfg.num_layers, batch, t, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant != "none":
        qdt = kv_qdtype(kv_quant)
        return {"k": torch.zeros(shape, dtype=qdt, device=device),
                "v": torch.zeros(shape, dtype=qdt, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device)}
    cache.update({"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                  "v": torch.zeros(shape, dtype=cfg.dtype, device=device)})
    return cache


def _update_rows(cache_leaf, new_rows, index):
    """Write new rows [B,S,...] into a per-layer plane [B,T,...] at per-row
    offsets index [B], in place (no host sync: the rows are an index
    tensor). Rows advance independently under continuous batching; the
    quantized cache's scale planes [B,T,KH] ride the same write.

    A multi-row write's start is clamped per row so that the whole write
    fits, as jax.lax.dynamic_update_slice clamps it: S rows asked at an
    index past T - S land at T - S (a speculative verify near the end of
    its cache bucket). A single row is the decode step's, whose index every
    caller already bounds by the cache length, and is written where asked."""
    b, s = new_rows.shape[:2]
    dev = new_rows.device
    start = index.to(torch.long)
    if s > 1:
        start = start.clamp(0, cache_leaf.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=dev)
    batch = torch.arange(b, device=dev)[:, None]
    cache_leaf[batch, rows] = new_rows.to(cache_leaf.dtype)


def _update_cache_rolling(cache, k, v, positions, index, window: int):
    """Modular writes into one layer's rolling cache {"k","v","pos"} ([B,
    window, ...] planes), in place: chunk row j of batch row b lands in
    row (index[b] + j) % window with its absolute position. A row whose
    position is negative (the engine's pad sentinel) keeps the target
    row's old K, V and position: a pad write must never evict a live row.
    Callers keep S <= window, so a chunk's target rows are distinct and
    gather-then-write is well defined. No host sync."""
    b, s = k.shape[:2]
    dev = k.device
    rows = (index.to(torch.long)[:, None]
            + torch.arange(s, device=dev)) % window
    batch = torch.arange(b, device=dev)[:, None]
    valid = positions >= 0
    for name, new in (("k", k), ("v", v), ("pos", positions)):
        leaf = cache[name]
        keep = valid.view(b, s, *([1] * (new.dim() - 2)))
        leaf[batch, rows] = torch.where(keep, new.to(leaf.dtype),
                                        leaf[batch, rows])


def _dense(cfg: LlamaConfig, in_features: int, out_features: int, device,
           bias: bool = False):
    """The projection class at every site: `Dense`, or `Int8Dense` under
    `cfg.quantized_dense` (the JAX `_dense_cls`)."""
    if cfg.quantized_dense:
        return Int8Dense(in_features, out_features, cfg.dtype, device,
                         bias=bias, bias_dtype=cfg.storage_dtype)
    return Dense(cfg, in_features, out_features, device, bias=bias)


class Dense(nn.Linear):
    """An nn.Linear stored in `cfg.storage_dtype` and applied in
    `cfg.dtype` (flax DenseGeneral with dtype and param_dtype): the product
    is rounded to `cfg.dtype`, then the bias, cast to it, is added, as
    DenseGeneral does. With equal dtypes and no bias the cast is a no-op
    and this is nn.Linear."""

    def __init__(self, cfg: LlamaConfig, in_features: int,
                 out_features: int, device, bias: bool = False):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=cfg.storage_dtype, device=device)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        y = F.linear(x, self.weight.to(self.compute_dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype)
        return y


def _add_lora(block: nn.Module, block_name: str, cfg: LlamaConfig,
              dims: dict, device) -> None:
    """Register `<proj>_lora_a` [r, in] and `<proj>_lora_b` [out, r] on
    `block` for each of its projections the config adapts (allocated, not
    initialised: `Llama.init_weights` draws A and zeroes B)."""
    block.lora = tuple(p.split(".")[1] for p in lora_projections(cfg)
                       if p.startswith(block_name + "."))
    r, dt = cfg.lora_rank, cfg.storage_dtype
    for name in block.lora:
        n_in, n_out = dims[name]
        block.register_parameter(f"{name}_lora_a", nn.Parameter(
            torch.empty(r, n_in, dtype=dt, device=device)))
        block.register_parameter(f"{name}_lora_b", nn.Parameter(
            torch.empty(n_out, r, dtype=dt, device=device)))


class AdapterRows(dict):
    """Multi-LoRA factors selected per batch row: {projection: (a [L, B,
    in, r], b [L, B, r, out])}, b already scaled by alpha/r. Made by
    `adapter_rows`; layer i reads views a[i], b[i]."""


def adapter_rows(stacks: dict, ids, dtype) -> AdapterRows:
    """Each row's entry of the multi-LoRA stacks (serve/multilora.py):
    `ids` [B] indexes axis 1 of every "a"/"b" stack, entry 0 being the
    zero (base) adapter. One gather per factor, no host sync."""
    ids = ids.to(torch.long)
    return AdapterRows({m: tuple(torch.index_select(ab[k], 1, ids).to(dtype)
                                 for k in ("a", "b"))
                        for m, ab in stacks.items()})


def _project(block: nn.Module, name: str, x, rows=None):
    """The projection `name` of x, plus its LoRA delta (x @ A) @ B *
    alpha/rank when the config adapts it: x, A and B cast to cfg.dtype, as
    the JAX `_lora_delta`'s dot_generals. `rows` ({name: (a [B, in, r],
    b [B, r, out])}, one layer of `AdapterRows`) adds each row's
    multi-LoRA delta (x @ a) @ b after it, in x's dtype (the JAX
    `_multi_lora_delta`): a base row's zero factors add exact zeros."""
    out = getattr(block, name)(x)
    if name in block.lora:
        cfg = block.cfg
        dt = cfg.dtype
        a = getattr(block, f"{name}_lora_a").to(dt)
        b = getattr(block, f"{name}_lora_b").to(dt)
        out = out + F.linear(F.linear(x.to(dt), a), b) * (
            cfg.lora_alpha / cfg.lora_rank)
    if rows is not None and name in rows:
        a, b = rows[name]
        out = out + torch.bmm(torch.bmm(x, a), b)
    return out


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        d, dh = cfg.hidden_size, cfg.head_dim
        bias = cfg.attention_bias
        self.q_proj = _dense(cfg, d, cfg.num_heads * dh, device, bias)
        self.k_proj = _dense(cfg, d, cfg.num_kv_heads * dh, device, bias)
        self.v_proj = _dense(cfg, d, cfg.num_kv_heads * dh, device, bias)
        self.o_proj = _dense(cfg, cfg.num_heads * dh, d, device)
        _add_lora(self, "attn", cfg, {"q_proj": (d, cfg.num_heads * dh),
                                      "v_proj": (d, cfg.num_kv_heads * dh)},
                  device)
        if cfg.qk_norm:
            self.q_norm = _norm(cfg, dh, device)
            self.k_norm = _norm(cfg, dh, device)

    def forward(self, x, cos, sin, positions, standard_positions=True,
                cache=None, cache_index=None, segment_ids=None,
                attend_full_cache=False, adapter=None, sliding=None):
        """`sliding` is this layer's kind (`sliding_flags`): None where the
        config has none, else True on a sliding layer (the window's band)
        and False on a full one (causal). `cos`/`sin` are the layer's RoPE
        table, chosen by the caller."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rolling = cache is not None and "pos" in cache
        # A rolling decode chunk that runs past the context end may ask for
        # positions past the RoPE table: its lookups clamp to the last row,
        # as JAX's gather does (the pad sentinel wraps, as it does there).
        rope_pos = (positions.clamp_max(cos.shape[0] - 1) if rolling
                    else positions)
        # Each LoRA delta lands on its projection's output; then the qk
        # norms and the query_pre_attn_scalar fold, before RoPE (the norm
        # would erase a scale applied before it).
        q = _project(self, "q_proj", x, adapter).view(b, s, h, dh)
        k = self.k_proj(x).view(b, s, kh, dh)
        v = _project(self, "v_proj", x, adapter).view(b, s, kh, dh)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if cfg.query_pre_attn_scalar:
            # Every attention impl divides by sqrt(head_dim): fold the
            # ratio into q, rounded to q's dtype as JAX rounds it.
            q = q * torch.tensor(
                dh ** 0.5 / cfg.query_pre_attn_scalar ** 0.5, dtype=q.dtype,
                device=q.device)
        q = apply_rope(q, cos, sin, rope_pos)
        k = apply_rope(k, cos, sin, rope_pos)
        mask_spec = cfg.mask_spec
        # The layer's mask: a full layer of an alternating model is causal.
        layer_mask = None if sliding is False else mask_spec
        softcap = cfg.attn_softcap
        if rolling:
            out = self._attend_rolling(q, k, v, positions, cache, cache_index)
            return self.o_proj(out.reshape(b, s, h * dh))
        if (mask_spec is not None and cache is not None
                and not (mask_spec.kind == "sliding_window"
                         and sliding is not None)):
            raise ValueError(
                "attention mask specs don't compose with KV-cache decode: "
                "serve masked models with a full forward (sliding_window "
                "checkpoints roll when the cache is built with max_len > "
                "window)")
        if cache is not None:
            k_scale = v_scale = None
            if "ks" in cache:
                # Quantized cache: quantize only the new rows, write codes
                # and scales at the per-row offsets, and attend over the
                # raw codes cast to the compute dtype with the scale planes
                # applied to scores and probabilities (no dequantized
                # cache is made).
                mode = "int8" if cache["k"].dtype == torch.int8 else "fp8"
                kq, ks = kv_quantize_rows(k, mode)
                vq, vs = kv_quantize_rows(v, mode)
                for name, rows in (("k", kq), ("v", vq), ("ks", ks),
                                   ("vs", vs)):
                    _update_rows(cache[name], rows, cache_index)
                ck, cv = cache["k"].to(k.dtype), cache["v"].to(v.dtype)
                k_scale, v_scale = cache["ks"], cache["vs"]
            else:
                ck, cv = cache["k"], cache["v"]
                _update_rows(ck, k, cache_index)
                _update_rows(cv, v, cache_index)
            if s == 1 or attend_full_cache:
                # Decode or a continuation chunk: attend over the whole
                # cache; causality and the unwritten tail (incl. stale rows
                # of a previous slot occupant) are masked by positions.
                # An alternating model past its window keeps the whole
                # history and its sliding layers band their reads here.
                t = ck.shape[1]
                pos_kv = torch.arange(t, device=x.device).expand(b, t)
                out = naive_attention(q, ck, cv, causal=True,
                                      positions_q=positions,
                                      positions_kv=pos_kv, softcap=softcap,
                                      mask=layer_mask, k_scale=k_scale,
                                      v_scale=v_scale)
                return self.o_proj(out.reshape(b, s, h * dh))
            # Prefill (cache_index 0): nothing precedes the new tokens, so
            # attention over just k/v is exact — the fused path serves it.
        if softcap or (sliding is not None and mask_spec is not None):
            # The score cap and the per-layer band are not in the fused
            # kernels (nor in JAX's): the einsum path is the only correct
            # one. A per-layer kind alone does not force it: Gemma-3's
            # causal view keeps its kinds for the dual RoPE, and flash is
            # exact there.
            if cfg.attention_impl not in ("auto", "naive"):
                raise ValueError(
                    f"attn_softcap / alternating sliding layers need "
                    f"attention_impl 'naive', not {cfg.attention_impl!r}")
            out = naive_attention(q, k, v, causal=True, positions_q=positions,
                                  positions_kv=positions,
                                  segment_ids=segment_ids, mask=layer_mask,
                                  softcap=softcap)
            return self.o_proj(out.reshape(b, s, h * dh))
        impl = cfg.attention_impl
        if impl == "auto":
            flashable = standard_positions or segment_ids is not None
            takes = cuda_flash_takes(q.dtype, dh, q.device)
            if flashable and q.is_cuda and not takes:
                raise ValueError(
                    f"attention_impl='auto' on CUDA: no flash kernel takes "
                    f"{q.dtype} at head_dim {dh} (the CUDA-core kernels stop "
                    f"at 256); set attention_impl='naive'")
            impl = "flash" if flashable and takes else "naive"
        if impl == "flash" and not standard_positions and segment_ids is None:
            raise ValueError(
                "attention_impl='flash' masks causality by index; custom "
                "positions need segment_ids or attention_impl='naive'")
        if impl == "flash":
            out = flash_attention(q, k, v, causal=True,
                                  block_q=cfg.flash_block_q,
                                  block_kv=cfg.flash_block_kv,
                                  segment_ids=segment_ids, mask=mask_spec)
        else:
            out = naive_attention(q, k, v, causal=True, positions_q=positions,
                                  positions_kv=positions,
                                  segment_ids=segment_ids, mask=mask_spec)
        return self.o_proj(out.reshape(b, s, h * dh))

    def _attend_rolling(self, q, k, v, positions, cache, cache_index):
        """Attention of a chunk (prefill, continuation or decode) over a
        rolling cache, then its write. The read comes first: the chunk's
        own modular writes may evict rows its earliest queries still see.
        Rows holding positions >= cache_index (left stale by a rewind) are
        masked to the sentinel; the fresh chunk's K/V ride beside the
        cache in the read, under the sliding-window mask."""
        window = int(self.cfg.mask_window)
        cpos = torch.where(cache["pos"] >= cache_index[:, None],
                           -(window + 1), cache["pos"])
        keys = torch.cat([cache["k"].to(k.dtype), k], dim=1)
        vals = torch.cat([cache["v"].to(v.dtype), v], dim=1)
        pos_kv = torch.cat([cpos.to(positions.dtype), positions], dim=1)
        out = naive_attention(q, keys, vals, causal=True,
                              positions_q=positions, positions_kv=pos_kv,
                              mask=self.cfg.mask_spec,
                              softcap=self.cfg.attn_softcap)
        _update_cache_rolling(cache, k, v, positions, cache_index, window)
        return out


class MLPBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(cfg, d, i, device)
        self.up_proj = _dense(cfg, d, i, device)
        self.down_proj = _dense(cfg, i, d, device)
        _add_lora(self, "mlp", cfg, {"gate_proj": (d, i), "up_proj": (d, i),
                                     "down_proj": (i, d)}, device)

    def forward(self, x, adapter=None):
        gate = _project(self, "gate_proj", x, adapter)
        act = (F.silu(gate) if self.cfg.mlp_act == "silu"
               else F.gelu(gate, approximate="tanh"))  # Gemma's GeGLU
        h = act * _project(self, "up_proj", x, adapter)
        return _project(self, "down_proj", h, adapter)


#: The MLP projections a multi-LoRA stack can adapt; DecoderLayer hands
#: the MLP only these (the JAX layer's `mlp_ad`).
MLP_PROJECTIONS = ("gate_proj", "up_proj", "down_proj")


class DecoderLayer(nn.Module):
    """`mlp_cls` is the layer's FFN class (JAX's `mlp_cls`): None is the
    dense `MLPBlock`; models/moe.py passes its routed-expert `MoEBlock`."""

    def __init__(self, cfg: LlamaConfig, device, mlp_cls=None):
        super().__init__()
        d = cfg.hidden_size
        self.input_norm = _norm(cfg, d, device)
        self.attn = Attention(cfg, device)
        # With sandwich norms this plays HF's pre_feedforward_layernorm.
        self.post_attn_norm = _norm(cfg, d, device)
        self.mlp = (mlp_cls or MLPBlock)(cfg, device)
        # Gemma-2's sandwich norms on the branch outputs (HF
        # post_attention_layernorm, post_feedforward_layernorm).
        self.attn_out_norm = (_norm(cfg, d, device) if cfg.sandwich_norms
                              else None)
        self.mlp_out_norm = (_norm(cfg, d, device) if cfg.sandwich_norms
                             else None)

    def forward(self, x, cos, sin, positions, standard_positions=True,
                cache=None, cache_index=None, segment_ids=None,
                attend_full_cache=False, adapter=None, sliding=None,
                with_aux=False):
        """The layer's output; with `with_aux` (routed experts only),
        (output, the FFN's load-balance term)."""
        x = x + self._attn_out(self.attn(
            self.input_norm(x), cos, sin, positions, standard_positions,
            cache, cache_index, segment_ids, attend_full_cache, adapter,
            sliding))
        if with_aux:
            out, aux = self.mlp_branch(x, adapter, with_aux=True)
            return x + out, aux
        return x + self.mlp_branch(x, adapter)

    def _attn_out(self, out):
        return out if self.attn_out_norm is None else self.attn_out_norm(out)

    def attn_branch(self, x, cos, sin, positions, standard_positions=True,
                    segment_ids=None, sliding=None):
        """The attention block's output (after o_proj, and after the
        sandwich norm) of a training forward: what JAX names "attn_out"
        for the save_attn policy."""
        return self._attn_out(self.attn(
            self.input_norm(x), cos, sin, positions, standard_positions,
            segment_ids=segment_ids, sliding=sliding))

    def mlp_branch(self, x, adapter=None, with_aux=False):
        if adapter is not None:  # only the MLP's own factors, or None
            adapter = {k: adapter[k] for k in MLP_PROJECTIONS
                       if k in adapter} or None
        if with_aux:
            out, aux = self.mlp(self.post_attn_norm(x), adapter,
                                with_aux=True)
        else:
            out = self.mlp(self.post_attn_norm(x), adapter)
        out = out if self.mlp_out_norm is None else self.mlp_out_norm(out)
        return (out, aux) if with_aux else out


_SAVED_PRODUCTS = {  # remat policy: the ops whose outputs it keeps
    "dots": [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default],
    "dots_no_batch": [torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default],
}


def _remat_layer(policy: str, layer: DecoderLayer, x, cos, sin, positions,
                 standard_positions, segment_ids, sliding, with_aux=False):
    """One training DecoderLayer under `torch.utils.checkpoint`, keeping
    what `policy` keeps (see LlamaConfig.remat_policy). The flash kernels
    are launched through ctypes, out of the dispatcher's sight: no policy
    keeps their output, so the recompute launches them again, as JAX's
    recompute runs the Pallas kernel again. With `with_aux` the
    load-balance term is an output of the checkpointed function, so the
    backward's recompute never adds it a second time."""
    if policy == "save_attn":
        # Two regions, so the saved inputs are the layer's input and x +
        # attn_out: as much as JAX keeps for checkpoint_name("attn_out").
        x = x + checkpoint(layer.attn_branch, x, cos, sin, positions,
                           standard_positions, segment_ids, sliding,
                           use_reentrant=False)
        if with_aux:
            out, aux = checkpoint(layer.mlp_branch, x, None, True,
                                  use_reentrant=False)
            return x + out, aux
        return x + checkpoint(layer.mlp_branch, x, use_reentrant=False)
    kwargs = {}
    if policy in _SAVED_PRODUCTS:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _SAVED_PRODUCTS[policy])
    return checkpoint(layer, x, cos, sin, positions, standard_positions,
                      None, None, segment_ids, False, None, sliding,
                      with_aux, use_reentrant=False, **kwargs)


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def draw_weights(mod: nn.Module, gen: torch.Generator) -> None:
    """`mod`'s own weights (not its children's) from `gen`, as
    `Llama.init_weights` draws them: an nn.Linear N(0, 1/fan_in) with a
    zero bias, an RMSNorm's scale 1 (0 for (1 + w)), and a module with its
    own `draw_weights(gen)` (the routed experts) by that."""
    if isinstance(mod, nn.Linear):
        mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=gen)
        if mod.bias is not None:
            mod.bias.zero_()
    elif isinstance(mod, RMSNorm):
        mod.scale.fill_(0.0 if mod.plus_one else 1.0)
    elif hasattr(mod, "draw_weights"):
        mod.draw_weights(gen)


class Llama(nn.Module):
    """Causal LM. `forward` returns logits [B, S, V] in cfg.dtype.

    `device` defaults to CUDA and raises when CUDA is absent; pass
    device="cpu" to run on the CPU. Parameters are allocated, not
    initialised: load a state dict or call `init_weights(seed)`. With
    `cfg.remat` and grad enabled, each DecoderLayer runs under
    `torch.utils.checkpoint` with `cfg.remat_policy` (its forward, flash
    kernel included, runs again in the backward).

    With `cfg.quantized_dense` every projection is an `Int8Dense` and the
    embedding an `Int8Dense` table (codes [V, D], scales [V]); such a model
    takes its weights from a state dict (`quantize_model` makes one from a
    float model). `mlp_cls` is every layer's FFN class (None: the dense
    `MLPBlock`; `models.moe.MoELlama` passes `MoEBlock`).

    `device="meta"` allocates nothing: `serve.quant.init_quantized` fills
    such a model part by part."""

    def __init__(self, cfg: LlamaConfig, device=None, mlp_cls=None):
        super().__init__()
        _check_supported(cfg)
        device = (torch.device("meta") if _is_meta(device)
                  else resolve_device(device))
        self.cfg = cfg
        if cfg.quantized_dense:
            self.embed = Int8Dense(cfg.hidden_size, cfg.vocab_size,
                                   cfg.dtype, device)
        else:
            self.embed = nn.Parameter(torch.empty(
                cfg.vocab_size, cfg.hidden_size, dtype=cfg.storage_dtype,
                device=device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, mlp_cls)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _norm(cfg, cfg.hidden_size, device)
        self.lm_head = (None if cfg.tie_embeddings else _dense(
            cfg, cfg.hidden_size, cfg.vocab_size, device))
        self.set_rope_tables(device)

    def set_rope_tables(self, device) -> None:
        """(Re)make the RoPE tables on `device` (non-persistent buffers)."""
        cfg = self.cfg
        cos, sin = rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                              cfg, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        if cfg.rope_theta_local:
            # Gemma-3's sliding layers: the local base, never scaled.
            cos, sin = rope_table(cfg.head_dim, cfg.max_seq_len,
                                  cfg.rope_theta_local, device=device)
            self.register_buffer("rope_local_cos", cos, persistent=False)
            self.register_buffer("rope_local_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.rope_cos.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Llama":
        """Random weights from `seed` on the model's own device: embedding
        N(0, 0.02), projections N(0, 1/fan_in) (LeCun normal, untruncated),
        biases zero, norm scales 1 (0 for (1 + w) norms), LoRA A N(0, 0.02)
        and B zero (so the adapted model starts as the base). A quantized
        model is refused: initialise the float model, then quantize it."""
        if self.cfg.quantized_dense:
            raise ValueError("init_weights needs a float model; quantize "
                             "after initialising (serve.quant.quantize_model)")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.embed.normal_(0.0, 0.02, generator=gen)
        for mod in self.modules():
            draw_weights(mod, gen)
        for name, p in self.named_parameters():
            if name.endswith("_lora_a"):
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith("_lora_b"):
                p.zero_()
        return self

    @property
    def sows_aux(self) -> bool:
        """Whether the layers' FFNs are routed experts (an `MoEConfig`)
        with a load-balance term (`forward(..., return_aux=True)` sums
        it)."""
        return hasattr(self.cfg, "num_experts")

    def forward(self, tokens, positions=None, cache: dict | None = None,
                cache_index=None, return_hidden: bool = False,
                segment_ids=None, attend_full_cache: bool = False,
                adapter=None, adapter_ids=None, return_aux: bool = False):
        """With `cache` (see init_cache) returns (logits, cache): prefill
        when S>1 at cache_index 0, single-token decode when S==1 (positions
        default to cache_index), and a continuation when S>1 with
        `attend_full_cache=True` (pass absolute `positions`). The cache is
        written in place. `return_hidden` skips the unembedding and returns
        the final-norm hidden states [B,S,D]. `segment_ids` [B,S] confines
        attention within equal-id spans. `return_aux` (a training forward
        of routed experts, `sows_aux`) returns (out, the sum of every
        layer's load-balance term), JAX's summed `aux_loss` collection.

        Multi-LoRA serving: `adapter` is the stacks of
        serve/multilora.build_adapter_stacks ({projection: {"a": [L, N+1,
        in, r], "b": [L, N+1, r, out]}}) and `adapter_ids` [B] picks each
        row's entry (default 0, the base), or `adapter` is an
        `AdapterRows` already gathered (`adapter_rows`) and `adapter_ids`
        is None. Each adapted projection of each row gets (x @ a) @ b."""
        b, s = tokens.shape
        if adapter is not None and not isinstance(adapter, AdapterRows):
            if adapter_ids is None:
                adapter_ids = torch.zeros(b, dtype=torch.long,
                                          device=tokens.device)
            adapter = adapter_rows(adapter, adapter_ids, self.cfg.dtype)
        elif adapter_ids is not None:
            raise ValueError("adapter_ids select from adapter stacks; "
                             "pass the stacks as `adapter`")
        if cache is not None:
            if cache_index is None:
                cache_index = torch.zeros(b, dtype=torch.int32,
                                          device=tokens.device)
            if positions is None and s == 1:
                positions = cache_index[:, None]
        standard_positions = positions is None
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        cfg = self.cfg
        # Rows first, then the cast: the same values as JAX's
        # embed.astype(dtype)[tokens], and the gradient scatter-adds in the
        # storage dtype.
        x = quant_embed_lookup(self.embed, tokens, cfg.dtype)
        if cfg.embed_scale:
            # Gemma: the sqrt(hidden) multiplier is rounded to the
            # activation dtype first, as HF and JAX round it.
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype,
                                 device=x.device)
        kinds = sliding_flags(cfg)
        remat = (cfg.remat and cache is None
                 and torch.is_grad_enabled())
        if return_aux and (cache is not None or not self.sows_aux):
            raise ValueError("return_aux: a training forward (no cache) of "
                             "a model with routed experts")
        aux = None
        for i, layer in enumerate(self.layers):
            sliding = None if kinds is None else kinds[i]
            cos, sin = ((self.rope_local_cos, self.rope_local_sin)
                        if sliding and cfg.rope_theta_local
                        else (self.rope_cos, self.rope_sin))
            if remat:
                x = _remat_layer(cfg.remat_policy, layer, x, cos, sin,
                                 positions, standard_positions, segment_ids,
                                 sliding, return_aux)
            else:
                layer_cache = (None if cache is None
                               else {n: c[i] for n, c in cache.items()})
                layer_ad = (None if adapter is None else
                            {m: (a[i], bb[i])
                             for m, (a, bb) in adapter.items()})
                x = layer(x, cos, sin, positions, standard_positions,
                          layer_cache, cache_index, segment_ids,
                          attend_full_cache, layer_ad, sliding, return_aux)
            if return_aux:
                x, layer_aux = x
                aux = layer_aux if aux is None else aux + layer_aux
        x = self.final_norm(x)
        out = x if return_hidden else self.unembed(x)
        if cache is not None:
            return out, cache
        return (out, aux) if return_aux else out

    def unembed(self, x):
        """Logits [..., V] of final-norm hidden states [..., D]: the head,
        or the tied embedding, then Gemma-2's final soft-cap."""
        if self.lm_head is None:
            logits = quant_unembed(x, self.embed, self.cfg.dtype)
        else:
            logits = self.lm_head(x)
        cap = self.cfg.final_softcap
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return logits
