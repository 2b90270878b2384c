"""GPT-2 decoder family: learned positions, biased MHA, pre-LN.

The port of `kubeflow_tpu/models/gpt2.py`. The module keeps the port's
Llama cache contract (models/llama.py: `tokens, positions, cache,
cache_index, attend_full_cache, return_hidden` -> (logits, cache), with the
layer-stacked [L, B, T, H, D] cache of `llama.init_cache`, written in
place by `llama._update_rows`), plus `unembed`, so the generation engine
serves GPT-2 checkpoints flat, paged, with the prefix cache, streaming and
behind the OpenAI surface as it serves a Llama.

Differences from the Llama, as in JAX: learned absolute positions
(`wpe[positions]`, no RoPE), LayerNorm with a bias (eps 1e-5), q/k/v/o
projections with biases and the 1/sqrt(d) scaling of `naive_attention`,
a tanh-GELU MLP with biases, `ln_f` before the hidden states are returned,
and the head tied to `wte` in the compute dtype with fp32 logits. Every
branch (prefill, decode, continuation) runs `ops/reference.py::
naive_attention` with positions, as JAX's does: no Pallas kernel lies on
this family's path in either package.

Where weights live is `cfg.param_dtype`, as for the Llama: None stores
them in `cfg.dtype` (the serving layout), torch.float32 keeps fp32 weights
cast to `cfg.dtype` at each use (JAX's param_dtype). LayerNorm parameters
are fp32 either way. The two embeddings are summed in fp32 and then cast,
as JAX sums its fp32 tables; stored in bf16, each table is rounded before
the sum. Under `quantize: int8` (serve/quant.quantize_fixed) the
projections are `Int8Dense`, `wte` an `Int8Dense` table (one scale per
vocab row: the lookup gathers rows and scales, the tied head runs the
W8A16 op) and `wpe` an `Int8Table` (one scale per column).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.bert import LayerNorm
from kubeflow_tpu_torch.models.llama import Dense, _update_rows
from kubeflow_tpu_torch.models.mlp import as_dtype
from kubeflow_tpu_torch.ops.reference import naive_attention
from kubeflow_tpu_torch.serve.quant import (Int8Table, quant_embed_lookup,
                                            quant_unembed)
from kubeflow_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # None = `dtype` (serving); torch.float32 = fp32 weights cast at use.
    param_dtype: Any = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        if self.param_dtype is not None:
            object.__setattr__(self, "param_dtype",
                               as_dtype(self.param_dtype))

    # The engine's cache is laid out from these (llama.init_cache): GPT-2
    # is multi-head, so kv heads == heads.
    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def storage_dtype(self):
        return self.dtype if self.param_dtype is None else self.param_dtype

    @property
    def num_params(self) -> int:
        h, n = self.hidden_size, self.num_layers
        return (self.vocab_size * h + self.max_seq_len * h
                + n * (4 * h * h + 2 * h * self.intermediate_size))


def gpt2_small() -> GPT2Config:
    return GPT2Config()


def gpt2_tiny() -> GPT2Config:
    return GPT2Config(vocab_size=96, hidden_size=32, num_layers=2,
                      num_heads=4, intermediate_size=64, max_seq_len=64)


def _rows(table, idx):
    """Rows of an embedding table: a float Parameter's, an Int8Table's
    dequantized, or an Int8Dense table's gathered with their scales; fp32
    for the sum."""
    if isinstance(table, Int8Table):
        return table.rows(idx).float()
    return quant_embed_lookup(table, idx, torch.float32)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln_1 = LayerNorm(h, eps, cfg.dtype, device)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, Dense(cfg, h, h, device, bias=True))
        self.ln_2 = LayerNorm(h, eps, cfg.dtype, device)
        self.fc = Dense(cfg, h, cfg.intermediate_size, device, bias=True)
        self.proj = Dense(cfg, cfg.intermediate_size, h, device, bias=True)

    def forward(self, x, positions, cache=None, cache_index=None,
                attend_full_cache=False):
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        h = self.ln_1(x)
        q = self.q_proj(h).view(b, s, nh, hd)
        k = self.k_proj(h).view(b, s, nh, hd)
        v = self.v_proj(h).view(b, s, nh, hd)
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            _update_rows(ck, k, cache_index)
            _update_rows(cv, v, cache_index)
        if cache is not None and (s == 1 or attend_full_cache):
            # Decode or a continuation chunk: the whole cache, masked by
            # positions (the unwritten tail and a previous occupant's rows
            # lie past every query's position).
            t = ck.shape[1]
            pos_kv = torch.arange(t, device=x.device).expand(b, t)
            attn = naive_attention(q, ck.to(cfg.dtype), cv.to(cfg.dtype),
                                   causal=True, positions_q=positions,
                                   positions_kv=pos_kv)
        else:
            attn = naive_attention(q, k, v, causal=True,
                                   positions_q=positions,
                                   positions_kv=positions)
        x = x + self.o_proj(attn.reshape(b, s, nh * hd))
        h = F.gelu(self.fc(self.ln_2(x)), approximate="tanh")  # gelu_new
        return x + self.proj(h)


class GPT2(nn.Module):
    """Causal LM over the Llama cache contract. `device` defaults to CUDA
    and raises when CUDA is absent; pass device="cpu" for the CPU.
    Parameters are allocated, not initialised: load a state dict or call
    `init_weights(seed)`."""

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.storage_dtype
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, h, dtype=dt,
                                            device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, h, dtype=dt,
                                            device=device))
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.ln_f.scale.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "GPT2":
        """Random weights from `seed` on the model's own device: both
        tables N(0, 0.02), projections N(0, 1/fan_in) (LeCun normal,
        untruncated) with zero biases, LayerNorms the identity."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.wte.normal_(0.0, 0.02, generator=gen)
        self.wpe.normal_(0.0, 0.02, generator=gen)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5,
                                   generator=gen)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        return self

    def forward(self, tokens, positions=None, cache: dict | None = None,
                cache_index=None, attend_full_cache: bool = False,
                return_hidden: bool = False, adapter=None):
        """With `cache` (llama.init_cache of this config) returns (logits,
        cache): prefill when S > 1 at cache_index 0, single-token decode
        when S == 1 (positions default to cache_index), a continuation
        when S > 1 with `attend_full_cache` (pass absolute `positions`).
        The cache is written in place. `return_hidden` returns the
        ln_f hidden states [B, S, D] instead of the logits. GPT-2 has no
        adapter path: `adapter` must be None."""
        if adapter is not None:
            raise ValueError("GPT-2 has no LoRA adapter path")
        cfg = self.cfg
        b, s = tokens.shape
        if cache is not None:
            if "ks" in cache or "pos" in cache:
                raise ValueError("GPT-2 serves from a plain K/V cache (no "
                                 "kv_quant, no rolling window)")
            if cache_index is None:
                cache_index = torch.zeros(b, dtype=torch.int32,
                                          device=tokens.device)
            if positions is None and s == 1:
                # A one-token decode sits at its cache write offset.
                positions = cache_index[:, None]
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        # Out-of-range positions (a padded chunk's tail) read the last row,
        # as JAX's gather clamps; such rows are never attended.
        wpe_rows = positions.clamp(0, cfg.max_seq_len - 1)
        x = (_rows(self.wte, tokens) + _rows(self.wpe, wpe_rows)).to(
            cfg.dtype)
        for i, block in enumerate(self.blocks):
            layer_cache = (None if cache is None
                           else {"k": cache["k"][i], "v": cache["v"][i]})
            x = block(x, positions, layer_cache, cache_index,
                      attend_full_cache)
        x = self.ln_f(x)
        out = x if return_hidden else self.unembed(x)
        return (out, cache) if cache is not None else out

    def unembed(self, x):
        """fp32 logits [..., V] of ln_f hidden states: the head tied to
        `wte`, in the compute dtype (an int8 table through the W8A16
        op)."""
        return quant_unembed(x, self.wte, self.cfg.dtype).float()
