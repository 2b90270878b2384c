"""T5 encoder-decoder: the text2text model family (T5, MT5, UMT5).

The port of `kubeflow_tpu/models/t5.py`, with the details that break naive
ports: RMS layer norm in fp32 with no mean subtraction and no bias; NO
sqrt(d) attention scaling; scores widened to fp32, the bucketed
relative-position bias added in fp32 (owned by the first block of each
stack: bidirectional for the encoder, causal for the decoder, none for
cross attention; UMT5 gives every layer its own table,
`per_layer_rel_bias`), masked to -1e30, and the probabilities cast to the
compute dtype before the value product; pre-LN residual blocks; a relu
FFN (T5 v1.0) or a gated tanh-GELU one ("gated-gelu", v1.1/Flan); and the
head tied to `shared` with the d_model**-0.5 rescale, or an untied
`lm_head`.

Generation is `greedy_generate`: the encoder and each decoder layer's
cross K/V once, then exactly `max_tokens` decoder steps over a
self-attention KV cache. The argmax, the done mask and the EOS padding
stay on the device, so nothing reaches the host inside the loop: the
counterpart of JAX's one-program `lax.scan`, one host fetch a request.

Where weights live is `cfg.param_dtype`, as for the Llama: None stores the
projections and `shared` in `cfg.dtype`, torch.float32 keeps fp32 weights
cast at each use (JAX's param_dtype). Norm scales and the relative-position
tables are fp32 either way. Under `quantize: int8`
(serve/quant.quantize_fixed) the projections and an untied head become
`Int8Dense`, and `shared` an `Int8Dense` table (one scale per vocab row).
No Pallas kernel lies on this family's path in either package: attention
is an einsum with the bias.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.llama import Dense
from kubeflow_tpu_torch.models.mlp import as_dtype
from kubeflow_tpu_torch.serve.quant import quant_embed_lookup, quant_unembed
from kubeflow_tpu_torch.utils.devices import resolve_device

FEED_FORWARD_PROJ = ("relu", "gated-gelu")


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6          # encoder
    num_decoder_layers: int = 6
    num_heads: int = 8
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    feed_forward_proj: str = "relu"   # "relu" (v1.0) | "gated-gelu" (v1.1)
    # UMT5: every layer owns its relative-position bias table (T5/MT5
    # share block 0's across the stack).
    per_layer_rel_bias: bool = False
    tie_embeddings: bool = True
    decoder_start_id: int = 0
    eos_id: int = 1
    dtype: Any = torch.bfloat16
    # None = `dtype` (serving); torch.float32 = fp32 weights cast at use.
    param_dtype: Any = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        if self.param_dtype is not None:
            object.__setattr__(self, "param_dtype",
                               as_dtype(self.param_dtype))

    @property
    def gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    @property
    def storage_dtype(self):
        return self.dtype if self.param_dtype is None else self.param_dtype

    @property
    def num_params(self) -> int:
        e = self.vocab_size * self.d_model
        att = 4 * self.d_model * self.num_heads * self.d_kv
        ff = (3 if self.gated else 2) * self.d_model * self.d_ff
        enc = self.num_layers * (att + ff)
        dec = self.num_decoder_layers * (2 * att + ff)
        return e * (1 if self.tie_embeddings else 2) + enc + dec


def t5_small() -> T5Config:
    return T5Config()


def t5_tiny() -> T5Config:
    return T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                    num_layers=2, num_decoder_layers=2, num_heads=4,
                    rel_buckets=8, rel_max_distance=16)


class T5LayerNorm(nn.Module):
    """RMS norm: fp32 statistics, no bias, no mean subtraction, an fp32
    scale; the result in the input's dtype."""

    def __init__(self, dim: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (xf * self.scale).to(x.dtype)


def relative_position_bucket(rel_pos, *, bidirectional: bool,
                             num_buckets: int, max_distance: int):
    """T5's log-bucketed map from relative positions (an integer tensor,
    key minus query) to bucket indices, in JAX's arithmetic: the log ratio
    in fp32, truncated toward zero."""
    ret = torch.zeros_like(rel_pos)
    n = num_buckets
    if bidirectional:
        n = n // 2
        ret = ret + torch.where(rel_pos > 0, n, 0)
        rel_pos = rel_pos.abs()
    else:
        rel_pos = -torch.clamp_max(rel_pos, 0)
    max_exact = n // 2
    is_small = rel_pos < max_exact
    # log(max_distance / max_exact) in fp32, as JAX takes it, on the host
    # (a scalar sent to the card would be a synchronising copy).
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32)).item()
    large = max_exact + (
        torch.log(rel_pos.clamp_min(1).float() / max_exact) / denom
        * (n - max_exact)).to(rel_pos.dtype)
    large = large.clamp_max(n - 1)
    return ret + torch.where(is_small, rel_pos, large)


class RelPosBias(nn.Module):
    """[heads, q_len, kv_len] additive bias in the compute dtype from the
    bucketed offsets of absolute positions `q_pos` [Q] and `kv_pos` [KV]."""

    def __init__(self, cfg: T5Config, bidirectional: bool, device):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        self.table = nn.Parameter(torch.empty(
            cfg.rel_buckets, cfg.num_heads, dtype=torch.float32,
            device=device))

    def forward(self, q_pos, kv_pos):
        cfg = self.cfg
        bucket = relative_position_bucket(
            kv_pos[None, :] - q_pos[:, None],
            bidirectional=self.bidirectional, num_buckets=cfg.rel_buckets,
            max_distance=cfg.rel_max_distance)
        return self.table[bucket].permute(2, 0, 1).to(cfg.dtype)


class T5Attention(nn.Module):
    """Projections without bias and the score half (`finish`), which the
    cached decode path calls with k/v from its cache."""

    def __init__(self, cfg: T5Config, device):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        for name in ("q", "k", "v"):
            self.add_module(name, Dense(cfg, cfg.d_model, inner, device))
        self.o = Dense(cfg, inner, cfg.d_model, device)

    def heads(self, proj: str, x):
        """Projection `proj` of x [B, S, D] as [B, S, H, Dk]."""
        b, s, _ = x.shape
        return getattr(self, proj)(x).view(b, s, self.cfg.num_heads,
                                           self.cfg.d_kv)

    def forward(self, x, kv, mask, bias=None):
        return self.finish(self.heads("q", x), self.heads("k", kv),
                           self.heads("v", kv), mask, bias)

    def finish(self, q, k, v, mask, bias=None):
        """q [B, Q, H, Dk], k/v [B, K, H, Dk]; mask broadcast to
        [B, H, Q, K]; bias [., H, Q, K]. No 1/sqrt(d) scaling."""
        cfg = self.cfg
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if bias is not None:
            scores = scores + bias.float()
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        b, s = out.shape[:2]
        return self.o(out.reshape(b, s, -1))


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device):
        super().__init__()
        self.cfg = cfg
        names = ("wi_0", "wi_1") if cfg.gated else ("wi",)
        for name in names:
            self.add_module(name, Dense(cfg, cfg.d_model, cfg.d_ff, device))
        self.wo = Dense(cfg, cfg.d_ff, cfg.d_model, device)

    def forward(self, x):
        if self.cfg.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


def _stack(make, n: int) -> nn.ModuleList:
    return nn.ModuleList(make() for _ in range(n))


class T5(nn.Module):
    """Teacher-forced `forward(input_ids, decoder_input_ids, enc_mask)` ->
    fp32 logits [B, T, V]; generation through `greedy_generate`, composed
    of `encode`, `cross_kv` and `decode_step`. `device` defaults to CUDA
    and raises when CUDA is absent. Parameters are allocated, not
    initialised: load a state dict or call `init_weights(seed)`."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        if cfg.feed_forward_proj not in FEED_FORWARD_PROJ:
            raise ValueError(f"unsupported feed_forward_proj "
                             f"{cfg.feed_forward_proj!r}")
        device = resolve_device(device)
        self.cfg = cfg
        d, ne, nd = cfg.d_model, cfg.num_layers, cfg.num_decoder_layers
        self.shared = nn.Parameter(torch.empty(
            cfg.vocab_size, d, dtype=cfg.storage_dtype, device=device))
        if cfg.per_layer_rel_bias:  # UMT5: one table a layer
            self.enc_rels = _stack(lambda: RelPosBias(cfg, True, device), ne)
            self.dec_rels = _stack(lambda: RelPosBias(cfg, False, device),
                                   nd)
        else:
            self.enc_rel = RelPosBias(cfg, True, device)
            self.dec_rel = RelPosBias(cfg, False, device)

        def ln():
            return T5LayerNorm(d, cfg.layer_norm_eps, device)

        self.enc_attn = _stack(lambda: T5Attention(cfg, device), ne)
        self.enc_attn_ln = _stack(ln, ne)
        self.enc_ffn = _stack(lambda: T5FFN(cfg, device), ne)
        self.enc_ffn_ln = _stack(ln, ne)
        self.enc_final_ln = ln()
        self.dec_self = _stack(lambda: T5Attention(cfg, device), nd)
        self.dec_self_ln = _stack(ln, nd)
        self.dec_cross = _stack(lambda: T5Attention(cfg, device), nd)
        self.dec_cross_ln = _stack(ln, nd)
        self.dec_ffn = _stack(lambda: T5FFN(cfg, device), nd)
        self.dec_ffn_ln = _stack(ln, nd)
        self.dec_final_ln = ln()
        self.lm_head = (None if cfg.tie_embeddings
                        else Dense(cfg, d, cfg.vocab_size, device))

    @property
    def device(self) -> torch.device:
        return self.enc_final_ln.scale.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "T5":
        """Random weights from `seed` on the model's own device, JAX's
        initializers untruncated: `shared`, the relative-position tables
        and an untied head N(0, 1), projections N(0, 1/fan_in), norm
        scales 1."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.shared.normal_(0.0, 1.0, generator=gen)
        for mod in self.modules():
            if isinstance(mod, RelPosBias):
                mod.table.normal_(0.0, 1.0, generator=gen)
            elif isinstance(mod, nn.Linear):
                std = 1.0 if mod is self.lm_head else mod.in_features ** -0.5
                mod.weight.normal_(0.0, std, generator=gen)
            elif isinstance(mod, T5LayerNorm):
                mod.scale.fill_(1.0)
        return self

    def _embed(self, ids):
        return quant_embed_lookup(self.shared, ids, self.cfg.dtype)

    def rel_bias(self, decoder: bool, layer: int, q_pos, kv_pos):
        """The bias [1, H, Q, KV] of `layer` of the encoder or decoder (its
        own table under UMT5, else the stack's shared one)."""
        if self.cfg.per_layer_rel_bias:
            rel = (self.dec_rels if decoder else self.enc_rels)[layer]
        else:
            rel = self.dec_rel if decoder else self.enc_rel
        return rel(q_pos, kv_pos)[None]

    # -- encoder ------------------------------------------------------------

    def encode(self, input_ids, enc_mask=None):
        """Encoder output [B, S, D] (final-normed); `enc_mask` [B, S] bool
        marks real tokens (default all)."""
        cfg = self.cfg
        b, s = input_ids.shape
        if enc_mask is None:
            enc_mask = torch.ones(b, s, dtype=torch.bool,
                                  device=input_ids.device)
        x = self._embed(input_ids)
        pos = torch.arange(s, device=input_ids.device)
        bias = (None if cfg.per_layer_rel_bias
                else self.rel_bias(False, 0, pos, pos))
        mask = enc_mask.to(torch.bool)[:, None, None, :]
        for i in range(cfg.num_layers):
            b_i = (self.rel_bias(False, i, pos, pos)
                   if cfg.per_layer_rel_bias else bias)
            h = self.enc_attn_ln[i](x)
            x = x + self.enc_attn[i](h, h, mask, b_i)
            x = x + self.enc_ffn[i](self.enc_ffn_ln[i](x))
        return self.enc_final_ln(x)

    # -- decoder ------------------------------------------------------------

    def _logits(self, x):
        """fp32 logits of final-normed decoder states: the tied head with
        T5's d_model**-0.5 rescale (the factor rounded to the compute
        dtype, as JAX rounds its weak-typed scalar), or the untied head."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            # The factor rounded to x's dtype on the host, then multiplied.
            x = x * torch.tensor(cfg.d_model ** -0.5, dtype=x.dtype).item()
            return quant_unembed(x, self.shared, cfg.dtype).float()
        return self.lm_head(x).float()

    def decode(self, decoder_input_ids, enc_out, enc_mask):
        """Teacher-forced decoder pass -> fp32 logits [B, T, V]."""
        cfg = self.cfg
        t = decoder_input_ids.shape[1]
        x = self._embed(decoder_input_ids)
        pos = torch.arange(t, device=x.device)
        bias = (None if cfg.per_layer_rel_bias
                else self.rel_bias(True, 0, pos, pos))
        causal = (pos[:, None] >= pos[None, :])[None, None]
        cross_mask = enc_mask.to(torch.bool)[:, None, None, :]
        for i in range(cfg.num_decoder_layers):
            b_i = (self.rel_bias(True, i, pos, pos)
                   if cfg.per_layer_rel_bias else bias)
            h = self.dec_self_ln[i](x)
            x = x + self.dec_self[i](h, h, causal, b_i)
            x = x + self.dec_cross[i](self.dec_cross_ln[i](x), enc_out,
                                      cross_mask)
            x = x + self.dec_ffn[i](self.dec_ffn_ln[i](x))
        return self._logits(self.dec_final_ln(x))

    def forward(self, input_ids, decoder_input_ids, enc_mask=None):
        b, s = input_ids.shape
        if enc_mask is None:
            enc_mask = torch.ones(b, s, dtype=torch.bool,
                                  device=input_ids.device)
        return self.decode(decoder_input_ids,
                           self.encode(input_ids, enc_mask), enc_mask)

    # -- the greedy decode's parts --------------------------------------------

    def cross_kv(self, enc_out):
        """Each decoder layer's cross-attention (K, V) [B, S, H, Dk],
        computed once a request."""
        return [(attn.heads("k", enc_out), attn.heads("v", enc_out))
                for attn in self.dec_cross]

    def self_bias(self, t_max: int) -> list:
        """Each decoder layer's self-attention bias [1, H, t_max, t_max]
        over positions 0..t_max-1 (one tensor shared by every layer unless
        UMT5): `decode_step` at position p reads row p, the values JAX
        computes there from p."""
        pos = torch.arange(t_max, device=self.device)
        n = self.cfg.num_decoder_layers
        if self.cfg.per_layer_rel_bias:
            return [self.rel_bias(True, i, pos, pos) for i in range(n)]
        return [self.rel_bias(True, 0, pos, pos)] * n

    def decode_step(self, tok, cache_k, cache_v, pos: int, enc_mask, cross,
                    self_bias):
        """One decoder step at position `pos` (a host int, so no value
        crosses to the host): tok [B, 1] -> (fp32 logits [B, V], the
        caches). cache_k/v [L, B, T_max, H, Dk] are written in place at
        row `pos`. `self_bias` is `self_bias(T_max)`, made once a request:
        the step reads its row `pos`."""
        cfg = self.cfg
        x = self._embed(tok)                       # [B, 1, D]
        kv_pos = torch.arange(cache_k.shape[2], device=x.device)
        rows = [b[:, :, pos:pos + 1] for b in self_bias]
        self_mask = (kv_pos <= pos)[None, None, None, :]
        cross_mask = enc_mask.to(torch.bool)[:, None, None, :]
        for i in range(cfg.num_decoder_layers):
            attn = self.dec_self[i]
            h = self.dec_self_ln[i](x)
            q = attn.heads("q", h)
            cache_k[i, :, pos] = attn.heads("k", h)[:, 0].to(cache_k.dtype)
            cache_v[i, :, pos] = attn.heads("v", h)[:, 0].to(cache_v.dtype)
            x = x + attn.finish(q, cache_k[i].to(cfg.dtype),
                                cache_v[i].to(cfg.dtype), self_mask, rows[i])
            cattn = self.dec_cross[i]
            cq = cattn.heads("q", self.dec_cross_ln[i](x))
            ck, cv = cross[i]
            x = x + cattn.finish(cq, ck, cv, cross_mask)
            x = x + self.dec_ffn[i](self.dec_ffn_ln[i](x))
        logits = self._logits(self.dec_final_ln(x))[:, 0]
        return logits, cache_k, cache_v


@torch.no_grad()
def greedy_generate(model: T5, input_ids, enc_mask=None, *, max_tokens: int):
    """Greedy decode: the encoder and the cross K/V once, then exactly
    `max_tokens` decoder steps over a self-attention KV cache. Emission
    stops advancing at EOS (later tokens are eos_id). Everything stays on
    the device: returns (tokens [B, max_tokens] int32, n_valid [B]), where
    n_valid is the first EOS's index, or max_tokens without one."""
    cfg = model.cfg
    b, s = input_ids.shape
    dev = input_ids.device
    if enc_mask is None:
        enc_mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    enc_out = model.encode(input_ids, enc_mask)
    cross = model.cross_kv(enc_out)
    shape = (cfg.num_decoder_layers, b, max_tokens, cfg.num_heads, cfg.d_kv)
    cache_k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    bias = model.self_bias(max_tokens)
    tok = torch.full((b, 1), cfg.decoder_start_id, dtype=torch.int32,
                     device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = []
    for pos in range(max_tokens):
        logits, cache_k, cache_v = model.decode_step(
            tok, cache_k, cache_v, pos, enc_mask, cross, bias)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, cfg.eos_id, nxt).to(torch.int32)
        done = done | (nxt == cfg.eos_id)
        out.append(nxt)
        tok = nxt[:, None]
    toks = torch.stack(out, dim=1)
    is_eos = toks == cfg.eos_id
    n_valid = torch.where(is_eos.any(dim=1),
                          torch.argmax(is_eos.to(torch.int32), dim=1),
                          max_tokens)
    return toks, n_valid

