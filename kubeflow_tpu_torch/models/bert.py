"""BERT-class bidirectional encoder: the fixed-forward serving model.

The port of `kubeflow_tpu/models/bert.py`, with its four task heads
(`BertConfig.task`):

    sequence_classification -> pooled logits [B, num_labels] (fp32), with
                               or without the pooler (`use_pooler`)
    token_classification    -> per-token logits [B, S, num_labels] (fp32)
    fill_mask               -> MLM logits [B, S, vocab] (fp32): a
                               transform, then a decoder TIED to
                               `word_embeddings` plus a free bias
    embedding               -> masked mean in fp32, L2-normalised [B, H]

`Bert.forward` returns (sequence output [B, S, H], head output). The
rounding points are JAX's: parameters in `param_dtype` (fp32), compute in
`dtype` (bf16); the three embeddings summed (in fp32), then LayerNorm
(statistics in fp32, the fast variance, the output cast to `dtype`);
attention scores in fp32 divided by sqrt(head_dim), -1e30 where the key
is padding, softmax in fp32, probabilities cast to `dtype` before the
value product; classifier logits in fp32. Attention is a plain einsum, as
in JAX (no Pallas kernel there, so no fused kernel here).

Under `quantize: "int8"` (serve/quant.quantize_fixed) projections become
`Int8Dense` and the large embedding tables `Int8Table`: a lookup
dequantizes the rows it reads, the tied decoder dequantizes the table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.mlp import Dense, as_dtype, init_dense_weights
from kubeflow_tpu_torch.serve.quant import Int8Table
from kubeflow_tpu_torch.utils.devices import resolve_device

TASKS = ("sequence_classification", "token_classification", "fill_mask",
         "embedding")
ACTIVATIONS = ("gelu", "gelu_new", "gelu_pytorch_tanh", "relu")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # "gelu" is exact erf GELU; "gelu_new"/"gelu_pytorch_tanh" the tanh
    # form; "relu".
    hidden_act: str = "gelu"
    num_labels: int = 2
    # False: the classifier reads the raw [CLS] state (pooler-free
    # exports), with no dense+tanh.
    use_pooler: bool = True
    task: str = "sequence_classification"
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    def __post_init__(self):
        for field in ("dtype", "param_dtype"):
            object.__setattr__(self, field, as_dtype(getattr(self, field)))


def bert_base(num_labels: int = 2) -> BertConfig:
    return BertConfig(num_labels=num_labels)


def bert_tiny() -> BertConfig:
    return BertConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, max_seq_len=64)


def activation(cfg: BertConfig, h):
    """The checkpoint's hidden activation, shared by the FFN and the MLM
    transform."""
    if cfg.hidden_act == "gelu":  # exact erf GELU (BERT canonical)
        return F.gelu(h)
    if cfg.hidden_act in ("gelu_new", "gelu_pytorch_tanh"):
        return F.gelu(h, approximate="tanh")
    if cfg.hidden_act == "relu":
        return F.relu(h)
    raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")


class LayerNorm(nn.Module):
    """flax's LayerNorm: statistics in fp32 (variance E[x^2] - E[x]^2,
    clipped at 0), (x - mean) times rsqrt(var + eps) * scale, plus bias,
    all in fp32; the result cast to `dtype`."""

    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x - mean) * mul + self.bias.float()).to(self.dtype)


def _rows(table, idx):
    """Rows of an embedding table: a float Parameter's as stored, an
    Int8Table's dequantized (the JAX dequantized table's rows)."""
    return table.rows(idx) if isinstance(table, Int8Table) else table[idx]


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        self.cfg = cfg
        h, i, dt, pd = (cfg.hidden_size, cfg.intermediate_size, cfg.dtype,
                        cfg.param_dtype)
        for name, (a, b) in (("q", (h, h)), ("k", (h, h)), ("v", (h, h)),
                             ("o", (h, h)), ("ffn_in", (h, i)),
                             ("ffn_out", (i, h))):
            self.add_module(name, Dense(a, b, dt, device, param_dtype=pd))
        self.ln_attn = LayerNorm(h, cfg.layer_norm_eps, dt, device)
        self.ln_ffn = LayerNorm(h, cfg.layer_norm_eps, dt, device)

    def forward(self, x, mask):
        cfg = self.cfg
        b, s, h = x.shape
        nh = cfg.num_heads
        hd = h // nh
        q = self.q(x).view(b, s, nh, hd)
        k = self.k(x).view(b, s, nh, hd)
        v = self.v(x).view(b, s, nh, hd)
        scores = torch.einsum("bshd,bthd->bhst", q, k).float()
        scores = scores / math.sqrt(hd)
        scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        attn = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h)
        x = self.ln_attn(x + self.o(attn))
        hid = self.ffn_out(activation(cfg, self.ffn_in(x)))
        return self.ln_ffn(x + hid)


class Bert(nn.Module):
    """The encoder and the head `cfg.task` names. `device` defaults to
    CUDA and raises when CUDA is absent. Parameters are allocated, not
    initialised: load a state dict or call `init_weights(seed)`."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        if cfg.task not in TASKS:
            raise ValueError(f"unknown task {cfg.task!r}")
        if cfg.hidden_act not in ACTIVATIONS:
            raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")
        device = resolve_device(device)
        self.cfg = cfg
        h, dt, pd = cfg.hidden_size, cfg.dtype, cfg.param_dtype

        def table(rows):
            return nn.Parameter(torch.empty(rows, h, dtype=pd, device=device))

        self.word_embeddings = table(cfg.vocab_size)
        self.position_embeddings = table(cfg.max_seq_len)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        self.ln_embed = LayerNorm(h, cfg.layer_norm_eps, dt, device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        f32 = torch.float32
        if cfg.task in ("token_classification", "sequence_classification"):
            self.classifier = Dense(h, cfg.num_labels, f32, device,
                                    param_dtype=pd)
        if cfg.task == "sequence_classification" and cfg.use_pooler:
            self.pooler = Dense(h, h, dt, device, param_dtype=pd)
        if cfg.task == "fill_mask":
            self.mlm_transform = Dense(h, h, dt, device, param_dtype=pd)
            self.mlm_ln = LayerNorm(h, cfg.layer_norm_eps, dt, device)
            self.mlm_bias = nn.Parameter(torch.empty(
                cfg.vocab_size, dtype=pd, device=device))

    @property
    def device(self) -> torch.device:
        return self.ln_embed.scale.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Bert":
        """Random weights from `seed` on the model's own device: embeddings
        N(0, 0.02), projections N(0, 1/fan_in) (LeCun normal, untruncated),
        biases zero, LayerNorms the identity."""
        init_dense_weights(self, seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        for p in (self.word_embeddings, self.position_embeddings,
                  self.token_type_embeddings):
            p.normal_(0.0, 0.02, generator=gen)
        if self.cfg.task == "fill_mask":
            self.mlm_bias.zero_()
        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        return self

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.cfg
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.bool, device=dev)
        else:
            attention_mask = attention_mask.to(torch.bool)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.long, device=dev)
        x = (_rows(self.word_embeddings, input_ids)
             + _rows(self.position_embeddings,
                     torch.arange(s, device=dev))[None]
             + _rows(self.token_type_embeddings, token_type_ids))
        x = self.ln_embed(x.to(cfg.dtype))
        for layer in self.layers:
            x = layer(x, attention_mask)

        if cfg.task == "token_classification":
            return x, self.classifier(x)
        if cfg.task == "fill_mask":
            h = self.mlm_ln(activation(cfg, self.mlm_transform(x)))
            emb = self.word_embeddings
            emb = (emb.dequantize() if isinstance(emb, Int8Table)
                   else emb).to(cfg.dtype)
            logits = (torch.einsum("bsh,vh->bsv", h, emb).float()
                      + self.mlm_bias)
            return x, logits
        if cfg.task == "embedding":
            m = attention_mask[..., None].float()
            pooled = ((x.float() * m).sum(dim=1)
                      / m.sum(dim=1).clamp_min(1e-9))
            norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
            return x, pooled / norm.clamp_min(1e-12)
        pooled = x[:, 0]
        if cfg.use_pooler:
            pooled = torch.tanh(self.pooler(pooled))
        return x, self.classifier(pooled)
