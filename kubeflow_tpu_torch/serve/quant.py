"""Weight-only int8 quantization for serving, and the KV-row codec.

The port of `kubeflow_tpu/serve/quant.py`. Two halves:

Weights. `quantize_model` replaces every projection and the embedding of a
Llama with int8 codes and fp32 per-output-channel scales (symmetric
max-abs over the contraction dim), in place, module by module, freeing each
float weight as it goes: an 8B model never holds an fp32 copy of itself.
`Int8Dense` applies a quantized projection as the JAX `Int8DenseGeneral`
does: the raw codes in the compute dtype go into the matmul, which
accumulates in fp32; the scale multiplies the `[..., out]` output in fp32;
the result is cast back. No weight-shaped dequantized tensor is made by a
multiply. Serving is weight-only, as in the JAX package: this path never
calls the W8A8 op `ops.quant_matmul.int8_matmul`. An MoE model's expert
stacks become `Int8Experts` (one W8A16 launch per expert and projection)
and its routers stay fp32; `init_quantized` builds such a model int8 part
by part from a seed, never holding its float weights whole.

`quantize_fixed` does the same for models without `quantized_dense` (BERT,
the MLP), leaf by leaf as `quantize_tree` picks them: projections become
`Int8Dense`, embedding tables `Int8Table` (per-column scales, rows
dequantized where they are read).

Both `Int8Dense` and `quant_unembed` go through `ops.w8a16.
int8_weight_matmul`. On the card its kernels read the int8 codes and
widen them in registers, as XLA fuses the JAX branch's convert into the
dot's operand read, so an int8 step reads one byte per weight and makes no
bf16 copy of any weight. On the CPU its plain version casts the codes to
the compute dtype per call, the same arithmetic.

Like `quantize_tree`, a projection is quantized when its weight, stacked
over the layers as the JAX param tree holds it, has at least `min_size`
elements, and biases (Qwen2's QKV) stay float: an `Int8Dense` adds its
bias in the compute dtype after the scaled output, as `Int8DenseGeneral`
does. Unlike `quantize_tree`, every norm scale stays fp32, the qk-norms
included. This carries JAX's caveat forward, not its behaviour: the JAX
tree's stacked norm scales are quantized once they reach `min_size` (L·D
>= 4096: `[L, D]` at 8B widths, Gemma-3's `[L, 256]` qk-norms at 16
layers) and dequantized at apply, so above that size the two packages'
int8 models differ in their norms; below it they agree.

KV rows. `kv_quantize_rows`/`kv_dequantize_rows` encode the paged pool's
int8/fp8 blocks: per-row-per-head symmetric max-abs over head_dim, f32
scales. The decode path never dequantizes a cache: the scales land on the
score and probability tensors inside `ops.reference.naive_attention`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.ops.w8a16 import int8_weight_matmul

#: Legal `kv_quant` values. "none" keeps the pool in the model dtype.
KV_QUANT_MODES = ("none", "int8", "fp8")


def kv_qdtype(mode: str) -> torch.dtype:
    """Storage dtype of a quantized KV pool."""
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]


def kv_qmax(mode: str) -> float:
    """Largest magnitude the scale maps a row's amax onto."""
    return {"int8": 127.0, "fp8": 448.0}[mode]


def kv_quantize_rows(rows: torch.Tensor, mode: str):
    """Quantize `[..., D]` rows -> (q `[..., D]` in kv_qdtype(mode), scale
    `[...]` fp32). int8 rounds half to even and clips to +-127; fp8 relies
    on the cast's round to nearest even. All-zero rows get the 1e-12 scale
    and encode to exact zeros."""
    r32 = rows.float()
    scale = r32.abs().amax(dim=-1).clamp_min(1e-12) / kv_qmax(mode)
    q = r32 / scale[..., None]
    if mode == "int8":
        q = q.round().clamp(-127, 127)
    return q.to(kv_qdtype(mode)), scale


def kv_dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of kv_quantize_rows, for admission-side use and tests; the
    decode path never calls it."""
    return (q.float() * scale[..., None]).to(dtype)


def _quantize_rows(w: torch.Tensor):
    """(int8 codes, fp32 scale [rows]) of a [rows, cols] weight, max-abs
    over cols, in row blocks so the fp32 temporaries stay small."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
    step = max(1, (1 << 26) // max(1, w.shape[1]))
    for i in range(0, w.shape[0], step):
        w32 = w[i:i + step].float()
        s = w32.abs().amax(dim=1).clamp_min(1e-12) / 127.0
        q[i:i + step] = (w32 / s[:, None]).round().clamp(-127, 127).to(
            torch.int8)
        scale[i:i + step] = s
    return q, scale


class Int8Dense(nn.Module):
    """A projection stored as int8 codes `q` [out, in] and fp32
    per-output-channel scales `scale` [out] (buffers), applied in
    `compute_dtype` as the JAX Int8DenseGeneral's int8 branch: the input
    cast to the compute dtype times the raw codes, an fp32-accumulating
    matmul, the scale on the fp32 output, then the cast back
    (`int8_weight_matmul`). An optional float `bias` [out] (a frozen
    parameter in `bias_dtype`) is added after that, in the compute
    dtype."""

    def __init__(self, in_features: int, out_features: int, compute_dtype,
                 device=None, bias: bool = False, bias_dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.register_buffer("q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            out_features, dtype=bias_dtype or compute_dtype, device=device),
            requires_grad=False) if bias else None)

    @classmethod
    def from_weight(cls, weight: torch.Tensor, compute_dtype,
                    bias: torch.Tensor | None = None) -> "Int8Dense":
        out_f, in_f = weight.shape
        mod = cls(in_f, out_f, compute_dtype, device="meta")
        mod.q, mod.scale = _quantize_rows(weight.detach())
        if bias is not None:
            mod.bias = nn.Parameter(bias.detach(), requires_grad=False)
        return mod

    def forward(self, x):
        y = int8_weight_matmul(x.to(self.compute_dtype), self.q, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Int8Experts(nn.Module):
    """A routed-expert weight stack [E, in, out] (models/moe.py) stored as
    int8 codes `q` [E, out, in] and fp32 scales `scale` [E, out] (buffers):
    one scale per expert and output column, the max-abs over the
    contraction dim, as `quantize_tree` scales the JAX stack [L, E, in,
    out] over its `in` axis. `matmul(e, x)` applies expert e through the
    W8A16 op (`int8_weight_matmul`), as `Int8Dense` applies a projection;
    no expert is ever dequantized whole."""

    def __init__(self, experts: int, in_features: int, out_features: int,
                 compute_dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.register_buffer("q", torch.zeros(
            experts, out_features, in_features, dtype=torch.int8,
            device=device))
        self.register_buffer("scale", torch.ones(
            experts, out_features, dtype=torch.float32, device=device))

    @classmethod
    def from_weight(cls, w: torch.Tensor, compute_dtype) -> "Int8Experts":
        e, n_in, n_out = w.shape
        mod = cls(e, n_in, n_out, compute_dtype, device="meta")
        mod.q = torch.empty(e, n_out, n_in, dtype=torch.int8,
                            device=w.device)
        mod.scale = torch.empty(e, n_out, dtype=torch.float32,
                                device=w.device)
        for i in range(e):
            mod.q[i], mod.scale[i] = _quantize_rows(w[i].detach().t())
        return mod

    def matmul(self, e: int, x):
        """x [..., in] times expert e: [..., out] in the compute dtype."""
        return int8_weight_matmul(x.to(self.compute_dtype), self.q[e],
                                  self.scale[e])


class Int8Table(nn.Module):
    """An embedding table [rows, D] of a model without `quantized_dense`
    (BERT) as JAX's `quantize_tree` stores it: int8 codes `q` and fp32
    per-column scales `scale` [D] (max-abs over the rows, axis 0, the
    default contraction axis for that leaf name). JAX's `QuantizedModule`
    dequantizes such a leaf whole to bf16; `rows` dequantizes only the rows
    a lookup reads, to the same values, and `dequantize` the whole table
    (the tied MLM decoder)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @classmethod
    def from_table(cls, w: torch.Tensor) -> "Int8Table":
        w32 = w.detach().float()
        s = w32.abs().amax(dim=0).clamp_min(1e-12) / 127.0
        q = (w32 / s).round().clamp(-127, 127).to(torch.int8)
        return cls(q, s)

    def rows(self, idx) -> torch.Tensor:
        return (self.q[idx].float() * self.scale).to(self.dtype)

    def dequantize(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.dtype)


#: Embedding tables that a tied head also reads (GPT-2's `wte`, T5's
#: `shared`): JAX's contraction axis for them is the last, one scale per
#: vocab row, so they become `Int8Dense` tables as a Llama's `embed` does.
ROW_SCALED_TABLES = ("wte", "shared")


@torch.no_grad()
def quantize_fixed(model, *, min_size: int = 4096):
    """Quantize a float model without `quantized_dense` (BERT, the MLP,
    GPT-2, T5) in place, leaf by leaf as JAX's `quantize_tree`: each
    projection (an nn.Linear with a `compute_dtype`) whose weight has at
    least `min_size` elements becomes an `Int8Dense` over the W8A16 op in
    that compute dtype, its bias kept float; each other floating parameter
    of two or more dims and at least `min_size` elements (the embedding
    tables) becomes an `Int8Table` (one scale per column: BERT's tables,
    GPT-2's `wpe`), or, for a ROW_SCALED_TABLES name, an `Int8Dense` table
    in its module's compute dtype. These are JAX's contraction axes for
    every BERT, MLP, GPT-2 and T5 leaf: q/k/v one scale per (head, dim),
    o reduced over (heads, dim), an untied T5 head one per vocab column,
    all the port's per-output-channel scales. Smaller leaves (BERT-base's
    2 x 768 classifier, the MLP's head, T5's 32 x 12 relative-position
    tables), biases and norms stay float. Returns the model.

    JAX serves these models through QuantizedModule's dequantize-all path:
    bf16(q * scale) into the float matmul. Int8Dense feeds the raw codes
    and puts the scale on the fp32 output instead, so the two differ by
    the bf16 rounding of the dequantized weight (see tests for the
    tolerance it costs)."""
    for mod in list(model.modules()):
        for name, child in list(mod.named_children()):
            if (isinstance(child, nn.Linear) and hasattr(child, "compute_dtype")
                    and child.weight.numel() >= min_size):
                setattr(mod, name, Int8Dense.from_weight(
                    child.weight, child.compute_dtype, child.bias))
        if isinstance(mod, nn.Linear):
            continue
        for name, p in list(mod.named_parameters(recurse=False)):
            if (p.is_floating_point() and p.dim() >= 2
                    and p.numel() >= min_size):
                delattr(mod, name)
                setattr(mod, name, Int8Dense.from_weight(p, mod.cfg.dtype)
                        if name in ROW_SCALED_TABLES
                        else Int8Table.from_table(p))
    return model


def quant_embed_lookup(embed, tokens, dtype):
    """Token-embedding gather: int8 rows and their per-row scales gathered,
    the multiply after the gather ([B, S, D] work, never the [V, D] table).
    A float embedding is gathered, then cast."""
    if not isinstance(embed, Int8Dense):
        return embed[tokens].to(dtype)
    rows = embed.q[tokens].float()
    return (rows * embed.scale[tokens][..., None]).to(dtype)


def quant_unembed(x, embed, dtype):
    """Tied-embedding unembed `x @ embed.T`, with an int8 table's per-vocab
    scale applied to the logits in fp32 (the JAX einsum rounds the raw
    logits to `dtype` first, and so does this)."""
    if not isinstance(embed, Int8Dense):
        return F.linear(x, embed.to(dtype))
    return int8_weight_matmul(x.to(dtype), embed.q, embed.scale,
                              round_before_scale=True)


def _layer_sites(layer, n_layers: int):
    """(parent module, attribute name, weight elements as the JAX tree
    stacks them over `n_layers`) of a layer's quantizable leaves: the
    attention projections; then the dense MLP's projections, or a routed
    MLP's expert stacks and shared-expert leaves (its fp32 router never:
    int8 noise could flip an expert choice, a discrete change)."""
    out = [(layer.attn, name, getattr(layer.attn, name).weight.numel()
            * n_layers) for name in ("q_proj", "k_proj", "v_proj", "o_proj")]
    mlp = layer.mlp
    for name in ("gate_proj", "up_proj", "down_proj", "w_gate", "w_up",
                 "w_down", *getattr(mlp, "shared", ())):
        leaf = getattr(mlp, name, None)
        if leaf is not None:
            weight = leaf.weight if isinstance(leaf, nn.Linear) else leaf
            out.append((mlp, name, weight.numel() * n_layers))
    return out


def _projections(model):
    """`_layer_sites` of every layer, then the head and the embedding."""
    n_layers = len(model.layers)
    out = [site for layer in model.layers
           for site in _layer_sites(layer, n_layers)]
    if model.lm_head is not None:
        out.append((model, "lm_head", model.lm_head.weight.numel()))
    out.append((model, "embed", model.cfg.vocab_size * model.cfg.hidden_size))
    return out


def _quantize_sites(sites, dtype, min_size: int) -> None:
    """Replace each site's float leaf whose stacked size reaches
    `min_size` by its int8 module, one at a time, freeing the float leaf
    before the next: a projection (nn.Linear [out, in]) or the embedding
    becomes an `Int8Dense`, an expert stack [E, in, out] `Int8Experts`, a
    shared-expert leaf [in, out] an `Int8Dense` of its transpose."""
    for parent, name, stacked in sites:
        if stacked < min_size:
            continue
        leaf = getattr(parent, name)
        if isinstance(leaf, nn.Linear):
            q = Int8Dense.from_weight(leaf.weight, dtype, leaf.bias)
        elif leaf.dim() == 3:
            q = Int8Experts.from_weight(leaf, dtype)
        else:
            q = Int8Dense.from_weight(leaf if name == "embed" else leaf.t(),
                                      dtype)
        if not isinstance(leaf, nn.Module):
            delattr(parent, name)  # the Parameter; re-registered as a module
        setattr(parent, name, q)
        del leaf


def _mark_quantized(model, cfg) -> None:
    qcfg = dataclasses.replace(cfg, quantized_dense=True)
    for mod in model.modules():
        if getattr(mod, "cfg", None) is cfg:
            mod.cfg = qcfg


@torch.no_grad()
def quantize_model(model, *, min_size: int = 4096):
    """Quantize a float Llama (or MoE Llama) in place and return it: every
    projection (and the embedding, an untied head, a routed MLP's expert
    stacks and shared-expert leaves) whose weight stacked over the layers
    has at least `min_size` elements becomes int8, one module at a time,
    its float weight freed before the next; the config gains
    `quantized_dense=True`. Biases stay in their dtype, norm scales and
    MoE routers in fp32. A config's own LoRA factors (`lora_rank`) stay in
    their float dtype and add their delta after the int8 projection, as
    JAX's `_lora_delta` after `Int8DenseGeneral`; the JAX tree quantizes
    such a factor once it reaches `min_size` stacked (and dequantizes it
    at apply), so above that size the two packages' adapters differ by
    that rounding.

    JAX's `QuantizedModule` dequantizes expert stacks and shared-expert
    leaves to the compute dtype before a float einsum; here they run the
    W8A16 op (scale on the fp32 output), so the two packages' int8 MoE
    models round at different points (tests bound the difference)."""
    cfg = model.cfg
    if cfg.quantized_dense:
        raise ValueError("model is already quantized")
    _quantize_sites(_projections(model), cfg.dtype, min_size)
    _mark_quantized(model, cfg)
    return model


@torch.no_grad()
def init_quantized(model, seed: int, device, *, min_size: int = 4096):
    """Fill a float model built on the meta device (`Llama(cfg,
    device="meta")`, or an `MoELlama`) with `quantize_model(model
    .init_weights(seed))`'s weights, part by part on `device`: the
    embedding, then each layer, the final norm and the head are
    allocated, drawn from one seeded generator in `init_weights`' order,
    and quantized before the next part exists. A model whose float weights
    would not fit (Mixtral-8x7B's 93 GB in bf16 on an 80 GB card) is built
    in its int8 size plus one float layer. Returns the model."""
    from kubeflow_tpu_torch.models.llama import draw_weights

    cfg = model.cfg
    if cfg.quantized_dense or cfg.lora_rank:
        raise ValueError("init_quantized needs a float model without LoRA "
                         "factors")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_layers = len(model.layers)
    model.embed = nn.Parameter(torch.empty(
        cfg.vocab_size, cfg.hidden_size, dtype=cfg.storage_dtype,
        device=device))
    model.embed.normal_(0.0, 0.02, generator=gen)
    _quantize_sites([(model, "embed", model.embed.numel())], cfg.dtype,
                    min_size)
    for layer in model.layers:
        layer.to_empty(device=device)
        for mod in layer.modules():
            draw_weights(mod, gen)
        _quantize_sites(_layer_sites(layer, n_layers), cfg.dtype, min_size)
    for part in (model.final_norm, model.lm_head):
        if part is not None:
            part.to_empty(device=device)
            draw_weights(part, gen)
    if model.lm_head is not None:
        _quantize_sites([(model, "lm_head", model.lm_head.weight.numel())],
                        cfg.dtype, min_size)
    model.set_rope_tables(device)
    _mark_quantized(model, cfg)
    return model


def quantized_bytes(model) -> dict:
    """{"quantized": n, "full": n} parameter bytes, for metadata: int8
    codes plus fp32 scales against the same codes at bf16 (what the server
    would otherwise hold); float tensors count their own bytes in both."""
    qb = fb = 0
    for mod in model.modules():
        if isinstance(mod, (Int8Dense, Int8Experts, Int8Table)):
            qb += mod.q.numel() + mod.scale.numel() * 4
            fb += mod.q.numel() * 2
    for p in model.parameters():
        qb += p.numel() * p.element_size()
        fb += p.numel() * p.element_size()
    return {"quantized": int(qb), "full": int(fb)}
