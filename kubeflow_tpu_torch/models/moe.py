"""Mixture-of-experts decoder (Mixtral, Qwen2-MoE) for serving and training.

The port of `kubeflow_tpu/models/moe.py`: the Llama trunk with every
layer's FFN replaced by top-k routed SwiGLU experts under GShard/Switch
capacity routing, and Qwen2-MoE's always-on shared expert. The routing is
the JAX package's: an fp32 router and softmax, top-k (ties to the lower
expert index, as `jax.lax.top_k`), the gates optionally renormalised, then
capacity claimed slot-major — every slot-0 choice first, in sequence
order, then every slot-1 choice — with `expert_capacity` slots per
(batch row, expert); a choice past its expert's capacity is dropped.

`gshard_route` is the plain version: the one-hot dispatch and combine
tensors [B, S, E, C] exactly as JAX builds them (with the Switch aux
term), and `MoEBlock.forward_plain` applies the experts through them as
JAX's einsums do. `MoEBlock.forward`, the serving and the training path,
computes the same (expert, slot) assignment without those tensors
(`route`): each kept choice's token row is copied into a static buffer
[E, B·C, H] of zeros (a dropped one to a discarded row), the experts run
on it (`torch.bmm` in the compute dtype; int8 experts one W8A16 launch
per expert and projection, over that expert's B·C rows), and each token
gathers its K rows back (a dropped choice reads a zero row), weighted by
the combine gates cast to the compute dtype, summed in fp32. Shapes are
static and nothing reads a count back to the host.

Each (expert, slot) row has at most one claimant, so the copy into the
buffer (`_Dispatch`) and the gather out of it (`_Combine`) are each
other's adjoints: each one's backward is the other's forward by the same
row map, with no scatter-add and no atomics, so the gradients are
deterministic, and the forward launches what serving always launched. A
dropped choice gets no expert gradient and a zero gate gradient, as under
JAX's one-hot dispatch; its token's gradient still flows through the
residual. The router's gradient flows through the gates (top-k values of
the fp32 softmax, renormalised under `norm_topk_prob`) and through the
Switch load-balance term, which `forward(..., with_aux=True)` returns
scaled by `router_aux_coef` (JAX sows it; the train step adds it to the
loss). Multi-LoRA adapters do not apply to the routed experts; attention-only
adapters do.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.serve.quant import Int8Dense, Int8Experts

#: JAX MoEBlock's refusal of a multi-LoRA adapter on the expert FFNs.
ADAPTER_REFUSAL = ("multi-LoRA adapters don't apply to routed-expert FFNs "
                   "(use attention-only adapters with MoE models)")


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2     # top-k routing (Mixtral: 2)
    capacity_factor: float = 1.25  # buffer slack over perfect balance
    router_aux_coef: float = 0.01  # Switch load-balance loss weight
    # Mixtral renormalizes the top-k gate values to sum 1; Qwen2-MoE's
    # default (norm_topk_prob=false) keeps the raw softmax mass.
    norm_topk_prob: bool = True
    # Qwen2-MoE shared expert: an always-on SwiGLU FFN of this width
    # whose output is scaled by a learned sigmoid gate (0 = none).
    shared_expert_size: int = 0

    def _shared_params(self) -> int:
        if not self.shared_expert_size:
            return 0
        return 3 * self.hidden_size * self.shared_expert_size \
            + self.hidden_size  # + the [H, 1] sigmoid gate

    def _attn_params(self) -> int:
        h = self.hidden_size
        qkv = (h * self.num_heads * self.head_dim
               + 2 * h * self.num_kv_heads * self.head_dim)
        attn = qkv + self.num_heads * self.head_dim * h
        if self.attention_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        return attn

    def _count(self, experts: int) -> int:
        h, m, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (self._attn_params() + experts * 3 * h * m
                     + h * self.num_experts + 2 * h + self._shared_params())
        emb = v * h * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + emb + h

    @property
    def num_params(self) -> int:
        return self._count(self.num_experts)

    @property
    def active_params(self) -> int:
        """Params touched per token (for MFU accounting of sparse models)."""
        return self._count(self.experts_per_token)


def mixtral_8x7b() -> MoEConfig:
    return MoEConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        max_seq_len=8192, rope_theta=1e6, num_experts=8,
        experts_per_token=2)


def moe_tiny(vocab: int = 512) -> MoEConfig:
    """Test-size config — same routing topology, toy dims."""
    return MoEConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        max_seq_len=128, remat=False, num_experts=4, experts_per_token=2,
        flash_block_q=64, flash_block_kv=64)


def expert_capacity(cfg: MoEConfig, seq_len: int) -> int:
    """Per-(batch-row) expert buffer: perfect balance needs K*S/E slots;
    capacity_factor adds slack before tokens drop. The JAX arithmetic,
    operation for operation: a dropless config (E/K) may round up by one."""
    return max(1, int(math.ceil(
        seq_len * cfg.experts_per_token / cfg.num_experts
        * cfg.capacity_factor)))


def _top_k(x, w_router, k: int, renormalize: bool):
    """(probs [B,S,E], gates [B,S,K], experts [B,S,K]): the fp32 router
    and softmax, then the k largest probabilities, a tie to the lower
    expert index (a stable sort, as `jax.lax.top_k` orders ties)."""
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :k], order[..., :k]
    if renormalize:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def _one_hot(idx, n: int):
    """[..., n] int32 one-hot of idx (a compare: no value check, no sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def route(x, w_router, k: int, capacity: int, renormalize: bool = True,
          with_aux: bool = False):
    """The GShard assignment without the one-hot [B,S,E,C] tensors:
    (experts [B,S,K] int64, gates [B,S,K] fp32, slot [B,S,K] int32, keep
    [B,S,K] bool). Choice j of token s of row b goes to slot `slot` of
    expert `experts` in row b's buffer when `keep`; slots are claimed
    slot-major (all slot-0 choices in sequence order, then slot-1, ...),
    so `slot` counts the earlier claims on that expert, and `keep` is
    slot < capacity. `with_aux` appends the unweighted Switch term of
    `gshard_route` from the same probabilities and slot-0 choices."""
    e = w_router.shape[-1]
    probs, gates, experts = _top_k(x, w_router, k, renormalize)
    count = torch.zeros(x.shape[0], 1, e, dtype=torch.int32, device=x.device)
    slots = []
    for j in range(k):
        chosen = experts[:, :, j]
        mask = _one_hot(chosen, e)                              # [B,S,E]
        pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - mask + count
        count = count + mask.sum(dim=1, keepdim=True, dtype=torch.int32)
        slots.append(pos.gather(2, chosen[..., None])[..., 0])
    slot = torch.stack(slots, dim=-1)
    out = (experts, gates, slot, slot < capacity)
    if with_aux:
        out += (switch_aux(probs, experts[:, :, 0]),)
    return out


def switch_aux(probs, first):
    """The Switch load-balance term E * sum_e frac_e * mean_prob_e of
    probabilities [B,S,E] and slot-0 choices [B,S] (JAX `gshard_route`'s
    arithmetic: the fraction has no gradient)."""
    e = probs.shape[-1]
    frac = _one_hot(first, e).float().mean(dim=(0, 1))
    return e * (frac * probs.mean(dim=(0, 1))).sum()


def gshard_route(x, w_router, k: int, capacity: int,
                 renormalize: bool = True):
    """GShard/Switch capacity routing, the plain version: JAX's
    `gshard_route` op for op. x [B, S, H] (any dtype; the router runs
    fp32), w_router [H, E]. Returns (dispatch [B,S,E,C], combine
    [B,S,E,C], aux) in fp32, aux the unweighted Switch load-balance term
    E * sum_e frac_e * mean_prob_e."""
    e = w_router.shape[-1]
    probs, gates, experts = _top_k(x, w_router, k, renormalize)
    b, s = x.shape[:2]
    dispatch = torch.zeros(b, s, e, capacity, device=x.device)
    combine = torch.zeros_like(dispatch)
    count = torch.zeros(b, 1, e, device=x.device)
    for j in range(k):
        mask = _one_hot(experts[:, :, j], e).float()
        pos = torch.cumsum(mask, dim=1) - mask + count
        count = count + mask.sum(dim=1, keepdim=True)
        keep = mask * (pos < capacity)
        slot = _one_hot(pos.long(), capacity).float() * keep[..., None]
        dispatch = dispatch + slot
        combine = combine + gates[:, :, j, None, None] * slot
    return dispatch, combine, switch_aux(probs, experts[:, :, 0])


def _mm(x, w, dtype):
    """x @ w of a float [in, out] leaf (cast to `dtype`), or an
    `Int8Dense` (the W8A16 op)."""
    if isinstance(w, Int8Dense):
        return w(x)
    return x @ w.to(dtype)


def shared_expert_ffn(x, w_gate, w_up, w_down, gate_w, dtype):
    """Qwen2-MoE's always-on shared expert: a dense SwiGLU scaled by a
    learned per-token sigmoid gate (fp32 sigmoid). x [.., H]; w_gate/w_up
    [H, Ms]; w_down [Ms, H]; gate_w [H, 1] — float leaves or `Int8Dense`."""
    xd = x.to(dtype)
    sh = _mm(F.silu(_mm(xd, w_gate, dtype)) * _mm(xd, w_up, dtype), w_down,
             dtype)
    gate = torch.sigmoid(_mm(xd, gate_w, dtype).float())
    return sh * gate.to(dtype)


def _scatter_rows(src, dest, n: int):
    """src [M, H] copied into rows `dest` [M] of a zero table [n, H]; index
    n (a dropped choice) lands on a discarded row."""
    buf = src.new_zeros(n + 1, src.shape[-1])
    buf.index_copy_(0, dest, src)
    return buf[:n]


def _gather_rows(table, dest):
    """Rows `dest` [M] of table [n, H]; index n reads a zero row."""
    return torch.cat([table, table.new_zeros(1, table.shape[-1])])[dest]


def _dispatch_rows(x, dest, n: int):
    """Token rows x [T, H] into a zero buffer [n, H]: choice j of token t
    to row dest[t, j] (n: dropped)."""
    t, k = dest.shape
    return _scatter_rows(x[:, None].expand(t, k, x.shape[-1]).reshape(
        t * k, -1), dest.reshape(-1), n)


class _Dispatch(torch.autograd.Function):
    """`_dispatch_rows` with its adjoint: a buffer row has at most one
    claimant, so the backward is the gather by `dest`, the K rows of a
    token summed in fp32: no scatter-add, a deterministic backward."""

    @staticmethod
    def forward(ctx, x, dest, n: int):
        ctx.save_for_backward(dest)
        return _dispatch_rows(x, dest, n)

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        g = _gather_rows(grad, dest.reshape(-1)).view(*dest.shape, -1)
        return g.float().sum(dim=1).to(grad.dtype), None, None


class _Combine(torch.autograd.Function):
    """Each choice's row of the experts' output [n, H] (`dest` [M]; a
    dropped choice reads a zero row). The adjoint copies the gradient rows
    back to `dest`, a dropped choice's to the discarded row: each kept row
    has one reader, so again no scatter-add."""

    @staticmethod
    def forward(ctx, out, dest):
        ctx.save_for_backward(dest)
        ctx.n = out.shape[0]
        return _gather_rows(out, dest)

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        return _scatter_rows(grad, dest, ctx.n), None


class MoEBlock(nn.Module):
    """Top-k routed SwiGLU experts with capacity-based dispatch.

    Parameters in the JAX layout: `router` [H, E] fp32, `w_gate`/`w_up`
    [E, H, M] and `w_down` [E, M, H] in the storage dtype, and with a
    shared expert `w_shared_gate`/`w_shared_up` [H, Ms], `w_shared_down`
    [Ms, H] and `shared_gate` [H, 1]. Under `quantized_dense` the expert
    stacks are `Int8Experts` (codes [E, out, in], a scale per expert and
    output column) and the shared leaves `Int8Dense`; the router stays
    fp32. With `with_aux` the block also returns its Switch load-balance
    term, which the trunk sums for the train step."""

    def __init__(self, cfg: MoEConfig, device):
        super().__init__()
        self.cfg = cfg
        h, m, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        self.router = nn.Parameter(torch.empty(h, e, dtype=torch.float32,
                                               device=device))
        for name, n_in, n_out in (("w_gate", h, m), ("w_up", h, m),
                                  ("w_down", m, h)):
            if cfg.quantized_dense:
                setattr(self, name, Int8Experts(e, n_in, n_out, cfg.dtype,
                                                device))
            else:
                setattr(self, name, nn.Parameter(torch.empty(
                    e, n_in, n_out, dtype=cfg.storage_dtype, device=device)))
        ms = cfg.shared_expert_size
        self.shared = ()
        if ms:
            self.shared = ("w_shared_gate", "w_shared_up", "w_shared_down",
                           "shared_gate")
            for name, n_in, n_out in zip(self.shared, (h, h, ms, h),
                                         (ms, ms, h, 1)):
                if cfg.quantized_dense:
                    setattr(self, name, Int8Dense(n_in, n_out, cfg.dtype,
                                                  device))
                else:
                    setattr(self, name, nn.Parameter(torch.empty(
                        n_in, n_out, dtype=cfg.storage_dtype,
                        device=device)))

    @torch.no_grad()
    def draw_weights(self, gen: torch.Generator) -> None:
        """Each leaf N(0, 1/fan_in), fan_in its contraction width (LeCun
        normal, untruncated, as `Llama.init_weights` draws projections)."""
        for name, fan_in in (("router", 0), ("w_gate", 1), ("w_up", 1),
                             ("w_down", 1)) + tuple(
                                 (n, 0) for n in self.shared):
            p = getattr(self, name)
            p.normal_(0.0, p.shape[fan_in] ** -0.5, generator=gen)

    def forward(self, x, adapter=None, with_aux: bool = False):  # [B, S, H]
        """The block's output [B, S, H] in the compute dtype; with
        `with_aux`, (output, router_aux_coef * the Switch term)."""
        if adapter is not None:
            raise ValueError(ADAPTER_REFUSAL)
        cfg = self.cfg
        b, s, h = x.shape
        e, k, dt = cfg.num_experts, cfg.experts_per_token, cfg.dtype
        c = expert_capacity(cfg, s)
        experts, gates, slot, keep, *aux = route(
            x, self.router, k, c, cfg.norm_topk_prob, with_aux)
        n = b * c  # rows of one expert's buffer: each batch row's C slots
        rows = torch.arange(b, device=x.device)[:, None, None] * c + slot
        dest = torch.where(keep, experts * n + rows, e * n).view(b * s, k)
        # Serving (no grad) calls the forwards without autograd's wrapper.
        dispatch, combine = ((_Dispatch.apply, _Combine.apply)
                             if torch.is_grad_enabled()
                             else (_dispatch_rows, _gather_rows))
        out = self._experts(dispatch(x.to(dt).reshape(b * s, h), dest,
                                     e * n).view(e, n, h))
        picked = combine(out.reshape(e * n, h), dest.reshape(-1))
        y = (gates.to(dt).float()[..., None]
             * picked.view(b, s, k, h).float()).sum(dim=2).to(dt)
        y = self._shared(x, y)
        return (y, cfg.router_aux_coef * aux[0]) if with_aux else y

    def forward_plain(self, x, with_aux: bool = False):
        """The block through JAX's one-hot dispatch and combine einsums
        (`gshard_route`): the plain version the routed path is held
        against. Float experts only."""
        cfg = self.cfg
        dt = cfg.dtype
        c = expert_capacity(cfg, x.shape[1])
        dispatch, combine, aux = gshard_route(
            x, self.router, cfg.experts_per_token, c, cfg.norm_topk_prob)
        xin = torch.einsum("bsec,bsh->ebch", dispatch.to(dt), x.to(dt))
        g = torch.einsum("ebch,ehm->ebcm", xin, self.w_gate.to(dt))
        u = torch.einsum("ebch,ehm->ebcm", xin, self.w_up.to(dt))
        out = torch.einsum("ebcm,emh->ebch", F.silu(g) * u,
                           self.w_down.to(dt))
        y = self._shared(x, torch.einsum("bsec,ebch->bsh", combine.to(dt),
                                         out))
        return (y, cfg.router_aux_coef * aux) if with_aux else y

    def _experts(self, xin):
        """SwiGLU of every expert over its rows: xin [E, N, H] -> [E, N,
        H]. Float stacks in three batched matmuls; int8 stacks one W8A16
        launch per expert and projection."""
        dt = self.cfg.dtype
        if not isinstance(self.w_gate, Int8Experts):
            g = torch.bmm(xin, self.w_gate.to(dt))
            u = torch.bmm(xin, self.w_up.to(dt))
            return torch.bmm(F.silu(g) * u, self.w_down.to(dt))
        outs = []
        for i in range(xin.shape[0]):
            g = self.w_gate.matmul(i, xin[i])
            u = self.w_up.matmul(i, xin[i])
            outs.append(self.w_down.matmul(i, F.silu(g) * u))
        return torch.stack(outs)

    def _shared(self, x, y):
        if self.shared:
            y = y + shared_expert_ffn(
                x, *(getattr(self, n) for n in self.shared), self.cfg.dtype)
        return y.to(self.cfg.dtype)


def MoELlama(cfg: MoEConfig, device=None, **kwargs) -> Llama:
    """Mixtral-family causal LM: the Llama trunk with routed-expert FFNs."""
    return Llama(cfg, device=device, mlp_cls=MoEBlock, **kwargs)


def causal_lm(cfg, device=None) -> nn.Module:
    """The causal LM of a config: `MoELlama` for an `MoEConfig`, `GPT2`
    for a `GPT2Config`, else the dense `Llama`."""
    from kubeflow_tpu_torch.models.gpt2 import GPT2, GPT2Config

    if isinstance(cfg, MoEConfig):
        return MoELlama(cfg, device=device)
    if isinstance(cfg, GPT2Config):
        return GPT2(cfg, device=device)
    return Llama(cfg, device=device)
