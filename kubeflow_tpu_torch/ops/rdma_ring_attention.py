"""Context-parallel ring attention: hand-written Hopper kernels and their
plain twins.

The port of `kubeflow_tpu/ops/rdma_ring_attention.py`: causal attention
over a sequence cut into n contiguous shards, one per rank of the mesh axis
`axis_name`. Rank `me` keeps its q shard (rows me*s .. me*s + s - 1) and sees
the K/V shards of every rank, masked by global position; the gradient is the
JAX package's two-pass backward (resident dq from the travelling K/V, then
resident dk/dv from the travelling q, dO, lse and delta).

On a CUDA tensor the op cuts q, k, v (and dO, lse, delta) into n separately
allocated shards, as they would lie on n devices, and launches
`csrc/rdma_ring.cu` once per rank: `tpk_rdma_fwd`, `tpk_rdma_bwd_dq`,
`tpk_rdma_bwd_dkv`. Each launch gets its rank's own shard and a table of
every rank's pointer to what travels; the kernel pulls only the shards it
can see. On a CPU tensor the same per-rank walk runs as plain PyTorch
(`_rdma_fwd_plain`, `_rdma_bwd_plain`). Nothing falls back: a CUDA tensor
the kernels do not take raises.

So far all ranks share one device (one card, or the CPU), as the JAX
package's tests place the ring on virtual devices. Ranks on separate cards
and meshes with batch axes are refused by name (ROADMAP A5, "B5–B7 across
four cards").
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from kubeflow_tpu_torch.ops.flash_attention import (NEG_INF, _acc_dtype,
                                                    _bwd_delta,
                                                    flash_attention)
from kubeflow_tpu_torch.parallel.mesh import current_mesh

#: Launches of each CUDA kernel, one per rank of a call (never of the plain
#: versions), for callers that must show a run went through them. Reset by
#: assigning 0.
rdma_fwd_launches = 0
rdma_bwd_dq_launches = 0
rdma_bwd_dkv_launches = 0
_count_lock = threading.Lock()

#: The largest ring one launch takes (kMaxRanks in csrc/rdma_ring.cu).
MAX_RANKS = 16


def _same_device(x: torch.Tensor, dev: torch.device) -> bool:
    return x.device.type == dev.type and dev.index in (None, x.device.index)


def _resolve_ring(axis_name, mesh):
    """(mesh, n): the mesh given or installed by `with mesh:`, and the size
    of its ring axis. One place for the op and its backward."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("rdma_ring_attention needs a mesh")
    if axis_name not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis_name!r} "
                         f"(axes {mesh.axis_names})")
    if mesh.axis_names != (axis_name,):
        raise NotImplementedError(
            f"a mesh with axes besides {axis_name!r} ({mesh.axis_names}): "
            "sharding the batch over data/fsdp waits for ROADMAP A5 "
            "(parallel/)")
    if len(set(mesh.devices)) != 1:
        raise NotImplementedError(
            f"ring ranks on different devices ({mesh.devices}): ranks on "
            "separate cards need peer memory between them, ROADMAP \"B5–B7 "
            "across four cards\" after A5 (parallel/)")
    return mesh, mesh.shape[axis_name]


def _check_inputs(q, k, v, n, dev):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,S,H,D] and k/v [B,S,KH,D] expected; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s_glob, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s_glob or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if s_glob % n:
        raise ValueError(f"sequence length {s_glob} does not split into {n} "
                         "equal shards")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _same_device(x, dev):
            raise ValueError(f"{name} is on {x.device}, the mesh on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ring attention runs on cuda or cpu, not "
                         f"{dev.type}")


def _shards(x, n):
    """n separately allocated contiguous shards of x along the sequence."""
    return [c.clone(memory_format=torch.contiguous_format)
            for c in x.chunk(n, dim=1)]


def _kv_order(me, n):
    """The sources rank `me` reads K/V from in the forward and dq: the TPU
    kernel's ring order src = (me - i) mod n, i = 0..n-1, without the shards
    masked in full (src > me)."""
    return [(me - i) % n for i in range(n) if (me - i) % n <= me]


def _q_order(me, n):
    """The sources of q/dO/lse/delta for rank `me`'s dk/dv: the same ring
    order without the shards masked in full (src < me)."""
    return [(me - i) % n for i in range(n) if (me - i) % n >= me]


def _grid(me, src, s, device):
    """[s, s] bool: which (row of shard me, col of shard src) pairs attend,
    by global position."""
    rows = me * s + torch.arange(s, device=device)[:, None]
    cols = src * s + torch.arange(s, device=device)[None, :]
    return rows >= cols


def _per_row(x, kh):
    """[B, s, H] -> [B, KH, G, s, 1]."""
    b, s, h = x.shape
    return x.reshape(b, s, kh, h // kh).permute(0, 2, 3, 1)[..., None]


def _fwd_rank_plain(me, qs, ks, vs):
    """Rank me's forward: fp32 online-softmax partials carried across the
    visible shards, divided at the end. (out [B,s,H,D], lse [B,s,H])."""
    q = qs[me]
    b, s, h, d = q.shape
    kh = ks[me].shape[2]
    acc_t = _acc_dtype(q)
    scale = 1.0 / math.sqrt(d)
    qf = q.to(acc_t).reshape(b, s, kh, h // kh, d)
    m = torch.full((b, kh, h // kh, s, 1), NEG_INF, dtype=acc_t,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, h // kh, s, d), dtype=acc_t, device=q.device)
    for src in _kv_order(me, len(qs)):
        sc = torch.einsum("bskgd,btkd->bkgst", qf, ks[src].to(acc_t)) * scale
        sc = torch.where(_grid(me, src, s, q.device), sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p,
                                         vs[src].to(acc_t))
        m = m_new
    lc = l.clamp_min(1e-30)
    out = (acc / lc).permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    lse = (m + torch.log(lc))[..., 0].permute(0, 3, 1, 2).reshape(b, s, h)
    return out.to(q.dtype), lse


def _dq_rank_plain(me, qs, ks, vs, dos, lses, deltas):
    """Rank me's dq: K/V of the visible shards against the resident q, dO
    and row stats."""
    q = qs[me]
    b, s, h, d = q.shape
    kh = ks[me].shape[2]
    acc_t = _acc_dtype(q)
    scale = 1.0 / math.sqrt(d)
    qf = q.to(acc_t).reshape(b, s, kh, h // kh, d)
    dof = dos[me].to(acc_t).reshape(b, s, kh, h // kh, d)
    lse, delta = _per_row(lses[me].to(acc_t), kh), _per_row(deltas[me], kh)
    dq = torch.zeros_like(qf)
    for src in _kv_order(me, len(qs)):
        kf, vf = ks[src].to(acc_t), vs[src].to(acc_t)
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
        p = torch.where(_grid(me, src, s, q.device), torch.exp(sc - lse), 0.0)
        dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
        ds = p * (dp - delta)
        dq = dq + torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    return dq.reshape(b, s, h, d).to(q.dtype)


def _dkv_rank_plain(me, qs, ks, vs, dos, lses, deltas):
    """Rank me's dk and dv: q, dO and row stats of the visible shards
    against the resident K/V, summed over each kv head's GQA group."""
    k, v = ks[me], vs[me]
    b, s, h, d = qs[me].shape
    kh = k.shape[2]
    acc_t = _acc_dtype(k)
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.to(acc_t), v.to(acc_t)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for src in _q_order(me, len(qs)):
        qf = qs[src].to(acc_t).reshape(b, s, kh, h // kh, d)
        dof = dos[src].to(acc_t).reshape(b, s, kh, h // kh, d)
        lse = _per_row(lses[src].to(acc_t), kh)
        delta = _per_row(deltas[src], kh)
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
        p = torch.where(_grid(src, me, s, k.device), torch.exp(sc - lse), 0.0)
        dv = dv + torch.einsum("bkgst,bskgd->btkd", p, dof)
        dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
        ds = p * (dp - delta)
        dk = dk + torch.einsum("bkgst,bskgd->btkd", ds, qf * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def _ring_ptrs(tensors):
    """A host array of the ranks' device pointers, as the kernels take it."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch(symbol, ptrs, n, me, q, kh):
    """One rank's launch of `symbol` on the current stream (no synchronise);
    a ctypes pointer array in `ptrs` is passed by address."""
    from kubeflow_tpu_torch.ops import _build

    b, s, h, d = q.shape
    args = [ctypes.addressof(p) if isinstance(p, ctypes.Array) else p
            for p in ptrs]
    fn = _build.function("rdma_ring.cu", symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, n, me, b, s, h, kh, d, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch for rank {me} of {n} failed: "
                           f"CUDA error {err}")


def _fwd_rank_cuda(me, qs, ks, vs):
    """Launch rank me's forward kernel: (out [B,s,H,D], lse [B,s,H] fp32)."""
    global rdma_fwd_launches
    q = qs[me]
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("tpk_rdma_fwd", (q.data_ptr(), _ring_ptrs(ks), _ring_ptrs(vs),
                             out.data_ptr(), lse.data_ptr()),
            len(qs), me, q, ks[me].shape[2])
    with _count_lock:
        rdma_fwd_launches += 1
    return out, lse


def _dq_rank_cuda(me, qs, ks, vs, dos, lses, deltas):
    """Launch rank me's dq kernel."""
    global rdma_bwd_dq_launches
    q = qs[me]
    dq = torch.empty_like(q)
    _launch("tpk_rdma_bwd_dq", (q.data_ptr(), _ring_ptrs(ks), _ring_ptrs(vs),
                                dos[me].data_ptr(), lses[me].data_ptr(),
                                deltas[me].data_ptr(), dq.data_ptr()),
            len(qs), me, q, ks[me].shape[2])
    with _count_lock:
        rdma_bwd_dq_launches += 1
    return dq


def _dkv_rank_cuda(me, qs, ks, vs, dos, lses, deltas):
    """Launch rank me's dk/dv kernel."""
    global rdma_bwd_dkv_launches
    k, v = ks[me], vs[me]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("tpk_rdma_bwd_dkv", (_ring_ptrs(qs), _ring_ptrs(dos),
                                 _ring_ptrs(lses), _ring_ptrs(deltas),
                                 k.data_ptr(), v.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr()),
            len(qs), me, qs[me], k.shape[2])
    with _count_lock:
        rdma_bwd_dkv_launches += 1
    return dk, dv


def _check_cuda(named, n):
    """What the CUDA kernels take; raises on anything else."""
    for name, x in named:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bf16; {name} is "
                            f"{x.dtype}")
    d = named[0][1].shape[-1]
    if d not in (64, 128):
        raise ValueError(f"the CUDA kernels take head_dim 64 or 128, not {d}")
    if n > MAX_RANKS:
        raise ValueError(f"the CUDA kernels take rings of at most "
                         f"{MAX_RANKS} ranks, not {n}")


def _fwd_ring(q, k, v, n, rank):
    qs, ks, vs = (_shards(x, n) for x in (q, k, v))
    res = [rank(me, qs, ks, vs) for me in range(n)]
    return (torch.cat([o for o, _ in res], dim=1),
            torch.cat([lse for _, lse in res], dim=1))


def _bwd_ring(q, k, v, out, lse, do, n, dq_rank, dkv_rank):
    delta = _bwd_delta(do, out, None)
    shards = [_shards(x, n) for x in (q, k, v, do, lse, delta)]
    dq = torch.cat([dq_rank(me, *shards) for me in range(n)], dim=1)
    dkv = [dkv_rank(me, *shards) for me in range(n)]
    return (dq, torch.cat([a for a, _ in dkv], dim=1),
            torch.cat([b for _, b in dkv], dim=1))


def _rdma_fwd_plain(q, k, v, n):
    """The forward kernels' function, rank by rank in plain PyTorch:
    (out [B,S,H,D] in q's dtype, lse [B,S,H] fp32; float64 for float64)."""
    return _fwd_ring(q, k, v, n, _fwd_rank_plain)


def _rdma_bwd_plain(q, k, v, out, lse, do, n):
    """The backward kernels' function, rank by rank in plain PyTorch:
    (dq, dk, dv) in the dtypes of q, k, v."""
    return _bwd_ring(q, k, v, out, lse, do, n, _dq_rank_plain,
                     _dkv_rank_plain)


def _rdma_fwd_cuda(q, k, v, n):
    """One forward launch per rank on the current stream (no synchronise)."""
    _check_cuda((("q", q), ("k", k), ("v", v)), n)
    return _fwd_ring(q, k, v, n, _fwd_rank_cuda)


def _rdma_bwd_cuda(q, k, v, out, lse, do, n):
    """delta in PyTorch, then one dq and one dk/dv launch per rank."""
    _check_cuda((("q", q), ("k", k), ("v", v), ("out", out), ("do", do)), n)
    return _bwd_ring(q, k, v, out, lse, do, n, _dq_rank_cuda, _dkv_rank_cuda)


def _fwd(q, k, v, n):
    if q.device.type == "cpu":
        return _rdma_fwd_plain(q, k, v, n)
    return _rdma_fwd_cuda(q, k, v, n)


def _bwd(q, k, v, out, lse, do, n):
    if q.device.type == "cpu":
        return _rdma_bwd_plain(q, k, v, out, lse, do, n)
    return _rdma_bwd_cuda(q, k, v, out, lse, do, n)


class _RdmaRingAttention(torch.autograd.Function):
    """out with the two-pass ring backward; the counterpart of the JAX
    custom_vjp rules (residuals q, k, v, out and lse)."""

    @staticmethod
    def forward(ctx, q, k, v, n):
        out, lse = _fwd(q, k, v, n)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, g.contiguous(), ctx.n)
        return dq, dk, dv, None


def rdma_ring_attention(q, k, v, axis_name: str = "seq", mesh=None):
    """Causal ring attention over the `axis_name` ring of `mesh` (or the
    mesh installed by `with mesh:`). q [B,S,H,D], k/v [B,S,KH,D], the
    sequence cut into n = mesh.shape[axis_name] contiguous shards; returns
    out [B,S,H,D] in q's dtype, differentiable in q, k and v.

    A one-rank ring is plain flash attention, forward and backward, as in
    the JAX package."""
    mesh, n = _resolve_ring(axis_name, mesh)
    _check_inputs(q, k, v, n, mesh.devices[0])
    if n == 1:
        return flash_attention(q, k, v, True)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RdmaRingAttention.apply(q, k, v, n)
    return _fwd(q, k, v, n)[0]
