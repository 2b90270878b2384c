"""Flash attention: hand-written Hopper kernels and their plain twins.

The port of `kubeflow_tpu/ops/flash_attention.py`. On a CUDA tensor the
wrappers launch hand-written CUDA C++ for sm_90a, built on first use by
`_build.py`: for bf16 at head_dim 64 or 128, the wgmma kernels of
`csrc/flash_fwd.cu` (forward) and `csrc/flash_bwd.cu` (the two-pass
backward: dq, then dk/dv); for every other fp32, bf16 or fp16 input up to
head_dim 256, the kernels of `csrc/flash_simt.cu`: a forward on the tensor
cores for bf16/fp16 (`mma.sync`, fp32 accumulation, P rounded to the input
dtype for P.V as the wgmma forward does) and on the CUDA cores for fp32,
and the CUDA-core dq and dk/dv, which compute in fp32 as the TPU kernels do
for any dtype and head dim (`_simt_fwd_plan` and `_simt_bwd_plan` pick
their grids). On a CPU tensor they run `_flash_fwd_plain` and
`_flash_bwd_plain`, the same functions with the full score matrix in fp32.
Nothing falls back: a CUDA tensor no kernel takes (head_dim above 256,
float64) raises.

Layout is the JAX package's: q [B,S,H,D], k/v [B,T,KH,D] with H % KH == 0;
out [B,S,H,D] in q's dtype and lse [B,S,H,1] fp32. Masks are applied by
array index (positions 0..S-1 and 0..T-1), as in the TPU kernels.

Gradients: when an input requires grad, `flash_attention` and
`flash_attention_lse` run through `_FlashAttention`, an autograd Function
that saves q, k, v, out and lse (as the JAX custom_vjp does) and whose
backward is the two kernels. lse is differentiable: its cotangent folds
into delta (ds = p * (dp - (delta - g_lse))).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading

import torch

from kubeflow_tpu_torch.ops.quant_matmul import _tickets_for
from kubeflow_tpu_torch.ops.w8a16 import H100_SMS, _sm_count

NEG_INF = -1e30

#: Launches of each CUDA kernel (never of the plain versions), for callers
#: that must show a run went through them. Reset by assigning 0.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
flash_simt_fwd_launches = 0  # both forward kernels of csrc/flash_simt.cu
flash_simt_fwd_mma_launches = 0  # ... of them, the tensor-core one
flash_simt_bwd_dq_launches = 0
flash_simt_bwd_dkv_launches = 0
_count_lock = threading.Lock()

_MASK_CODES = {"causal": 0, "full": 1, "prefix_lm": 2, "sliding_window": 3}

#: What the wgmma kernels take: this dtype and these head dims.
KERNEL_DTYPE = torch.bfloat16
KERNEL_HEAD_DIMS = (64, 128)
#: What the CUDA-core kernels take: these dtypes (by their C code) and head
#: dims up to this one.
SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SIMT_MAX_HEAD_DIM = 256
#: The CUDA-core backward's rows a CTA owns, largest first (at most 32
#: above head dim 128, where the [rows, D] accumulators would spill).
SIMT_BWD_ROWS = (64, 32, 16)
_SIMT_WIDE_ROWS = 32
#: dk/dv splits of a key block's walk, at most (the kernel takes 16).
SIMT_MAX_SPLITS = 8
#: The forward's kernels (their C codes): "mma" on the tensor cores for
#: bf16/fp16, "simt" on the CUDA cores for fp32.
SIMT_FWD_KERNELS = {"simt": 0, "mma": 1}
#: The tensor-core forward's query rows a CTA owns (16 a warp), largest
#: first; its head-dim buckets (the head dim is padded with zero columns to
#: the next); and its kv tile rows.
SIMT_MMA_ROWS = (128, 64, 32, 16)
SIMT_MMA_BUCKETS = (16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 256)
_SIMT_MMA_TILE = 64
_SIMT_SMEM_MAX = 232448  # an H100 CTA's dynamic shared memory, bytes
_SIMT_STAGES = 2


def cuda_kernel_takes(dtype, head_dim: int, device) -> bool:
    """Whether the wgmma kernels take q/k/v of this dtype and head dim on
    this device: bf16 on a CUDA device, head_dim 64 or 128. Their wrappers
    raise on anything else."""
    return (torch.device(device).type == "cuda" and dtype == KERNEL_DTYPE
            and head_dim in KERNEL_HEAD_DIMS)


def simt_kernel_takes(dtype, head_dim: int, device) -> bool:
    """Whether the CUDA-core kernels take q/k/v of this dtype and head dim
    on this device: fp32, bf16 or fp16 on a CUDA device, head_dim 1..256."""
    return (torch.device(device).type == "cuda" and dtype in SIMT_DTYPES
            and 1 <= head_dim <= SIMT_MAX_HEAD_DIM)


def cuda_flash_takes(dtype, head_dim: int, device) -> bool:
    """Whether a CUDA flash kernel takes these inputs: the wgmma kernels
    where they do, else the CUDA-core kernels. Callers choosing an attention
    path ask here."""
    return (cuda_kernel_takes(dtype, head_dim, device)
            or simt_kernel_takes(dtype, head_dim, device))


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Block-sparse attention mask families.

    kind:
      - "causal": rows attend cols <= row (the default).
      - "full": bidirectional (encoder-style).
      - "prefix_lm": bidirectional over the first `prefix` positions,
        causal after.
      - "sliding_window": causal, but each row sees only the trailing
        `window` keys.

    Document confinement composes via `segment_ids`, except prefix_lm,
    whose boundary is an absolute position (packed rows restart positions
    per document), which is refused with segment_ids.
    """

    kind: str = "causal"
    window: int = 0
    prefix: int = 0

    def __post_init__(self):
        kinds = tuple(_MASK_CODES)
        if self.kind not in kinds:
            raise ValueError(f"mask kind {self.kind!r}: one of {kinds}")
        if self.kind == "sliding_window" and self.window < 1:
            raise ValueError("sliding_window needs window >= 1")
        if self.kind == "prefix_lm" and self.prefix < 0:
            raise ValueError("prefix_lm needs prefix >= 0")


def _norm_mask(causal: bool, mask) -> MaskSpec:
    if mask is None:
        return MaskSpec("causal" if causal else "full")
    if isinstance(mask, str):
        return MaskSpec(mask)
    return mask


def _visible(rows, cols, mask: MaskSpec):
    """The spec's predicate over index grids (True = attend)."""
    if mask.kind == "causal":
        return rows >= cols
    if mask.kind == "prefix_lm":
        return (rows >= cols) | (cols < mask.prefix)
    if mask.kind == "sliding_window":
        return (rows >= cols) & (rows - cols < mask.window)
    return torch.ones_like(rows >= cols)  # full


def _valid(b, s, t, mask: MaskSpec, segment_ids, device):
    """[1 or B, S, T] bool: which (row, col) pairs attend."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    valid = _visible(rows, cols, mask)[None]
    if segment_ids is not None:
        sid = segment_ids.to(device=device, dtype=torch.int32)
        valid = valid & (sid[:, :, None] == sid[:, None, :])
    return valid


def _acc_dtype(x):
    """fp32, or float64 for float64 inputs (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _flash_fwd_plain(q, k, v, mask: MaskSpec, segment_ids=None):
    """The kernel's function with the full [S, T] score matrix in fp32: the
    same -1e30 mask and lse = m + log(max(l, 1e-30)). The CPU path of the
    wrapper, and the reference the kernel is held against on the card.
    Returns (out [B,S,H,D] in q's dtype, lse [B,S,H,1] fp32; float64 for
    float64 inputs)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    group = h // kh
    acc = _acc_dtype(q)
    qf = q.to(acc).reshape(b, s, kh, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.to(acc))
    scores = scores * (1.0 / math.sqrt(d))
    valid = _valid(b, s, t, mask, segment_ids, q.device)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p / lc, v.to(acc))
    lse = (m + torch.log(lc)).permute(0, 3, 1, 2, 4).reshape(b, s, h, 1)
    return out.reshape(b, s, h, d).to(q.dtype), lse


def _flash_bwd_plain(q, k, v, out, lse, do, g_lse, mask: MaskSpec,
                     segment_ids=None):
    """The backward kernels' function over the full score matrix in fp32:
    the two-pass recipe of the JAX `_flash_bwd_impl`. delta = rowsum(dO·O)
    - g_lse with O the saved output (in its own dtype, as the kernels read
    it); p = exp(s·scale - lse) masked to exactly 0; ds = p·(dp - delta);
    dq = ds·k·scale, dk = dsᵀ·(q·scale), dv = pᵀ·dO, dk/dv summed over the
    GQA group. `g_lse` [B,S,H,1] may be None. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    group = h // kh
    acc = _acc_dtype(q)
    scale = 1.0 / math.sqrt(d)
    qf = q.to(acc).reshape(b, s, kh, group, d)
    dof = do.to(acc).reshape(b, s, kh, group, d)
    kf, vf = k.to(acc), v.to(acc)
    delta = _bwd_delta(do, out, g_lse)                        # [B, S, H]

    def per_row(x):  # [B, S, H] -> [B, KH, G, S, 1]
        return x.reshape(b, s, kh, group).permute(0, 2, 3, 1)[..., None]

    scores = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    valid = _valid(b, s, t, mask, segment_ids, q.device)[:, None, None]
    p = torch.where(valid, torch.exp(scores - per_row(lse.to(acc))), 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, vf)
    ds = p * (dp - per_row(delta))
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf * scale)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_kernel_inputs(named, device) -> None:
    """What the CUDA kernels take: bf16, contiguous, 16-byte aligned, on
    one device. Raises on anything else (nothing falls back)."""
    for name, x in named:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
        if x.dtype != KERNEL_DTYPE:
            raise TypeError(f"the CUDA kernel takes bf16; {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _seg_arg(segment_ids, device):
    if segment_ids is None:
        return None
    return segment_ids.to(device=device, dtype=torch.int32).contiguous()


def _flash_fwd_cuda(q, k, v, mask: MaskSpec, segment_ids=None):
    """Launch csrc/flash_fwd.cu on the current stream (no synchronise)."""
    global flash_fwd_launches
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    _check_kernel_inputs((("q", q), ("k", k), ("v", v)), q.device)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim 64 or 128, not {d}")
    seg = _seg_arg(segment_ids, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, s, h, 1), dtype=torch.float32, device=q.device)
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("flash_fwd.cu", "tpk_flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if seg is None else seg.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b, s, t, h, kh, d,
                 _MASK_CODES[mask.kind], int(mask.window), int(mask.prefix),
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        flash_fwd_launches += 1
    return out, lse


def _bwd_delta(do, out, g_lse):
    """delta = rowsum(dO·O) - g_lse, [B,S,H] fp32 (float64 for float64
    inputs) — plain tensor arithmetic outside the kernels, as the JAX
    package computes it."""
    b, s, h, _ = do.shape
    acc_t = _acc_dtype(do)
    delta = (do.to(acc_t) * out.to(acc_t)).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.to(acc_t).reshape(b, s, h)
    return delta.contiguous()


def _bwd_args(q, k, v, do, lse, delta, mask: MaskSpec, segment_ids):
    """Checks what the backward kernels take, and their shared arguments:
    (input pointers, (B, S, T, H, KH, D, kind, window, prefix, scale))."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    _check_kernel_inputs((("q", q), ("k", k), ("v", v), ("do", do)),
                         q.device)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim 64 or 128, not {d}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.numel() != b * s * h or x.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [B,S,H(,1)] "
                             f"on {q.device}")
    seg = _seg_arg(segment_ids, q.device)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           None if seg is None else seg.data_ptr())
    return ins, seg, (b, s, t, h, kh, d, _MASK_CODES[mask.kind],
                      int(mask.window), int(mask.prefix), 1.0 / math.sqrt(d))


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask: MaskSpec,
                       segment_ids=None):
    """Launch csrc/flash_bwd.cu's dq kernel on the current stream."""
    global flash_bwd_dq_launches
    # `seg` backs a pointer in `ins`: it stays bound through the launch.
    ins, seg, common = _bwd_args(q, k, v, do, lse, delta, mask, segment_ids)
    dq = torch.empty_like(q)
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("flash_bwd.cu", "tpk_flash_bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ins, dq.data_ptr(), *common, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        flash_bwd_dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask: MaskSpec,
                        segment_ids=None):
    """Launch csrc/flash_bwd.cu's dk/dv kernel on the current stream."""
    global flash_bwd_dkv_launches
    # `seg` backs a pointer in `ins`: it stays bound through the launch.
    ins, seg, common = _bwd_args(q, k, v, do, lse, delta, mask, segment_ids)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("flash_bwd.cu", "tpk_flash_bwd_dkv")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ins, dk.data_ptr(), dv.data_ptr(), *common, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        flash_bwd_dkv_launches += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, out, lse, do, g_lse, mask: MaskSpec,
                    segment_ids=None):
    """delta in PyTorch, then the dq and dk/dv kernels (no synchronise)."""
    # The cotangent's layout is autograd's, not the caller's: make it the
    # kernels' (a no-op for the contiguous grads a model produces).
    do = do.contiguous()
    _check_kernel_inputs((("out", out),), q.device)
    delta = _bwd_delta(do, out, g_lse)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask, segment_ids)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask, segment_ids)
    return dq, dk, dv


def _check_simt_inputs(named, device, dtype) -> None:
    """What the CUDA-core kernels take: one dtype of SIMT_DTYPES,
    contiguous, on one device."""
    if dtype not in SIMT_DTYPES:
        raise TypeError(f"the CUDA-core kernels take fp32, bf16 or fp16, "
                        f"not {dtype}")
    for name, x in named:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, q {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _simt_common(q, k, mask: MaskSpec):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if not 1 <= d <= SIMT_MAX_HEAD_DIM:
        raise ValueError(f"the CUDA-core kernels take head_dim up to "
                         f"{SIMT_MAX_HEAD_DIM}, not {d}")
    return (b, s, t, h, kh, d, _MASK_CODES[mask.kind], int(mask.window),
            int(mask.prefix), 1.0 / math.sqrt(d))


def _flash_simt_fwd_cuda(q, k, v, mask: MaskSpec, segment_ids=None,
                         plan: SimtFwdPlan | None = None):
    """Launch csrc/flash_simt.cu's forward on the current stream: the
    kernel and rows of `plan` (default `_simt_fwd_plan`'s)."""
    global flash_simt_fwd_launches, flash_simt_fwd_mma_launches
    _check_simt_inputs((("q", q), ("k", k), ("v", v)), q.device, q.dtype)
    common = _simt_common(q, k, mask)
    plan = plan or _simt_fwd_plan_for(q, k)
    b, s, h = q.shape[:3]
    seg = _seg_arg(segment_ids, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, s, h, 1), dtype=torch.float32, device=q.device)
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("flash_simt.cu", "tpk_flash_simt_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(SIMT_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), None if seg is None else seg.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), *common,
                 SIMT_FWD_KERNELS[plan.kernel], plan.rows, stream)
    if err != 0:
        raise RuntimeError(f"flash_simt_fwd ({plan.kernel}) kernel launch "
                           f"failed: CUDA error {err}")
    with _count_lock:
        flash_simt_fwd_launches += 1
        flash_simt_fwd_mma_launches += plan.kernel == "mma"
    return out, lse


def _simt_bucket(d: int) -> int:
    """The head-dim bucket a CUDA-core kernel is instantiated at."""
    return next(dm for dm in (32, 64, 128, 256) if d <= dm)


def _simt_smem(dkv: bool, size: int, dm: int, rows: int, n: int,
               pbufs: int) -> int:
    """Shared bytes of a backward CTA (csrc/flash_simt.cu BwdTile): the
    owned rows' two operands, _SIMT_STAGES stages of the streamed tile's
    two operands and its per-row words, and `pbufs` fp32 [rows, n] buffers
    for dS (and P); rows of `size`-byte elements padded by 16 bytes."""
    ld = dm + 16 // size
    stage = 2 * n * ld * size + (3 if dkv else 1) * n * 4
    return (2 * rows * ld * size + _SIMT_STAGES * stage
            + pbufs * rows * (n + 8) * 4)


def _simt_tile(dkv: bool, size: int, dm: int, rows: int) -> int:
    """Rows of the streamed tile (the kernel's BwdTile::kN): 64 where the
    ring of 64-row tiles fits in shared memory, for dk/dv with P and dS
    sharing a buffer where a buffer each would not fit; else 32. At 16
    owned rows also 32 where 64 would take more than half the SM's shared
    memory (a second CTA then fits beside it)."""
    own = _simt_smem(dkv, size, dm, rows, 64, 2 if dkv else 1)
    if rows == SIMT_BWD_ROWS[-1] and own > _SIMT_SMEM_MAX // 2:
        return 32
    if own <= _SIMT_SMEM_MAX:
        return 64
    if dkv and _simt_smem(dkv, size, dm, rows, 64, 1) <= _SIMT_SMEM_MAX:
        return 64
    return 32


@dataclasses.dataclass(frozen=True)
class SimtBwdPlan:
    """The CUDA-core backward's grid: rows a CTA owns and the streamed
    tile of each pass, and the splits of a dk/dv key block's walk over
    (GQA head, q tile) pairs."""

    dq_rows: int
    dq_tile: int
    dkv_rows: int
    dkv_tile: int
    splits: int
    dq_ctas: int
    dkv_blocks: int  # key blocks, B * KH * ceil(T / dkv_rows): one ticket each
    walk: int  # (GQA head, q tile) pairs of a key block, unmasked

    @property
    def dkv_ctas(self) -> int:
        return self.dkv_blocks * self.splits


def _fill_rows(units: int, n: int, top: int, sm_count: int) -> int:
    """The largest of `top`, top / 2, ... down to 16 rows whose `units` *
    ceil(n / rows) CTAs fill `sm_count` SMs, else 16."""
    rows = top
    while rows > SIMT_BWD_ROWS[-1] and units * -(-n // rows) < sm_count:
        rows //= 2
    return rows


@functools.lru_cache(maxsize=1024)  # pure, and on every backward's path
def _simt_bwd_plan(b: int, s: int, t: int, h: int, kh: int, d: int,
                   dtype: torch.dtype, sm_count: int = H100_SMS) -> SimtBwdPlan:
    """The CUDA-core dq and dk/dv grids for q [b, s, h, d] and k/v [b, t,
    kh, d] of `dtype` on a card of `sm_count` SMs.

    Each pass owns 64 rows a CTA (32 above head dim 128), halved down to 16
    while its CTAs (b * h * ceil(s / rows) for dq, b * kh * ceil(t / rows)
    key blocks for dk/dv) would not fill the SMs. Where dk/dv's key blocks
    still leave SMs idle, each block's walk over (GQA head, q tile) pairs
    is split over as many CTAs as give every SM one (ceil(SMs / blocks)):
    at most the walk's steps (q tiles of the pass's streamed tile,
    unmasked) and SIMT_MAX_SPLITS. Raises, naming the limit, for what no
    kernel takes."""
    _check_simt_sizes(b, s, t, h, kh, d, dtype)
    dm = _simt_bucket(d)
    size = torch.empty((), dtype=dtype).element_size()
    top = SIMT_BWD_ROWS[0] if dm <= 128 else _SIMT_WIDE_ROWS
    dq_rows = _fill_rows(b * h, s, top, sm_count)
    dkv_rows = _fill_rows(b * kh, t, top, sm_count)
    dkv_tile = _simt_tile(True, size, dm, dkv_rows)
    blocks = b * kh * -(-t // dkv_rows)
    walk = h // kh * -(-s // dkv_tile)
    splits = 1
    if blocks < sm_count:
        splits = min(walk, -(-sm_count // blocks), SIMT_MAX_SPLITS)
    return SimtBwdPlan(dq_rows, _simt_tile(False, size, dm, dq_rows),
                       dkv_rows, dkv_tile, splits, b * h * -(-s // dq_rows),
                       blocks, walk)


def _check_simt_sizes(b, s, t, h, kh, d, dtype) -> None:
    """Raises, naming the limit, for what no kernel of csrc/flash_simt.cu
    takes."""
    if dtype not in SIMT_DTYPES:
        raise TypeError(f"the CUDA-core kernels take fp32, bf16 or fp16, "
                        f"not {dtype}")
    if not 1 <= d <= SIMT_MAX_HEAD_DIM:
        raise ValueError(f"the CUDA-core kernels take head_dim up to "
                         f"{SIMT_MAX_HEAD_DIM}, not {d}")
    if min(b, s, t, h, kh) < 1 or h % kh:
        raise ValueError(f"B{b} S{s} T{t} H{h} KH{kh}: sizes must be "
                         f"positive and H a multiple of KH")


def _simt_fwd_smem(size: int, dm: int, rows: int, n: int) -> int:
    """Shared bytes of a CUDA-core forward CTA (csrc/flash_simt.cu
    FwdTile): Q [rows], _SIMT_STAGES stages of K and V [n] with the keys'
    segment ids, fp32 P [rows, n + 8]; rows of `size`-byte elements padded
    by 16 bytes."""
    ld = dm + 16 // size
    return (rows * ld * size + _SIMT_STAGES * (2 * n * ld * size + n * 4)
            + rows * (n + 8) * 4)


def _simt_fwd_tile(size: int, dm: int, rows: int) -> int:
    """kv tile rows of the CUDA-core forward (FwdTile::kN), by the
    backward's rules: 64 where two stages fit, and at 16 owned rows where
    they leave room for a second CTA on the SM; else 32."""
    own = _simt_fwd_smem(size, dm, rows, 64)
    if own > _SIMT_SMEM_MAX or (rows == SIMT_BWD_ROWS[-1]
                                and own > _SIMT_SMEM_MAX // 2):
        return 32
    return 64


def _mma_bucket(d: int) -> int:
    """The head-dim bucket the tensor-core forward is instantiated at."""
    return next(dm for dm in SIMT_MMA_BUCKETS if d <= dm)


def _mma_smem(dm: int, rows: int) -> int:
    """Shared bytes of a tensor-core forward CTA (csrc/flash_simt.cu
    mma_smem_bytes): Q [rows] and _SIMT_STAGES stages of K and V
    [_SIMT_MMA_TILE], rows of 2-byte elements padded by 16 bytes, with the
    keys' segment ids."""
    ld = dm + 8
    return (2 * rows * ld
            + _SIMT_STAGES * (4 * _SIMT_MMA_TILE * ld + 4 * _SIMT_MMA_TILE))


@dataclasses.dataclass(frozen=True)
class SimtFwdPlan:
    """The forward of csrc/flash_simt.cu: which kernel, the head-dim bucket
    it runs at, the query rows a CTA owns, the kv tile rows, the CTAs and
    a CTA's shared bytes."""

    kernel: str  # "mma" (tensor cores) or "simt" (CUDA cores)
    bucket: int
    rows: int
    tile: int
    ctas: int
    smem: int


@functools.lru_cache(maxsize=1024)  # pure, and on every forward's path
def _simt_fwd_plan(b: int, s: int, t: int, h: int, kh: int, d: int,
                   dtype: torch.dtype, sm_count: int = H100_SMS,
                   kernel: str | None = None) -> SimtFwdPlan:
    """The forward's kernel and grid for q [b, s, h, d] and k/v [b, t, kh,
    d] of `dtype` on a card of `sm_count` SMs.

    bf16 and fp16 go to the tensor-core kernel ("mma"), fp32 to the
    CUDA-core one ("simt"), which keeps fp32 math; `kernel` forces one (the
    CUDA-core kernel takes every dtype, the tensor-core one bf16 and fp16
    only). Query rows a CTA owns: the most (128 for "mma"; 64 for "simt",
    32 above head dim 128) whose b * h * ceil(s / rows) CTAs fill the SMs,
    halved down to 16 while they do not. Raises, naming the limit, for
    what no kernel takes."""
    _check_simt_sizes(b, s, t, h, kh, d, dtype)
    if kernel is None:
        kernel = "simt" if dtype == torch.float32 else "mma"
    if kernel not in SIMT_FWD_KERNELS:
        raise ValueError(f"forward kernel {kernel!r}: one of "
                         f"{tuple(SIMT_FWD_KERNELS)}")
    if kernel == "mma" and dtype == torch.float32:
        raise TypeError("the tensor-core forward takes bf16 or fp16, not "
                        "fp32 (an fp32 model keeps fp32 attention)")
    size = torch.empty((), dtype=dtype).element_size()
    if kernel == "mma":
        dm = _mma_bucket(d)
        rows = _fill_rows(b * h, s, SIMT_MMA_ROWS[0], sm_count)
        tile, smem = _SIMT_MMA_TILE, _mma_smem(dm, rows)
    else:
        dm = _simt_bucket(d)
        top = SIMT_BWD_ROWS[0] if dm <= 128 else _SIMT_WIDE_ROWS
        rows = _fill_rows(b * h, s, top, sm_count)
        tile = _simt_fwd_tile(size, dm, rows)
        smem = _simt_fwd_smem(size, dm, rows, tile)
    return SimtFwdPlan(kernel, dm, rows, tile, b * h * -(-s // rows), smem)


def _simt_fwd_plan_for(q, k) -> SimtFwdPlan:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    return _simt_fwd_plan(b, s, t, h, kh, d, q.dtype,
                          _sm_count(q.device.index))


def _simt_plan_for(q, k) -> SimtBwdPlan:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    return _simt_bwd_plan(b, s, t, h, kh, d, q.dtype,
                          _sm_count(q.device.index))


def _simt_bwd_args(q, k, v, do, lse, delta, mask: MaskSpec, segment_ids):
    """Checks what the CUDA-core backward kernels take; returns (dtype
    code, input pointers, seg, common arguments)."""
    b, s, h, _ = q.shape
    _check_simt_inputs((("q", q), ("k", k), ("v", v), ("do", do)), q.device,
                       q.dtype)
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.numel() != b * s * h or x.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [B,S,H(,1)] "
                             f"on {q.device}")
    common = _simt_common(q, k, mask)
    seg = _seg_arg(segment_ids, q.device)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           None if seg is None else seg.data_ptr())
    return SIMT_DTYPES[q.dtype], ins, seg, common


def _flash_simt_bwd_dq_cuda(q, k, v, do, lse, delta, mask: MaskSpec,
                            segment_ids=None, plan: SimtBwdPlan | None = None):
    """Launch csrc/flash_simt.cu's dq kernel on the current stream, at
    `plan`'s rows (default `_simt_bwd_plan`'s)."""
    global flash_simt_bwd_dq_launches
    # `seg` backs a pointer in `ins`: it stays bound through the launch.
    code, ins, seg, common = _simt_bwd_args(q, k, v, do, lse, delta, mask,
                                            segment_ids)
    plan = plan or _simt_plan_for(q, k)
    dq = torch.empty_like(q)
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("flash_simt.cu", "tpk_flash_simt_bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(code, *ins, dq.data_ptr(), *common, plan.dq_rows, stream)
    if err != 0:
        raise RuntimeError(f"flash_simt_bwd_dq kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        flash_simt_bwd_dq_launches += 1
    return dq


def _flash_simt_bwd_dkv_cuda(q, k, v, do, lse, delta, mask: MaskSpec,
                             segment_ids=None,
                             plan: SimtBwdPlan | None = None):
    """Launch csrc/flash_simt.cu's dk/dv kernel on the current stream, at
    `plan`'s rows and splits (default `_simt_bwd_plan`'s). Split launches
    get an fp32 workspace for the partials and the W8A8 op's ticket
    counters (every launch leaves them at zero)."""
    global flash_simt_bwd_dkv_launches
    # `seg` backs a pointer in `ins`: it stays bound through the launch.
    code, ins, seg, common = _simt_bwd_args(q, k, v, do, lse, delta, mask,
                                            segment_ids)
    plan = plan or _simt_plan_for(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("flash_simt.cu", "tpk_flash_simt_bwd_dkv")
    ws = tickets = None  # held until the launch is enqueued
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan.splits > 1:
            ws = torch.empty(plan.dkv_ctas * 2 * plan.dkv_rows
                             * _simt_bucket(q.shape[-1]),
                             dtype=torch.float32, device=q.device)
            tickets = _tickets_for(q.device, stream, plan.dkv_blocks)
        err = fn(code, *ins, dk.data_ptr(), dv.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), *common,
                 plan.dkv_rows, plan.splits, stream)
    if err != 0:
        raise RuntimeError(f"flash_simt_bwd_dkv kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        flash_simt_bwd_dkv_launches += 1
    return dk, dv


def _flash_simt_bwd_cuda(q, k, v, out, lse, do, g_lse, mask: MaskSpec,
                         segment_ids=None):
    """delta in PyTorch, then the CUDA-core dq and dk/dv kernels."""
    do = do.contiguous()
    _check_simt_inputs((("out", out),), q.device, q.dtype)
    delta = _bwd_delta(do, out, g_lse)
    dq = _flash_simt_bwd_dq_cuda(q, k, v, do, lse, delta, mask, segment_ids)
    dk, dv = _flash_simt_bwd_dkv_cuda(q, k, v, do, lse, delta, mask,
                                      segment_ids)
    return dq, dk, dv


def _cuda_route(dtype, d: int, device) -> str:
    """Which kernels take CUDA q/k/v of this dtype and head dim: "sm90"
    (wgmma) or "simt" (CUDA cores). Raises when neither does."""
    if cuda_kernel_takes(dtype, d, device):
        return "sm90"
    if simt_kernel_takes(dtype, d, device):
        return "simt"
    raise ValueError(
        f"no CUDA flash kernel takes {dtype} at head_dim {d}: the wgmma "
        f"kernels take bf16 at 64 or 128, the CUDA-core kernels fp32, bf16 "
        f"or fp16 up to {SIMT_MAX_HEAD_DIM}; use attention_impl='naive'")


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return q.device.type


def _fwd(q, k, v, spec, segment_ids):
    if _device_kind(q) == "cpu":
        return _flash_fwd_plain(q, k, v, spec, segment_ids)
    if _cuda_route(q.dtype, q.shape[-1], q.device) == "simt":
        return _flash_simt_fwd_cuda(q, k, v, spec, segment_ids)
    return _flash_fwd_cuda(q, k, v, spec, segment_ids)


def _bwd(q, k, v, out, lse, do, g_lse, spec, segment_ids):
    if _device_kind(q) == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, do, g_lse, spec,
                                segment_ids)
    if _cuda_route(q.dtype, q.shape[-1], q.device) == "simt":
        return _flash_simt_bwd_cuda(q, k, v, out, lse, do, g_lse, spec,
                                    segment_ids)
    return _flash_bwd_cuda(q, k, v, out, lse, do, g_lse, spec, segment_ids)


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with the flash backward; the counterpart of the JAX
    custom_vjp rules (residuals q, k, v, out, lse and the segment ids)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, spec):
        out, lse = _fwd(q, k, v, spec, segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        if g_out is None:  # only lse was used
            g_out = torch.zeros_like(out)
        dq, dk, dv = _bwd(q, k, v, out, lse, g_out, g_lse, ctx.spec,
                          segment_ids)
        return dq, dk, dv, None, None


def _attn_impl(q, k, v, causal, segment_ids=None, mask=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,S,H,D] and k/v [B,T,KH,D] expected; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % kh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
    spec = _norm_mask(causal, mask)
    if spec.kind == "prefix_lm" and segment_ids is not None:
        raise ValueError(
            "prefix_lm does not compose with segment_ids: packed rows "
            "restart positions per document, but the prefix boundary is "
            "an absolute index — only the first document would get a "
            "bidirectional prefix. Pack prefix-LM data unsegmented.")
    if segment_ids is not None and (tuple(segment_ids.shape) != (b, s)
                                    or t != s):
        raise ValueError(
            f"segment_ids must be [B,S]={b, s} for self-attention "
            f"(got {tuple(segment_ids.shape)}, T={t})")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, segment_ids, spec)
    return _fwd(q, k, v, spec, segment_ids)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_kv: int = 512, segment_ids=None, mask=None):
    """Flash attention. q [B,S,H,D]; k,v [B,T,KH,D]; returns [B,S,H,D] in
    q's dtype. Differentiable in q, k, v (the flash backward kernels).

    `segment_ids` [B,S] int (self-attention only) confines attention within
    equal-id spans. `mask` (a MaskSpec or kind string) selects causal /
    full / prefix_lm / sliding_window, overriding `causal`; kv tiles a q
    tile cannot see are skipped, not masked, in all three kernels.
    prefix_lm is refused with segment_ids.

    `block_q`/`block_kv` keep the JAX signature and are ignored: the CUDA
    kernels' tiles are fixed by their design, and the CPU path computes
    the whole score matrix at once."""
    del block_q, block_kv
    out, _ = _attn_impl(q, k, v, causal, segment_ids, mask)
    return out


def flash_attention_lse(q, k, v, causal: bool = True, block_q: int = 512,
                        block_kv: int = 512, segment_ids=None, mask=None):
    """Flash attention returning (out [B,S,H,D], lse [B,S,H,1] fp32), lse
    being the per-row logsumexp of the scaled scores. Both outputs are
    differentiable. Arguments as for `flash_attention`."""
    del block_q, block_kv
    return _attn_impl(q, k, v, causal, segment_ids, mask)
