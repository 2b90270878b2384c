"""W8A16 matmul: activations times int8 weight codes, scaled per output.

    y[..., n] = cast(sum_k x[..., k] * q[n, k] * scale[n])

The port's counterpart of what XLA does for the int8 branch of the JAX
package's `Int8DenseGeneral` and `quant_unembed`
(`kubeflow_tpu/serve/quant.py`): the codes reach the dot through a bare
convert that XLA fuses into the operand read, so no weight-sized temporary
exists. Not a TPU kernel: the JAX package has no `pallas_call` here.

On a CUDA tensor `int8_weight_matmul` launches one of the three kernels of
`csrc/w8a16.cu`, chosen by shape before the launch (`_w8a16_plan`): the
decode kernel (at most 16 activation rows; the weight streamed once, split
along K where few CTAs would stream it), the wgmma + TMA tile kernel (more
rows; split along K where its tiles alone would leave SMs idle), or the
CUDA-core kernel (fp32 activations, K not a multiple of 16, an operand not
16-byte aligned). Accumulation is fp32 throughout and the
scale lands on the fp32 sum. On a CPU tensor it runs
`_int8_weight_matmul_plain`: the codes cast to the compute dtype, an
fp32-output matmul, the scale, the cast back. Nothing falls back: a CUDA
tensor no kernel takes raises.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops.quant_matmul import _tickets_for

#: Launches of any of the CUDA kernels (never of the plain version), for
#: callers that must show a run went through them. Reset by assigning 0.
w8a16_launches = 0
#: Of those, launches of the wgmma + TMA tile kernel. Reset by assigning 0.
w8a16_wgmma_launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SIMT, GEMV, WGMMA = "simt", "gemv", "wgmma"
_KERNEL_IDS = {SIMT: 0, GEMV: 1, WGMMA: 2}
_GEMV_MAX_M = 16  # the decode kernel's activation rows: two 8-row products
_GEMV_ROWS = 64  # weight rows a decode CTA streams
_BMS = (64, 128, 256)  # the wgmma kernel's activation rows per tile
_BN = 128  # ... and weight rows per tile
_MAX_SPLIT_BM = 128  # the wgmma kernel splits K only at tiles of 64 and 128 rows
#: Stages (of 64 k) a wgmma split runs at least: shorter runs spend their
#: time filling the ring and reducing partials (at M 128, K 4096, N 1024 on
#: an H100: 0.0191 ms at 16 stages a split, 0.0252 at 4; tools/w8a16_ab.py).
_MIN_SPLIT_STAGES = 16
_SIMT_M, _SIMT_N = 32, 64  # the CUDA-core kernel's output tiles
#: The decode kernel's k block and the wgmma kernel's stage: 64 deep, the
#: unit of a split.
_KBLOCK = 64
_MAX_SPLITS = 16
#: SMs of an H100 SXM: the plan's default card.
H100_SMS = 132
#: Decode CTAs that keep every SM of an H100 (132) streaming: about two a
#: SM. Fewer weight-row groups than this split K until they reach it.
_GEMV_CTAS = 264
_GRID_Y_MAX = 65535
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class W8a16Plan:
    """How csrc/w8a16.cu runs one [m, k] x [n, k]^T product: which kernel,
    how many ways K is split (the decode and wgmma kernels) and its grid;
    for the wgmma kernel also its tile's activation rows (`bm`, by 128
    weight rows) and the number of tiles. Its persistent CTAs (`grid`) take
    the tiles x splits units in turn."""

    kernel: str
    splits: int
    grid: tuple
    bm: int = 0
    tiles: int = 0

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    def k_ranges(self, k: int) -> list:
        """[k0, k1) of each split, as the kernels compute them: split j
        takes the 64-deep blocks (stages) [j * n_kb // splits, (j + 1) *
        n_kb // splits) of n_kb = ceil(k / 64), the last one cut at k."""
        n_kb = -(-k // _KBLOCK)
        return [(j * n_kb // self.splits * _KBLOCK,
                 min((j + 1) * n_kb // self.splits * _KBLOCK, k))
                for j in range(self.splits)]


@functools.lru_cache(maxsize=1024)  # pure, and on every decode step's path
def _w8a16_plan(m: int, k: int, n: int, dtype: torch.dtype,
                aligned: bool = True, sm_count: int = H100_SMS) -> W8a16Plan:
    """The kernel and grid for x [m, k] in `dtype` times codes [n, k] on a
    card of `sm_count` SMs.

    fp32 activations, K not a multiple of 16 or an operand not 16-byte
    aligned (`aligned`: TMA's rule too) take the CUDA-core kernel. Otherwise
    up to 16 rows take the decode kernel, which splits K (in 64-deep blocks,
    at least two a split) while fewer than _GEMV_CTAS CTAs of 64 weight rows
    would stream the weight. More rows take the wgmma kernel: the smallest
    tile of 64, 128 or 256 rows that holds m (256 beyond), 128 rows where
    256-row tiles would fill at most half the SMs, and 64 where 128-row
    units (tiles x splits) would too. Where at most half the
    SMs would have a tile (at 64 and 128 rows), K is split into as many runs
    of 64-deep stages as give each SM a unit, at most _MAX_SPLITS and each
    run at least _MIN_SPLIT_STAGES stages. Raises, naming the limit, for a
    dtype, a K or a size that no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"the W8A16 kernels take fp32, bf16 or fp16 "
                        f"activations, not {dtype}")
    if k < 1:
        raise ValueError(f"the W8A16 kernels need K >= 1, got {k}")
    if max(m * k, n * k, m * n) > _INT32_MAX:
        raise ValueError(f"M{m} K{k} N{n}: an operand or the output exceeds "
                         f"2**31 - 1 elements (the kernels' 32-bit sizes)")
    if dtype == torch.float32 or k % 16 or not aligned:
        grid = (-(-n // _SIMT_N), -(-m // _SIMT_M))
        if grid[1] > _GRID_Y_MAX:
            raise ValueError(f"M{m}: more than {_GRID_Y_MAX} row tiles of "
                             f"{_SIMT_M} for the CUDA-core kernel")
        return W8a16Plan(SIMT, 1, grid)
    n_kb = -(-k // _KBLOCK)
    if m <= _GEMV_MAX_M:
        groups = -(-n // _GEMV_ROWS)
        splits = 1
        while (splits < _MAX_SPLITS and groups * splits < _GEMV_CTAS
               and 4 * splits <= n_kb):
            splits *= 2
        return W8a16Plan(GEMV, splits, (groups, splits))
    bm = next((b for b in _BMS if m <= b), _BMS[-1])
    tiles, splits = _tiling(m, n, n_kb, bm, sm_count)
    if bm == 256 and 2 * tiles <= sm_count:
        bm = 128
        tiles, splits = _tiling(m, n, n_kb, bm, sm_count)
    # A split needs its stages, so a few 128-row tiles (k/v at 128 rows:
    # 8 tiles, 4 runs of 16 stages) leave most SMs idle, and 64-row tiles
    # double the units (tools/w8a16_ab.py's forced tile rows).
    if bm == 128 and 2 * tiles * splits <= sm_count:
        bm = 64
        tiles, splits = _tiling(m, n, n_kb, bm, sm_count)
    return W8a16Plan(WGMMA, splits, (min(tiles * splits, sm_count),), bm,
                     tiles)


def _tiling(m: int, n: int, n_kb: int, bm: int, sm_count: int) -> tuple:
    """(tiles, splits) of the wgmma kernel at bm-row tiles: K is split
    where at most half the SMs would have a tile, at bm <= 128."""
    tiles = -(-m // bm) * -(-n // _BN)
    if bm > _MAX_SPLIT_BM or 2 * tiles > sm_count:
        return tiles, 1
    return tiles, max(1, min(sm_count // tiles, n_kb // _MIN_SPLIT_STAGES,
                             _MAX_SPLITS))


@functools.lru_cache(maxsize=64)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [out, in]^T with fp32 output, both operands already
    in the compute dtype. Half-precision operands on CUDA go through one
    matmul with fp32 accumulation and fp32 output; elsewhere the operands
    are widened to fp32 first (the same products: a half-precision product
    is exact in fp32)."""
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def _int8_weight_matmul_plain(x, q, scale, round_before_scale=False):
    """The kernels' function in eager PyTorch: the codes cast to x's dtype,
    an fp32-accumulating matmul, then the fp32 scale and the cast back
    (`round_before_scale`: the matmul's output rounded to x's dtype before
    the scale, as the unembedding's einsum returns it). The CPU path of the
    wrapper, and the reference the kernels are held against on the card."""
    cd = x.dtype
    if round_before_scale:
        logits = F.linear(x, q.to(cd))
        return (logits.float() * scale).to(cd)
    y = _matmul_f32(x, q.to(cd))
    return y.mul_(scale).to(cd)  # in place: y is this call's own


def _int8_weight_matmul_cuda(x2, q, scale, round_before_scale=False):
    """Launch the kernel of csrc/w8a16.cu that `_w8a16_plan` picks for x2
    [M, K], on the current stream (no synchronise)."""
    global w8a16_launches, w8a16_wgmma_launches
    dev = x2.device
    for name, t, dtype in (("q", q, torch.int8), ("scale", scale,
                                                  torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"the W8A16 kernels take {name} as {dtype}, not "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x2.shape
    n = q.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    plan = _w8a16_plan(m, k, n, x2.dtype, x2.data_ptr() % 16 == 0
                       and q.data_ptr() % 16 == 0, _sm_count(dev.index))
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("w8a16.cu", "tpk_w8a16")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = tickets = None  # held until the launch is enqueued
    if plan.splits > 1:
        # The decode kernel's partials are [splits, m, n], the wgmma
        # kernel's a whole tile per unit; the tickets are the W8A8 op's
        # counters (one per CTA column or tile): every launch leaves them at
        # zero, and launches on one stream run in order.
        wgmma = plan.kernel == WGMMA
        ws = torch.empty(plan.units * plan.bm * _BN if wgmma
                         else (plan.splits, m, n), dtype=torch.float32,
                         device=dev)
        tickets = _tickets_for(dev, stream,
                               plan.tiles if wgmma else plan.grid[0])
    args = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), m, k, n,
            _DTYPES[x2.dtype], int(round_before_scale),
            _KERNEL_IDS[plan.kernel], plan.bm, plan.splits, stream)
    # A launch goes to the thread's current device: enter x's only when it
    # is another (the context costs host time on every decode projection).
    if torch.cuda.current_device() == dev.index:
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed: CUDA error {err}")
    with _count_lock:
        w8a16_launches += 1
        w8a16_wgmma_launches += plan.kernel == WGMMA
    return out


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor, *,
                       round_before_scale: bool = False) -> torch.Tensor:
    """x [..., K] in the compute dtype; q [N, K] int8 codes; scale [N] fp32
    per output channel. Returns [..., N] in x's dtype: the fp32 sum of x
    times the codes, times the scale (`round_before_scale`: the sum first
    rounded to x's dtype, the unembedding's epilogue), cast to x's dtype."""
    if q.dim() != 2 or scale.shape != (q.shape[0],) or x.shape[-1:] != (
            q.shape[1],):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if x.device.type == "cpu":
        return _int8_weight_matmul_plain(x, q, scale, round_before_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul runs on cuda or cpu, not "
                         f"{x.device.type}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _int8_weight_matmul_cuda(x2, q, scale, round_before_scale)
    return out.reshape(*x.shape[:-1], q.shape[0])
