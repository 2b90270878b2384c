"""W8A8 int8 matmul: a hand-written Hopper kernel and its plain twin.

The port of `kubeflow_tpu/ops/quant_matmul.py`:

    y[m, n] = (sum_k qx[m, k] * qw[k, n]) * sx[m] * sw[n]

with the activations quantized per row (dynamic symmetric max-abs) outside
the kernel, as the JAX package does outside its `pallas_call`. On a CUDA
tensor `int8_matmul` launches one of the two kernels of `csrc/qmm.cu` (int8
tensor cores, int32 accumulators, the rescale fused into the epilogue),
chosen by shape before the launch (`_qmm_plan`): the wgmma + TMA kernel,
split along K where its tiles alone would leave SMs idle, or the byte-wise
kernel for shapes TMA cannot describe. On a CPU tensor it runs
`_int8_matmul_plain`, which sums exactly in float64 (CUDA has no int32
matmul; float64 holds every partial sum of K <= 133,000 int8 products
exactly) and applies the same epilogue. The two agree bit for bit at fp32
output. Nothing falls back: a CUDA tensor the kernels do not take raises.

Serving does not call this op: the port serves int8 weights weight-only,
as the JAX package does (`serve/quant.py`).
"""

from __future__ import annotations

import dataclasses
import threading

import torch

#: Launches of either CUDA kernel (never of the plain version), for callers
#: that must show a run went through them. Reset by assigning 0.
qmm_launches = 0
#: Of those, launches of the wgmma + TMA kernel; the rest ran the byte-wise
#: kernel. Reset by assigning 0.
qmm_wgmma_launches = 0
_count_lock = threading.Lock()

_OUT_BF16 = {torch.float32: 0, torch.bfloat16: 1}

WGMMA, BYTEWISE = "wgmma+tma", "bytewise"
_BMS = (32, 64, 128, 256)  # the wgmma kernel's activation rows per tile
_BN = 128  # weight columns per tile (both kernels)
_BK = 128  # k bytes per stage of the wgmma kernel: the unit of a split
_BYTEWISE_BM = 128
_MAX_SPLITS = 16
_MAX_SPLIT_BM = 64  # the kernel splits K only at tiles of 32 and 64 rows
#: Weight streams (CTAs) that together reach the rate the kernel attains
#: from device memory: on an H100 (700 W) 32 CTAs read ~2.1 TB/s at K 14336,
#: N 4096, and 112 reach no more than ~2.3 TB/s (tools/qmm_ab.py). Splitting
#: K past that many units only adds partial tiles to store and reduce.
_STREAMS = 32

@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """How csrc/qmm.cu runs one shape: which kernel, its activation rows
    per tile (`bm`, 0 for the byte-wise kernel), how many runs of 128-deep
    stages K is split into, and the output tiles."""

    kernel: str
    bm: int
    splits: int
    m_tiles: int
    n_tiles: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    def k_ranges(self, k: int) -> list:
        """[k0, k1) of each split, as the kernel computes them: split j takes
        stages [j * n_k // splits, (j + 1) * n_k // splits) of n_k =
        ceil(k / 128), the last stage cut at k."""
        n_k = -(-k // _BK)
        return [(j * n_k // self.splits * _BK,
                 min((j + 1) * n_k // self.splits * _BK, k))
                for j in range(self.splits)]


def _qmm_plan(m: int, k: int, n: int, sm_count: int,
              aligned: bool = True) -> QmmPlan:
    """The kernel and tiling for an [m, k] x [k, n] product on a card of
    `sm_count` SMs. TMA needs 16-byte row strides and bases (k % 16, n % 16,
    `aligned`): other shapes, and k = 0, take the byte-wise kernel. The
    wgmma kernel takes the smallest tile of 32, 64, 128 or 256 rows that
    holds m (256 beyond). At m <= 64 it splits K when fewer tiles than
    `_STREAMS` would stream the weight, into as many runs as keep tiles x
    splits within `_STREAMS` (and the card): each split costs a partial
    tile's store, a ticket and a reduction, which pay only where they add
    streams the memory can feed."""
    if k <= 0 or k % 16 or n % 16 or not aligned:
        return QmmPlan(BYTEWISE, 0, 1, -(-m // _BYTEWISE_BM), -(-n // _BN))
    bm = next((b for b in _BMS if m <= b), _BMS[-1])
    m_tiles, n_tiles = -(-m // bm), -(-n // _BN)
    tiles, n_k = m_tiles * n_tiles, -(-k // _BK)
    splits = 1
    if bm <= _MAX_SPLIT_BM:
        splits = max(1, min(n_k, _MAX_SPLITS,
                            min(_STREAMS, sm_count) // tiles))
    return QmmPlan(WGMMA, bm, splits, m_tiles, n_tiles)


# One ticket counter per output tile for split launches, by (device,
# stream): zeroed once, and left at zero by every launch (the last split of
# a tile resets its ticket), so a launch needs no memset. Launches on one
# stream run in order, so they can share the counters.
_tickets: dict = {}


def _tickets_for(dev: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _count_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < tiles:
            t = torch.zeros(max(tiles, 256), dtype=torch.int32, device=dev)
            _tickets[key] = t
        return t


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8 quantization of x [M, K]: (qx int8 [M, K],
    sx fp32 [M]) with sx = max(amax|x|, 1e-12) / 127 and qx = clip(round(
    x / sx), -127, 127), all in fp32 (round half to even, as jnp.round)."""
    x32 = x.float()
    sx = x32.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    qx = (x32 / sx[:, None]).round().clamp(-127, 127).to(torch.int8)
    return qx, sx


def _int8_matmul_plain(qx, sx, qw, sw, out_dtype=torch.float32):
    """The kernel's function: the exact integer sum (in float64), rounded
    to fp32, times sx[m], then times sw[n], each product in fp32, then cast
    to `out_dtype`. The CPU path of the wrapper, and the reference the
    kernel is held against on the card."""
    acc = (qx.double() @ qw.double()).float()
    return (acc * sx.float()[:, None] * sw.float()[None, :]).to(out_dtype)


def _int8_matmul_cuda(qx, sx, qw, sw, out_dtype=torch.float32):
    """Launch the kernel of csrc/qmm.cu that `_qmm_plan` picks, on the
    current stream (no synchronise)."""
    global qmm_launches, qmm_wgmma_launches
    dev = qx.device
    if out_dtype not in _OUT_BF16:
        raise TypeError(f"the CUDA kernel writes fp32 or bf16, not "
                        f"{out_dtype}")
    for name, x, dtype in (("qx", qx, torch.int8), ("sx", sx, torch.float32),
                           ("qw", qw, torch.int8), ("sw", sw, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, qx on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {name} as {dtype}, not "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = qx.shape
    n = qw.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("qmm.cu", "tpk_qmm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _qmm_plan(m, k, n, sms, qx.data_ptr() % 16 == 0
                         and qw.data_ptr() % 16 == 0)
        ws = tickets = None  # held until the launch is enqueued
        if plan.splits > 1:
            ws = torch.empty((plan.splits, m, n), dtype=torch.int32,
                             device=dev)
            tickets = _tickets_for(dev, stream, plan.tiles)
        err = fn(qx.data_ptr(), sx.data_ptr(), qw.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), m, k, n,
                 _OUT_BF16[out_dtype], plan.bm, plan.splits, stream)
    if err != 0:
        raise RuntimeError(f"qmm kernel launch failed: CUDA error {err}")
    with _count_lock:
        qmm_launches += 1
        qmm_wgmma_launches += plan.kernel == WGMMA
    return out


def int8_matmul(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor, *,
                block_m: int = 256, block_n: int = 256,
                out_dtype=torch.float32) -> torch.Tensor:
    """x [M, K] float; qw [K, N] int8; sw [N] fp32 per-column scales.
    Returns x @ (qw * sw) [M, N] in `out_dtype`, computed as an int8 x int8
    -> int32 product of the per-row quantized activations.

    `block_m`/`block_n` keep the JAX signature and are tile hints only: the
    CUDA kernels' tiles follow from the shape (`_qmm_plan`), and they mask
    the ragged edges themselves, so nothing is padded."""
    del block_m, block_n
    if x.dim() != 2 or qw.dim() != 2 or sw.dim() != 1:
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"qw{tuple(qw.shape)} sw{tuple(sw.shape)}")
    m, k = x.shape
    k2, n = qw.shape
    if k != k2 or tuple(sw.shape) != (n,):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"qw{tuple(qw.shape)} sw{tuple(sw.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul runs on cuda or cpu, not "
                         f"{x.device.type}")
    qx, sx = quantize_activations(x)
    if x.device.type == "cpu":
        return _int8_matmul_plain(qx, sx, qw, sw, out_dtype)
    return _int8_matmul_cuda(qx, sx, qw, sw, out_dtype)
