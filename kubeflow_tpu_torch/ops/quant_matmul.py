"""W8A8 int8 matmul: a hand-written Hopper kernel and its plain twin.

The port of `kubeflow_tpu/ops/quant_matmul.py`:

    y[m, n] = (sum_k qx[m, k] * qw[k, n]) * sx[m] * sw[n]

with the activations quantized per row (dynamic symmetric max-abs) outside
the kernel, as the JAX package does outside its `pallas_call`. On a CUDA
tensor `int8_matmul` launches `csrc/qmm.cu` (int8 tensor cores, int32
accumulators, the rescale fused into the epilogue); on a CPU tensor it runs
`_int8_matmul_plain`, which sums exactly in float64 (CUDA has no int32
matmul; float64 holds every partial sum of K <= 133,000 int8 products
exactly) and applies the same epilogue. The two agree bit for bit at fp32
output. Nothing falls back: a CUDA tensor the kernel does not take raises.

Serving does not call this op: the port serves int8 weights weight-only,
as the JAX package does (`serve/quant.py`).
"""

from __future__ import annotations

import threading

import torch

#: Launches of the CUDA kernel (never of the plain version), for callers
#: that must show a run went through it. Reset by assigning 0.
qmm_launches = 0
_count_lock = threading.Lock()

_OUT_BF16 = {torch.float32: 0, torch.bfloat16: 1}


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
    """Launch csrc/qmm.cu on the current stream (no synchronise)."""
    global qmm_launches
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
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("qmm.cu", "tpk_qmm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qx.data_ptr(), sx.data_ptr(), qw.data_ptr(), sw.data_ptr(),
                 out.data_ptr(), m, k, n, _OUT_BF16[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"qmm kernel launch failed: CUDA error {err}")
    with _count_lock:
        qmm_launches += 1
    return out


def int8_matmul(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor, *,
                block_m: int = 256, block_n: int = 256,
                out_dtype=torch.float32) -> torch.Tensor:
    """x [M, K] float; qw [K, N] int8; sw [N] fp32 per-column scales.
    Returns x @ (qw * sw) [M, N] in `out_dtype`, computed as an int8 x int8
    -> int32 product of the per-row quantized activations.

    `block_m`/`block_n` keep the JAX signature and are tile hints only: the
    CUDA kernel's 128x128 tiles are fixed by its design, and it masks the
    ragged edges itself, so nothing is padded."""
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
