"""Build and load the port's CUDA kernels (nvcc into a plain C library).

Each source under `csrc/` compiles on first use into its own shared library
under `build/torch_kernels/` at the repository root, named by a hash of the
source, the headers beside it and the flags, so a changed source or header
rebuilds and an unchanged one is reused. The libraries expose plain C entry
points and are loaded with `ctypes`; no PyTorch headers are compiled, which
keeps a build to seconds.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: `-split-compile=0` optimizes a source's kernels in parallel on every
#: core: flash_simt.cu's many instantiations otherwise hold the whole build
#: on one core (166 s against 66 s on an 8-core H100 host).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every entry point, by source file: {symbol: argtypes}.
#: Every pointer and the stream are c_void_p — an undeclared pointer would
#: be passed as a 32-bit int and cut.
_MASK_ARGS = [_I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]  # B..scale, stream
_RING_ARGS = [_I] * 7 + [_F, _P]  # n, me, B, s, H, KH, D, scale, stream
SIGNATURES = {
    "flash_fwd.cu": {
        "tpk_flash_fwd": [_P, _P, _P, _P, _P, _P, *_MASK_ARGS],
    },
    "flash_bwd.cu": {
        # q, k, v, do, lse, delta, seg, dq
        "tpk_flash_bwd_dq": [_P] * 8 + _MASK_ARGS,
        # q, k, v, do, lse, delta, seg, dk, dv
        "tpk_flash_bwd_dkv": [_P] * 9 + _MASK_ARGS,
    },
    "flash_simt.cu": {
        # dtype (0 fp32, 1 bf16, 2 fp16), then as the wgmma entry points;
        # the forward's kernel (0 CUDA cores, 1 tensor cores) and rows, the
        # backward's rows a CTA owns, before the stream
        "tpk_flash_simt_fwd": [_I] + [_P] * 6 + _MASK_ARGS[:-1] + [_I, _I, _P],
        "tpk_flash_simt_bwd_dq": [_I] + [_P] * 8 + _MASK_ARGS[:-1] + [_I, _P],
        # ... dk, dv, ws, tickets, B..scale, rows, splits, stream
        "tpk_flash_simt_bwd_dkv": [_I] + [_P] * 11 + _MASK_ARGS[:-1]
        + [_I, _I, _P],
    },
    "qmm.cu": {
        # qx, sx, qw, sw, out, ws, tickets, M, K, N, out_bf16, bm, splits,
        # stream
        "tpk_qmm": [_P] * 7 + [_I] * 6 + [_P],
    },
    "w8a16.cu": {
        # x, q, scale, out, ws, tickets, M, K, N, dtype (0 fp32, 1 bf16,
        # 2 fp16), round_first, kernel (0 simt, 1 gemv, 2 wgmma), bm,
        # splits, then the decode kernel's grid and shared-memory layout
        # (slot_rows, slot_bytes, part, red, bars, smem), stream
        "tpk_w8a16": [_P] * 6 + [_I] * 15 + [_P],
    },
    "rdma_ring.cu": {
        # A *_ring argument is the address of a host array of n pointers.
        # q, k_ring, v_ring, o, lse, then _RING_ARGS
        "tpk_rdma_fwd": [_P] * 5 + _RING_ARGS,
        # q, k_ring, v_ring, dout, lse, delta, dq
        "tpk_rdma_bwd_dq": [_P] * 7 + _RING_ARGS,
        # q_ring, do_ring, lse_ring, delta_ring, k, v, dk, dv
        "tpk_rdma_bwd_dkv": [_P] * 8 + _RING_ARGS,
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library, by
#: source: of this process's build, or read from beside a cached library.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build_all(sources=None) -> float:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together. Returns the wall seconds spent. Raises with
    the compiler's output when a build fails."""
    sources = list(sources or SIGNATURES)
    t0 = time.monotonic()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in sources:
            out = _target(src)
            if out.exists():
                report = out.with_suffix(".log")
                if report.exists():
                    build_logs[src] = report.read_text()
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[src] = log
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed, with every
    entry point's argtypes and restype declared."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    build_all([source])
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(_target(source)))
            for symbol, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return _libs[source]


def function(source: str, symbol: str):
    """One declared entry point of a source's library."""
    if symbol not in SIGNATURES[source]:
        raise KeyError(f"{source} declares no entry point {symbol!r}")
    return getattr(library(source), symbol)
