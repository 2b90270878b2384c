"""Time the attention forward kernels of two trees on one card, in turns.

    python3 tools/attn_fwd_ab.py --parent build/parent [--out FILE]

`--parent` is an unpacked copy of another commit of this repository (for
example `git archive <commit> | tar -x -C build/parent`). Its
`ops/csrc/flash_fwd.cu` and `ops/csrc/rdma_ring.cu` are built with this
tree's nvcc flags into `build/torch_kernels/ab/` and loaded beside this
tree's, through the same C entry points (`tpk_flash_fwd`, `tpk_rdma_fwd`).
Both are launched on the same bf16 inputs with preallocated outputs, timed
with CUDA events in the order old, new, new, old at each shape, and
checked against each other. Shapes: the causal serving prefill shapes of
chip_smoke.py's phase 2 (B1 H32 KH8 D128 at S 128, 512, 1000, 2048), the
llama_1b training shape (B12 S1024 H16 KH8 D128) and the ring forward at
n 4, B1 S32768 H32 KH8 D128 (one launch per rank, all ranks on this card).
Beside each: the bound (the larger of the visible pairs' flops over the
bf16 peak and the bytes over the memory rate) and one SDPA call's time.
The flash shapes are also timed host-inclusive, in the same turns: one call
from the host's first instruction to the device's last, on an idle queue
(`host_ms`), and the host's time inside the entry point alone
(`enqueue_us`); the ring row gives the enqueue time of its n rank calls.

    python3 tools/attn_fwd_ab.py --parent build/parent --simt [--out FILE]

times the forward of `ops/csrc/flash_simt.cu` instead: the other tree's
`tpk_flash_simt_fwd` (called with its own `_build.SIGNATURES`: an entry
point without the kernel and rows arguments gets none) beside this tree's
at its `_simt_fwd_plan`, at chip_smoke.py's phase 2e shapes (phase 6's two
configs at B2 S96, llama_1b's widths in fp32 at B2 S1024, Gemma 7B's
attention widths in bf16 at B1 S2048; all causal), in the order old, new,
new, old. The two trees' out and lse must agree within SIMT_TOL of
tests/test_torch_gpu_kernels.py (max abs). Beside each: the bound as phase
2e counts it (fp32 at the CUDA cores' peak, bf16 at the tensor cores'),
the plain version's time, one SDPA call as phase 2e makes it, SDPA forced
onto its FlashAttention-2 and cuDNN backends (K/V expanded to q's heads;
null where a backend refuses the input), the plan, and this tree's other
forward kernel at the same shape (`other_kernel`: the CUDA-core kernel
forced on the bf16 inputs, or the tensor-core kernel on bf16 copies of the
fp32 inputs).
Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import hashlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.ops import rdma_ring_attention as rra  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet, at 700 W)
PEAK_FP32_FLOPS = 67e12   # ... on the CUDA cores
PEAK_BYTES = 3.35e12
FLASH_SHAPES = [(1, s, 32, 8, 128) for s in (128, 512, 1000, 2048)] + [
    (12, 1024, 16, 8, 128)]  # (B, S, H, KH, D), causal, T = S
RING_SHAPE = (4, 1, 32768, 32, 8, 128)  # n, B, S, H, KH, D
REPS, RING_REPS, HOST_REPS = 20, 3, 50
# (B, S, H, KH, D, dtype), causal, T = S: phase 2e's shapes.
SIMT_SHAPES = [(2, 96, 4, 2, 16, torch.bfloat16),
               (2, 96, 16, 8, 128, torch.float32),
               (2, 1024, 16, 8, 128, torch.float32),
               (1, 2048, 16, 16, 256, torch.bfloat16)]


def time_ms(fn, reps: int) -> float:
    """CUDA events around `reps` back-to-back calls behind a sleep kernel
    (host enqueue time not counted), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(fn, reps: int) -> float:
    """Median wall time of one call and its completion, each started on an
    idle queue: the entry point's host work, the launch and the kernel."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def enqueue_us(fn, reps: int) -> float:
    """Median host time spent inside one call (the device's work not
    waited for), each call on an idle queue."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    ops, mem = flops / peak, nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


@functools.lru_cache(maxsize=None)
def parent_library(parent: Path, source: str) -> ctypes.CDLL:
    """The parent tree's library of one source, built once with this
    tree's flags."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(str(parent.resolve()).encode()).hexdigest()[:8]
    out = out_dir / f"parent_{Path(source).stem}_{tag}.so"
    src = parent / "kubeflow_tpu_torch" / "ops" / "csrc" / source
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def parent_function(parent: Path, source: str, symbol: str):
    """The parent tree's entry point, built with this tree's flags."""
    fn = getattr(parent_library(parent, source), symbol)
    fn.argtypes = _build.SIGNATURES[source][symbol]
    fn.restype = ctypes.c_int
    return fn


def parent_declared(parent: Path, source: str, symbol: str):
    """The parent tree's entry point, declared with the parent's own
    `_build.SIGNATURES` (its argument list may differ from this tree's)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "kubeflow_tpu_torch" / "ops" / "_build.py")
    pbuild = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pbuild)
    fn = getattr(parent_library(parent, source), symbol)
    fn.argtypes = pbuild.SIGNATURES[source][symbol]
    fn.restype = ctypes.c_int
    return fn


def gpu_tests():
    """tests/test_torch_gpu_kernels.py as a module (its SIMT_TOL)."""
    path = ROOT / "tests" / "test_torch_gpu_kernels.py"
    spec = importlib.util.spec_from_file_location("gpu_kernel_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def flash_call(fn, q, k, v, out, lse, what):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                  out.data_ptr(), lse.data_ptr(), b, s, t, h, kh, d, 0, 0, 0,
                  1.0 / math.sqrt(d), stream), what)
    return call


def ring_call(fn, qs, ks, vs, outs, lses, what, rank=None):
    n = len(qs)
    b, s, h, d = qs[0].shape
    kh = ks[0].shape[2]
    kp, vp = rra._ring_ptrs(ks), rra._ring_ptrs(vs)
    stream = torch.cuda.current_stream().cuda_stream
    ranks = range(n) if rank is None else [rank]

    def call():
        for me in ranks:
            _check(fn(qs[me].data_ptr(), ctypes.addressof(kp),
                      ctypes.addressof(vp), outs[me].data_ptr(),
                      lses[me].data_ptr(), n, me, b, s, h, kh, d,
                      1.0 / math.sqrt(d), stream), what)
    return call


def in_turns(old, new, reps, timer=time_ms):
    """old, new, new, old: (old times, new times)."""
    a1 = timer(old, reps)
    b1 = timer(new, reps)
    b2 = timer(new, reps)
    a2 = timer(old, reps)
    return [a1, a2], [b1, b2]


def _sdpa_ms(q, k, v, reps):
    """One SDPA call, causal, K/V expanded to q's heads outside the timing,
    on the fused backends only."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2)
              for x in (k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]), torch.no_grad():
        return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps)


def simt_fwd_call(fn, q, k, v, out, lse, plan, what):
    """One tree's tpk_flash_simt_fwd into `out` and `lse`: with `plan`'s
    kernel and rows where the entry point takes them."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    common = (b, s, t, h, kh, d, 0, 0, 0, 1.0 / math.sqrt(d))
    extra = ((fa.SIMT_FWD_KERNELS[plan.kernel], plan.rows)
             if len(fn.argtypes) > 1 + 6 + len(common) + 1 else ())

    def call():
        _check(fn(fa.SIMT_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), None, out.data_ptr(), lse.data_ptr(),
                  *common, *extra, stream), what)
    return call


def sdpa_backend_ms(q, k, v, backend: str) -> float | None:
    """One causal SDPA call on one backend ("FLASH_ATTENTION",
    "CUDNN_ATTENTION", ...), K/V expanded to q's heads outside the timing;
    None where the backend refuses the input."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2)
              for x in (k, v))
    try:
        with sdpa_kernel([getattr(SDPBackend, backend)]), torch.no_grad():
            return time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), REPS)
    except RuntimeError:
        return None


def other_kernel_row(q, k, v, kernel: str) -> dict:
    """This tree's forward kernel that the plan does not pick for q, k, v,
    timed at their shape: the CUDA-core one (forced) on bf16/fp16 inputs,
    the tensor-core one on bf16 copies of fp32 inputs."""
    b, s, h, d = q.shape
    other = "simt" if kernel == "mma" else "mma"
    if other == "mma":
        q, k, v = (x.bfloat16() for x in (q, k, v))
    plan = fa._simt_fwd_plan(b, s, k.shape[1], h, k.shape[2], d, q.dtype,
                             fa._sm_count(q.device.index), kernel=other)
    mask = fa.MaskSpec("causal")
    return {"kernel": other, "dtype": str(q.dtype)[6:], "rows": plan.rows,
            "ms": time_ms(lambda: fa._flash_simt_fwd_cuda(q, k, v, mask,
                                                          plan=plan), REPS)}


def simt_rows(parent: Path) -> tuple[list, list]:
    """The flash_simt forward of both trees at SIMT_SHAPES, in turns:
    (rows, shapes where the trees disagree)."""
    tol = gpu_tests().SIMT_TOL
    old_fn = parent_declared(parent, "flash_simt.cu", "tpk_flash_simt_fwd")
    new_fn = _build.function("flash_simt.cu", "tpk_flash_simt_fwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = fa.MaskSpec("causal")
    rows, bad = [], []
    for b, s, h, kh, d, dtype in SIMT_SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, s, kh, d, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        plan = fa._simt_fwd_plan_for(q, k)
        outs = [torch.empty_like(q) for _ in range(2)]
        lses = [torch.empty(b, s, h, device="cuda") for _ in range(2)]
        old = simt_fwd_call(old_fn, q, k, v, outs[0], lses[0], plan, "old")
        new = simt_fwd_call(new_fn, q, k, v, outs[1], lses[1], plan, "new")
        old()
        new()
        torch.cuda.synchronize()
        diff = (outs[0].float() - outs[1].float()).abs().max().item()
        diff_lse = (lses[0] - lses[1]).abs().max().item()
        t_old, t_new = in_turns(old, new, REPS)
        pairs = b * h * s * (s + 1) // 2
        size = q.element_size()
        # phase 2e's peaks: the CUDA cores' for fp32, the tensor cores' else
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        nbytes = size * (2 * q.numel() + 2 * k.numel()) + 4 * lses[1].numel()
        bound, by = bound_ms(4 * d * pairs, nbytes, peak)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"shape": f"B{b} S{s} H{h} KH{kh} D{d} causal "
                        f"{str(dtype)[6:]}",
               "plan": dataclasses.asdict(plan),
               "old_ms": t_old, "new_ms": t_new,
               "bound_ms": bound, "bound_by": by,
               "plain_ms": time_ms(lambda: fa._flash_fwd_plain(
                   q, k, v, mask), 5),
               "sdpa_ms": time_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True), REPS),
               "sdpa_flash2_ms": sdpa_backend_ms(q, k, v, "FLASH_ATTENTION"),
               "sdpa_cudnn_ms": sdpa_backend_ms(q, k, v, "CUDNN_ATTENTION"),
               "max_abs_diff_old_new": diff,
               "max_abs_diff_lse_old_new": diff_lse,
               "other_kernel": other_kernel_row(q, k, v, plan.kernel)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if diff > tol[dtype][0] or diff_lse > tol[dtype][1]:
            bad.append(row["shape"])
    return rows, bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--simt", action="store_true",
                    help="time the forward of flash_simt.cu instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_fwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.simt:
        rows, bad = simt_rows(args.parent)
        _write(args.out, card, rows)
        if bad:
            print(f"old and new disagree at {bad}", file=sys.stderr)
            return 1
        return 0
    old_flash = parent_function(args.parent, "flash_fwd.cu", "tpk_flash_fwd")
    old_ring = parent_function(args.parent, "rdma_ring.cu", "tpk_rdma_fwd")
    new_flash = _build.function("flash_fwd.cu", "tpk_flash_fwd")
    new_ring = _build.function("rdma_ring.cu", "tpk_rdma_fwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    for b, s, h, kh, d in FLASH_SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, s, kh, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        outs = [torch.empty_like(q) for _ in range(2)]
        lses = [torch.empty(b, s, h, device="cuda") for _ in range(2)]
        old = flash_call(old_flash, q, k, v, outs[0], lses[0], "old flash")
        new = flash_call(new_flash, q, k, v, outs[1], lses[1], "new flash")
        old()
        new()
        torch.cuda.synchronize()
        diff = (outs[0].float() - outs[1].float()).abs().max().item()
        t_old, t_new = in_turns(old, new, REPS)
        h_old, h_new = in_turns(old, new, HOST_REPS, host_ms)
        e_old, e_new = in_turns(old, new, HOST_REPS, enqueue_us)
        pairs = b * h * s * (s + 1) // 2
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * s * h
        bound, by = bound_ms(4 * d * pairs, nbytes)
        row = {"kernel": "flash_fwd", "shape": f"B{b} S{s} H{h} KH{kh} D{d} "
               "causal", "old_ms": t_old, "new_ms": t_new,
               "old_host_ms": h_old, "new_host_ms": h_new,
               "old_enqueue_us": e_old, "new_enqueue_us": e_new,
               "bound_ms": bound,
               "bound_by": by, "sdpa_ms": _sdpa_ms(q, k, v, REPS),
               "max_abs_diff_old_new": diff}
        rows.append(row)
        print(json.dumps(row), flush=True)

    n, b, s_glob, h, kh, d = RING_SHAPE
    q = torch.randn(b, s_glob, h, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, s_glob, kh, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    qs, ks, vs = (rra._shards(x, n) for x in (q, k, v))
    outs = [[torch.empty_like(x) for x in qs] for _ in range(2)]
    lses = [[torch.empty(x.shape[:3], device="cuda") for x in qs]
            for _ in range(2)]
    old = ring_call(old_ring, qs, ks, vs, outs[0], lses[0], "old ring")
    new = ring_call(new_ring, qs, ks, vs, outs[1], lses[1], "new ring")
    old()
    new()
    torch.cuda.synchronize()
    diff = max((a.float() - c.float()).abs().max().item()
               for a, c in zip(outs[0], outs[1]))
    t_old, t_new = in_turns(old, new, RING_REPS)
    e_old, e_new = in_turns(old, new, RING_REPS, enqueue_us)
    by_rank = {"old": [], "new": []}
    for me in range(n):
        o1, n1 = in_turns(
            ring_call(old_ring, qs, ks, vs, outs[0], lses[0], "old", me),
            ring_call(new_ring, qs, ks, vs, outs[1], lses[1], "new", me),
            RING_REPS)
        by_rank["old"].append(o1)
        by_rank["new"].append(n1)
    pairs = b * h * s_glob * (s_glob + 1) // 2
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * s_glob * h
    bound, by = bound_ms(4 * d * pairs, nbytes)
    row = {"kernel": "rdma_fwd", "shape": f"n{n} B{b} S{s_glob} H{h} KH{kh} "
           f"D{d}", "old_ms": t_old, "new_ms": t_new,
           "old_ms_by_rank": by_rank["old"], "new_ms_by_rank": by_rank["new"],
           "old_enqueue_us": e_old, "new_enqueue_us": e_new,
           "bound_ms": bound, "bound_by": by,
           "sdpa_ms": _sdpa_ms(q, k, v, RING_REPS),
           "max_abs_diff_old_new": diff}
    rows.append(row)
    print(json.dumps(row), flush=True)
    _write(args.out, card, rows)
    bad = [r["shape"] for r in rows if r["max_abs_diff_old_new"] > 4e-2]
    if bad:
        print(f"old and new disagree at {bad}", file=sys.stderr)
        return 1
    return 0


def _write(out: Path | None, card: str, rows: list) -> None:
    if out:
        os.makedirs(out.parent, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
