"""Time the W8A8 int8 matmul kernels of two trees on one card, in turns.

    python3 tools/qmm_ab.py --parent build/parent [--out FILE]

`--parent` is an unpacked copy of another commit of this repository (for
example `git archive <commit> kubeflow_tpu_torch | tar -x -C build/parent`).
Its `ops/csrc/qmm.cu` (with the headers of its own tree) is built with this
tree's nvcc flags into `build/torch_kernels/ab/` and loaded beside this
tree's, each through its own tree's `tpk_qmm` signature (read from the
parent's `ops/_build.py`). Both are launched on the same int8 codes and
fp32 scales with preallocated outputs, timed with CUDA events in the order
old, new, new, old at each shape, and their fp32 outputs must be equal
(both are held bit for bit against the plain version elsewhere).

Shapes: chip_smoke.py's phase 2c (llama3_8b's projections at 2048 and 32
rows), then M 1, 8, 64, 128 and 512 over K 4096, N 14336, then its down
(K 14336, N 4096) and k/v (K 4096, N 1024) projections at 32 rows. Each shape is
timed twice: `warm`, back-to-back launches on one weight (at K 4096, N
4096 the 16.8 MB weight then stays in the 50 MB L2), and `cold`, launches
rotating over copies of the weight that together exceed 100 MB, as a
decode step that reads every layer's weights finds them. Beside each: the
bound (2*M*K*N operations over the int8 peak, or the bytes each input
read once and the fp32 output written once over the memory rate,
whichever is larger), this tree's plan, and two `torch._int_mm` yardsticks
(cuBLASLt's int8 GEMM, int32 out, no rescale; it takes M > 16): on the
N-major weight as the op holds it, and on a K-major copy (`qw.t()
.contiguous()`, made outside the timing), the TN layout cuBLASLt wants.
Then this tree's kernel at forced split counts at decode widths, the
measurement behind `_qmm_plan`'s split rule.
Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import quant_matmul as qmm  # noqa: E402
from tools.attn_fwd_ab import in_turns, parent_library, time_ms  # noqa: E402

PEAK_INT8_OPS = 1979e12  # H100 SXM, dense (NVIDIA data sheet, at 700 W)
PEAK_BYTES = 3.35e12
SHAPES = [(2048, 4096, 14336), (2048, 14336, 4096), (32, 4096, 14336),
          (32, 4096, 4096)] + [(m, 4096, 14336) for m in (1, 8, 64, 128, 512)
                               ] + [(32, 14336, 4096), (32, 4096, 1024)]
SPLIT_SHAPES = [(32, 4096, 4096), (8, 4096, 4096), (32, 14336, 4096),
                (32, 4096, 14336), (32, 4096, 2048), (32, 4096, 1024),
                (8, 4096, 1024), (32, 16384, 512)]
SPLITS = (1, 2, 4, 8, 16)
REPS = 20
COLD_BYTES = 100_000_000  # twice the L2


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    nbytes = m * k + 4 * m + k * n + 4 * n + 4 * m * n
    ops, mem = 2 * m * k * n / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def parent_qmm(parent: Path):
    """The parent tree's tpk_qmm, declared with the parent's own argtypes."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "kubeflow_tpu_torch" / "ops" / "_build.py")
    pbuild = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pbuild)  # stdlib only: nothing is built here
    fn = parent_library(parent, "qmm.cu").tpk_qmm
    fn.argtypes = pbuild.SIGNATURES["qmm.cu"]["tpk_qmm"]
    fn.restype = ctypes.c_int
    return fn


class Call:
    """One tree's launch of tpk_qmm into `out` on a rotation of weights
    (the first only when warm)."""

    def __init__(self, fn, qx, sx, qws, sw, out, what, plan=None):
        self.fn, self.qx, self.sx, self.qws, self.sw = fn, qx, sx, qws, sw
        self.out, self.what, self.plan, self.i = out, what, plan, 0
        self.ws = self.tickets = None
        m, n = out.shape
        if plan is not None and plan.splits > 1:
            self.ws = torch.empty((plan.splits, m, n), dtype=torch.int32,
                                  device="cuda")
            self.tickets = torch.zeros(plan.tiles, dtype=torch.int32,
                                       device="cuda")

    def __call__(self, rotate: bool = False):
        qw = self.qws[self.i % len(self.qws)] if rotate else self.qws[0]
        self.i += 1
        m, k = self.qx.shape
        n = qw.shape[1]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (self.qx.data_ptr(), self.sx.data_ptr(), qw.data_ptr(),
                self.sw.data_ptr(), self.out.data_ptr())
        if self.plan is None:  # the signature before split-K: no plan
            err = self.fn(*ptrs, m, k, n, 0, stream)
        else:
            err = self.fn(*ptrs,
                          None if self.ws is None else self.ws.data_ptr(),
                          None if self.tickets is None
                          else self.tickets.data_ptr(),
                          m, k, n, 0, self.plan.bm, self.plan.splits, stream)
        if err != 0:
            raise RuntimeError(f"{self.what} tpk_qmm failed: CUDA error {err}")


def _inputs(m, k, n, gen):
    copies = max(1, -(-COLD_BYTES // (k * n)))
    qws = [torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                         dtype=torch.int8) for _ in range(copies)]
    x = torch.randn(m, k, generator=gen, device="cuda")
    qx, sx = qmm.quantize_activations(x)
    sw = torch.rand(n, generator=gen, device="cuda") * 9e-3 + 1e-3
    return qx, sx, qws, sw


def _int_mm_ms(qx, qw) -> tuple:
    """torch._int_mm on the N-major weight and on a K-major copy."""
    if qx.shape[0] <= 16:
        return None, None
    qwt = qw.t().contiguous()
    return (time_ms(lambda: torch._int_mm(qx, qw), REPS),
            time_ms(lambda: torch._int_mm(qx, qwt.t()), REPS))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qmm_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    old_fn = parent_qmm(args.parent)
    old_plan_arg = len(old_fn.argtypes) != 10
    new_fn = _build.function("qmm.cu", "tpk_qmm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    for m, k, n in SHAPES:
        qx, sx, qws, sw = _inputs(m, k, n, gen)
        plan = qmm._qmm_plan(m, k, n, sms)
        outs = [torch.empty(m, n, device="cuda") for _ in range(2)]
        old = Call(old_fn, qx, sx, qws, sw, outs[0], "old",
                   plan if old_plan_arg else None)
        new = Call(new_fn, qx, sx, qws, sw, outs[1], "new", plan)
        old()
        new()
        torch.cuda.synchronize()
        equal = torch.equal(outs[0], outs[1])
        warm_old, warm_new = in_turns(old, new, REPS)
        cold_old, cold_new = in_turns(lambda: old(True), lambda: new(True),
                                      REPS)
        bound, by = bound_ms(m, k, n)
        nmajor, kmajor = _int_mm_ms(qx, qws[0])
        row = {"shape": f"M{m} K{k} N{n}", "kernel": plan.kernel,
               "bm": plan.bm, "splits": plan.splits,
               "old_ms": warm_old, "new_ms": warm_new,
               "old_cold_ms": cold_old, "new_cold_ms": cold_new,
               "bound_ms": bound, "bound_by": by,
               "int_mm_ms": nmajor, "int_mm_kmajor_ms": kmajor,
               "weight_copies_cold": len(qws), "equal": equal}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not equal:
            bad.append(row["shape"])
        del qws, old, new, outs
        torch.cuda.empty_cache()
    for m, k, n in SPLIT_SHAPES:
        qx, sx, qws, sw = _inputs(m, k, n, gen)
        base = qmm._qmm_plan(m, k, n, sms)
        row = {"shape": f"M{m} K{k} N{n}", "plan_splits": base.splits,
               "splits": list(SPLITS), "warm_ms": [], "cold_ms": []}
        ref = None
        for s in SPLITS:
            plan = qmm.QmmPlan(base.kernel, base.bm, s, base.m_tiles,
                               base.n_tiles)
            out = torch.empty(m, n, device="cuda")
            call = Call(new_fn, qx, sx, qws, sw, out, f"new splits {s}", plan)
            call()
            torch.cuda.synchronize()
            ref = out.clone() if ref is None else ref
            if not torch.equal(out, ref):
                bad.append(f"{row['shape']} splits {s}")
            row["warm_ms"].append(time_ms(call, REPS))
            row["cold_ms"].append(time_ms(lambda: call(True), REPS))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qws
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    if bad:
        print(f"outputs differ at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
