"""Time the W8A16 tile kernels of two trees on one card, in turns.

    python3 tools/w8a16_ab.py --parent build/parent [--out FILE]

`--parent` is an unpacked copy of another commit of this repository (for
example `git archive <commit> kubeflow_tpu_torch | tar -x -C build/parent`).
Its `ops/csrc/w8a16.cu` (with the headers of its own tree) is built with
this tree's nvcc flags into `build/torch_kernels/ab/` and loaded beside this
tree's, each called through its own tree's `tpk_w8a16` signature (read from
the parent's `ops/_build.py`): the parent's with the kernel its own plan
gave every shape past 16 rows (id 2, one split), this tree's with
`_w8a16_plan`'s kernel, tile rows and splits. Both run on the same bf16
activations, int8 codes and fp32 scales into preallocated outputs, timed
with CUDA events in the order old, new, new, old at each shape, and each
output must sit within 4e-3 rel-L2 of the plain version
(`_int8_weight_matmul_plain`) and repeat bit for bit.

Shapes: chip_smoke.py's phase 2f prefill projections of llama3_8b (q/o, k/v,
gate/up, down) at M 17, 128, 512 and 2048. Each is timed `warm` (one
weight, back to back) and `cold` (launches rotating over copies of the
weight that together exceed 120 MB, as a forward through every layer
finds them). Beside each: the bound (2*M*K*N operations over the bf16
peak, or the bytes each input read once and the output written once over
the memory rate, whichever is larger), the plain version's time and
torch.mm's on a bf16 copy of the weight made outside the timing (fp32 out,
the scale, the cast; a yardstick the op never calls). Then this tree's
kernel at forced split counts at M 128 (128-row tiles), and at forced
tile rows (64, 128 or 256 activation rows by 128 weight rows, each with
the splits the plan's rule gives it) at M 128, 512, 1024 and 2048: the
measurements behind the plan's split and tile rules.
Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import w8a16 as w8  # noqa: E402
from tools.attn_fwd_ab import in_turns, parent_library, time_ms  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet, at 700 W)
PEAK_BYTES = 3.35e12
#: llama3_8b's projections as (K, N): q/o, k/v, gate/up, down.
PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SHAPES = [(m, k, n) for m in (17, 128, 512, 2048) for k, n in PROJ]
SPLITS = (1, 2, 4, 8, 16)
TILE_ROWS = (64, 128, 256)
REPS = 20
COLD_BYTES = 120e6
TOL = 4e-3  # rel-L2 against the plain version (tests/test_torch_gpu_kernels.py)


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    nbytes = 2 * m * k + k * n + 4 * n + 2 * m * n
    ops, mem = 2 * m * k * n / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def parent_w8a16(parent: Path):
    """The parent tree's tpk_w8a16, declared with the parent's own argtypes."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "kubeflow_tpu_torch" / "ops" / "_build.py")
    pbuild = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pbuild)  # stdlib only: nothing is built here
    fn = parent_library(parent, "w8a16.cu").tpk_w8a16
    fn.argtypes = pbuild.SIGNATURES["w8a16.cu"]["tpk_w8a16"]
    fn.restype = ctypes.c_int
    return fn


class Call:
    """One tree's launch of tpk_w8a16 into `out` on a rotation of weights
    (the first only when warm). `plan` None: the parent's signature (no
    tile arguments) and its tile kernel."""

    def __init__(self, fn, x, qs, scale, out, what, plan=None):
        self.fn, self.x, self.qs, self.scale = fn, x, qs, scale
        self.out, self.what, self.plan, self.i = out, what, plan, 0
        self.ws = self.tickets = None
        if plan is not None and plan.splits > 1:
            self.ws = torch.empty(plan.units * plan.bm * w8._BN,
                                  dtype=torch.float32, device="cuda")
            self.tickets = torch.zeros(plan.tiles, dtype=torch.int32,
                                       device="cuda")

    def __call__(self, rotate: bool = False):
        q = self.qs[self.i % len(self.qs)] if rotate else self.qs[0]
        self.i += 1
        m, k = self.x.shape
        n = q.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        head = (self.x.data_ptr(), q.data_ptr(), self.scale.data_ptr(),
                self.out.data_ptr(),
                None if self.ws is None else self.ws.data_ptr(),
                None if self.tickets is None else self.tickets.data_ptr(),
                m, k, n, 1, 0)  # bf16, the dense epilogue
        if self.plan is None:
            err = self.fn(*head, 2, 1, stream)
        else:
            err = self.fn(*head, 2, self.plan.bm, self.plan.splits, stream)
        if err != 0:
            raise RuntimeError(f"{self.what} tpk_w8a16 failed: CUDA error "
                               f"{err}")


def _inputs(m, k, n, gen):
    copies = max(1, math.ceil(COLD_BYTES / (k * n)))
    qs = [torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                        dtype=torch.int8) for _ in range(copies)]
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    scale = torch.rand(n, generator=gen, device="cuda") * 9e-3 + 1e-3
    return x, qs, scale


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def _check(call, want, bad, what) -> float:
    """Two launches: the same bits, and within TOL of the plain version."""
    call()
    first = call.out.clone()
    call()
    torch.cuda.synchronize()
    rel = _rel_l2(call.out, want)
    if not torch.equal(first, call.out) or rel > TOL:
        bad.append(f"{what}: rel_l2 {rel:.3e}, repeat "
                   f"{'equal' if torch.equal(first, call.out) else 'DIFFERS'}")
    return rel


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w8a16_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    old_fn = parent_w8a16(args.parent)
    new_fn = _build.function("w8a16.cu", "tpk_w8a16")
    sms = w8._sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    for m, k, n in SHAPES:
        x, qs, scale = _inputs(m, k, n, gen)
        plan = w8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
        want = w8._int8_weight_matmul_plain(x, qs[0], scale)
        shape = f"M{m} K{k} N{n}"
        old = Call(old_fn, x, qs, scale, torch.empty_like(want), "old")
        new = Call(new_fn, x, qs, scale, torch.empty_like(want), "new", plan)
        rel_old = _check(old, want, bad, f"{shape} old")
        rel_new = _check(new, want, bad, f"{shape} new")
        warm_old, warm_new = in_turns(old, new, REPS)
        cold_old, cold_new = in_turns(lambda: old(True), lambda: new(True),
                                      REPS)
        wide = qs[0].bfloat16()
        library = time_ms(lambda: (torch.mm(x, wide.t(),
                                            out_dtype=torch.float32)
                                   * scale).bfloat16(), REPS)
        plain = time_ms(lambda: w8._int8_weight_matmul_plain(x, qs[0],
                                                             scale), 3)
        bound, by = bound_ms(m, k, n)
        row = {"shape": shape, "bm": plan.bm,
               "splits": plan.splits, "tiles": plan.tiles,
               "old_ms": warm_old, "new_ms": warm_new,
               "old_cold_ms": cold_old, "new_cold_ms": cold_new,
               "bound_ms": bound, "bound_by": by, "plain_ms": plain,
               "library_ms": library, "rel_l2_old": rel_old,
               "rel_l2_new": rel_new, "weight_copies_cold": len(qs)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qs, old, new, wide
        torch.cuda.empty_cache()
    sweeps = [(128, k, n, "splits", s) for k, n in PROJ for s in SPLITS]
    sweeps += [(m, k, n, "bm", bm) for m in (128, 512, 1024, 2048)
               for k, n in PROJ for bm in TILE_ROWS]
    for m, k, n, kind, val in sweeps:
        x, qs, scale = _inputs(m, k, n, gen)
        base = w8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
        if kind == "splits":
            bm, splits = 128, val
            tiles = -(-m // bm) * -(-n // w8._BN)
        else:
            bm = val
            tiles, splits = w8._tiling(m, n, -(-k // 64), bm, sms)
        plan = w8.W8a16Plan(w8.WGMMA, splits, (min(tiles * splits, sms),),
                            bm, tiles)
        want = w8._int8_weight_matmul_plain(x, qs[0], scale)
        call = Call(new_fn, x, qs, scale, torch.empty_like(want),
                    f"{kind} {val}", plan)
        shape = f"M{m} K{k} N{n}"
        rel = _check(call, want, bad, f"{shape} {kind} {val}")
        row = {"shape": shape, "sweep": kind, "bm": bm, "splits": splits,
               "plan": [base.bm, base.splits],
               "warm_ms": time_ms(call, REPS),
               "cold_ms": time_ms(lambda: call(True), REPS), "rel_l2": rel}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qs, call
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    if bad:
        print(f"failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
