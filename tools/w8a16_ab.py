"""Time the W8A16 kernels of two trees on one card, in turns.

    python3 tools/w8a16_ab.py --parent build/parent [--out FILE]
    python3 tools/w8a16_ab.py --parent build/parent --decode [--out FILE]

`--parent` is an unpacked copy of another commit of this repository (for
example `git archive <commit> kubeflow_tpu_torch | tar -x -C build/parent`).
Its `ops/csrc/w8a16.cu` (with the headers of its own tree) is built with
this tree's nvcc flags into `build/torch_kernels/ab/` and loaded beside this
tree's, each called through its own tree's `tpk_w8a16` signature (read
from the parent's `ops/_build.py`) with its own tree's plan (the parent's
`_w8a16_plan`, loaded from its tree). Both run on the same bf16
activations, int8 codes and fp32 scales into preallocated outputs, timed
with CUDA events in the order old, new, new, old at each shape, and each
output must sit within 4e-3 rel-L2 of the plain version
(`_int8_weight_matmul_plain`) and repeat bit for bit.

Without `--decode`: the tile kernels, at chip_smoke.py's phase 2f prefill
projections of llama3_8b (q/o, k/v, gate/up, down) at M 17, 128, 512 and
2048. Each is timed `warm` (one weight, back to back) and `cold`
(launches rotating over copies of the weight that together exceed 120 MB,
as a forward through every layer finds them). Beside each: the bound
(2*M*K*N operations over the bf16 peak, or the bytes each input read once
and the output written once over the memory rate, whichever is larger),
the plain version's time and torch.mm's on a bf16 copy of the weight made
outside the timing (fp32 out, the scale, the cast; a yardstick the op never
calls). Then this tree's kernel at forced split counts at M 128 (128-row
tiles), and at forced tile rows (64, 128 or 256 activation rows by 128
weight rows, each with the splits the plan's rule gives it) at M 128, 512,
1024 and 2048: the measurements behind the plan's split and tile rules.

With `--decode`: the decode kernels (M <= 16), at M 1, 4 and 16
on llama3_8b's five weight shapes (q/o, k/v, gate/up, down, the 128256 x
4096 unembedding with its epilogue) and at N 130 and 16383 (K 4096), warm
and cold, with each tree's host time to enqueue one call of its entry
point, the bound and torch.mm's time (cold); then the 225 launches of one
int8 decode step (64 q/o, 64 k/v, 64 gate/up, 32 down, 1 unembedding)
summed per tree, cold. Each decode call is timed after a PyTorch kernel,
as a model's step runs it (back to back, a programmatic dependent launch
would overlap each call with the one before): alone between two CUDA
events (`launch_ms`), and as its share of a run of (add, call) pairs
(`after_add_ms`, cold), where a programmatic dependent launch may start it
as the add ends.
tools/w8a16_decode_variants.py times this tree's kernel at forced ring
stages, cluster sizes and row blocks.
Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import w8a16 as w8  # noqa: E402
from tools.attn_fwd_ab import (enqueue_us, in_turns, parent_library,  # noqa: E402
                                time_ms)

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet, at 700 W)
PEAK_BYTES = 3.35e12
#: llama3_8b's projections as (K, N): q/o, k/v, gate/up, down.
PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SHAPES = [(m, k, n) for m in (17, 128, 512, 2048) for k, n in PROJ]
#: The decode comparison: the projections, the unembedding, then N 130 and
#: 16383; and the launches of each 8B shape in one int8 decode step.
DECODE_KN = PROJ + [(4096, 128256), (4096, 130), (4096, 16383)]
DECODE_M = (1, 4, 16)
STEP = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64,
        (14336, 4096): 32, (4096, 128256): 1}
SPLITS = (1, 2, 4, 8, 16)
TILE_ROWS = (64, 128, 256)
REPS = 20
COLD_BYTES = 120e6
TOL = 4e-3  # rel-L2 against the plain version (tests/test_torch_gpu_kernels.py)


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    nbytes = 2 * m * k + k * n + 4 * n + 2 * m * n
    ops, mem = 2 * m * k * n / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, "operations" if ops >= mem else "bytes"


def launch_ms(fn, reps: int) -> float:
    """Device time of one call as a model's step finds it: each call
    follows a PyTorch kernel (a one-element add, which like a norm or an
    activation does not let the next kernel start early), and a pair of
    CUDA events spans the call alone. Mean over `reps`, after one warm-up
    call, behind a sleep kernel (host enqueue time not counted)."""
    fn()
    torch.cuda.synchronize()
    tiny = torch.zeros(1, device="cuda")
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for e0, e1 in zip(starts, ends):
        tiny.add_(1)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in zip(starts, ends)) / reps


def after_add_ms(fn, reps: int) -> float:
    """reps x (a one-element add, the call) back to back, less reps x (the
    add alone): a call's share of the device time when it follows a
    PyTorch kernel with nothing between them, as in a model's step (a
    programmatic dependent launch may start the call as the add ends)."""
    tiny = torch.zeros(1, device="cuda")

    def timed(with_call: bool) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        e0.record()
        for _ in range(reps):
            tiny.add_(1)
            if with_call:
                fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps
    return timed(True) - timed(False)


def _parent_module(parent: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"parent_{name}", parent / "kubeflow_tpu_torch" / "ops" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def parent_w8a16(parent: Path):
    """The parent tree's tpk_w8a16, declared with the parent's own argtypes."""
    pbuild = _parent_module(parent, "_build")  # stdlib only: nothing is built
    fn = parent_library(parent, "w8a16.cu").tpk_w8a16
    fn.argtypes = pbuild.SIGNATURES["w8a16.cu"]["tpk_w8a16"]
    fn.restype = ctypes.c_int
    return fn


def _launch_args(fn, plan) -> tuple:
    """The plan's arguments from `kernel` to before the stream, for either
    tree's entry point: the earlier one takes (kernel, bm, splits), this
    tree's `_launch_tail` (the decode kernel's grid and layout besides)."""
    if len(fn.argtypes) == 15:
        return ({"simt": 0, "gemv": 1, "wgmma": 2}[plan.kernel], plan.bm,
                plan.splits)
    return w8._launch_tail(plan)


class Call:
    """One tree's launch of tpk_w8a16 (`fn`, declared with its own tree's
    signature) by `plan` (that tree's `_w8a16_plan`, or a forced variant)
    into `out`, on a rotation of weights (the first only when warm). The
    scratch a plan needs is made here, outside the timing: the wgmma
    kernel's split partials and tickets, and the earlier decode kernel's."""

    def __init__(self, fn, x, qs, scale, out, what, plan, rf=False):
        self.fn, self.x, self.qs, self.scale = fn, x, qs, scale
        self.out, self.what, self.plan, self.i = out, what, plan, 0
        self.rf = int(rf)
        self.ws = self.tickets = None
        m, n = x.shape[0], qs[0].shape[0]
        if plan.splits > 1 and plan.kernel == "wgmma":
            self.ws = torch.empty(plan.units * plan.bm * w8._BN,
                                  dtype=torch.float32, device="cuda")
            self.tickets = torch.zeros(plan.tiles, dtype=torch.int32,
                                       device="cuda")
        elif plan.splits > 1 and len(fn.argtypes) == 15:  # ticket reduction
            self.ws = torch.empty(plan.splits * m * n, dtype=torch.float32,
                                  device="cuda")
            self.tickets = torch.zeros(plan.grid[0], dtype=torch.int32,
                                       device="cuda")
        self.tail = _launch_args(fn, plan)

    def __call__(self, rotate: bool = False):
        q = self.qs[self.i % len(self.qs)] if rotate else self.qs[0]
        self.i += 1
        m, k = self.x.shape
        n = q.shape[0]
        err = self.fn(self.x.data_ptr(), q.data_ptr(), self.scale.data_ptr(),
                      self.out.data_ptr(),
                      None if self.ws is None else self.ws.data_ptr(),
                      None if self.tickets is None
                      else self.tickets.data_ptr(),
                      m, k, n, 1, self.rf, *self.tail,  # bf16
                      torch.cuda.current_stream().cuda_stream)
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


def _library_ms(x, qs, scale, rf, cold, timer=time_ms) -> float:
    """torch.mm on bf16 copies of the weight (made outside the timing),
    rotating past the L2 when cold, with the op's epilogue."""
    wides = [qs[0].bfloat16()]
    if cold:
        wides += [wides[0].clone() for _ in range(max(0, math.ceil(
            COLD_BYTES / (2 * wides[0].numel())) - 1))]
    turn = iter(range(1 << 30))

    def call():
        w = wides[next(turn) % len(wides)]
        if rf:
            return (torch.mm(x, w.t()).float() * scale).bfloat16()
        return (torch.mm(x, w.t(), out_dtype=torch.float32)
                * scale).bfloat16()
    ms = timer(call, REPS)
    del wides
    return ms


def _plan_dict(plan) -> dict:
    return {f.name: getattr(plan, f.name)
            for f in dataclasses.fields(plan)}


def prefill(old_fn, new_fn, pw8, sms, gen, rows, bad) -> None:
    """The tile kernels at the prefill shapes, then this tree's forced
    splits and tile rows."""
    for m, k, n in SHAPES:
        x, qs, scale = _inputs(m, k, n, gen)
        pplan = pw8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
        plan = w8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
        want = w8._int8_weight_matmul_plain(x, qs[0], scale)
        shape = f"M{m} K{k} N{n}"
        old = Call(old_fn, x, qs, scale, torch.empty_like(want), "old",
                   pplan)
        new = Call(new_fn, x, qs, scale, torch.empty_like(want), "new", plan)
        rel_old = _check(old, want, bad, f"{shape} old")
        rel_new = _check(new, want, bad, f"{shape} new")
        warm_old, warm_new = in_turns(old, new, REPS)
        cold_old, cold_new = in_turns(lambda: old(True), lambda: new(True),
                                      REPS)
        plain = time_ms(lambda: w8._int8_weight_matmul_plain(x, qs[0],
                                                             scale), 3)
        bound, by = bound_ms(m, k, n)
        row = {"shape": shape, "bm": plan.bm,
               "splits": plan.splits, "tiles": plan.tiles,
               "old_ms": warm_old, "new_ms": warm_new,
               "old_cold_ms": cold_old, "new_cold_ms": cold_new,
               "bound_ms": bound, "bound_by": by, "plain_ms": plain,
               "library_ms": _library_ms(x, qs, scale, False, False),
               "rel_l2_old": rel_old,
               "rel_l2_new": rel_new, "weight_copies_cold": len(qs)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qs, old, new
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


def decode(old_fn, new_fn, pw8, sms, gen, rows, bad) -> None:
    """The decode kernels in turns at the decode shapes, each call timed
    after a PyTorch kernel, then the 225-launch step."""
    for k, n in DECODE_KN:
        x0, qs, scale = _inputs(16, k, n, gen)
        rf = n == 128256
        for m in DECODE_M:
            x = x0[:m].contiguous()
            pplan = pw8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
            plan = w8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
            want = w8._int8_weight_matmul_plain(x, qs[0], scale, rf)
            shape = f"M{m} K{k} N{n}"
            old = Call(old_fn, x, qs, scale, torch.empty_like(want), "old",
                       pplan, rf)
            new = Call(new_fn, x, qs, scale, torch.empty_like(want), "new",
                       plan, rf)
            rel_old = _check(old, want, bad, f"{shape} old")
            rel_new = _check(new, want, bad, f"{shape} new")
            warm_old, warm_new = in_turns(old, new, REPS, timer=launch_ms)
            cold_old, cold_new = in_turns(lambda: old(True),
                                          lambda: new(True), REPS,
                                          timer=launch_ms)
            add_old, add_new = in_turns(lambda: old(True),
                                        lambda: new(True), REPS,
                                        timer=after_add_ms)
            enq_old, enq_new = in_turns(old, new, 50, timer=enqueue_us)
            bound, by = bound_ms(m, k, n)
            row = {"shape": shape, "m": m, "k": k, "n": n, "unembed": rf,
                   "old_plan": _plan_dict(pplan), "plan": _plan_dict(plan),
                   "old_ms": warm_old, "new_ms": warm_new,
                   "old_cold_ms": cold_old, "new_cold_ms": cold_new,
                   "old_after_add_ms": add_old, "new_after_add_ms": add_new,
                   "old_enqueue_us": enq_old, "new_enqueue_us": enq_new,
                   "bound_ms": bound, "bound_by": by,
                   "library_cold_ms": _library_ms(x, qs, scale, rf, True,
                                                  launch_ms),
                   "rel_l2_old": rel_old, "rel_l2_new": rel_new,
                   "weight_copies_cold": len(qs)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del old, new
        del qs
        torch.cuda.empty_cache()
    mean = statistics.fmean
    for m in DECODE_M:
        mine = {(r["k"], r["n"]): r for r in rows
                if r.get("m") == m and (r["k"], r["n"]) in STEP}
        step = {"step_m": m, "launches": sum(STEP.values())}
        for key in ("old_cold_ms", "new_cold_ms", "old_after_add_ms",
                    "new_after_add_ms", "bound_ms", "library_cold_ms"):
            step[key] = sum(STEP[kn] * (mean(mine[kn][key])
                                        if isinstance(mine[kn][key], list)
                                        else mine[kn][key]) for kn in STEP)
        rows.append(step)
        print(json.dumps(step), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--decode", action="store_true",
                    help="the decode kernels (M <= 16) instead of the tile "
                    "kernels")
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
    pw8 = _parent_module(args.parent, "w8a16")
    sms = w8._sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    (decode if args.decode else prefill)(old_fn, new_fn, pw8, sms, gen, rows,
                                         bad)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                             "clocks.max.sm,power.draw,temperature.gpu",
                             "--format=csv,noheader"], capture_output=True,
                            text=True, check=True).stdout.strip()
    print(f"after the timings: {clocks} (SM clock, its maximum, power, "
          f"temperature)", flush=True)
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "clocks_after": clocks,
                                        "rows": rows}, indent=1))
    if bad:
        print(f"failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
