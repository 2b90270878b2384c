"""Where the W8A16 decode kernel of w8a16.cu spends its time, and the
measurements behind its plan's constants.

    python3 tools/w8a16_decode_variants.py [--out FILE]

Writes patched copies of `ops/csrc/w8a16.cu` into
`build/torch_kernels/variants/`, each with a set of the changes below, and
builds them in parallel with this tree's nvcc flags (the quoted includes
found in `ops/csrc/`):

- `unpatched`;
- `no_pdl`: launched without programmatic dependent launch (PDL);
- `no_trigger`: no griddepcontrol.launch_dependents (a next kernel
  launched with PDL is scheduled only as this one ends);
- `no_math`: the consumers wait for each stage and free it without reading
  it (the copies, the barriers and the partials alone);
- `no_x`: the producer copies no activations (the weight stream alone;
  the result is garbage); `no_x+no_math`: the weight's TMA boxes and the
  ring alone;
- `stages_2`, `stages_3`, `stages_8`: the ring's depth (kDecStages, and
  the plan's `_GEMV_STAGES` with it);
- `rows_32`, `rows_64`: the deal's unit of weight rows (kDecRows, and the
  plan's `_GEMV_ROWS` with it).

Times each (`launch_ms` of tools/w8a16_ab.py: each call after a PyTorch
kernel, an event pair around the call alone), with the weight rotating
past the L2, on the plan of llama3_8b's five decode shapes at M 1, 4 and
16, where the plan's shared memory fits; then the unpatched kernel at every
cluster size (K splits 1, 2, 4, 8: `_gemv_launch` at that split); then,
for `unpatched` and `no_pdl`, `after_add_ms` (tools/w8a16_ab.py): what PDL
gives a call that follows a PyTorch kernel. Prints one JSON line a shape
(and writes them to FILE). Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
from tools.w8a16_ab import after_add_ms, launch_ms  # noqa: E402

SHAPES = [(m, k, n) for m in (1, 4, 16)
          for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                       (14336, 4096), (4096, 128256))]  # M, K, N
REPS = 20
COLD_BYTES = 120e6
NO_MATH = [("      if (kk < len) {", "      if (kk < 0) {")]
NO_X = [("      } else if (lane <= p.M) {", "      } else if (lane <= 0) {"),
        ("(R / 16) * boxes * 16 * kDecBoxK + p.M * 2 * len);",
         "(R / 16) * boxes * 16 * kDecBoxK);")]
NO_PDL = [("  cfg.numAttrs = 2;\n  return static_cast<int>(cudaLaunchKernelEx(&cfg, w8a16_decode",
           "  cfg.numAttrs = 1;\n  return static_cast<int>(cudaLaunchKernelEx(&cfg, w8a16_decode")]
NO_TRIGGER = [('    asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");', "")]


def _constant(name: str, value: int) -> list:
    """The patch that sets the source's `constexpr int name` to `value`."""
    head = f"constexpr int {name} = "
    return [(head, f"{head}{value};  //")]


#: name: (source patches, the plan's module constants to match them).
VARIANTS = {
    "unpatched": ([], {}),
    "no_pdl": (NO_PDL, {}),
    "no_trigger": (NO_TRIGGER, {}),
    "no_math": (NO_MATH, {}),
    "no_x": (NO_X, {}),
    "no_x+no_math": (NO_X + NO_MATH, {}),
    **{f"stages_{v}": (_constant("kDecStages", v), {"_GEMV_STAGES": v})
       for v in (2, 3, 8)},
    **{f"rows_{v}": (_constant("kDecRows", v), {"_GEMV_ROWS": v})
       for v in (32, 64)},
}
SPLITS = (1, 2, 4, 8)


def build(variants: dict) -> dict:
    """{variant: tpk_w8a16 of its library}, built in parallel."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "w8a16.cu").read_text()
    procs = {}
    for name, (patches, _) in variants.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        cu = out_dir / f"w8a16_{name.replace('+', '_')}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).tpk_w8a16
        fn.argtypes = _build.SIGNATURES["w8a16.cu"]["tpk_w8a16"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@contextlib.contextmanager
def _constants(values: dict):
    """The plan module's constants set to `values` (a patched kernel's)."""
    saved = {k: getattr(w8, k) for k in values}
    for k, v in values.items():
        setattr(w8, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(w8, k, v)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w8a16_decode_variants: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sms = w8._sm_count(0)
    fns = build(VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for m, k, n in SHAPES:
        qs = [torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                            dtype=torch.int8)
              for _ in range(max(1, math.ceil(COLD_BYTES / (k * n))))]
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        scale = torch.rand(n, generator=gen, device="cuda") * 9e-3 + 1e-3
        out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        rf = int(n == 128256)

        def caller(fn, plan, what):
            turn = iter(range(1 << 30))

            def call():
                q = qs[next(turn) % len(qs)]
                err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), None, None, m, k, n, 1, rf,
                         *w8._launch_tail(plan), stream)
                if err != 0:
                    raise RuntimeError(f"{what}: CUDA error {err}")
            return call

        plan = w8._gemv_plan(m, k, n, sms)
        ms, skipped, pdl = {}, {}, {}
        for name, fn in fns.items():
            with _constants(VARIANTS[name][1]):
                vplan = w8._gemv_plan(m, k, n, sms)
            if vplan.layout[-1] > w8._GEMV_SMEM_MAX:
                skipped[name] = "shared memory does not fit"
                continue
            call = caller(fn, vplan, name)
            ms[name] = launch_ms(call, REPS)
            if name in ("unpatched", "no_pdl"):
                pdl[name] = after_add_ms(call, REPS)
        by_splits = {}
        for splits in SPLITS:
            splan = w8._gemv_launch(m, n, splits, sms)
            if (splan.layout[-1] > w8._GEMV_SMEM_MAX
                    or splits > -(-k // 64)):
                continue
            by_splits[splits] = launch_ms(
                caller(fns["unpatched"], splan, f"splits {splits}"), REPS)
        row = {"shape": f"M{m} K{k} N{n}", "splits": plan.splits,
               "layout": plan.layout,
               "bound_ms": (k * n + 2 * m * k + 2 * m * n + 4 * n)
               / 3.35e12 * 1e3, "ms": ms, "skipped": skipped,
               "ms_by_splits": by_splits, "after_add_ms": pdl}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del qs
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
