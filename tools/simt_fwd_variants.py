"""Where the tensor-core forward of flash_simt.cu spends its time.

    python3 tools/simt_fwd_variants.py [--out FILE]

Writes patched copies of `ops/csrc/flash_simt.cu` into
`build/torch_kernels/variants/`, each dispatching only the bf16 tensor-core
forward (so each builds in seconds) and each with at most one change:
`unpatched`; `loads_only` (every warp skips every tile: the walk, its
cp.async copies and barriers alone); `math_only` (no tile after the first
is copied: the same math on stale tiles); `tile32` (32-row kv tiles). Builds
them with this tree's nvcc flags, the quoted includes found in
`ops/csrc/`, and times each with CUDA events at Gemma 7B's attention widths
(B1 S2048 H16 KH16 D256 causal) and at B1 S2048 H16 KH8 D128, at 128 and 64
query rows a CTA, beside SDPA on its default, FlashAttention-2 and cuDNN
backends. Prints one JSON line a shape (and writes them to FILE). Needs
CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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
from tools.attn_fwd_ab import REPS, sdpa_backend_ms, time_ms  # noqa: E402

SHAPES = [(1, 2048, 16, 16, 256), (1, 2048, 16, 8, 128)]  # B, S, H, KH, D
ROWS = (128, 64)
_MMA_ONLY = ('''  if (kernel == 1)
    return dtype == 1 ? launch_mma_t<__nv_bfloat16>(p, rows, st) : launch_mma_t<__half>(p, rows, st);
  if (dtype == 0) return launch_t<float>(pass, p, rows, st);
  if (dtype == 1) return launch_t<__nv_bfloat16>(pass, p, rows, st);
  return launch_t<__half>(pass, p, rows, st);''', '''  if (kernel == 1 && dtype == 1) return launch_mma_t<__nv_bfloat16>(p, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);''')
PATCHES = {
    "unpatched": [],
    "loads_only": [("    if (t0 > whi || t0 + kN - 1 < wlo) continue;", "    continue;")],
    "math_only": [("    if (it + 1 < ntiles) issue(t0 + kN, st ^ 1);\n    cp_async_commit();\n"
                   "    if (t0 > whi", "    cp_async_commit();\n    if (t0 > whi")],
    "tile32": [("constexpr int kMmaTile = 64;", "constexpr int kMmaTile = 32;")],
}


def build() -> dict:
    """{variant: tpk_flash_simt_fwd of its library}, built in parallel."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "flash_simt.cu").read_text()
    procs = {}
    for name, patches in PATCHES.items():
        src = text
        for old, new in [_MMA_ONLY, *patches]:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        cu = out_dir / f"flash_simt_{name}.cu"
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
        fn = ctypes.CDLL(str(so)).tpk_flash_simt_fwd
        fn.argtypes = _build.SIGNATURES["flash_simt.cu"]["tpk_flash_simt_fwd"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("simt_fwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for b, s, h, kh, d in SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, s, kh, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        out = torch.empty_like(q)
        lse = torch.empty(b, s, h, device="cuda")
        ms = {}
        for rows in ROWS:
            for name, fn in fns.items():
                def call(fn=fn, rows=rows):
                    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                             out.data_ptr(), lse.data_ptr(), b, s, s, h, kh, d,
                             0, 0, 0, 1.0 / math.sqrt(d), 1, rows, stream)
                    if err != 0:
                        raise RuntimeError(f"{name} at {rows} rows: CUDA "
                                           f"error {err}")
                ms[f"{name}@{rows}"] = time_ms(call, REPS)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"shape": f"B{b} S{s} H{h} KH{kh} D{d} causal bfloat16",
               "ms": ms,
               "sdpa_ms": time_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True), REPS),
               "sdpa_flash2_ms": sdpa_backend_ms(q, k, v, "FLASH_ATTENTION"),
               "sdpa_cudnn_ms": sdpa_backend_ms(q, k, v, "CUDNN_ATTENTION")}
        rows_out.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows_out},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
