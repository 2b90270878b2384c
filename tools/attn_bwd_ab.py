"""Time the attention backward kernels of two trees on one card, in turns.

    python3 tools/attn_bwd_ab.py --parent build/parent [--out FILE]

`--parent` is an unpacked copy of another commit of this repository (for
example `git archive <commit> kubeflow_tpu_torch | tar -x -C build/parent`).
Its `ops/csrc/flash_bwd.cu` and `ops/csrc/rdma_ring.cu` (each with the
headers of its own tree) are built with this tree's nvcc flags into
`build/torch_kernels/ab/` and loaded beside this tree's, through the same C
entry points (`tpk_flash_bwd_dq`, `tpk_flash_bwd_dkv`, `tpk_rdma_bwd_dq`,
`tpk_rdma_bwd_dkv`). Both are launched on the same bf16 inputs (q, k, v,
dO, the forward kernel's lse and the PyTorch delta) with preallocated
outputs, timed with CUDA events in the order old, new, new, old at each
shape, and their gradients checked against each other (rel-L2 at most
1e-2, the bound both are held to against the plain version). Flash shapes:
the causal serving prefill shapes of chip_smoke.py's phase 2 (B1 H32 KH8
D128 at S 128, 512, 1000, 2048) and the llama_1b training shape (B12 S1024
H16 KH8 D128). Beside each: each kernel's bound (the larger of the visible
pairs' flops over the bf16 peak and the bytes over the memory rate, as
chip_smoke.py's phase 2b counts them), one SDPA backward (dq, dk and dv in
one autograd call) and delta's time. Then the ring backward at phase 2d's
full-width shape (n 4, B1 S32768 H32 KH8 D128, all ranks on this card):
dq and dk/dv summed over the n rank launches and per rank, the host's time
inside the n entry-point calls (`enqueue_us`: each call encodes the rank's
TMA maps), the bounds as phase 2d counts them, SDPA's backward and the
flash kernels over the whole sequence.

    python3 tools/attn_bwd_ab.py --parent build/parent --simt [--out FILE]

times the CUDA-core pair instead: the other tree's `ops/csrc/flash_simt.cu`
beside this tree's (`tpk_flash_simt_bwd_dq`, `tpk_flash_simt_bwd_dkv`, each
tree called with its own `_build.SIGNATURES`; this tree's at its
`_simt_bwd_plan`), at chip_smoke.py's phase 2e shapes (phase 6's two
configs at B2 S96, llama_1b's widths in fp32 at B2 S1024, Gemma 7B's
attention widths in bf16 at B1 S2048; all causal), dq and dk/dv each in
the order old, new, new, old. The two trees' gradients must agree within
SIMT_TOL of tests/test_torch_gpu_kernels.py (rel-L2). Beside each: the
bounds as phase 2e counts them, the plain backward's time, one SDPA
backward, and the plan.
Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.ops import quant_matmul as qmm  # noqa: E402
from kubeflow_tpu_torch.ops import rdma_ring_attention as rra  # noqa: E402
from tools.attn_fwd_ab import (PEAK_BF16_FLOPS, PEAK_FP32_FLOPS,  # noqa: E402
                               SIMT_SHAPES, bound_ms, enqueue_us, gpu_tests,
                               in_turns, parent_declared, parent_function,
                               time_ms)

SHAPES = [(1, s, 32, 8, 128) for s in (128, 512, 1000, 2048)] + [
    (12, 1024, 16, 8, 128)]  # (B, S, H, KH, D), causal, T = S
RING_SHAPE = (4, 1, 32768, 32, 8, 128)  # n, B, S, H, KH, D
REPS, RING_REPS, HOST_REPS = 20, 3, 5
AGREE_REL_L2 = 1e-2


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def bwd_calls(fns, q, k, v, do, lse, delta, outs, what):
    """(dq call, dk/dv call) of one tree's entry points into `outs`."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None)
    stream = torch.cuda.current_stream().cuda_stream
    common = (b, s, t, h, kh, d, 0, 0, 0, 1.0 / math.sqrt(d), stream)
    dq, dk, dv = outs

    def check(err, kernel):
        if err != 0:
            raise RuntimeError(f"{what} {kernel} launch failed: CUDA error "
                               f"{err}")

    def call_dq():
        check(fns[0](*ins, dq.data_ptr(), *common), "dq")

    def call_dkv():
        check(fns[1](*ins, dk.data_ptr(), dv.data_ptr(), *common), "dk/dv")
    return call_dq, call_dkv


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """One torch.autograd.grad through causal SDPA with GQA, its forward
    outside the timing."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    go = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), go,
                                               retain_graph=True), REPS)


def ring_bwd_calls(fns, shards, outs, what, rank=None):
    """(dq call, dk/dv call) of one tree's ring entry points into `outs`,
    each launching every rank (or only `rank`)."""
    qs, ks, vs, dos, lses, deltas = shards
    n = len(qs)
    b, s, h, d = qs[0].shape
    kh = ks[0].shape[2]
    kp, vp, qp, dop, lp, dp = (rra._ring_ptrs(x) for x in (ks, vs, qs, dos,
                                                            lses, deltas))
    stream = torch.cuda.current_stream().cuda_stream
    ranks = range(n) if rank is None else [rank]
    dq, dk, dv = outs

    def check(err, kernel, me):
        if err != 0:
            raise RuntimeError(f"{what} ring {kernel} launch for rank {me} "
                               f"failed: CUDA error {err}")

    def call_dq():
        for me in ranks:
            check(fns[0](qs[me].data_ptr(), ctypes.addressof(kp),
                         ctypes.addressof(vp), dos[me].data_ptr(),
                         lses[me].data_ptr(), deltas[me].data_ptr(),
                         dq[me].data_ptr(), n, me, b, s, h, kh, d,
                         1.0 / math.sqrt(d), stream), "dq", me)

    def call_dkv():
        for me in ranks:
            check(fns[1](ctypes.addressof(qp), ctypes.addressof(dop),
                         ctypes.addressof(lp), ctypes.addressof(dp),
                         ks[me].data_ptr(), vs[me].data_ptr(),
                         dk[me].data_ptr(), dv[me].data_ptr(), n, me, b, s,
                         h, kh, d, 1.0 / math.sqrt(d), stream), "dk/dv", me)
    return call_dq, call_dkv


def _sdpa_global_bwd_ms(q, k, v, do, reps) -> float:
    """SDPA's causal backward over the whole sequence, K/V expanded to q's
    heads outside the timing, on the fused backends only (the math
    backend's [S, S] scores would not fit), as chip_smoke.py's phase 2d."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        go = do.transpose(1, 2)
        return time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), go, retain_graph=True), reps)


def ring_row(parent, gen) -> dict:
    """The ring backward of both trees at RING_SHAPE, in turns."""
    symbols = ("tpk_rdma_bwd_dq", "tpk_rdma_bwd_dkv")
    old_fns = [parent_function(parent, "rdma_ring.cu", s) for s in symbols]
    new_fns = [_build.function("rdma_ring.cu", s) for s in symbols]
    n, b, s_glob, h, kh, d = RING_SHAPE
    q, do = (torch.randn(b, s_glob, h, d, generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, s_glob, kh, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out, lse = rra._rdma_fwd_cuda(q, k, v, n)
    delta = fa._bwd_delta(do, out, None)
    shards = [rra._shards(x, n) for x in (q, k, v, do, lse, delta)]
    outs = {w: tuple([torch.empty_like(x) for x in shards[i]]
                     for i in (0, 1, 2)) for w in ("old", "new")}
    calls = {w: ring_bwd_calls(fns, shards, outs[w], w)
             for w, fns in (("old", old_fns), ("new", new_fns))}
    for w in ("old", "new"):
        for call in calls[w]:
            call()
    torch.cuda.synchronize()
    agree = {name: _rel_l2(torch.cat(outs["new"][i], dim=1),
                           torch.cat(outs["old"][i], dim=1))
             for i, name in enumerate(("dq", "dk", "dv"))}
    row = {"kernel": "rdma_bwd", "shape": f"n{n} B{b} S{s_glob} H{h} "
           f"KH{kh} D{d} causal", "rel_l2_new_vs_old": agree}
    for i, key in enumerate(("dq", "dkv")):
        old, new = calls["old"][i], calls["new"][i]
        row[f"{key}_old_ms"], row[f"{key}_new_ms"] = in_turns(old, new,
                                                              RING_REPS)
        (row[f"{key}_old_enqueue_us"],
         row[f"{key}_new_enqueue_us"]) = in_turns(old, new, HOST_REPS,
                                                  enqueue_us)
        by_rank = [in_turns(
            ring_bwd_calls(old_fns, shards, outs["old"], "old", me)[i],
            ring_bwd_calls(new_fns, shards, outs["new"], "new", me)[i],
            RING_REPS) for me in range(n)]
        row[f"{key}_old_ms_by_rank"] = [o for o, _ in by_rank]
        row[f"{key}_new_ms_by_rank"] = [c for _, c in by_rank]
    pairs = b * s_glob * (s_glob + 1) // 2 * h
    io = 2 * (q.numel() + k.numel() + v.numel()) + 2 * do.numel()
    stats = 2 * 4 * lse.numel()
    row["dq_bound_ms"], row["dq_bound_by"] = bound_ms(
        6 * d * pairs, io + stats + 2 * q.numel())
    row["dkv_bound_ms"], row["dkv_bound_by"] = bound_ms(
        8 * d * pairs, io + stats + 2 * (k.numel() + v.numel()))
    row["sdpa_bwd_ms"] = _sdpa_global_bwd_ms(q, k, v, do, RING_REPS)
    causal = fa.MaskSpec("causal")
    fout, flse = fa._flash_fwd_cuda(q, k, v, causal)
    fdelta = fa._bwd_delta(do, fout, None)
    row["flash_global_dq_ms"] = time_ms(lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, flse, fdelta, causal), RING_REPS)
    row["flash_global_dkv_ms"] = time_ms(lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, do, flse, fdelta, causal), RING_REPS)
    return row


def simt_functions(tree: Path | None):
    """(dq, dk/dv) entry points of flash_simt.cu: this tree's, or the
    other tree's built beside it and declared with its own argtypes."""
    symbols = ("tpk_flash_simt_bwd_dq", "tpk_flash_simt_bwd_dkv")
    if tree is None:
        return [_build.function("flash_simt.cu", s) for s in symbols]
    return [parent_declared(tree, "flash_simt.cu", s) for s in symbols]


def simt_calls(fns, q, k, v, do, lse, delta, outs, plan, what):
    """(dq call, dk/dv call) of one tree's CUDA-core entry points into
    `outs`. An entry point that takes no grid arguments (the earlier
    design's) gets none; one that does gets `plan`'s, with its workspace
    and tickets."""

    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    code = fa.SIMT_DTYPES[q.dtype]
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None)
    stream = torch.cuda.current_stream().cuda_stream
    common = (b, s, t, h, kh, d, 0, 0, 0, 1.0 / math.sqrt(d))
    dq, dk, dv = outs
    gridded = len(fns[0].argtypes) > 1 + 8 + len(common) + 1
    ws = tickets = None
    if gridded and plan.splits > 1:
        ws = torch.empty(plan.dkv_ctas * 2 * plan.dkv_rows
                         * fa._simt_bucket(d), device=q.device)
        tickets = qmm._tickets_for(q.device, stream, plan.dkv_blocks)

    def check(err, kernel):
        if err != 0:
            raise RuntimeError(f"{what} {kernel} launch failed: CUDA error "
                               f"{err}")

    def call_dq():
        extra = (plan.dq_rows,) if gridded else ()
        check(fns[0](code, *ins, dq.data_ptr(), *common, *extra, stream),
              "dq")

    def call_dkv():
        if gridded:
            check(fns[1](code, *ins, dk.data_ptr(), dv.data_ptr(),
                         None if ws is None else ws.data_ptr(),
                         None if tickets is None else tickets.data_ptr(),
                         *common, plan.dkv_rows, plan.splits, stream),
                  "dk/dv")
        else:
            check(fns[1](code, *ins, dk.data_ptr(), dv.data_ptr(), *common,
                         stream), "dk/dv")
    return call_dq, call_dkv


def simt_rows(parent: Path) -> tuple[list, list]:
    """The CUDA-core pair of both trees at SIMT_SHAPES, in turns: (rows,
    shapes where the trees disagree)."""
    tol = gpu_tests().SIMT_TOL
    old_fns, new_fns = simt_functions(parent), simt_functions(None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = fa.MaskSpec("causal")
    rows, bad = [], []
    for b, s, h, kh, d, dtype in SIMT_SHAPES:
        q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, kh, d, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        out, lse = fa._flash_simt_fwd_cuda(q, k, v, mask)
        delta = fa._bwd_delta(do, out, None)
        plan = fa._simt_plan_for(q, k)
        outs = {w: (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v)) for w in ("old", "new")}
        old_dq, old_dkv = simt_calls(old_fns, q, k, v, do, lse, delta,
                                     outs["old"], plan, "old")
        new_dq, new_dkv = simt_calls(new_fns, q, k, v, do, lse, delta,
                                     outs["new"], plan, "new")
        for call in (old_dq, old_dkv, new_dq, new_dkv):
            call()
        torch.cuda.synchronize()
        agree = {n: _rel_l2(a, c) for n, a, c in
                 zip(("dq", "dk", "dv"), outs["new"], outs["old"])}
        dq_old, dq_new = in_turns(old_dq, new_dq, REPS)
        dkv_old, dkv_new = in_turns(old_dkv, new_dkv, REPS)
        pairs = b * h * s * (s + 1) // 2
        size = q.element_size()
        # phase 2e's peaks: the CUDA cores' for fp32, the tensor cores' else
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        reads = (size * (2 * q.numel() + 2 * k.numel())
                 + 8 * lse.numel())
        dq_bound = bound_ms(6 * d * pairs, reads + size * q.numel(), peak)
        dkv_bound = bound_ms(8 * d * pairs, reads + 2 * size * k.numel(),
                             peak)
        row = {"shape": f"B{b} S{s} H{h} KH{kh} D{d} causal "
                        f"{str(dtype)[6:]}",
               "plan": dataclasses.asdict(plan),
               "dq_old_ms": dq_old, "dq_new_ms": dq_new,
               "dkv_old_ms": dkv_old, "dkv_new_ms": dkv_new,
               "dq_bound_ms": dq_bound[0], "dq_bound_by": dq_bound[1],
               "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
               "plain_bwd_ms": time_ms(lambda: fa._flash_bwd_plain(
                   q, k, v, out, lse, do, None, mask), 3),
               "sdpa_bwd_ms": _sdpa_bwd_ms(q, k, v, do),
               "rel_l2_new_vs_old": agree}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if max(agree.values()) > tol[dtype][2]:
            bad.append(row["shape"])
    return rows, bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--simt", action="store_true",
                    help="time the CUDA-core pair (flash_simt.cu) instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.simt:
        rows, bad = simt_rows(args.parent)
        return _finish(args.out, card, rows, bad)
    symbols = ("tpk_flash_bwd_dq", "tpk_flash_bwd_dkv")
    old_fns = [parent_function(args.parent, "flash_bwd.cu", s) for s in symbols]
    new_fns = [_build.function("flash_bwd.cu", s) for s in symbols]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    mask = fa.MaskSpec("causal")
    for b, s, h, kh, d in SHAPES:
        q, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, s, kh, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        out, lse = fa._flash_fwd_cuda(q, k, v, mask)
        delta = fa._bwd_delta(do, out, None)
        outs = {w: (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v)) for w in ("old", "new")}
        old_dq, old_dkv = bwd_calls(old_fns, q, k, v, do, lse, delta,
                                    outs["old"], "old")
        new_dq, new_dkv = bwd_calls(new_fns, q, k, v, do, lse, delta,
                                    outs["new"], "new")
        for call in (old_dq, old_dkv, new_dq, new_dkv):
            call()
        torch.cuda.synchronize()
        agree = {n: _rel_l2(a, c) for n, a, c in
                 zip(("dq", "dk", "dv"), outs["new"], outs["old"])}
        dq_old, dq_new = in_turns(old_dq, new_dq, REPS)
        dkv_old, dkv_new = in_turns(old_dkv, new_dkv, REPS)
        pairs = b * h * s * (s + 1) // 2
        reads = 2 * (2 * q.numel() + 2 * k.numel()) + 8 * b * s * h
        dq_bound, dq_by = bound_ms(6 * d * pairs, reads + 2 * q.numel())
        dkv_bound, dkv_by = bound_ms(8 * d * pairs, reads + 4 * k.numel())
        row = {"shape": f"B{b} S{s} H{h} KH{kh} D{d} causal",
               "dq_old_ms": dq_old, "dq_new_ms": dq_new,
               "dkv_old_ms": dkv_old, "dkv_new_ms": dkv_new,
               "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
               "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by,
               "sdpa_bwd_ms": _sdpa_bwd_ms(q, k, v, do),
               "delta_ms": time_ms(lambda: fa._bwd_delta(do, out, None),
                                   REPS),
               "rel_l2_new_vs_old": agree}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if max(agree.values()) > AGREE_REL_L2:
            bad.append(row["shape"])
    row = ring_row(args.parent, gen)
    rows.append(row)
    print(json.dumps(row), flush=True)
    if max(row["rel_l2_new_vs_old"].values()) > AGREE_REL_L2:
        bad.append(row["shape"])
    return _finish(args.out, card, rows, bad)


def _finish(out: Path | None, card: str, rows: list, bad: list) -> int:
    if out:
        os.makedirs(out.parent, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    if bad:
        print(f"old and new disagree at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
