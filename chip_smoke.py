"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is printed as a result then):
  1. device: require CUDA, print the card, build every kernel from source
     (one nvcc per source, all started together); the ptxas reports of the
     wgmma kernels (both attention forwards, the flash and ring dq and dk/dv
     backward, the int8 and W8A16 matmuls) and of the CUDA-core dq and
     dk/dv (every instantiation) must show no spill stores;
  2. kernels: the forward kernel against its plain PyTorch version on the
     card, at the serving shapes, with its time, the plain version's, one
     library call's (a yardstick the port never calls) and its bound;
  2b. backward kernels: dq and dk/dv against the plain backward at the
     phase-2 shapes and the llama_1b training shape, with the same timings
     (and the forward kernel's and SDPA's forward times there);
  2c. the W8A8 int8 matmul through its op entry point `int8_matmul` at the
     llama3_8b projection shapes (prefill and decode widths), launches
     counted (all of the wgmma + TMA kernel), then against its plain version
     (bit for bit at fp32 output, equal at bf16) there and at the JAX
     test's ragged shapes, each shape launching the kernel its plan names
     (the byte-wise one where TMA cannot describe the shape), with the
     kernel's time, the op's with quantization, the plain version's,
     torch._int_mm's on the N-major weight and on a K-major copy, and its
     bound;
  2e. the CUDA-core flash kernels (forward, dq, dk/dv for the inputs the
     wgmma kernels do not take) against the plain versions at the attention
     shapes of phase 6's configs, at llama_1b's widths in fp32 at seq 1024
     and at Gemma 7B's widths (head_dim 256) in bf16 at seq 2048, each
     case's backward plan (rows, streamed tile, dk/dv splits) printed, two
     launches of dq and dk/dv bit-identical at a split shape, with their
     times, the plain versions', SDPA's and their bounds (and, for the fp32
     shapes, the tensor-core forward's, the plain forward's and SDPA's on
     bf16 copies of the same inputs);
  2f. the W8A16 matmul (`int8_weight_matmul`, csrc/w8a16.cu: int8 weight
     codes, activations in the compute dtype, the scale in the epilogue)
     against its plain version at llama3_8b's projection and unembedding
     shapes at decode widths (M 1, 4, 16: the decode kernel, its plan
     printed: row block, cluster, grid, ring; and how many of its clusters
     the card holds at once), the projections at prefill buckets (M 128,
     512, 2048: the wgmma kernel, its tile and splits printed) in bf16 and
     fp16, the unembedding at M 2048, ragged M and N and small
     bf16/fp16/fp32 shapes (the GPU tests' W8A16_CASES): rel-L2 within 4e-3
     (bf16/fp16) or 1e-5 (fp32), two launches bit-identical; at the bf16 8B
     shapes its time (the weight read cold), bound, plain version's and
     torch.mm's on a pre-cast bf16 weight, and at decode widths the host's
     enqueue time; then the 225 launches of one int8 decode step summed
     (at M 1, 4 and 16) against their bound;
  2d. context-parallel ring attention (`rdma_ring_attention`, all ranks on
     this card): the forward, dq and dk/dv kernels (one launch per rank)
     against their plain versions at small shapes (rings of 2, 4 and 8,
     ragged shards, GQA, head dims 64 and 128), a one-rank ring through the
     flash kernels, then llama3_8b's attention widths at 32768 tokens over 4
     ranks through the op and autograd, launches counted, with each
     kernel's time (summed over the ranks, and per rank), its bound, the
     plain version's, SDPA's and the flash kernels' over the whole sequence;
  3. model: full-width, full-depth llama3_8b logits with attention through
     the kernel against the same weights through the plain version;
  4. serving: a llama3_8b bundle behind the port's HTTP server answering
     concurrent :generate requests at the default pipeline_depth 2; the
     kernel launch counts show that every first-chunk prefill ran through
     the kernel, the overlap counters that the loop kept a chunk in flight
     while it fetched another; the longest greedy prompt alone on a second
     server at pipeline_depth 1 gives the depth-2 repeat's ids (both step
     times logged);
  4b. paged serving: the same bundle with a paged KV pool (block size 16);
     the longest greedy prompt alone gives phase 4's ids, at depth 2 and
     on a depth-1 server;
  4c. quantized serving: int8 weights and an int8 paged KV pool, phase 4's
     six requests (prefill still through the flash kernel, every int8
     projection and unembedding through the W8A16 kernel, every prefill
     chunk's projections through its wgmma kernel, int8_matmul never
     called, no int8-weight-shaped copy in a decode chunk), the decode
     step's device busy time beside the earlier decode kernel's, admission
     and prefill seconds beside phase 4's, peak memory at
     least 5 GiB under phase 4's, the longest prompt's ids and step time
     at depth 1 against depth 2; then the int8 model's logits against a
     bf16 model holding the same codes dequantized;
  5. training: llama_1b at full width and depth through the trainer's entry
     point (batch 12, seq 1024, 3 warm-up + 10 timed steps): finite losses,
     the first near ln(V), every step's launches (2 forward per layer under
     remat, one dq, one dk/dv), ms/step, tok/s, MFU, peak memory, the
     data-wait share and a profiler breakdown of one step; then one step
     through the kernels against one through the plain attention (and the
     bf16 naive_attention path) on the same weights and batch, and the loss
     falling over a few steps on one repeated batch;
  5b. a training job: llama_1b at full width and depth on a packed
     document corpus written from the seed (`packed_lm`: segment ids,
     restarting positions, a loss mask) through the trainer's entry point,
     with the eval stream, a two-step profile window and checkpoint saves:
     every step's launches (the flash kernels run document-masked batches),
     finite losses, ms/step, tok/s and MFU beside phase 5's, the data-wait
     share, eval loss and accuracy, a Chrome trace naming the flash
     kernels, each save's seconds and bytes; then, at 4 layers, a worker
     launched as the control plane launches it and killed by TPK_FAULT
     (SIGKILL), whose relaunch resumes from its last checkpoint with the
     losses of a fault-free run bit for bit;
  6. attention_impl="auto" on configs the wgmma kernels do not take
     (llama_tiny: bf16, head_dim 16; llama_1b's widths in fp32, 2 layers):
     a prefill and a training step run through the CUDA-core kernels, with
     no wgmma launch, and agree with attention_impl="naive" (the GPU tests'
     own check, `c1_compare` of tests/test_torch_gpu_kernels.py).
Then one JSON line of kernel numbers, the card's name and power limit, and
the final {"ok": true, "device": ...} line.

Weights are random, made from a seed. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kubeflow_tpu_torch.models import llama as llama_mod  # noqa: E402
from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.ops import quant_matmul as qmm  # noqa: E402
from kubeflow_tpu_torch.ops import rdma_ring_attention as rra  # noqa: E402
from kubeflow_tpu_torch.ops import w8a16 as w8  # noqa: E402
from kubeflow_tpu_torch.ops.reference import naive_attention  # noqa: E402
from kubeflow_tpu_torch.parallel import Mesh  # noqa: E402
from kubeflow_tpu_torch.serve import quant as squant  # noqa: E402
from kubeflow_tpu_torch.serve.runtimes import export_for_serving  # noqa: E402
from kubeflow_tpu_torch.serve.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as ckpt_mod  # noqa: E402
from kubeflow_tpu_torch.train import optim  # noqa: E402
from kubeflow_tpu_torch.train import step as train_step  # noqa: E402
from kubeflow_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from kubeflow_tpu_torch.utils import registry  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet, at 700 W); fp32 is the
# CUDA cores' rate, where the CUDA-core kernels compute.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# Kernel vs plain bounds. out: the kernel rounds P to bf16 for P.V and its
# output to bf16 (half an ulp is 2^-8 at |o| in [1, 2)); lse: fp32 sums of
# exact bf16 products in another order.
OUT_TOL, LSE_TOL = 2e-2, 1e-3
# The ring forward's out is also held relative to its size. Past a few
# thousand keys a row's |o| is ~1e-2, under OUT_TOL, so an accumulation
# error as large as the output itself (a missed rescale between shards, V
# read from the wrong shard: lse stays exact) would pass the absolute bound.
# rel-L2 1e-2, the backward's bound: bf16 rounding of P and out gives ~3e-3.
OUT_REL_L2_TOL = 1e-2
# 8B logits, kernel vs plain attention. Every op of the bf16 model rounds
# its output, so any change of rounding inside attention (here: bf16 P in
# the kernel vs fp32 P in the plain version) is carried and re-rounded
# through 32 layers; measured on the H100, the hidden states already differ
# by ~7e-3 after layer 0 and ~2e-2 at the logits. The floor is the repo's
# own reference path: naive_attention rounds scores and probabilities to
# bf16 as the JAX twin does. The kernel must stay within 1.25x of that
# path's distance from the plain version (and under an absolute 5e-2).
# Random-init logits (std ~1, bf16 ulp 1/32 above 4) make near-ties of the
# top two common, so argmax agreement is held to 0.8, not 1.
LOGITS_VS_NAIVE, LOGITS_REL_L2_MAX, ARGMAX_AGREE_MIN = 1.25, 5e-2, 0.8
# Backward kernels vs plain: the kernels round P and dS to bf16 for their
# tensor-core products and the gradients to bf16 (each ~2^-9 relative); the
# plain version keeps fp32 to the end. Bounds per gradient: rel-L2 1e-2
# (about 3x the ~3e-3 those roundings give) and max abs error 2e-2 of the
# gradient's largest magnitude.
BWD_REL_L2_TOL, BWD_MAX_ABS_REL_TOL = 1e-2, 2e-2
# Training (phase 5): bench.py's llama_1b point through the trainer.
TRAIN_MODEL, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = "llama_1b", 12, 1024, 3e-4
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
# Random-init logits have std ~1, which adds ~sigma^2/2 = 0.5 nats to the
# uniform ln(V) on random targets: the first loss must lie in this band.
LOSS0_BELOW, LOSS0_ABOVE = 0.5, 1.5
# Kernel vs plain step at batch 2 (the plain path's fp32 [B,H,S,S] scores
# stay small). "Plain" is the kernels' plain versions in their place: the
# same saved bf16 out and fp32 lse, the same backward recipe (delta from
# the saved out), fp32 arithmetic. Every op of the bf16 model rounds, so
# any bf16 attention moves the gradients ~2e-2 rel-L2 from the plain step,
# and per leaf which of two bf16 paths lies nearer varies with the
# weights. The bound is 1.25x naive_attention's distance (the repo's bf16
# reference path, as in phase 3) over all leaves together, and per leaf
# 1.25x the largest per-leaf distance of the naive step: a broken gradient
# (rel-L2 ~1) fails both. The loss: within 1.25x naive's distance or 1e-3
# relative.
AGREE_BATCH, GRAD_VS_NAIVE = 2, 1.25
LOSS_VS_NAIVE, LOSS_REL_FLOOR = 1.25, 1e-3
# The backward kernels alone: the forward kernel with the plain backward
# vs with the backward kernels. The activations are then identical, so only
# the dq and dk/dv kernels' bf16 P and dS differ; each of the L layers adds
# that op-level rounding (~2.4e-3 rel-L2, phase 2b) to the gradient flowing
# back through it, ~sqrt(L) times that by the first layers. Bound:
# naive_attention's whole-step distance over all leaves.
BWD_ALONE_VS_NAIVE = 1.0
# Updates on one repeated batch, and the least drop of its loss (nats).
REPEAT_STEPS, LOSS_DROP_MIN = 5, 0.5
# Phase 5b: the packed corpora (document lengths drawn from [20, 3000], a
# train corpus for phase 5's 13 steps with room to spare and an eval one),
# the eval stream (JOB_EVAL_BATCHES batches at every JOB_EVAL_EVERY-th
# step), a profile window of two warm-up steps, and 5b-ii's fault run: 4
# layers, 6 steps, a checkpoint every 3, SIGKILL at the top of step 5.
JOB_DOC_LENS = (20, 3001)
JOB_TRAIN_TOKENS, JOB_EVAL_TOKENS = 400_000, 100_000
JOB_EVAL_EVERY, JOB_EVAL_BATCHES = 5, 2
JOB_PROFILE_START = 1
JOB_TRACE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
JOB_RESUME_LAYERS, JOB_RESUME_STEPS, JOB_RESUME_INTERVAL = 4, 6, 3
JOB_FAULT = "step=5;signal=9"
JOB_WORKER_TIMEOUT_S = 300
PROMPT_LENS = (5, 100, 400, 1000, 1900, 3000)
MAX_TOKENS, CHUNK = 32, 16
SEED = 0
MODEL, MODEL_KWARGS, DEVICE = "llama3_8b", {}, "cuda"
GENERATIVE = {"slots": 4, "max_len": 4096, "chunk": CHUNK,
              "prefill_buckets": [128, 512, 2048]}
# Paged serving (4b, 4c): 16 divides max_len and every default decode
# bucket (64 .. 4096).
KV_BLOCK_SIZE = 16
# 4c: int8 weights and KV must bring the serving peak this far under
# phase 4's (bf16 weights 14.96 GiB; an int8 copy is ~7.5 GiB).
QUANT_PEAK_SAVING_MIN_GIB = 5.0
# 4c model level: the int8 model (raw codes into each matmul, fp32 output,
# the scale applied to the output) against a bf16 model holding the same
# codes dequantized (q * scale rounded to bf16). Both compute the same
# function and differ only in where they round: the dequantized weights
# carry a bf16 rounding (~2^-9 relative) the int8 path does not. Every op
# of the bf16 model re-rounds and carries such differences through 32
# layers, the floor phase 3 measured at ~2e-2 rel-L2 for a change of
# rounding inside attention; so the bound is phase 3's absolute one (5e-2)
# and its argmax agreement (0.8). A wrong scale axis gives rel-L2 ~1.
QUANT_LOGITS_REL_L2_MAX, QUANT_ARGMAX_AGREE_MIN = 5e-2, 0.8
QUANT_PROMPT = 2048
# Phase 2c: (M, K, N) of llama3_8b's projections: gate/up and down at a
# 2048-token prefill bucket, then at 32 decode rows (the weight's read
# bounds those).
QMM_SHAPES = [(2048, 4096, 14336), (2048, 14336, 4096), (32, 4096, 14336),
              (32, 4096, 4096)]
# The JAX test's shapes (ragged M, N and K: the byte-wise kernel where K %
# 16 or N % 16 is not 0), one odd M, ragged M and N on the wgmma + TMA
# kernel, and llama3_8b's k/v projection at 32 rows (8 tiles: split K).
QMM_RAGGED = [(100, 384, 200), (64, 128, 128), (32, 100, 64),
              (33, 4096, 4096), (130, 64, 144), (32, 4096, 1024)]
# Phase 2d: ring attention at every (n, B, S, (H, KH), D) of these (S 800 at
# n 4 and 8 gives ragged shards of 200 and 100 rows), then the full-width
# shape: llama3_8b's attention widths (H 32, KH 8, D 128) at 32768 tokens
# over 4 ranks of 8192, with few repetitions at that size. The plain
# versions run there on RING_PLAIN_KV_HEADS kv heads per call (fp32 scores
# of one shard pair for 8 heads would take 8.6 GB).
RING_NS, RING_BS, RING_SS = (2, 4, 8), (1, 2), (512, 800, 2048)
RING_HEADS, RING_DS = ((8, 2), (4, 4), (32, 8)), (64, 128)
RING_FULL = (4, 1, 32768, 32, 8, 128)  # n, B, S, H, KH, D
RING_REPS, RING_PLAIN_KV_HEADS = 3, 2
KERNEL_DESIGN = "wgmma+tma"
# The kernels whose ptxas report must show no spill stores (their consumer
# warpgroups hold the wgmma accumulators in registers: the forward's S, O
# and P, dq's S, dP and dQ, dk/dv's dK and dV, the int8 matmul's int32
# tile and its register A fragments, the W8A16 tile kernel's fp32 tile and
# its widened A fragments; a spill there is lost overlap), and the
# kernels of flash_simt.cu: the CUDA-core forward and backward pair (their
# micro-tiles of S and dP and their [rows, D] accumulators live in
# registers across the walk: every dtype and head-dim bucket) and the
# tensor-core forward (S, P and O fragments; at head dim 256 O alone is 128
# registers a thread).
NO_SPILL_KERNELS = ("flash_fwd_kernel", "rdma_fwd_kernel",
                    "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                    "rdma_bwd_dq_kernel", "rdma_bwd_dkv_kernel",
                    "qmm_wgmma_kernel", "w8a16_wgmma_kernel",
                    "w8a16_decode_kernel",
                    "flash_simt_fwd_kernel", "flash_simt_fwd_mma_kernel",
                    "flash_simt_dq_kernel", "flash_simt_dkv_kernel")
# Instantiations ptxas must report of each flash_simt.cu kernel: 3 dtypes x
# 4 head-dim buckets at every rows choice (16, 32, 64; 64 not above 128) for
# the CUDA-core ones; bf16 and fp16 x 11 buckets for the tensor-core one.
SIMT_INSTANTIATIONS = {"flash_simt_fwd_kernel": 33,
                       "flash_simt_dq_kernel": 33,
                       "flash_simt_dkv_kernel": 33,
                       "flash_simt_fwd_mma_kernel": 22}
# Phase 2e: besides phase 6's attention shapes, llama_1b's widths in fp32
# at batch 2, seq 1024, where launch overhead does not hide the kernels,
# and Gemma 7B's published attention widths (google/gemma-7b config.json:
# 16 heads, 16 kv heads, head_dim 256) in bf16 at batch 1, seq 2048: the
# CUDA-core route's head-dim-256 bucket (only the widths are used).
SIMT_EXTRA_CASE = (2, 1024, 1024, 16, 8, 128, fa.MaskSpec("causal"), False,
                   torch.float32)
SIMT_GEMMA_CASE = (1, 2048, 2048, 16, 16, 256, fa.MaskSpec("causal"), False,
                   torch.bfloat16)
SIMT_BWD_DESIGN = ("cuda cores, fp32, register-tiled micro-tiles, cp.async "
                   "ring, per-tile masks, planned grid with split dk/dv")
SIMT_FWD_DESIGN = ("bf16/fp16: tensor cores, mma.sync m16n8k16, ldmatrix "
                   "fragments, online softmax in registers; fp32: cuda "
                   "cores, register-tiled micro-tiles; both: cp.async ring, "
                   "per-tile masks, planned grid")


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around `reps` back-to-back calls.
    A sleep kernel keeps the device busy while the host enqueues them, so
    host overhead between launches is not counted."""
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


def _visible(b, s, t, mask, seg, dev):
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(t, device=dev)[None, :]
    vis = fa._visible(rows, cols, mask)[None].expand(b, s, t)
    if seg is not None:
        vis = vis & (seg[:, :, None] == seg[:, None, :])
    return vis


# (B, S, T, H, KH, D, mask, segments): the serving shapes of phase 2.
KERNEL_CASES = [(1, s, s, 32, 8, 128, fa.MaskSpec("causal"), False)
                for s in (128, 512, 2048, 1000)] + [
    (1, 512, 512, 16, 8, 128, fa.MaskSpec("causal"), False),
    (2, 300, 300, 8, 2, 64, fa.MaskSpec("causal"), False),
    (1, 1000, 1000, 32, 8, 128, fa.MaskSpec("full"), False),
    (1, 200, 700, 32, 8, 128, fa.MaskSpec("full"), False),
    (1, 1000, 1000, 32, 8, 128, fa.MaskSpec("prefix_lm", prefix=300),
     False),
    (1, 1000, 1000, 32, 8, 128,
     fa.MaskSpec("sliding_window", window=256), False),
    (1, 1000, 1000, 32, 8, 128, fa.MaskSpec("causal"), True),
]
# The llama_1b training shape (batch 12, seq 1024, 16/8 heads, Dh 128).
TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 128,
              fa.MaskSpec("causal"), False)


def _case_name(b, s, t, h, kh, d, mask, segs) -> str:
    return (f"B{b} S{s} T{t} H{h} KH{kh} D{d} {mask.kind}"
            + ("+segments" if segs else ""))


def _case_inputs(case, gen, dev, grad_out=False):
    """Random bf16 q, k, v (and dO) and, for segment cases, documents of
    random length (~1% chance of a break per row)."""
    b, s, t, h, kh, d, mask, segs = case
    shapes = [(b, s, h, d), (b, t, kh, d), (b, t, kh, d)]
    if grad_out:
        shapes.append((b, s, h, d))
    xs = [torch.randn(shp, generator=gen, device=dev).bfloat16()
          for shp in shapes]
    seg = None
    if segs:
        seg = torch.cumsum((torch.rand(b, s, generator=gen, device=dev)
                            < 0.01).int(), dim=1).int()
    return xs, seg


def _sdpa_kwargs(mask, seg, s, t, vis) -> dict:
    if mask.kind == "causal" and seg is None and s == t:
        return {"is_causal": True}
    if mask.kind == "full" and seg is None:
        return {}
    return {"attn_mask": vis[:, None]}


def _bound(flops: float, nbytes: float,
           peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    ops_s, mem_s = flops / peak, nbytes / PEAK_BYTES
    return max(ops_s, mem_s) * 1e3, ("operations" if ops_s >= mem_s
                                     else "bytes")


def phase_kernels() -> dict:
    """flash_fwd against _flash_fwd_plain (fp32 on the same bf16 inputs)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, worst_out, worst_lse = [], 0.0, 0.0
    for case in KERNEL_CASES:
        b, s, t, h, kh, d, mask, segs = case
        (q, k, v), seg = _case_inputs(case, gen, dev)
        before = fa.flash_fwd_launches
        out, lse = fa.flash_attention_lse(q, k, v, mask=mask, segment_ids=seg)
        torch.cuda.synchronize()
        if fa.flash_fwd_launches != before + 1:
            raise RuntimeError("flash_attention_lse did not launch the kernel")
        ref_out, ref_lse = fa._flash_fwd_plain(q.float(), k.float(),
                                               v.float(), mask, seg)
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        vis = _visible(b, s, t, mask, seg, dev)
        pairs = int(vis.sum().item()) * h
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
                  + 4 * lse.numel() + (4 * seg.numel() if segs else 0))
        bound, bound_by = _bound(4 * d * pairs, nbytes)
        ms = time_ms(lambda: fa.flash_attention_lse(
            q, k, v, mask=mask, segment_ids=seg))
        plain_ms = time_ms(lambda: fa._flash_fwd_plain(q, k, v, mask, seg),
                           reps=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_kw = _sdpa_kwargs(mask, seg, s, t, vis)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa_kw))
        name = _case_name(*case)
        ok = err_out <= OUT_TOL and err_lse <= LSE_TOL and finite
        log(f"  {name:48s} err_out {err_out:.3e} err_lse {err_lse:.3e} "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} bound_ms {bound:.4f} ({bound_by}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_fwd disagrees with its plain version "
                               f"at {name}")
        worst_out, worst_lse = max(worst_out, err_out), max(worst_lse, err_lse)
        rows.append({"shape": name, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound,
                     "bound_by": bound_by})
    main_shape = rows[2]  # B1 S2048 H32 KH8 D128 causal: the 8B prefill
    return {"rows": rows, "main": main_shape, "max_abs_err": worst_out,
            "max_abs_err_lse": worst_lse}


def _grad_errors(got, ref) -> dict:
    """max abs error, the reference's largest magnitude, rel-L2, finite."""
    g32 = got.float()
    return {"max_abs": (g32 - ref).abs().max().item(),
            "scale": ref.abs().max().item(),
            "rel_l2": ((g32 - ref).norm() / ref.norm()).item(),
            "finite": bool(torch.isfinite(g32).all())}


def _sdpa_backward_ms(q, k, v, do, sdpa_kw) -> float:
    """One torch.autograd.grad through SDPA (dq, dk, dv in one call), its
    forward outside the timing."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **sdpa_kw)
    go = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), go, retain_graph=True))


def phase_backward() -> dict:
    """flash_bwd_dq and flash_bwd_dkv against _flash_bwd_plain (fp32 on the
    same bf16 inputs, the kernel forward's out and lse) at the phase-2
    shapes and the training shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, worst = [], {n: {"max_abs": 0.0, "rel_l2": 0.0}
                       for n in ("dq", "dk", "dv")}
    for case in KERNEL_CASES + [TRAIN_CASE]:
        b, s, t, h, kh, d, mask, segs = case
        (q, k, v, do), seg = _case_inputs(case, gen, dev, grad_out=True)
        out, lse = fa.flash_attention_lse(q, k, v, mask=mask, segment_ids=seg)
        got = fa._flash_bwd_cuda(q, k, v, out, lse, do, None, mask, seg)
        torch.cuda.synchronize()
        ref = fa._flash_bwd_plain(q.float(), k.float(), v.float(), out, lse,
                                  do.float(), None, mask, seg)
        errs = {n: _grad_errors(g, r)
                for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        del got, ref
        ok = all(e["finite"] and e["rel_l2"] <= BWD_REL_L2_TOL
                 and e["max_abs"] <= BWD_MAX_ABS_REL_TOL * e["scale"]
                 for e in errs.values())
        vis = _visible(b, s, t, mask, seg, dev)
        pairs = int(vis.sum().item()) * h
        seg_bytes = 4 * seg.numel() if segs else 0
        # q, k, v, dO read once, lse and delta once; each kernel writes
        # its own gradients once.
        reads = (2 * (q.numel() + k.numel() + v.numel() + do.numel())
                 + 8 * lse.numel() + seg_bytes)
        dq_bound, dq_by = _bound(6 * d * pairs, reads + 2 * q.numel())
        dkv_bound, dkv_by = _bound(8 * d * pairs,
                                   reads + 2 * (k.numel() + v.numel()))
        delta = fa._bwd_delta(do, out, None)
        dq_ms = time_ms(lambda: fa._flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, mask, seg))
        dkv_ms = time_ms(lambda: fa._flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, mask, seg))
        delta_ms = time_ms(lambda: fa._bwd_delta(do, out, None))
        fwd_ms = time_ms(lambda: fa.flash_attention_lse(
            q, k, v, mask=mask, segment_ids=seg))
        sdpa_kw = _sdpa_kwargs(mask, seg, s, t, vis)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fwd_library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa_kw))
        plain_ms = time_ms(lambda: fa._flash_bwd_plain(
            q, k, v, out, lse, do, None, mask, seg), reps=3)
        library_ms = _sdpa_backward_ms(q, k, v, do, sdpa_kw)
        name = _case_name(*case)
        log(f"  {name:48s} " + " ".join(
            f"{n} max_abs {e['max_abs']:.3e} (of {e['scale']:.2e}) rel_l2 "
            f"{e['rel_l2']:.3e};" for n, e in errs.items())
            + f" {'OK' if ok else 'FAIL'}")
        log(f"    dq_ms {dq_ms:.4f} (bound {dq_bound:.4f}, {dq_by}) dkv_ms "
            f"{dkv_ms:.4f} (bound {dkv_bound:.4f}, {dkv_by}) delta_ms "
            f"{delta_ms:.4f} fwd_ms {fwd_ms:.4f} (SDPA fwd "
            f"{fwd_library_ms:.4f}) plain_bwd_ms "
            f"{plain_ms:.4f} library_bwd_ms {library_ms:.4f}")
        if not ok:
            raise RuntimeError(f"flash backward kernels disagree with the "
                               f"plain version at {name}")
        for n, e in errs.items():
            for key in ("max_abs", "rel_l2"):
                worst[n][key] = max(worst[n][key], e[key])
        rows.append({"shape": name, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
                     "delta_ms": delta_ms, "fwd_ms": fwd_ms,
                     "fwd_library_ms": fwd_library_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
                     "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by})
    return {"rows": rows, "main": rows[-1], "worst": worst}


def _gpu_tests():
    """tests/test_torch_gpu_kernels.py as a module: phases 2e and 6 use its
    C1 configs, bounds and check, so the chip run and the GPU tests hold
    one copy of them."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "test_torch_gpu_kernels.py")
    spec = importlib.util.spec_from_file_location("gpu_kernel_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _simt_cases(gk) -> list:
    """(B, S, T, H, KH, D, mask, segments, dtype): the attention of each of
    phase 6's configs at its batch, then SIMT_EXTRA_CASE and
    SIMT_GEMMA_CASE."""
    cases = []
    for name in gk.C1_CONFIGS:
        cfg = gk.c1_config(name)
        cases.append((gk.C1_BATCH, gk.C1_SEQ, gk.C1_SEQ, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim, fa.MaskSpec("causal"),
                      False, cfg.dtype))
    return cases + [SIMT_EXTRA_CASE, SIMT_GEMMA_CASE]


def phase_simt(gk) -> dict:
    """The CUDA-core forward, dq and dk/dv (csrc/flash_simt.cu) against the
    plain versions on the same inputs widened to fp32, held by the GPU
    tests' bounds (SIMT_TOL: out and lse max abs, gradients' rel-L2), with
    their times, the plain versions', SDPA's forward and backward, and
    their bounds (fp32 at the CUDA cores' peak, bf16 at the tensor
    cores'). Prints each case's forward and backward plans; the forward
    must run on the tensor cores for bf16/fp16 and on the CUDA cores for
    fp32 (by the launch counters), and two launches of it must give
    bit-identical out and lse; where the backward splits dk/dv, a second
    launch of dq and of dk/dv must give bit-identical gradients (fails
    unless some case splits). Returns the rows and, as "main", the row of
    phase 6's fp32 config."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows, repeated = [], 0
    for case in _simt_cases(gk):
        b, s, t, h, kh, d, mask, segs, dtype = case
        q, k, v, do = (torch.randn(shp, generator=gen, device=dev).to(dtype)
                       for shp in ((b, s, h, d), (b, t, kh, d),
                                   (b, t, kh, d), (b, s, h, d)))
        plan = fa._simt_plan_for(q, k)
        fplan = fa._simt_fwd_plan_for(q, k)
        log(f"  plan {_case_name(*case[:8])} {str(dtype)[6:]}: forward "
            f"{fplan.kernel} (bucket {fplan.bucket}, rows {fplan.rows}, "
            f"tile {fplan.tile}, {fplan.ctas} CTAs, {fplan.smem} bytes); "
            f"dq rows {plan.dq_rows} (tile {plan.dq_tile}, {plan.dq_ctas} "
            f"CTAs); "
            f"dk/dv rows {plan.dkv_rows} (tile {plan.dkv_tile}, "
            f"{plan.dkv_blocks} key blocks x {plan.splits} splits of a "
            f"{plan.walk}-step walk)")
        mma_before = fa.flash_simt_fwd_mma_launches
        out, lse = fa._flash_simt_fwd_cuda(q, k, v, mask)
        out2, lse2 = fa._flash_simt_fwd_cuda(q, k, v, mask)
        torch.cuda.synchronize()
        ran = ("mma" if fa.flash_simt_fwd_mma_launches - mma_before == 2
               else "simt" if fa.flash_simt_fwd_mma_launches == mma_before
               else "both")
        want = "simt" if dtype == torch.float32 else "mma"
        same_fwd = torch.equal(out, out2) and torch.equal(lse, lse2)
        log(f"    forward ran the {ran} kernel; a second launch "
            f"{'is bit-identical' if same_fwd else 'DIFFERS'}")
        if ran != want or not same_fwd:
            raise RuntimeError(f"the forward at {_case_name(*case[:8])} ran "
                               f"{ran} (want {want}), repeat bit-identical "
                               f"{same_fwd}")
        del out2, lse2
        delta = fa._bwd_delta(do, out, None)
        dq = fa._flash_simt_bwd_dq_cuda(q, k, v, do, lse, delta, mask)
        dk, dv = fa._flash_simt_bwd_dkv_cuda(q, k, v, do, lse, delta, mask)
        torch.cuda.synchronize()
        if plan.splits > 1:
            again = (fa._flash_simt_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                mask),
                     *fa._flash_simt_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                  mask))
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip((dq, dk, dv), again))
            log(f"    split dk/dv: a second launch of dq and dk/dv "
                f"{'is bit-identical' if same else 'DIFFERS'}")
            if not same:
                raise RuntimeError(f"two launches of the CUDA-core backward "
                                   f"differ at {_case_name(*case[:8])}")
            repeated += 1
            del again
        ref_out, ref_lse = fa._flash_fwd_plain(q.float(), k.float(),
                                               v.float(), mask)
        refs = fa._flash_bwd_plain(q.float(), k.float(), v.float(), out,
                                   lse, do.float(), None, mask)
        out_tol, lse_tol, grad_tol = gk.SIMT_TOL[dtype]
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        errs = {n: _grad_errors(g, r)
                for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        del refs, ref_out
        ok = (err_out <= out_tol and err_lse <= lse_tol
              and bool(torch.isfinite(out.float()).all())
              and all(e["finite"] and e["rel_l2"] <= grad_tol
                      for e in errs.values()))
        vis = _visible(b, s, t, mask, None, dev)
        pairs = int(vis.sum().item()) * h
        es = q.element_size()
        peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        reads = es * (q.numel() + k.numel() + v.numel())
        fwd_bound = _bound(4 * d * pairs, reads + es * out.numel()
                           + 4 * lse.numel(), peak)
        bwd_reads = reads + es * do.numel() + 8 * lse.numel()
        dq_bound = _bound(6 * d * pairs, bwd_reads + es * q.numel(), peak)
        dkv_bound = _bound(8 * d * pairs,
                           bwd_reads + es * (k.numel() + v.numel()), peak)
        fwd_ms = time_ms(lambda: fa._flash_simt_fwd_cuda(q, k, v, mask))
        dq_ms = time_ms(lambda: fa._flash_simt_bwd_dq_cuda(
            q, k, v, do, lse, delta, mask))
        dkv_ms = time_ms(lambda: fa._flash_simt_bwd_dkv_cuda(
            q, k, v, do, lse, delta, mask))
        plain_fwd_ms = time_ms(lambda: fa._flash_fwd_plain(q, k, v, mask),
                               reps=5)
        plain_bwd_ms = time_ms(lambda: fa._flash_bwd_plain(
            q, k, v, out, lse, do, None, mask), reps=3)
        sdpa_kw = _sdpa_kwargs(mask, None, s, t, vis)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_fwd_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa_kw))
        library_bwd_ms = _sdpa_backward_ms(q, k, v, do, sdpa_kw)
        # fp32 inputs: the same shapes in bf16 (the tensor-core forward),
        # its plain version and SDPA, for the kernel table's bf16 row.
        bf16_copy = None
        if dtype == torch.float32:
            qb, kb, vb = (x.bfloat16() for x in (q, k, v))
            qbt, kbt, vbt = (x.transpose(1, 2) for x in (qb, kb, vb))
            bf16_copy = {
                "fwd_ms": time_ms(lambda: fa._flash_simt_fwd_cuda(
                    qb, kb, vb, mask)),
                "plain_fwd_ms": time_ms(lambda: fa._flash_fwd_plain(
                    qb, kb, vb, mask), reps=5),
                "library_fwd_ms": time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qbt, kbt, vbt, enable_gqa=True, **sdpa_kw))}
            del qb, kb, vb, qbt, kbt, vbt
        name = _case_name(*case[:8]) + f" {str(dtype)[6:]}"
        log(f"  {name:52s} err_out {err_out:.3e} err_lse {err_lse:.3e} "
            + " ".join(f"{n} rel_l2 {e['rel_l2']:.3e};"
                       for n, e in errs.items())
            + f" {'OK' if ok else 'FAIL'}")
        log(f"    fwd_ms {fwd_ms:.4f} (bound {fwd_bound[0]:.4f}, "
            f"{fwd_bound[1]}; plain {plain_fwd_ms:.4f}; SDPA "
            f"{library_fwd_ms:.4f}) dq_ms {dq_ms:.4f} (bound "
            f"{dq_bound[0]:.4f}, {dq_bound[1]}) dkv_ms {dkv_ms:.4f} (bound "
            f"{dkv_bound[0]:.4f}, {dkv_bound[1]}) plain_bwd_ms "
            f"{plain_bwd_ms:.4f} library_bwd_ms {library_bwd_ms:.4f}"
            + ("; on bf16 copies: fwd_ms {fwd_ms:.4f} plain_fwd_ms "
               "{plain_fwd_ms:.4f} library_fwd_ms {library_fwd_ms:.4f}"
               .format(**bf16_copy) if bf16_copy else ""))
        if not ok:
            raise RuntimeError(f"the CUDA-core kernels disagree with the "
                               f"plain versions at {name}")
        rows.append({"shape": name, "err_out": err_out, "err_lse": err_lse,
                     "errs": errs, "fwd_ms": fwd_ms, "dq_ms": dq_ms,
                     "dkv_ms": dkv_ms, "plain_fwd_ms": plain_fwd_ms,
                     "plain_bwd_ms": plain_bwd_ms,
                     "library_fwd_ms": library_fwd_ms,
                     "library_bwd_ms": library_bwd_ms,
                     "bf16_copy": bf16_copy,
                     "fwd_bound": fwd_bound, "dq_bound": dq_bound,
                     "dkv_bound": dkv_bound,
                     "plan": dataclasses.asdict(plan),
                     "fwd_plan": dataclasses.asdict(fplan)})
        del q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    if not repeated:
        raise RuntimeError("no phase 2e case split dk/dv: the repeat check "
                           "did not run")
    return {"rows": rows, "main": rows[len(gk.C1_CONFIGS) - 1]}


def _qmm_inputs(m, k, n, gen, dev):
    """Activations N(0, 1); int8 weights uniform over [-127, 127] with
    per-column scales in [1e-3, 1e-2]."""
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    sw = torch.rand(n, generator=gen, device=dev) * 9e-3 + 1e-3
    return x, qw, sw


def phase_qmm() -> dict:
    """int8_matmul's path (the op at the 8B projection shapes, launches
    counted: every one of the wgmma + TMA kernel), then the op against
    _int8_matmul_plain: equal bit for bit at fp32 output, equal at bf16, on
    every shape, each launching the kernel _qmm_plan names for it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    inputs = {shape: _qmm_inputs(*shape, gen, dev)
              for shape in QMM_SHAPES + QMM_RAGGED}
    qmm.qmm_launches = qmm.qmm_wgmma_launches = 0
    for shape in QMM_SHAPES:
        x, qw, sw = inputs[shape]
        out = qmm.int8_matmul(x, qw, sw)
        if out.shape != (shape[0], shape[2]):
            raise RuntimeError(f"int8_matmul gave shape {tuple(out.shape)}")
    torch.cuda.synchronize()
    launches, wgmma = qmm.qmm_launches, qmm.qmm_wgmma_launches
    log(f"  int8_matmul at the {len(QMM_SHAPES)} projection shapes: "
        f"{launches} kernel launches, {wgmma} of the wgmma + TMA kernel")
    if launches != len(QMM_SHAPES) or wgmma != len(QMM_SHAPES):
        raise RuntimeError("int8_matmul did not launch the wgmma kernel at "
                           "every projection shape")
    rows, worst = [], 0.0
    for shape, (x, qw, sw) in inputs.items():
        m, k, n = shape
        qx, sx = qmm.quantize_activations(x)
        plan = qmm._qmm_plan(m, k, n, sms)
        if (k % 16 or n % 16) and plan.kernel != qmm.BYTEWISE:
            raise RuntimeError(f"M{m} K{k} N{n}: TMA cannot describe it, "
                               f"yet the plan is {plan}")
        for out_dtype in (torch.float32, torch.bfloat16):
            before = qmm.qmm_launches, qmm.qmm_wgmma_launches
            got = qmm.int8_matmul(x, qw, sw, out_dtype=out_dtype)
            want = qmm._int8_matmul_plain(qx, sx, qw, sw, out_dtype)
            torch.cuda.synchronize()
            ran = (qmm.WGMMA if qmm.qmm_wgmma_launches > before[1]
                   else qmm.BYTEWISE)
            if qmm.qmm_launches != before[0] + 1 or ran != plan.kernel:
                raise RuntimeError(f"M{m} K{k} N{n}: the {ran} kernel ran, "
                                   f"the plan names {plan.kernel}")
            err = (got.float() - want.float()).abs().max().item()
            if not torch.equal(got, want):
                raise RuntimeError(f"int8_matmul differs from its plain "
                                   f"version at {shape} {out_dtype}: max abs "
                                   f"{err:.3e}")
            worst = max(worst, err)
        what = (f"{plan.kernel} kernel (bm {plan.bm}, splits {plan.splits})"
                if plan.kernel == qmm.WGMMA else f"{plan.kernel} kernel")
        if shape not in QMM_SHAPES:
            log(f"  M{m} K{k} N{n}: {what}, equal to the plain version "
                "(fp32, bf16)")
            continue
        # Bytes: qx, sx, qw, sw read once, fp32 out written once.
        nbytes = m * k + 4 * m + k * n + 4 * n + 4 * m * n
        ops_s, mem_s = 2 * m * k * n / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        bound = max(ops_s, mem_s) * 1e3
        bound_by = "operations" if ops_s >= mem_s else "bytes"
        ms = time_ms(lambda: qmm._int8_matmul_cuda(qx, sx, qw, sw))
        op_ms = time_ms(lambda: qmm.int8_matmul(x, qw, sw))
        plain_ms = time_ms(lambda: qmm._int8_matmul_plain(qx, sx, qw, sw),
                           reps=3)
        # torch._int_mm: cuBLASLt's int8 GEMM (int32 out, no epilogue); it
        # takes M > 16 and K, N multiples of 8. Timed here, never called
        # by the port: on the N-major weight as the op holds it, and on a
        # K-major copy (made outside the timing), the TN layout it wants.
        library_ms = time_ms(lambda: torch._int_mm(qx, qw))
        qwt = qw.t().contiguous()
        library_kmajor_ms = time_ms(lambda: torch._int_mm(qx, qwt.t()))
        del qwt
        quant_ms = time_ms(lambda: qmm.quantize_activations(x))
        log(f"  M{m} K{k} N{n}: {what}: ms {ms:.4f} "
            f"({2 * m * k * n / ms / 1e9:.1f} TOP/s, {bound / ms:.1%} of "
            f"bound) op_ms (with quantization) {op_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms (_int_mm, N-major) {library_ms:.4f} "
            f"(K-major) {library_kmajor_ms:.4f} bound_ms {bound:.4f} "
            f"({bound_by}); activation quantization {quant_ms:.4f} ms; "
            "equal (fp32, bf16)")
        rows.append({"shape": f"M{m} K{k} N{n}", "design": plan.kernel,
                     "bm": plan.bm, "splits": plan.splits, "ms": ms,
                     "op_ms": op_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library_ms_kmajor": library_kmajor_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "quantize_ms": quant_ms})
    del inputs
    torch.cuda.empty_cache()
    return {"rows": rows, "main": rows[0], "launches": launches,
            "max_abs_err": worst}


# Phase 2f: the unembedding epilogue's source line (the XLA-fused int8
# branch the kernel stands for; not a TPU kernel).
W8A16_REPLACES = "kubeflow_tpu/serve/quant.py:260"
# Weight bytes a cold timing rotates through: past the 50 MB L2, as a
# model's layers find each weight.
W8A16_COLD_BYTES = 120e6
# The kernels line reports this shape (the decode gate/up projection at
# phase 4c's four rows).
W8A16_MAIN = (4, 4096, 14336)
# Row counts timed at the 8B shapes (bf16): decode and prefill buckets; the
# ragged and fp16 cases are held for correctness only.
W8A16_TIMED_M = (1, 4, 16, 128, 512, 2048)
# Launches of each 8B weight shape (K, N) in one int8 decode step: q and o,
# k and v, gate and up per layer, down per layer, the unembedding once
# (7 x 32 + 1 = 225).
W8A16_STEP = {(4096, 4096): 64, (4096, 1024): 64, (4096, 14336): 64,
              (14336, 4096): 32, (4096, 128256): 1}
W8A16_DECODE_DESIGN = ("persistent CTAs, one an SM, each a contiguous run of "
                       "16-row blocks; a 4-slot ring on mbarriers fed by TMA "
                       "boxes (cached tensor maps) and cp.async.bulk; "
                       "mma.sync m16n8k16; split-K summed in a thread-block "
                       "cluster through distributed shared memory; "
                       "programmatic dependent launch")
# Position p of a decode step's 225 decode-kernel launches (7 a layer in
# the model's order, then the unembedding): the shape it runs.
W8A16_STEP_ORDER = ("q/o", "k/v", "k/v", "q/o", "gate/up", "gate/up", "down")
# The device busy time of an int8 decode step before the streamed decode
# kernel (phase 4c's profile, NVIDIA H100 80GB HBM3 at 700 W), printed
# beside this run's.
W8A16_EARLIER_BUSY_MS = 20.30


def launch_ms(fn, reps: int = 20) -> float:
    """Device time of one call as a model's step finds it: each call
    follows a PyTorch kernel (a one-element add; a decode projection
    follows a norm, a rotary embedding, an activation or attention, none of
    which lets the next kernel start early), and a pair of CUDA events
    spans the call alone, from the add's end to the call's. Mean over
    `reps`; a sleep kernel keeps the device busy while the host enqueues
    them. Back-to-back calls (`time_ms`) would let a programmatic dependent
    launch overlap each call with the one before it."""
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


def _rotating(fn, copies) -> callable:
    """A zero-argument call of fn on each of `copies` in turn."""
    turn = itertools.cycle(copies)
    return lambda: fn(next(turn))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds to enqueue one call of `fn` (no synchronise inside
    the timing; the device work is far shorter than the queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def phase_w8a16(gk) -> dict:
    """int8_weight_matmul against _int8_weight_matmul_plain at the GPU
    tests' W8A16_CASES (their check: two launches bit-identical, rel-L2
    within W8A16_TOL), then, at the 8B shapes, the kernel's time with the
    weight rotating past the L2, its bound, the plain version's time and
    torch.mm's on a pre-cast copy of the weight in the compute dtype (fp32
    output, the scale, the cast: the library yardstick, never called by
    the port). Decode rows (M <= 16) time each call after a PyTorch kernel
    (`launch_ms`), as a model's step runs it; prefill rows back to back."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    sms = w8._sm_count(dev.index or 0)
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    for case in gk.W8A16_CASES:
        m, k, n, dtype, rf = case
        x, q, scale = gk.w8a16_inputs(m, k, n, dtype, gen, dev)
        plan = w8._w8a16_plan(m, k, n, dtype, True, sms)
        err = gk.w8a16_check(x, q, scale, rf)
        worst_abs = max(worst_abs, err["max_abs"])
        worst_rel = max(worst_rel, err["rel_l2"])
        what = (f"{gk.w8a16_case_id(case)}: {plan.kernel} kernel"
                + (f" (tile {plan.bm} x {w8._BN}, {plan.tiles} tiles)"
                   if plan.kernel == w8.WGMMA else "")
                + (f" (row block {w8._GEMV_ROWS}, cluster {plan.splits}, "
                   f"{plan.clusters} clusters, grid {plan.grid[0]}, ring "
                   f"{w8._GEMV_STAGES} stages of {w8._GEMV_STAGE_K} k by "
                   f"{plan.slot_rows} rows, {plan.layout[-1]} bytes of shared "
                   f"memory)" if plan.kernel == w8.GEMV else "")
                + (f", {plan.splits} splits" if plan.splits > 1
                   and plan.kernel != w8.GEMV else "")
                + f", rel_l2 {err['rel_l2']:.2e} (bound "
                f"{gk.W8A16_TOL[dtype]}), two launches bit-identical")
        if (n * k < 4096 * 1024 or dtype != torch.bfloat16
                or m not in W8A16_TIMED_M):  # correctness only
            log(f"  {what}")
            continue
        es = x.element_size()
        nbytes = m * k * es + n * k + 4 * n + m * n * es
        bound, bound_by = _bound(2 * m * n * k, nbytes)
        copies = [q] + [q.clone() for _ in range(
            max(0, math.ceil(W8A16_COLD_BYTES / (n * k)) - 1))]
        timer = launch_ms if m <= 16 else time_ms
        ms = timer(_rotating(lambda w: w8.int8_weight_matmul(
            x, w, scale, round_before_scale=rf), copies))
        del copies
        plain_ms = time_ms(lambda: w8._int8_weight_matmul_plain(
            x, q, scale, rf), reps=3)
        wides = [q.to(dtype)]
        wides += [wides[0].clone() for _ in range(max(0, math.ceil(
            W8A16_COLD_BYTES / (n * k * es)) - 1))]
        library_ms = timer(_rotating(lambda w: (torch.mm(
            x, w.t(), out_dtype=torch.float32) * scale).to(dtype), wides))
        # The host's share of a decode step: enqueue time of one call of
        # the op, of its plain version and of the library call, at decode
        # widths (at prefill widths the device's queue would fill).
        enqueue = {} if m > 16 else {name: host_us(fn) for name, fn in (
            ("op", lambda: w8.int8_weight_matmul(
                x, q, scale, round_before_scale=rf)),
            ("plain", lambda: w8._int8_weight_matmul_plain(x, q, scale, rf)),
            ("library", lambda: (torch.mm(x, wides[0].t(),
                                          out_dtype=torch.float32)
                                 * scale).to(dtype)))}
        del wides
        log(f"  {what}; ms {ms:.4f} ({bound / ms:.1%} of bound) plain_ms "
            f"{plain_ms:.4f} library_ms (torch.mm, pre-cast weight) "
            f"{library_ms:.4f} bound_ms {bound:.4f} ({bound_by})"
            + ("; host enqueue us a call: " + ", ".join(
                f"{k} {v:.1f}" for k, v in enqueue.items()) if enqueue
               else ""))
        rows.append({"shape": f"M{m} K{k} N{n}", "m": m, "k": k, "n": n,
                     "kernel": plan.kernel, "bm": plan.bm,
                     "splits": plan.splits, "grid": plan.grid[0],
                     "layout": plan.layout, "timer": timer.__name__,
                     "unembed": rf, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound, "bound_by": bound_by,
                     "rel_l2": err["rel_l2"], "host_us": enqueue})
        del x, q, scale
    torch.cuda.empty_cache()
    main = next(r for r in rows
                if r["shape"] == "M{} K{} N{}".format(*W8A16_MAIN))
    steps = {}
    for m in (1, 4, 16):
        # The step's five weights, each with its own epilogue (the dense
        # one, the unembedding's for the 128256-row table).
        mine = {(r["k"], r["n"]): r for r in rows
                if r["m"] == m and (r["k"], r["n"]) in W8A16_STEP
                and r["unembed"] == (r["n"] == 128256)}
        if set(mine) != set(W8A16_STEP):
            raise RuntimeError(f"phase 2f timed no full decode step at M{m}")
        step = {key: sum(W8A16_STEP[kn] * mine[kn][key] for kn in W8A16_STEP)
                for key in ("ms", "bound_ms", "library_ms")}
        steps[m] = step
        log(f"  per int8 decode step at M{m} ({sum(W8A16_STEP.values())} "
            f"launches): {step['ms']:.4f} ms, bound "
            f"{step['bound_ms']:.4f} ms ({step['bound_ms'] / step['ms']:.1%} "
            f"of bound); torch.mm on pre-cast weights {step['library_ms']:.4f}"
            f" ms")
    return {"rows": rows, "main": main, "max_abs_err": worst_abs,
            "rel_l2_err": worst_rel, "steps": steps}


def _ring_counts() -> tuple:
    return (rra.rdma_fwd_launches, rra.rdma_bwd_dq_launches,
            rra.rdma_bwd_dkv_launches)


def _ring_name(n, b, s, h, kh, d) -> str:
    return f"n{n} B{b} S{s} H{h} KH{kh} D{d}"


def _by_kv_heads(fn, n, kh, group, *xs):
    """`fn(*xs sliced to RING_PLAIN_KV_HEADS kv heads, n)` over all kv heads,
    the results concatenated on the head axis. xs are q-like (H heads) or
    k-like (KH heads) [B,S,heads,...] tensors, sliced in fp32."""
    parts = []
    for j in range(0, kh, RING_PLAIN_KV_HEADS):
        m = min(RING_PLAIN_KV_HEADS, kh - j)
        parts.append(fn(*(
            (x[:, :, j:j + m] if x.shape[2] == kh
             else x[:, :, j * group:(j + m) * group]).float() for x in xs),
            n))
    return [torch.cat(p, dim=2) for p in zip(*parts)]


def _ring_case(shape, gen, dev, full=False) -> dict:
    """The op forward and backward (autograd) on one shape, held against
    the plain versions on the same bf16 inputs; the counters must move by
    exactly n per kernel."""
    n, b, s, h, kh, d = shape
    q, k, v, do = (torch.randn(shp, generator=gen, device=dev).bfloat16()
                   for shp in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d),
                               (b, s, h, d)))
    mesh = Mesh([dev] * n, ("seq",))
    out, lse = rra._rdma_fwd_cuda(q, k, v, n)
    torch.cuda.synchronize()
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    if full:
        # The main path: the counts from 0, read right after.
        rra.rdma_fwd_launches = rra.rdma_bwd_dq_launches = 0
        rra.rdma_bwd_dkv_launches = 0
    before = _ring_counts()
    got = rra.rdma_ring_attention(qg, kg, vg, "seq", mesh)
    got.backward(do)
    torch.cuda.synchronize()
    moved = tuple(a - c for a, c in zip(_ring_counts(), before))
    if moved != (n, n, n):
        raise RuntimeError(f"ring attention at {_ring_name(*shape)} "
                           f"launched {moved} kernels, not {n} each")
    if not torch.equal(got, out):
        raise RuntimeError("the op's output differs from the forward kernels'")
    group = h // kh
    if full:
        ref_out, ref_lse = _by_kv_heads(rra._rdma_fwd_plain, n, kh, group,
                                        q, k, v)
        refs = _by_kv_heads(rra._rdma_bwd_plain, n, kh, group,
                            q, k, v, out, lse, do)
    else:
        ref_out, ref_lse = rra._rdma_fwd_plain(q.float(), k.float(),
                                               v.float(), n)
        refs = rra._rdma_bwd_plain(q.float(), k.float(), v.float(), out,
                                   lse, do.float(), n)
    res = {"out": (out.float() - ref_out).abs().max().item(),
           "out_rel_l2": ((out.float() - ref_out).norm()
                          / ref_out.norm()).item(),
           "lse": (lse - ref_lse).abs().max().item(),
           "finite": bool(torch.isfinite(out.float()).all())}
    res.update({name: _grad_errors(g, r) for name, g, r in zip(
        ("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad), refs)})
    ok = (res["finite"] and res["out"] <= OUT_TOL
          and res["out_rel_l2"] <= OUT_REL_L2_TOL and res["lse"] <= LSE_TOL
          and all(res[g]["finite"] and res[g]["rel_l2"] <= BWD_REL_L2_TOL
                  and res[g]["max_abs"] <= BWD_MAX_ABS_REL_TOL
                  * res[g]["scale"] for g in ("dq", "dk", "dv")))
    line = (f"  {_ring_name(*shape)}: err_out {res['out']:.3e} out rel_l2 "
            f"{res['out_rel_l2']:.3e} err_lse {res['lse']:.3e} " + " ".join(
                f"{g} rel_l2 {res[g]['rel_l2']:.3e}" for g in ("dq", "dk",
                                                               "dv")))
    if full or not ok:
        log(line + (" OK" if ok else " FAIL"))
    if not ok:
        raise RuntimeError(f"ring attention kernels disagree with the plain "
                           f"versions at {_ring_name(*shape)}")
    if full:
        res["launches"] = moved
        res["tensors"] = (q, k, v, do, out, lse)
    return res


def _sdpa_global_ms(q, k, v, do) -> tuple[float, float]:
    """SDPA causal over the whole sequence, K/V expanded to q's heads
    outside the timing, on the fused backends only (the math backend's
    [S, S] scores would not fit): (forward ms, backward ms)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(group, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        with torch.no_grad():
            fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                             reps=RING_REPS)
        out = sdpa(qt, kt, vt, is_causal=True)
        go = do.transpose(1, 2)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), go, retain_graph=True), reps=RING_REPS)
    return fwd_ms, bwd_ms


def phase_ring() -> dict:
    """rdma_ring_attention's three kernels against their plain versions,
    then the full-width shape with times and bounds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst = {"out": 0.0, "out_rel_l2": 0.0, "lse": 0.0, "dq": 0.0,
             "dk": 0.0, "dv": 0.0, "dq_abs": 0.0, "dk_abs": 0.0,
             "dv_abs": 0.0}

    def note(res):
        for key in ("out", "out_rel_l2", "lse"):
            worst[key] = max(worst[key], res[key])
        for g in ("dq", "dk", "dv"):
            worst[g] = max(worst[g], res[g]["rel_l2"])
            worst[g + "_abs"] = max(worst[g + "_abs"], res[g]["max_abs"])

    t0 = time.monotonic()
    cases = 0
    for n in RING_NS:
        for b in RING_BS:
            for s in RING_SS:
                for h, kh in RING_HEADS:
                    for d in RING_DS:
                        note(_ring_case((n, b, s, h, kh, d), gen, dev))
                        cases += 1
    log(f"  {cases} small shapes (n {RING_NS}, B {RING_BS}, S {RING_SS}, "
        f"(H, KH) {RING_HEADS}, D {RING_DS}) within bounds in "
        f"{time.monotonic() - t0:.1f}s: worst err_out {worst['out']:.3e} "
        f"(rel_l2 {worst['out_rel_l2']:.3e}) err_lse {worst['lse']:.3e}, "
        f"rel_l2 dq {worst['dq']:.3e} dk "
        f"{worst['dk']:.3e} dv {worst['dv']:.3e}")

    # A one-rank ring is flash attention (the JAX package's own route).
    x = torch.randn(1, 512, 8, 128, generator=gen, device=dev).bfloat16()
    xg = x.clone().requires_grad_()
    before, flash_before = _ring_counts(), _counts()
    got = rra.rdma_ring_attention(xg, xg, xg, "seq", Mesh([dev], ("seq",)))
    got.backward(torch.ones_like(got))
    torch.cuda.synchronize()
    flash_moved = tuple(a - c for a, c in zip(_counts(), flash_before))
    if _ring_counts() != before or flash_moved != (1, 1, 1):
        raise RuntimeError(f"a one-rank ring launched ring kernels or not "
                           f"the flash kernels once each ({flash_moved})")
    if not torch.equal(got, fa.flash_attention(x, x, x, True)):
        raise RuntimeError("a one-rank ring differs from flash_attention")
    log(f"  one-rank ring: flash kernels launched {flash_moved}, ring "
        "kernels 0; equal to flash_attention")

    t0 = time.monotonic()
    full = _ring_case(RING_FULL, gen, dev, full=True)
    note(full)
    n, b, s_glob, h, kh, d = RING_FULL
    q, k, v, do, out, lse = full.pop("tensors")
    log(f"  main path at {_ring_name(*RING_FULL)}: op forward and backward "
        f"launched {full['launches']} (fwd, dq, dk/dv); checked in "
        f"{time.monotonic() - t0:.1f}s")
    qs, ks, vs, dos, lses = (rra._shards(x_, n) for x_ in (q, k, v, do, lse))
    deltas = rra._shards(fa._bwd_delta(do, out, None), n)
    pairs = b * s_glob * (s_glob + 1) // 2 * h
    io = 2 * (q.numel() + k.numel() + v.numel())  # bf16 q, k, v
    stats = 4 * lse.numel()
    rows = {}
    launch = {
        "rdma_fwd": lambda me: rra._fwd_rank_cuda(me, qs, ks, vs),
        "rdma_bwd_dq": lambda me: rra._dq_rank_cuda(
            me, qs, ks, vs, dos, lses, deltas),
        "rdma_bwd_dkv": lambda me: rra._dkv_rank_cuda(
            me, qs, ks, vs, dos, lses, deltas),
    }
    bounds = {
        # out and lse written; do, lse, delta read and one gradient set
        # written by each backward kernel.
        "rdma_fwd": _bound(4 * d * pairs, io + 2 * out.numel() + stats),
        "rdma_bwd_dq": _bound(6 * d * pairs,
                              io + 2 * do.numel() + 2 * stats
                              + 2 * q.numel()),
        "rdma_bwd_dkv": _bound(8 * d * pairs,
                               io + 2 * do.numel() + 2 * stats
                               + 2 * (k.numel() + v.numel())),
    }
    for name, fn in launch.items():
        ms = time_ms(lambda: [fn(me) for me in range(n)], reps=RING_REPS)
        by_rank = [time_ms(lambda: fn(me), reps=RING_REPS)
                   for me in range(n)]
        rows[name] = {"ms": ms, "ms_by_rank": by_rank,
                      "bound_ms": bounds[name][0],
                      "bound_by": bounds[name][1]}
    rows["rdma_fwd"]["plain_ms"] = time_ms(
        lambda: _by_kv_heads(rra._rdma_fwd_plain, n, kh, h // kh, q, k, v),
        reps=1)
    plain_bwd_ms = time_ms(lambda: _by_kv_heads(
        rra._rdma_bwd_plain, n, kh, h // kh, q, k, v, out, lse, do), reps=1)
    sdpa_fwd_ms, sdpa_bwd_ms = _sdpa_global_ms(q, k, v, do)
    rows["rdma_fwd"]["library_ms"] = sdpa_fwd_ms
    for name in ("rdma_bwd_dq", "rdma_bwd_dkv"):
        rows[name]["plain_ms"] = plain_bwd_ms
        rows[name]["library_ms"] = sdpa_bwd_ms
    causal = fa.MaskSpec("causal")
    fout, flse = fa.flash_attention_lse(q, k, v)
    fdelta = fa._bwd_delta(do, fout, None)
    flash = {
        "rdma_fwd": time_ms(lambda: fa.flash_attention_lse(q, k, v),
                            reps=RING_REPS),
        "rdma_bwd_dq": time_ms(lambda: fa._flash_bwd_dq_cuda(
            q, k, v, do, flse, fdelta, causal), reps=RING_REPS),
        "rdma_bwd_dkv": time_ms(lambda: fa._flash_bwd_dkv_cuda(
            q, k, v, do, flse, fdelta, causal), reps=RING_REPS),
    }
    shape = _ring_name(*RING_FULL)
    for i, (name, row) in enumerate(rows.items()):
        row.update(flash_global_ms=flash[name], launches=full["launches"][i],
                   shape=shape)
        log(f"  {name}: ms {row['ms']:.3f} (by rank "
            + ", ".join(f"{x:.3f}" for x in row["ms_by_rank"])
            + f") bound_ms {row['bound_ms']:.3f} ({row['bound_by']}, "
            f"{row['bound_ms'] / row['ms']:.1%}) plain_ms "
            f"{row['plain_ms']:.1f} library_ms (SDPA "
            f"{'fwd' if name == 'rdma_fwd' else 'bwd'}) "
            f"{row['library_ms']:.3f} flash kernel over the whole sequence "
            f"{row['flash_global_ms']:.3f}")
    del qs, ks, vs, dos, lses, deltas, q, k, v, do, out, lse, fout, flse
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "worst": worst}


def phase_model() -> None:
    """llama3_8b logits, attention through the kernel vs the plain version."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    t0 = time.monotonic()
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED)
    torch.cuda.synchronize()
    log(f"  {MODEL} built in {time.monotonic() - t0:.1f}s: "
        f"{cfg.num_params / 1e9:.2f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 512))).to(DEVICE)
    with torch.inference_mode():
        before = fa.flash_fwd_launches
        model(tokens)
        if fa.flash_fwd_launches - before != cfg.num_layers:
            raise RuntimeError("the forward did not run the kernel per layer")
        real = llama_mod.flash_attention

        def plain(q, k, v, causal=True, block_q=512, block_kv=512,
                  segment_ids=None, mask=None):
            return fa._flash_fwd_plain(q, k, v, fa._norm_mask(causal, mask),
                                       segment_ids)[0]

        def naive(q, k, v, causal=True, block_q=512, block_kv=512,
                  segment_ids=None, mask=None):
            return naive_attention(q, k, v, causal=causal, mask=mask,
                                   segment_ids=segment_ids)

        first_layer = []  # layer 0's output per run, kernel run first
        hook = model.layers[0].register_forward_hook(
            lambda mod, args, out: first_layer.append(out.float()))
        try:
            kernel_logits = model(tokens).float()
            llama_mod.flash_attention = plain
            plain_logits = model(tokens).float()
            llama_mod.flash_attention = naive
            naive_logits = model(tokens).float()
        finally:
            llama_mod.flash_attention = real
            hook.remove()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(kernel_logits).all()):
        raise RuntimeError("non-finite logits")

    def rel_l2(a):
        return ((a - plain_logits).norm() / plain_logits.norm()).item()

    rel, floor = rel_l2(kernel_logits), rel_l2(naive_logits)
    k0, p0, n0 = first_layer
    log(f"  layer 0 output vs plain attention: kernel rel_l2 "
        f"{((k0 - p0).norm() / p0.norm()).item():.3e}, naive_attention "
        f"rel_l2 {((n0 - p0).norm() / p0.norm()).item():.3e}")
    top = plain_logits.argmax(-1)
    agree = (kernel_logits.argmax(-1) == top).float().mean().item()
    naive_agree = (naive_logits.argmax(-1) == top).float().mean().item()
    ok = (rel <= LOGITS_VS_NAIVE * floor and rel <= LOGITS_REL_L2_MAX
          and agree >= ARGMAX_AGREE_MIN)
    log(f"  logits [1, 512, {cfg.vocab_size}] vs plain attention: kernel "
        f"rel_l2 {rel:.3e}, naive_attention rel_l2 {floor:.3e} (bound "
        f"{LOGITS_VS_NAIVE} x naive, <= {LOGITS_REL_L2_MAX}); argmax "
        f"agreement {agree:.4f} (bound {ARGMAX_AGREE_MIN}; naive "
        f"{naive_agree:.4f}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("8B logits through the kernel disagree with the "
                           "plain version")
    del model, kernel_logits, plain_logits, naive_logits, first_layer
    torch.cuda.empty_cache()


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _serving(bundle: str, generative: dict | None = None, **spec):
    """(Re)write the llama3_8b bundle at `bundle` with phase 4's generative
    block updated by `generative` and the extra bundle keys `spec`, load it
    behind the port's HTTP server, and yield the server's base URL. The
    server and its model are freed on exit."""
    gc.collect()
    torch.cuda.empty_cache()
    export_for_serving(bundle, model=MODEL, model_kwargs=MODEL_KWARGS,
                       seed=SEED, extra={
                           "generative": {**GENERATIVE, **(generative or {})},
                           **spec})
    server = ModelServer()
    t0 = time.monotonic()
    server.load(bundle, name=MODEL, device=DEVICE)
    port = server.start_background(0)
    base = f"http://127.0.0.1:{port}"
    log(f"  server up in {time.monotonic() - t0:.1f}s on port {port}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    try:
        with urllib.request.urlopen(base + "/v2/health/ready",
                                    timeout=30) as r:
            if json.loads(r.read()) != {"ready": True}:
                raise RuntimeError("server not ready")
        yield base, server
    finally:
        server.stop()
        del server
        gc.collect()
        torch.cuda.empty_cache()


def _metadata(base: str) -> dict:
    with urllib.request.urlopen(f"{base}/v2/models/{MODEL}", timeout=30) as r:
        return json.loads(r.read())


def _bodies(vocab: int) -> list:
    """Phase 4's six requests: prompts of PROMPT_LENS tokens, 32 out, the
    third sampled (temperature 0.8, top_k 50), the rest greedy."""
    rng = np.random.default_rng(SEED + 1)
    bodies = [{"input_ids": rng.integers(0, vocab, n).tolist(),
               "max_tokens": MAX_TOKENS} for n in PROMPT_LENS]
    bodies[2].update(temperature=0.8, top_k=50)
    return bodies


def _concurrent(base: str, bodies: list) -> dict:
    """The requests at once, peak memory over their window (reset at its
    start), the engine's counters after it, and the most pool blocks in
    use that the metadata showed while they ran (None on a flat cache)."""
    url = f"{base}/v1/models/{MODEL}:generate"
    results: list = [None] * len(bodies)
    blocks_used = []
    done = threading.Event()

    def run(i):
        try:
            results[i] = _post(url, bodies[i])
        except Exception as e:  # reported below as a failed request
            results[i] = e

    def poll():
        while not done.wait(0.05):
            info = _metadata(base).get("paged_kv")
            if info:
                blocks_used.append(info["blocks_used"])

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    poller = threading.Thread(target=poll)
    poller.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    done.set()
    poller.join(timeout=30)
    # Engine counters of the concurrent batch alone.
    md = _metadata(base)
    for i, res in enumerate(results):
        if not isinstance(res, dict):
            raise RuntimeError(f"request {i} failed: {res!r}")
    return {"results": results, "wall": wall, "peak": peak,
            "stats": md["stats"], "metadata": md,
            "max_blocks_used": max(blocks_used) if blocks_used else None}


def _check_outputs(results: list, vocab: int) -> None:
    for i, res in enumerate(results):
        ids = res["output_ids"]
        if len(ids) != MAX_TOKENS or not all(0 <= t < vocab for t in ids):
            raise RuntimeError(f"request {i}: bad output ids {ids}")
        log(f"  request {i}: prompt {PROMPT_LENS[i]:5d} tokens, "
            f"{res['num_output_tokens']} out, latency "
            f"{res['latency_s']:.3f}s"
            + (" (temperature 0.8, top_k 50)" if i == 2 else ""))


def _decode_line(stats: dict, weight_bytes: float) -> float:
    """Log the engine's decode rate and ms per 4-row step; returns the
    latter."""
    steps = stats["decode_dispatches"] * CHUNK
    step_ms = stats["decode_seconds"] / steps * 1e3
    log(f"  decode: engine {stats['decode_tokens']} tokens in "
        f"{stats['decode_seconds']:.3f}s = "
        f"{stats['decode_tokens'] / stats['decode_seconds']:.1f} tok/s "
        f"(chunk tokens of active rows, slots 4); "
        f"{stats['decode_dispatches']} chunks x {CHUNK} steps, "
        f"{step_ms:.2f} ms per 4-row step (bound "
        f"{weight_bytes / PEAK_BYTES * 1e3:.2f} ms: the weights read once "
        "per step)")
    return step_ms


#: The engine counters of the overlapped loop, logged by every serving
#: phase.
PIPELINE_COUNTERS = ("decode_fetch_overlapped", "decode_fetch_blocking",
                     "admit_overlap", "decode_dead_slot_chunks",
                     "decode_wasted_tokens", "host_stall_seconds")


def _pipeline_line(stats: dict, what: str) -> None:
    """Log the overlap counters; fail unless some fetch overlapped a chunk
    in flight (the loop did not re-serialise)."""
    log(f"  pipeline ({what}): " + ", ".join(
        f"{k} {stats[k]:.3f}" if isinstance(stats[k], float)
        else f"{k} {stats[k]}" for k in PIPELINE_COUNTERS))
    if stats["decode_fetch_overlapped"] <= 0:
        raise RuntimeError("no decode fetch overlapped a chunk in flight: "
                           "the depth-2 loop re-serialised")


def _step_ms(before: dict, after: dict) -> float:
    """Host-inclusive engine ms per decode step between two stats
    snapshots."""
    steps = (after["decode_dispatches"] - before["decode_dispatches"]) * CHUNK
    return (after["decode_seconds"] - before["decode_seconds"]) / steps * 1e3


def _alone_at_depth1(bundle: str, generative: dict, body: dict,
                     **spec) -> tuple:
    """(response, host-inclusive ms per step) of `body` alone on a server
    of the same bundle at pipeline_depth 1."""
    with _serving(bundle, {**generative, "pipeline_depth": 1},
                  **spec) as (base, _):
        out = _post(f"{base}/v1/models/{MODEL}:generate", body)
        ms = _step_ms({"decode_dispatches": 0, "decode_seconds": 0.0},
                      _metadata(base)["stats"])
    return out, ms


def _depth_line(depth2: dict, depth2_ms: float, depth1: dict,
                depth1_ms: float) -> None:
    """Log the longest prompt's step time at both depths; fail unless the
    greedy ids are equal."""
    same = depth1["output_ids"] == depth2["output_ids"]
    log(f"  longest prompt alone: pipeline_depth 1 on a second server "
        f"{'gives the same' if same else 'DIFFERS from the'} greedy ids "
        f"as depth 2; ms per step (host-inclusive, 1 row): depth 2 "
        f"{depth2_ms:.2f}, depth 1 {depth1_ms:.2f}")
    if not same:
        raise RuntimeError("depth-1 greedy ids differ from depth 2")


def phase_serving(bundle: str) -> dict:
    """The port's main path: bundle -> server -> concurrent :generate.
    Returns the kernel launches and the numbers later phases compare
    with."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    bodies = _bodies(cfg.vocab_size)
    with _serving(bundle) as (base, server):
        fa.flash_fwd_launches = 0
        run = _concurrent(base, bodies)
        # The longest prompt again, alone: it decodes at the same cache
        # bucket (4096) either way, so greedy ids must repeat exactly.
        again = _post(f"{base}/v1/models/{MODEL}:generate", bodies[-1])
        launches = fa.flash_fwd_launches
        alone_ms = _step_ms(run["stats"], _metadata(base)["stats"])
        depth = run["metadata"]["pipeline_depth"]
        prof = _profile_decode(server)
    results, stats, wall = run["results"], run["stats"], run["wall"]
    _check_outputs(results, cfg.vocab_size)
    if again["output_ids"] != results[-1]["output_ids"]:
        raise RuntimeError("repeated greedy prompt gave other ids")
    if depth != 2:
        raise RuntimeError(f"the bundle served at pipeline_depth {depth}, "
                           "not the default 2")
    _pipeline_line(stats, "6 concurrent requests")
    sync, sync_ms = _alone_at_depth1(bundle, {}, bodies[-1])
    _depth_line(again, alone_ms, sync, sync_ms)
    prefills = len(bodies) + 1  # each request's first chunk, + repeat
    expect = cfg.num_layers * prefills
    prefill_s = wall - stats["decode_seconds"]
    log(f"  6 concurrent requests in {wall:.3f}s; repeat greedy ids "
        f"identical; peak memory {run['peak'] / 2**30:.2f} GiB; admission "
        f"and prefill {prefill_s:.3f}s of the {wall:.3f}s")
    step_ms = _decode_line(stats, cfg.num_params * 2)  # bf16 weights
    log(f"  flash_fwd launches {launches} (expected {cfg.num_layers} x "
        f"{prefills} first-chunk prefills = {expect})")
    if launches != expect:
        raise RuntimeError("prefill did not go through the kernel")
    return {"launches": launches, "peak": run["peak"], "step_ms": step_ms,
            "tok_s": stats["decode_tokens"] / stats["decode_seconds"],
            "repeat": again, "profile": prof, "alone_ms": alone_ms,
            "sync_alone_ms": sync_ms, "prefill_s": prefill_s}


def phase_paged(bundle: str, flat: dict) -> dict:
    """Phase 4's bundle on a paged KV pool: the longest greedy prompt alone
    gives the ids of phase 4's flat repeat (the gathered view holds the
    flat cache's bytes, so the arithmetic is the same)."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    body = _bodies(cfg.vocab_size)[-1]
    with _serving(bundle, {"kv_block_size": KV_BLOCK_SIZE}) as (base, _):
        torch.cuda.reset_peak_memory_stats()
        fa.flash_fwd_launches = 0
        out = _post(f"{base}/v1/models/{MODEL}:generate", body)
        launches = fa.flash_fwd_launches
        peak = torch.cuda.max_memory_allocated()
        md = _metadata(base)
        info = md["paged_kv"]
    _pipeline_line(md["stats"], "the longest prompt alone")
    step_ms = _step_ms({"decode_dispatches": 0, "decode_seconds": 0.0},
                       md["stats"])
    sync, sync_ms = _alone_at_depth1(
        bundle, {"kv_block_size": KV_BLOCK_SIZE}, body)
    _depth_line(out, step_ms, sync, sync_ms)
    same = out["output_ids"] == flat["repeat"]["output_ids"]
    log(f"  longest prompt ({len(body['input_ids'])} tokens) alone: greedy "
        f"ids {'identical to' if same else 'DIFFER from'} phase 4's flat "
        f"repeat; latency {out['latency_s']:.3f}s, {step_ms:.2f} ms per "
        f"step (host-inclusive, 1 row); {launches} flash_fwd "
        f"launches; peak {peak / 2**30:.2f} GiB; pool {info['blocks']} "
        f"blocks of {info['block_size']} rows, after it "
        f"{info['blocks_used']} used, {info['blocks_free']} free")
    if not same:
        raise RuntimeError("paged greedy ids differ from flat")
    if info["blocks_used"] != 0 or launches != cfg.num_layers:
        raise RuntimeError("paged request leaked blocks or skipped the "
                           "flash kernel")
    return {"out": out, "peak": peak, "step_ms": step_ms,
            "sync_ms": sync_ms}


def phase_quant(bundle: str, flat: dict, paged: dict) -> dict:
    """int8 weights and an int8 paged KV pool behind the server: phase 4's
    six requests, prefill through the flash kernel, no int8_matmul call,
    and a peak at least QUANT_PEAK_SAVING_MIN_GIB under phase 4's."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    bodies = _bodies(cfg.vocab_size)
    gen = {"kv_block_size": KV_BLOCK_SIZE, "kv_quant": "int8"}
    with _serving(bundle, gen, quantize="int8") as (base, server):
        fa.flash_fwd_launches = 0
        qmm.qmm_launches = 0
        w8.w8a16_launches = w8.w8a16_wgmma_launches = 0
        run = _concurrent(base, bodies)
        again = _post(f"{base}/v1/models/{MODEL}:generate", bodies[-1])
        launches, qmm_calls = fa.flash_fwd_launches, qmm.qmm_launches
        w8_calls, w8_wgmma = w8.w8a16_launches, w8.w8a16_wgmma_launches
        after = _metadata(base)
        qbytes = run["metadata"]["quantize"]
        copies = _int8_weight_copies(server)
        prof = _profile_decode(server, "w8a16_decode_kernel")
    in_situ = None
    if prof:
        log(f"  int8 decode step: device busy {prof['busy_ms'] / CHUNK:.2f} ms"
            f" (before the streamed decode kernel: {W8A16_EARLIER_BUSY_MS:.2f}"
            f" ms), unprofiled wall {prof['unprofiled_wall_ms'] / CHUNK:.2f} "
            f"ms: host-bound")
        in_situ = _decode_in_situ(prof.pop("ordered_ms"))
    results, stats, total = run["results"], run["stats"], after["stats"]
    _check_outputs(results, cfg.vocab_size)
    _pipeline_line(stats, "6 concurrent requests")
    alone_ms = _step_ms(stats, total)
    sync, sync_ms = _alone_at_depth1(bundle, gen, bodies[-1],
                                     quantize="int8")
    _depth_line(again, alone_ms, sync, sync_ms)
    if after["paged_kv"]["blocks_used"] != 0:
        raise RuntimeError(f"{after['paged_kv']['blocks_used']} pool blocks "
                           "still in use after every request finished")
    # Every model forward runs 7 projections a layer through the kernel,
    # and every unembedding one more: each decode step's, and those of each
    # admission that samples: its first chunk (prefill) and, for a prompt
    # longer than the largest bucket, its last (extend).
    big = max(GENERATIVE["prefill_buckets"])
    admitted = list(PROMPT_LENS) + [PROMPT_LENS[-1]]  # + the repeat
    if total["requests"] != len(admitted):
        raise RuntimeError(f"{total['requests']} admissions, expected "
                           f"{len(admitted)}")
    samples = sum(1 + (n > big) for n in admitted)
    steps = total["decode_dispatches"] * CHUNK
    w8_expect = (7 * cfg.num_layers * (total["prefill_chunks"] + steps)
                 + samples + steps)
    log(f"  w8a16 launches {w8_calls} (expected 7 x {cfg.num_layers} x "
        f"({total['prefill_chunks']} prefill chunks + {steps} decode steps)"
        f" + {samples} admission + {steps} decode unembeddings = "
        f"{w8_expect}); int8-weight-shaped copies in a decode chunk: "
        f"{copies}")
    if w8_calls != w8_expect:
        raise RuntimeError("int8 serving did not run every projection and "
                           "unembedding through the W8A16 kernel")
    # Every prefill chunk (a first chunk or a continuation, at least 128
    # tokens) runs its 7 projections a layer through the wgmma kernel; its
    # unembedding (one row) and every decode step (4 rows) take the decode
    # kernel.
    wgmma_expect = 7 * cfg.num_layers * total["prefill_chunks"]
    log(f"  w8a16 wgmma launches {w8_wgmma} (expected 7 x "
        f"{cfg.num_layers} x {total['prefill_chunks']} prefill chunks = "
        f"{wgmma_expect})")
    if w8_wgmma != wgmma_expect:
        raise RuntimeError("int8 prefill did not run every projection "
                           "through the W8A16 wgmma kernel")
    if copies:
        raise RuntimeError(f"a decode chunk copied int8 weights: {copies}")
    expect = cfg.num_layers * (len(bodies) + 1)
    saving = (flat["peak"] - run["peak"]) / 2**30
    prefill_s = run["wall"] - stats["decode_seconds"]
    log(f"  admission and prefill {prefill_s:.3f}s of the {run['wall']:.3f}s "
        f"(phase 4, bf16 weights: {flat['prefill_s']:.3f}s)")
    log(f"  6 concurrent requests in {run['wall']:.3f}s; pool blocks in use "
        f"at most {run['max_blocks_used']} of "
        f"{run['metadata']['paged_kv']['blocks']}; weights "
        f"{qbytes['quantized'] / 2**30:.2f} GiB int8 + scales (bf16 "
        f"{qbytes['full'] / 2**30:.2f} GiB)")
    log(f"  peak memory {run['peak'] / 2**30:.2f} GiB vs phase 4's "
        f"{flat['peak'] / 2**30:.2f} GiB: {saving:.2f} GiB less (at least "
        f"{QUANT_PEAK_SAVING_MIN_GIB})")
    step_ms = _decode_line(stats, qbytes["quantized"])
    log(f"  vs phase 4 (bf16, flat): {flat['tok_s']:.1f} tok/s, "
        f"{flat['step_ms']:.2f} ms per 4-row step")
    log(f"  flash_fwd launches {launches} (expected {expect}); int8_matmul "
        f"launches {qmm_calls} (weight-only serving: expected 0)")
    if launches != expect:
        raise RuntimeError("quantized prefill did not go through the kernel")
    if qmm_calls:
        raise RuntimeError("weight-only serving called int8_matmul")
    if saving < QUANT_PEAK_SAVING_MIN_GIB:
        raise RuntimeError(f"quantized serving saves only {saving:.2f} GiB")
    # Greedy drift of the int8 KV pool, reported, not gated. Against 4b
    # (bf16 weights and KV) the weights differ too; against the same int8
    # weights on a bf16 paged pool only the KV encoding does.
    agree_4b, _ = _greedy_drift(again, paged["out"])
    with _serving(bundle, {"kv_block_size": KV_BLOCK_SIZE},
                  quantize="int8") as (base, _):
        bf16_kv = _post(f"{base}/v1/models/{MODEL}:generate", bodies[-1])
    agree, drift = _greedy_drift(again, bf16_kv)
    log(f"  longest prompt alone, int8 KV: first {agree_4b} of {MAX_TOKENS} "
        f"greedy ids agree with 4b (bf16 weights and KV); against the same "
        f"int8 weights on a bf16 paged pool, the first {agree} agree, max "
        f"|logprob drift| over them {drift:.4f} (reported, not gated)")
    model_gate = phase_quant_model()
    return {"peak": run["peak"], "step_ms": step_ms,
            "tok_s": stats["decode_tokens"] / stats["decode_seconds"],
            "saving_gib": saving, "quantized_bytes": qbytes,
            "launches": launches, "w8a16_launches": w8_calls,
            "w8a16_wgmma_launches": w8_wgmma, "prefill_s": prefill_s,
            "alone_ms": alone_ms, "sync_alone_ms": sync_ms,
            "logprob_drift": drift, "profile": prof,
            "w8a16_in_situ": in_situ, **model_gate}


def _decode_in_situ(ordered_ms: list) -> dict | None:
    """The decode kernel's device ms by shape inside a decode chunk, read
    from its launches in order (W8A16_STEP_ORDER a layer, then the
    unembedding): the mean of each shape and the sum a step. None (and
    said so) when the launches are not whole steps."""
    per = sum(W8A16_STEP.values())
    if not ordered_ms or len(ordered_ms) % per:
        log(f"  decode kernel in situ: {len(ordered_ms)} launches profiled, "
            f"not whole steps of {per}: per-shape times not measured")
        return None
    steps = len(ordered_ms) // per
    by = {}
    for i, ms in enumerate(ordered_ms):
        pos = i % per
        kind = ("unembedding" if pos == per - 1
                else W8A16_STEP_ORDER[pos % len(W8A16_STEP_ORDER)])
        by.setdefault(kind, []).append(ms)
    res = {"step_ms": sum(ordered_ms) / steps,
           "by_shape_ms": {k: statistics.fmean(v) for k, v in by.items()}}
    log(f"  decode kernel in situ ({steps} steps, profiled): "
        f"{res['step_ms']:.4f} ms a step; mean ms a launch: " + ", ".join(
            f"{k} {v:.4f}" for k, v in res["by_shape_ms"].items()))
    return res


def _greedy_drift(a: dict, b: dict) -> tuple:
    """(how many leading greedy ids two responses share, the largest
    |logprob difference| over those)."""
    n = 0
    while (n < len(a["output_ids"])
           and a["output_ids"][n] == b["output_ids"][n]):
        n += 1
    drift = max((abs(x - y) for x, y in zip(a["output_logprobs"][:n],
                                             b["output_logprobs"][:n])),
                default=0.0)
    return n, drift


@torch.no_grad()
def _dequantized_copy(qmodel, cfg):
    """A bf16 Llama holding qmodel's int8 codes dequantized (q * scale,
    rounded to bf16): the port's counterpart of the JAX legacy dequant."""
    deq = llama_mod.Llama(cfg, device=DEVICE)
    qmods = dict(qmodel.named_modules())
    for name, mod in deq.named_modules():
        src = qmods.get(name)
        if isinstance(mod, llama_mod.Dense):
            for i in range(0, mod.weight.shape[0], 4096):
                mod.weight[i:i + 4096] = (src.q[i:i + 4096].float()
                                          * src.scale[i:i + 4096, None])
    for i in range(0, cfg.vocab_size, 4096):
        deq.embed[i:i + 4096] = (qmodel.embed.q[i:i + 4096].float()
                                 * qmodel.embed.scale[i:i + 4096, None])
    for name, p in qmodel.named_parameters():  # the fp32 norm scales
        deq.get_parameter(name).copy_(p)
    return deq


def phase_quant_model() -> dict:
    """The int8 model's logits on a QUANT_PROMPT-token prompt against a bf16
    model loaded with the same codes dequantized (gated), and against the
    original bf16 weights (reported)."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    gc.collect()
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, QUANT_PROMPT))).to(DEVICE)
    with torch.inference_mode():
        model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED)
        orig = model(tokens).float()
        squant.quantize_model(model)
        gc.collect()
        torch.cuda.empty_cache()
        int8 = model(tokens).float()
        deq = _dequantized_copy(model, cfg)
        ref = deq(tokens).float()
    del model, deq

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    rel, rel_orig = rel_l2(int8, ref), rel_l2(int8, orig)
    agree = (int8.argmax(-1) == ref.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(int8).all())
    ok = (finite and rel <= QUANT_LOGITS_REL_L2_MAX
          and agree >= QUANT_ARGMAX_AGREE_MIN)
    log(f"  int8 logits [1, {QUANT_PROMPT}, {cfg.vocab_size}] vs the same "
        f"codes dequantized to bf16: rel_l2 {rel:.3e} (bound "
        f"{QUANT_LOGITS_REL_L2_MAX}), argmax agreement {agree:.4f} (bound "
        f"{QUANT_ARGMAX_AGREE_MIN}) {'OK' if ok else 'FAIL'}; vs the original "
        f"bf16 weights (reported): rel_l2 {rel_orig:.3e}, dequantized copy "
        f"{rel_l2(ref, orig):.3e}")
    del int8, ref, orig
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError("int8 logits disagree with the dequantized model")
    return {"logits_rel_l2": rel, "logits_rel_l2_orig": rel_orig}


def _counts() -> tuple:
    return (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches)


def _reset_counts() -> None:
    fa.flash_fwd_launches = 0
    fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    fa.flash_simt_fwd_launches = 0
    fa.flash_simt_fwd_mma_launches = 0
    fa.flash_simt_bwd_dq_launches = 0
    fa.flash_simt_bwd_dkv_launches = 0


class _StepTap(io.TextIOBase):
    """The trainer's stdout: forwards every line and, at each per-step
    metrics line, records it with the kernel launches since the last (an
    eval at that step's boundary included); eval lines are kept apart."""

    def __init__(self, out):
        self.out, self.buf, self.last = out, "", _counts()
        self.steps, self.evals = [], []

    def write(self, text):
        self.out.write(text)
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or "event" in rec:
                continue
            if "eval_loss" in rec:
                self.evals.append(rec)
            elif "loss" in rec:
                now = _counts()
                self.steps.append((rec, tuple(
                    a - b for a, b in zip(now, self.last))))
                self.last = now
        return len(text)

    def flush(self):
        self.out.flush()


#: Kernel families of a profile, matched in order on the kernel's name.
_FAMILIES = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("w8a16", ("w8a16",)),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                         "sm90")),
    ("copies and casts", ("direct_copy", "copy_kernel")),
)


def _profile(label: str, fn, ordered: str | None = None) -> dict | None:
    """Device time of one call of `fn` by kernel family (torch.profiler):
    wall, device-busy time and idle share, the families and the top
    kernels; with `ordered`, also the device ms of each launch of the
    kernels whose name holds it, in launch order. Returns None when the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    families = {name: 0.0 for name, _ in _FAMILIES}
    families["other"] = 0.0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    for evt in kernels:
        name = evt.key.lower()
        fam = next((f for f, keys in _FAMILIES
                    if any(k in name for k in keys)), "other")
        families[fam] += evt.self_device_time_total / 1e3
    busy = sum(families.values())
    if busy <= 0:
        log(f"  profiler saw no device time in {label}: breakdown not "
            "measured")
        return None
    log(f"  profiled {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / wall:.1%}; idle share {1 - busy / wall:.1%})")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        if ms:
            log(f"    {fam:18s} {ms:9.2f} ms  {ms / busy:6.1%}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for evt in kernels[:8]:
        log(f"    top: {evt.self_device_time_total / 1e3:8.2f} ms "
            f"x{evt.count:<5d} {evt.key[:90]}")
    rec = {"wall_ms": wall, "busy_ms": busy, "families": families}
    if ordered:
        mine = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and ordered in e.name),
                      key=lambda e: e.time_range.start)
        rec["ordered_ms"] = [e.time_range.elapsed_us() / 1e3 for e in mine]
    return rec


def _profile_step(step_fn, state, batch) -> None:
    """Device time of one train step by kernel family."""
    _profile("step", lambda: step_fn(state, batch))


def _decode_chunk(server: ModelServer):
    """(one decode chunk of the idle engine as a zero-argument call: CHUNK
    steps, every slot at position 3000, greedy, through the engine's own
    decode function; its rows, its bucket). Paged engines get tables over
    blocks 1.. (the pool is idle: nothing lives there)."""
    engine = server.models[MODEL].engine
    dev, n = engine.device, engine.n_slots
    pos = PROMPT_LENS[-1]
    bucket = next(b for b in engine.decode_buckets if b >= pos + CHUNK)
    args = [torch.ones(n, dtype=torch.long, device=dev),
            torch.full((n,), pos, dtype=torch.long, device=dev),
            torch.zeros(n, device=dev),
            torch.zeros(n, dtype=torch.long, device=dev),
            torch.ones(n, device=dev)]
    if engine.kv_info() is not None:
        nb = bucket // engine.kv_info()["block_size"]
        args.insert(0, torch.arange(1, 1 + n * nb, device=dev).view(n, nb))
    chunk_fn = engine._decode[(bucket, False)]
    return (lambda: chunk_fn(engine._cache, *args, engine._gen)), n, bucket


class _Int8Copies(TorchDispatchMode):
    """Records the shape of every aten._to_copy of an int8 tensor whose
    shape is one of `shapes`."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.seen = shapes, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func.overloadpacket is torch.ops.aten._to_copy
                and args[0].dtype == torch.int8
                and tuple(args[0].shape) in self.shapes):
            self.seen.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def _int8_weight_copies(server: ModelServer) -> list:
    """Shapes of int8-weight-shaped aten._to_copy calls that one decode
    chunk makes (a weight-sized cast the W8A16 kernel exists to avoid)."""
    model = server.models[MODEL].engine.model
    shapes = {tuple(m.q.shape) for m in model.modules()
              if isinstance(m, squant.Int8Dense)}
    shapes |= {s[::-1] for s in shapes}
    call, _, _ = _decode_chunk(server)
    rec = _Int8Copies(shapes)
    with torch.inference_mode(), rec:
        call()
    torch.cuda.synchronize()
    return rec.seen


def _profile_decode(server: ModelServer,
                    ordered: str | None = None) -> dict | None:
    """One decode chunk (`_decode_chunk`), profiled (`ordered`: see
    `_profile`), and its unprofiled wall time."""
    call, n, bucket = _decode_chunk(server)
    with torch.inference_mode():
        call()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec = _profile(f"decode chunk ({CHUNK} steps, {n} rows, bucket "
                       f"{bucket})", call, ordered)
    if rec:
        # The profiler's own host overhead stretches its wall: the idle
        # share is read against the same chunk run unprofiled just before.
        rec["unprofiled_wall_ms"] = wall
        log(f"    per step: unprofiled wall {wall / CHUNK:.2f} ms, device "
            f"busy {rec['busy_ms'] / CHUNK:.2f} ms (idle share of the "
            f"unprofiled wall {1 - rec['busy_ms'] / wall:.1%})")
    return rec


class _PlainFlash(torch.autograd.Function):
    """flash_attention with the kernels' plain versions in their place:
    _flash_fwd_plain forward, _flash_bwd_plain backward, on the same
    residuals the kernels save (bf16 out, fp32 lse)."""

    @staticmethod
    def forward(ctx, q, k, v, spec, seg):
        out, lse = fa._flash_fwd_plain(q, k, v, spec, seg)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg = ctx.saved_tensors
        grads = fa._flash_bwd_plain(q, k, v, out, lse, do, None, ctx.spec,
                                    seg)
        return (*grads, None, None)


class _KernelFwdPlainBwd(_PlainFlash):
    """The forward kernel, then _flash_bwd_plain on its saved residuals."""

    @staticmethod
    def forward(ctx, q, k, v, spec, seg):
        out, lse = fa._flash_fwd_cuda(q, k, v, spec, seg)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.spec = spec
        return out


def _rel_l2s(grads, refs) -> tuple[list, float]:
    """Per-leaf rel-L2 of grads from refs, and over all leaves together."""
    per, d_sq, r_sq = [], 0.0, 0.0
    for g, r in zip(grads, refs):
        d = (g - r).float().norm().item()
        n = r.float().norm().item()
        per.append(d / max(n, 1e-30))
        d_sq, r_sq = d_sq + d ** 2, r_sq + n ** 2
    return per, math.sqrt(d_sq / r_sq)


def _loss_and_grads(model, batch):
    loss = train_step.cross_entropy_loss(model(batch["inputs"]),
                                         batch["targets"])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach().float().item(), grads


def phase_training() -> dict:
    """The port's training path: llama_1b through the trainer entry point,
    then kernel-vs-plain agreement of one step and the loss falling on a
    repeated batch. Returns the training run's launches and numbers."""
    cfg = registry.model_config(TRAIN_MODEL)
    steps = TRAIN_WARMUP + TRAIN_TIMED
    spec = trainer_mod.TrainJobSpec(
        model=TRAIN_MODEL, dataset="synthetic_lm", batch_size=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, learning_rate=TRAIN_LR, weight_decay=1e-4,
        steps=steps, log_every=1, seed=SEED)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="chip_smoke_train_", suffix=".json",
                                dir=os.path.join(ROOT, "build"))
    with os.fdopen(fd, "w") as fh:
        fh.write(spec.to_json())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  before training: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tap = _StepTap(sys.stdout)
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(tap):
            rc = trainer_mod.main(["--spec", path])
    finally:
        os.remove(path)
    wall = time.monotonic() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or len(tap.steps) != steps:
        raise RuntimeError(f"trainer exited {rc} after {len(tap.steps)} of "
                           f"{steps} steps")
    layers = cfg.num_layers
    expect = (2 * layers, layers, layers)
    for rec, per_step in tap.steps:
        if per_step != expect:
            raise RuntimeError(f"step {rec['step']} launched (fwd, dq, dkv) "
                               f"= {per_step}, expected {expect}")
    losses = [rec["loss"] for rec, _ in tap.steps]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    ln_v = math.log(cfg.vocab_size)
    if not ln_v - LOSS0_BELOW <= losses[0] <= ln_v + LOSS0_ABOVE:
        raise RuntimeError(f"first loss {losses[0]:.4f} outside "
                           f"[{ln_v - LOSS0_BELOW:.2f}, "
                           f"{ln_v + LOSS0_ABOVE:.2f}]")
    timed = [rec for rec, _ in tap.steps[TRAIN_WARMUP:]]
    step_s = sum(r["step_time_s"] for r in timed) / len(timed)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    mfu = 6 * cfg.num_params * tok_s / PEAK_BF16_FLOPS
    wait = (sum(r["data_wait_s"] for r in timed)
            / sum(r["step_time_s"] for r in timed))
    log(f"  trainer: {steps} steps in {wall:.1f}s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (first within "
        f"[{ln_v - LOSS0_BELOW:.2f}, {ln_v + LOSS0_ABOVE:.2f}] of ln V "
        f"{ln_v:.4f})")
    log(f"  launches per step (fwd, dq, dkv) = {expect} in all {steps} "
        f"steps; run totals {launches}")
    log(f"  timed {TRAIN_TIMED} steps: {step_s * 1e3:.2f} ms/step, "
        f"{tok_s:.0f} tok/s, MFU {mfu:.4f} (6*N*tok/s / {PEAK_BF16_FLOPS:.3g}"
        f", N {cfg.num_params}); trainer's own last line: tok/s "
        f"{timed[-1]['tokens_per_sec']:.0f} mfu {timed[-1]['mfu']:.4f}; "
        f"peak memory {peak / 2**30:.2f} GiB; data-wait share {wait:.4%}")
    result = {"launches": launches, "ms_per_step": step_s * 1e3,
              "tok_s": tok_s, "mfu": mfu, "peak_gib": peak / 2**30,
              "data_wait_share": wait}
    gc.collect()
    torch.cuda.empty_cache()

    # The same model outside the trainer: a profile of one step, then one
    # step's gradients through kernel / plain / naive attention.
    tcfg = registry.model_config(TRAIN_MODEL, param_dtype="float32")
    model = llama_mod.Llama(tcfg, device=DEVICE).init_weights(SEED)
    tx = optim.AdamW(TRAIN_LR)
    state = train_step.TrainState(step=0, model=model,
                                  opt_state=tx.init(list(model.parameters())),
                                  tx=tx)
    step_fn = train_step.make_train_step(model)
    rng = np.random.default_rng(SEED + 3)

    def batch_of(rows):
        return {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (rows, TRAIN_SEQ))).to(DEVICE)
            for k in ("inputs", "targets")}

    big = batch_of(TRAIN_BATCH)
    step_fn(state, big)  # warm
    _profile_step(step_fn, state, big)
    del big
    small = batch_of(AGREE_BATCH)
    real = llama_mod.flash_attention

    def plain(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return _PlainFlash.apply(q, k, v, fa._norm_mask(causal, mask),
                                 segment_ids)

    def naive(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return naive_attention(q, k, v, causal=causal, mask=mask,
                               segment_ids=segment_ids)

    def kernel_fwd_plain_bwd(q, k, v, causal=True, block_q=512,
                             block_kv=512, segment_ids=None, mask=None):
        return _KernelFwdPlainBwd.apply(q, k, v, fa._norm_mask(causal, mask),
                                        segment_ids)

    try:
        k_loss, k_grads = _loss_and_grads(model, small)
        llama_mod.flash_attention = plain
        p_loss, p_grads = _loss_and_grads(model, small)
        llama_mod.flash_attention = naive
        n_loss, n_grads = _loss_and_grads(model, small)
        llama_mod.flash_attention = kernel_fwd_plain_bwd
        _, b_grads = _loss_and_grads(model, small)
    finally:
        llama_mod.flash_attention = real
    names = [n for n, _ in model.named_parameters()]
    k_rel, k_glob = _rel_l2s(k_grads, p_grads)
    n_rel, n_glob = _rel_l2s(n_grads, p_grads)
    b_rel, b_glob = _rel_l2s(k_grads, b_grads)
    del k_grads, p_grads, n_grads, b_grads
    worst = max(range(len(names)), key=lambda i: k_rel[i])
    leaf_bound = GRAD_VS_NAIVE * max(n_rel)
    k_dl, n_dl = abs(k_loss - p_loss), abs(n_loss - p_loss)
    checks = {
        "loss": k_dl <= max(LOSS_VS_NAIVE * n_dl,
                            LOSS_REL_FLOOR * abs(p_loss)),
        "all leaves": k_glob <= GRAD_VS_NAIVE * n_glob,
        "each leaf": k_rel[worst] <= leaf_bound,
        "backward kernels alone": b_glob <= BWD_ALONE_VS_NAIVE * n_glob,
    }
    log(f"  one step at batch {AGREE_BATCH} x {TRAIN_SEQ}: loss kernel "
        f"{k_loss:.6f} plain {p_loss:.6f} naive {n_loss:.6f}; gradient "
        f"rel_l2 vs plain over all leaves: kernel {k_glob:.3e}, "
        f"naive_attention {n_glob:.3e} (bound {GRAD_VS_NAIVE} x naive)")
    log(f"  per leaf: kernel worst {k_rel[worst]:.3e} ({names[worst]}), "
        f"naive worst {max(n_rel):.3e} (bound {leaf_bound:.3e}); "
        f"kernel/naive ratio median "
        f"{sorted(k / n for k, n in zip(k_rel, n_rel))[len(names) // 2]:.3f}"
        f" max {max(k / n for k, n in zip(k_rel, n_rel)):.3f}")
    log(f"  backward kernels alone (kernel fwd + kernel bwd vs kernel fwd + "
        f"plain bwd): rel_l2 over all leaves {b_glob:.3e}, worst leaf "
        f"{max(b_rel):.3e} (bound {BWD_ALONE_VS_NAIVE} x naive = "
        f"{BWD_ALONE_VS_NAIVE * n_glob:.3e}); "
        + ", ".join(f"{k} {'OK' if ok else 'FAIL'}"
                    for k, ok in checks.items()))
    if not all(checks.values()):
        raise RuntimeError(f"kernel step disagrees with the plain step: "
                           f"{checks}")
    result.update(grad_rel_l2=k_glob, naive_grad_rel_l2=n_glob,
                  bwd_alone_rel_l2=b_glob)

    losses = []
    for _ in range(REPEAT_STEPS + 1):
        state, metrics = step_fn(state, small)
        losses.append(float(metrics["loss"]))
    drop = losses[0] - losses[-1]
    log(f"  repeated batch, {REPEAT_STEPS} updates: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; drop {drop:.4f} "
        f"(at least {LOSS_DROP_MIN}) {'OK' if drop >= LOSS_DROP_MIN else 'FAIL'}")
    if not drop >= LOSS_DROP_MIN:
        raise RuntimeError("the loss did not fall on a repeated batch")
    # Last: it moves the weights (zero gradients still decay and carry
    # momentum).
    params = list(model.parameters())
    grads = [torch.zeros_like(p) for p in params]
    opt_ms = time_ms(lambda: tx.update(params, grads, state.opt_state),
                     reps=3)
    log(f"  optimizer update alone (AdamW over {len(params)} fp32 leaves): "
        f"{opt_ms:.2f} ms (bound "
        f"{28 * cfg.num_params / PEAK_BYTES * 1e3:.2f} ms: read p, g, mu, "
        "nu and write p, mu, nu once, fp32)")
    result["optimizer_ms"] = opt_ms
    del model, state, step_fn, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _write_corpus(path: str, n_tokens: int, rng, vocab: int) -> int:
    """Documents of JOB_DOC_LENS tokens over the vocabulary, each ending in
    eos 0 (no 0 inside), until n_tokens; returns the document count."""
    docs, total = [], 0
    while total < n_tokens:
        doc = rng.integers(1, vocab, int(rng.integers(*JOB_DOC_LENS)),
                           dtype=np.int32)
        doc[-1] = 0
        docs.append(doc)
        total += len(doc)
    np.save(path, np.concatenate(docs))
    return len(docs)


def _job_spec(corpus: str, **kw) -> trainer_mod.TrainJobSpec:
    base = dict(model=TRAIN_MODEL, dataset="packed_lm",
                dataset_kwargs={"path": corpus}, batch_size=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, learning_rate=TRAIN_LR, weight_decay=1e-4,
                log_every=1, seed=SEED)
    base.update(kw)
    return trainer_mod.TrainJobSpec(**base)


def _trace_kernels(prof_dir: str) -> dict:
    """{trace file: {kernel family: device events}} of the Chrome traces
    the trainer wrote under prof_dir; logs each trace's device ms by
    kernel family (_FAMILIES)."""
    out = {}
    for name in sorted(os.listdir(prof_dir)):
        with open(os.path.join(prof_dir, name)) as fh:
            events = json.load(fh).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = [e.get("name", "") for e in kernels]
        out[name] = {fam: sum(fam in n for n in names)
                     for fam in JOB_TRACE_KERNELS}
        ms = {}
        for e in kernels:
            low = e.get("name", "").lower()
            fam = next((f for f, keys in _FAMILIES
                        if any(k in low for k in keys)), "other")
            ms[fam] = ms.get(fam, 0.0) + e.get("dur", 0.0) / 1e3
        log(f"  {name}: {len(kernels)} kernels, device ms by family "
            + ", ".join(f"{f} {v:.2f}" for f, v in
                        sorted(ms.items(), key=lambda kv: -kv[1])))
    return out


def _worker(workdir: str, spec: trainer_mod.TrainJobSpec,
            fault: str | None) -> tuple[int, list]:
    """`python -m kubeflow_tpu_torch.train.trainer` with no --spec, as the
    controller launches a JAXJob worker (cpp/jaxjob.cc): runtime.json in
    TPK_WORKDIR and the TPK_* env. Returns (exit code, its JSONL records)."""
    with open(os.path.join(workdir, "runtime.json"), "w") as fh:
        fh.write(spec.to_json())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPK_")}
    env.update(TPK_NUM_PROCS="1", TPK_PROC_ID="0", TPK_NUM_SLICES="1",
               TPK_SLICE_ID="0", TPK_JOB_NAME="chip-smoke-job",
               TPK_WORKDIR=workdir)
    if fault:
        env["TPK_FAULT"] = fault
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.train.trainer"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=JOB_WORKER_TIMEOUT_S)
    recs = []
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            recs.append(rec)
    if proc.returncode not in (0, -9):
        log(proc.stdout[-3000:])
        log(proc.stderr[-3000:])
    return proc.returncode, recs


def _step_losses(recs: list) -> dict:
    return {r["step"]: r["loss"] for r in recs
            if "loss" in r and "event" not in r}


def phase_job(train: dict) -> dict:
    """The trainer as a job worker on packed documents: 5b-i at llama_1b's
    full width and depth (eval stream, a profile window, checkpoint saves
    timed), 5b-ii a SIGKILLed worker relaunched as the controller would,
    whose losses must equal a fault-free run's."""
    cfg = registry.model_config(TRAIN_MODEL)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_job_",
                            dir=os.path.join(ROOT, "build"))
    try:
        rng = np.random.default_rng(SEED)
        corpus = os.path.join(work, "train.npy")
        eval_corpus = os.path.join(work, "eval.npy")
        n_docs = _write_corpus(corpus, JOB_TRAIN_TOKENS, rng,
                               cfg.vocab_size)
        n_eval = _write_corpus(eval_corpus, JOB_EVAL_TOKENS, rng,
                               cfg.vocab_size)
        log(f"  corpora from seed {SEED}: {n_docs} documents "
            f"({JOB_TRAIN_TOKENS}+ tokens) to train on, {n_eval} to "
            f"evaluate, lengths {JOB_DOC_LENS[0]}-{JOB_DOC_LENS[1] - 1} "
            f"over vocabulary {cfg.vocab_size}, eos 0")
        result = _job_full(cfg, work, corpus, eval_corpus, train)
        result.update(_job_resume(cfg, work, corpus))
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _job_full(cfg, work: str, corpus: str, eval_corpus: str,
              train: dict) -> dict:
    """5b-i: llama_1b at full width and depth on packed rows through
    trainer.main, with the eval stream, a two-step profile window and
    synchronous checkpoint saves (the first save of a directory, at step
    1, and the forced final one), each timed."""
    steps = TRAIN_WARMUP + TRAIN_TIMED
    prof_dir = os.path.join(work, "profile")
    ckpt_dir = os.path.join(work, "ckpt_full")
    spec = _job_spec(
        corpus, steps=steps, eval_dataset="packed_lm",
        eval_dataset_kwargs={"path": eval_corpus},
        eval_every=JOB_EVAL_EVERY, eval_batches=JOB_EVAL_BATCHES,
        profile={"dir": prof_dir, "start_step": JOB_PROFILE_START,
                 "num_steps": 2},
        checkpoint={"dir": ckpt_dir, "interval": 10 * steps, "keep": 1,
                    "async_save": False})
    path = os.path.join(work, "job_full.json")
    with open(path, "w") as fh:
        fh.write(spec.to_json())
    saves = []
    manager = ckpt_mod.CheckpointManager
    real_save = manager.maybe_save

    def timed_save(self, step, state, **kw):
        t0 = time.perf_counter()
        did = real_save(self, step, state, **kw)
        if did:
            saves.append((step, time.perf_counter() - t0, os.path.getsize(
                os.path.join(self.directory, str(step),
                             ckpt_mod.STATE_FILE))))
        return did

    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts()
    tap = _StepTap(sys.stdout)
    t0 = time.monotonic()
    manager.maybe_save = timed_save
    try:
        with contextlib.redirect_stdout(tap):
            rc = trainer_mod.main(["--spec", path])
    finally:
        manager.maybe_save = real_save
    wall = time.monotonic() - t0
    launches = _counts()
    if rc != 0 or len(tap.steps) != steps:
        raise RuntimeError(f"trainer exited {rc} after {len(tap.steps)} of "
                           f"{steps} steps")
    layers = cfg.num_layers
    for rec, per_step in tap.steps:
        evals = JOB_EVAL_BATCHES if rec["step"] % JOB_EVAL_EVERY == 0 else 0
        expect = ((2 + evals) * layers, layers, layers)
        if per_step != expect:
            raise RuntimeError(f"packed step {rec['step']} launched (fwd, "
                               f"dq, dkv) = {per_step}, expected {expect}")
    losses = [rec["loss"] for rec, _ in tap.steps]
    ln_v = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite packed training loss: {losses}")
    if not ln_v - LOSS0_BELOW <= losses[0] <= ln_v + LOSS0_ABOVE:
        raise RuntimeError(f"first packed loss {losses[0]:.4f} outside "
                           f"[{ln_v - LOSS0_BELOW:.2f}, "
                           f"{ln_v + LOSS0_ABOVE:.2f}]")
    # An eval step's line carries the trainer's running average (its window
    # closed before the eval), not a window of its own: left out.
    timed = [rec for rec, _ in tap.steps[TRAIN_WARMUP:]
             if rec["step"] % JOB_EVAL_EVERY]
    step_s = sum(r["step_time_s"] for r in timed) / len(timed)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    mfu = 6 * cfg.num_params * tok_s / PEAK_BF16_FLOPS
    wait = (sum(r["data_wait_s"] for r in timed)
            / sum(r["step_time_s"] for r in timed))
    log(f"  5b-i: {steps} packed steps in {wall:.1f}s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (first within "
        f"[{ln_v - LOSS0_BELOW:.2f}, {ln_v + LOSS0_ABOVE:.2f}])")
    log(f"  launches per step (fwd, dq, dkv) = ({2 * layers}, {layers}, "
        f"{layers}) plus {JOB_EVAL_BATCHES} x {layers} forward at each "
        f"eval step, in all {steps} steps; run totals {launches}")
    log(f"  timed {len(timed)} steps (no eval step): {step_s * 1e3:.2f} "
        f"ms/step, {tok_s:.0f} tok/s, MFU {mfu:.4f} (padding counted as "
        "tokens); "
        f"phase 5 (synthetic, no segments): {train['ms_per_step']:.2f} "
        f"ms/step, {train['tok_s']:.0f} tok/s, MFU {train['mfu']:.4f}; "
        f"data-wait share {wait:.4%}")
    if not tap.evals or not all(
            math.isfinite(e["eval_loss"]) and 0 <= e["eval_accuracy"] <= 1
            for e in tap.evals):
        raise RuntimeError(f"eval lines missing or wrong: {tap.evals}")
    log("  eval: " + "; ".join(
        f"step {e['step']}: loss {e['eval_loss']:.4f} accuracy "
        f"{e['eval_accuracy']:.5f} over {e['eval_batches']:.0f} batches"
        for e in tap.evals))
    traces = _trace_kernels(prof_dir)
    log(f"  profile window steps [{JOB_PROFILE_START}, "
        f"{JOB_PROFILE_START + 2}): {traces}")
    if not traces or not all(all(n > 0 for n in t.values())
                             for t in traces.values()):
        raise RuntimeError("the profile trace does not name the flash "
                           f"forward and backward kernels: {traces}")
    if [s for s, _, _ in saves] != [1, steps]:
        raise RuntimeError(f"saves at steps {[s for s, _, _ in saves]}, "
                           f"expected the first at 1 and the final {steps}")
    log("  checkpoint saves (synchronous, fp32 parameters and both "
        "moments): " + "; ".join(
            f"step {s}: {sec:.2f}s, {n / 1e9:.3f} GB ({n / sec / 1e9:.2f} "
            "GB/s)" for s, sec, n in saves))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": step_s * 1e3,
            "tok_s": tok_s, "mfu": mfu, "data_wait_share": wait,
            "evals": tap.evals, "traces": traces,
            "saves": [{"step": s, "seconds": sec, "bytes": n}
                      for s, sec, n in saves]}


def _job_resume(cfg, work: str, corpus: str) -> dict:
    """5b-ii: three workers launched as the controller launches them. A
    fault-free reference (the same spec without checkpoints, which do not
    enter the losses), the spec with checkpoints and TPK_FAULT (it must
    die by SIGKILL after logging fault_injected), and its relaunch, which
    must log `restored` at the last checkpoint and reach the final step
    with the reference's losses bit for bit."""
    kw = dict(model_kwargs={"num_layers": JOB_RESUME_LAYERS},
              steps=JOB_RESUME_STEPS)
    ckpt = {"dir": os.path.join(work, "ckpt_resume"),
            "interval": JOB_RESUME_INTERVAL, "keep": 2}
    cut = registry.model_config(TRAIN_MODEL, num_layers=JOB_RESUME_LAYERS)
    log(f"  5b-ii: {TRAIN_MODEL} widths at {JOB_RESUME_LAYERS} layers "
        f"(depth cut: a {cfg.num_layers}-layer checkpoint of fp32 masters "
        f"and both moments is {12 * cfg.num_params / 1e9:.1f} GB, a "
        f"{JOB_RESUME_LAYERS}-layer one {12 * cut.num_params / 1e9:.1f} GB, "
        "written by two of the three runs), "
        f"{JOB_RESUME_STEPS} steps, checkpoint every {JOB_RESUME_INTERVAL}, "
        f"TPK_FAULT={JOB_FAULT}")
    runs = {}
    for name, spec, fault in (
            ("reference", _job_spec(corpus, **kw), None),
            ("faulted", _job_spec(corpus, checkpoint=ckpt, **kw), JOB_FAULT),
            ("relaunch", _job_spec(corpus, checkpoint=ckpt, **kw), None)):
        t0 = time.monotonic()
        rc, recs = _worker(work, spec, fault)
        runs[name] = (rc, recs, time.monotonic() - t0)
        log(f"    {name}: exit {rc} in {runs[name][2]:.1f}s; events "
            f"{[(r['step'], r['event']) for r in recs if 'event' in r]}; "
            f"losses {_step_losses(recs)}")
    ref, bad, again = (runs[n][1] for n in ("reference", "faulted",
                                            "relaunch"))
    fault_step = int(JOB_FAULT.split(";")[0].split("=")[1])
    restored = [r["step"] for r in again if r.get("event") == "restored"]
    want_restore = fault_step // JOB_RESUME_INTERVAL * JOB_RESUME_INTERVAL
    checks = {
        "reference finished": runs["reference"][0] == 0
        and len(_step_losses(ref)) == JOB_RESUME_STEPS,
        "faulted worker killed by signal 9": runs["faulted"][0] == -9,
        "fault_injected logged": any(
            r.get("event") == "fault_injected" and r["step"] == fault_step
            for r in bad),
        f"restored at step {want_restore}": restored == [want_restore],
        "relaunch finished": runs["relaunch"][0] == 0
        and max(_step_losses(again), default=0) == JOB_RESUME_STEPS,
    }
    ref_l = _step_losses(ref)
    got = {**_step_losses(bad), **_step_losses(again)}
    diffs = {s: abs(got[s] - ref_l[s]) / abs(ref_l[s])
             for s in ref_l if s in got}
    checks["every step's loss bit-equal to the reference"] = (
        set(got) == set(ref_l) and all(got[s] == ref_l[s] for s in ref_l))
    log(f"    loss rel. differences from the reference by step: {diffs}; "
        + ", ".join(f"{k} {'OK' if ok else 'FAIL'}"
                    for k, ok in checks.items()))
    if not all(checks.values()):
        raise RuntimeError(f"fault and resume failed: {checks}")
    return {"resume": {"restored_at": want_restore, "bit_equal": True,
                       "seconds": {n: r[2] for n, r in runs.items()}}}


def phase_auto(gk) -> tuple:
    """attention_impl="auto" on the configs the wgmma kernels do not take,
    through the GPU tests' check (c1_compare: a prefill and a training step
    under "auto" and under "naive" on the same weights and batch). Fails if
    a config raises, drifts from "naive" beyond C1_TOL, launches a wgmma
    kernel or leaves a CUDA-core kernel unlaunched. Returns the launches
    of flash_simt.cu's kernels (fwd, dq, dk/dv, and of fwd the tensor-core
    kernel's) of the whole phase."""
    _reset_counts()
    for name in gk.C1_CONFIGS:
        res = gk.c1_compare(name, DEVICE)
        log(f"  {name} ({res['dtype']}, head_dim {res['head_dim']}): auto "
            f"launched (wgmma fwd, dq, dkv, simt fwd, dq, dkv) = "
            f"{res['launches']}; logits rel_l2 vs naive "
            f"{res['logits_rel_l2']:.3e}; loss auto {res['loss']:.6f} naive "
            f"{res['loss_naive']:.6f}; grad norm auto {res['grad_norm']:.6f} "
            f"naive {res['grad_norm_naive']:.6f} "
            f"{'OK' if res['ok'] else 'FAIL'}")
        if (not res["ok"] or res["launches"][:3] != (0, 0, 0)
                or min(res["launches"][3:]) == 0):
            raise RuntimeError(f"attention_impl='auto' on {name} did not run "
                               f"through the CUDA-core kernels as 'naive'")
    launches = (fa.flash_simt_fwd_launches, fa.flash_simt_bwd_dq_launches,
                fa.flash_simt_bwd_dkv_launches,
                fa.flash_simt_fwd_mma_launches)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _kernel_spills(logs: dict) -> dict:
    """{kernel function: spill-store bytes} of NO_SPILL_KERNELS, from the
    ptxas reports ("Function properties for F" then "... N bytes spill
    stores ...")."""
    found, current = {}, None
    for text in logs.values():
        for line in text.splitlines():
            if "Function properties for" in line:
                name = line.rsplit(" ", 1)[-1]
                current = (name if any(k in name for k in NO_SPILL_KERNELS)
                           else None)
            elif current and "spill stores" in line:
                found[current] = int(line.split("bytes spill stores")[0]
                                     .rsplit(",", 1)[-1].strip())
                current = None
    if len(found) < 2 * len(NO_SPILL_KERNELS):  # D 64 and 128 each
        raise RuntimeError(f"no ptxas report for every no-spill kernel: "
                           f"{sorted(found)}")
    for kernel, want in SIMT_INSTANTIATIONS.items():
        # (no name here is a substring of another's mangled name)
        got = sum(kernel in name for name in found)
        if got < want:
            raise RuntimeError(f"ptxas reported {got} instantiations of "
                               f"{kernel}, fewer than {want}")
    return found


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    log(f"phase 1: device: {smi()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    secs = _build.build_all()
    log(f"  kernels built from source in {secs:.2f}s")
    for src, text in _build.build_logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                log(f"  {src}: {line.strip()}")
    spills = _kernel_spills(_build.build_logs)
    log(f"  spill stores of the {len(spills)} instantiations of "
        f"NO_SPILL_KERNELS: {sum(spills.values())} bytes")
    if any(spills.values()):
        raise RuntimeError(f"a no-spill kernel spills: "
                           f"{ {k: n for k, n in spills.items() if n} }")
    t0 = time.monotonic()
    log("phase 2: kernels vs plain versions")
    kern = phase_kernels()
    log("phase 2b: backward kernels vs the plain backward")
    bwd = phase_backward()
    gk = _gpu_tests()
    log("phase 2e: the CUDA-core flash kernels vs the plain versions")
    simt = phase_simt(gk)
    log("phase 2c: the W8A8 int8 matmul vs its plain version")
    q8 = phase_qmm()
    log("phase 2f: the W8A16 matmul vs its plain version")
    w8r = phase_w8a16(gk)
    log("phase 2d: ring attention kernels vs plain (all ranks on this "
        "card)")
    ring = phase_ring()
    log(f"phase 3: {MODEL} forward, kernel vs plain attention")
    phase_model()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    bundle = tempfile.mkdtemp(prefix="chip_smoke_bundle_",
                              dir=os.path.join(ROOT, "build"))
    try:
        log(f"phase 4: serving {MODEL} over HTTP")
        flat = phase_serving(bundle)
        log(f"phase 4b: paged serving of {MODEL} (KV blocks of "
            f"{KV_BLOCK_SIZE})")
        paged = phase_paged(bundle, flat)
        log(f"phase 4c: quantized serving of {MODEL} (int8 weights, int8 "
            "paged KV)")
        quant = phase_quant(bundle, flat, paged)
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    log(f"phase 5: training {TRAIN_MODEL} through the trainer")
    train = phase_training()
    log(f"phase 5b: a training job: {TRAIN_MODEL} on packed documents, "
        "eval, profile, checkpoints, SIGKILL and resume")
    job = phase_job(train)
    log("phase 6: attention_impl='auto' where the wgmma kernels do not "
        "take the config")
    simt_launches = phase_auto(gk)
    log(f"  phases 2-6 took {time.monotonic() - t0:.1f}s")
    main_row, bmain, qmain, wmain = (kern["main"], bwd["main"], q8["main"],
                                     w8r["main"])
    smain = simt["main"]
    fwd_launches = {"serving": flat["launches"],
                    "paged_quant_serving": quant["launches"],
                    "training": train["launches"][0],
                    "packed_training": job["launches"][0]}
    bwd_common = {"route": "cuda",
                  "source": "kubeflow_tpu_torch/ops/csrc/flash_bwd.cu",
                  "plain_ms": bmain["plain_ms"],
                  "library_ms": bmain["library_ms"],
                  "delta_ms": bmain["delta_ms"],
                  "shape": bmain["shape"], "design": KERNEL_DESIGN}
    log(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:135",
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": kern["max_abs_err"],
        "max_abs_err_lse": kern["max_abs_err_lse"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "shape": main_row["shape"],
        "ms_training_shape": bmain["fwd_ms"],
        "library_ms_training_shape": bmain["fwd_library_ms"],
        "design": KERNEL_DESIGN,
    }, {
        "name": "flash_bwd_dq",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:234",
        "launches": train["launches"][1] + job["launches"][1],
        "launches_by_path": {"training": train["launches"][1],
                             "packed_training": job["launches"][1]},
        "max_abs_err": bwd["worst"]["dq"]["max_abs"],
        "rel_l2_err": bwd["worst"]["dq"]["rel_l2"],
        "ms": bmain["dq_ms"], "bound_ms": bmain["dq_bound_ms"],
        "bound_by": bmain["dq_bound_by"], **bwd_common,
    }, {
        "name": "flash_bwd_dkv",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:285",
        "launches": train["launches"][2] + job["launches"][2],
        "launches_by_path": {"training": train["launches"][2],
                             "packed_training": job["launches"][2]},
        "max_abs_err": max(bwd["worst"][n]["max_abs"] for n in ("dk", "dv")),
        "rel_l2_err": max(bwd["worst"][n]["rel_l2"] for n in ("dk", "dv")),
        "ms": bmain["dkv_ms"], "bound_ms": bmain["dkv_bound_ms"],
        "bound_by": bmain["dkv_bound_by"], **bwd_common,
    }, *({
        "name": name, "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/flash_simt.cu",
        "replaces": f"kubeflow_tpu/ops/flash_attention.py:{line}",
        "launches": n, "max_abs_err": err, "rel_l2_err": rel,
        "ms": smain[f"{key}_ms"], "plain_ms": smain[plain],
        "bound_ms": smain[f"{key}_bound"][0],
        "bound_by": smain[f"{key}_bound"][1],
        "library_ms": smain[library], "shape": smain["shape"],
        "design": SIMT_FWD_DESIGN if key == "fwd" else SIMT_BWD_DESIGN,
        **({"launches_by_kernel": {
            "mma": simt_launches[3],
            "simt": simt_launches[0] - simt_launches[3]}}
           if key == "fwd" else {}),
        "by_shape": [{"shape": r["shape"], "ms": r[f"{key}_ms"],
                      "bound_ms": r[f"{key}_bound"][0],
                      "plain_ms": r[plain], "library_ms": r[library],
                      **({"kernel": r["fwd_plan"]["kernel"],
                          "bf16_copy": r["bf16_copy"]}
                         if key == "fwd" else {})}
                     for r in simt["rows"]],
    } for name, line, n, key, plain, library, err, rel in (
        ("flash_simt_fwd", 135, simt_launches[0], "fwd", "plain_fwd_ms",
         "library_fwd_ms", max(r["err_out"] for r in simt["rows"]), None),
        ("flash_simt_bwd_dq", 234, simt_launches[1], "dq", "plain_bwd_ms",
         "library_bwd_ms",
         max(r["errs"]["dq"]["max_abs"] for r in simt["rows"]),
         max(r["errs"]["dq"]["rel_l2"] for r in simt["rows"])),
        ("flash_simt_bwd_dkv", 285, simt_launches[2], "dkv", "plain_bwd_ms",
         "library_bwd_ms",
         max(r["errs"][n]["max_abs"] for r in simt["rows"]
             for n in ("dk", "dv")),
         max(r["errs"][n]["rel_l2"] for r in simt["rows"]
             for n in ("dk", "dv"))),
    )), {
        "name": "int8_matmul", "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/qmm.cu",
        "replaces": "kubeflow_tpu/ops/quant_matmul.py:29",
        "launches": q8["launches"], "max_abs_err": q8["max_abs_err"],
        "ms": qmain["ms"], "plain_ms": qmain["plain_ms"],
        "bound_ms": qmain["bound_ms"], "bound_by": qmain["bound_by"],
        "library_ms": qmain["library_ms"],
        "library_ms_kmajor": qmain["library_ms_kmajor"],
        "op_ms": qmain["op_ms"], "shape": qmain["shape"],
        "design": qmain["design"], "by_shape": q8["rows"],
    }, {
        "name": "w8a16", "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/w8a16.cu",
        "replaces": W8A16_REPLACES,
        "tpu_kernel": False,
        "launches": quant["w8a16_launches"],
        "launches_wgmma": quant["w8a16_wgmma_launches"],
        "max_abs_err": w8r["max_abs_err"], "rel_l2_err": w8r["rel_l2_err"],
        "ms": wmain["ms"], "plain_ms": wmain["plain_ms"],
        "bound_ms": wmain["bound_ms"], "bound_by": wmain["bound_by"],
        "library_ms": wmain["library_ms"], "shape": wmain["shape"],
        "design": W8A16_DECODE_DESIGN, "kernel": wmain["kernel"],
        "step_ms": w8r["steps"][4]["ms"],
        "step_bound_ms": w8r["steps"][4]["bound_ms"],
        "step_library_ms": w8r["steps"][4]["library_ms"],
        "in_situ": quant["w8a16_in_situ"],
        "by_shape": w8r["rows"],
    }, *({
        "name": name, "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/rdma_ring.cu",
        "replaces": f"kubeflow_tpu/ops/rdma_ring_attention.py:{line}",
        **errs, **ring["rows"][name],
    } for name, line, errs in (
        ("rdma_fwd", 50, {"max_abs_err": ring["worst"]["out"],
                          "rel_l2_err": ring["worst"]["out_rel_l2"],
                          "max_abs_err_lse": ring["worst"]["lse"],
                          "design": KERNEL_DESIGN}),
        ("rdma_bwd_dq", 197, {"max_abs_err": ring["worst"]["dq_abs"],
                              "rel_l2_err": ring["worst"]["dq"],
                              "design": KERNEL_DESIGN}),
        ("rdma_bwd_dkv", 268, {
            "max_abs_err": max(ring["worst"]["dk_abs"],
                               ring["worst"]["dv_abs"]),
            "rel_l2_err": max(ring["worst"]["dk"], ring["worst"]["dv"]),
            "design": KERNEL_DESIGN}),
    ))]}))
    log(smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
