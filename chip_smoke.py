"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is printed as a result then):
  1. device: require CUDA, print the card, build every kernel from source
     (one nvcc per source, all started together); the ptxas reports of the
     wgmma kernels (both attention forwards, the flash and ring dq and dk/dv
     backward, the int8 and W8A16 matmuls) and of the CUDA-core dq and
     dk/dv (every instantiation) must show no spill stores;
  2. kernels: the forward kernel against its plain PyTorch version on the
     card, at the serving shapes (Qwen2-7B's 28/4 heads among them), with
     its time, the plain version's, one library call's (a yardstick the
     port never calls) and its bound;
  2b. backward kernels: dq and dk/dv against the plain backward at the
     phase-2 shapes and the llama_1b and llama3_8b (phase 5c's) training
     shapes, with the same timings (and the forward kernel's time and
     bound and SDPA's forward time there);
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
     case's backward plan (rows, streamed tile, dk/dv splits) printed, and
     at Gemma-3-1B's (4 heads, 1 kv head) in bf16 at seq 512, two
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
     times logged); then 4k (vii) on the same server;
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
     least 5 GiB under phase 4's; the longest prompt alone on a
     pipeline_depth-1 engine over the same served module and pool config
     gives the depth-2 repeat's ids; then the int8 model's logits against
     a bf16 model holding the same codes dequantized;
  4d. the request surface: phase 4's bundle with the "bytes" tokenizer
     behind a server admitting 6 requests at once: phase 4's six requests
     at once over :generate, the v2 generate stream and
     /openai/v1/completions (one streamed; every first-chunk prefill
     through the flash kernel), then the longest greedy prompt streamed as
     ndjson (frames joined = phase 4's repeat ids; time to the first frame
     and to done beside the same prompt unstreamed on this server and on
     phase 4's), a 2000-token
     request under a 500 ms deadline (504; streamed under 3 s, past its
     first frame: a terminal error frame; each frees its slot at the next
     chunk boundary, tokens wasted printed), a burst of 10 (at least 4
     shed with 503 + Retry-After, ready 503 while shedding, 200 after),
     one timed /metrics scrape consistent
     with the engine and the requests served, an OpenAI completion streamed
     and not (same text, [DONE]) and a chat, then a version swap through
     the repository API (202, the new model_dir ready, the same greedy ids,
     the old version's memory released after its grace window);
  4e. Hugging Face checkpoints and PEFT adapters: (i) llama3_8b's widths
     (meta-llama/Meta-Llama-3-8B config.json) at 4 layers written from the
     seed with the port's safetensors writer as two shards and an index,
     read back bit-equal, served through the server's --storage-uri (the
     "huggingface" format): logits bit-equal to the module that wrote it,
     greedy ids equal to its engine's, every first-chunk prefill through
     the flash kernel, load seconds and bytes; a rank-16 attn_mlp adapter
     folded flat through `peft_adapter` within phase 5c's relative gate of
     the adapted function in fp32; (ii) two synthetic PEFT adapters on the
     full llama3_8b bundle (`generative.adapters`): four concurrent
     requests (two base, one per adapter, one of them as the OpenAI model
     "llama3_8b:ml_b"), the same four paged and on a base-only engine:
     base rows equal the base-only engine's, adapter rows their lone runs
     and within the fp32 gate of base + (x·A)·B·alpha/r, each adapter
     changes its row, paged equals flat, the adapters listed;
     ms per 4-row step mixed and base-only, launches per step with and
     without adapters, the adapters' load seconds and bytes;
  4f. KV reuse on phase 4's llama3_8b, one model under every engine: a
     2048-token shared head, then A, B, C (the head + 100, 700, 1500
     tokens) and E (A + A's ids + 300: a second turn), each alone. (i) The
     flat prefix cache: 1 miss, 3 hits of 2048, 2048 and 2148 tokens, no
     flash launch for a hit (32 for A), one prefill chunk fewer per hit at
     2048, B and C bit-equal (ids and first logprob) to a cacheless
     engine, E's first-token logits within 1.25x phase 3's floor of E run
     cold; admission seconds cold and hit, a fragment's bytes. (ii) Paged
     (block 16): ids equal to (i)'s, 3 zero-copy hits, a CoW fork (E),
     the pool whole once the cache is emptied. (iii) An int8 pool: one
     dequant fallback per hit, the pool whole, a second hit on B's prompt
     bit-equal to the first; logit distance from the int8 pool's cold run
     printed. (iv) The host tier: a pool of two 3000-token reservations,
     A, two 3000-token prompts that push A's entries into the tier, then
     B restored from it: ids equal to (ii)'s, spill and restore ms and
     bytes. (v) One /metrics scrape on a server whose bundle sets the
     three keys, after a miss and a hit: the new families equal the
     engine's stats;
  4g. speculative decoding: (i) at llama_1b's widths in fp32 (2 layers)
     the target as its own draft and a 1-layer draft, flat and paged, at
     depth 1 and 2: four greedy prompts at once give the vanilla engine's
     ids, the self-draft accepting at least 0.99; (ii) llama3_8b with a
     draft at meta-llama/Llama-3.2-1B's published widths written from the
     seed as an HF checkpoint and served over HTTP through
     generative.draft.checkpoint (gamma 4): greedy ids equal vanilla
     decoding's or part only at a recomputed near-tie, ms a dispatch, tok/s
     a row and acceptance at depth 2 and 1 beside vanilla at depth 2, one
     profiled dispatch split into draft forwards and verify, kernels a spec step,
     no B1 launch in a dispatch, the draft's load seconds and bytes; (iii)
     the target as its own draft: acceptance at least 0.75 greedy (bf16
     ties of random-init logits) and 0.9 at temperature 0.8, the same ids
     from the same seed; (iv) int8 weights:
     ids against the int8 vanilla engine, W8A16 launches by kernel with 4
     slots and with 1, kv_quant with a draft refused; (v) 2 greedy, 1
     top-k and 1 top-p request at once on a paged engine: the truncated
     rows decode vanilla, the pool whole after; (vi) /metrics' spec
     series equal the engine's stats; B1 launches 32 a target admission;
  4h. the rolling-window KV cache on Mistral-7B-v0.1's published config
     (sliding window 4096, random bf16 weights): (i) at its widths cut to 2
     layers in fp32, a 4200-token prompt's 48 greedy ids on a rolling
     engine (max_len 8192) at depth 1 and 2, with a random 1-layer draft
     (rejections across the wrap) and after a prefix-cache hit, each the
     teacher-forced fp32 full forward's argmax; (ii) the full model past
     the window, four prompts at once (6000, 4090, 2000, 100 tokens), 64
     ids each: ids against one teacher-forced bf16 full forward each (B1 with mask code
     3) under 4g's near-tie rule, no B1 launch in the engine, the cache's
     bytes, ms per 4-row step over 4 dispatches, one decode chunk's wall
     (median of 5) and profile (the read's concat and masks); (iii) within the window (max_len 4096, a causal
     view): ids, B1 32 a first admission chunk; (iv) a 5000-token shared
     head: hit ids equal cold ones, admission seconds; (v) one row as a
     spec target: ids against vanilla rolling, acceptance, ms a dispatch;
     (vi) a 4-layer huggingface bundle over --storage-uri: a 5000-token
     request's ids equal the engine's;
  4i. disaggregated roles on phase 4's llama3_8b (one module under every
     engine, paged, blocks of 16; a unified, a prefill and a decode engine
     a case): (i) phase 4's six requests shipped by the prefill engine and
     decoded at once by the decode engine: greedy ids against the unified
     engine's (equal or parted at a near-tie), no prefill chunk and no B1
     launch on the decode engine, 32 B1 launches a prompt, no decode and a
     drained pool on the prefill engine, blocks shipped = received = the
     prompts' blocks, each frame at least its prompt's k and v; per
     request the frame's bytes, the ship's ms (export, host copy, pack)
     and the import's device ms; the decode engine's 4-row step while the
     prefill engine prefills the 3000-token prompt, against the unified
     engine's while it admits it; (ii) one request at temperature 0.8
     alone on each side: ids and logprobs bit-equal to the unified
     engine's on the same seed; (iii) an int8 pool: fmt 3, at most 0.55x
     the fmt-1 frame, the int8 unified engine's ids; (iv) the target as its
     own draft: fmt 2 with a draft section, spec dispatches and no prefill
     chunk on the decode engine, the unified spec engine's ids; (v) an
     adapter named in the frame: the unified engine's ids for it; (vi)
     bundles with generative.role behind one server: :prefill (a KV frame)
     then :decode plain and streamed (ids against (i)), time from :prefill
     to :decode's first frame against the unified stream's first frame,
     503 + Retry-After for a frame a small pool can never hold, 400 for a
     truncated frame, the new /metrics rows;
  4j. the Gemma 1/2/3 and Qwen2 config flags, each from its published
     config.json through hf_import.config_from_hf, random bf16 weights
     with the (1 + w) norm scales and QKV biases drawn nonzero: (i)
     Gemma-7B whole (head_dim 256) behind the HTTP server, four prompts at
     once (100-2000 tokens): B1 28 launches a first admission chunk, all
     flash_simt_fwd_mma_kernel, no wgmma; ids against one teacher-forced
     bf16 full forward each (near-tie rule); the first token's logits
     within 1.25x phase 3's floor of a full forward through the plain
     attention; peak; (ii) Gemma-2-9B's widths at 4
     layers (caps 50/30, window 4096): a 4200-token prompt past the
     window on a full-length cache (the mask kept, nothing rolls), no B1
     launch (as in JAX), ids against the teacher-forced forward, peaks;
     (iii) Gemma-3-1B whole (4 heads, 1 kv head, window 512, dual RoPE):
     within the window (a causal view keeping its per-layer kinds: B1 26
     mma launches a first chunk) and past it (5to1 banded reads, no B1),
     ids against the teacher-forced forward; (iv) Qwen2-7B's widths at 4
     layers (QKV biases) written as a huggingface checkpoint, served over
     --storage-uri in bf16 and under quantize: int8: ids equal to an
     engine's on the same weights, B1 4 wgmma launches a first chunk, the
     W8A16 launches by kernel against 7 a layer a forward plus the
     unembeddings, in bf16 the engine's first-token logits within 1.25x
     phase 3's floor of a full forward through the plain attention; each
     engine's decode step, the median wall of 5 decode chunks; then the
     W8A16 op at Gemma's tied unembedding (N 256000) and at every Qwen2-7B
     width (K 3584 and 18944; N 512 to 152064) against its plain
     version (phase 2 holds flash_fwd at Qwen2-7B's 28/4 heads);
  4k. fixed-forward serving: (i) BERT-base at google-bert/bert-base-uncased's
     config.json widths with a 2-label sequence-classification head, random
     weights written in HF names, served as a "huggingface" bundle over
     --storage-uri (seq_len 128, buckets 1-32): :predict of 1, 3, 32 and 40
     instances (40 = a 32-row and an 8-row call), /infer = :predict, the
     logits within 5e-2 rel-L2 of an fp32 forward of the same weights, a
     pad-id-padded row within 1e-2 of the row cut to its length (same
     argmax), 16 one-row requests at once coalesced into fewer model calls,
     each row within 1e-3 of its solo predict and the distinct rows more
     than 1e-2 apart; ms of a bucket-1 and a bucket-32 call,
     examples/s of the burst, peak memory; (ii) occlusion :explain of 2 rows
     (129 variants each through the buckets) equal to the logit
     differences of a direct predict of the variants; (iii) the same
     checkpoint under quantize: int8: W8A16 launches a predict call by
     route against `_w8a16_plan`'s count (72 projections and the pooler),
     logits within 1e-1 of the bf16 bundle's, weight bytes against bf16;
     (iv) mnist_mlp with the integrated-gradients explainer: completeness
     gap within 1% of |f(x) - f(x0)|; (v) llama_1b's registry bundle
     without a generative block: B1 16 wgmma launches a bucket call, the
     logits within 1.25x naive_attention's distance from the plain
     attention, and its int8 form: W8A16 launches against the plan, logits
     within 5e-2 of the same codes dequantized; (vi) rank-16 attn_mlp
     adapters of the config on int8 projections at llama_1b's widths (2
     layers): the logits against the adapted function in fp32 within 1.25x
     the int8 base's distance from its fp32 function, the adapters moving
     the logits more than that; (vii) in phase 4, :predict and /infer of 2
     rows of 16 tokens on the llama3_8b server: B1 32 a call, /infer =
     :predict, the logits within 1.25x naive_attention's distance from the
     plain attention, the last position's logits within 1.25x phase 3's
     floor of the engine's first-token logits;
  4m. GPT-2 and the T5 family at full depth from checkpoints written with
     the published configs: (i) GPT-2-small over --storage-uri, fp32 ids
     equal to the cache-free teacher-forced replay, paged = flat, bf16
     and int8 first-token logits (int8 against the fp32 function of its
     codes and against bf16), W8A16 launches of an admission against the
     plan, a decode step's wall and device ms; the W8A16 op at the odd N
     50257 against its plain version; (ii) T5-base and Flan-T5-base by
     :generate: fp32 tokens the teacher-forced argmax with n_valid by the
     EOS rule, bf16 and int8 first-step logits, an int8 request under
     set_sync_debug_mode("error") with one host sync and the plan's W8A16
     launches;
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
     losses of a fault-free run (on the card beside the faulted worker)
     bit for bit; the same with spec.lora side by side with it;
  5c. LoRA fine-tuning: llama3_8b at full width and depth (fp32 masters
     frozen, rank 16 adapters on attn_mlp) through the trainer (batch 4,
     seq 2048, 3 warm-up + 5 timed steps): every step's flash launches,
     sane losses, ms/step, tok/s, the LoRA MFU ((4·N_base + 6·N_lora) ·
     tok/s over the bf16 peak), peak memory, the adapters' optimizer
     bytes, the frozen base bit-unchanged; then `train.lora.merge` into a
     bf16 lora_rank=0 model held against the trained model (in fp32, and
     as trained), and that model behind the engine answering greedy
     requests at pipeline_depth 2;
  5d. the four remat policies at phase 5's point through the trainer, one
     run of three steps each: ms/step, peak memory, flash launches a step,
     and losses equal to "nothing"'s;
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
import http.client
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
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kubeflow_tpu_torch.models import bert as bert_mod  # noqa: E402
from kubeflow_tpu_torch.models import gpt2 as gpt2_mod  # noqa: E402
from kubeflow_tpu_torch.models import hf_import as hf_mod  # noqa: E402
from kubeflow_tpu_torch.models import llama as llama_mod  # noqa: E402
from kubeflow_tpu_torch.models import moe as moe_mod  # noqa: E402
from kubeflow_tpu_torch.models import peft_import  # noqa: E402
from kubeflow_tpu_torch.models import t5 as t5_mod  # noqa: E402
from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.ops import quant_matmul as qmm  # noqa: E402
from kubeflow_tpu_torch.ops import rdma_ring_attention as rra  # noqa: E402
from kubeflow_tpu_torch.ops import w8a16 as w8  # noqa: E402
from kubeflow_tpu_torch.ops.reference import naive_attention  # noqa: E402
from kubeflow_tpu_torch.parallel import Mesh  # noqa: E402
from kubeflow_tpu_torch.serve import quant as squant  # noqa: E402
from kubeflow_tpu_torch.serve import multilora  # noqa: E402
from kubeflow_tpu_torch.serve import runtimes  # noqa: E402
from kubeflow_tpu_torch.serve import server as server_mod  # noqa: E402
from kubeflow_tpu_torch.serve import text2text  # noqa: E402
from kubeflow_tpu_torch.serve.generation import (  # noqa: E402
    GenerationEngine, GenerativeTorchModel)
from kubeflow_tpu_torch.serve.kv_transfer import peek_meta  # noqa: E402
from kubeflow_tpu_torch.serve.runtimes import export_for_serving  # noqa: E402
from kubeflow_tpu_torch.serve.server import (ModelRepository,  # noqa: E402
                                             ModelServer)
from kubeflow_tpu_torch.serve.text2text import \
    Text2TextTorchModel  # noqa: E402
from kubeflow_tpu_torch.utils.resilience import \
    metrics as res_metrics  # noqa: E402
from kubeflow_tpu_torch.train import checkpoint as ckpt_mod  # noqa: E402
from kubeflow_tpu_torch.train import lora as lora_mod  # noqa: E402
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
# Phase 5c: LoRA fine-tuning of llama3_8b at full width and depth (32
# layers, frozen fp32 masters, bf16 compute) through the trainer: rank 16,
# alpha 32 on attn_mlp, batch 4 x seq 2048 of synthetic_lm, 3 warm-up and 5
# timed steps. The lr is high for LoRA so that 8 steps move the adapters
# well clear of the merge check's rounding floor.
LORA_MODEL, LORA_BATCH, LORA_SEQ, LORA_LR = "llama3_8b", 4, 2048, 1e-3
LORA = {"rank": 16, "alpha": 32.0, "targets": "attn_mlp"}
LORA_WARMUP, LORA_TIMED = 3, 5
# Base tensors held bit-equal before and after training.
LORA_FROZEN_CHECK = ("embed", "layers.0.attn.q_proj.weight",
                     "layers.0.attn.k_proj.weight",
                     "layers.31.mlp.down_proj.weight",
                     "layers.31.post_attn_norm.scale", "final_norm.scale")
# The merged bf16 serving model against the trained function on one
# prompt, as phase 3 holds the kernel: the trained model computed in fp32
# is the exact reference, and the merged model must lie within
# LOGITS_VS_NAIVE (1.25) x the adapted bf16 model's own distance from it
# (and within LOGITS_REL_L2_MAX of the adapted model). The two bf16 models
# round differently (the merged weights round W + s·B·A once, the adapted
# model rounds W and adds a bf16 delta), and every op re-rounds through 32
# layers: on a CPU proxy of llama3_8b's layout at 32 layers the two sit
# 2.5e-2 to 2.7e-2 apart, each ~2.3e-2 from the fp32 function.
LORA_PROMPT = 512
# The merged model behind the engine in-process: greedy requests of these
# prompt lengths, LORA_MAX_TOKENS out each (three decode chunks, so depth
# 2 has a chunk to overlap), at pipeline_depth 2.
LORA_SERVE = {"slots": 4, "max_len": 1024, "chunk": 16,
              "prefill_buckets": [128, 512], "pipeline_depth": 2}
LORA_REQUESTS, LORA_MAX_TOKENS = (5, 100, 500), 48
# Phase 5d: each remat policy at phase 5's point, REMAT_STEPS steps a
# run, one run each; the first step's time (allocations) is left out of
# ms/step. The losses must equal
# "nothing"'s within REMAT_LOSS_REL (bit-equal is expected: a policy
# changes what is recomputed, never a value).
REMAT_STEPS, REMAT_LOSS_REL = 3, 1e-6
# Phase 5e: training the MoE and MLP families. (i) Mixtral-8x7B's widths
# (hidden 4096, 32/8 heads of 128, 8 experts top-2, intermediate 14336,
# vocab 32000) at MOE_TRAIN_LAYERS layers, through the trainer's entry
# point as the control plane launches a worker: fp32 masters (at 2 layers
# 3.16B parameters, ~51 GB of masters, gradients and both moments; the
# 32-layer model's would not fit one card), bf16 compute, phase 5c's point
# (B4 S2048: B1-B3 at the 8B training shape), the chunked loss, remat
# "nothing", 3 warm-up steps (the last one profiled) and 5 timed. (ii) One
# step's loss and gradients through the kernels against the plain
# attention, at MOE_AGREE_BATCH rows, under phase 5's gates: the loss; the
# attention, norm and embedding leaves together and each; the router and
# expert-stack leaves together and each, a looser check (a bf16 attention
# flips some routing choices, so both the kernel step and naive_attention's
# sit ~1e-1 from the plain step there); and the backward kernels alone
# (kernel forward + kernel backward against kernel forward + the plain
# backward, so the routing is the same in both) over every leaf within
# BWD_ALONE_VS_NAIVE x naive_attention's distance on the attention leaves.
# (iii) The routed block at Mixtral's widths in fp32 on
# MOE_ROUTE_SHAPE tokens, at capacity 1.25 and MOE_DROP_CAPACITY: the
# adjoint gathers' gradients against the one-hot einsums' within
# MOE_ROUTE_REL_L2 (the same fp32 products summed in other orders). (iv)
# spec.lora MOE_LORA on the same model, one step; its SIGKILL and resume
# is 5b-ii's third variant (beside the plain and llama_1b's spec.lora
# ones), in a workdir of its own, at MOE_RESUME_LAYERS
# layers and batch MOE_AGREE_BATCH (depth cut as 5b-ii's: a checkpoint
# holds every fp32 master, the frozen base too, 12.7 GB at 2 layers and 6.9
# GB at 1, written twice and read once on the resume's critical path;
# alone, its three workers took 70.2 s). (v) mnist_mlp on mnist_like at the
# JAX trainer's test point.
MOE_TRAIN_MODEL, MOE_TRAIN_LAYERS = "mixtral_8x7b", 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_LR = 4, 2048, 3e-4
MOE_TRAIN_WARMUP, MOE_TRAIN_TIMED = 3, 5
MOE_AGREE_BATCH = 2
MOE_ROUTE_SHAPE, MOE_ROUTE_REL_L2 = (2, 192), 1e-5
MOE_LORA = {"rank": 16, "alpha": 32.0, "targets": "attn"}
MOE_FROZEN_CHECK = ("embed", "layers.0.mlp.router", "layers.0.mlp.w_gate",
                    "layers.1.mlp.w_down", "layers.1.attn.q_proj.weight",
                    "final_norm.scale")
MOE_RESUME_LAYERS = 1
MLP_STEPS, MLP_BATCH, MLP_LR = 20, 64, 1e-2
PROMPT_LENS = (5, 100, 400, 1000, 1900, 3000)
MAX_TOKENS, CHUNK = 32, 16
SEED = 0
MODEL, MODEL_KWARGS, DEVICE = "llama3_8b", {}, "cuda"
GENERATIVE = {"slots": 4, "max_len": 4096, "chunk": CHUNK,
              "prefill_buckets": [128, 512, 2048]}
# Paged serving (4b, 4c): 16 divides max_len and every default decode
# bucket (64 .. 4096).
KV_BLOCK_SIZE = 16
# 4d, the request surface: a server admitting 6 requests at once (phase
# 4's six fit, a burst of 10 sheds at least 4); a 500 ms deadline on a
# request of 2000 tokens (far past the budget); the same request streamed
# under 3000 ms, or four of this server's decode chunks where that is
# longer, since at depth 2 an admission's first token goes out at its
# first chunk's fetch, after two chunks of host issue (1.989 s on an
# NVIDIA H100 80GB HBM3 at 700 W, 3.006 s on one whose host issued a chunk
# in 1.354 s: a 500 ms stream is a clean 504 before its first frame, and
# so was a 3000 ms one there); a 5 s grace window for the version swap
# (the JAX tests shrink it too); the OpenAI text prompt.
SURFACE_MAX_INFLIGHT, SURFACE_BURST = 6, 10
SURFACE_DEADLINE_MS, SURFACE_LATE_TOKENS = 500, 2000
SURFACE_STREAM_DEADLINE_MS = 3000
SURFACE_GRACE_S = 5.0
SURFACE_PROMPT = "The quick brown fox jumps over the lazy dog."
# 4e (i): a Hugging Face checkpoint at llama3_8b's published widths
# (meta-llama/Meta-Llama-3-8B config.json) cut to HF_LAYERS layers to bound
# the disk and the time (~3.9 GB in bf16), written from the seed as two
# shards and an index, served through --storage-uri on phase 4's engine;
# HF_PROMPT_LENS greedy requests, one at a time, on the server and on the
# engine of the module that wrote it; then a rank-16, alpha-32 attn_mlp
# adapter folded flat through the bundle's peft_adapter.
HF_LAYERS = 4
HF_CONFIG = {"architectures": ["LlamaForCausalLM"], "attention_bias": False,
             "bos_token_id": 128000, "eos_token_id": 128001,
             "hidden_act": "silu", "hidden_size": 4096,
             "intermediate_size": 14336, "max_position_embeddings": 8192,
             "model_type": "llama", "num_attention_heads": 32,
             "num_hidden_layers": HF_LAYERS, "num_key_value_heads": 8,
             "rms_norm_eps": 1e-05, "rope_scaling": None,
             "rope_theta": 500000.0, "tie_word_embeddings": False,
             "torch_dtype": "bfloat16", "vocab_size": 128256}
HF_NAME, HF_PROMPT_LENS, HF_PROMPT = "llama3_8b_hf", (5, 400, 3000), 512
HF_ADAPTER = {"r": 16, "alpha": 32.0, "targets": "attn_mlp"}
# 4e (ii): multi-LoRA on phase 4's full llama3_8b bundle: two synthetic
# PEFT adapters (the JAX bench's `_synth_adapter_dir`: A and B N(0, 0.02),
# alpha 2r), four concurrent requests of MAX_TOKENS, two of them base. The
# prompt lengths keep every decode chunk in the 1024-row cache bucket
# whatever the admission order (a chunk's first need is > 512, its last <=
# 1024), so runs of the same requests compare bit for bit.
ML_ADAPTERS = {"ml_a": {"r": 8, "targets": "attn", "seed": 11},
               "ml_b": {"r": 16, "targets": "attn_mlp", "seed": 12}}
ML_REQUESTS = ((520, None), (700, None), (600, "ml_a"), (900, "ml_b"))
# 4f: KV reuse on phase 4's llama3_8b at phase 4's generative settings. A
# shared head of PREFIX_HEAD tokens, one full largest-bucket chunk (a
# system prompt plus retrieved context), then four requests of MAX_TOKENS
# greedy tokens, each alone: A, B, C = the head + PREFIX_TAILS tokens, and
# E = A + A's ids + PREFIX_TURN tokens, a second turn whose hit lands at A's
# prompt (2148 % 16 = 4: the paged engine forks a tail block). PREFIX_CAP
# entries. The host tier's pool holds about two worst-case reservations of
# the PREFIX_CROWD prompts, which push A's entries into the tier.
PREFIX_HEAD, PREFIX_TAILS, PREFIX_TURN = 2048, (100, 700, 1500), 300
PREFIX_CAP, PREFIX_TIER_BLOCKS, PREFIX_CROWD = 4, 1024, (3000, 3000)
# 4g: speculative decoding. (i) Exactness at phase 6's llama_1b_fp32_2l
# widths (fp32: the verify's and a decode step's roundings stay far under
# any gap between two top logits): the target as its own draft and a
# 1-layer draft from another seed, SPEC_SMALL_LENS greedy prompts at
# once, flat and paged engines at depth 1 and 2, SPEC_SMALL settings. (ii)
# Phase 4's llama3_8b (bf16) with a draft at the published widths of
# meta-llama/Llama-3.2-1B's config.json (DRAFT_CONFIG: 16 layers, tied
# embeddings, llama3 rope scaling), written from the seed as an HF
# checkpoint and served over HTTP through generative.draft.checkpoint,
# gamma SPEC_GAMMA, SPEC_PROMPT_LENS greedy prompts at once; (iii) the
# target as its own draft; (iv) the int8-weight target; (v) 2 greedy, 1
# top-k and 1 top-p request at once on a paged engine. Where bf16 greedy
# ids part from vanilla decoding's, the position's logits, recomputed by
# one forward over the common prefix, must show a near-tie: the two
# tokens' logits within SPEC_TIE_SIGMAS x sqrt(2) x phase 3's floor x the
# row's rms (phase 3's rel-L2 is the per-logit spread one change of bf16
# rounding gives; two paths' spreads differ by sqrt(2) of it).
SPEC_GAMMA, SPEC_TIE_SIGMAS = 4, 5.0
SPEC_PROMPT_LENS = (100, 400, 700, 1000)
SPEC_SMALL_LENS = (50, 120, 300, 600)
SPEC_SMALL = {"slots": 4, "max_len": 2048, "chunk": CHUNK,
              "prefill_buckets": [128, 512]}
# The target as its own draft accepts every proposal in fp32 (i). In bf16
# a proposal's argmax (a 1-row step) and the verify's (a 5-row forward,
# other GEMM shapes) are two roundings of one model, and random-init
# logits over 128256 entries often tie within a bf16 ulp (~0.03 at |l| ~
# 4): most ids that part in (ii)-(iii) do so at an exact tie of the
# recomputed logits. At a per-proposal agreement p, gamma 4's cumulative
# acceptance is (p + p^2 + p^3 + p^4) / 4: 0.80 at p 0.91, what an NVIDIA
# H100 80GB HBM3 at 700 W measured (0.806 and 0.833). Greedy is held to SPEC_SELF_ACCEPT_BF16_MIN,
# under that; a fault (a stale draft row, a wrong position) takes it
# toward the 1-layer draft's 0. Temperature rows (rejection by p_t / p_d,
# which a tie does not move) are held to SPEC_SELF_ACCEPT_MIN.
SPEC_SELF_ACCEPT_FP32_MIN, SPEC_SELF_ACCEPT_MIN = 0.99, 0.9
SPEC_SELF_ACCEPT_BF16_MIN = 0.75
SPEC_TEMPERATURE = 0.8
# Tokens out of the spec runs of (ii), (iv) and (v), whose draft accepts
# nothing (3 tokens a dispatch): half of MAX_TOKENS keeps the phase near
# its budget. The target-as-draft runs of (iii) take MAX_TOKENS.
SPEC_SHORT_TOKENS = MAX_TOKENS // 2


def _spec_steps(generative: dict) -> int:
    """Spec steps a dispatch of an engine of these settings."""
    return max(1, generative["chunk"] // (SPEC_GAMMA + 1))


DRAFT_CONFIG = {"architectures": ["LlamaForCausalLM"],
                "attention_bias": False, "bos_token_id": 128000,
                "eos_token_id": 128001, "head_dim": 64,
                "hidden_act": "silu", "hidden_size": 2048,
                "intermediate_size": 8192,
                "max_position_embeddings": 131072, "mlp_bias": False,
                "model_type": "llama", "num_attention_heads": 32,
                "num_hidden_layers": 16, "num_key_value_heads": 8,
                "rms_norm_eps": 1e-05,
                "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                                 "low_freq_factor": 1.0,
                                 "original_max_position_embeddings": 8192,
                                 "rope_type": "llama3"},
                "rope_theta": 500000.0, "tie_word_embeddings": True,
                "torch_dtype": "bfloat16", "vocab_size": 128256}
# 4h: the rolling-window KV cache on the published config.json of
# mistralai/Mistral-7B-v0.1 (a sliding window of 4096 tokens on every layer:
# the Mistral 7B paper's rolling buffer cache), mapped by
# llama_config_from_hf, random weights from the seed in bf16. (i) fp32
# exactness at its widths cut to ROLLING_FP32_LAYERS layers: a prompt of
# ROLLING_FP32_PROMPT tokens, ROLLING_FP32_TOKENS greedy ids on a rolling
# engine at depth 1 and 2, the same with a random 1-layer causal draft at
# gamma SPEC_GAMMA (rejections across the wrap), and a prefix-cache hit:
# every id the teacher-forced fp32 full forward's argmax, no near-tie
# allowed. (ii) The full model past the window (ROLLING_GEN: max_len 8192,
# prompt buckets clamped to the window), four greedy prompts of
# ROLLING_PROMPT_LENS at once (6000 wraps at admission, 4090 in decode),
# ROLLING_MAX_TOKENS ids each: the ms per step is read over that many
# decode dispatches, and one decode chunk's wall over ROLLING_WALL_REPS
# calls.
# (iii) Within the window (WITHIN_GEN, max_len 4096: a causal view with B1
# prefill), WITHIN_PROMPT_LENS. (iv) A shared head of ROLLING_PREFIX_HEAD
# tokens and ROLLING_PREFIX_TAILS. (v) One row of ROLLING_SPEC_PROMPT
# tokens as a spec target, the target's weights as its causal draft. (vi) A
# huggingface bundle of MISTRAL_HF_LAYERS layers over --storage-uri, one
# MISTRAL_HTTP_PROMPT-token request. bf16 ids are held to one
# teacher-forced full forward per prompt (B1 with mask code 3) under 4g's
# near-tie rule.
MISTRAL_CONFIG = {"architectures": ["MistralForCausalLM"], "bos_token_id": 1,
                  "eos_token_id": 2, "hidden_act": "silu",
                  "hidden_size": 4096, "initializer_range": 0.02,
                  "intermediate_size": 14336,
                  "max_position_embeddings": 32768, "model_type": "mistral",
                  "num_attention_heads": 32, "num_hidden_layers": 32,
                  "num_key_value_heads": 8, "rms_norm_eps": 1e-05,
                  "rope_theta": 10000.0, "sliding_window": 4096,
                  "tie_word_embeddings": False, "torch_dtype": "bfloat16",
                  "use_cache": True, "vocab_size": 32000}
MISTRAL_PARAMS, MISTRAL_NAME = 7_241_732_096, "mistral_7b"
ROLLING_GEN = {"slots": 4, "max_len": 8192, "chunk": CHUNK,
               "prefill_buckets": [128, 512, 2048]}
WITHIN_GEN = dict(ROLLING_GEN, max_len=4096)
ROLLING_PROMPT_LENS, WITHIN_PROMPT_LENS = (6000, 4090, 2000, 100), (4000, 1000)
ROLLING_MAX_TOKENS, ROLLING_WALL_REPS = 64, 5
ROLLING_FP32_LAYERS, ROLLING_FP32_PROMPT, ROLLING_FP32_TOKENS = 2, 4200, 48
ROLLING_PREFIX_HEAD, ROLLING_PREFIX_TAILS = 5000, (300, 700)
ROLLING_SPEC_PROMPT = 4200
MISTRAL_HF_LAYERS, MISTRAL_HTTP_PROMPT = 4, 5000
# (ii)-(v) run Mistral-7B-v0.1's widths cut to ROLLING_LAYERS layers (its
# published config is checked whole): the depth pays for phases 4l's and
# 4m's time.
ROLLING_LAYERS = 8
# 4i: disaggregated roles on phase 4's llama3_8b, every engine over one
# module at phase 4's settings paged (blocks of KV_BLOCK_SIZE). A prefill
# engine ships, a decode engine admits. (ii) One request at
# DISAGG_TEMPERATURE on the fifth of phase 4's prompts, alone on each
# side; the unified and prefill engines share DISAGG_SEED and the decode
# engine's own seed differs, so bit-equality shows the shipped generator
# state was adopted. (iii)-(v) phase 4's longest greedy prompt alone on
# each side. The step windows: DISAGG_ROWS short requests of
# DISAGG_ROW_TOKENS decode while the longest prompt is prefilled (on the
# prefill engine, or admitted by the same unified engine); a window closes
# once DISAGG_WINDOW_CHUNKS more chunks were fetched. The HTTP case's
# small decode pool (DISAGG_SMALL_BLOCKS) can never hold that prompt.
DISAGG_TEMPERATURE, DISAGG_SEED = 0.8, SEED + 41
DISAGG_ROWS, DISAGG_ROW_TOKENS, DISAGG_WINDOW_CHUNKS = 3, 160, 2
DISAGG_SMALL_BLOCKS = 64
# 4i runs phase 4's llama3_8b cut to DISAGG_LAYERS layers (its widths
# whole): the depth pays for phases 4l's and 4m's time.
DISAGG_LAYERS = 8
# 4j: the Gemma 1/2/3 and Qwen2 config flags on random weights from the
# seed, each config from its published config.json (google/gemma-7b,
# google/gemma-2-9b, google/gemma-3-1b-pt, Qwen/Qwen2-7B) through
# `hf_import.config_from_hf`; the (1 + w) norm scales and Qwen2's QKV
# biases drawn N(0, GEMMA_DRAW_STD) so those paths do work. (i) Gemma-7B
# whole over HTTP: GEMMA_PROMPT_LENS at once on GEMMA_GEN, MAX_TOKENS ids
# each; (ii) Gemma-2-9B's widths at GEMMA2_LAYERS layers, one
# GEMMA2_PROMPT-token prompt past the window (GEMMA2_GEN: max_len 8192);
# (iii) Gemma-3-1B whole, GEMMA3_WITHIN_LENS within the window (max_len
# 512) and GEMMA3_PAST_LENS past it (max_len 2048); (iv) Qwen2-7B's widths
# at QWEN2_LAYERS layers as a huggingface bundle over --storage-uri, bf16
# and int8, QWEN2_PROMPT_LENS. Then the W8A16 op at Gemma's tied
# unembedding and at Qwen2-7B's widths (GEMMA_W8A16_SHAPES).
GEMMA7B_CONFIG = {"architectures": ["GemmaForCausalLM"],
                  "attention_bias": False, "attention_dropout": 0.0,
                  "bos_token_id": 2, "eos_token_id": 1, "head_dim": 256,
                  "hidden_act": "gelu", "hidden_size": 3072,
                  "initializer_range": 0.02, "intermediate_size": 24576,
                  "max_position_embeddings": 8192, "model_type": "gemma",
                  "num_attention_heads": 16, "num_hidden_layers": 28,
                  "num_key_value_heads": 16, "pad_token_id": 0,
                  "rms_norm_eps": 1e-06, "rope_scaling": None,
                  "rope_theta": 10000.0, "torch_dtype": "bfloat16",
                  "use_cache": True, "vocab_size": 256000}
GEMMA2_9B_CONFIG = {"architectures": ["Gemma2ForCausalLM"],
                    "attention_bias": False, "attention_dropout": 0.0,
                    "attn_logit_softcapping": 50.0, "bos_token_id": 2,
                    "cache_implementation": "hybrid", "eos_token_id": 1,
                    "final_logit_softcapping": 30.0, "head_dim": 256,
                    "hidden_act": "gelu_pytorch_tanh",
                    "hidden_activation": "gelu_pytorch_tanh",
                    "hidden_size": 3584, "initializer_range": 0.02,
                    "intermediate_size": 14336,
                    "max_position_embeddings": 8192, "model_type": "gemma2",
                    "num_attention_heads": 16, "num_hidden_layers": 42,
                    "num_key_value_heads": 8, "pad_token_id": 0,
                    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06,
                    "rope_theta": 10000.0, "sliding_window": 4096,
                    "sliding_window_size": 4096, "torch_dtype": "float32",
                    "use_cache": True, "vocab_size": 256000}
GEMMA3_1B_CONFIG = {"architectures": ["Gemma3ForCausalLM"],
                    "attention_bias": False, "attention_dropout": 0.0,
                    "attn_logit_softcapping": None, "bos_token_id": 2,
                    "cache_implementation": "hybrid", "eos_token_id": 1,
                    "final_logit_softcapping": None, "head_dim": 256,
                    "hidden_activation": "gelu_pytorch_tanh",
                    "hidden_size": 1152, "initializer_range": 0.02,
                    "intermediate_size": 6912,
                    "max_position_embeddings": 32768,
                    "model_type": "gemma3_text", "num_attention_heads": 4,
                    "num_hidden_layers": 26, "num_key_value_heads": 1,
                    "pad_token_id": 0, "query_pre_attn_scalar": 256,
                    "rms_norm_eps": 1e-06, "rope_local_base_freq": 10000,
                    "rope_scaling": None, "rope_theta": 1000000,
                    "sliding_window": 512, "sliding_window_pattern": 6,
                    "torch_dtype": "bfloat16", "use_cache": True,
                    "vocab_size": 262144}
QWEN2_7B_CONFIG = {"architectures": ["Qwen2ForCausalLM"],
                   "attention_dropout": 0.0, "bos_token_id": 151643,
                   "eos_token_id": 151643, "hidden_act": "silu",
                   "hidden_size": 3584, "initializer_range": 0.02,
                   "intermediate_size": 18944,
                   "max_position_embeddings": 131072,
                   "max_window_layers": 28, "model_type": "qwen2",
                   "num_attention_heads": 28, "num_hidden_layers": 28,
                   "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
                   "rope_theta": 1000000.0, "sliding_window": 131072,
                   "tie_word_embeddings": False, "torch_dtype": "bfloat16",
                   "use_cache": True, "use_sliding_window": False,
                   "vocab_size": 152064}
GEMMA7B_PARAMS, GEMMA7B_NAME = 8_537_680_896, "gemma_7b"
GEMMA_DRAW_STD = 0.05
# (i)'s first-token logits against the plain attention: within this
# factor of phase 3's floor (naive_attention's rel-L2 at llama3_8b).
GEMMA_LOGITS_VS_FLOOR = 1.25
GEMMA_GEN = {"slots": 4, "max_len": 4096, "chunk": CHUNK,
             "prefill_buckets": [128, 512, 2048]}
GEMMA_PROMPT_LENS = (100, 400, 1000, 2000)
GEMMA2_LAYERS, GEMMA2_PROMPT = 4, 4200
GEMMA2_GEN = dict(GEMMA_GEN, slots=1, max_len=8192)
GEMMA3_WITHIN = dict(GEMMA_GEN, max_len=512, prefill_buckets=[128, 512])
GEMMA3_PAST = dict(GEMMA_GEN, max_len=2048)
GEMMA3_WITHIN_LENS, GEMMA3_PAST_LENS = (100, 300), (700, 1500)
QWEN2_LAYERS, QWEN2_NAME = 4, "qwen2_7b"
QWEN2_PROMPT_LENS = (300, 1500)
# (M, K, N, unembedding): Gemma-7B's tied unembedding at 4 and 1 rows;
# Qwen2-7B's q/o, k/v, gate/up and down projections at the decode rows (1,
# 4) and at (iv)'s two prefill buckets (512, 2048), and its untied
# unembedding at the decode rows (an admission unembeds one row).
QWEN2_PROJ_KN = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
GEMMA_W8A16_SHAPES = ([(m, 3072, 256000, True) for m in (4, 1)]
                      + [(m, k, n, False) for m in (1, 4, 512, 2048)
                         for k, n in QWEN2_PROJ_KN]
                      + [(m, 3584, 152064, True) for m in (4, 1)])
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
# 4k: fixed-forward serving. BERT-base at the widths of
# google-bert/bert-base-uncased's config.json (vocab 30522, hidden 768, 12
# layers of 12 heads, intermediate 3072, 512 positions, 2 token types, erf
# GELU, eps 1e-12, pad id 0) with a 2-label sequence-classification head,
# weights drawn from the seed and written in HF names; served as a
# "huggingface" bundle over --storage-uri at seq_len 128, buckets 1-32.
BERT_CONFIG = {"architectures": ["BertForSequenceClassification"],
               "model_type": "bert", "vocab_size": 30522,
               "hidden_size": 768, "intermediate_size": 3072,
               "num_hidden_layers": 12, "num_attention_heads": 12,
               "max_position_embeddings": 512, "type_vocab_size": 2,
               "hidden_act": "gelu", "layer_norm_eps": 1e-12,
               "pad_token_id": 0, "position_embedding_type": "absolute",
               "id2label": {"0": "LABEL_0", "1": "LABEL_1"}}
BERT_SEQ, BERT_BUCKETS, BERT_NAME = 128, (1, 2, 4, 8, 16, 32), "bert_base"
# bf16 BERT logits against an fp32 forward of the same weights: bf16 rounds
# at ~85 points a layer through 12 LayerNormed layers, and the 2-label
# logits of a random head are small (|z| ~ 0.5), so their rel-L2 is the
# noisiest read. The same code on the CPU measured 2.0e-2 over 8 rows (3.7e-2
# on the worst row); the repository's absolute bf16 logits bound (5e-2)
# holds them, and the card read 7.3e-3.
BERT_TOL = LOGITS_REL_L2_MAX
# A row right-padded to 128 tokens against the same row cut to its 70: the
# attention and its softmax run over other lengths, so bf16 rounds them
# otherwise; the card read 3.79e-3 in three calls (about one bf16 ulp,
# 2^-8), so 1e-2.
BERT_PAD_TOL = 1e-2
# A burst row (coalesced into a larger bucket) against the same row alone:
# the same length, only the bucket's row count differs; the card read
# 2.7e-7 to 2.9e-7 in three calls, so 1e-3, a quarter of a bf16 ulp. The
# distinct rows' own logits must lie more than 10x that apart, so that a row
# delivered to another caller fails the gate.
BERT_BURST_TOL = 1e-3
# int8 BERT against the bf16 bundle's logits: the weights' per-channel int8
# rounding (about 1% of a weight's spread) through 73 projections; the
# CPU run measured 4.4e-2 (5.4e-2 from fp32), so 1e-1.
BERT_INT8_TOL = 1e-1
BERT_BURST, EXPLAIN_ROWS, BERT_PAD_LEN = 16, 2, 70
IG_STEPS, IG_GAP = 32, 0.01  # completeness within 1% of |f(x) - f(x0)|
# (v): llama_1b's registry bundle, its example width (16 tokens), a bucket
# of 8 rows; (vi): llama_1b's widths at 2 layers with rank-16 attn_mlp
# adapters on int8 projections, one 128-token prompt; (vii): phase 4's
# llama3_8b server, 2 rows of 16 tokens: a [2, S, 128256] fp32 answer is
# ~5 MB of JSON a token of S (the 4.1M floats of S 16 took 4.5 s a call over
# HTTP on the H100's host, so S 128 would take ~36 s a call); phase 2's
# KERNEL_CASES holds B1 at this shape against its plain version.
FIXED_1B_ROWS, LORA_INT8_LAYERS, LORA_INT8_PROMPT = 8, 2, 128
FIXED_8B_ROWS, FIXED_8B_TOKENS = 2, 16
# 4l: the mixture-of-experts family (models/moe.py), weights from the
# seed. (i) mistralai/Mixtral-8x7B-v0.1's widths (the registry's
# mixtral_8x7b: 8 experts, top-2, capacity 1.25, so prefill buckets drop)
# in bf16 at MIXTRAL_BF16_LAYERS layers: layer 0's routed block on the
# serving path against the plain one-hot route (`forward_plain`) in fp32
# on a MIXTRAL_FP32_PROMPT-token input; MOE_PROMPT_LENS at once on flat and
# paged engines at depth 1 and 2 (ids equal across the four); a 4-row
# decode step. (ii) mixtral_8x7b whole (32 layers, 46.7B parameters) in
# int8, built part by part from the seed by the registry bundle, behind the
# HTTP server at depth 2: MOE_PROMPT_LENS at once on :generate and the
# longest again as a stream; the W8A16 launches of a decode step by
# kernel; the step's wall and device time against its bound; layer 0's
# int8 experts against the op's plain version and against the same codes
# dequantized to bf16. (iii) Qwen/Qwen1.5-MoE-A2.7B's config.json at
# QWEN_MOE_LAYERS layers (QKV biases drawn N(0, GEMMA_DRAW_STD)), written as
# a huggingface checkpoint and served over --storage-uri in bf16
# (dropless, 60 experts, top-4, a shared expert): the first token's logits
# against the fp32 function, ids over HTTP against the engine's.
MIXTRAL_BF16_LAYERS, MIXTRAL_FP32_PROMPT = 4, 2048
MIXTRAL_PARAMS = 46_702_792_704
MOE_GEN = {"slots": 4, "max_len": 4096, "chunk": CHUNK,
           "prefill_buckets": [128, 512, 2048]}
MOE_PROMPT_LENS, MOE_MAX_TOKENS, MOE_NAME = (100, 400, 1000, 2000), 16, "moe"
# The serving path against the plain route in fp32: the same products
# summed in other orders (bmm over the buffer, einsum over one-hot
# tensors), ~1e-6 apart; 1e-5 leaves room and is far under any routing
# change, which moves a token's output by O(1).
MOE_FP32_TOL = 1e-5
# ... also at this capacity factor, where a 2048-token chunk's 4096 choices
# (512 an expert on average) overflow 256 slots: the drop path on the card.
MOE_DROP_CAPACITY = 0.5
# Layer 0's int8 experts against the same codes dequantized to bf16 (what
# JAX's QuantizedModule feeds its einsum): the weights' bf16 rounding
# (2^-9 relative) against the op's fp32 scale, through SwiGLU; the CPU
# test of the same comparison at 256 x 512 reads ~3e-3.
MOE_DEQUANT_TOL = 1e-2
QWEN_MOE_CONFIG = {"architectures": ["Qwen2MoeForCausalLM"],
                   "model_type": "qwen2_moe", "vocab_size": 151936,
                   "hidden_size": 2048, "intermediate_size": 5632,
                   "moe_intermediate_size": 1408,
                   "shared_expert_intermediate_size": 5632,
                   "num_hidden_layers": 24, "num_attention_heads": 16,
                   "num_key_value_heads": 16, "num_experts": 60,
                   "num_experts_per_tok": 4, "norm_topk_prob": False,
                   "decoder_sparse_step": 1, "mlp_only_layers": [],
                   "max_position_embeddings": 8192, "rope_theta": 1000000.0,
                   "rms_norm_eps": 1e-06, "router_aux_loss_coef": 0.001,
                   "sliding_window": 32768, "use_sliding_window": False,
                   "max_window_layers": 21, "tie_word_embeddings": False,
                   "hidden_act": "silu", "torch_dtype": "bfloat16",
                   "bos_token_id": 151643, "eos_token_id": 151643}
QWEN_MOE_PARAMS, QWEN_MOE_ACTIVE = 14_315_784_192, 2_689_173_504
QWEN_MOE_LAYERS, QWEN_MOE_NAME = 2, "qwen15_moe"
QWEN_MOE_PROMPT_LENS = (100, 1000)
# 4m: GPT-2 and the T5 family (models/gpt2.py, models/t5.py), weights from
# the seed, each written by the port's writer under HF's names with the
# published config.json and served over --storage-uri (huggingface format).
# (i) openai-community/gpt2's config (GPT-2-small: 12 x 768, 12 heads,
# 1024 positions, vocab 50257, gelu_new), the checkpoint in GPT-2's Conv1D
# layout with the fused c_attn, biases drawn N(0, GEMMA_DRAW_STD): fp32
# over HTTP (ids against the cache-free teacher-forced replay), the paged
# engine (ids against the flat), bf16 and int8 engines (first-token logits
# and a 4-row decode step), and the W8A16 op at the unembedding's odd N.
GPT2_CONFIG = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
               "vocab_size": 50257, "n_embd": 768, "n_layer": 12,
               "n_head": 12, "n_positions": 1024, "n_ctx": 1024,
               "n_inner": None, "activation_function": "gelu_new",
               "layer_norm_epsilon": 1e-05, "scale_attn_weights": True,
               "bos_token_id": 50256, "eos_token_id": 50256,
               "initializer_range": 0.02, "resid_pdrop": 0.1,
               "embd_pdrop": 0.1, "attn_pdrop": 0.1}
GPT2_GEN = {"slots": 4, "max_len": 1024, "chunk": CHUNK,
            "prefill_buckets": [64, 256]}
GPT2_BLOCK, GPT2_NAME = 16, "gpt2"
GPT2_PROMPT_LENS = (16, 250, 700, 960)
# (ii) google-t5/t5-base's and google/flan-t5-base's configs at full depth
# (12 + 12 layers of 768, 12 heads of 64; relu and tied, or gated-gelu,
# d_ff 2048 and untied), weights drawn as HF's T5 initialises them (the
# port's init_weights, q and the relative-position tables rescaled:
# `_t5_model`), served by :generate: T5_REQUEST_LENS one after another,
# fp32 tokens against the teacher-forced argmax, bf16 and int8 first-step
# logits, one int8 request under set_sync_debug_mode("error").
T5_BASE_CONFIG = {"architectures": ["T5ForConditionalGeneration"],
                  "model_type": "t5", "vocab_size": 32128, "d_model": 768,
                  "d_kv": 64, "d_ff": 3072, "num_layers": 12,
                  "num_decoder_layers": 12, "num_heads": 12,
                  "relative_attention_num_buckets": 32,
                  "relative_attention_max_distance": 128,
                  "layer_norm_epsilon": 1e-06, "feed_forward_proj": "relu",
                  "tie_word_embeddings": True, "decoder_start_token_id": 0,
                  "eos_token_id": 1, "pad_token_id": 0,
                  "initializer_factor": 1.0}
FLAN_T5_BASE_CONFIG = dict(T5_BASE_CONFIG, d_ff=2048,
                           feed_forward_proj="gated-gelu",
                           tie_word_embeddings=False)
T5_GEN = {"in_buckets": [64, 512], "max_tokens": 64}
T5_REQUEST_LENS, T5_MIN_VALID = (10, 60, 300, 500), 32
# int8 against bf16: the gate holds the int8 path (the W8A16 op, its
# rounding points) against the bf16 model of the same codes dequantized,
# within LOGITS_REL_L2_MAX; against the original bf16 weights the int8
# rounding of the weights itself shows (~1% of a weight's spread, 2.4e-2
# to 3.5e-2 measured on the CPU at reduced widths for these families), so
# that one is held at 4k's BERT_INT8_TOL.
GPT2_T5_TOL = 2e-2
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
RING_NS, RING_BS, RING_SS = (2, 4, 8), (1,), (512, 800, 2048)
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
# Gemma-3-1B's (google/gemma-3-1b-pt: 4 heads, 1 kv head, head_dim 256) at
# its window's prompt bucket, 512: phase 4j's within-window prefill.
SIMT_GEMMA3_CASE = (1, 512, 512, 4, 1, 256, fa.MaskSpec("causal"), False,
                    torch.bfloat16)
SIMT_BWD_DESIGN = ("cuda cores, fp32, register-tiled micro-tiles, cp.async "
                   "ring, per-tile masks, planned grid with split dk/dv")
SIMT_FWD_DESIGN = ("bf16/fp16: tensor cores, mma.sync m16n8k16, ldmatrix "
                   "fragments, online softmax in registers; fp32: cuda "
                   "cores, register-tiled micro-tiles; both: cp.async ring, "
                   "per-tile masks, planned grid")


def log(*a):
    print(*a, flush=True)


def _free() -> None:
    """Collect garbage and return the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


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
    # Qwen2-7B's attention (Qwen/Qwen2-7B config.json: 28 heads, 4 kv
    # heads, a GQA group of 7) at 4j (iv)'s 2048-token prefill bucket.
    (1, 2048, 2048, 28, 4, 128, fa.MaskSpec("causal"), False),
    # llama_1b's attention (16/8 heads) as 4k (v)'s fixed-forward predict
    # runs it: a bucket of 8 rows at its registry width (16 tokens), and
    # at the 128 tokens of a huggingface fixed-forward bundle.
    (8, 16, 16, 16, 8, 128, fa.MaskSpec("causal"), False),
    (8, 128, 128, 16, 8, 128, fa.MaskSpec("causal"), False),
    # llama3_8b's attention as 4k (vii)'s :predict and /infer on phase 4's
    # generative server run it: FIXED_8B_ROWS rows of FIXED_8B_TOKENS.
    (FIXED_8B_ROWS, FIXED_8B_TOKENS, FIXED_8B_TOKENS, 32, 8, 128,
     fa.MaskSpec("causal"), False),
    # Qwen1.5-MoE-A2.7B's attention (16 heads, 16 kv heads) at 4l (iii)'s
    # 2048-token prefill bucket (Mixtral's 32/8 is the 8B row above).
    (1, 2048, 2048, 16, 16, 128, fa.MaskSpec("causal"), False),
]
# The llama_1b training shape (batch 12, seq 1024, 16/8 heads, Dh 128),
# and phase 5c's llama3_8b one (batch 4, seq 2048, 32/8 heads).
TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 8, 128,
              fa.MaskSpec("causal"), False)
LORA_CASE = (LORA_BATCH, LORA_SEQ, LORA_SEQ, 32, 8, 128,
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
    shapes and the two training shapes (llama_1b's, phase 5c's
    llama3_8b)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows, worst = [], {n: {"max_abs": 0.0, "rel_l2": 0.0}
                       for n in ("dq", "dk", "dv")}
    for case in KERNEL_CASES + [TRAIN_CASE, LORA_CASE]:
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
        fwd_bound, fwd_by = _bound(
            4 * d * pairs, 2 * (q.numel() + k.numel() + v.numel()
                                + out.numel()) + 4 * lse.numel() + seg_bytes)
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
            f"{delta_ms:.4f} fwd_ms {fwd_ms:.4f} (bound {fwd_bound:.4f}, "
            f"{fwd_by}; SDPA fwd {fwd_library_ms:.4f}) plain_bwd_ms "
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
                     "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
                     "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by})
    return {"rows": rows, "main": rows[-2], "lora": rows[-1],
            "worst": worst}


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
    phase 6's configs at its batch, then SIMT_EXTRA_CASE, SIMT_GEMMA_CASE
    and SIMT_GEMMA3_CASE."""
    cases = []
    for name in gk.C1_CONFIGS:
        cfg = gk.c1_config(name)
        cases.append((gk.C1_BATCH, gk.C1_SEQ, gk.C1_SEQ, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim, fa.MaskSpec("causal"),
                      False, cfg.dtype))
    return cases + [SIMT_EXTRA_CASE, SIMT_GEMMA_CASE, SIMT_GEMMA3_CASE]


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
    moe = [(m, k, n, torch.bfloat16, False)
           for m, k, n in gk.MOE_W8A16_CASES]
    for case, is_moe in ([(c, False) for c in gk.W8A16_CASES]
                         + [(c, True) for c in moe]):
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
        if (not is_moe and (n * k < 4096 * 1024 or dtype != torch.bfloat16
                            or m not in W8A16_TIMED_M)) or n == 1:
            # correctness only
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
                     "rel_l2": err["rel_l2"], "host_us": enqueue,
                     "moe": is_moe})
        del x, q, scale
    torch.cuda.empty_cache()
    main = next(r for r in rows
                if r["shape"] == "M{} K{} N{}".format(*W8A16_MAIN))
    steps = {}
    for m in (1, 4, 16):
        # The step's five weights, each with its own epilogue (the dense
        # one, the unembedding's for the 128256-row table).
        mine = {(r["k"], r["n"]): r for r in rows
                if r["m"] == m and not r["moe"]
                and (r["k"], r["n"]) in W8A16_STEP
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
    _free()
    return {"rows": rows, "worst": worst}


def phase_model() -> float:
    """llama3_8b logits, attention through the kernel vs the plain version.
    Returns naive_attention's rel-L2 from the plain version (the bf16
    floor later phases scale their bounds by)."""
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
    return floor


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _serving(bundle: str, generative: dict | None = None,
             max_inflight: int = 256, **spec):
    """(Re)write the llama3_8b bundle at `bundle` with phase 4's generative
    block updated by `generative` and the extra bundle keys `spec`, load it
    behind the port's HTTP server (admitting `max_inflight` requests at
    once), and yield the server's base URL. The server and its model are
    freed on exit."""
    _free()
    export_for_serving(bundle, model=MODEL, model_kwargs=MODEL_KWARGS,
                       seed=SEED, extra={
                           "generative": {**GENERATIVE, **(generative or {})},
                           **spec})
    server = ModelServer(max_inflight=max_inflight)
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
        _free()


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


def _step_ms(after: dict, before: dict | None = None) -> float:
    """Host-inclusive engine ms per decode step between two stats
    snapshots (`before` None: since the engine started)."""
    before = before or {"decode_dispatches": 0, "decode_seconds": 0.0}
    steps = (after["decode_dispatches"] - before["decode_dispatches"]) * CHUNK
    return (after["decode_seconds"] - before["decode_seconds"]) / steps * 1e3


def _alone_at_depth1(bundle: str, generative: dict, body: dict,
                     **spec) -> tuple:
    """(response, host-inclusive ms per step) of `body` alone on a server
    of the same bundle at pipeline_depth 1."""
    with _serving(bundle, {**generative, "pipeline_depth": 1},
                  **spec) as (base, _):
        out = _post(f"{base}/v1/models/{MODEL}:generate", body)
        ms = _step_ms(_metadata(base)["stats"])
    return out, ms


def _alone_on_depth1_engine(server: ModelServer, body: dict) -> tuple:
    """(response, host-inclusive ms per step) of `body` alone on a
    pipeline_depth-1 engine over the served module, with the served
    engine's settings (a second engine beside it: no second load)."""
    served = server.models[MODEL]
    eng = GenerationEngine(served._model,
                           **{**served._gen_cfg, "pipeline_depth": 1})
    try:
        b = dict(body)
        out = eng.submit(b.pop("input_ids"), timeout=600,
                         eos_id=served.eos_id, **b)
        ms = _step_ms(eng.stats_snapshot())
    finally:
        _close(eng)
    return out, ms


def _depth_line(depth2: dict, depth2_ms: float, depth1: dict,
                depth1_ms: float, where: str = "a second server") -> None:
    """Log the longest prompt's step time at both depths; fail unless the
    greedy ids are equal."""
    same = depth1["output_ids"] == depth2["output_ids"]
    log(f"  longest prompt alone: pipeline_depth 1 on {where} "
        f"{'gives the same' if same else 'DIFFERS from the'} greedy ids "
        f"as depth 2; ms per step (host-inclusive, 1 row): depth 2 "
        f"{depth2_ms:.2f}, depth 1 {depth1_ms:.2f}")
    if not same:
        raise RuntimeError("depth-1 greedy ids differ from depth 2")


def _plain_and_naive(module, tokens) -> tuple:
    """`module`'s fp32 logits on `tokens` (on the host), its attention
    through the flash kernel's plain version, then through naive_attention:
    the reference and the bf16 floor that a logits gate scales by."""
    real = llama_mod.flash_attention

    def plain(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return fa._flash_fwd_plain(q, k, v, fa._norm_mask(causal, mask),
                                   segment_ids)[0]

    def naive(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return naive_attention(q, k, v, causal=causal, mask=mask,
                               segment_ids=segment_ids)

    try:
        with torch.inference_mode():
            llama_mod.flash_attention = plain
            ref = module(tokens).float().cpu()
            llama_mod.flash_attention = naive
            nv = module(tokens).float().cpu()
    finally:
        llama_mod.flash_attention = real
    return ref, nv


def _generative_predict(base: str, server: ModelServer, vocab: int,
                        floor: float) -> dict:
    """4k (vii) on phase 4's server: one :predict and one /infer of
    FIXED_8B_ROWS rows of FIXED_8B_TOKENS tokens through the model's
    batcher (full-forward logits, no cache). Gates: B1 num_layers launches
    a call, /infer equal to :predict, every position's logits within 1.25x
    naive_attention's distance of a forward of the served module on the
    same rows with its attention through the plain version, as (v) holds
    its own, and the last prompt position's logits within 1.25x phase 3's
    floor of the engine's first-token logits for the same prompt (two bf16
    computations of one function over other shapes: a 2-row forward and a
    prefill padded to its bucket), as 4j holds its first tokens."""
    model = server.models[MODEL]
    rows = np.random.default_rng(SEED + 29).integers(
        0, vocab, (FIXED_8B_ROWS, FIXED_8B_TOKENS))
    before = _b1_launches()
    t0 = time.monotonic()
    pred = np.asarray(_post(f"{base}/v1/models/{MODEL}:predict", {
        "instances": rows.tolist()})["predictions"], np.float32)
    predict_s = time.monotonic() - t0
    b1_predict = _b1_launches() - before
    before = _b1_launches()
    out = _post(f"{base}/v2/models/{MODEL}/infer", {"inputs": [{
        "name": "input_0", "shape": list(rows.shape), "datatype": "INT64",
        "data": rows.ravel().tolist()}]})["outputs"][0]
    b1_infer = _b1_launches() - before
    infer = np.asarray(out["data"], np.float32).reshape(out["shape"])
    first: list = []
    with _first_logits(model._model, first):
        model.engine.submit(rows[0].tolist(), max_tokens=1, timeout=600)
    rel = _rel_l2(torch.from_numpy(pred[0, -1]), first[0].cpu())
    ref, nv = _plain_and_naive(model._model,
                               torch.from_numpy(rows).to(DEVICE))
    rel_plain, naive = _rel_l2(torch.from_numpy(pred), ref), _rel_l2(nv, ref)
    del ref, nv
    layers = model.cfg.num_layers
    gates = {"B1 launches a call": b1_predict == b1_infer == layers,
             "/infer = :predict": np.array_equal(infer, pred),
             "logits vs plain attention": rel_plain <= LOGITS_VS_NAIVE * naive,
             "last position vs the engine's first token":
                 rel <= LOGITS_VS_NAIVE * floor}
    log(f"  (vii) :predict of {FIXED_8B_ROWS} x {FIXED_8B_TOKENS} tokens: "
        f"[{', '.join(map(str, pred.shape))}] fp32 logits in "
        f"{predict_s:.2f}s over HTTP; B1 launches :predict {b1_predict}, "
        f"/infer {b1_infer} (expected {layers} each); /infer "
        f"{'equals' if gates['/infer = :predict'] else 'DIFFERS from'} "
        f":predict; logits vs plain attention rel_l2 {rel_plain:.3e}, "
        f"naive_attention {naive:.3e} (bound {LOGITS_VS_NAIVE} x naive); "
        f"last position vs the engine's first-token logits "
        f"rel_l2 {rel:.3e} (bound {LOGITS_VS_NAIVE} x phase 3's floor "
        f"{floor:.3e}); " + ", ".join(
            f"{g} {'OK' if ok else 'FAIL'}" for g, ok in gates.items()))
    if not all(gates.values()):
        raise RuntimeError(f"4k (vii) gates failed: {gates}")
    return {"launches": b1_predict + b1_infer, "predict_s": predict_s,
            "rel_l2": rel, "rel_l2_plain": rel_plain}


def phase_serving(bundle: str, floor: float) -> dict:
    """The port's main path: bundle -> server -> concurrent :generate;
    then 4k (vii), :predict and /infer on the same server. Returns the
    kernel launches and the numbers later phases compare with."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    bodies = _bodies(cfg.vocab_size)
    with _serving(bundle) as (base, server):
        fa.flash_fwd_launches = 0
        run = _concurrent(base, bodies)
        # The longest prompt again, alone: it decodes at the same cache
        # bucket (4096) either way, so greedy ids must repeat exactly.
        again = _post(f"{base}/v1/models/{MODEL}:generate", bodies[-1])
        launches = fa.flash_fwd_launches
        alone_ms = _step_ms(_metadata(base)["stats"], run["stats"])
        depth = run["metadata"]["pipeline_depth"]
        prof = _profile_decode(server)
        predict = _generative_predict(base, server, cfg.vocab_size, floor)
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
            "sync_alone_ms": sync_ms, "prefill_s": prefill_s,
            "predict": predict}


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
    step_ms = _step_ms(md["stats"])
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
        sync, sync_ms = _alone_on_depth1_engine(server, bodies[-1])
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
    alone_ms = _step_ms(total, stats)
    _depth_line(again, alone_ms, sync, sync_ms,
                "a second engine over the served int8 module")
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


def _request(method: str, url: str, body=None, headers=None) -> tuple:
    """(status, headers, body bytes) of one request; HTTP errors are
    returned, not raised. A bytes body (a KV frame) is sent as it is."""
    data = (body if isinstance(body, bytes) or body is None
            else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _stream(url: str, body: dict, headers=None) -> dict:
    """POST a streaming request and read it frame by frame (ndjson lines or
    SSE `data:` frames): {"status", "content_type", "frames", "first_s",
    "end_s"} (seconds from the send to the first frame and to the end). A
    bytes body (a KV frame to :decode) is sent as it is."""
    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=600)
    t0 = time.monotonic()
    raw = isinstance(body, bytes)
    conn.request("POST", parts.path, body if raw else json.dumps(body),
                 {"Content-Type": (server_mod.KV_SHIPMENT_CONTENT_TYPE
                                   if raw else "application/json"),
                  **(headers or {})})
    resp = conn.getresponse()
    frames, first = [], None
    for line in resp:
        line = line.strip()
        if not line:
            continue
        if first is None:
            first = time.monotonic() - t0
        if line.startswith(b"data: "):
            line = line[len(b"data: "):]
            frames.append("[DONE]" if line == b"[DONE]"
                          else json.loads(line))
        else:
            frames.append(json.loads(line))
    end = time.monotonic() - t0
    out = {"status": resp.status,
           "content_type": resp.getheader("Content-Type"),
           "frames": frames, "first_s": first, "end_s": end}
    conn.close()
    return out


def _openai_ids(tokens: list) -> list:
    """Token ids back from the "bytes" tokenizer's logprob strings: the
    character of a printable byte, bytes:0xNN for the other bytes, the id
    itself past 255."""
    return [int(t[len("bytes:"):], 16) if t.startswith("bytes:")
            else ord(t) if len(t) == 1 else int(t) for t in tokens]


def _metric(text: str, sample: str) -> float:
    """The value of one exposition sample line (`name{labels}`)."""
    for line in text.splitlines():
        if line.startswith(sample + " "):
            return float(line.split(" ")[1])
    raise RuntimeError(f"/metrics has no sample {sample}")


def phase_surface(bundle: str, flat: dict) -> dict:
    """The request surface (4d) on phase 4's bundle with the "bytes"
    tokenizer, behind a server admitting SURFACE_MAX_INFLIGHT requests: the
    surfaces at once, a stream, deadlines, admission, /metrics, the OpenAI
    routes, and a version swap through the repository API. Every prefill
    of the phase goes through the flash kernel."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    bodies = _bodies(cfg.vocab_size)
    longest = bodies[-1]
    gen_url = f"/v1/models/{MODEL}:generate"
    served = 0  # requests the latency histogram must count
    res_metrics.reset()
    with _serving(bundle, {"tokenizer": "bytes"},
                  max_inflight=SURFACE_MAX_INFLIGHT) as (base, server):
        _reset_counts()
        one_model = torch.cuda.memory_allocated()
        # 1. Phase 4's six bodies at once across the surfaces: (status,
        # tokens out, their ids where the surface returns them).
        launches0 = fa.flash_fwd_launches
        results = [None] * len(bodies)

        def run(i):
            b = bodies[i]
            try:
                if i < 2:
                    code, _, raw = _request("POST", base + gen_url, b)
                    ids = json.loads(raw).get("output_ids", [])
                    results[i] = (code, len(ids), ids)
                elif i < 4:
                    s = _stream(f"{base}/v2/models/{MODEL}/generate",
                                {**b, "stream": True})
                    ids = [t for f in s["frames"][:-1] for t in f["tokens"]]
                    results[i] = (s["status"], len(ids), ids)
                else:  # greedy: OpenAI's default temperature is 1
                    body = {"model": MODEL, "prompt": b["input_ids"],
                            "max_tokens": MAX_TOKENS, "temperature": 0}
                    if i == 4:
                        code, _, raw = _request(
                            "POST", base + "/openai/v1/completions",
                            {**body, "logprobs": 0})
                        out = json.loads(raw)
                        ids = _openai_ids(
                            out["choices"][0]["logprobs"]["tokens"])
                        results[i] = (code, out["usage"][
                            "completion_tokens"], ids)
                    else:
                        s = _stream(base + "/openai/v1/completions",
                                    {**body, "stream": True})
                        ok = s["frames"][-1] == "[DONE]"
                        results[i] = (s["status"] if ok else None,
                                      s["frames"][-2]["usage"][
                                          "completion_tokens"], [])
            except Exception as e:  # reported below as a failed request
                results[i] = (None, 0, repr(e))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t0
        served += len(bodies)
        launches = fa.flash_fwd_launches - launches0
        expect = cfg.num_layers * len(bodies)
        for i, (code, n, ids) in enumerate(results):
            surface = (":generate", ":generate", "v2 generate stream",
                       "v2 generate stream", "openai completions",
                       "openai completions stream")[i]
            good = (code == 200 and n == MAX_TOKENS and isinstance(ids, list)
                    and len(ids) in (0, n)
                    and all(0 <= t < cfg.vocab_size for t in ids))
            log(f"  request {i} ({PROMPT_LENS[i]} tokens) on {surface}: "
                f"status {code}, {n} tokens out"
                + ("" if isinstance(ids, list) else f" {ids}")
                + f" {'OK' if good else 'FAIL'}")
            if not good:
                raise RuntimeError(f"request {i} on {surface} failed")
        log(f"  six requests across the surfaces in {wall:.3f}s; flash_fwd "
            f"launches {launches} (expected {cfg.num_layers} x "
            f"{len(bodies)} first-chunk prefills = {expect})")
        if launches != expect:
            raise RuntimeError("a surface's prefill skipped the kernel")
        # 2. The longest greedy prompt, streamed alone (warm, as phase 4's
        # repeat was), then unstreamed on this server: the host's issue per
        # step differs between servers, so the stream is compared here.
        first = _stream(base + gen_url, {**longest, "stream": True})
        t0 = time.monotonic()
        unstreamed = _post(base + gen_url, longest)
        unstreamed_s = time.monotonic() - t0
        served += 2
        frames = first["frames"]
        streamed = [t for f in frames[:-1] for t in f["tokens"]]
        ok = (first["status"] == 200
              and first["content_type"] == "application/x-ndjson"
              and frames[-1].get("done") is True and len(frames) >= 3
              and streamed == frames[-1]["output_ids"]
              == flat["repeat"]["output_ids"] == unstreamed["output_ids"])
        log(f"  stream of the longest prompt ({len(longest['input_ids'])} "
            f"tokens, {MAX_TOKENS} out): {len(frames) - 1} token frames, "
            f"first frame {first['first_s']:.3f}s, done "
            f"{first['end_s']:.3f}s; unstreamed on this server "
            f"{unstreamed_s:.3f}s (engine {unstreamed['latency_s']:.3f}s), "
            f"on phase 4's {flat['repeat']['latency_s']:.3f}s; ids "
            f"{'identical to' if ok else 'DIFFER from'} phase 4's repeat")
        if not ok:
            raise RuntimeError(f"stream {first['status']} {frames[-1]} "
                               "differs from phase 4's repeat")
        # 3. Deadlines: 2000 tokens asked under a 500 ms budget.
        engine = server.models[MODEL].engine
        before = engine.stats_snapshot()
        budget = {"X-Request-Timeout-Ms": str(SURFACE_DEADLINE_MS)}
        late = {"input_ids": bodies[0]["input_ids"],
                "max_tokens": SURFACE_LATE_TOKENS}
        t0 = time.monotonic()
        code, _, raw = _request("POST", base + gen_url, late, budget)
        late_s = time.monotonic() - t0
        # Past the first frame on this host: four chunks of its issue.
        stream_ms = max(SURFACE_STREAM_DEADLINE_MS, math.ceil(
            4e3 * before["decode_seconds"]
            / max(before["decode_dispatches"], 1)))
        st = _stream(base + gen_url, {**late, "stream": True}, {
            "X-Request-Timeout-Ms": str(stream_ms)})
        served += 1  # the stream's status line went out: it is observed
        last = st["frames"][-1]
        t0 = time.monotonic()
        while (time.monotonic() - t0 < 30
               and (engine.inflight_depth
                    or any(s is not None for s in engine._slots))):
            time.sleep(0.005)
        freed_s = time.monotonic() - t0
        after = engine.stats_snapshot()
        chunk_s = after["decode_seconds"] / max(after["decode_dispatches"], 1)
        decoded = after["decode_tokens"] - before["decode_tokens"]
        wasted, dead = (after[k] - before[k] for k in (
            "decode_wasted_tokens", "decode_dead_slot_chunks"))
        ok = (code == 504 and late_s <= SURFACE_DEADLINE_MS / 1e3
              + 2 * chunk_s and st["status"] == 200
              and len(st["frames"]) >= 2
              and set(last) == {"model_name", "error"}
              and "DeadlineExceeded" in last["error"]
              and engine.inflight_depth == 0
              and all(s is None for s in engine._slots)
              and decoded < 2 * SURFACE_LATE_TOKENS)
        log(f"  deadline {SURFACE_DEADLINE_MS} ms on {SURFACE_LATE_TOKENS} "
            f"tokens: {code} after {late_s:.3f}s (bound: budget + 2 chunks "
            f"of {chunk_s:.3f}s); streamed under "
            f"{stream_ms} ms: status {st['status']}, "
            f"first frame {st['first_s']:.3f}s, end {st['end_s']:.3f}s, "
            f"{len(st['frames']) - 1} token frames then "
            f"{json.dumps(last)[:120]}; slots free and nothing in flight "
            f"{freed_s:.3f}s later; decoded {decoded} tokens of the "
            f"{2 * SURFACE_LATE_TOKENS} asked; decode_wasted_tokens "
            f"{wasted}, decode_dead_slot_chunks {dead} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("an expired request was not answered or did "
                               "not free its slot")
        # 4. Admission: a burst past SURFACE_MAX_INFLIGHT.
        burst = [None] * SURFACE_BURST
        ready_during = []

        def hit(i):
            burst[i] = _request("POST", base + gen_url, {
                "input_ids": bodies[1]["input_ids"], "max_tokens": 64})

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(SURFACE_BURST)]
        for th in threads:
            th.start()
        t0 = time.monotonic()
        while (time.monotonic() - t0 < 30
               and sum(b is not None and b[0] == 503 for b in burst)
               < SURFACE_BURST - SURFACE_MAX_INFLIGHT):
            time.sleep(0.002)
        ready_during.append(_request("GET", base + "/v2/health/ready")[0])
        for th in threads:
            th.join(timeout=900)
        t0 = time.monotonic()
        ready_after = _request("GET", base + "/v2/health/ready")[0]
        while ready_after != 200 and time.monotonic() - t0 < 10:
            time.sleep(0.05)
            ready_after = _request("GET", base + "/v2/health/ready")[0]
        sheds = [b for b in burst if b[0] == 503]
        admitted = [b for b in burst if b[0] != 503]
        served += len(admitted)
        ok = (len(sheds) >= SURFACE_BURST - SURFACE_MAX_INFLIGHT
              and all(b[1]["Retry-After"] == "1" for b in sheds)
              and all(b[0] == 200 and len(json.loads(b[2])["output_ids"])
                      == 64 for b in admitted)
              and ready_during == [503] and ready_after == 200)
        log(f"  burst of {SURFACE_BURST} at max_inflight "
            f"{SURFACE_MAX_INFLIGHT}: {len(sheds)} shed (503, Retry-After "
            f"{sorted({b[1]['Retry-After'] for b in sheds})}), "
            f"{len(admitted)} admitted and answered; /v2/health/ready "
            f"{ready_during[0]} while shedding, {ready_after} after "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("admission did not shed, or readiness did "
                               "not degrade and recover")
        # 5. One scrape.
        t0 = time.monotonic()
        code, _, raw = _request("GET", base + "/metrics")
        scrape_ms = (time.monotonic() - t0) * 1e3
        text = raw.decode()
        md = _metadata(base)
        tag = f'{{model="{MODEL}"}}'
        sums = (_metric(text, f"tpk_engine_decode_tokens_total{tag}"),
                _metric(text, f"tpk_serve_request_latency_seconds_count{tag}"),
                _metric(text, f"tpk_serve_requests_total{tag}"),
                _metric(text, 'tpk_deadline_expired_total{component="serve"}'),
                _metric(text, 'tpk_shed_total{component="serve"}'))
        ok = (code == 200 and sums[0] == md["stats"]["decode_tokens"]
              and sums[1] == sums[2] == served and sums[3] == 2
              and sums[4] == len(sheds))
        log(f"  /metrics scrape {scrape_ms:.2f} ms, {len(text)} bytes: "
            f"decode tokens {sums[0]:.0f} (metadata "
            f"{md['stats']['decode_tokens']}), latency histogram count "
            f"{sums[1]:.0f} and requests {sums[2]:.0f} (served {served}), "
            f"deadline expiries {sums[3]:.0f}, sheds {sums[4]:.0f} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("/metrics disagrees with the engine or the "
                               "requests served")
        # 6. OpenAI.
        prompt = {"model": MODEL, "prompt": SURFACE_PROMPT,
                  "max_tokens": MAX_TOKENS, "temperature": 0}
        code, _, raw = _request("POST", base + "/openai/v1/completions",
                                prompt)
        plain = json.loads(raw)
        sse = _stream(base + "/openai/v1/completions",
                      {**prompt, "stream": True})
        joined = "".join(f["choices"][0]["text"] for f in sse["frames"][:-1])
        same_text = joined == plain["choices"][0]["text"]
        chat_code, _, raw = _request(
            "POST", base + "/openai/v1/chat/completions",
            {"model": MODEL, "max_tokens": 8, "temperature": 0,
             "messages": [{"role": "user", "content": SURFACE_PROMPT}]})
        chat = json.loads(raw)
        listed = json.loads(_request("GET", base + "/openai/v1/models")[2])
        served += 3
        ok = (code == 200 and sse["status"] == 200
              and sse["content_type"] == "text/event-stream"
              and sse["frames"][-1] == "[DONE]"
              and same_text
              and plain["usage"]["completion_tokens"] == MAX_TOKENS
              and sse["frames"][-2]["usage"]["completion_tokens"]
              == MAX_TOKENS
              and chat_code == 200
              and chat["choices"][0]["message"]["role"] == "assistant"
              and chat["usage"]["completion_tokens"] == 8
              and [m["id"] for m in listed["data"]] == [MODEL])
        log(f"  OpenAI: completion {code} {plain['usage']}, text "
            f"{plain['choices'][0]['text']!r}; streamed {sse['status']} in "
            f"{len(sse['frames']) - 1} chunks (first {sse['first_s']:.3f}s,"
            f" end {sse['end_s']:.3f}s), joined text "
            f"{'equal' if same_text else 'DIFFERENT'}"
            f", ends in [DONE]; chat {chat_code} "
            f"{chat['choices'][0]['finish_reason']}; models "
            f"{[m['id'] for m in listed['data']]} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the OpenAI routes disagree")
        # 7. A version swap through the repository API.
        req1 = engine.stats_snapshot()["requests"]
        del engine
        second = bundle + "_v2"
        export_for_serving(second, model=MODEL, model_kwargs=MODEL_KWARGS,
                           seed=SEED, extra={"generative": {
                               **GENERATIVE, "tokenizer": "bytes"}})
        grace = ModelRepository.UNLOAD_GRACE_S
        ModelRepository.UNLOAD_GRACE_S = SURFACE_GRACE_S
        try:
            t0 = time.monotonic()
            code, _, raw = _request(
                "POST", f"{base}/v2/repository/models/{MODEL}/load",
                {"model_dir": second})
            landed, peak_during = None, one_model
            while time.monotonic() - t0 < 300:
                peak_during = max(peak_during, torch.cuda.memory_allocated())
                c, _, r = _request("GET", f"{base}/v2/models/{MODEL}/ready")
                if c == 200 and json.loads(r)["model_dir"] == second:
                    landed = time.monotonic() - t0
                    break
                time.sleep(0.05)
            during = torch.cuda.memory_allocated()
            again = _post(base + gen_url, longest)
            served += 1
            time.sleep(SURFACE_GRACE_S + 1.0)
            _free()
            after_mem = torch.cuda.memory_allocated()
            req2 = server.models[MODEL].engine.stats_snapshot()["requests"]
        finally:
            ModelRepository.UNLOAD_GRACE_S = grace
            shutil.rmtree(second, ignore_errors=True)
        phase_launches = fa.flash_fwd_launches
        same = again["output_ids"] == flat["repeat"]["output_ids"]
        ok = (code == 202 and landed is not None and same
              and during > one_model + 0.9 * cfg.num_params * 2
              and after_mem < one_model + 2**30)
        gib = 2**30
        log(f"  repository: load {code}, new model_dir ready after "
            f"{landed if landed is None else round(landed, 3)}s; longest "
            f"prompt on it {'gives' if same else 'DIFFERS from'}"
            f" phase 4's ids; allocated {one_model / gib:.2f} GiB before, "
            f"{during / gib:.2f} during (peak seen {peak_during / gib:.2f}), "
            f"{after_mem / gib:.2f} after the {SURFACE_GRACE_S:.0f} s grace "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the version swap failed or kept the old "
                               "version's memory")
    expect = cfg.num_layers * (req1 + req2)
    log(f"  phase 4d flash_fwd launches {phase_launches} (expected "
        f"{cfg.num_layers} x {req1 + req2} admitted requests = {expect}); "
        f"{smi()}")
    if phase_launches != expect:
        raise RuntimeError("a phase-4d prefill skipped the kernel")
    return {"launches": phase_launches, "first_frame_s": first["first_s"],
            "unstreamed_s": unstreamed_s,
            "late_s": late_s, "scrape_ms": scrape_ms, "swap_s": landed}


def _write_hf_checkpoint(ckpt: str, sd: dict, cfg,
                         config: dict = HF_CONFIG) -> tuple[int, float]:
    """`sd` as an HF checkpoint: `config` as config.json, two shards (the
    embedding and the first half of the layers, then the rest) and their
    index, in the checkpoint's dtypes (norm scales bf16, as HF stores them;
    they widen to fp32 exactly). Returns (bytes written, seconds)."""
    os.makedirs(ckpt, exist_ok=True)
    names = hf_mod.llama_hf_names(cfg)
    half = cfg.num_layers // 2
    first = [h for h in names if h == "model.embed_tokens.weight"
             or any(h.startswith(f"model.layers.{i}.") for i in range(half))]
    shards = {"model-00001-of-00002.safetensors": first,
              "model-00002-of-00002.safetensors":
                  [h for h in names if h not in first]}
    t0 = time.monotonic()
    nbytes = 0
    for shard, hf_names in shards.items():
        nbytes += hf_mod.save_safetensors(
            {h: sd[names[h]].to(torch.bfloat16) for h in hf_names},
            os.path.join(ckpt, shard), metadata={"format": "pt"})
    with open(os.path.join(ckpt, hf_mod.INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": nbytes}, "weight_map": {
            h: shard for shard, hs in shards.items() for h in hs}}, f)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(config, f)
    return nbytes, time.monotonic() - t0


def phase_hf_import(work: str) -> dict:
    """4e (i): an HF checkpoint of llama3_8b's widths (HF_LAYERS layers)
    written from the seed with the port's writer, read back bit-equal,
    served through the server's --storage-uri with the bundle's
    "huggingface" format; its logits bit-equal to the module that wrote
    it, its greedy ids equal to that module's engine; then a PEFT adapter
    folded flat through `peft_adapter`, held against the adapted function
    in fp32."""
    t_phase = time.monotonic()
    cfg = hf_mod.llama_config_from_hf(HF_CONFIG)
    ref = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    sd = ref.state_dict()
    ckpt = os.path.join(work, "hf_llama3_8b")
    nbytes, write_s = _write_hf_checkpoint(ckpt, sd, cfg)
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "generative": GENERATIVE}, f)
    t0 = time.monotonic()
    back = hf_mod.load_safetensors_dir(ckpt)
    names = hf_mod.llama_hf_names(cfg)
    bad = sorted(set(back) ^ set(names)) + [
        h for h in names if h in back
        and not torch.equal(back[h].to(DEVICE), sd[names[h]].to(
            torch.bfloat16))]
    read_s = time.monotonic() - t0
    log(f"  checkpoint: {cfg.num_layers} layers of {MODEL}'s widths, "
        f"{len(names)} tensors, {nbytes} bytes in two shards + index, "
        f"written in {write_s:.2f}s; read back in {read_s:.2f}s: "
        f"{'every tensor bit-equal' if not bad else f'MISMATCH {bad[:4]}'}")
    if bad:
        raise RuntimeError("safetensors round trip changed tensors")
    del back
    rng = np.random.default_rng(SEED + 7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, HF_PROMPT))).to(DEVICE)
    bodies = [{"input_ids": rng.integers(0, cfg.vocab_size, n).tolist(),
               "max_tokens": MAX_TOKENS} for n in HF_PROMPT_LENS]
    gc.collect()
    t0 = time.monotonic()
    server, port = server_mod.start([
        "--storage-uri", f"file://{ckpt}", "--name", HF_NAME, "--host",
        "127.0.0.1", "--port", "0", "--device", DEVICE])
    load_s = time.monotonic() - t0
    base = f"http://127.0.0.1:{port}"
    try:
        with torch.inference_mode():
            same_logits = torch.equal(
                server.models[HF_NAME]._model(prompt), ref(prompt))
        _reset_counts()
        got = [_post(f"{base}/v1/models/{HF_NAME}:generate",
                     b)["output_ids"] for b in bodies]
        launches = fa.flash_fwd_launches
        model_dir = server.repo.model_dir(HF_NAME)
    finally:
        server.stop()
        del server
        gc.collect()
    engine = GenerationEngine(ref, **GENERATIVE)
    try:
        want = [engine.submit(b["input_ids"], max_tokens=b["max_tokens"])
                ["output_ids"] for b in bodies]
    finally:
        engine.close()
    expect = cfg.num_layers * len(bodies)
    log(f"  --storage-uri file://{ckpt}: served from {model_dir}, loaded "
        f"in {load_s:.2f}s ({nbytes / load_s / 1e9:.2f} GB/s of checkpoint "
        f"read onto the card with the engine built); logits [1, "
        f"{HF_PROMPT}, {cfg.vocab_size}] "
        f"{'bit-equal to' if same_logits else 'DIFFER from'} the writing "
        f"module's; greedy ids of prompts {HF_PROMPT_LENS} "
        f"{'equal' if got == want else 'DIFFER from'} its engine's; "
        f"flash_fwd launches {launches} (expected {expect})")
    if not same_logits or got != want or launches != expect:
        raise RuntimeError("the HF checkpoint does not serve the module "
                           "that wrote it")
    # The adapter, folded flat by the runtime.
    pbundle = os.path.join(work, "hf_peft")
    adir = multilora.write_synthetic_adapter(
        cfg, os.path.join(pbundle, "adapter"), SEED + 9, r=HF_ADAPTER["r"],
        alpha=HF_ADAPTER["alpha"], targets=HF_ADAPTER["targets"])
    with open(os.path.join(pbundle, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "checkpoint": ckpt,
                   "peft_adapter": "adapter", "generative": GENERATIVE}, f)
    del engine
    _free()
    t0 = time.monotonic()
    folded = runtimes.load_model(pbundle, device=DEVICE)
    fold_s = time.monotonic() - t0
    with torch.inference_mode():
        folded_logits = folded._model(prompt).float()
        base_logits = ref(prompt).float()
    del folded, ref
    _free()
    # The adapted function: base weights and fp32 adapters, in bf16 as
    # served adapted, and in fp32 (the exact reference).
    fcfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    acfg, asd = peft_import.attach_peft_adapter(
        adir, fcfg, hf_mod.build_from_hf(ckpt)[1])
    adapted = llama_mod.Llama(acfg, device=DEVICE)
    adapted.load_state_dict(asd)
    del asd
    with torch.inference_mode():
        adapted_logits = adapted(prompt).float()
        _set_compute_dtype(adapted, torch.float32)
        exact = adapted(prompt).float()
    del adapted
    _free()
    rel_exact = _rel_l2(folded_logits, exact)
    floor = _rel_l2(adapted_logits, exact)
    rel = _rel_l2(folded_logits, adapted_logits)
    rel_base = _rel_l2(base_logits, exact)
    ok = rel_exact <= LOGITS_VS_NAIVE * floor and rel <= LOGITS_REL_L2_MAX
    log(f"  peft_adapter (rank {HF_ADAPTER['r']}, alpha "
        f"{HF_ADAPTER['alpha']}, {HF_ADAPTER['targets']}) folded flat and "
        f"loaded in {fold_s:.2f}s; logits rel_l2 on the {HF_PROMPT}-token "
        f"prompt: folded bf16 model vs the adapted function in fp32 "
        f"{rel_exact:.3e}, the adapted bf16 model vs it {floor:.3e} (bound "
        f"{LOGITS_VS_NAIVE} x that); folded vs adapted {rel:.3e} (bound "
        f"{LOGITS_REL_L2_MAX}); the base without the adapter vs the fp32 "
        f"function {rel_base:.3e} {'OK' if ok else 'FAIL'}; 4e (i) took "
        f"{time.monotonic() - t_phase:.1f}s")
    if not ok:
        raise RuntimeError("the folded adapter disagrees with the adapted "
                           "function")
    return {"launches": launches, "load_s": load_s, "bytes": nbytes,
            "write_s": write_s, "read_s": read_s, "fold_s": fold_s,
            "fold_rel_l2": rel_exact, "adapted_rel_l2": floor}


def _ml_bodies(vocab: int) -> list:
    """4e (ii)'s four requests: prompts of ML_REQUESTS' lengths, greedy,
    MAX_TOKENS out, each with its adapter (None: the base)."""
    rng = np.random.default_rng(SEED + 8)
    return [{"input_ids": rng.integers(0, vocab, n).tolist(),
             "max_tokens": MAX_TOKENS, **({"adapter": ad} if ad else {})}
            for n, ad in ML_REQUESTS]


def _ml_concurrent(base: str, bodies: list, openai_index=None) -> list:
    """The bodies at once, their greedy ids in order; body `openai_index`
    goes through /openai/v1/completions as "<model>:<adapter>"."""
    out: list = [None] * len(bodies)

    def run(i):
        b = bodies[i]
        try:
            if i == openai_index:
                res = _post(f"{base}/openai/v1/completions", {
                    "model": f"{MODEL}:{b['adapter']}",
                    "prompt": b["input_ids"], "max_tokens": b["max_tokens"],
                    "temperature": 0, "logprobs": 0})
                out[i] = [int(t) for t in
                          res["choices"][0]["logprobs"]["tokens"]]
            else:
                out[i] = _post(f"{base}/v1/models/{MODEL}:generate",
                               b)["output_ids"]
        except Exception as e:  # reported below as a failed request
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    for i, ids in enumerate(out):
        if not isinstance(ids, list) or len(ids) != MAX_TOKENS:
            raise RuntimeError(f"multi-LoRA request {i} failed: {ids!r}")
    return out


def _chunk_launches(server: ModelServer, aids=None) -> tuple:
    """(kernel launches per decode step by the profiler, or None when it
    saw no device time; unprofiled ms per step) of one decode chunk of the
    idle engine, with adapter ids `aids`. Only kernels are counted, so the
    profiler records the device alone (no CPU op events to collect)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call, _, _ = _decode_chunk(server, aids)
    with torch.inference_mode():
        call()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return (kernels / CHUNK if kernels else None), wall / CHUNK


def _adapted_logits_check(server: ModelServer, bodies: list, dirs: dict,
                          cfg) -> list:
    """Each adapter request's prompt through the served model: bf16 as
    served (the engine's stacks, the row selecting its adapter), and in
    fp32 with fp32 stacks (base + (x·A)·B·alpha/r, the exact function);
    the floor is phase 5c's adapted bf16 model (the adapter as LoRA
    parameters beside the same weights, `models/llama._project`) against
    that fp32 function. Returns per request (rel-L2 of the served logits
    from the fp32 ones, the floor, the last row's, the bf16 argmax at the
    last row). The model is restored to bf16 after."""
    model = server.models[MODEL]._model
    engine = server.models[MODEL].engine
    stacks32, ids = multilora.build_adapter_stacks(
        dirs, dataclasses.replace(cfg, dtype=torch.float32), device=DEVICE)
    weights = model.state_dict()
    rows = []
    with torch.inference_mode():
        for b in bodies:
            if "adapter" not in b:
                continue
            toks = torch.tensor([b["input_ids"]], device=DEVICE)
            aid = torch.tensor([ids[b["adapter"]]], device=DEVICE)
            served = model(toks, adapter=engine._ml_stacks,
                           adapter_ids=aid).float()
            acfg, leaves = peft_import.load_peft_adapter(dirs[b["adapter"]],
                                                         cfg)
            lora = llama_mod.Llama(acfg, device=DEVICE)  # shares weights:
            lora.load_state_dict({**weights, **{
                k: v.to(DEVICE) for k, v in leaves.items()}}, assign=True)
            floor16 = lora(toks).float()
            del lora
            _set_compute_dtype(model, torch.float32)
            try:
                exact = model(toks, adapter=stacks32, adapter_ids=aid)
            finally:
                _set_compute_dtype(model, cfg.dtype)
            rows.append((_rel_l2(served, exact), _rel_l2(floor16, exact),
                         _rel_l2(served[0, -1], exact[0, -1]),
                         int(served[0, -1].argmax())))
            del served, floor16, exact
            torch.cuda.empty_cache()
    del stacks32, weights
    torch.cuda.empty_cache()
    return rows


def _ml_serve(bundle: str, generative: dict, bodies: list,
              openai_index=None, probe=None) -> dict:
    """`bodies` at once on phase 4's bundle with `generative` on top:
    {"ids", "launches" (flash_fwd, this run alone), "stats", "step_ms"
    (host-inclusive ms per 4-row step), and what `probe(base, server)`
    adds after the run}. Nothing here outlives the server."""
    with _serving(bundle, generative) as (base, server):
        _reset_counts()
        out = {"ids": _ml_concurrent(base, bodies, openai_index),
               "launches": fa.flash_fwd_launches,
               "stats": _metadata(base)["stats"]}
        out["step_ms"] = _step_ms(out["stats"])
        if probe is not None:
            out.update(probe(base, server))
    return out


def phase_multilora(bundle: str, work: str) -> dict:
    """4e (ii): two PEFT adapters on phase 4's full llama3_8b bundle
    (`generative.adapters`), four concurrent requests (two base, one per
    adapter, the ml_b one as the OpenAI model "llama3_8b:ml_b"), then the
    same four paged, and on a base-only engine. Gates: base rows = the
    base-only engine's; adapter rows = their lone runs on the same engine
    and within the fp32 gate; each adapter changes its row; paged = flat;
    the adapters listed by /openai/v1/models and the metadata."""
    t_phase = time.monotonic()
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    dirs = {name: multilora.write_synthetic_adapter(
        cfg, os.path.join(work, name), a["seed"], r=a["r"],
        targets=a["targets"]) for name, a in ML_ADAPTERS.items()}
    bodies = _ml_bodies(cfg.vocab_size)
    ad_rows = [i for i, b in enumerate(bodies) if "adapter" in b]
    base_rows = [i for i in range(len(bodies)) if i not in ad_rows]

    def mixed_probe(base, server):
        engine = server.models[MODEL].engine
        return {
            "alone": {i: _post(f"{base}/v1/models/{MODEL}:generate",
                               bodies[i])["output_ids"] for i in ad_rows},
            "listed": [m["id"] for m in json.loads(_request(
                "GET", base + "/openai/v1/models")[2])["data"]],
            "named": _metadata(base).get("adapters"),
            "stack_bytes": multilora.stack_bytes(engine._ml_stacks),
            "load_s": engine.adapter_load_s,
            "chunk": _chunk_launches(server, [
                engine._ml_ids.get(b.get("adapter"), 0) for b in bodies]),
            "checks": _adapted_logits_check(server, bodies, dirs, cfg)}

    mixed = _ml_serve(bundle, {"adapters": dirs}, bodies, next(
        i for i in ad_rows if bodies[i]["adapter"] == "ml_b"), mixed_probe)
    _pipeline_line(mixed["stats"], "4 concurrent requests, 2 adapters")
    mixed_paged = _ml_serve(bundle, {"adapters": dirs,
                                     "kv_block_size": KV_BLOCK_SIZE}, bodies)
    plain = [{k: v for k, v in b.items() if k != "adapter"} for b in bodies]
    base_only = _ml_serve(bundle, {}, plain, probe=lambda base, server: {
        "chunk": _chunk_launches(server)})
    ids, base_ids, checks = mixed["ids"], base_only["ids"], mixed["checks"]
    expect = cfg.num_layers * len(bodies)
    gates = {
        "1 base rows = base-only engine": all(
            ids[i] == base_ids[i] for i in base_rows),
        "2 adapter rows = lone runs": all(ids[i] == mixed["alone"][i]
                                          for i in ad_rows),
        "2 fp32 gate": all(r <= LOGITS_VS_NAIVE * floor
                           and last <= LOGITS_REL_L2_MAX
                           for r, floor, last, _ in checks),
        "3 each adapter changes its row": all(
            ids[i] != base_ids[i] for i in ad_rows),
        "4 paged = flat": mixed_paged["ids"] == ids,
        "5 adapters listed": (mixed["named"] == sorted(dirs) and all(
            f"{MODEL}:{n}" in mixed["listed"] for n in dirs)),
        "flash launches": mixed["launches"] == expect,
    }
    for i, (r, floor, last, top) in zip(ad_rows, checks):
        b = bodies[i]
        log(f"  {b['adapter']} (rank {ML_ADAPTERS[b['adapter']]['r']}, "
            f"{ML_ADAPTERS[b['adapter']]['targets']}), prompt "
            f"{len(b['input_ids'])}: logits rel_l2, served (bf16 stacks) vs "
            f"fp32 base + (x·A)·B·alpha/r {r:.3e}, the adapted bf16 model "
            f"of phase 5c vs it {floor:.3e} (bound {LOGITS_VS_NAIVE} x "
            f"that), last row {last:.3e} (bound {LOGITS_REL_L2_MAX}); "
            f"first id {ids[i][0]}, bf16 argmax {top}; ids differing from "
            f"the base run {sum(x != y for x, y in zip(ids[i], base_ids[i]))}"
            f" of {MAX_TOKENS}")
    per_step = {"mixed": mixed["chunk"], "base_only": base_only["chunk"]}
    fmt = (lambda v: "not measured" if v is None else f"{v:.1f}")
    log(f"  adapters loaded and stacked in {mixed['load_s']:.3f}s, "
        f"{mixed['stack_bytes']} bytes on the card; ms per 4-row decode "
        f"step (host-inclusive): mixed {mixed['step_ms']:.2f}, base-only "
        f"{base_only['step_ms']:.2f}; one idle chunk (bucket 4096) per "
        f"step: mixed {per_step['mixed'][1]:.2f} ms, "
        f"{fmt(per_step['mixed'][0])} kernels; base-only "
        f"{per_step['base_only'][1]:.2f} ms, "
        f"{fmt(per_step['base_only'][0])} kernels; flash_fwd launches "
        f"{mixed['launches']} (expected {expect}); /openai/v1/models "
        f"{mixed['listed']}; {time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"multi-LoRA gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"launches": mixed["launches"], "load_s": mixed["load_s"],
            "stack_bytes": mixed["stack_bytes"],
            "mixed_ms": mixed["step_ms"], "base_ms": base_only["step_ms"],
            "launches_per_step": per_step}


def _timed(engine, name: str, log_to: list) -> None:
    """Wrap `engine.<name>` so each call appends (seconds, result) to
    `log_to`, the device drained before the clock stops (a lone request's
    admission has nothing to overlap)."""
    real = getattr(engine, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        log_to.append((time.perf_counter() - t0, out))
        return out
    setattr(engine, name, call)


@contextlib.contextmanager
def _first_logits(model, into: list):
    """Record, as fp32 into `into`, the logits of the request's first token:
    the last unembedding of a single [1, D] row in the block (an admission
    unembeds the last row of its first chunk and of its final one, and the
    final chunk's gives the first token; decode unembeds [B, 1, D])."""
    real = model.unembed

    def unembed(x):
        out = real(x)
        if x.dim() == 2:
            into[:] = [out.float().reshape(-1).clone()]
        return out
    model.unembed = unembed
    try:
        yield
    finally:
        del model.unembed


def _lone(engine, ids: list, admits: list) -> dict:
    """One greedy request alone on `engine`: {"ids", "lp0", "logits"
    (first token, fp32), "launches" (flash_fwd), "chunks" (prefill chunks
    run), "admit_s" (its admission, device drained)}."""
    logits: list = []
    before = (fa.flash_fwd_launches,
              engine.stats_snapshot()["prefill_chunks"], len(admits))
    with _first_logits(engine.model, logits):
        out = engine.submit(ids, max_tokens=MAX_TOKENS, timeout=600)
    return {"ids": out["output_ids"], "lp0": out["output_logprobs"][0],
            "logits": logits[0],
            "launches": fa.flash_fwd_launches - before[0],
            "chunks": engine.stats_snapshot()["prefill_chunks"] - before[1],
            "admit_s": sum(t for t, _ in admits[before[2]:])}


def _engine_runs(model, prompts: dict, **kw) -> tuple:
    """The prompts alone, in order, on one engine over `model` at phase 4's
    settings plus `kw`: ({name: _lone's dict}, the engine, still open).
    A prompt given as a callable is built from the runs so far."""
    engine = GenerationEngine(model, **GENERATIVE, **kw)
    admits: list = []
    _timed(engine, "_admit", admits)
    runs: dict = {}
    for name, ids in prompts.items():
        runs[name] = _lone(engine, ids(runs) if callable(ids) else ids,
                           admits)
    return runs, engine


def _close(engine) -> None:
    engine.close()
    _free()


def _evict_all(engine) -> None:
    while engine._prefix_lru:
        engine._prefix_evict(next(iter(engine._prefix_lru)))


def _prefix_prompts(vocab: int) -> dict:
    """4f's traffic: {name: ids, or a callable of the runs so far}."""
    rng = np.random.default_rng(SEED + 12)
    head = rng.integers(0, vocab, PREFIX_HEAD).tolist()
    a, b, c = (head + rng.integers(0, vocab, n).tolist()
               for n in PREFIX_TAILS)
    turn = rng.integers(0, vocab, PREFIX_TURN).tolist()
    return {"A": a, "B": b, "C": c,
            "E": lambda runs: a + runs["A"]["ids"] + turn}


def _prefix_scrape(bundle: str, model, cfg, prompts: dict) -> dict:
    """4f (v): one server over `model` whose bundle sets kv_block_size,
    prefix_cache and kv_host_tier_blocks (the bundle is written, and its
    generative block builds the engine as a load would), A then B over
    HTTP, one /metrics scrape. Returns {family: (scraped, engine's)}."""
    gen = {"kv_block_size": KV_BLOCK_SIZE, "prefix_cache": PREFIX_CAP,
           "kv_host_tier_blocks": PREFIX_TIER_BLOCKS}
    export_for_serving(bundle, model=MODEL, model_kwargs=MODEL_KWARGS,
                       seed=SEED, extra={"generative": {**GENERATIVE, **gen}})
    with open(os.path.join(bundle, "model.json")) as f:
        spec = json.load(f)
    served = runtimes._generative(MODEL, model, spec,
                                  dict(spec["generative"]))
    served.load()
    server = ModelServer()
    server.register(served)
    port = server.start_background(0)
    base = f"http://127.0.0.1:{port}"
    try:
        for name in ("A", "B"):
            _post(f"{base}/v1/models/{MODEL}:generate",
                  {"input_ids": prompts[name], "max_tokens": MAX_TOKENS})
        text = _request("GET", base + "/metrics")[2].decode()
        engine = served.engine
        stats = engine.stats_snapshot()
        tier = _metadata(base)["paged_kv"].get("host_tier")
        rows = {metric: (_metric(text, f'{metric}{{model="{MODEL}"}}'),
                         float(stats[key]))
                for key, metric, _ in server_mod._ENGINE_METRICS
                if key in stats and (key.startswith("prefix_")
                                     or key.startswith("kv_"))}
        rows["tpk_kv_spill_blocks"] = (
            _metric(text, f'tpk_kv_spill_blocks{{model="{MODEL}"}}'),
            float(engine.kv_spill_blocks))
        rows["metadata host_tier"] = (tier is not None, True)
    finally:
        server.stop()
        served.unload()
        _free()
    return rows


def phase_prefix(bundle: str, floor: float) -> dict:
    """4f: KV reuse in the serving engine on phase 4's llama3_8b (one model
    for every engine): (i) the flat prefix cache against a cacheless
    engine, (ii) the paged one (zero-copy hits, a CoW fork), (iii) an int8
    pool, (iv) the host tier under pool pressure, (v) one /metrics
    scrape."""
    t_phase = time.monotonic()
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    fa.flash_fwd_launches = 0
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    prompts = _prefix_prompts(cfg.vocab_size)
    hits = ("B", "C", "E")
    limit = LOGITS_VS_NAIVE * floor
    gates: dict = {}
    # (i) flat
    cached, eng = _engine_runs(model, prompts, prefix_cache=PREFIX_CAP)
    s = eng.stats_snapshot()
    frag = next(iter(eng._prefix_lru.values()))[1]
    frag_bytes = sum(t.numel() * t.element_size() for t in frag.values())
    frag_rows = frag["k"].shape[2]
    _close(eng)
    cold_prompts = {"B": prompts["B"], "C": prompts["C"],
                    "E": prompts["E"](cached)}
    cold, eng = _engine_runs(model, cold_prompts)
    _close(eng)
    e_dist = _rel_l2(cached["E"]["logits"], cold["E"]["logits"])
    e_agree = sum(x == y for x, y in zip(cached["E"]["ids"],
                                         cold["E"]["ids"]))
    gates["i counters"] = (
        (s["prefix_misses"], s["prefix_hits"], s["prefix_hit_tokens"])
        == (1, 3, 2 * PREFIX_HEAD + len(prompts["A"])))
    gates["i no B1 for a hit"] = (
        cached["A"]["launches"] == cfg.num_layers
        and all(cached[n]["launches"] == 0 for n in hits))
    gates["i one chunk fewer per boundary hit"] = all(
        cold[n]["chunks"] - cached[n]["chunks"] == 1 for n in ("B", "C"))
    gates["i boundary hits bit-equal to cold"] = all(
        cached[n]["ids"] == cold[n]["ids"]
        and cached[n]["lp0"] == cold[n]["lp0"] for n in ("B", "C"))
    gates["i E logits"] = e_dist <= limit
    for n in ("A",) + hits:
        c = cold.get(n)
        log(f"  (i) {n}: prompt {len(cold_prompts.get(n, prompts[n]))}, "
            f"admission {cached[n]['admit_s']:.4f}s"
            + (f" (hit) vs {c['admit_s']:.4f}s cold" if c else " (miss)")
            + f"; {cached[n]['launches']} flash_fwd launches, "
            f"{cached[n]['chunks']} prefill chunks"
            + (f" (cold {c['chunks']})" if c else "") + f"; {smi()}")
    log(f"  (i) flat: {s['prefix_misses']} miss, {s['prefix_hits']} hits, "
        f"{s['prefix_hit_tokens']} hit tokens, {s['prefix_stores']} stores; "
        f"one stored fragment {frag_rows} rows, {frag_bytes} bytes; E's "
        f"first-token logits rel_l2 vs cold {e_dist:.3e} (bound {limit:.3e}"
        f"), ids agreeing {e_agree} of {MAX_TOKENS}; {smi()}")
    # (ii) paged
    paged, eng = _engine_runs(model, prompts, prefix_cache=PREFIX_CAP,
                              kv_block_size=KV_BLOCK_SIZE)
    sp = eng.stats_snapshot()
    _evict_all(eng)
    pool_whole = eng.kv_blocks_free == eng._kv_alloc.n_blocks
    _close(eng)
    gates["ii ids = flat"] = all(paged[n]["ids"] == cached[n]["ids"]
                                 for n in prompts)
    gates["ii zero-copy hits, CoW"] = (sp["prefix_zero_copy_hits"] == 3
                                       and sp["kv_cow_copies"] >= 1)
    gates["ii refcounts conserved"] = pool_whole
    log(f"  (ii) paged (block {KV_BLOCK_SIZE}): zero-copy hits "
        f"{sp['prefix_zero_copy_hits']}, CoW forks {sp['kv_cow_copies']}; "
        + ", ".join(f"{n} admission {paged[n]['admit_s']:.4f}s"
                    for n in paged) + f"; pool whole after eviction "
        f"{pool_whole}; {smi()}")
    # (iii) int8 pool
    q_prompts = dict(prompts, **{"B2": prompts["B"]})
    quant, eng = _engine_runs(model, q_prompts, prefix_cache=PREFIX_CAP,
                              kv_block_size=KV_BLOCK_SIZE, kv_quant="int8")
    sq = eng.stats_snapshot()
    _evict_all(eng)
    q_whole = eng.kv_blocks_free == eng._kv_alloc.n_blocks
    _close(eng)
    q_cold, eng = _engine_runs(model, dict(cold_prompts,
                                           E=prompts["E"](quant)),
                               kv_block_size=KV_BLOCK_SIZE, kv_quant="int8")
    _close(eng)
    gates["iii dequant fallbacks = hits"] = (
        sq["kv_dequant_fallbacks"] == sq["prefix_hits"] == 4)
    gates["iii refcounts conserved"] = q_whole
    gates["iii second hit bit-equal"] = quant["B2"]["ids"] == quant["B"]["ids"]
    log("  (iii) int8 pool, hit vs the int8 pool's cold run: " + "; ".join(
        f"{n} first-token logits rel_l2 "
        f"{_rel_l2(quant[n]['logits'], q_cold[n]['logits']):.3e}, ids "
        f"agreeing {sum(x == y for x, y in zip(quant[n]['ids'], q_cold[n]['ids']))}"
        f" of {MAX_TOKENS}" for n in hits)
        + f"; dequant fallbacks {sq['kv_dequant_fallbacks']} for "
        f"{sq['prefix_hits']} hits; {smi()}")
    # (iv) host tier
    rng = np.random.default_rng(SEED + 13)
    crowd = [rng.integers(0, cfg.vocab_size, n).tolist()
             for n in PREFIX_CROWD]
    need = -(-(max(PREFIX_CROWD) + MAX_TOKENS) // KV_BLOCK_SIZE)
    eng = GenerationEngine(model, **GENERATIVE, prefix_cache=PREFIX_CAP,
                           kv_block_size=KV_BLOCK_SIZE, kv_blocks=2 * need,
                           kv_host_tier_blocks=PREFIX_TIER_BLOCKS)
    spills: list = []
    restores: list = []
    _timed(eng, "_spill_prefix", spills)
    _timed(eng, "_restore_spilled", restores)
    spill_bytes, restore_bytes = [], []
    real_put, real_take = eng._host_tier.put, eng._host_tier.take

    def put(aid, kt, n, data):
        spill_bytes.append(len(data))
        return real_put(aid, kt, n, data)

    def take(aid, kt):
        out = real_take(aid, kt)
        restore_bytes.append(len(out[1]) if out else 0)
        return out
    eng._host_tier.put, eng._host_tier.take = put, take
    for ids in [prompts["A"]] + crowd:
        eng.submit(ids, max_tokens=MAX_TOKENS, timeout=600)
    b_tier = eng.submit(prompts["B"], max_tokens=MAX_TOKENS, timeout=600)
    st = eng.stats_snapshot()
    tier_info = eng.kv_info()["host_tier"]
    _evict_all(eng)
    t_whole = eng.kv_blocks_free == eng._kv_alloc.n_blocks
    _close(eng)
    gates["iv spilled and restored"] = (st["kv_spilled_blocks"] > 0
                                        and st["kv_restored_blocks"] > 0)
    b_same = b_tier["output_ids"] == paged["B"]["ids"]
    gates["iv restored B = (ii)'s B"] = b_same
    gates["iv refcounts conserved"] = t_whole
    restores = [t for t, out in restores if out is not None]
    log(f"  (iv) host tier: pool {2 * need} blocks; "
        f"{st['kv_spilled_blocks']} blocks spilled in {len(spills)} spills "
        f"of {spill_bytes} bytes, ms "
        f"{[round(t * 1e3, 3) for t, _ in spills]}; "
        f"{st['kv_restored_blocks']} blocks restored in {len(restores)} "
        f"restores of {[b for b in restore_bytes if b]} bytes, ms "
        f"{[round(t * 1e3, 3) for t in restores]}; B's ids after the "
        f"restore {'equal' if b_same else 'DIFFER from'} (ii)'s; tier "
        f"{tier_info}; {smi()}")
    # (v) the scrape
    rows = _prefix_scrape(bundle, model, cfg, prompts)
    gates["v /metrics = engine stats"] = all(
        got == want for got, want in rows.values())
    log(f"  (v) /metrics vs the engine: "
        + ", ".join(f"{k} {g}/{w}" for k, (g, w) in rows.items()))
    launches = fa.flash_fwd_launches
    del model
    _free()
    log(f"  flash_fwd launches in 4f {launches}; "
        f"{time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"prefix-cache gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"launches": launches,
            "admit_s": {n: (cached[n]["admit_s"], cold[n]["admit_s"])
                        for n in hits},
            "frag_bytes": frag_bytes, "e_dist": e_dist,
            "spill_ms": [t * 1e3 for t, _ in spills],
            "restore_ms": [t * 1e3 for t in restores]}


def _spec_bodies(vocab: int, lens, seed: int, **kw) -> list:
    """Greedy requests of MAX_TOKENS after prompts of `lens` tokens."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, n).tolist(),
             "max_tokens": MAX_TOKENS, **kw} for n in lens]


def _burst(call, items: list) -> list:
    """`call(item)` for every item at once, each on a thread of its own:
    the results in order; a failure raises."""
    results: list = [None] * len(items)

    def run(i):
        try:
            results[i] = call(items[i])
        except Exception as e:  # reported below
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    for i, res in enumerate(results):
        if not isinstance(res, dict):
            raise RuntimeError(f"request {i} failed: {res!r}")
    return results


def _engine_burst(engine, bodies: list) -> tuple:
    """The bodies at once on an in-process engine: (their ids in order,
    the engine's stats after them)."""
    def call(body):
        b = dict(body)
        return engine.submit(b.pop("input_ids"), timeout=600, **b)
    return ([r["output_ids"] for r in _burst(call, bodies)],
            engine.stats_snapshot())


def _accept(stats: dict) -> float:
    return (stats["spec_accepted"] / stats["spec_proposed"]
            if stats["spec_proposed"] else 0.0)


def _near_tie(model, prompt: list, want: list, got: list, floor: float,
              checks: dict) -> dict:
    """Greedy `got` against vanilla `want` after `prompt`: equal, or, at
    the first position they part, the logits of one forward over the
    common prefix, with the two tokens' gap and its bound (SPEC_TIE_SIGMAS
    x sqrt(2) x floor x the row's rms). That forward's flash launches are
    a check's, added to checks["flash"]."""
    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        return {"equal": len(want) == len(got), "ok": len(want) == len(got)}
    tokens = torch.tensor([prompt + want[:j]], device=DEVICE)
    before = fa.flash_fwd_launches
    with torch.inference_mode():
        row = model(tokens)[0, -1].float()
    checks["flash"] += fa.flash_fwd_launches - before
    gap = abs(float(row[want[j]]) - float(row[got[j]]))
    bound = (SPEC_TIE_SIGMAS * math.sqrt(2) * floor
             * float(row.pow(2).mean().sqrt()))
    return {"equal": False, "at": j, "gap": gap, "bound": bound,
            "top": int(row.argmax()), "ok": gap <= bound}


def _ids_gate(model, bodies: list, want: list, got: list, floor: float,
              what: str, checks: dict) -> bool:
    """Log and judge spec ids against vanilla ids, request by request, by
    `_near_tie`'s rule."""
    ok = True
    for b, w, g in zip(bodies, want, got):
        res = _near_tie(model, b["input_ids"], w, g, floor, checks)
        ok &= res["ok"]
        if not res["equal"] and "at" in res:
            log(f"    {what}: prompt {len(b['input_ids'])} parts from "
                f"vanilla at token {res['at']}: recomputed logits of the "
                f"two tokens {res['gap']:.4f} apart (bound "
                f"{res['bound']:.4f}; argmax {res['top']} vanilla "
                f"{w[res['at']]} spec {g[res['at']]}) "
                f"{'near-tie OK' if res['ok'] else 'FAIL'}")
    log(f"    {what}: ids {'equal' if want == got else 'as above'} for "
        f"{len(bodies)} requests")
    return ok


def _spec_exactness(gk) -> dict:
    """4g (i): fp32 at llama_1b_fp32_2l's widths: greedy ids of every
    spec engine (target as draft, a 1-layer draft; flat and paged; depth 1
    and 2) equal the vanilla engine's; the self-draft's acceptance."""
    cfg = gk.c1_config("llama_1b_fp32_2l")
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    weak = llama_mod.Llama(dataclasses.replace(cfg, num_layers=1),
                           device=DEVICE).init_weights(SEED + 21).eval()
    bodies = _spec_bodies(cfg.vocab_size, SPEC_SMALL_LENS, SEED + 30)
    eng = GenerationEngine(model, **SPEC_SMALL, pipeline_depth=1)
    want, _ = _engine_burst(eng, bodies)
    _close(eng)
    rows, ok = {}, True
    for name, draft in (("self", model), ("1-layer", weak)):
        for pool in ("flat", "paged"):
            for depth in (1, 2):
                eng = GenerationEngine(
                    model, **SPEC_SMALL, pipeline_depth=depth,
                    draft={"model": draft, "gamma": SPEC_GAMMA},
                    **({"kv_block_size": KV_BLOCK_SIZE}
                       if pool == "paged" else {}))
                got, st = _engine_burst(eng, bodies)
                _close(eng)
                key = f"{name} {pool} depth {depth}"
                same = got == want
                parts = [(k, next(i for i, (a, b) in enumerate(zip(w, g))
                                  if a != b))
                         for k, (w, g) in enumerate(zip(want, got))
                         if w != g]
                rows[key] = {"accept": _accept(st), "same": same,
                             "dispatches": st["spec_dispatches"],
                             "wasted": st["decode_wasted_tokens"]}
                ok &= same and st["spec_dispatches"] > 0
                if name == "self":
                    ok &= _accept(st) >= SPEC_SELF_ACCEPT_FP32_MIN
                log(f"  (i) {key}: ids {'equal' if same else 'DIFFER'}"
                    + (f" (request, first token apart: {parts})"
                       if parts else "") + "; "
                    f"accepted/proposed {st['spec_accepted']}/"
                    f"{st['spec_proposed']} = {_accept(st):.6f}; "
                    f"{st['spec_dispatches']} spec dispatches, "
                    f"{st['decode_wasted_tokens']} tokens wasted")
    del model, weak
    _free()
    return {"ok": ok, "rows": rows}


def _labelled(module):
    """Run `module`'s forward under a profiler label: "spec.draft" for a
    single-token step, "spec.verify" for a wider one. Returns the undo."""
    real = module.forward

    def forward(tokens, *a, **kw):
        label = "spec.draft" if tokens.shape[1] == 1 else "spec.verify"
        with torch.profiler.record_function(label):
            return real(tokens, *a, **kw)
    module.forward = forward
    return lambda: module.__dict__.pop("forward", None)


def _profile_spec(engine, pos: int) -> dict:
    """One spec dispatch of the idle engine over every slot at position
    `pos` (greedy), through its own spec function: its unprofiled wall (the
    device drained), then a profiled run: device busy ms, split into the
    draft's forwards and the verify by profiler labels, and kernels a spec
    step. The flash kernel must not launch in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec, n = engine._spec, engine.n_slots
    worst = spec["n_spec"] * (spec["gamma"] + 1)
    bucket = next(b for b in engine.decode_buckets if b >= pos + worst)
    args = [torch.ones(n, dtype=torch.long, device=DEVICE),
            torch.full((n,), pos, dtype=torch.long, device=DEVICE),
            torch.zeros(n, device=DEVICE)]
    if engine.kv_info() is not None:
        nb = bucket // engine.kv_info()["block_size"]
        tables = torch.arange(1, 1 + n * nb, device=DEVICE).view(n, nb)
        args[:0] = [tables, tables]
    fn = engine._spec_decode[bucket]

    def call():
        fn(engine._cache, engine._dcache, *args, engine._gen, None)

    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        flash0 = fa.flash_fwd_launches
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        undo = [_labelled(m) for m in {id(engine.model): engine.model,
                                       id(spec["model"]): spec["model"]
                                       }.values()]
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
        finally:
            for u in undo:
                u()
    labels = ("spec.draft", "spec.verify")
    avgs = prof.key_averages()
    kern = [e for e in avgs if e.device_type == DeviceType.CUDA
            and e.key not in labels]  # not the labels' GPU-side ranges
    busy = sum(e.self_device_time_total for e in kern) / 1e3

    def label_ms(label):
        # A CPU range's device time: its launches' kernels, children too.
        return sum(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
                   for e in avgs
                   if e.key == label and e.device_type == DeviceType.CPU
                   ) / 1e3
    return {"wall_ms": wall, "bucket": bucket, "rows": n,
            "busy_ms": busy if kern else None,
            "draft_ms": label_ms("spec.draft") if kern else None,
            "verify_ms": label_ms("spec.verify") if kern else None,
            "kernels_per_step": (sum(e.count for e in kern) / spec["n_spec"]
                                 if kern else None),
            "flash": fa.flash_fwd_launches - flash0}


def _spec_line(what: str, stats: dict, rows: int) -> dict:
    """Log and return a run's host-inclusive ms a dispatch and tok/s a
    row (decode seconds are the union of the dispatches in flight)."""
    disp, secs = stats["decode_dispatches"], stats["decode_seconds"]
    out = {"ms_per_dispatch": secs / disp * 1e3,
           "tok_s_per_row": stats["decode_tokens"] / secs / rows,
           "accept": _accept(stats), "dispatches": disp,
           "spec_dispatches": stats["spec_dispatches"]}
    log(f"    {what}: {stats['decode_tokens']} tokens in {secs:.3f}s of "
        f"decode over {disp} dispatches ({stats['spec_dispatches']} spec): "
        f"{out['ms_per_dispatch']:.2f} ms a dispatch, "
        f"{out['tok_s_per_row']:.2f} tok/s a row; accepted/proposed "
        f"{stats['spec_accepted']}/{stats['spec_proposed']} = "
        f"{out['accept']:.4f}; wasted {stats['decode_wasted_tokens']}, "
        f"demotions {stats['spec_demotions']}, readmissions "
        f"{stats['spec_readmissions']}, stale rides "
        f"{stats['spec_stale_rides']}")
    return out


def _spec_http(bundle: str, model, ckpt: str, bodies: list) -> tuple:
    """4g (ii) over HTTP and (vi): a bundle whose generative block names
    the draft checkpoint, loaded over `model` as a load would build it,
    the bodies at once over :generate, one /metrics scrape. Returns (ids,
    stats, the draft module, {family: (scraped, engine's)}, draft_info,
    metadata's "speculative")."""
    gen = {**GENERATIVE, "draft": {"checkpoint": ckpt, "gamma": SPEC_GAMMA}}
    export_for_serving(bundle, model=MODEL, model_kwargs=MODEL_KWARGS,
                       seed=SEED, extra={"generative": gen})
    with open(os.path.join(bundle, "model.json")) as f:
        spec = json.load(f)
    served = runtimes._generative(MODEL, model, spec,
                                  dict(spec["generative"]))
    served.load()
    server = ModelServer()
    server.register(served)
    base = f"http://127.0.0.1:{server.start_background(0)}"
    try:
        run = _concurrent(base, bodies)
        text = _request("GET", base + "/metrics")[2].decode()
        stats = served.engine.stats_snapshot()
        rows = {metric: (_metric(text, f'{metric}{{model="{MODEL}"}}'),
                         float(stats[key]))
                for key, metric, _ in server_mod._ENGINE_METRICS
                if key.startswith("spec_")}
        rows["tpk_spec_accept_rate"] = (
            _metric(text, f'tpk_spec_accept_rate{{model="{MODEL}"}}'),
            round(_accept(stats), 6))
        draft = served.engine._spec["model"]
        speculative = run["metadata"].get("speculative")
    finally:
        server.stop()
        served.unload()
        _free()
    return ([r["output_ids"] for r in run["results"]], stats, draft, rows,
            dict(served.draft_info), speculative)


def phase_spec(bundle: str, floor: float, gk) -> dict:
    """4g: speculative decoding. (i) fp32 exactness at llama_1b_fp32_2l's
    widths; (ii) llama3_8b with a Llama-3.2-1B-width draft over HTTP
    through generative.draft.checkpoint, against vanilla at depth 2 and 1,
    one profiled dispatch; (iii) the target as its own draft, greedy and at
    temperature; (v) mixed traffic on a paged engine; (vi) the scrape;
    (iv) the int8-weight target (last: it quantizes the model in place)."""
    t_phase = time.monotonic()
    gates: dict = {}
    checks = {"flash": 0}
    small = _spec_exactness(gk)
    gates["i fp32 ids equal, self-draft acceptance"] = small["ok"]
    log(f"  (i) took {time.monotonic() - t_phase:.1f}s")
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    _reset_counts()
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    dcfg = hf_mod.llama_config_from_hf(DRAFT_CONFIG)
    ckpt = os.path.join(bundle, "hf_llama32_1b")
    dref = llama_mod.Llama(dcfg, device=DEVICE).init_weights(SEED + 20)
    nbytes, write_s = _write_hf_checkpoint(ckpt, dref.state_dict(), dcfg,
                                           DRAFT_CONFIG)
    del dref
    bodies = _spec_bodies(cfg.vocab_size, SPEC_PROMPT_LENS, SEED + 31)
    short = [dict(b, max_tokens=SPEC_SHORT_TOKENS) for b in bodies]
    admissions = 0
    # (ii) vanilla at depth 2 and 1, then spec over HTTP (depth 2) and
    # in-process at depth 1.
    # Vanilla runs at depth 2 only: depth 1 against depth 2 is gated on
    # the served engines of phases 4, 4b and 4c, and spec at depth 1 below.
    van, van_line = {}, {}
    eng = GenerationEngine(model, **GENERATIVE, pipeline_depth=2)
    van[2], st = _engine_burst(eng, bodies)
    _close(eng)
    admissions += st["requests"]
    van_line[2] = _spec_line("(ii) vanilla depth 2", st, len(bodies))
    want = van[2]
    want_short = [w[:SPEC_SHORT_TOKENS] for w in want]
    got, st2, draft, scrape, dinfo, speculative = _spec_http(
        bundle, model, ckpt, short)
    admissions += st2["requests"]
    spec_line = {2: _spec_line("(ii) spec over HTTP, depth 2", st2,
                               len(bodies))}
    gates["ii ids vs vanilla"] = _ids_gate(model, short, want_short, got,
                                           floor, "(ii) depth 2", checks)
    eng = GenerationEngine(model, **GENERATIVE, pipeline_depth=1,
                           draft={"model": draft, "gamma": SPEC_GAMMA})
    got1, st1 = _engine_burst(eng, short)
    admissions += st1["requests"]
    spec_line[1] = _spec_line("(ii) spec depth 1", st1, len(bodies))
    gates["ii depth-1 ids vs vanilla"] = _ids_gate(
        model, short, want_short, got1, floor, "(ii) depth 1", checks)
    prof = _profile_spec(eng, max(SPEC_PROMPT_LENS))
    _close(eng)
    gates["ii a spec dispatch launches no B1"] = prof["flash"] == 0
    gates["ii speculative in metadata"] = speculative is True
    log(f"  (ii) draft {DRAFT_CONFIG['num_hidden_layers']} layers of "
        f"Llama-3.2-1B's widths ({sum(p.numel() for p in draft.parameters())}"
        f" parameters): checkpoint {nbytes} bytes written in {write_s:.2f}s;"
        f" generative.draft loaded in {dinfo['load_s']:.2f}s, "
        f"{dinfo['bytes']} bytes on the card; {smi()}")
    n_spec = _spec_steps(GENERATIVE)
    log(f"  (ii) one spec dispatch ({prof['rows']} rows at position "
        f"{max(SPEC_PROMPT_LENS)}, bucket {prof['bucket']}, "
        f"{n_spec * (SPEC_GAMMA + 1)} draft steps and {n_spec} verifies):"
        f" unprofiled wall {prof['wall_ms']:.2f} ms; device busy "
        + (f"{prof['busy_ms']:.2f} ms: draft forwards "
           f"{prof['draft_ms']:.2f}, verify {prof['verify_ms']:.2f}; "
           f"{prof['kernels_per_step']:.1f} kernels a spec step"
           if prof["busy_ms"] is not None else "not measured")
        + f"; flash_fwd launches in it {prof['flash']}")
    # (vi) the scrape
    gates["vi /metrics = engine stats"] = all(
        g == w for g, w in scrape.values())
    log("  (vi) /metrics vs the engine: "
        + ", ".join(f"{k} {g}/{w}" for k, (g, w) in scrape.items()))
    # (iii) the target as its own draft
    self_draft = {"model": model, "gamma": SPEC_GAMMA}
    eng = GenerationEngine(model, **GENERATIVE, draft=self_draft)
    got_s, st_s = _engine_burst(eng, bodies)
    _close(eng)
    admissions += st_s["requests"]
    self_line = _spec_line("(iii) self-draft greedy, depth 2", st_s,
                           len(bodies))
    gates["iii self-draft ids vs vanilla"] = _ids_gate(
        model, bodies, want, got_s, floor, "(iii) self-draft", checks)
    gates["iii self-draft greedy acceptance"] = (
        self_line["accept"] >= SPEC_SELF_ACCEPT_BF16_MIN)
    temp_ids, temp_stats = [], []
    for _ in range(2):
        eng = GenerationEngine(model, **GENERATIVE, draft=self_draft,
                               seed=SEED + 5)
        temp_ids.append([eng.submit(b["input_ids"], max_tokens=MAX_TOKENS,
                                    temperature=SPEC_TEMPERATURE,
                                    timeout=600)["output_ids"]
                         for b in bodies[:1]])
        temp_stats.append(eng.stats_snapshot())
        _close(eng)
        admissions += temp_stats[-1]["requests"]
    temp_line = _spec_line(f"(iii) self-draft at temperature "
                           f"{SPEC_TEMPERATURE}, one at a time",
                           temp_stats[0], 1)
    gates["iii temperature acceptance"] = (
        temp_line["accept"] >= SPEC_SELF_ACCEPT_MIN)
    gates["iii same seed, same ids"] = temp_ids[0] == temp_ids[1]
    log(f"  (iii) temperature runs with one seed: ids "
        f"{'equal' if temp_ids[0] == temp_ids[1] else 'DIFFER'}")
    # (v) mixed traffic, paged, depth 2
    mixed = short[:2] + [
        dict(short[2], temperature=SPEC_TEMPERATURE, top_k=50),
        dict(short[3], temperature=SPEC_TEMPERATURE, top_p=0.9)]
    eng = GenerationEngine(model, **GENERATIVE, kv_block_size=KV_BLOCK_SIZE,
                           draft={"model": draft, "gamma": SPEC_GAMMA})
    got_m, st_m = _engine_burst(eng, mixed)
    whole = eng.kv_blocks_used == 0
    _close(eng)
    admissions += st_m["requests"]
    mixed_line = _spec_line("(v) mixed traffic, paged, depth 2", st_m, 4)
    gates["v greedy rows vs vanilla"] = _ids_gate(
        model, mixed[:2], want_short[:2], got_m[:2], floor,
        "(v) greedy rows", checks)
    gates["v top-k/top-p rows decode vanilla, greedy rows speculate"] = (
        st_m["spec_dispatches"] > 0
        and st_m["decode_dispatches"] > st_m["spec_dispatches"]
        and all(len(ids) == SPEC_SHORT_TOKENS for ids in got_m))
    gates["v pool whole"] = whole
    flash_bf16 = fa.flash_fwd_launches - checks["flash"]
    gates["B1 launches = 32 a target admission"] = (
        flash_bf16 == cfg.num_layers * admissions)
    log(f"  flash_fwd launches (bf16 target) {flash_bf16} for {admissions} "
        f"target admissions (expected {cfg.num_layers} each), besides "
        f"{checks['flash']} in the near-tie checks' forwards")
    # (iv) the int8-weight target: (ii)'s draft, a bf16 pool.
    squant.quantize_model(model)
    _free()
    eng = GenerationEngine(model, **GENERATIVE)
    want_q, st = _engine_burst(eng, short)
    _close(eng)
    admissions_q = st["requests"]
    w8.w8a16_launches = w8.w8a16_wgmma_launches = 0
    eng = GenerationEngine(model, **GENERATIVE,
                           draft={"model": draft, "gamma": SPEC_GAMMA})
    got_q, st_q = _engine_burst(eng, short)
    _close(eng)
    admissions_q += st_q["requests"]
    w8_4 = (w8.w8a16_launches, w8.w8a16_wgmma_launches)
    int8_line = _spec_line("(iv) int8 target, spec, depth 2", st_q,
                           len(bodies))
    gates["iv int8 ids vs int8 vanilla"] = _ids_gate(
        model, short, want_q, got_q, floor, "(iv) int8", checks)
    w8.w8a16_launches = w8.w8a16_wgmma_launches = 0
    eng = GenerationEngine(model, **{**GENERATIVE, "slots": 1},
                           draft={"model": draft, "gamma": SPEC_GAMMA})
    eng.submit(bodies[0]["input_ids"], max_tokens=SPEC_SHORT_TOKENS,
               timeout=600)
    _close(eng)
    admissions_q += 1
    w8_1 = (w8.w8a16_launches, w8.w8a16_wgmma_launches)
    try:
        GenerationEngine(model, **GENERATIVE, kv_block_size=KV_BLOCK_SIZE,
                         kv_quant="int8",
                         draft={"model": draft, "gamma": SPEC_GAMMA})
        refused = "not refused"
    except ValueError as e:
        refused = str(e)
    gates["iv kv_quant with a draft refused"] = refused.startswith(
        "kv_quant does not compose with speculative decoding")
    log(f"  (iv) W8A16 launches, 4 slots (verify 4 x {SPEC_GAMMA + 1} = "
        f"{4 * (SPEC_GAMMA + 1)} rows a projection): {w8_4[0]}, of them "
        f"wgmma {w8_4[1]}, decode kernel {w8_4[0] - w8_4[1]}; one slot "
        f"({SPEC_GAMMA + 1} rows): {w8_1[0]}, wgmma {w8_1[1]}, decode "
        f"kernel {w8_1[0] - w8_1[1]}; kv_quant='int8' with a draft: "
        f"{refused!r}")
    gates["iv the verify's W8A16 kernels by rows"] = (
        w8_4[1] > 0 and w8_1[0] - w8_1[1] > 0)
    flash = fa.flash_fwd_launches - checks["flash"]
    gates["B1 launches = 32 a target admission (int8 too)"] = (
        flash - flash_bf16 == cfg.num_layers * admissions_q)
    del model, draft
    _free()
    log(f"  flash_fwd launches in 4g {flash} (and {checks['flash']} in the "
        f"checks' forwards); 4g took "
        f"{time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"speculative-decoding gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"launches": flash, "w8a16_launches": w8_4[0] + w8_1[0],
            "w8a16_wgmma_launches": w8_4[1] + w8_1[1], "small": small,
            "vanilla": van_line, "spec": spec_line, "self": self_line,
            "temperature": temp_line, "mixed": mixed_line,
            "int8": int8_line, "profile": prof, "draft_bytes": nbytes,
            "draft_load_s": dinfo["load_s"]}


def _b1_split() -> tuple:
    """B1's forward launches so far: (flash_fwd.cu's, flash_simt.cu's
    forwards', of those the tensor-core mma kernel's)."""
    return (fa.flash_fwd_launches, fa.flash_simt_fwd_launches,
            fa.flash_simt_fwd_mma_launches)


def _since(before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(_b1_split(), before))


def _b1_launches() -> int:
    """B1's forward launches on either route."""
    return sum(_b1_split()[:2])


def _teacher_forced(model, prompt: list, ids: list) -> torch.Tensor:
    """fp32 logit rows [len(ids), V] of one full forward over prompt +
    ids[:-1] through the model's own attention (B1, sliding-window mask),
    row j at the position that chose ids[j]."""
    tokens = torch.tensor([prompt + ids[:-1]], device=DEVICE)
    with torch.inference_mode():
        hidden = model(tokens, return_hidden=True)
        return model.unembed(hidden[0, len(prompt) - 1:]).float()


def _tf_gate(model, prompt: list, ids: list, floor: float) -> dict:
    """`ids` against the teacher-forced argmax at every position: each id
    the argmax or, in bf16 (`floor` > 0), a near-tie by 4g's rule (its
    logit within SPEC_TIE_SIGMAS x sqrt(2) x floor x the row's rms of the
    top one); `floor` 0 asks for every id equal."""
    rows = _teacher_forced(model, prompt, ids)
    top = rows.argmax(-1)
    got = torch.tensor(ids, device=rows.device)
    gap = (rows.gather(1, top[:, None]) - rows.gather(1, got[:, None]))[:, 0]
    bound = (SPEC_TIE_SIGMAS * math.sqrt(2) * floor
             * rows.pow(2).mean(-1).sqrt())
    parts = top != got
    ok = bool((~parts | (gap <= bound)).all()) and len(ids) == rows.shape[0]
    ratio = [round(float(g / b), 4) for g, b, p in zip(gap, bound, parts)
             if p] if floor else []
    return {"ok": ok, "parts": int(parts.sum()), "n": len(ids),
            "gap_over_bound": ratio}


def _tf_line(what: str, prompt: list, res: dict) -> None:
    log(f"    {what}: prompt {len(prompt)}, {res['n']} ids, "
        f"{res['n'] - res['parts']} the teacher-forced argmax"
        + (f", {res['parts']} near-ties (gap / bound "
           f"{res['gap_over_bound']})" if res["parts"] else "")
        + f" {'OK' if res['ok'] else 'FAIL'}")


def _last_boundary(n: int, cfg) -> int:
    """The last prompt-chunk boundary at or before `n` tokens on a rolling
    engine of ROLLING_GEN (chunks of the largest bucket, clamped to the
    window): where a prefix-cache hit of a prompt sharing n tokens lands."""
    big = min(max(ROLLING_GEN["prefill_buckets"]), cfg.mask_window)
    return n // big * big


def _rolling_exactness(cfg) -> dict:
    """4h (i): Mistral's widths at ROLLING_FP32_LAYERS layers in fp32, one
    prompt past the window on one-slot rolling engines: vanilla and spec
    (a random 1-layer causal draft) at depth 1 and 2, and a prefix-cache
    hit; every run's ids equal the teacher-forced fp32 full forward's
    argmax (B1 with the sliding-window mask on flash_simt.cu)."""
    cfg32 = dataclasses.replace(cfg, num_layers=ROLLING_FP32_LAYERS,
                                dtype=torch.float32)
    model = llama_mod.Llama(cfg32, device=DEVICE).init_weights(SEED).eval()
    draft = llama_mod.Llama(dataclasses.replace(
        cfg32, num_layers=1, mask_kind="causal", mask_window=0),
        device=DEVICE).init_weights(SEED + 21).eval()
    prompt = np.random.default_rng(SEED + 40).integers(
        0, cfg.vocab_size, ROLLING_FP32_PROMPT).tolist()
    gen = dict(ROLLING_GEN, slots=1)
    n = ROLLING_FP32_TOKENS
    runs: dict = {}
    b0 = _b1_launches()
    for depth in (1, 2):
        for name, d in (("vanilla", None), ("spec", draft)):
            eng = GenerationEngine(model, **gen, pipeline_depth=depth, **(
                {"draft": {"model": d, "gamma": SPEC_GAMMA}} if d else {}))
            runs[f"{name} depth {depth}"] = (
                eng.submit(prompt, max_tokens=n, timeout=600)["output_ids"],
                eng.stats_snapshot())
            _close(eng)
    eng = GenerationEngine(model, **gen, prefix_cache=4)
    eng.submit(prompt, max_tokens=n, timeout=600)
    runs["prefix hit"] = (eng.submit(prompt, max_tokens=n,
                                     timeout=600)["output_ids"],
                          eng.stats_snapshot())
    _close(eng)
    engine_b1 = _b1_launches() - b0
    want: dict = {}
    ok = engine_b1 == 0
    for key, (ids, st) in runs.items():
        if tuple(ids) not in want:
            want[tuple(ids)] = _tf_gate(model, prompt, ids, 0.0)
        res = want[tuple(ids)]
        ok &= res["ok"]
        extra = ""
        if st["spec_dispatches"]:
            ok &= 0 < st["spec_proposed"] - st["spec_accepted"]
            extra = (f"; accepted/proposed {st['spec_accepted']}/"
                     f"{st['spec_proposed']} over {st['spec_dispatches']} "
                     "spec dispatches")
        if key == "prefix hit":
            ok &= (st["prefix_hits"], st["prefix_hit_tokens"]) == (
                1, _last_boundary(len(prompt) - 1, cfg))
            extra = (f"; prefix hits {st['prefix_hits']} of "
                     f"{st['prefix_hit_tokens']} tokens")
        log(f"  (i) fp32 {ROLLING_FP32_LAYERS} layers, {key}: {len(ids)} ids "
            f"{'all' if res['ok'] else 'NOT all'} the teacher-forced argmax"
            + extra)
    log(f"  (i) B1 launches in the rolling engines {engine_b1}")
    del model, draft
    _free()
    return {"ok": ok, "runs": len(runs)}


def _decode_call(engine, positions: list):
    """A call of one decode chunk of the idle flat engine (CHUNK greedy
    steps, row i at positions[i]) through its own decode function, at the
    cache bucket the engine would pick (a rolling engine's one)."""
    n = engine.n_slots
    args = [torch.ones(n, dtype=torch.long, device=DEVICE),
            torch.tensor(positions, dtype=torch.long, device=DEVICE),
            torch.zeros(n, device=DEVICE),
            torch.zeros(n, dtype=torch.long, device=DEVICE),
            torch.ones(n, device=DEVICE)]
    need = max(positions) + CHUNK
    bucket = next((b for b in engine.decode_buckets if b >= need),
                  engine.decode_buckets[-1])
    fn = engine._decode[(bucket, False)]

    def call():
        fn(engine._cache, *args, engine._gen, None)
    return call


def _chunk_walls(call) -> tuple[float, list]:
    """(median, every) wall ms of `call`, device drained, over
    ROLLING_WALL_REPS calls after a warm one."""
    walls = []
    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        for _ in range(ROLLING_WALL_REPS):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls)), walls


def _rolling_decode_profile(engine, positions: list) -> dict | None:
    """One decode chunk of the idle rolling engine (CHUNK steps, row i at
    positions[i], greedy) through its own decode function, profiled; its
    unprofiled wall first, over ROLLING_WALL_REPS calls (the median
    kept)."""
    n = engine.n_slots
    call = _decode_call(engine, positions)
    wall, walls = _chunk_walls(call)
    with torch.inference_mode():
        rec = _profile(f"rolling decode chunk ({CHUNK} steps, {n} rows at "
                       f"{positions}, window {engine.decode_buckets[0]})",
                       call)
    if rec:
        rec["unprofiled_wall_ms"] = wall
        rec["unprofiled_walls_ms"] = walls
        for what, keys in (("the read's concat", ("CatArray", "cat_")),
                           ("the read's masks (where)", ("where",))):
            hit = [(k, ms, c) for k, (ms, c) in rec["by_name"].items()
                   if any(x in k for x in keys)]
            rec[what] = sum(ms for _, ms, _ in hit)
            log(f"    {what}: {rec[what]:.2f} ms in {sum(c for *_, c in hit)}"
                f" launches ({[k[:60] for k, _, _ in hit][:3]})")
        log(f"    per step: unprofiled wall {wall / CHUNK:.2f} ms (median "
            f"of {[round(w / CHUNK, 2) for w in walls]}), device busy "
            f"{rec['busy_ms'] / CHUNK:.2f} ms")
    return rec


def phase_rolling(work: str, floor: float) -> dict:
    """4h: the rolling-window cache on Mistral-7B-v0.1's config (see
    MISTRAL_CONFIG): (i) fp32 exactness, (ii) the full model past the
    window, (iii) within it, (iv) prefix reuse, (v) a spec target, (vi)
    over HTTP."""
    t_phase = time.monotonic()
    _free()
    gates: dict = {}
    checks = {"flash": 0}
    cfg = hf_mod.llama_config_from_hf(MISTRAL_CONFIG)
    window = cfg.mask_window
    gates["config"] = (cfg.num_params == MISTRAL_PARAMS and (
        cfg.mask_kind, window, cfg.vocab_size) == ("sliding_window", 4096,
                                                   32000))
    log(f"  {MISTRAL_CONFIG['architectures'][0]} config.json: "
        f"{cfg.num_params} parameters, mask {cfg.mask_kind} window {window}, "
        f"max_seq_len {cfg.max_seq_len}, rope_theta {cfg.rope_theta}, "
        f"attention_impl {cfg.attention_impl}")
    t0 = time.monotonic()
    small = _rolling_exactness(cfg)
    gates["i fp32 ids = teacher-forced argmax, rejections, a hit"] = (
        small["ok"])
    log(f"  (i) took {time.monotonic() - t0:.1f}s")
    cfg = dataclasses.replace(cfg, num_layers=ROLLING_LAYERS)
    log(f"  (ii)-(v) at {ROLLING_LAYERS} of its "
        f"{MISTRAL_CONFIG['num_hidden_layers']} layers")
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    rng = np.random.default_rng(SEED + 41)
    bodies = _spec_bodies(cfg.vocab_size, ROLLING_PROMPT_LENS, SEED + 41,
                          max_tokens=ROLLING_MAX_TOKENS)
    rolling_b1 = 0
    # (ii) past the window, four rows
    t0 = time.monotonic()
    eng = GenerationEngine(model, **ROLLING_GEN)
    cache_bytes = {n: t.numel() * t.element_size()
                   for n, t in eng._cache.items()}
    b0 = _b1_launches()
    torch.cuda.reset_peak_memory_stats()
    ids, st = _engine_burst(eng, bodies)
    peak = torch.cuda.max_memory_allocated()
    rolling_b1 += _b1_launches() - b0
    step_ms = _step_ms(st)
    prof = _rolling_decode_profile(
        eng, [n + ROLLING_MAX_TOKENS for n in ROLLING_PROMPT_LENS])
    _close(eng)
    engine_b1 = _b1_launches() - b0
    rows = cfg.num_layers * ROLLING_GEN["slots"] * window
    gates["ii cache bytes"] = (
        cache_bytes["k"] + cache_bytes["v"]
        == 2 * rows * cfg.num_kv_heads * cfg.head_dim * 2
        and cache_bytes["pos"] == 4 * rows)
    gates["ii engine (buckets) and overlap"] = st[
        "decode_fetch_overlapped"] > 0
    log(f"  (ii) {len(bodies)} prompts {ROLLING_PROMPT_LENS} at once, "
        f"{ROLLING_MAX_TOKENS} greedy ids each (max_len "
        f"{ROLLING_GEN['max_len']}, "
        f"window {window}): {st['prefill_chunks']} prefill chunks, "
        f"{st['decode_dispatches']} decode dispatches, "
        f"{step_ms:.2f} ms per 4-row step (host-inclusive); cache "
        f"{cache_bytes}; peak {peak / 2**30:.2f} GiB; B1 launches in the "
        f"engine's run {engine_b1}; {time.monotonic() - t0:.1f}s; {smi()}")
    gates["ii B1 launches 0"] = engine_b1 == 0
    res = [_tf_gate(model, b["input_ids"], g, floor)
           for b, g in zip(bodies, ids)]
    for b, r in zip(bodies, res):
        _tf_line("(ii)", b["input_ids"], r)
    gates["ii ids vs teacher-forced bf16 (near-tie rule)"] = all(
        r["ok"] for r in res)
    # (iii) within the window: a causal view
    t0 = time.monotonic()
    wbodies = _spec_bodies(cfg.vocab_size, WITHIN_PROMPT_LENS, SEED + 42)
    eng = GenerationEngine(model, **WITHIN_GEN)
    view_ok = (eng._rolling == 0 and eng.cfg.mask_kind == "causal"
               and "pos" not in eng._cache
               and model.cfg.mask_kind == "sliding_window")
    b0 = _b1_launches()
    wids, wst = _engine_burst(eng, wbodies)
    within_b1 = _b1_launches() - b0
    _close(eng)
    gates["iii a causal view, the model unchanged"] = view_ok
    gates["iii B1 = a layer's a first admission chunk"] = (
        within_b1 == cfg.num_layers * wst["requests"])
    log(f"  (iii) within the window (max_len {WITHIN_GEN['max_len']}): "
        f"prompts {WITHIN_PROMPT_LENS}, {wst['prefill_chunks']} prefill "
        f"chunks of which {wst['requests']} first chunks; B1 launches "
        f"{within_b1} (expected {cfg.num_layers} x {wst['requests']}); "
        f"{_step_ms(wst):.2f} ms per step; {time.monotonic() - t0:.1f}s")
    wres = [_tf_gate(model, b["input_ids"], g, floor)
            for b, g in zip(wbodies, wids)]
    for b, r in zip(wbodies, wres):
        _tf_line("(iii)", b["input_ids"], r)
    gates["iii ids vs teacher-forced bf16"] = all(r["ok"] for r in wres)
    # (iv) prefix reuse past the window
    t0 = time.monotonic()
    head = rng.integers(0, cfg.vocab_size, ROLLING_PREFIX_HEAD).tolist()
    a, b = (head + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in ROLLING_PREFIX_TAILS)
    eng = GenerationEngine(model, **ROLLING_GEN, prefix_cache=PREFIX_CAP)
    admits: list = []
    _timed(eng, "_admit", admits)
    b0 = _b1_launches()
    runs = {}
    for name, p in (("A", a), ("B hit", b)):
        runs[name] = eng.submit(p, max_tokens=MAX_TOKENS,
                                timeout=600)["output_ids"]
    sp = eng.stats_snapshot()
    frag = next(iter(eng._prefix_lru.values()))[1]
    frag_bytes = sum(t.numel() * t.element_size() for t in frag.values())
    _evict_all(eng)
    runs["B cold"] = eng.submit(b, max_tokens=MAX_TOKENS,
                                timeout=600)["output_ids"]
    rolling_b1 += _b1_launches() - b0
    _close(eng)
    gates["iv hit ids = cold ids"] = runs["B hit"] == runs["B cold"]
    gates["iv one hit at the head's last chunk boundary"] = (
        (sp["prefix_hits"], sp["prefix_hit_tokens"])
        == (1, _last_boundary(ROLLING_PREFIX_HEAD, cfg)))
    log(f"  (iv) shared head {ROLLING_PREFIX_HEAD}, tails "
        f"{ROLLING_PREFIX_TAILS}: hits {sp['prefix_hits']} of "
        f"{sp['prefix_hit_tokens']} tokens, {sp['prefix_stores']} stores, "
        f"a stored fragment {frag['k'].shape[2]} rows and {sorted(frag)}, "
        f"{frag_bytes} bytes; admission s A {admits[0][0]:.4f}, B hit "
        f"{admits[1][0]:.4f}, B cold {admits[2][0]:.4f}; B's ids hit "
        f"{'=' if runs['B hit'] == runs['B cold'] else '!='} cold; "
        f"{time.monotonic() - t0:.1f}s")
    # (v) a spec target: the target's weights as its causal draft
    t0 = time.monotonic()
    sbody = _spec_bodies(cfg.vocab_size, (ROLLING_SPEC_PROMPT,), SEED + 43)
    one = dict(ROLLING_GEN, slots=1)
    eng = GenerationEngine(model, **one, pipeline_depth=1)
    b0 = _b1_launches()
    want, vst = _engine_burst(eng, sbody)
    _close(eng)
    draft = llama_mod.config_view(model, dataclasses.replace(
        cfg, mask_kind="causal", mask_window=0, attention_impl="auto"))
    eng = GenerationEngine(model, **one, pipeline_depth=1,
                           draft={"model": draft, "gamma": SPEC_GAMMA})
    got, sst = _engine_burst(eng, sbody)
    _close(eng)
    rolling_b1 += _b1_launches() - b0
    van = _spec_line("(v) vanilla rolling, one row, depth 1", vst, 1)
    spec = _spec_line("(v) spec on the rolling target, gamma "
                      f"{SPEC_GAMMA}, depth 1", sst, 1)
    gates["v ids vs vanilla rolling (near-tie rule)"] = _ids_gate(
        model, sbody, want, got, floor, "(v)", checks)
    gates["v speculated"] = sst["spec_dispatches"] > 0
    log(f"  (v) {time.monotonic() - t0:.1f}s")
    del model, draft
    _free()
    # (vi) a huggingface bundle over --storage-uri
    t0 = time.monotonic()
    hf4 = dict(MISTRAL_CONFIG, num_hidden_layers=MISTRAL_HF_LAYERS)
    cfg4 = hf_mod.llama_config_from_hf(hf4)
    ref = llama_mod.Llama(cfg4, device=DEVICE).init_weights(SEED).eval()
    ckpt = os.path.join(work, "hf_mistral")
    nbytes, write_s = _write_hf_checkpoint(ckpt, ref.state_dict(), cfg4, hf4)
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "generative": ROLLING_GEN}, f)
    body = _spec_bodies(cfg.vocab_size, (MISTRAL_HTTP_PROMPT,), SEED + 44)[0]
    server, port = server_mod.start([
        "--storage-uri", f"file://{ckpt}", "--name", MISTRAL_NAME, "--host",
        "127.0.0.1", "--port", "0", "--device", DEVICE])
    base = f"http://127.0.0.1:{port}"
    try:
        b0 = _b1_launches()
        served = _post(f"{base}/v1/models/{MISTRAL_NAME}:generate",
                       body)["output_ids"]
        http_b1 = _b1_launches() - b0
        with urllib.request.urlopen(f"{base}/v2/models/{MISTRAL_NAME}",
                                    timeout=30) as r:
            buckets = json.loads(r.read())["decode_buckets"]
    finally:
        server.stop()
        del server
        gc.collect()
    eng = GenerationEngine(ref, **ROLLING_GEN)
    b0 = _b1_launches()
    local = eng.submit(body["input_ids"], max_tokens=MAX_TOKENS,
                       timeout=600)["output_ids"]
    http_b1 += _b1_launches() - b0
    _close(eng)
    del ref
    _free()
    rolling_b1 += http_b1
    gates["vi served ids = the engine's on the same weights"] = (
        served == local)
    gates["vi decode_buckets [window]"] = buckets == [window]
    log(f"  (vi) {MISTRAL_HF_LAYERS} layers of Mistral-7B-v0.1's widths, "
        f"{nbytes} bytes written in {write_s:.2f}s, served through "
        f"--storage-uri file://{ckpt}: a {MISTRAL_HTTP_PROMPT}-token "
        f"request's {len(served)} ids "
        f"{'equal' if served == local else 'DIFFER from'} the engine's; "
        f"decode_buckets {buckets}; B1 launches {http_b1}; "
        f"{time.monotonic() - t0:.1f}s")
    gates["B1 launches 0 on every rolling engine"] = rolling_b1 == 0
    log(f"  B1 launches: rolling engines {rolling_b1}, within the window "
        f"{within_b1}; checks' forwards {checks['flash']} (near-tie) beside "
        f"the teacher-forced ones; 4h took {time.monotonic() - t_phase:.1f}s"
        f"; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"rolling-window gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"launches": {"rolling_serving": rolling_b1,
                         "window_serving": within_b1},
            "step_ms": step_ms, "vanilla": van, "spec": spec,
            "profile": prof, "admit_s": [t for t, _ in admits],
            "cache_bytes": cache_bytes, "peak_gib": peak / 2**30}


def _kwargs(body: dict) -> dict:
    """A request body's sampling keys, for an engine call."""
    return {k: v for k, v in body.items() if k != "input_ids"}


def _ship_timed(engine, log_to: list) -> None:
    """Wrap `engine._finish_ship` so each ship appends (ms of the export,
    the host copy and the pack, frame bytes) to `log_to`; the device
    drains the prefill first (a prefill engine has nothing else in
    flight)."""
    real = engine._finish_ship

    def call(req, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(req, *a)
        log_to.append(((time.perf_counter() - t0) * 1e3,
                       len(req["result"]["shipment"])))
    engine._finish_ship = call


def _import_timed(engine, log_to: list) -> None:
    """Wrap `engine._admit_remote_paged` so each remote admission appends
    (its prompt's length, host ms of the call, CUDA events around it) to
    `log_to`. The events' span is the stream's time from the first of the
    import's copies to the last scatter, where the stream also waits for
    the host's pinning between them."""
    real = engine._admit_remote_paged

    def call(slot, req):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        real(slot, req)
        end.record()
        log_to.append((len(req["input_ids"]),
                       (time.perf_counter() - t0) * 1e3, start, end))
    engine._admit_remote_paged = call


def _until(pred, what: str, timeout: float = 120.0) -> None:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"{what} did not happen in {timeout:.0f} s")
        time.sleep(0.001)


def _step_window(engine, rows, during) -> dict:
    """Wall ms per 4-row step of `engine` while `rows()` (DISAGG_ROWS
    requests) decode, from the times its chunks' fetches land: over a
    window from just before `during()` to the DISAGG_WINDOW_CHUNKS-th
    fetch after it returns, with the longest wait between two fetches
    there, then over as many fetches with nothing beside; and `during`'s
    seconds."""
    out, times = [], []
    stop = threading.Event()

    def fetched():
        s = engine.stats_snapshot()
        return s["decode_fetch_overlapped"] + s["decode_fetch_blocking"]

    def poll():
        last = fetched()
        while not stop.is_set():
            n = fetched()
            times.extend([time.monotonic()] * (n - last))
            last = n
            time.sleep(0.0005)

    poller = threading.Thread(target=poll)
    poller.start()
    th = threading.Thread(target=lambda: out.append(rows()))
    th.start()
    try:
        _until(lambda: len(times) >= 2, "the rows' first fetches")
        t0, k0 = time.monotonic(), len(times)
        during()
        busy = time.monotonic() - t0
        k1 = len(times) + DISAGG_WINDOW_CHUNKS
        _until(lambda: len(times) >= k1 + DISAGG_WINDOW_CHUNKS,
               "the window's fetches")
    finally:
        stop.set()
        poller.join(timeout=30)
        th.join(timeout=600)
    if not out:
        raise RuntimeError("the step window's rows failed")
    edges = [t0] + times[k0:k1]
    t2 = times[k1 + DISAGG_WINDOW_CHUNKS - 1]
    return {"during": (edges[-1] - t0) / ((k1 - k0) * CHUNK) * 1e3,
            "longest_wait_ms": max(b - a for a, b in zip(edges, edges[1:]))
            * 1e3,
            "alone": (t2 - edges[-1]) / (DISAGG_WINDOW_CHUNKS * CHUNK) * 1e3,
            "busy_s": busy}


def phase_disagg(work: str, floor: float) -> dict:
    """4i: disaggregated roles on phase 4's llama3_8b (one module under
    every engine, paged, blocks of 16). For each case a unified engine, a
    prefill engine and a decode engine: (i) phase 4's six requests shipped
    and decoded at once; (ii) a request at temperature 0.8 alone on each
    side; (iii) an int8 pool; (iv) the target as its own draft; (v) an
    adapter; then the decode step while a prompt prefills beside it, and
    (vi) :prefill and :decode over HTTP."""
    t_phase = time.monotonic()
    cfg = registry.model_config(MODEL, **MODEL_KWARGS,
                                num_layers=DISAGG_LAYERS)
    _reset_counts()
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    nl = cfg.num_layers
    log(f"  {MODEL}'s widths at {nl} layers")
    paged = dict(GENERATIVE, kv_block_size=KV_BLOCK_SIZE)
    bodies = _bodies(cfg.vocab_size)
    greedy = [i for i, b in enumerate(bodies) if "temperature" not in b]
    longest = bodies[-1]
    # Bytes of k and v a prompt token holds (every layer).
    kv_row = (2 * nl * cfg.num_kv_heads * cfg.head_dim
              * torch.finfo(cfg.dtype).bits // 8)
    blocks = [-(-len(b["input_ids"]) // KV_BLOCK_SIZE) for b in bodies]
    gates: dict = {}
    checks = {"flash": 0}
    prefills = [0]  # local admissions and ships: one B1 a layer each
    decode_b1: dict = {}

    def engine(**kw):
        return GenerationEngine(model, **paged, **kw)

    def done(eng, role=None):
        """Close `eng`, counting its prefills (a decode engine has none)."""
        if role != "decode":
            prefills[0] += eng.stats_snapshot()["requests"]
        _close(eng)

    def decode_alone(eng, what, fn):
        """`fn()` on a decode engine with nothing else running: its B1
        launches go to decode_b1[what]."""
        before = _b1_launches()
        out = fn()
        decode_b1[what] = _b1_launches() - before
        return out

    # (i) greedy, and a sampled row, shipped and decoded at once
    uni = engine()
    want, _ = _engine_burst(uni, bodies)
    pre, dec = engine(role="prefill"), engine(role="decode")
    ship_log, import_log = [], []
    _ship_timed(pre, ship_log)
    _import_timed(dec, import_log)
    before = _b1_launches()
    frames = [pre.prefill_ship(b["input_ids"], timeout=600,
                               **_kwargs(b))["shipment"] for b in bodies]
    pre_b1 = _b1_launches() - before
    sp, pre_used = pre.stats_snapshot(), pre.kv_blocks_used
    results = decode_alone(dec, "i", lambda: _burst(
        lambda f: dec.submit_remote(f, timeout=600), frames))
    got = [r["output_ids"] for r in results]
    sd = dec.stats_snapshot()
    torch.cuda.synchronize()
    imports = {n: (host, a.elapsed_time(b)) for n, host, a, b in import_log}
    ships = list(ship_log)
    gates["i greedy ids vs the unified engine's"] = _ids_gate(
        model, [bodies[i] for i in greedy], [want[i] for i in greedy],
        [got[i] for i in greedy], floor, "(i) the pair", checks)
    gates["i every output 32 ids of the vocabulary"] = all(
        len(ids) == MAX_TOKENS and all(0 <= t < cfg.vocab_size for t in ids)
        for ids in got)
    gates["i decode engine: no prefill chunk, no B1"] = (
        sd["prefill_chunks"] == 0 and decode_b1["i"] == 0)
    gates["i prefill engine: B1 a layer's a prompt, no decode, drained"] = (
        pre_b1 == nl * len(bodies) and sp["decode_dispatches"] == 0
        and pre_used == 0)
    gates["i blocks shipped = received = sum of ceil(len / 16)"] = (
        sp["kv_blocks_shipped"] == sd["kv_blocks_received"] == sum(blocks))
    gates["i each frame holds its prompt's k and v"] = all(
        len(f) >= n * KV_BLOCK_SIZE * kv_row for f, n in zip(frames, blocks))
    for b, (ship_ms, nbytes) in zip(bodies, ships):
        host_ms, span_ms = imports[len(b["input_ids"])]
        log(f"  (i) prompt {len(b['input_ids'])}: frame {nbytes} bytes, "
            f"ship (export, host copy, pack) {ship_ms:.2f} ms, import "
            f"{host_ms:.2f} ms on the host (pinning, copies and scatters "
            f"enqueued), the stream's span {span_ms:.2f} ms; {smi()}")
    log("  (i) remote admissions in order of arrival: prompts "
        f"{[n for n, *_ in import_log[:len(bodies)]]}")
    log(f"  (i) B1 launches: prefill engine {pre_b1} for {len(bodies)} "
        f"prompts, decode engine {decode_b1['i']}; blocks shipped "
        f"{sp['kv_blocks_shipped']}, received {sd['kv_blocks_received']}; "
        f"decode engine prefill chunks {sd['prefill_chunks']}, "
        f"{sd['decode_dispatches']} dispatches; the sampled row's ids "
        f"{'equal' if got[2] == want[2] else 'differ from'} the unified "
        "engine's (shared generator, other interleaving: not gated)")
    # The decode step while the longest prompt prefills beside it.
    row_bodies = [dict(bodies[1], max_tokens=DISAGG_ROW_TOKENS)
                  ] * DISAGG_ROWS
    row_frames = [pre.prefill_ship(b["input_ids"], timeout=600,
                                   **_kwargs(b))["shipment"]
                  for b in row_bodies]
    pair_step = _step_window(
        dec, lambda: _burst(lambda f: dec.submit_remote(f, timeout=600),
                            row_frames),
        lambda: pre.prefill_ship(longest["input_ids"], timeout=600,
                                 **_kwargs(longest)))
    uni_step = _step_window(
        uni, lambda: _engine_burst(uni, row_bodies),
        lambda: uni.submit(longest["input_ids"], max_tokens=1, timeout=600))
    done(uni)
    done(pre)
    done(dec, "decode")
    log(f"  decode step, {DISAGG_ROWS} rows of 4 decoding (wall ms a "
        f"step from the fetches' times, over a window that ends "
        f"{DISAGG_WINDOW_CHUNKS} fetches after the prefill): on the decode "
        f"engine {pair_step['during']:.2f} ms, the longest wait between "
        f"two fetches "
        f"{pair_step['longest_wait_ms']:.1f} ms, while the prefill engine "
        f"shipped the {len(longest['input_ids'])}-token prompt "
        f"({pair_step['busy_s']:.3f} s), {pair_step['alone']:.2f} ms after;"
        f" on the unified engine {uni_step['during']:.2f} ms, the longest "
        f"wait {uni_step['longest_wait_ms']:.1f} ms, while it admitted the "
        f"same prompt ({uni_step['busy_s']:.3f} s to its first token), "
        f"{uni_step['alone']:.2f} ms after (one card: the engines share "
        f"its SMs and one process's GIL); {smi()}")
    # (ii) one sampled request alone on each side
    body = dict(bodies[4], temperature=DISAGG_TEMPERATURE)
    uni = engine(seed=DISAGG_SEED)
    ref = uni.submit(body["input_ids"], timeout=600, **_kwargs(body))
    done(uni)
    pre = engine(seed=DISAGG_SEED, role="prefill")
    frame = pre.prefill_ship(body["input_ids"], timeout=600,
                             **_kwargs(body))["shipment"]
    done(pre)
    dec = engine(seed=DISAGG_SEED + 1, role="decode")
    out = decode_alone(dec, "ii", lambda: dec.submit_remote(frame,
                                                            timeout=600))
    done(dec, "decode")
    same = (out["output_ids"] == ref["output_ids"]
            and out["output_logprobs"] == ref["output_logprobs"])
    gates["ii sampled stream bit-equal to the unified engine's"] = same
    log(f"  (ii) prompt {len(body['input_ids'])} at temperature "
        f"{DISAGG_TEMPERATURE}: ids and logprobs through the pair "
        f"{'bit-equal to' if same else 'DIFFER from'} the unified "
        f"engine's on seed {DISAGG_SEED} (decode engine seeded "
        f"{DISAGG_SEED + 1})")
    # (iii) an int8 pool
    uni = engine(kv_quant="int8")
    ref = uni.submit(longest["input_ids"], timeout=600, **_kwargs(longest))
    done(uni)
    pre = engine(kv_quant="int8", role="prefill")
    frame8 = pre.prefill_ship(longest["input_ids"], timeout=600,
                              **_kwargs(longest))["shipment"]
    done(pre)
    dec = engine(kv_quant="int8", role="decode")
    out = decode_alone(dec, "iii", lambda: dec.submit_remote(frame8,
                                                             timeout=600))
    done(dec, "decode")
    meta8 = peek_meta(frame8)
    ratio = len(frame8) / len(frames[-1])
    gates["iii fmt 3, int8"] = (meta8["fmt"], meta8.get("kv_quant")) == (
        3, "int8")
    gates["iii frame <= 0.55 x the fmt-1 frame"] = ratio <= 0.55
    gates["iii ids = the int8 unified engine's"] = (
        out["output_ids"] == ref["output_ids"])
    log(f"  (iii) int8 pool, prompt {len(longest['input_ids'])}: fmt "
        f"{meta8['fmt']} frame {len(frame8)} bytes, {ratio:.4f} x the "
        f"fmt-1 frame's {len(frames[-1])}; ids "
        f"{'equal to' if out['output_ids'] == ref['output_ids'] else 'DIFFER from'}"
        " the int8 unified engine's")
    # (iv) the target as its own draft
    draft = {"model": model, "gamma": SPEC_GAMMA}
    body = bodies[3]
    uni = engine(draft=draft)
    ref = uni.submit(body["input_ids"], timeout=600, **_kwargs(body))
    done(uni)
    pre = engine(draft=draft, role="prefill")
    frame2 = pre.prefill_ship(body["input_ids"], timeout=600,
                              **_kwargs(body))["shipment"]
    done(pre)
    dec = engine(draft=draft, role="decode")
    out = decode_alone(dec, "iv", lambda: dec.submit_remote(frame2,
                                                            timeout=600))
    s4 = dec.stats_snapshot()
    done(dec, "decode")
    meta2 = peek_meta(frame2)
    gates["iv fmt 2 with a draft section"] = (
        meta2["fmt"] == 2 and meta2.get("draft", {}).get("n_blocks")
        == -(-len(body["input_ids"]) // KV_BLOCK_SIZE))
    gates["iv decode engine speculates, no prefill chunk"] = (
        s4["spec_dispatches"] > 0 and s4["prefill_chunks"] == 0)
    gates["iv ids = the unified spec engine's"] = (
        out["output_ids"] == ref["output_ids"])
    log(f"  (iv) self-draft (gamma {SPEC_GAMMA}), prompt "
        f"{len(body['input_ids'])}: fmt {meta2['fmt']} frame {len(frame2)} "
        f"bytes, draft section {meta2.get('draft')}; decode engine "
        f"{s4['spec_dispatches']} spec dispatches, accepted "
        f"{s4['spec_accepted']}/{s4['spec_proposed']}, prefill chunks "
        f"{s4['prefill_chunks']}; ids "
        f"{'equal to' if out['output_ids'] == ref['output_ids'] else 'DIFFER from'}"
        " the unified spec engine's")
    # (v) an adapter named in the frame
    spec = ML_ADAPTERS["ml_a"]
    adapters = {"ml_a": multilora.write_synthetic_adapter(
        cfg, os.path.join(work, "disagg_ml_a"), spec["seed"], r=spec["r"],
        targets=spec["targets"])}
    body = dict(bodies[3], adapter="ml_a")
    uni = engine(adapters=adapters)
    ref = uni.submit(body["input_ids"], timeout=600, **_kwargs(body))
    done(uni)
    pre = engine(adapters=adapters, role="prefill")
    framea = pre.prefill_ship(body["input_ids"], timeout=600,
                              **_kwargs(body))["shipment"]
    done(pre)
    dec = engine(adapters=adapters, role="decode")
    out = decode_alone(dec, "v", lambda: dec.submit_remote(framea,
                                                           timeout=600))
    done(dec, "decode")
    gates["v adapter in the frame, ids = the unified engine's"] = (
        peek_meta(framea)["adapter"] == "ml_a"
        and out["output_ids"] == ref["output_ids"])
    log(f"  (v) adapter ml_a, prompt {len(body['input_ids'])}: ids "
        f"{'equal to' if out['output_ids'] == ref['output_ids'] else 'DIFFER from'}"
        " the unified engine's for the adapter")
    # (vi) over HTTP
    server = ModelServer()
    served = {}
    for name, extra in (("unified", {}), ("prefill", {"role": "prefill"}),
                        ("decode", {"role": "decode"}),
                        ("small", {"role": "decode",
                                   "kv_blocks": DISAGG_SMALL_BLOCKS})):
        bundle = os.path.join(work, f"disagg_{name}")
        export_for_serving(bundle, model=MODEL, model_kwargs=dict(
                               MODEL_KWARGS, num_layers=DISAGG_LAYERS),
                           seed=SEED,
                           extra={"generative": {**paged, **extra}})
        with open(os.path.join(bundle, "model.json")) as f:
            bspec = json.load(f)
        served[name] = runtimes._generative(f"{MODEL}_{name}", model, bspec,
                                            dict(bspec["generative"]))
        served[name].load()
        server.register(served[name])
    base = f"http://127.0.0.1:{server.start_background(0)}"
    res_metrics.reset()
    try:
        url = f"{base}/v1/models/{MODEL}_" + "{}:{}"
        t0 = time.monotonic()
        code, hdrs, frame = _request("POST", url.format("prefill", "prefill"),
                                     longest)
        prefill_s = time.monotonic() - t0
        ctype = hdrs.get("Content-Type")
        code_d, _, raw = _request("POST", url.format("decode", "decode"),
                                  frame)
        plain = json.loads(raw) if code_d == 200 else {}
        t0 = time.monotonic()
        _, _, frame_s = _request("POST", url.format("prefill", "prefill"),
                                 dict(longest, stream=True))
        stream_prefill_s = time.monotonic() - t0
        streamed = _stream(url.format("decode", "decode"), frame_s)
        uni_stream = _stream(url.format("unified", "generate"),
                             dict(longest, stream=True))
        code_503, hdrs_503, _ = _request("POST", url.format("small", "decode"),
                                         frame)
        code_400, _, _ = _request("POST", url.format("decode", "decode"),
                                  frame[:-100])
        text = _request("GET", base + "/metrics")[2].decode()
        for name in ("unified", "prefill"):
            prefills[0] += served[name].engine.stats_snapshot()["requests"]
        dstats = served["decode"].engine.stats_snapshot()
    finally:
        server.stop()
        _free()
    joined = [t for ev in streamed["frames"][:-1]
              for t in ev.get("tokens", ())]
    http_ids = plain.get("output_ids", [])
    gates["vi :prefill answers a KV frame"] = (
        code == 200 and ctype == server_mod.KV_SHIPMENT_CONTENT_TYPE)
    gates["vi :decode plain, ids vs (i)"] = code_d == 200 and _ids_gate(
        model, [longest], [got[-1]], [http_ids], floor, "(vi) :decode",
        checks)
    gates["vi :decode streamed = plain"] = (
        streamed["content_type"] == "application/x-ndjson"
        and joined == streamed["frames"][-1].get("output_ids") == http_ids)
    gates["vi never fits: 503 + Retry-After"] = (
        code_503 == 503 and hdrs_503.get("Retry-After") == "1")
    gates["vi truncated frame: 400"] = code_400 == 400
    rows = {f"tpk_kv_blocks_shipped_total{{model=\"{MODEL}_prefill\"}}":
            2 * blocks[-1],
            f"tpk_kv_blocks_received_total{{model=\"{MODEL}_decode\"}}":
            2 * blocks[-1],
            f"tpk_engine_remote_admits_total{{model=\"{MODEL}_decode\"}}": 2,
            f"tpk_engine_prefill_chunks_total{{model=\"{MODEL}_decode\"}}":
            0, "tpk_kv_shipment_bytes_count": 2}
    scraped = {k: _metric(text, k) for k in rows}
    gates["vi /metrics: the new rows"] = all(
        scraped[k] == v for k, v in rows.items()) and dstats[
            "remote_admits"] == 2
    log(f"  (vi) HTTP, prompt {len(longest['input_ids'])}: :prefill "
        f"{prefill_s:.3f} s ({len(frame)} bytes, {ctype}); streamed, "
        f":prefill {stream_prefill_s:.3f} s then :decode's first frame "
        f"{streamed['first_s']:.3f} s = "
        f"{stream_prefill_s + streamed['first_s']:.3f} s to the first "
        f"frame, against {uni_stream['first_s']:.3f} s on the unified "
        f"model's :generate stream; a frame the {DISAGG_SMALL_BLOCKS}-"
        f"block pool can never hold {code_503}, a truncated one "
        f"{code_400}; /metrics {scraped}; {smi()}")
    launches = _b1_launches() - checks["flash"]
    gates["B1 launches = a layer's a prefill, none on a decode engine"] = (
        launches == nl * prefills[0]
        and not any(decode_b1.values()))
    del model
    _free()
    log(f"  B1 launches in 4i {launches} for {prefills[0]} prefills "
        f"(expected {nl} each; decode engines {decode_b1}), besides "
        f"{checks['flash']} in the near-tie checks' forwards; 4i took "
        f"{time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"disaggregation gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"launches": launches,
            "ship_ms": [t for t, _ in ships],
            "frame_bytes": [n for _, n in ships],
            "import_ms": {n: host for n, (host, _) in imports.items()},
            "pair_step": pair_step, "uni_step": uni_step,
            "first_frame_s": stream_prefill_s + streamed["first_s"],
            "unified_first_frame_s": uni_stream["first_s"],
            "int8_ratio": ratio}


def _gemma_model(hf: dict, **over):
    """(config, bf16 model) of config.json `hf` (`config_from_hf`), random
    weights from the seed; (1 + w) norm scales and QKV biases drawn
    N(0, GEMMA_DRAW_STD), so the plus-one and bias paths do work."""
    cfg = hf_mod.config_from_hf(hf, **over)
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 50)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") or (name.endswith(".scale")
                                          and cfg.norm_plus_one):
                p.normal_(0.0, GEMMA_DRAW_STD, generator=gen)
    return cfg, model


def _plain_last_logits(model, prompt: list) -> torch.Tensor:
    """fp32 logits of the last prompt position from one full forward with
    attention through the flash kernel's plain version."""
    real = llama_mod.flash_attention

    def plain(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return fa._flash_fwd_plain(q, k, v, fa._norm_mask(causal, mask),
                                   segment_ids)[0]
    llama_mod.flash_attention = plain
    try:
        with torch.inference_mode():
            hidden = model(torch.tensor([prompt], device=DEVICE),
                           return_hidden=True)
            return model.unembed(hidden[0, -1]).float()
    finally:
        llama_mod.flash_attention = real


def _step_walls(engine, lens) -> dict:
    """4j's decode step: one decode chunk of the idle engine, its rows at
    the ends of requests of `lens` tokens (cycled over the slots); the
    median wall ms a step over ROLLING_WALL_REPS chunks, and each."""
    pos = [lens[i % len(lens)] + MAX_TOKENS for i in range(engine.n_slots)]
    wall, walls = _chunk_walls(_decode_call(engine, pos))
    return {"ms": wall / CHUNK, "reps": [round(w / CHUNK, 2) for w in walls]}


def _step_text(step: dict, rows: int) -> str:
    return (f"{step['ms']:.2f} ms per {rows}-row step (median wall of "
            f"{ROLLING_WALL_REPS} decode chunks: {step['reps']})")


def _gemma7b(floor: float, gates: dict) -> dict:
    """4j (i): Gemma-7B whole, four prompts at once through the HTTP
    server; every first admission chunk runs B1 on the tensor-core
    CUDA-core kernel, 28 launches; ids against one teacher-forced bf16
    full forward each; the first token's logits against a full forward
    through the plain attention."""
    t0 = time.monotonic()
    cfg, model = _gemma_model(GEMMA7B_CONFIG)
    gates["i config"] = (cfg.num_params == GEMMA7B_PARAMS and (
        cfg.head_dim, cfg.norm_plus_one, cfg.embed_scale, cfg.mlp_act,
        cfg.tie_embeddings) == (256, True, True, "gelu_tanh", True))
    build_s = time.monotonic() - t0
    served = GenerativeTorchModel(GEMMA7B_NAME, model,
                                  generation=dict(GEMMA_GEN))
    served.load()
    server = ModelServer()
    server.register(served)
    port = server.start_background(0)
    url = f"http://127.0.0.1:{port}/v1/models/{GEMMA7B_NAME}:generate"
    bodies = _spec_bodies(cfg.vocab_size, GEMMA_PROMPT_LENS, SEED + 51)
    try:
        b0 = _b1_split()
        torch.cuda.reset_peak_memory_stats()
        ids = [r["output_ids"] for r in _burst(lambda b: _post(url, b),
                                                bodies)]
        peak = torch.cuda.max_memory_allocated()
        wgmma, simt, mma = _since(b0)
        st = served.engine.stats_snapshot()
        logits: list = []
        with _first_logits(served.engine.model, logits):
            served.engine.submit(bodies[2]["input_ids"], max_tokens=1,
                                 timeout=600)
        step = _step_walls(served.engine, GEMMA_PROMPT_LENS)
    finally:
        server.stop()  # unloads the model
        del server, served
        _free()
    first = st["requests"]
    gates["i B1 = 28 mma launches a first admission chunk"] = (
        mma == simt == cfg.num_layers * first and wgmma == 0)
    log(f"  (i) Gemma-7B ({cfg.num_params} parameters, head_dim "
        f"{cfg.head_dim}, {cfg.num_layers} layers) built in {build_s:.1f}s; "
        f"prompts {GEMMA_PROMPT_LENS} at once over HTTP, {MAX_TOKENS} ids "
        f"each: {st['prefill_chunks']} prefill chunks ({first} first "
        f"chunks), B1 launches {simt} CUDA-core of which {mma} on "
        f"flash_simt_fwd_mma_kernel (expected {cfg.num_layers} x {first}), "
        f"wgmma {wgmma}; peak {peak / 2**30:.2f} GiB; {smi()}")
    log(f"    (i) {_step_text(step, 4)}")
    res = [_tf_gate(model, b["input_ids"], g, floor)
           for b, g in zip(bodies, ids)]
    for b, r in zip(bodies, res):
        _tf_line("(i)", b["input_ids"], r)
    gates["i ids vs teacher-forced bf16 (near-tie rule)"] = all(
        r["ok"] for r in res)
    ref = _plain_last_logits(model, bodies[2]["input_ids"])
    rel = _rel_l2(logits[0], ref)
    gates["i first-token logits vs plain attention"] = (
        rel <= GEMMA_LOGITS_VS_FLOOR * floor)
    log(f"    first token of the {GEMMA_PROMPT_LENS[2]}-token prompt: "
        f"logits rel_l2 {rel:.3e} from a full forward through the plain "
        f"attention (bound {GEMMA_LOGITS_VS_FLOOR} x phase 3's floor "
        f"{floor:.3e}); (i) took {time.monotonic() - t0:.1f}s")
    del model, ref
    _free()
    return {"mma": mma, "step": step, "peak_gib": peak / 2**30,
            "rel_l2": rel}


def _gemma2(floor: float, gates: dict) -> dict:
    """4j (ii): Gemma-2-9B's widths at GEMMA2_LAYERS layers, one prompt
    past the window on a full-length cache (the mask kept, the sliding
    layers' reads banded); no B1 launch, as in JAX; ids against the
    teacher-forced full forward."""
    t0 = time.monotonic()
    hf = dict(GEMMA2_9B_CONFIG, num_hidden_layers=GEMMA2_LAYERS)
    cfg, model = _gemma_model(hf)
    eng = GenerationEngine(model, **GEMMA2_GEN)
    kept = (eng._rolling == 0 and eng.cfg.mask_kind == "sliding_window"
            and eng._cache["k"].shape[2] == GEMMA2_GEN["max_len"])
    body = _spec_bodies(cfg.vocab_size, (GEMMA2_PROMPT,), SEED + 52)[0]
    b0 = _b1_launches()
    torch.cuda.reset_peak_memory_stats()
    ids = eng.submit(body["input_ids"], max_tokens=MAX_TOKENS,
                     timeout=600)["output_ids"]
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats_snapshot()
    b1 = _b1_launches() - b0
    step = _step_walls(eng, (GEMMA2_PROMPT,))
    _close(eng)
    torch.cuda.reset_peak_memory_stats()
    res = _tf_gate(model, body["input_ids"], ids, floor)
    tf_peak = torch.cuda.max_memory_allocated()
    gates["ii the mask and the full-length cache kept"] = kept
    gates["ii no B1 launch"] = b1 == 0
    gates["ii ids vs teacher-forced bf16 (near-tie rule)"] = res["ok"]
    log(f"  (ii) Gemma-2-9B's widths at {cfg.num_layers} layers (window "
        f"{cfg.mask_window}, caps {cfg.attn_softcap}/{cfg.final_softcap}, "
        f"query_pre_attn_scalar {cfg.query_pre_attn_scalar}): a "
        f"{GEMMA2_PROMPT}-token prompt past the window, max_len "
        f"{GEMMA2_GEN['max_len']}, rolling {eng._rolling}, mask "
        f"{eng.cfg.mask_kind}: {st['prefill_chunks']} prefill chunks, "
        f"{_step_text(step, 1)}; B1 launches {b1}; peak {peak / 2**30:.2f} "
        f"GiB serving, {tf_peak / 2**30:.2f} GiB in the teacher-forced "
        f"forward (naive attention at {GEMMA2_PROMPT + MAX_TOKENS - 1} "
        f"tokens)")
    _tf_line("(ii)", body["input_ids"], res)
    log(f"    (ii) took {time.monotonic() - t0:.1f}s")
    del model, eng
    _free()
    return {"b1": b1, "step": step, "peak_gib": peak / 2**30,
            "tf_peak_gib": tf_peak / 2**30}


def _gemma3(floor: float, gates: dict) -> dict:
    """4j (iii): Gemma-3-1B whole: within the window (a causal view, its
    dual RoPE kept; B1 on the tensor-core kernel, 26 launches a first
    chunk) and past it (5to1 banded reads, no B1); ids against the
    teacher-forced full forward."""
    t0 = time.monotonic()
    cfg, model = _gemma_model(GEMMA3_1B_CONFIG)
    out = {}
    for where, gen, lens in (("within", GEMMA3_WITHIN, GEMMA3_WITHIN_LENS),
                             ("past", GEMMA3_PAST, GEMMA3_PAST_LENS)):
        eng = GenerationEngine(model, **gen)
        kinds = llama_mod.sliding_flags(eng.cfg)
        layout = (eng._rolling, eng.cfg.mask_kind, kinds is not None)
        bodies = _spec_bodies(cfg.vocab_size, lens, SEED + 53)
        b0 = _b1_split()
        ids, st = _engine_burst(eng, bodies)
        wgmma, simt, mma = _since(b0)
        step = _step_walls(eng, lens)
        _close(eng)
        res = [_tf_gate(model, b["input_ids"], g, floor)
               for b, g in zip(bodies, ids)]
        if where == "within":
            gates["iii within: a causal view with its per-layer kinds"] = (
                layout == (0, "causal", True))
            gates["iii within: B1 = 26 mma launches a first chunk"] = (
                mma == simt == cfg.num_layers * st["requests"]
                and wgmma == 0)
        else:
            gates["iii past: the mask kept, nothing rolls"] = (
                layout == (0, "sliding_window", True))
            gates["iii past: no B1 launch"] = wgmma + simt == 0
        gates[f"iii {where}: ids vs teacher-forced bf16"] = all(
            r["ok"] for r in res)
        log(f"  (iii) Gemma-3-1B ({cfg.num_params} parameters, {cfg.num_heads}"
            f" heads, {cfg.num_kv_heads} kv head, window {cfg.mask_window}) "
            f"{where} the window (max_len {gen['max_len']}; rolling "
            f"{layout[0]}, mask {layout[1]}): prompts {lens}, "
            f"{st['prefill_chunks']} prefill chunks; B1 launches {simt} "
            f"CUDA-core ({mma} mma), wgmma {wgmma}; "
            f"{_step_text(step, eng.n_slots)}")
        for b, r in zip(bodies, res):
            _tf_line(f"(iii) {where}", b["input_ids"], r)
        out[where] = {"mma": mma, "step": step}
    log(f"    (iii) took {time.monotonic() - t0:.1f}s")
    del model
    _free()
    return out


def _qwen2(work: str, floor: float, gates: dict) -> dict:
    """4j (iv): Qwen2-7B's widths at QWEN2_LAYERS layers, QKV biases drawn
    nonzero, written as a huggingface checkpoint and served over
    --storage-uri in bf16 and under `quantize: int8`: ids equal to an
    engine's on the same weights; B1 on the wgmma kernel; the W8A16
    launches by kernel; in bf16, the engine's first-token logits against a
    full forward through the plain attention."""
    t0 = time.monotonic()
    hf = dict(QWEN2_7B_CONFIG, num_hidden_layers=QWEN2_LAYERS)
    cfg, model = _gemma_model(hf)
    ckpt = os.path.join(work, "hf_qwen2")
    nbytes, write_s = _write_hf_checkpoint(ckpt, model.state_dict(), cfg, hf)
    bodies = _spec_bodies(cfg.vocab_size, QWEN2_PROMPT_LENS, SEED + 54)
    out = {}
    for mode in ("bf16", "int8"):
        spec = {"format": "huggingface", "generative": GEMMA_GEN}
        if mode == "int8":
            spec["quantize"] = "int8"
        with open(os.path.join(ckpt, "model.json"), "w") as f:
            json.dump(spec, f)
        server, port = server_mod.start([
            "--storage-uri", f"file://{ckpt}", "--name", QWEN2_NAME,
            "--host", "127.0.0.1", "--port", "0", "--device", DEVICE])
        url = f"http://127.0.0.1:{port}/v1/models/{QWEN2_NAME}:generate"
        try:
            b0 = _b1_split()
            w0 = (w8.w8a16_launches, w8.w8a16_wgmma_launches)
            ids = [r["output_ids"] for r in _burst(lambda b: _post(url, b),
                                                    bodies)]
            wgmma, simt, _ = _since(b0)
            w8_calls = (w8.w8a16_launches - w0[0],
                        w8.w8a16_wgmma_launches - w0[1])
            st = server.models[QWEN2_NAME].engine.stats_snapshot()
        finally:
            server.stop()
            del server
            _free()
        if mode == "int8":
            squant.quantize_model(model)
        eng = GenerationEngine(model, **GEMMA_GEN)
        want, _ = _engine_burst(eng, bodies)
        step = _step_walls(eng, QWEN2_PROMPT_LENS)
        rel = None
        if mode == "bf16":
            logits: list = []
            with _first_logits(eng.model, logits):
                eng.submit(bodies[1]["input_ids"], max_tokens=1, timeout=600)
            rel = _rel_l2(logits[0], _plain_last_logits(
                model, bodies[1]["input_ids"]))
            gates["iv bf16: first-token logits vs plain attention"] = (
                rel <= GEMMA_LOGITS_VS_FLOOR * floor)
        _close(eng)
        steps = st["decode_dispatches"] * CHUNK
        w8_expect = (7 * cfg.num_layers * (st["prefill_chunks"] + steps)
                     + st["requests"] + steps) if mode == "int8" else 0
        gates[f"iv {mode}: served ids = the engine's"] = ids == want
        gates[f"iv {mode}: B1 on the wgmma kernel, 4 a first chunk"] = (
            wgmma == cfg.num_layers * st["requests"] and simt == 0)
        gates[f"iv {mode}: W8A16 launches"] = w8_calls[0] == w8_expect
        log(f"  (iv) Qwen2-7B's widths at {cfg.num_layers} layers, {mode}, "
            f"over --storage-uri ({nbytes} bytes written in {write_s:.2f}s):"
            f" prompts {QWEN2_PROMPT_LENS}, ids "
            f"{'equal' if ids == want else 'DIFFER from'} the engine's; B1 "
            f"wgmma {wgmma} (expected {cfg.num_layers} x {st['requests']}), "
            f"CUDA-core {simt}; W8A16 launches {w8_calls[0]} (expected "
            f"{w8_expect}), of them wgmma {w8_calls[1]}, decode "
            f"{w8_calls[0] - w8_calls[1]}; {_step_text(step, 4)}")
        if rel is not None:
            log(f"    first token of the {QWEN2_PROMPT_LENS[1]}-token prompt "
                f"on the engine: logits rel_l2 {rel:.3e} from a full forward"
                f" through the plain attention (bound "
                f"{GEMMA_LOGITS_VS_FLOOR} x phase 3's floor {floor:.3e})")
        out[mode] = {"b1": wgmma, "w8a16": w8_calls, "step": step,
                     "rel_l2": rel}
    log(f"    (iv) took {time.monotonic() - t0:.1f}s")
    del model
    _free()
    return out


def phase_gemma(work: str, floor: float, gk) -> dict:
    """4j: the Gemma 1/2/3 and Qwen2 config flags on the card (see the
    constants' comment): (i) Gemma-7B over HTTP, (ii) Gemma-2 past the
    window, (iii) Gemma-3-1B within and past it, (iv) Qwen2 bf16 and int8
    over --storage-uri, then the W8A16 op at GEMMA_W8A16_SHAPES against
    its plain version."""
    t_phase = time.monotonic()
    _free()
    gates: dict = {}
    g7 = _gemma7b(floor, gates)
    g2 = _gemma2(floor, gates)
    g3 = _gemma3(floor, gates)
    qw = _qwen2(work, floor, gates)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    for m, k, n, unembed in GEMMA_W8A16_SHAPES:
        x, q, scale = gk.w8a16_inputs(m, k, n, torch.bfloat16, gen, dev)
        plan = w8._w8a16_plan(m, k, n, torch.bfloat16, True,
                              w8._sm_count(dev.index or 0))
        err = gk.w8a16_check(x, q, scale, unembed)
        log(f"  W8A16 M{m} K{k} N{n}{' unembedding' if unembed else ''}: "
            f"{plan.kernel} kernel, rel_l2 "
            f"{err['rel_l2']:.2e} (bound {gk.W8A16_TOL[torch.bfloat16]}), "
            f"two launches bit-identical")
        del x, q, scale
    log(f"  4j took {time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"Gemma/Qwen2 gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"simt_launches": {"gemma_7b_serving": g7["mma"],
                              "gemma3_1b_serving": g3["within"]["mma"]},
            "fwd_launches": {"qwen2_serving": qw["bf16"]["b1"],
                             "qwen2_int8_serving": qw["int8"]["b1"]},
            "w8a16_launches": qw["int8"]["w8a16"], "gemma7b": g7,
            "gemma2": g2, "gemma3": g3}


def _w8a16_counts() -> tuple:
    return w8.w8a16_launches, w8.w8a16_wgmma_launches


def _w8a16_expect(shapes, dtype=torch.bfloat16) -> dict:
    """{kernel: launches} that `_w8a16_plan` names for one call of each
    (M, K, N) in `shapes`: the count predicted from the code."""
    sms = w8._sm_count(torch.cuda.current_device())
    out: dict = {}
    for m, k, n in shapes:
        kernel = w8._w8a16_plan(m, k, n, dtype, True, sms).kernel
        out[kernel] = out.get(kernel, 0) + 1
    return out


def _bert_w8a16_shapes(cfg, bucket: int) -> list:
    """The int8 BERT's projections of one forward of `bucket` rows: q, k,
    v, o, ffn_in, ffn_out a layer over bucket x BERT_SEQ tokens, and the
    pooler over the [CLS] rows (the 2-label classifier stays float)."""
    m, h, i = bucket * BERT_SEQ, cfg.hidden_size, cfg.intermediate_size
    layer = [(m, h, h)] * 4 + [(m, h, i), (m, i, h)]
    return layer * cfg.num_layers + [(bucket, h, h)]


def _llama_w8a16_shapes(cfg, m: int) -> list:
    """The int8 Llama's projections of one forward of m tokens: seven a
    layer, then the head (an untied lm_head)."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = [(m, d, q), (m, d, kv), (m, d, kv), (m, q, d), (m, d, i),
             (m, d, i), (m, i, d)]
    return layer * cfg.num_layers + [(m, d, cfg.vocab_size)]


def _by_route(delta: tuple) -> dict:
    """(all, wgmma) launch deltas as {kernel: launches}."""
    return {k: v for k, v in ((w8.WGMMA, delta[1]),
                              ("not wgmma", delta[0] - delta[1])) if v}


def _bert_http(work: str, gates: dict) -> dict:
    """4k (i) and (ii): BERT-base written from the seed in HF names, served
    through --storage-uri; :predict at 1, 3, 32 and 40 rows, /infer, a
    padded row, a 16-request burst, occlusion :explain."""
    cfg = hf_mod.bert_config_from_hf(BERT_CONFIG)
    module = bert_mod.Bert(cfg, device=DEVICE).init_weights(SEED).eval()
    sd = module.state_dict()
    ckpt = os.path.join(work, "hf_bert_base")
    os.makedirs(ckpt, exist_ok=True)
    t0 = time.monotonic()
    nbytes = hf_mod.save_safetensors(
        {hf: sd[port] for port, hf in hf_mod.bert_hf_names(cfg).items()},
        os.path.join(ckpt, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(BERT_CONFIG, f)
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "seq_len": BERT_SEQ,
                   "batch_buckets": list(BERT_BUCKETS),
                   "explainer": {"method": "occlusion", "baseline_id": 0}},
                  f)
    write_s = time.monotonic() - t0
    ref = bert_mod.Bert(dataclasses.replace(cfg, dtype=torch.float32),
                        device=DEVICE)
    ref.load_state_dict(sd)
    n_params = sum(v.numel() for v in sd.values())
    del module, sd
    rng = np.random.default_rng(SEED + 23)
    rows = rng.integers(1, cfg.vocab_size, (40, BERT_SEQ))  # no pad ids
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    server, port = server_mod.start([
        "--storage-uri", f"file://{ckpt}", "--name", BERT_NAME, "--host",
        "127.0.0.1", "--port", "0", "--device", DEVICE])
    load_s = time.monotonic() - t0
    base = f"http://127.0.0.1:{port}"
    url = f"{base}/v1/models/{BERT_NAME}"
    try:
        served = server.models[BERT_NAME]
        module = served.apply_and_params()[1]

        def predict(x):
            return np.asarray(_post(url + ":predict", {
                "instances": x.tolist()})["predictions"], np.float32)

        predict(rows[:1])  # the batcher thread's first forward
        t0 = time.perf_counter()
        p1 = predict(rows[:1])
        ms1 = (time.perf_counter() - t0) * 1e3
        p3 = predict(rows[:3])
        predict(rows[:32])  # bucket 32's first use
        t0 = time.perf_counter()
        p32 = predict(rows[:32])
        ms32 = (time.perf_counter() - t0) * 1e3
        p40 = predict(rows)
        p8 = predict(rows[32:])
        v2 = _post(f"{base}/v2/models/{BERT_NAME}/infer", {"inputs": [{
            "name": "input_0", "shape": [3, BERT_SEQ], "datatype": "INT32",
            "data": rows[:3].ravel().tolist()}]})["outputs"][0]
        infer = np.asarray(v2["data"], np.float32).reshape(v2["shape"])
        ids = torch.from_numpy(rows[:32]).to(DEVICE)
        with torch.inference_mode():
            exact = ref(ids)[1].float().cpu()
        rel32 = _rel_l2(torch.from_numpy(p32), exact)
        padded = rows[0].copy()
        padded[BERT_PAD_LEN:] = BERT_CONFIG["pad_token_id"]
        p_pad = predict(padded[None])[0]
        with torch.inference_mode():
            cut = module(torch.from_numpy(padded[None, :BERT_PAD_LEN])
                         .to(DEVICE))[1][0].float().cpu().numpy()
        rel_pad = _rel_l2(torch.from_numpy(p_pad), torch.from_numpy(cut))
        # The burst: one-row requests at once, coalesced by the batcher;
        # the second of two is read (the first meets buckets unused yet).
        burst: list = [None] * BERT_BURST

        def one(i):
            burst[i] = predict(rows[i:i + 1])[0]

        for _ in range(2):
            before = served.stats["requests"]
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(BERT_BURST)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            burst_s = time.perf_counter() - t0
            calls = served.stats["requests"] - before
        solo = [served.predict([rows[i:i + 1]])[0][0]
                for i in range(BERT_BURST)]
        rel_burst = max(_rel_l2(torch.from_numpy(b), torch.from_numpy(s))
                        for b, s in zip(burst, solo))
        apart = min(_rel_l2(torch.from_numpy(a), torch.from_numpy(b))
                    for a, b in itertools.permutations(solo, 2))
        # (ii) occlusion: 129 variants a row through the buckets.
        t0 = time.perf_counter()
        ex = _post(url + ":explain", {"instances": rows[:EXPLAIN_ROWS]
                                      .tolist()})["explanations"]
        explain_s = time.perf_counter() - t0
        ex_err, ex_ok = 0.0, len(ex) == EXPLAIN_ROWS
        for row, got in zip(rows[:EXPLAIN_ROWS], ex):
            variants = np.tile(row, (BERT_SEQ + 1, 1))
            variants[np.arange(1, BERT_SEQ + 1), np.arange(BERT_SEQ)] = 0
            logits = served.predict([variants])[-1]
            t = int(np.argmax(logits[0]))
            want = logits[0, t] - logits[1:, t]
            ex_ok &= got["target"] == t and len(got["attributions"]) == \
                BERT_SEQ
            ex_err = max(ex_err, float(np.abs(
                np.asarray(got["attributions"]) - want).max()))
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
        del server
    del ref
    _free()
    gates.update({
        "i bf16 logits vs fp32": rel32 <= BERT_TOL,
        "i 1, 3, 32, 40 rows answered": (p1.shape, p3.shape, p32.shape,
                                         p40.shape) == (
            (1, 2), (3, 2), (32, 2), (40, 2)),
        "i 40 rows = 32 then 8": np.array_equal(p40, np.concatenate(
            [p32, p8])),
        "i /infer = :predict": np.array_equal(infer, p3),
        "i padded row = cut row": rel_pad <= BERT_PAD_TOL
        and int(p_pad.argmax()) == int(cut.argmax()),
        "i burst coalesced": calls < BERT_BURST,
        "i burst rows = alone": rel_burst <= BERT_BURST_TOL,
        "i distinct rows apart": apart > 10 * BERT_BURST_TOL,
        "ii occlusion = direct predict": ex_ok and ex_err <= 1e-6})
    log(f"  (i) {BERT_NAME}: {n_params} parameters, {nbytes} bytes written in {write_s:.2f}s, served "
        f"over --storage-uri in {load_s:.2f}s; logits of 32 rows vs fp32 "
        f"rel_l2 {rel32:.3e} (bound {BERT_TOL}); :predict ms over HTTP: "
        f"bucket 1 {ms1:.2f}, bucket 32 {ms32:.2f}; 40 rows "
        f"{'=' if gates['i 40 rows = 32 then 8'] else '!='} 32 + 8; "
        f"/infer {'=' if gates['i /infer = :predict'] else '!='} :predict; "
        f"a row padded from {BERT_PAD_LEN} tokens vs cut rel_l2 "
        f"{rel_pad:.3e} (bound {BERT_PAD_TOL}); {BERT_BURST} one-row "
        f"requests at once in {burst_s * 1e3:.1f} ms "
        f"({BERT_BURST / burst_s:.1f} examples/s) over {calls} model calls, "
        f"rows vs alone rel_l2 at most {rel_burst:.3e} (bound "
        f"{BERT_BURST_TOL}), distinct rows alone at least {apart:.3e} apart "
        f"(bound > {10 * BERT_BURST_TOL:g}); peak {peak / 2**30:.2f} GiB; "
        f"{smi()}")
    log(f"  (ii) occlusion :explain of {EXPLAIN_ROWS} rows x {BERT_SEQ + 1}"
        f" variants in {explain_s:.3f}s; attributions vs a direct predict "
        f"of the variants: max abs {ex_err:.3e}")
    return {"ckpt": ckpt, "cfg": cfg, "rows": rows, "p32": p32, "p1": p1,
            "ms1": ms1, "ms32": ms32, "burst_eps": BERT_BURST / burst_s,
            "explain_s": explain_s, "peak": peak, "rel_l2": rel32}



def _bert_int8(http: dict, gates: dict) -> dict:
    """4k (iii): the same checkpoint with quantize: int8 (loaded in
    process): its W8A16 launches a predict call by route against the plan's
    count, logits against the bf16 bundle's, weight bytes against bf16."""
    cfg, rows = http["cfg"], http["rows"]
    qdir = os.path.join(os.path.dirname(http["ckpt"]), "bert_base_int8")
    os.makedirs(qdir, exist_ok=True)
    with open(os.path.join(qdir, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "checkpoint": http["ckpt"],
                   "quantize": "int8", "seq_len": BERT_SEQ,
                   "batch_buckets": list(BERT_BUCKETS)}, f)
    model = runtimes.load_model(qdir, device=DEVICE)
    model.load()
    counts = {}
    for bucket, x in ((32, rows[:32]), (1, rows[:1])):
        before = _w8a16_counts()
        got = model.predict([x])[0]
        counts[bucket] = (_by_route(tuple(a - b for a, b in zip(
            _w8a16_counts(), before))),
            _w8a16_expect(_bert_w8a16_shapes(cfg, bucket)))
        if bucket == 32:
            q32 = got
    rel = _rel_l2(torch.from_numpy(q32), torch.from_numpy(http["p32"]))
    qb = model.quantization
    del model
    _free()

    def total(d):
        return sum(d.values())

    gates["iii W8A16 launches = the plan's"] = all(
        total(got) == total(want) and got.get(w8.WGMMA, 0) == want.get(
            w8.WGMMA, 0) for got, want in counts.values())
    gates["iii int8 logits vs bf16"] = rel <= BERT_INT8_TOL
    log("  (iii) int8 bundle: W8A16 launches a predict call " + "; ".join(
        f"bucket {b}: {got} (the plan: {want})"
        for b, (got, want) in counts.items())
        + f"; logits vs the bf16 bundle's rel_l2 {rel:.3e} (bound "
        f"{BERT_INT8_TOL}); weight bytes {qb['quantized']} int8 vs "
        f"{qb['full']} at bf16 ({qb['quantized'] / qb['full']:.3f}x)")
    return {"w8a16": total(counts[32][0]) + total(counts[1][0]),
            "w8a16_wgmma": sum(c[0].get(w8.WGMMA, 0)
                               for c in counts.values()),
            "rel_l2": rel, "bytes": qb}


def _mlp_ig(work: str, gates: dict) -> None:
    """4k (iv): mnist_mlp's registry bundle with the integrated-gradients
    explainer; completeness within IG_GAP of |f(x) - f(x0)|."""
    mdir = os.path.join(work, "mnist_mlp_ig")
    export_for_serving(mdir, model="mnist_mlp", seed=SEED, extra={
        "explainer": {"method": "integrated_gradients", "steps": IG_STEPS}})
    model = runtimes.load_model(mdir, device=DEVICE)
    model.load()
    x = np.random.default_rng(SEED + 37).random((4, 784)).astype(np.float32)
    t0 = time.perf_counter()
    out = model.explain(x)
    sec = time.perf_counter() - t0
    gaps = [abs(e["completeness_gap"]) / max(abs(
        e["target_logit"] - e["baseline_logit"]), 1e-12) for e in out]
    gates["iv IG completeness"] = max(gaps) <= IG_GAP
    log(f"  (iv) mnist_mlp, integrated gradients over {IG_STEPS} steps for "
        f"{len(out)} rows in {sec:.3f}s: completeness gap / |f(x) - f(x0)| "
        f"at most {max(gaps):.2e} (bound {IG_GAP})")


def _llama_fixed(work: str, floor_gates: dict) -> dict:
    """4k (v): llama_1b's registry bundle without a generative block, one
    bucket call of FIXED_1B_ROWS rows at its example width: B1 launches a
    call, the logits against the plain attention beside naive_attention's,
    then the int8 form through W8A16 against the same codes dequantized."""
    gates = floor_gates
    ldir = os.path.join(work, "llama_1b_fixed")
    export_for_serving(ldir, model="llama_1b", seed=SEED)
    model = runtimes.load_model(ldir, device=DEVICE)
    t0 = time.monotonic()
    model.load()
    load_s = time.monotonic() - t0
    cfg = model.apply_and_params()[1].cfg
    width = model.input_spec[0][0][0]
    ids = np.random.default_rng(SEED + 41).integers(
        0, cfg.vocab_size, (FIXED_1B_ROWS, width))
    before = _b1_split()
    t0 = time.perf_counter()
    logits = torch.from_numpy(model.predict([ids])[0])
    call_ms = (time.perf_counter() - t0) * 1e3
    b1 = _since(before)
    module = model.apply_and_params()[1]
    tokens = torch.from_numpy(ids).to(DEVICE)
    ref, nv = _plain_and_naive(module, tokens)
    rel, floor = _rel_l2(logits, ref), _rel_l2(nv, ref)
    del model, module
    _free()
    qdir = os.path.join(work, "llama_1b_fixed_int8")
    export_for_serving(qdir, model="llama_1b", seed=SEED,
                       extra={"quantize": "int8"})
    qmodel = runtimes.load_model(qdir, device=DEVICE)
    qmodel.load()
    before = _w8a16_counts()
    qlogits = torch.from_numpy(qmodel.predict([ids])[0])
    got = _by_route(tuple(a - b for a, b in zip(_w8a16_counts(), before)))
    want = _w8a16_expect(_llama_w8a16_shapes(cfg, ids.size))
    deq = _dequantized_copy(qmodel.apply_and_params()[1], cfg)
    with torch.inference_mode():
        dlogits = deq(tokens).float().cpu()
    qrel = _rel_l2(qlogits, dlogits)
    del qmodel, deq
    _free()
    layers = cfg.num_layers
    gates.update({
        "v B1 launches a bucket call, all wgmma": b1 == (layers, 0, 0),
        "v logits vs plain attention": rel <= LOGITS_VS_NAIVE * floor,
        "v int8 W8A16 launches = the plan's": sum(got.values()) == sum(
            want.values()) and got.get(w8.WGMMA, 0) == want.get(w8.WGMMA, 0),
        "v int8 logits vs the codes dequantized":
            qrel <= QUANT_LOGITS_REL_L2_MAX})
    log(f"  (v) llama_1b registry bundle (no generative block): loaded "
        f"with warm buckets in {load_s:.2f}s; one bucket-{FIXED_1B_ROWS} "
        f"call of {width} tokens in {call_ms:.2f} ms; B1 (flash_fwd.cu, "
        f"flash_simt.cu, of which mma) {b1} (expected ({layers}, 0, 0)); "
        f"logits vs plain attention rel_l2 {rel:.3e}, naive_attention "
        f"{floor:.3e} (bound {LOGITS_VS_NAIVE} x naive); int8: W8A16 "
        f"{got} (the plan: {want}), logits vs the same codes dequantized "
        f"rel_l2 {qrel:.3e} (bound {QUANT_LOGITS_REL_L2_MAX})")
    return {"b1": sum(b1), "w8a16": sum(got.values()),
            "w8a16_wgmma": got.get(w8.WGMMA, 0)}


def _lora_int8(gates: dict) -> dict:
    """4k (vi): rank-16 attn_mlp adapters of a config's own on int8
    projections at llama_1b's widths, LORA_INT8_LAYERS layers: the logits
    against the adapted function in fp32, bounded by 1.25 x the int8 base's
    distance from the base's fp32 function (the adapters cost no more than
    the int8 weights do), and the adapters must matter."""
    cfg = registry.model_config("llama_1b", num_layers=LORA_INT8_LAYERS,
                                lora_rank=LORA["rank"],
                                lora_alpha=LORA["alpha"],
                                lora_targets=LORA["targets"])
    model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 43)
    bs = [p for n, p in model.named_parameters() if n.endswith("_lora_b")]
    with torch.no_grad():
        for p in bs:
            p.normal_(0.0, 0.02, generator=gen)
    saved = [p.detach().clone() for p in bs]
    tokens = torch.from_numpy(np.random.default_rng(SEED + 47).integers(
        0, cfg.vocab_size, (1, LORA_INT8_PROMPT))).to(DEVICE)

    def run(zero_b: bool):
        with torch.inference_mode():
            for p, b in zip(bs, saved):
                p.copy_(torch.zeros_like(b) if zero_b else b)
            return model(tokens).float()

    _set_compute_dtype(model, torch.float32)
    exact, exact_base = run(False), run(True)
    _set_compute_dtype(model, cfg.dtype)
    squant.quantize_model(model)
    before = _w8a16_counts()
    got = run(False)
    launches = _by_route(tuple(a - b for a, b in zip(_w8a16_counts(),
                                                     before)))
    got_base = run(True)
    want = _w8a16_expect(_llama_w8a16_shapes(cfg, LORA_INT8_PROMPT))
    rel, floor = _rel_l2(got, exact), _rel_l2(got_base, exact_base)
    moved = _rel_l2(exact, exact_base)
    del model, exact, exact_base, got, got_base
    _free()
    gates.update({
        "vi int8 + LoRA vs the fp32 adapted function":
            rel <= LOGITS_VS_NAIVE * floor,
        "vi the adapters matter": moved > floor,
        "vi W8A16 launches = the plan's": sum(launches.values()) == sum(
            want.values())})
    log(f"  (vi) llama_1b widths at {LORA_INT8_LAYERS} layers, rank "
        f"{LORA['rank']} {LORA['targets']} adapters on int8 projections, a "
        f"{LORA_INT8_PROMPT}-token prompt: logits vs the adapted function in "
        f"fp32 rel_l2 {rel:.3e}, the int8 base vs the base's fp32 function "
        f"{floor:.3e} (bound {LOGITS_VS_NAIVE} x that); the adapters move "
        f"the fp32 logits by {moved:.3e}; W8A16 {launches} (the plan: "
        f"{want})")
    return {"w8a16": sum(launches.values()),
            "w8a16_wgmma": launches.get(w8.WGMMA, 0)}


def phase_fixed(work: str, flat: dict) -> dict:
    """4k: fixed-forward serving. (i) BERT-base over HTTP: :predict, /infer,
    a padded row, a coalesced burst; (ii) occlusion :explain; (iii) the
    int8 BERT bundle; (iv) integrated gradients on mnist_mlp; (v) llama_1b's
    fixed-forward registry bundle and its int8 form; (vi) a config's own
    LoRA on int8 projections; (vii) ran in phase 4 (:predict and /infer on
    the llama3_8b server), its numbers carried here."""
    t_phase = time.monotonic()
    gates: dict = {}
    http = _bert_http(work, gates)
    bert8 = _bert_int8(http, gates)
    _mlp_ig(work, gates)
    fixed = _llama_fixed(work, gates)
    lora8 = _lora_int8(gates)
    vii = flat["predict"]
    log(f"  4k readings: BERT-base :predict bucket 1 {http['ms1']:.2f} ms, "
        f"bucket 32 {http['ms32']:.2f} ms over HTTP; the {BERT_BURST}-request "
        f"burst {http['burst_eps']:.1f} examples/s; occlusion :explain of "
        f"{EXPLAIN_ROWS} rows {http['explain_s']:.3f}s; peak "
        f"{http['peak'] / 2**30:.2f} GiB; (vii) llama3_8b :predict "
        f"{vii['predict_s']:.2f}s; 4k took {time.monotonic() - t_phase:.1f}s"
        f"; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"4k gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"b1": {"fixed_forward_1b": fixed["b1"],
                   "generative_predict": vii["launches"]},
            "w8a16": {"bert_int8": (bert8["w8a16"], bert8["w8a16_wgmma"]),
                      "fixed_forward_1b_int8": (fixed["w8a16"],
                                                fixed["w8a16_wgmma"]),
                      "lora_int8": (lora8["w8a16"], lora8["w8a16_wgmma"])}}


def _one_hot_dispatch(experts, slot, keep, e: int, c: int):
    """The serving path's assignment as the plain route's dispatch tensor
    [B, S, E, C] (a scatter on the card)."""
    b, s = experts.shape[:2]
    out = torch.zeros(b, s, e, c + 1, device=experts.device)
    where = torch.where(keep, experts * (c + 1) + slot, e * (c + 1) - 1)
    out.view(b, s, -1).scatter_(2, where, 1.0)
    return out[..., :c]


def _moe_fp32_block(model, cfg) -> dict:
    """4l (i): layer 0's routed block in fp32 (a copy of its weights) on
    the normed embeddings of a MIXTRAL_FP32_PROMPT-token prompt: the serving
    path's choices and slots as a dispatch tensor against the plain route's
    (equal), its output against `forward_plain`'s (rel-L2). At `cfg`'s
    capacity factor and at MOE_DROP_CAPACITY, where choices must drop."""
    return {cf: _moe_fp32_at(model, dataclasses.replace(
        cfg, dtype=torch.float32, capacity_factor=cf))
        for cf in (cfg.capacity_factor, MOE_DROP_CAPACITY)}


def _moe_fp32_at(model, cfg) -> dict:
    blk = moe_mod.MoEBlock(cfg, device=DEVICE)
    blk.load_state_dict({k: v.float()
                         for k, v in model.layers[0].mlp.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(SEED + 60).integers(
        0, cfg.vocab_size, (1, MIXTRAL_FP32_PROMPT))).to(DEVICE)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    with torch.inference_mode():
        x = model.layers[0].post_attn_norm(model.embed[toks]).float()
        c = moe_mod.expert_capacity(cfg, x.shape[1])
        experts, _, slot, keep = moe_mod.route(
            x, blk.router, cfg.experts_per_token, c, cfg.norm_topk_prob)
        dispatch, _, _ = moe_mod.gshard_route(
            x, blk.router, cfg.experts_per_token, c, cfg.norm_topk_prob)
        same = bool(torch.equal(_one_hot_dispatch(
            experts, slot, keep, cfg.num_experts, c), dispatch))
        rel = _rel_l2(blk(x), blk.forward_plain(x))
        dropped = int((~keep).sum())
    del blk, dispatch
    _free()
    return {"same": same, "rel": rel, "dropped": dropped,
            "choices": experts.numel(), "capacity": c, "tf32": tf32}


def _mixtral_bf16(gates: dict) -> dict:
    """4l (i): Mixtral-8x7B's widths at MIXTRAL_BF16_LAYERS layers in bf16
    (see the constants)."""
    t0 = time.monotonic()
    cfg = registry.model_config("mixtral_8x7b",
                                num_layers=MIXTRAL_BF16_LAYERS)
    gates["config: mixtral_8x7b = Mixtral-8x7B-v0.1"] = (
        registry.model_config("mixtral_8x7b").num_params == MIXTRAL_PARAMS
        and (cfg.num_experts, cfg.experts_per_token, cfg.capacity_factor)
        == (8, 2, 1.25))
    model = moe_mod.MoELlama(cfg, device=DEVICE).init_weights(SEED).eval()
    build_s = time.monotonic() - t0
    fp32s = _moe_fp32_block(model, cfg)
    log(f"  (i) mixtral_8x7b at {cfg.num_layers} layers, bf16 "
        f"({cfg.num_params} parameters) built in {build_s:.1f}s")
    for cf, fp32 in fp32s.items():
        gates[f"i fp32 at capacity {cf}: choices = the plain route's"] = (
            fp32["same"] and not fp32["tf32"])
        gates[f"i fp32 at capacity {cf}: output vs the plain route"] = (
            fp32["rel"] <= MOE_FP32_TOL)
        log(f"    (i) layer 0's block in fp32 on {MIXTRAL_FP32_PROMPT} "
            f"tokens at capacity factor {cf} ({fp32['capacity']} slots, "
            f"{fp32['dropped']} of {fp32['choices']} choices dropped): "
            f"dispatch {'equal to' if fp32['same'] else 'DIFFERS from'} the "
            f"plain route's, output rel_l2 {fp32['rel']:.3e} (bound "
            f"{MOE_FP32_TOL}); TF32 {'on' if fp32['tf32'] else 'off'}")
    gates[f"i fp32 at capacity {MOE_DROP_CAPACITY}: choices dropped"] = (
        fp32s[MOE_DROP_CAPACITY]["dropped"] > 0)
    fp32 = fp32s[cfg.capacity_factor]
    bodies = _spec_bodies(cfg.vocab_size, MOE_PROMPT_LENS, SEED + 61,
                          max_tokens=MOE_MAX_TOKENS)
    runs, b1 = {}, 0
    for paged in (False, True):
        for depth in (1, 2):
            kw = dict(MOE_GEN, pipeline_depth=depth)
            if paged:
                kw["kv_block_size"] = KV_BLOCK_SIZE
            eng = GenerationEngine(model, **kw)
            b0 = _b1_split()
            torch.cuda.reset_peak_memory_stats()
            ids, st = _engine_burst(eng, bodies)
            peak = torch.cuda.max_memory_allocated()
            wgmma, simt, _ = _since(b0)
            b1 += wgmma + simt
            name = f"{'paged' if paged else 'flat'} depth {depth}"
            runs[name] = ids
            gates[f"i {name}: B1 = {cfg.num_layers} a first chunk"] = (
                wgmma == cfg.num_layers * st["requests"] and simt == 0
                and st["prefill_chunks"] == st["requests"])
            if name == "flat depth 2":
                pos = [n + MOE_MAX_TOKENS for n in MOE_PROMPT_LENS]
                wall, _ = _chunk_walls(_decode_call(eng, pos))
                prof = _profile("4l (i) one decode chunk (bf16, "
                                f"{cfg.num_layers} layers)",
                                _decode_call(eng, pos))
                step = {"ms": wall / CHUNK, "peak_gib": peak / 2**30,
                        "device_ms": (prof["busy_ms"] / CHUNK if prof
                                      else None)}
            _close(eng)
    first = runs["flat depth 1"]
    gates["i ids: flat = paged at depth 1 and 2"] = all(
        ids == first for ids in runs.values())
    log(f"  (i) prompts {MOE_PROMPT_LENS} at once, {MOE_MAX_TOKENS} greedy "
        f"ids each, flat and paged at depth 1 and 2: ids "
        f"{'equal' if gates['i ids: flat = paged at depth 1 and 2'] else 'DIFFER'}"
        f" ({ {k: v == first for k, v in runs.items()} }); B1 launches "
        f"{b1}; peak {step['peak_gib']:.2f} GiB; a 4-row decode step "
        f"{step['ms']:.2f} ms of wall (median of {ROLLING_WALL_REPS} chunks)"
        + (f", {step['device_ms']:.2f} ms of device time"
           if step["device_ms"] is not None else "")
        + f"; (i) took {time.monotonic() - t0:.1f}s; {smi()}")
    del model
    _free()
    return {"b1": b1, "step": step, "fp32_rel": fp32["rel"]}


def _int8_expert_check(mlp, cfg, gk) -> dict:
    """4l (ii): layer 0's int8 routed block (the W8A16 kernels, one launch
    per expert and projection) at a 4-row decode shape and a
    MIXTRAL_FP32_PROMPT-token prefill, against the same block through the
    op's plain version, and against a bf16 block holding the same codes
    dequantized (JAX QuantizedModule's arithmetic)."""
    deq = moe_mod.MoEBlock(dataclasses.replace(cfg, quantized_dense=False),
                           device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 62)
    out = {}
    real = squant.int8_weight_matmul
    with torch.inference_mode():
        deq.router.copy_(mlp.router)
        for name in ("w_gate", "w_up", "w_down"):
            codes = getattr(mlp, name)
            for e in range(cfg.num_experts):
                getattr(deq, name)[e] = (codes.q[e].float() * codes.scale[
                    e, :, None]).t().to(cfg.dtype)
        for shape in ((4, 1), (1, MIXTRAL_FP32_PROMPT)):
            x = torch.randn(*shape, cfg.hidden_size, generator=gen,
                            device=DEVICE).to(cfg.dtype)
            w0 = _w8a16_counts()
            got = mlp(x)
            torch.cuda.synchronize()
            launches = tuple(a - b for a, b in zip(_w8a16_counts(), w0))
            squant.int8_weight_matmul = (
                lambda x, q, scale, **kw: w8._int8_weight_matmul_plain(
                    x, q, scale, kw.get("round_before_scale", False)))
            try:
                plain = mlp(x)
            finally:
                squant.int8_weight_matmul = real
            out[shape] = {"launches": launches,
                          "vs_plain": _rel_l2(got.float(), plain.float()),
                          "vs_dequant": _rel_l2(got.float(),
                                                deq(x).float())}
    del deq
    _free()
    return out


def _one_step(engine, positions: list):
    """A call of one decode step (the model's forward, no sampling) of
    the idle flat engine's rows at `positions`, on its cache cut to the
    bucket the engine would pick: what a decode step launches."""
    n = engine.n_slots
    tok = torch.ones(n, 1, dtype=torch.long, device=DEVICE)
    idx = torch.tensor(positions, dtype=torch.int32, device=DEVICE)
    bucket = next((b for b in engine.decode_buckets
                   if b >= max(positions) + 1), engine.decode_buckets[-1])
    cache = {k: v[:, :, :bucket] for k, v in engine._cache.items()}

    def call():
        with torch.inference_mode():
            engine.model(tok, cache=cache, cache_index=idx)
    return call


def _mixtral_int8(work: str, gk, gates: dict) -> dict:
    """4l (ii): mixtral_8x7b whole in int8 over HTTP (see the
    constants)."""
    t0 = time.monotonic()
    bundle = os.path.join(work, "mixtral_int8")
    export_for_serving(bundle, model="mixtral_8x7b", seed=SEED, extra={
        "quantize": "int8", "generative": MOE_GEN})
    _free()
    torch.cuda.reset_peak_memory_stats()
    server = ModelServer()
    server.load(bundle, name=MOE_NAME, device=DEVICE)
    load_s = time.monotonic() - t0
    load_peak = torch.cuda.max_memory_allocated()
    port = server.start_background(0)
    url = f"http://127.0.0.1:{port}/v1/models/{MOE_NAME}:generate"
    served = server.models[MOE_NAME]
    model, cfg = served.engine.model, served.engine.model.cfg
    qbytes = squant.quantized_bytes(model)
    bodies = _spec_bodies(cfg.vocab_size, MOE_PROMPT_LENS, SEED + 63,
                          max_tokens=MOE_MAX_TOKENS)
    # Two decode chunks for the first request: the second is dispatched
    # while the first is in flight (depth 2's overlap).
    bodies[0]["max_tokens"] = 2 * CHUNK
    try:
        th = time.monotonic()
        b0, w0 = _b1_split(), _w8a16_counts()
        torch.cuda.reset_peak_memory_stats()
        res = _burst(lambda b: _post(url, b), bodies)
        stream = _stream(url, dict(bodies[1], stream=True))
        peak = torch.cuda.max_memory_allocated()
        http_s = time.monotonic() - th
        wgmma, simt, _ = _since(b0)
        w8_http = tuple(a - b for a, b in zip(_w8a16_counts(), w0))
        st = served.engine.stats_snapshot()
        eng = served.engine
        pos = [n + MOE_MAX_TOKENS for n in MOE_PROMPT_LENS]
        chunk = _decode_call(eng, pos)
        w1 = _w8a16_counts()
        torch.cuda.synchronize()
        tw = time.perf_counter()
        with torch.inference_mode():
            chunk()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tw) * 1e3
        per_step = tuple((a - b) / CHUNK
                         for a, b in zip(_w8a16_counts(), w1))
        prof = _profile("4l (ii) one decode step's forward (int8, 32 "
                        "layers)", _one_step(eng, pos))
        experts = _int8_expert_check(model.layers[0].mlp, cfg, gk)
    finally:
        server.stop()
        del server, served, model
        _free()
    frames = stream["frames"]
    streamed = [t for f in frames[:-1] for t in f.get("tokens", [])]
    ids = [r["output_ids"] for r in res]
    expect_step = cfg.num_layers * (4 + 3 * cfg.num_experts) + 1
    shapes = _mixtral_step_shapes(cfg, 1)
    code_bytes = sum(n * k for _, k, n in shapes)
    bound_ms = (code_bytes + 4 * sum(n for _, _, n in shapes)) / (
        PEAK_BYTES) * 1e3
    step = {"ms": wall / CHUNK,
            "device_ms": prof["busy_ms"] if prof else None,
            "forward_wall_ms": prof["wall_ms"] if prof else None,
            "engine_ms": _step_ms(st), "bound_ms": bound_ms,
            "w8a16_per_step": per_step[0], "wgmma_per_step": per_step[1]}
    gates["ii config: 32 layers, 46.7B parameters, int8"] = (
        cfg.num_layers == 32 and cfg.num_params == MIXTRAL_PARAMS
        and cfg.quantized_dense)
    gates["ii :generate ids in range, as many as asked"] = all(
        len(i) == b["max_tokens"]
        and all(0 <= t < cfg.vocab_size for t in i)
        for i, b in zip(ids, bodies))
    gates["ii stream = its :generate"] = (
        stream["status"] == 200 and frames[-1].get("done") is True
        and streamed == ids[1] == frames[-1]["output_ids"])
    gates["ii B1 = 32 a first chunk"] = (
        wgmma == cfg.num_layers * st["requests"] and simt == 0)
    gates[f"ii W8A16 = {expect_step} a decode step, all decode kernel"] = (
        per_step == (expect_step, 0))
    gates["ii depth 2 overlapped"] = st["decode_fetch_overlapped"] > 0
    for shape, r in experts.items():
        gates[f"ii layer 0 experts {shape}: kernels vs plain op"] = (
            r["vs_plain"] <= gk.W8A16_TOL[torch.bfloat16]
            and r["launches"][0] == 3 * cfg.num_experts)
        gates[f"ii layer 0 experts {shape}: vs dequantized bf16"] = (
            r["vs_dequant"] <= MOE_DEQUANT_TOL)
    log(f"  (ii) mixtral_8x7b whole, int8, built part by part and loaded in "
        f"{load_s:.1f}s (peak {load_peak / 2**30:.2f} GiB): weight bytes "
        f"{qbytes['quantized']} ({qbytes['quantized'] / qbytes['full']:.3f}"
        f" of bf16's {qbytes['full']}); prompts {MOE_PROMPT_LENS} at once "
        f"over :generate ({[b['max_tokens'] for b in bodies]} ids) and the "
        f"{MOE_PROMPT_LENS[1]}-token one again streamed ({len(frames)} "
        f"frames, first at {stream['first_s']:.3f}s) in {http_s:.1f}s; "
        f"{st['prefill_chunks']} prefill chunks, B1 wgmma {wgmma} "
        f"(expected {cfg.num_layers} x {st['requests']}), CUDA-core {simt};"
        f" W8A16 over HTTP {w8_http[0]}, of them wgmma {w8_http[1]}; "
        f"{st['decode_fetch_overlapped']} fetches overlapped; peak "
        f"{peak / 2**30:.2f} GiB; {smi()}")
    log(f"    (ii) a 4-row decode step: W8A16 launches {per_step[0]:.1f} "
        f"(expected {expect_step}: 4 attention + 3 x {cfg.num_experts} "
        f"experts a layer, the head), wgmma {per_step[1]:.1f}; wall "
        f"{step['ms']:.2f} ms (one chunk of {CHUNK}, device drained; the "
        f"engine's host-inclusive {step['engine_ms']:.2f} over HTTP)"
        + (f"; one step's forward profiled: device {prof['busy_ms']:.2f} ms"
           if prof else "")
        + f"; bound {bound_ms:.2f} ms ({code_bytes} bytes of codes and "
        f"their scales over {PEAK_BYTES / 1e12} TB/s)")
    for shape, r in experts.items():
        log(f"    (ii) layer 0's experts at x {list(shape)} x "
            f"{cfg.hidden_size}: W8A16 launches {r['launches'][0]} (wgmma "
            f"{r['launches'][1]}); rel_l2 vs the op's plain version "
            f"{r['vs_plain']:.3e} (bound {gk.W8A16_TOL[torch.bfloat16]}), "
            f"vs the codes dequantized to bf16 {r['vs_dequant']:.3e} (bound "
            f"{MOE_DEQUANT_TOL})")
    log(f"    (ii) took {time.monotonic() - t0:.1f}s")
    return {"b1": wgmma + simt, "w8a16": w8_http, "step": step,
            "peak_gib": peak / 2**30, "bytes": qbytes, "load_s": load_s}


def _mixtral_step_shapes(cfg, m: int) -> list:
    """(M, K, N) of every W8A16 launch of an int8 Mixtral decode step of m
    rows (C 1: each expert's buffer holds m rows): q/k/v/o, then gate, up
    and down of each expert, a layer; then the head."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = ([(m, d, q), (m, d, kv), (m, d, kv), (m, q, d)]
             + [(m, d, i), (m, d, i), (m, i, d)] * cfg.num_experts)
    return layer * cfg.num_layers + [(m, d, cfg.vocab_size)]


def _qwen_moe(work: str, gates: dict) -> dict:
    """4l (iii): Qwen1.5-MoE-A2.7B's widths at QWEN_MOE_LAYERS layers over
    --storage-uri in bf16 (see the constants)."""
    t0 = time.monotonic()
    full = hf_mod.config_from_hf(QWEN_MOE_CONFIG)
    hf = dict(QWEN_MOE_CONFIG, num_hidden_layers=QWEN_MOE_LAYERS)
    cfg = hf_mod.config_from_hf(hf)
    gates["iii config: Qwen1.5-MoE-A2.7B's widths, dropless"] = (
        (full.num_params, full.active_params)
        == (QWEN_MOE_PARAMS, QWEN_MOE_ACTIVE)
        and (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
             cfg.intermediate_size, cfg.shared_expert_size, cfg.num_experts,
             cfg.experts_per_token, cfg.norm_topk_prob, cfg.attention_bias,
             cfg.vocab_size, cfg.tie_embeddings, cfg.capacity_factor)
        == (2048, 16, 16, 128, 1408, 5632, 60, 4, False, True, 151936,
            False, 15.0))
    model = moe_mod.MoELlama(cfg, device=DEVICE).init_weights(SEED).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 64)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, GEMMA_DRAW_STD, generator=gen)
    ckpt = os.path.join(work, "hf_qwen_moe")
    os.makedirs(ckpt, exist_ok=True)
    tw = time.monotonic()
    tensors = hf_mod.hf_tensors(model.state_dict(), cfg, "qwen2_moe")
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    hf_mod.save_safetensors({k: v.cpu() for k, v in tensors.items()},
                            os.path.join(ckpt, "model.safetensors"))
    del tensors
    write_s = time.monotonic() - tw
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(hf, f)
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "generative": MOE_GEN}, f)
    bodies = _spec_bodies(cfg.vocab_size, QWEN_MOE_PROMPT_LENS, SEED + 65,
                          max_tokens=MOE_MAX_TOKENS)
    ts = time.monotonic()
    server, port = server_mod.start([
        "--storage-uri", f"file://{ckpt}", "--name", QWEN_MOE_NAME,
        "--host", "127.0.0.1", "--port", "0", "--device", DEVICE])
    serve_s = time.monotonic() - ts
    try:
        b0 = _b1_split()
        ids = [r["output_ids"] for r in _burst(lambda b: _post(
            f"http://127.0.0.1:{port}/v1/models/{QWEN_MOE_NAME}:generate",
            b), bodies)]
        wgmma, simt, _ = _since(b0)
        st = server.models[QWEN_MOE_NAME].engine.stats_snapshot()
        loaded = server.models[QWEN_MOE_NAME].engine.model
        is_moe = isinstance(loaded.layers[0].mlp, moe_mod.MoEBlock)
    finally:
        server.stop()
        del server
        _free()
    eng = GenerationEngine(model, **MOE_GEN)
    want, _ = _engine_burst(eng, bodies)
    logits: list = []
    with _first_logits(eng.model, logits):
        eng.submit(bodies[1]["input_ids"], max_tokens=1, timeout=600)
    _close(eng)
    ref = moe_mod.MoELlama(dataclasses.replace(cfg, dtype=torch.float32),
                           device=DEVICE)
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        hidden = ref(torch.tensor([bodies[1]["input_ids"]], device=DEVICE),
                     return_hidden=True)
        want_logits = ref.unembed(hidden[0, -1]).float()
    rel = _rel_l2(logits[0], want_logits)
    del ref, hidden, model
    _free()
    gates["iii served as MoE, ids = the engine's"] = is_moe and ids == want
    gates["iii B1 = 2 a first chunk"] = (
        wgmma == cfg.num_layers * st["requests"] and simt == 0)
    gates["iii first-token logits vs the fp32 function"] = (
        rel <= LOGITS_REL_L2_MAX)
    log(f"  (iii) Qwen1.5-MoE-A2.7B's config.json ({full.num_params} "
        f"parameters, {full.active_params} active) at {cfg.num_layers} "
        f"layers: {nbytes} bytes written in {write_s:.2f}s, serving "
        f"{serve_s:.1f}s after --storage-uri; prompts {QWEN_MOE_PROMPT_LENS}"
        f" at once over HTTP, ids {'equal' if ids == want else 'DIFFER from'}"
        f" the engine's; B1 wgmma {wgmma} (expected {cfg.num_layers} x "
        f"{st['requests']}), CUDA-core {simt}; the "
        f"{QWEN_MOE_PROMPT_LENS[1]}-token prompt's first-token logits "
        f"rel_l2 {rel:.3e} from the fp32 function (bound "
        f"{LOGITS_REL_L2_MAX}); (iii) took {time.monotonic() - t0:.1f}s")
    return {"b1": wgmma + simt, "rel_l2": rel}


def phase_moe(work: str, gk) -> dict:
    """4l: the mixture-of-experts family: (i) Mixtral-8x7B's widths at 4
    layers in bf16, (ii) mixtral_8x7b whole in int8 over HTTP, (iii)
    Qwen1.5-MoE-A2.7B's widths over --storage-uri (see the constants)."""
    t_phase = time.monotonic()
    _free()
    gates: dict = {}
    bf16 = _mixtral_bf16(gates)
    int8 = _mixtral_int8(work, gk, gates)
    qwen = _qwen_moe(work, gates)
    log(f"  4l took {time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"MoE gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"fwd_launches": {"mixtral_bf16_serving": bf16["b1"],
                             "mixtral_int8_serving": int8["b1"],
                             "qwen15_moe_serving": qwen["b1"]},
            "w8a16_launches": int8["w8a16"], "bf16": bf16, "int8": int8,
            "qwen": qwen}


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _dequantized_fixed(qmodel, fmodel):
    """`fmodel` (a float model of `qmodel`'s layout, its storage dtype the
    target) with each of `qmodel`'s int8 leaves' codes times scales
    written in its place: the same codes, dequantized, as JAX's
    QuantizedModule feeds its float matmuls."""
    with torch.no_grad():
        for name, mod in qmodel.named_modules():
            if isinstance(mod, squant.Int8Dense):
                w = mod.q.float() * mod.scale[:, None]
            elif isinstance(mod, squant.Int8Table):
                w = mod.q.float() * mod.scale[None, :]
            else:
                continue
            parent, _, leaf = name.rpartition(".")
            target = getattr(fmodel.get_submodule(parent), leaf)
            (target.weight if isinstance(target, torch.nn.Linear)
             else target).copy_(w)
    return fmodel


def _gpt2_w8a16_shapes(cfg, m: int, head_rows: int) -> list:
    """The int8 GPT-2's W8A16 calls of one forward of m tokens: q, k, v, o,
    fc and proj a layer, then the tied head over `head_rows` rows (the
    engine unembeds only a prompt's last row)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    layer = [(m, h, h)] * 4 + [(m, h, i), (m, i, h)]
    return layer * cfg.num_layers + [(head_rows, h, cfg.vocab_size)]


def _t5_w8a16_shapes(cfg, s: int, steps: int) -> list:
    """The int8 T5's W8A16 calls of one greedy request over an s-token
    bucket: the encoder's q, k, v, o and FFN a layer at s rows, each
    decoder layer's cross K and V at s rows, then `steps` decoder steps of
    one row (self q, k, v, o, cross q and o, the FFN a layer, the head)."""
    d, inner, f = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    ffn = ([(d, f), (d, f), (f, d)] if cfg.gated else [(d, f), (f, d)])
    enc = ([(s, d, inner)] * 3 + [(s, inner, d)]
           + [(s, k, n) for k, n in ffn]) * cfg.num_layers
    cross = [(s, d, inner)] * 2 * cfg.num_decoder_layers
    step = (([(1, d, inner)] * 3 + [(1, inner, d)] + [(1, d, inner),
             (1, inner, d)] + [(1, k, n) for k, n in ffn])
            * cfg.num_decoder_layers + [(1, d, cfg.vocab_size)])
    return enc + cross + step * steps


def _w8a16_at(gk, shapes) -> list:
    """The W8A16 op at GPT-2's and T5's decode shapes (the unembedding's
    epilogue where `rf`) against its plain version in 2f's way (two
    launches bit-identical, rel-L2 within the GPU tests' bound), and
    timed as 2f times decode rows: after a PyTorch kernel, the weight
    rotating past the L2; its plan, bound and torch.mm's time on a
    pre-cast weight. These calls are checks, not a path's."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 77)
    sms = w8._sm_count(dev.index or 0)
    rows = []
    for m, k, n, rf in shapes:
        x, q, scale = gk.w8a16_inputs(m, k, n, torch.bfloat16, gen, dev)
        plan = w8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
        err = gk.w8a16_check(x, q, scale, rf)
        nbytes = m * k * 2 + n * k + 4 * n + m * n * 2
        bound, bound_by = _bound(2 * m * n * k, nbytes)
        copies = [q] + [q.clone() for _ in range(
            max(0, math.ceil(W8A16_COLD_BYTES / (n * k)) - 1))]
        ms = launch_ms(_rotating(lambda w: w8.int8_weight_matmul(
            x, w, scale, round_before_scale=rf), copies))
        del copies
        plain_ms = time_ms(lambda: w8._int8_weight_matmul_plain(
            x, q, scale, rf), reps=3)
        wides = [q.to(torch.bfloat16)]
        wides += [wides[0].clone() for _ in range(max(0, math.ceil(
            W8A16_COLD_BYTES / (n * k * 2)) - 1))]
        library_ms = launch_ms(_rotating(lambda w: (torch.mm(
            x, w.t(), out_dtype=torch.float32) * scale).to(torch.bfloat16),
            wides))
        del wides
        row = {"shape": f"M{m} K{k} N{n}", "unembed": rf,
               "kernel": plan.kernel, "splits": plan.splits,
               "grid": plan.grid[0], "rel_l2": err["rel_l2"],
               "max_abs": err["max_abs"], "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound,
               "bound_by": bound_by}
        rows.append(row)
        log(f"    W8A16 M{m} K{k} N{n}{' (unembedding epilogue)' if rf else ''}"
            f": {plan.kernel} kernel (splits {plan.splits}, grid "
            f"{plan.grid[0]}), rel_l2 {err['rel_l2']:.2e} (bound "
            f"{gk.W8A16_TOL[torch.bfloat16]}), two launches bit-identical; "
            f"ms {ms:.4f} ({bound / ms:.1%} of bound) plain_ms "
            f"{plain_ms:.4f} library_ms (torch.mm, pre-cast weight) "
            f"{library_ms:.4f} bound_ms {bound:.4f} ({bound_by})")
        del x, q, scale
    torch.cuda.empty_cache()
    return rows


def _serve_ckpt(ckpt: str, name: str, bodies: list, burst: bool) -> tuple:
    """Serve the huggingface bundle `ckpt` over --storage-uri and POST
    `bodies` to :generate (at once, or one after another, each timed):
    (responses, seconds to serve, [ms a request], the served model)."""
    ts = time.monotonic()
    server, port = server_mod.start([
        "--storage-uri", f"file://{ckpt}", "--name", name,
        "--host", "127.0.0.1", "--port", "0", "--device", DEVICE])
    serve_s = time.monotonic() - ts
    url = f"http://127.0.0.1:{port}/v1/models/{name}:generate"
    try:
        walls = []
        if burst:
            out = _burst(lambda b: _post(url, b), bodies)
        else:
            out = []
            for b in bodies:
                t0 = time.perf_counter()
                out.append(_post(url, b))
                walls.append((time.perf_counter() - t0) * 1e3)
        served = type(server.models[name]).__name__
    finally:
        server.stop()
        del server
        _free()
    return out, serve_s, walls, served


def _gpt2(work: str, gk, gates: dict) -> dict:
    """4m (i): GPT-2-small at full depth (see the constants)."""
    t0 = time.monotonic()
    cfg = hf_mod.config_from_hf(GPT2_CONFIG, dtype="float32")
    gates["i config: GPT-2-small's widths"] = (
        isinstance(cfg, gpt2_mod.GPT2Config)
        and (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
             cfg.intermediate_size, cfg.max_seq_len)
        == (50257, 768, 12, 12, 3072, 1024))
    model = gpt2_mod.GPT2(cfg, device=DEVICE).init_weights(SEED).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 70)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, GEMMA_DRAW_STD, generator=gen)
    sd = model.state_dict()
    ckpt = os.path.join(work, "hf_gpt2")
    os.makedirs(ckpt, exist_ok=True)
    tw = time.monotonic()
    tensors = {k: v.cpu() for k, v in hf_mod.gpt2_hf_tensors(sd, cfg).items()}
    nbytes = hf_mod.save_safetensors(tensors,
                                     os.path.join(ckpt, "model.safetensors"))
    del tensors
    write_s = time.monotonic() - tw
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(GPT2_CONFIG, f)
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "generative": GPT2_GEN,
                   "model_overrides": {"dtype": "float32"}}, f)
    bodies = _spec_bodies(cfg.vocab_size, GPT2_PROMPT_LENS, SEED + 71)
    torch.cuda.reset_peak_memory_stats()
    laps = [time.monotonic()]
    out, serve_s, _, served = _serve_ckpt(ckpt, GPT2_NAME, bodies, True)
    laps.append(time.monotonic())
    ids = [r["output_ids"] for r in out]
    tf = [_tf_gate(model, b["input_ids"], i, 0.0)
          for b, i in zip(bodies, ids)]
    for b, res in zip(bodies, tf):
        _tf_line("(i) fp32 over HTTP", b["input_ids"], res)
    gates["i served by the engine as GPT-2"] = served == "GenerativeTorchModel"
    gates["i fp32 ids = the cache-free teacher-forced replay"] = all(
        r["ok"] for r in tf)
    gates["i non-degenerate (a prompt with > 1 distinct id)"] = any(
        len(set(i)) > 1 for i in ids)
    eng = GenerationEngine(model, **GPT2_GEN, kv_block_size=GPT2_BLOCK)
    paged, _ = _engine_burst(eng, bodies)
    _close(eng)
    gates["i paged ids = flat"] = paged == ids
    laps.append(time.monotonic())
    probe = bodies[1]["input_ids"]
    probe_t = torch.tensor([probe], device=DEVICE)
    with torch.inference_mode():
        ref = model(probe_t)[0, -1].float()
    fp32_peak = _peak_gib()
    pos = [n + MAX_TOKENS for n in GPT2_PROMPT_LENS]
    n_tok = len(bodies) * MAX_TOKENS

    def engine_run(m, what: str, profile: bool) -> dict:
        """The probe's first-token logits, the burst's ids (and W8A16
        launches: the probe's admission alone, then the rest), a decode
        step's wall ms (and, with `profile`, its device ms), the peak."""
        torch.cuda.reset_peak_memory_stats()
        eng = GenerationEngine(m, **GPT2_GEN)
        admits: list = []
        real_admit = eng._admit

        def admit(*a, **kw):  # the W8A16 launches of each admission
            start = _w8a16_counts()
            res = real_admit(*a, **kw)
            admits.append(tuple(x - y for x, y in zip(_w8a16_counts(),
                                                      start)))
            return res

        eng._admit = admit
        logits: list = []
        before = _w8a16_counts()
        with _first_logits(eng.model, logits):
            eng.submit(probe, max_tokens=1, timeout=600)
        got, _ = _engine_burst(eng, bodies)
        step = _step_walls(eng, GPT2_PROMPT_LENS)
        prof = (_profile(f"a {GPT2_GEN['slots']}-row {what} GPT-2 decode "
                         "chunk", _decode_call(eng, pos)) if profile
                else None)
        launches = tuple(a - b for a, b in zip(_w8a16_counts(), before))
        _close(eng)
        return {"logits": logits[0], "ids": got, "step": step,
                "device_ms": prof["busy_ms"] / CHUNK if prof else None,
                "admit": admits[0], "launches": launches,
                "peak": _peak_gib()}

    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    bmodel = gpt2_mod.GPT2(bcfg, device=DEVICE).eval()
    bmodel.load_state_dict(sd)
    bf16 = engine_run(bmodel, "bf16", True)
    laps.append(time.monotonic())
    rel_b = _rel_l2(bf16["logits"], ref)
    agree_b = sum(a == b for x, y in zip(ids, bf16["ids"])
                  for a, b in zip(x, y))
    gates["i bf16 first-token logits vs fp32"] = rel_b <= GPT2_T5_TOL
    # int8: quantize_fixed's codes (JAX's contraction axes), held against
    # the fp32 function of the same codes and against the bf16 weights.
    squant.quantize_fixed(bmodel)
    int8 = engine_run(bmodel, "int8", False)
    laps.append(time.monotonic())
    with torch.inference_mode():
        deq = _dequantized_fixed(bmodel, model)(probe_t)[0, -1].float()
    rel_qd = _rel_l2(int8["logits"], deq)
    rel_qb = _rel_l2(int8["logits"], bf16["logits"])
    agree_q = sum(a == b for x, y in zip(bf16["ids"], int8["ids"])
                  for a, b in zip(x, y))
    del model, bmodel, sd
    _free()
    bucket = next(b for b in GPT2_GEN["prefill_buckets"] if len(probe) <= b)
    want = _w8a16_expect(_gpt2_w8a16_shapes(cfg, bucket, 1))
    first = _by_route(int8["admit"])
    gates["i int8 W8A16 launches of an admission = the plan's"] = (
        sum(first.values()) == sum(want.values())
        and first.get(w8.WGMMA, 0) == want.get(w8.WGMMA, 0))
    gates["i int8 first-token logits vs the fp32 function of its codes"] = (
        rel_qd <= GPT2_T5_TOL)
    gates["i int8 first-token logits vs bf16"] = rel_qb <= BERT_INT8_TOL
    h, v, slots = cfg.hidden_size, cfg.vocab_size, GPT2_GEN["slots"]
    odd = _w8a16_at(gk, [(1, h, v, True), (slots, h, v, True),
                          (slots, h, h, False),
                          (slots, h, cfg.intermediate_size, False),
                          (slots, cfg.intermediate_size, h, False)])
    laps.append(time.monotonic())

    def step_text(r):
        dev = (f"{r['device_ms']:.3f}" if r["device_ms"] is not None
               else "not measured")
        return (f"decode {_step_text(r['step'], slots)}, device {dev} ms a "
                f"step, {1e3 / r['step']['ms']:.1f} tok/s a row; peak "
                f"{r['peak']:.2f} GiB")

    log(f"  (i) GPT-2-small ({cfg.num_params} parameters): {nbytes} bytes "
        f"(fp32, Conv1D layout, fused c_attn) written in {write_s:.2f}s, "
        f"serving {serve_s:.1f}s after --storage-uri; prompts "
        f"{GPT2_PROMPT_LENS} at once, {MAX_TOKENS} tokens each: fp32 ids "
        f"{sum(r['n'] - r['parts'] for r in tf)}/{n_tok} the teacher-forced "
        f"argmax; distinct ids a prompt {[len(set(i)) for i in ids]}; paged "
        f"(blocks of {GPT2_BLOCK}) ids {'=' if paged == ids else '!='} flat; "
        f"peak {fp32_peak:.2f} GiB")
    log(f"  (i) bf16: first-token logits rel_l2 {rel_b:.3e} from fp32 (bound "
        f"{GPT2_T5_TOL}); ids equal fp32's at {agree_b}/{n_tok} tokens; "
        + step_text(bf16))
    log(f"  (i) int8: first-token logits rel_l2 {rel_qd:.3e} from the fp32 "
        f"function of its codes (bound {GPT2_T5_TOL}), {rel_qb:.3e} from "
        f"bf16 (bound {BERT_INT8_TOL}); ids equal bf16's at "
        f"{agree_q}/{n_tok} tokens; W8A16 launches of the {len(probe)}-token "
        f"admission {first} (the plan: {want}), of the whole run "
        f"{_by_route(int8['launches'])}; " + step_text(int8)
        + f"; (i) took {time.monotonic() - t0:.1f}s (HTTP, replay and "
        f"paged, bf16, int8, the W8A16 shapes: "
        f"{[round(y - x, 1) for x, y in zip(laps, laps[1:])]} s)")
    return {"w8a16": int8["launches"], "odd": odd, "rel_bf16": rel_b,
            "rel_int8_codes": rel_qd, "rel_int8_bf16": rel_qb,
            "step_ms": {"bf16": bf16["step"]["ms"],
                        "int8": int8["step"]["ms"]},
            "device_step_ms": {"bf16": bf16["device_ms"],
                               "int8": int8["device_ms"]},
            "peak_gib": {"fp32": fp32_peak, "bf16": bf16["peak"],
                         "int8": int8["peak"]}}


def _t5_model(cfg):
    """A T5 of `cfg` on the card with HF's initialisation: the port's
    init_weights (shared and an untied head N(0, 1), projections
    N(0, 1/fan_in), norms 1), q rescaled to N(0, (d_model d_kv)^-0.5) and
    the relative-position tables to N(0, d_model^-0.5), as HF's
    T5PreTrainedModel draws them."""
    model = t5_mod.T5(cfg, device=DEVICE).init_weights(SEED)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, t5_mod.T5Attention):
                mod.q.weight.mul_(cfg.d_kv ** -0.5)
            elif isinstance(mod, t5_mod.RelPosBias):
                mod.table.mul_(cfg.d_model ** -0.5)
    return model.eval()


def _t5_first_logits(model, enc, mask) -> torch.Tensor:
    with torch.inference_mode():
        dec = torch.full((1, 1), model.cfg.decoder_start_id,
                         dtype=torch.long, device=DEVICE)
        return model(enc, dec, mask)[0, 0].float()


def _padded(ids: list, bucket: int) -> tuple:
    enc = torch.zeros((1, bucket), dtype=torch.long, device=DEVICE)
    enc[0, :len(ids)] = torch.tensor(ids, device=DEVICE)
    mask = torch.zeros((1, bucket), dtype=torch.bool, device=DEVICE)
    mask[0, :len(ids)] = True
    return enc, mask


def _t5(work: str, label: str, config: dict, gates: dict) -> dict:
    """4m (ii): one T5 config at full depth (see the constants): fp32 over
    :generate, then a bf16 request and an int8 request of the longest
    input under set_sync_debug_mode("error")."""
    t0 = time.monotonic()
    cfg = hf_mod.config_from_hf(config, dtype="float32")
    gates[f"ii {label} config"] = (
        isinstance(cfg, t5_mod.T5Config)
        and (cfg.vocab_size, cfg.d_model, cfg.d_kv, cfg.num_layers,
             cfg.num_decoder_layers, cfg.num_heads, cfg.rel_buckets,
             cfg.rel_max_distance, cfg.d_ff, cfg.gated, cfg.tie_embeddings)
        == (32128, 768, 64, 12, 12, 12, 32, 128, config["d_ff"],
            config["feed_forward_proj"] == "gated-gelu",
            config["tie_word_embeddings"]))
    model = _t5_model(cfg)
    sd = model.state_dict()
    ckpt = os.path.join(work, f"hf_{label}")
    os.makedirs(ckpt, exist_ok=True)
    tw = time.monotonic()
    nbytes = hf_mod.save_safetensors(
        {h: sd[p].cpu() for p, h in hf_mod.t5_hf_names(cfg).items()},
        os.path.join(ckpt, "model.safetensors"))
    write_s = time.monotonic() - tw
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(ckpt, "model.json"), "w") as f:
        json.dump({"format": "huggingface", "generative": T5_GEN,
                   "model_overrides": {"dtype": "float32"}}, f)
    rng = np.random.default_rng(SEED + 80)
    bodies = [{"input_ids": rng.integers(2, cfg.vocab_size, n).tolist(),
               "max_tokens": T5_GEN["max_tokens"]} for n in T5_REQUEST_LENS]
    buckets = [next(s for s in T5_GEN["in_buckets"]
                    if len(b["input_ids"]) <= s) for b in bodies]
    torch.cuda.reset_peak_memory_stats()
    laps = [time.monotonic()]
    out, serve_s, walls, served = _serve_ckpt(ckpt, label, bodies, False)
    gates[f"ii {label} served as text2text"] = (
        served == "Text2TextTorchModel")
    # Each request's tokens against the argmax of one teacher-forced
    # forward over [start] + its tokens on the same padded input: every
    # valid token, then, below max_tokens, EOS where n_valid says.
    n_max, ok, n_valid = T5_GEN["max_tokens"], True, []
    for b, bucket, r in zip(bodies, buckets, out):
        toks, nv = r["output_ids"], r["num_output_tokens"]
        n_valid.append(nv)
        enc, mask = _padded(b["input_ids"], bucket)
        dec = torch.tensor([[cfg.decoder_start_id] + toks], device=DEVICE)
        with torch.inference_mode():
            top = model(enc, dec, mask)[0].argmax(-1).tolist()
        want = toks + ([cfg.eos_id] if nv < n_max else [])
        ok &= (len(toks) == nv and cfg.eos_id not in toks
               and top[:len(want)] == want)
    gates[f"ii {label} fp32 tokens = the teacher-forced argmax, n_valid "
          "by the EOS rule"] = ok
    gates[f"ii {label} at least {T5_MIN_VALID} valid tokens"] = (
        sum(n_valid) >= T5_MIN_VALID)
    laps.append(time.monotonic())
    enc, mask = _padded(bodies[1]["input_ids"], buckets[1])
    ref = _t5_first_logits(model, enc, mask)
    fp32_peak = _peak_gib()
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    bmodel = t5_mod.T5(bcfg, device=DEVICE).eval()
    bmodel.load_state_dict(sd)
    del sd
    torch.cuda.reset_peak_memory_stats()
    b_logits = _t5_first_logits(bmodel, enc, mask)
    rel_b = _rel_l2(b_logits, ref)
    gates[f"ii {label} bf16 first-step logits vs fp32"] = (
        rel_b <= GPT2_T5_TOL)
    bserved = Text2TextTorchModel(label, bmodel, generation=T5_GEN)
    bserved.load()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bserved.generate(bodies[1])
    b_ms = (time.perf_counter() - t1) * 1e3
    bf16_peak = _peak_gib()
    del bserved
    laps.append(time.monotonic())
    torch.cuda.reset_peak_memory_stats()
    squant.quantize_fixed(bmodel)
    q_logits = _t5_first_logits(bmodel, enc, mask)
    rel_qb = _rel_l2(q_logits, b_logits)
    rel_qd = _rel_l2(q_logits, _t5_first_logits(
        _dequantized_fixed(bmodel, model), enc, mask))
    del model
    _free()
    gates[f"ii {label} int8 first-step logits vs the fp32 function of its "
          "codes"] = rel_qd <= GPT2_T5_TOL
    gates[f"ii {label} int8 first-step logits vs bf16"] = (
        rel_qb <= BERT_INT8_TOL)
    qserved = Text2TextTorchModel(label, bmodel, generation=T5_GEN)
    qserved.load()
    waits = []
    real_wait = text2text._wait

    def wait_outside(event):
        waits.append(event)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    text2text._wait = wait_outside
    q_ms, q_launch = [], []
    timed = (len(bodies) - 1,)  # the longest input
    try:
        for i in timed:
            before = _w8a16_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                qserved.generate(bodies[i])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            q_ms.append((time.perf_counter() - t1) * 1e3)
            q_launch.append(tuple(a - c for a, c in zip(_w8a16_counts(),
                                                         before)))
    finally:
        text2text._wait = real_wait
    gates[f"ii {label} one host sync a request (the fetch)"] = (
        len(waits) == len(timed))
    want = [_w8a16_expect(_t5_w8a16_shapes(cfg, buckets[i], n_max))
            for i in timed]
    gates[f"ii {label} int8 W8A16 launches a request = the plan's"] = all(
        n == sum(w.values()) and g == w.get(w8.WGMMA, 0)
        for (n, g), w in zip(q_launch, want))
    int8_peak = _peak_gib()
    laps.append(time.monotonic())
    del qserved, bmodel
    _free()
    log(f"  (ii) {label} ({cfg.num_params} parameters): {nbytes} bytes "
        f"written in {write_s:.2f}s, serving {serve_s:.1f}s after "
        f"--storage-uri; requests of {T5_REQUEST_LENS} ids one after "
        f"another over :generate, fp32: valid tokens {n_valid} (bound: at "
        f"least {T5_MIN_VALID} in all), ms a request "
        f"{[round(w, 1) for w in walls]}, peak {fp32_peak:.2f} GiB; bf16: "
        f"first-step logits rel_l2 {rel_b:.3e} from fp32 (bound "
        f"{GPT2_T5_TOL}), {b_ms:.1f} ms a request of "
        f"{T5_REQUEST_LENS[1]} ids, peak {bf16_peak:.2f} GiB; int8: first-step logits rel_l2 {rel_qd:.3e} "
        f"from the fp32 function of its codes (bound {GPT2_T5_TOL}), "
        f"{rel_qb:.3e} from bf16 (bound {BERT_INT8_TOL}); requests of "
        f"{[T5_REQUEST_LENS[i] for i in timed]} ids under sync-debug "
        f"'error': ms {[round(w, 1) for w in q_ms]}, host syncs "
        f"{len(waits)}, W8A16 launches {[n for n, _ in q_launch]} (wgmma "
        f"{[g for _, g in q_launch]}; the plan: {want}), peak "
        f"{int8_peak:.2f} GiB; (ii) {label} took "
        f"{time.monotonic() - t0:.1f}s (HTTP, replay, bf16, int8: "
        f"{[round(b - a, 1) for a, b in zip(laps, laps[1:])]} s)")
    return {"w8a16": (sum(n for n, _ in q_launch),
                      sum(g for _, g in q_launch)),
            "rel_bf16": rel_b, "rel_int8_codes": rel_qd,
            "rel_int8_bf16": rel_qb,
            "ms": {"fp32": walls, "bf16": b_ms, "int8": q_ms},
            "n_valid": n_valid,
            "peak_gib": {"fp32": fp32_peak, "bf16": bf16_peak,
                         "int8": int8_peak}}


def phase_gpt2_t5(work: str, gk) -> dict:
    """4m: GPT-2 and the T5 family at full depth: (i) GPT-2-small through
    the engine, (ii) T5-base and Flan-T5-base through :generate (see the
    constants)."""
    t_phase = time.monotonic()
    _free()
    gates: dict = {}
    gpt2 = _gpt2(work, gk, gates)
    t5 = {label: _t5(work, label, config, gates)
          for label, config in (("t5_base", T5_BASE_CONFIG),
                                ("flan_t5_base", FLAN_T5_BASE_CONFIG))}
    t5_odd = _w8a16_at(gk, [(1, 768, 32128, True), (1, 768, 32128, False),
                             (1, 768, 2048, False), (1, 2048, 768, False)])
    log(f"  4m took {time.monotonic() - t_phase:.1f}s; {smi()}")
    for gate, ok in gates.items():
        log(f"  gate {gate}: {'OK' if ok else 'FAIL'}")
    if not all(gates.values()):
        raise RuntimeError(f"GPT-2/T5 gates failed: "
                           f"{[g for g, ok in gates.items() if not ok]}")
    return {"w8a16_launches": {
                "gpt2_int8_serving": gpt2["w8a16"],
                **{f"{k}_int8_text2text": v["w8a16"] for k, v in t5.items()}},
            "gpt2": gpt2, "t5": t5, "t5_w8a16": t5_odd}


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
    _free()
    tokens = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, QUANT_PROMPT))).to(DEVICE)
    with torch.inference_mode():
        model = llama_mod.Llama(cfg, device=DEVICE).init_weights(SEED)
        orig = model(tokens).float()
        squant.quantize_model(model)
        _free()
        int8 = model(tokens).float()
        deq = _dequantized_copy(model, cfg)
        ref = deq(tokens).float()
    del model, deq
    rel, rel_orig = _rel_l2(int8, ref), _rel_l2(int8, orig)
    agree = (int8.argmax(-1) == ref.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(int8).all())
    ok = (finite and rel <= QUANT_LOGITS_REL_L2_MAX
          and agree >= QUANT_ARGMAX_AGREE_MIN)
    log(f"  int8 logits [1, {QUANT_PROMPT}, {cfg.vocab_size}] vs the same "
        f"codes dequantized to bf16: rel_l2 {rel:.3e} (bound "
        f"{QUANT_LOGITS_REL_L2_MAX}), argmax agreement {agree:.4f} (bound "
        f"{QUANT_ARGMAX_AGREE_MIN}) {'OK' if ok else 'FAIL'}; vs the original "
        f"bf16 weights (reported): rel_l2 {rel_orig:.3e}, dequantized copy "
        f"{_rel_l2(ref, orig):.3e}")
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
        self.steps, self.evals, self.events = [], [], []

    def write(self, text):
        self.out.write(text)
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if "event" in rec:
                self.events.append(rec)
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
    rec = {"wall_ms": wall, "busy_ms": busy, "families": families,
           "by_name": {e.key: (e.self_device_time_total / 1e3, e.count)
                       for e in kernels}}
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


def _decode_chunk(server: ModelServer, aids=None):
    """(one decode chunk of the idle engine as a zero-argument call: CHUNK
    steps, every slot at position 3000, greedy, through the engine's own
    decode function; its rows, its bucket). Paged engines get tables over
    blocks 1.. (the pool is idle: nothing lives there). `aids` (an
    engine with adapters): each row's adapter id, gathered once outside
    the call, as the engine's dispatch does."""
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
    rows = (None if aids is None
            else engine._adapter_rows(np.asarray(aids, np.int64)))
    return (lambda: chunk_fn(engine._cache, *args, engine._gen, rows)), n, \
        bucket


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


def _plain_flash(q, k, v, causal=True, block_q=512, block_kv=512,
                 segment_ids=None, mask=None):
    """flash_attention's signature over the kernels' plain versions."""
    return _PlainFlash.apply(q, k, v, fa._norm_mask(causal, mask),
                             segment_ids)


def _kernel_fwd_plain_bwd(q, k, v, causal=True, block_q=512, block_kv=512,
                          segment_ids=None, mask=None):
    """flash_attention's signature over the forward kernel and the plain
    backward."""
    return _KernelFwdPlainBwd.apply(q, k, v, fa._norm_mask(causal, mask),
                                    segment_ids)


def _naive_flash(q, k, v, causal=True, block_q=512, block_kv=512,
                 segment_ids=None, mask=None):
    """flash_attention's signature over naive_attention (bf16 scores and
    probabilities, as the JAX twin's einsum path)."""
    return naive_attention(q, k, v, causal=causal, mask=mask,
                           segment_ids=segment_ids)


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


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
    _free()
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
    _free()

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
    try:
        k_loss, k_grads = _loss_and_grads(model, small)
        llama_mod.flash_attention = _plain_flash
        p_loss, p_grads = _loss_and_grads(model, small)
        llama_mod.flash_attention = _naive_flash
        n_loss, n_grads = _loss_and_grads(model, small)
        llama_mod.flash_attention = _kernel_fwd_plain_bwd
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
    _free()
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
    whose losses must equal a fault-free run's, for a full-parameter job,
    a spec.lora job and a spec.lora job on the MoE base (5e (iv)'s) side
    by side."""
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
        resume = _job_resume(cfg, work, corpus)
        result.update(resume=resume["plain"], resume_lora=resume["lora"],
                      resume_moe_lora=resume["moe_lora"])
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _free()


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

    _free()
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
    _free()
    return {"launches": launches, "ms_per_step": step_s * 1e3,
            "tok_s": tok_s, "mfu": mfu, "data_wait_share": wait,
            "evals": tap.evals, "traces": traces,
            "saves": [{"step": s, "seconds": sec, "bytes": n}
                      for s, sec, n in saves]}


def _job_resume(cfg, work: str, corpus: str) -> dict:
    """5b-ii: a SIGKILLed worker relaunched as the controller launches it,
    for a full-parameter job, a spec.lora job (LORA) and 5e (iv)'s
    spec.lora job on the MoE base (MOE_LORA), whose checkpoints hold the
    adapters' moments alone, matched to them by name on the restore. Each
    variant has three workers: a fault-free reference (the same spec
    without checkpoints, which do not enter the losses), the spec with
    checkpoints and TPK_FAULT (it must die by SIGKILL after logging
    fault_injected), and its relaunch, which must log `restored` at the
    last checkpoint and reach the final step with the reference's losses
    bit for bit. The variants run side by side on the card, each in a
    workdir of its own: the references beside the faulted workers, the
    relaunches after them."""
    variants = {
        "plain": lambda **kw: _job_spec(
            corpus, model_kwargs={"num_layers": JOB_RESUME_LAYERS},
            steps=JOB_RESUME_STEPS, **kw),
        "lora": lambda **kw: _job_spec(
            corpus, model_kwargs={"num_layers": JOB_RESUME_LAYERS},
            steps=JOB_RESUME_STEPS, lora=dict(LORA), **kw),
        # 5e (iv)'s resume: spec.lora on the MoE base (synthetic rows: the
        # corpus is over llama_1b's vocabulary).
        "moe_lora": lambda **kw: _moe_spec(
            model_kwargs={"num_layers": MOE_RESUME_LAYERS,
                          "remat_policy": "nothing"},
            steps=JOB_RESUME_STEPS, batch_size=MOE_AGREE_BATCH,
            lora=dict(MOE_LORA), **kw)}
    cut = registry.model_config(TRAIN_MODEL, num_layers=JOB_RESUME_LAYERS)
    log(f"  5b-ii moe_lora with spec.lora {json.dumps(MOE_LORA)}: "
        f"{MOE_TRAIN_MODEL}'s widths at {MOE_RESUME_LAYERS} layer, batch "
        f"{MOE_AGREE_BATCH} x {MOE_TRAIN_SEQ} of synthetic_lm, "
        f"{JOB_RESUME_STEPS} steps, checkpoint every {JOB_RESUME_INTERVAL}, "
        f"TPK_FAULT={JOB_FAULT}")
    for v, lora in (("plain", None), ("lora", LORA)):
        per_param = 4 if lora else 12  # fp32 masters (and both moments)
        log(f"  5b-ii {v}"
            f"{' with spec.lora ' + json.dumps(lora) if lora else ''}: "
            f"{TRAIN_MODEL} widths at {JOB_RESUME_LAYERS} layers "
            f"(depth cut: a {cfg.num_layers}-layer checkpoint of fp32 "
            f"masters and {'the adapters' if lora else 'both'} moments is "
            f"{per_param * cfg.num_params / 1e9:.1f} GB, a "
            f"{JOB_RESUME_LAYERS}-layer one "
            f"{per_param * cut.num_params / 1e9:.1f} GB, written by two of "
            f"the three runs), {JOB_RESUME_STEPS} steps, checkpoint every "
            f"{JOB_RESUME_INTERVAL}, TPK_FAULT={JOB_FAULT}")
    runs: dict = {}

    def launch(key, workdir, spec, fault):
        t0 = time.monotonic()
        try:
            rc, recs = _worker(workdir, spec, fault)
        except Exception as e:  # raised below, after the other workers
            runs[key] = e
            return
        runs[key] = (rc, recs, time.monotonic() - t0)

    def faulted_then_relaunch(v, workdir, spec):
        launch((v, "faulted"), workdir, spec, JOB_FAULT)
        launch((v, "relaunch"), workdir, spec, None)

    # A reference takes no checkpoint, so it runs on the card beside its
    # faulted worker; each relaunch follows its fault.
    threads = []
    for v, spec_of in variants.items():
        vdir = os.path.join(work, f"resume_{v}")
        ref_dir = os.path.join(vdir, "reference")
        os.makedirs(ref_dir)
        ckpt = {"dir": os.path.join(vdir, "ckpt"),
                "interval": JOB_RESUME_INTERVAL, "keep": 2}
        threads += [
            threading.Thread(target=launch, args=(
                (v, "reference"), ref_dir, spec_of(), None)),
            threading.Thread(target=faulted_then_relaunch, args=(
                v, vdir, spec_of(checkpoint=ckpt)))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log(f"    the {len(threads) * 3 // 2} workers took "
        f"{time.monotonic() - t0:.1f}s side by side")
    fault_step = int(JOB_FAULT.split(";")[0].split("=")[1])
    want_restore = fault_step // JOB_RESUME_INTERVAL * JOB_RESUME_INTERVAL
    failed, out = {}, {}
    for v in variants:
        names = ("reference", "faulted", "relaunch")
        for name in names:
            if not isinstance(runs.get((v, name)), tuple):
                raise RuntimeError(f"5b-ii {v} worker {name} failed: "
                                   f"{runs.get((v, name))!r}")
            rc, recs, sec = runs[(v, name)]
            log(f"    {v} {name}: exit {rc} in {sec:.1f}s; events "
                f"{[(r['step'], r['event']) for r in recs if 'event' in r]}"
                f"; losses {_step_losses(recs)}")
        ref, bad, again = (runs[(v, n)][1] for n in names)
        restored = [r["step"] for r in again if r.get("event") == "restored"]
        checks = {
            "reference finished": runs[(v, "reference")][0] == 0
            and len(_step_losses(ref)) == JOB_RESUME_STEPS,
            "faulted worker killed by signal 9":
            runs[(v, "faulted")][0] == -9,
            "fault_injected logged": any(
                r.get("event") == "fault_injected" and r["step"] == fault_step
                for r in bad),
            f"restored at step {want_restore}": restored == [want_restore],
            "relaunch finished": runs[(v, "relaunch")][0] == 0
            and max(_step_losses(again), default=0) == JOB_RESUME_STEPS,
        }
        ref_l = _step_losses(ref)
        got = {**_step_losses(bad), **_step_losses(again)}
        diffs = {s: abs(got[s] - ref_l[s]) / abs(ref_l[s])
                 for s in ref_l if s in got}
        checks["every step's loss bit-equal to the reference"] = (
            set(got) == set(ref_l) and all(got[s] == ref_l[s] for s in ref_l))
        log(f"    {v}: loss rel. differences from the reference by step: "
            f"{diffs}; " + ", ".join(f"{k} {'OK' if ok else 'FAIL'}"
                                     for k, ok in checks.items()))
        if not all(checks.values()):
            failed[v] = checks
        out[v] = {"restored_at": want_restore, "bit_equal": True,
                  "seconds": {n: runs[(v, n)][2] for n in names}}
    if failed:
        raise RuntimeError(f"fault and resume failed: {failed}")
    return out


def _lora_train(cfg, prof_dir: str) -> tuple:
    """5c's training run through Trainer(spec).run(), the last warm-up
    step profiled into prof_dir; returns (trainer, tap, wall seconds, peak
    bytes, the frozen tensors as initialised)."""
    steps = LORA_WARMUP + LORA_TIMED
    spec = trainer_mod.TrainJobSpec(
        model=LORA_MODEL, dataset="synthetic_lm", batch_size=LORA_BATCH,
        seq_len=LORA_SEQ, learning_rate=LORA_LR, steps=steps, log_every=1,
        seed=SEED, lora=dict(LORA),
        profile={"dir": prof_dir, "start_step": LORA_WARMUP - 1,
                 "num_steps": 1})
    before = {}
    real_init = trainer_mod.init_train_state

    def init_and_snapshot(model, *args, **kw):
        state = real_init(model, *args, **kw)
        named = dict(model.named_parameters())
        before.update({n: named[n].detach().clone()
                       for n in LORA_FROZEN_CHECK})
        return state

    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tap = _StepTap(sys.stdout)
    t0 = time.monotonic()
    trainer_mod.init_train_state = init_and_snapshot
    try:
        with contextlib.redirect_stdout(tap):
            trainer = trainer_mod.Trainer(spec)
            trainer.run()
    finally:
        trainer_mod.init_train_state = real_init
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(tap.steps) != steps:
        raise RuntimeError(f"LoRA trainer logged {len(tap.steps)} of {steps} "
                           "steps")
    return trainer, tap, wall, peak, before


def phase_lora() -> dict:
    """5c: LoRA on llama3_8b at full width and depth through the trainer,
    then the merge and the merged model served through the engine."""
    cfg = registry.model_config(LORA_MODEL)
    layers = cfg.num_layers
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_lora_prof_",
                                dir=os.path.join(ROOT, "build"))
    try:
        trainer, tap, wall, peak, before = _lora_train(cfg, prof_dir)
        log(f"  profile of step {LORA_WARMUP} (the last warm-up step):")
        traces = _trace_kernels(prof_dir)
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    model, lcfg = trainer.model, trainer.info["config"]
    adapters, base = lora_mod.partition(model)
    n_lora = sum(p.numel() for p in adapters.values())
    expect = (2 * layers, layers, layers)
    bad = [(rec["step"], n) for rec, n in tap.steps if n != expect]
    if bad:
        raise RuntimeError(f"LoRA steps launched (fwd, dq, dkv) {bad}, "
                           f"expected {expect} a step")
    losses = [rec["loss"] for rec, _ in tap.steps]
    ln_v = math.log(cfg.vocab_size)
    if not (all(math.isfinite(x) for x in losses)
            and ln_v - LOSS0_BELOW <= losses[0] <= ln_v + LOSS0_ABOVE):
        raise RuntimeError(f"LoRA losses {losses}: not finite, or the first "
                           f"outside [{ln_v - LOSS0_BELOW:.2f}, "
                           f"{ln_v + LOSS0_ABOVE:.2f}]")
    named = dict(model.named_parameters())
    frozen_ok = (all(torch.equal(named[n], before[n]) for n in before)
                 and all(not p.requires_grad and p.grad is None
                         for p in base.values()))
    b_moved = max(p.abs().max().item() for n, p in adapters.items()
                  if n.endswith("_lora_b"))
    sharding = next(e for e in tap.events
                    if e.get("event") == "state_sharding")
    opt_bytes = sharding["opt_state_bytes_per_chip"]
    timed = [rec for rec, _ in tap.steps[LORA_WARMUP:]]
    step_s = sum(r["step_time_s"] for r in timed) / len(timed)
    tok_s = LORA_BATCH * LORA_SEQ / step_s
    flops_per_token = 4 * cfg.num_params + 6 * n_lora
    mfu = flops_per_token * tok_s / PEAK_BF16_FLOPS
    log(f"  trainer: {len(losses)} steps in {wall:.1f}s (model init "
        f"included); losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  launches per step (fwd, dq, dkv) = {expect} in every step "
        f"(remat 'nothing': the forward twice a layer); run totals "
        f"{_counts()}")
    log(f"  timed {len(timed)} steps: {step_s * 1e3:.2f} ms/step, "
        f"{tok_s:.0f} tok/s, LoRA MFU {mfu:.4f} ((4*N_base + 6*N_lora) * "
        f"tok/s / {PEAK_BF16_FLOPS:.3g}; N_base {cfg.num_params}, N_lora "
        f"{n_lora}); trainer's own mfu (6*N_base) {timed[-1]['mfu']:.4f}; "
        f"peak memory {peak / 2**30:.2f} GiB; opt_state_bytes_per_chip "
        f"{opt_bytes:.0f} ({opt_bytes / 1e9:.3f} GB, the adapters' mu and "
        f"nu: 8 x {n_lora} = {8 * n_lora})")
    log(f"  frozen base: {len(base)} tensors, requires_grad off, no .grad; "
        f"{', '.join(LORA_FROZEN_CHECK)} bit-equal before and after "
        f"training: {'OK' if frozen_ok else 'FAIL'}; largest |B| "
        f"{b_moved:.3e}")
    if not frozen_ok or opt_bytes != 8 * n_lora or not b_moved > 0:
        raise RuntimeError("the LoRA run changed the base, kept other "
                           "optimizer state or left B at zero")
    result = {"launches": _counts(), "ms_per_step": step_s * 1e3,
              "tok_s": tok_s, "mfu": mfu, "peak_gib": peak / 2**30,
              "opt_state_bytes": opt_bytes, "n_lora": n_lora,
              "losses": losses, "traces": traces}
    del model, named, adapters, base, before  # the trainer's is the last
    result.update(_lora_merge_and_serve(cfg, trainer))
    return result


def _set_compute_dtype(model, dtype) -> None:
    """Run `model` in `dtype` (its weights stay as stored): every module's
    config, each projection's compute dtype and each norm's output dtype,
    as serve.quant.quantize_model swaps the config."""
    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    for mod in model.modules():
        if getattr(mod, "cfg", None) is not None:
            mod.cfg = cfg
        if isinstance(mod, llama_mod.Dense):
            mod.compute_dtype = dtype
        elif isinstance(mod, llama_mod.RMSNorm):
            mod.dtype = dtype


def _lora_merge_and_serve(cfg, trainer) -> dict:
    """Fold the trained adapters into a bf16 serving copy (`merge`), hold a
    lora_rank=0 model on it against the adapted model's logits, and serve
    it through the engine. Takes the trainer's model from it, and frees
    the fp32 model once the copy is made."""
    model, lcfg = trainer.model, trainer.info["config"]
    trainer.model = None
    gen = np.random.default_rng(SEED + 5)
    prompt = torch.from_numpy(gen.integers(
        0, cfg.vocab_size, (1, LORA_PROMPT))).to(DEVICE)
    with torch.no_grad():
        adapted = model(prompt).float()
        _set_compute_dtype(model, torch.float32)
        exact = model(prompt).float()  # the trained function, fp32
    # The serving layout: projections and the embedding in bf16, norm
    # scales fp32; the adapters stay fp32 for the fold.
    sd = {k: (v.to(torch.bfloat16) if k.endswith(".weight") or k == "embed"
              else v.detach())
          for k, v in model.state_dict().items()}
    del model
    _free()
    plain = llama_mod.Llama(cfg, device=DEVICE)  # lora_rank 0, bf16
    plain.load_state_dict({k: v for k, v in sd.items()
                           if not lora_mod.is_lora_path(k)})
    plain.eval()
    with torch.no_grad():
        base_logits = plain(prompt).float()
    t0 = time.monotonic()
    merged = lora_mod.merge(sd, lcfg)
    merge_s = time.monotonic() - t0
    del sd
    plain.load_state_dict(merged)
    del merged
    with torch.no_grad():
        merged_logits = plain(prompt).float()
    rel = _rel_l2(merged_logits, adapted)
    rel_exact = _rel_l2(merged_logits, exact)
    floor = _rel_l2(adapted, exact)
    rel_base = _rel_l2(base_logits, adapted)
    agree = (merged_logits.argmax(-1) == adapted.argmax(-1)).float().mean()
    ok = rel_exact <= LOGITS_VS_NAIVE * floor and rel <= LOGITS_REL_L2_MAX
    log(f"  merge: {merge_s:.2f}s for {len(llama_mod.lora_projections(lcfg))}"
        f" x {cfg.num_layers} projections (fp32 fold, bf16 result); logits "
        f"rel_l2 on a {LORA_PROMPT}-token prompt: merged lora_rank=0 bf16 "
        f"model vs the trained model in fp32 {rel_exact:.3e}, the adapted "
        f"bf16 model vs it {floor:.3e} (bound {LOGITS_VS_NAIVE} x that); "
        f"merged vs adapted {rel:.3e} (bound {LOGITS_REL_L2_MAX}), argmax "
        f"agreement {agree.item():.4f}; the base without adapters vs the "
        f"adapted model {rel_base:.3e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("merged logits disagree with the adapted model")
    del adapted, exact, base_logits
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LORA_REQUESTS]
    with torch.no_grad():
        firsts = [plain(torch.tensor([p], device=DEVICE))[0, -1].argmax()
                  .item() for p in prompts]
    served = GenerativeTorchModel(f"{LORA_MODEL}-lora-merged", plain,
                                  generation=dict(LORA_SERVE))
    served.load()
    results: list = [None] * len(prompts)

    def run(i):
        try:
            results[i] = served.generate({"input_ids": prompts[i],
                                          "max_tokens": LORA_MAX_TOKENS})
        except Exception as e:  # reported below as a failed request
            results[i] = e

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        _reset_counts()  # the engine's launches alone (load does no warm-up)
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.monotonic() - t0
        serving_launches = _counts()
        stats = served.engine.stats_snapshot()
    finally:
        served.unload()
    for i, res in enumerate(results):
        ids = res.get("output_ids") if isinstance(res, dict) else None
        if (ids is None or len(ids) != LORA_MAX_TOKENS
                or not all(0 <= t < cfg.vocab_size for t in ids)):
            raise RuntimeError(f"merged-model request {i} failed: {res!r}")
        log(f"  merged model served (pipeline_depth "
            f"{LORA_SERVE['pipeline_depth']}): prompt {LORA_REQUESTS[i]} "
            f"tokens -> {ids[:8]}... ({len(ids)} greedy ids; the full "
            f"forward's argmax {firsts[i]}, the engine's first id "
            f"{ids[0]}), latency {res['latency_s']:.3f}s")
    log(f"  {len(prompts)} concurrent requests in {wall:.2f}s; engine "
        + ", ".join(f"{k} {stats.get(k)}" for k in PIPELINE_COUNTERS))
    if not stats.get("decode_fetch_overlapped", 0) > 0:
        raise RuntimeError("the merged model's engine never kept a chunk in "
                           "flight while it fetched another")
    first_ids_match = sum(r["output_ids"][0] == f
                          for r, f in zip(results, firsts))
    log(f"  engine's first id = the full forward's argmax in "
        f"{first_ids_match} of {len(prompts)} requests; flash launches "
        f"(fwd, dq, dkv) while the engine served: {serving_launches}")
    if first_ids_match != len(prompts):
        raise RuntimeError("the engine's first greedy ids on the merged "
                           "model differ from the full forward's argmax")
    del plain, served
    _free()
    return {"merge_rel_l2": rel, "merge_vs_fp32_rel_l2": rel_exact,
            "adapted_vs_fp32_rel_l2": floor, "base_rel_l2": rel_base,
            "merge_s": merge_s, "serving_launches": serving_launches,
            "first_ids_match": first_ids_match}


def phase_remat() -> dict:
    """5d: llama_1b at phase 5's point under each remat policy through
    the trainer, REMAT_STEPS steps each: ms/step, peak memory, launches a
    step, and the losses against "nothing"'s."""
    layers = registry.model_config(TRAIN_MODEL).num_layers
    rows = {p: [] for p in llama_mod.REMAT_POLICIES}
    for policy in rows:
        spec = trainer_mod.TrainJobSpec(
            model=TRAIN_MODEL, model_kwargs={"remat_policy": policy},
            dataset="synthetic_lm", batch_size=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, learning_rate=TRAIN_LR, weight_decay=1e-4,
            steps=REMAT_STEPS, log_every=1, seed=SEED)
        _free()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        tap = _StepTap(sys.stdout)
        with contextlib.redirect_stdout(tap):
            trainer_mod.Trainer(spec).run()
        peak = torch.cuda.max_memory_allocated()
        if len(tap.steps) != REMAT_STEPS:
            raise RuntimeError(f"remat_policy {policy}: {len(tap.steps)} of "
                               f"{REMAT_STEPS} steps")
        rows[policy].append({
            "ms": [rec["step_time_s"] * 1e3 for rec, _ in tap.steps[1:]],
            "peak_gib": peak / 2**30,
            "launches_per_step": [list(n) for _, n in tap.steps],
            "losses": [rec["loss"] for rec, _ in tap.steps]})
    ref = rows["nothing"][0]["losses"]
    expect = [2 * layers, layers, layers]
    out = {}
    for policy, runs in rows.items():
        ms = [x for run in runs for x in run["ms"]]
        diff = max(abs(a - b) for run in runs
                   for a, b in zip(run["losses"], ref))
        ok = all(n == expect for run in runs
                 for n in run["launches_per_step"]) and all(
            abs(a - b) <= REMAT_LOSS_REL * abs(b) for run in runs
            for a, b in zip(run["losses"], ref))
        out[policy] = {"ms_per_step": sum(ms) / len(ms),
                       "ms_by_run": [run["ms"] for run in runs],
                       "peak_gib": max(run["peak_gib"] for run in runs),
                       "launches_per_step": runs[0]["launches_per_step"],
                       "launches": [sum(n[i] for run in runs
                                        for n in run["launches_per_step"])
                                    for i in range(3)],
                       "losses": runs[0]["losses"], "max_loss_diff": diff}
        log(f"  remat_policy {policy:13s}: {out[policy]['ms_per_step']:.2f} "
            f"ms/step (steps 2-{REMAT_STEPS}: "
            f"{', '.join(f'{x:.2f}' for x in ms)}), peak "
            f"{out[policy]['peak_gib']:.2f} GiB, launches a step (fwd, dq, "
            f"dkv) {runs[0]['launches_per_step'][-1]}; losses "
            f"{', '.join(f'{x:.6f}' for x in runs[0]['losses'])}; largest "
            f"difference from 'nothing' {diff:.3e} "
            f"({'bit-equal' if diff == 0 else 'not bit-equal'}) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"remat_policy {policy}: launches or losses "
                               "differ from 'nothing'")
    return out


def _moe_spec(**kw) -> trainer_mod.TrainJobSpec:
    base = dict(model=MOE_TRAIN_MODEL,
                model_kwargs={"num_layers": MOE_TRAIN_LAYERS,
                              "remat_policy": "nothing"},
                dataset="synthetic_lm", batch_size=MOE_TRAIN_BATCH,
                seq_len=MOE_TRAIN_SEQ, learning_rate=MOE_TRAIN_LR,
                loss_impl="chunked", log_every=1, seed=SEED)
    base.update(kw)
    return trainer_mod.TrainJobSpec(**base)


def _moe_trainer(cfg, work: str) -> dict:
    """5e (i): the trainer entry point on Mixtral's widths; each layer's
    dropped share of choices at step 0 read from the route's own keep
    mask (device values, read after the run)."""
    layers = cfg.num_layers
    steps = MOE_TRAIN_WARMUP + MOE_TRAIN_TIMED
    prof_dir = os.path.join(work, "profile")
    spec = _moe_spec(steps=steps, profile={
        "dir": prof_dir, "start_step": MOE_TRAIN_WARMUP - 1, "num_steps": 1})
    path = os.path.join(work, "job.json")
    with open(path, "w") as fh:
        fh.write(spec.to_json())
    drops, real_route = [], moe_mod.route

    def route(*args, **kwargs):
        out = real_route(*args, **kwargs)
        if len(drops) < layers:  # step 0's forward, layer by layer
            drops.append((~out[3]).float().mean())
        return out

    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tap = _StepTap(sys.stdout)
    t0 = time.monotonic()
    moe_mod.route = route
    try:
        with contextlib.redirect_stdout(tap):
            rc = trainer_mod.main(["--spec", path])
    finally:
        moe_mod.route = real_route
    wall = time.monotonic() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or len(tap.steps) != steps:
        raise RuntimeError(f"MoE trainer exited {rc} after "
                           f"{len(tap.steps)} of {steps} steps")
    log(f"  profile of step {MOE_TRAIN_WARMUP} (the last warm-up step):")
    _trace_kernels(prof_dir)
    expect = (2 * layers, layers, layers)
    aux_max = cfg.router_aux_coef * layers * cfg.num_experts
    losses = [rec["loss"] for rec, _ in tap.steps]
    auxes = [rec.get("aux_loss", 0.0) for rec, _ in tap.steps]
    ln_v = math.log(cfg.vocab_size)
    checks = {
        f"launches (fwd, dq, dkv) {expect} a step": all(
            n == expect for _, n in tap.steps),
        "finite losses": all(math.isfinite(x) for x in losses),
        f"first loss within [{ln_v - LOSS0_BELOW:.2f}, "
        f"{ln_v + LOSS0_ABOVE:.2f}]":
        ln_v - LOSS0_BELOW <= losses[0] <= ln_v + LOSS0_ABOVE,
        f"aux_loss in (0, {aux_max:g}] in every line": all(
            0 < a <= aux_max for a in auxes),
    }
    timed = [rec for rec, _ in tap.steps[MOE_TRAIN_WARMUP:]]
    step_s = sum(r["step_time_s"] for r in timed) / len(timed)
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    tok_s = tokens / step_s
    attn_flops = (6 * layers * MOE_TRAIN_BATCH * cfg.num_heads
                  * MOE_TRAIN_SEQ ** 2 * cfg.head_dim)  # causal, fwd + bwd
    mfu = ((6 * cfg.active_params * tokens + attn_flops)
           / step_s / PEAK_BF16_FLOPS)
    dropped = [d.item() for d in drops]
    log(f"  trainer: {steps} steps in {wall:.1f}s (model init included); "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; aux_loss "
        f"{', '.join(f'{x:.6f}' for x in auxes)}")
    log(f"  launches per step (fwd, dq, dkv) "
        f"{sorted({n for _, n in tap.steps})}; run totals {launches}")
    log(f"  timed {len(timed)} steps: {step_s * 1e3:.2f} ms/step, "
        f"{tok_s:.0f} tok/s, MFU by active parameters {mfu:.4f} ((6 * "
        f"{cfg.active_params} * tok + {attn_flops:.4g} attention flops) / "
        f"step / {PEAK_BF16_FLOPS:.3g}); the trainer's own mfu (6 * all "
        f"{cfg.num_params} parameters) {timed[-1]['mfu']:.4f}; peak memory "
        f"{peak / 2**30:.2f} GiB; dropped share of choices at step 0 by "
        f"layer {[round(d, 4) for d in dropped]} (capacity "
        f"{moe_mod.expert_capacity(cfg, MOE_TRAIN_SEQ)} a row and expert); "
        + ", ".join(f"{k} {'OK' if ok else 'FAIL'}"
                    for k, ok in checks.items()))
    if not all(checks.values()):
        raise RuntimeError(f"MoE training through the trainer: {checks}")
    return {"launches": launches, "ms_per_step": step_s * 1e3,
            "tok_s": tok_s, "mfu": mfu, "peak_gib": peak / 2**30,
            "dropped": dropped, "losses": losses, "aux": auxes}


def _moe_loss_and_grads(model, batch, leaves):
    logits, aux = model(batch["inputs"], return_aux=True)
    loss = train_step.cross_entropy_loss(logits, batch["targets"]) + aux
    del logits
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), grads


def _moe_kernel_vs_plain(cfg) -> dict:
    """5e (ii): one step's loss and every gradient through the kernels, the
    plain attention, naive_attention and the forward kernel with the plain
    backward, on the same fp32 masters and batch; phase 5's gates on the
    attention side and on the expert side, and the backward kernels alone
    (see the constants). At most two sets of gradients are on the card."""
    tcfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    model = moe_mod.MoELlama(tcfg, device=DEVICE).init_weights(SEED)
    rng = np.random.default_rng(SEED + 70)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_AGREE_BATCH, MOE_TRAIN_SEQ))).to(DEVICE)
        for k in ("inputs", "targets")}
    names, leaves = zip(*model.named_parameters())
    sides = {"attention, norm and embedding": [
        i for i, n in enumerate(names) if ".mlp." not in n],
        "router and expert": [i for i, n in enumerate(names) if ".mlp." in n]}

    def by_side(grads, refs):
        return {side: _rel_l2s([grads[i] for i in idx],
                               [refs[i] for i in idx])
                for side, idx in sides.items()}

    real = llama_mod.flash_attention
    try:
        k_loss, k_grads = _moe_loss_and_grads(model, batch, leaves)
        llama_mod.flash_attention = _kernel_fwd_plain_bwd
        b_grads = _moe_loss_and_grads(model, batch, leaves)[1]
        b_rel, b_glob = _rel_l2s(k_grads, b_grads)
        del b_grads
        llama_mod.flash_attention = _plain_flash
        p_loss, p_grads = _moe_loss_and_grads(model, batch, leaves)
        k_side = by_side(k_grads, p_grads)
        del k_grads
        llama_mod.flash_attention = _naive_flash
        n_loss, n_grads = _moe_loss_and_grads(model, batch, leaves)
        n_side = by_side(n_grads, p_grads)
    finally:
        llama_mod.flash_attention = real
    del model, p_grads, n_grads, leaves
    _free()
    k_dl, n_dl = abs(k_loss - p_loss), abs(n_loss - p_loss)
    attn = next(iter(sides))
    bwd_bound = BWD_ALONE_VS_NAIVE * n_side[attn][1]
    checks = {"loss": k_dl <= max(LOSS_VS_NAIVE * n_dl,
                                  LOSS_REL_FLOOR * abs(p_loss))}
    log(f"  one step at batch {MOE_AGREE_BATCH} x {MOE_TRAIN_SEQ}: loss "
        f"kernel {k_loss:.6f} plain {p_loss:.6f} naive {n_loss:.6f}")
    for side, idx in sides.items():
        (k_rel, k_glob), (n_rel, n_glob) = k_side[side], n_side[side]
        leaf_bound = GRAD_VS_NAIVE * max(n_rel)
        checks[f"{side} leaves together"] = k_glob <= GRAD_VS_NAIVE * n_glob
        checks[f"each {side} leaf"] = max(k_rel) <= leaf_bound
        worst = max(range(len(idx)), key=lambda j: k_rel[j])
        log(f"  {len(idx)} {side} leaves, gradient rel_l2 vs plain: kernel "
            f"{k_glob:.3e} together, naive {n_glob:.3e} (bound "
            f"{GRAD_VS_NAIVE} x naive); per leaf kernel worst "
            f"{k_rel[worst]:.3e} ({names[idx[worst]]}), naive worst "
            f"{max(n_rel):.3e} (bound {leaf_bound:.3e})"
            + ("" if side == attn else "; per leaf (kernel/naive) "
               + ", ".join(f"{names[i].replace('layers.', 'L')} "
                           f"{k:.3e}/{m:.3e}"
                           for i, k, m in zip(idx, k_rel, n_rel))))
    checks["backward kernels alone"] = b_glob <= bwd_bound
    log(f"  backward kernels alone (kernel fwd + kernel bwd vs kernel fwd + "
        f"plain bwd, the same routing): rel_l2 over all {len(names)} leaves "
        f"{b_glob:.3e}, worst leaf {max(b_rel):.3e} "
        f"({names[max(range(len(names)), key=lambda i: b_rel[i])]}) (bound "
        f"{BWD_ALONE_VS_NAIVE} x naive's on the {attn} leaves = "
        f"{bwd_bound:.3e}); "
        + ", ".join(f"{k} {'OK' if ok else 'FAIL'}"
                    for k, ok in checks.items()))
    if not all(checks.values()):
        raise RuntimeError(f"MoE kernel step disagrees with the plain "
                           f"step: {checks}")
    return {"loss_diff": k_dl,
            "grad_rel_l2": {side: v[1] for side, v in k_side.items()},
            "naive_grad_rel_l2": {side: v[1] for side, v in n_side.items()},
            "bwd_alone_rel_l2": b_glob}


def _moe_route_grads(cfg) -> dict:
    """5e (iii): the routed block's gradients (x, router, the three
    stacks; the Switch term in the loss) through the adjoint gathers
    against the one-hot einsums, fp32 at Mixtral's widths."""
    bcfg = dataclasses.replace(cfg, dtype=torch.float32,
                               param_dtype=torch.float32)
    blk = moe_mod.MoEBlock(bcfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 80)
    blk.draw_weights(gen)
    b, s = MOE_ROUTE_SHAPE
    x = torch.randn(b, s, cfg.hidden_size, generator=gen, device=DEVICE)
    probe = torch.randn(x.shape, generator=gen, device=DEVICE)
    params = [blk.router, blk.w_gate, blk.w_up, blk.w_down]

    def grads(fwd):
        xx = x.clone().requires_grad_(True)
        y, aux = fwd(xx, with_aux=True)
        return torch.autograd.grad((y * probe).sum() + aux, [xx] + params)

    out = {}
    for cf in (cfg.capacity_factor, MOE_DROP_CAPACITY):
        blk.cfg = dataclasses.replace(bcfg, capacity_factor=cf)
        c = moe_mod.expert_capacity(blk.cfg, s)
        keep = moe_mod.route(x, blk.router, cfg.experts_per_token, c)[3]
        rels = [_rel_l2(a, p) for a, p in zip(grads(blk.forward),
                                             grads(blk.forward_plain))]
        out[cf] = {"rel_l2": rels, "dropped": int((~keep).sum()),
                   "choices": keep.numel()}
        log(f"  routed block fp32, {b} x {s} tokens, capacity factor {cf} "
            f"({c} slots; {out[cf]['dropped']} of {keep.numel()} choices "
            f"dropped): gradient rel_l2 vs the one-hot einsums x "
            f"{rels[0]:.3e}, router {rels[1]:.3e}, w_gate {rels[2]:.3e}, "
            f"w_up {rels[3]:.3e}, w_down {rels[4]:.3e} (bound "
            f"{MOE_ROUTE_REL_L2:g}; tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}) "
            f"{'OK' if max(rels) <= MOE_ROUTE_REL_L2 else 'FAIL'}")
    del blk, params, x, probe
    _free()
    if not (all(max(r["rel_l2"]) <= MOE_ROUTE_REL_L2 for r in out.values())
            and out[MOE_DROP_CAPACITY]["dropped"] > 0):
        raise RuntimeError(f"routed block gradients disagree with the "
                           f"one-hot einsums (or nothing dropped): {out}")
    return out


def _moe_lora(cfg) -> dict:
    """5e (iv): spec.lora on the MoE base, one step (base bit-unchanged,
    adapters moved); its SIGKILL and resume runs in 5b-ii."""
    spec = _moe_spec(steps=1, batch_size=MOE_AGREE_BATCH,
                     lora=dict(MOE_LORA))
    before, real_init = {}, trainer_mod.init_train_state

    def init_and_snapshot(model, *args, **kw):
        state = real_init(model, *args, **kw)
        named = dict(model.named_parameters())
        before.update({n: named[n].detach().clone()
                       for n in MOE_FROZEN_CHECK})
        return state

    _free()
    _reset_counts()
    tap = _StepTap(sys.stdout)
    t0 = time.monotonic()
    trainer_mod.init_train_state = init_and_snapshot
    try:
        with contextlib.redirect_stdout(tap):
            trainer = trainer_mod.Trainer(spec)
            trainer.run()
    finally:
        trainer_mod.init_train_state = real_init
    launches = _counts()
    adapters, base = lora_mod.partition(trainer.model)
    named = dict(trainer.model.named_parameters())
    frozen_ok = (all(torch.equal(named[n], before[n]) for n in before)
                 and all(not p.requires_grad and p.grad is None
                         for p in base.values()))
    b_moved = max(p.abs().max().item() for n, p in adapters.items()
                  if n.endswith("_lora_b"))
    aux = tap.steps[0][0].get("aux_loss", 0.0) if tap.steps else 0.0
    del trainer, adapters, base, named, before
    _free()
    log(f"  spec.lora {json.dumps(MOE_LORA)}: one step in "
        f"{time.monotonic() - t0:.1f}s (model init included), launches (fwd, "
        f"dq, dkv) {launches}, aux_loss {aux:.6f}; "
        f"{', '.join(MOE_FROZEN_CHECK)}"
        f" bit-equal before and after, base frozen: "
        f"{'OK' if frozen_ok else 'FAIL'}; largest |B| {b_moved:.3e}")
    if not (frozen_ok and b_moved > 0 and aux > 0
            and launches == (2 * cfg.num_layers, cfg.num_layers,
                             cfg.num_layers)):
        raise RuntimeError("the MoE LoRA step changed the base, left B at "
                           "zero, lost the aux term or missed a kernel")
    return {"launches": launches, "aux_loss": aux, "b_moved": b_moved}


def _mlp_train() -> dict:
    """5e (v): mnist_mlp on mnist_like through the trainer at the JAX
    trainer's test point, an eval at the end."""
    spec = trainer_mod.TrainJobSpec(
        model="mnist_mlp", dataset="mnist_like", steps=MLP_STEPS,
        batch_size=MLP_BATCH, learning_rate=MLP_LR, log_every=1,
        eval_every=MLP_STEPS, eval_batches=2, seed=SEED)
    tap = _StepTap(sys.stdout)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(tap):
        result = trainer_mod.Trainer(spec).run()
    wall = time.monotonic() - t0
    losses = [rec["loss"] for rec, _ in tap.steps]
    head, tail = losses[:5], losses[-5:]
    ok = (len(losses) == MLP_STEPS and all(math.isfinite(x) for x in losses)
          and sum(tail) < sum(head) and len(tap.evals) == 1)
    log(f"  mnist_mlp: {len(losses)} steps in {wall:.1f}s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; mean of the last five "
        f"{sum(tail) / 5:.4f} against the first five {sum(head) / 5:.4f}; "
        f"eval loss {result.get('eval_loss', float('nan')):.4f} accuracy "
        f"{result.get('eval_accuracy', float('nan')):.4f} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("mnist_mlp did not train")
    return {"losses": losses, "eval_loss": result["eval_loss"],
            "eval_accuracy": result["eval_accuracy"]}


def phase_moe_train() -> dict:
    """5e: training the MoE and MLP families (see the constants)."""
    cfg = registry.model_config(MOE_TRAIN_MODEL, num_layers=MOE_TRAIN_LAYERS)
    log(f"  {MOE_TRAIN_MODEL} at {MOE_TRAIN_LAYERS} of its 32 layers: "
        f"{cfg.num_params} parameters ({cfg.active_params} active a token), "
        f"fp32 masters, gradients and both moments "
        f"{16 * cfg.num_params / 1e9:.1f} GB")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_moe_train_",
                            dir=os.path.join(ROOT, "build"))
    seconds, out = {}, {}
    try:
        for key, fn, args in (("i", _moe_trainer, (cfg, work)),
                              ("ii", _moe_kernel_vs_plain, (cfg,)),
                              ("iii", _moe_route_grads, (cfg,)),
                              ("iv", _moe_lora, (cfg,)),
                              ("v", _mlp_train, ())):
            t0 = time.monotonic()
            out[key] = fn(*args)
            seconds[key] = round(time.monotonic() - t0, 1)
            _free()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        _free()
    log(f"  5e seconds by part {json.dumps(seconds)}")
    return {"launches": out["i"]["launches"],
            "lora_launches": out["iv"]["launches"], "seconds": seconds,
            **{k: out[k] for k in ("i", "ii", "iii", "iv", "v")}}


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
    _free()
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
    seconds: dict = {"build": secs}

    def run(name: str, what: str, fn, *args):
        """Log phase `name`, run it, log and keep its seconds."""
        log(f"phase {name}: {what}")
        start = time.monotonic()
        out = fn(*args)
        seconds[name] = round(time.monotonic() - start, 1)
        log(f"  phase {name} took {seconds[name]}s")
        return out

    kern = run("2", "kernels vs plain versions", phase_kernels)
    bwd = run("2b", "backward kernels vs the plain backward", phase_backward)
    gk = _gpu_tests()
    simt = run("2e", "the CUDA-core flash kernels vs the plain versions",
               phase_simt, gk)
    q8 = run("2c", "the W8A8 int8 matmul vs its plain version", phase_qmm)
    w8r = run("2f", "the W8A16 matmul vs its plain version", phase_w8a16, gk)
    ring = run("2d", "ring attention kernels vs plain (all ranks on this "
               "card)", phase_ring)
    floor = run("3", f"{MODEL} forward, kernel vs plain attention",
                phase_model)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    bundle = tempfile.mkdtemp(prefix="chip_smoke_bundle_",
                              dir=os.path.join(ROOT, "build"))
    try:
        flat = run("4", f"serving {MODEL} over HTTP", phase_serving, bundle,
                   floor)
        paged = run("4b", f"paged serving of {MODEL} (KV blocks of "
                    f"{KV_BLOCK_SIZE})", phase_paged, bundle, flat)
        quant = run("4c", f"quantized serving of {MODEL} (int8 weights, "
                    "int8 paged KV)", phase_quant, bundle, flat, paged)
        surface = run("4d", f"the request surface of {MODEL} (streams, the "
                      "OpenAI routes, deadlines, admission, /metrics, a "
                      "version swap)", phase_surface, bundle, flat)
        hf, ml = run("4e", f"Hugging Face checkpoints and PEFT adapters: "
                     f"{MODEL}'s widths at {HF_LAYERS} layers through "
                     "--storage-uri and peft_adapter, then multi-LoRA on the "
                     "full model", lambda: (phase_hf_import(bundle),
                                            phase_multilora(bundle, bundle)))
        prefix = run("4f", f"KV reuse on {MODEL}: the prefix cache flat, "
                     "paged and on an int8 pool, the host tier, /metrics",
                     phase_prefix, bundle, floor)
        spec = run("4g", f"speculative decoding: fp32 exactness, {MODEL} "
                   "with a Llama-3.2-1B-width draft over HTTP, the target "
                   "as its own draft, mixed traffic, int8 weights, /metrics",
                   phase_spec, bundle, floor, gk)
        rolling = run("4h", "the rolling-window cache on Mistral-7B-v0.1's "
                      "config: fp32 exactness, past the window, within it, "
                      "prefix reuse, a spec target, over HTTP",
                      phase_rolling, bundle, floor)
        disagg = run("4i", f"disaggregated roles on {MODEL}: a prefill "
                     "engine ships, a decode engine admits (greedy, "
                     "sampled, int8 pool, self-draft, adapter), the step "
                     "beside a prefill, :prefill and :decode over HTTP",
                     phase_disagg, bundle, floor)
        gemma = run("4j", "the Gemma 1/2/3 and Qwen2 config flags: "
                    "Gemma-7B over HTTP, Gemma-2 past its window, Gemma-3-1B "
                    "within and past it, Qwen2 bf16 and int8 over "
                    "--storage-uri", phase_gemma, bundle, floor, gk)
        fixed = run("4k", "fixed-forward serving: BERT-base over HTTP "
                    "(:predict, /infer, a burst, occlusion :explain), its "
                    "int8 bundle, integrated gradients on mnist_mlp, "
                    "llama_1b's fixed-forward bundle and its int8 form, LoRA "
                    "on int8 projections", phase_fixed, bundle, flat)
        moe = run("4l", "the mixture-of-experts family: Mixtral-8x7B's "
                  "widths in bf16 at 4 layers, mixtral_8x7b whole in int8 "
                  "over HTTP, Qwen1.5-MoE-A2.7B's widths over --storage-uri",
                  phase_moe, bundle, gk)
        gpt2_t5 = run("4m", "GPT-2 and the T5 family: GPT-2-small over "
                      "--storage-uri (fp32, paged, bf16, int8, the odd "
                      "vocab on the W8A16 op), T5-base and Flan-T5-base by "
                      ":generate (fp32, bf16, int8 under sync-debug)",
                      phase_gpt2_t5, bundle, gk)
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    train = run("5", f"training {TRAIN_MODEL} through the trainer",
                phase_training)
    job = run("5b", f"a training job: {TRAIN_MODEL} on packed documents, "
              "eval, profile, checkpoints, SIGKILL and resume (full, and "
              f"spec.lora on {MOE_TRAIN_MODEL}'s widths)",
              phase_job, train)
    lora_run = run("5c", f"LoRA fine-tuning of {LORA_MODEL} through the "
                   f"trainer (spec.lora {json.dumps(LORA)}), merge, serve the "
                   "merged model", phase_lora)
    remat = run("5d", f"the remat policies on {TRAIN_MODEL} at phase 5's "
                "point", phase_remat)
    moe_train = run("5e", f"training the MoE and MLP families: "
                    f"{MOE_TRAIN_MODEL}'s widths at {MOE_TRAIN_LAYERS} layers "
                    "through the trainer, kernel vs plain, the routed "
                    "block's gradients in fp32, one spec.lora step (its "
                    "SIGKILL and resume is 5b-ii's), mnist_mlp on "
                    "mnist_like", phase_moe_train)
    simt_launches = run("6", "attention_impl='auto' where the wgmma kernels "
                        "do not take the config", phase_auto, gk)
    log(f"  phases 2-6 took {time.monotonic() - t0:.1f}s; seconds by phase "
        f"{json.dumps(seconds)}")
    main_row, bmain, qmain, wmain = (kern["main"], bwd["main"], q8["main"],
                                     w8r["main"])
    smain, blora = simt["main"], bwd["lora"]
    remat_launches = [sum(row["launches"][i] for row in remat.values())
                      for i in range(3)]
    simt_by_path = {"auto": simt_launches[0], **gemma["simt_launches"]}
    fwd_launches = {"serving": flat["launches"],
                    "paged_quant_serving": quant["launches"],
                    "request_surface": surface["launches"],
                    "hf_import_serving": hf["launches"],
                    "multilora_serving": ml["launches"],
                    "prefix_cache": prefix["launches"],
                    "speculative_serving": spec["launches"],
                    **rolling["launches"],
                    "disaggregated_serving": disagg["launches"],
                    **gemma["fwd_launches"],
                    **fixed["b1"],
                    **moe["fwd_launches"],
                    "training": train["launches"][0],
                    "packed_training": job["launches"][0],
                    "lora_training": lora_run["launches"][0],
                    "lora_merged_serving": lora_run["serving_launches"][0],
                    "remat_policies": remat_launches[0],
                    "moe_training": moe_train["launches"][0],
                    "moe_lora_training": moe_train["lora_launches"][0]}

    def by_path(i):
        return {"training": train["launches"][i],
                "packed_training": job["launches"][i],
                "lora_training": lora_run["launches"][i],
                "remat_policies": remat_launches[i],
                "moe_training": moe_train["launches"][i],
                "moe_lora_training": moe_train["lora_launches"][i]}

    def lora_shape(key):
        return {"ms_lora_shape": blora[f"{key}_ms"],
                "bound_ms_lora_shape": blora[f"{key}_bound_ms"],
                "library_ms_lora_shape": (blora["fwd_library_ms"]
                                          if key == "fwd"
                                          else blora["library_ms"]),
                "lora_shape": blora["shape"]}
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
        **lora_shape("fwd"),
        "design": KERNEL_DESIGN,
    }, {
        "name": "flash_bwd_dq",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:234",
        "launches": sum(by_path(1).values()),
        "launches_by_path": by_path(1), **lora_shape("dq"),
        "max_abs_err": bwd["worst"]["dq"]["max_abs"],
        "rel_l2_err": bwd["worst"]["dq"]["rel_l2"],
        "ms": bmain["dq_ms"], "bound_ms": bmain["dq_bound_ms"],
        "bound_by": bmain["dq_bound_by"], **bwd_common,
    }, {
        "name": "flash_bwd_dkv",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:285",
        "launches": sum(by_path(2).values()),
        "launches_by_path": by_path(2), **lora_shape("dkv"),
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
        **({"launches_by_path": simt_by_path, "launches_by_kernel": {
            "mma": simt_launches[3] + sum(gemma["simt_launches"].values()),
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
        ("flash_simt_fwd", 135, sum(simt_by_path.values()), "fwd",
         "plain_fwd_ms",
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
        "launches": (quant["w8a16_launches"] + spec["w8a16_launches"]
                     + gemma["w8a16_launches"][0]
                     + sum(n for n, _ in fixed["w8a16"].values())
                     + moe["w8a16_launches"][0]
                     + sum(n for n, _ in
                           gpt2_t5["w8a16_launches"].values())),
        "launches_wgmma": (quant["w8a16_wgmma_launches"]
                           + spec["w8a16_wgmma_launches"]
                           + gemma["w8a16_launches"][1]
                           + sum(n for _, n in fixed["w8a16"].values())
                           + moe["w8a16_launches"][1]
                           + sum(n for _, n in
                                 gpt2_t5["w8a16_launches"].values())),
        "launches_by_path": {
            "paged_quant_serving": quant["w8a16_launches"],
            "speculative_serving": spec["w8a16_launches"],
            "qwen2_int8_serving": gemma["w8a16_launches"][0],
            **{path: n for path, (n, _) in fixed["w8a16"].items()},
            "mixtral_int8_serving": moe["w8a16_launches"][0],
            **{path: n for path, (n, _) in
               gpt2_t5["w8a16_launches"].items()}},
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
        "by_shape_gpt2_t5": gpt2_t5["gpt2"]["odd"] + gpt2_t5["t5_w8a16"],
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
