"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is printed as a result then):
  1. device: require CUDA, print the card, build every kernel from source
     (one nvcc per source, all started together);
  2. kernels: the forward kernel against its plain PyTorch version on the
     card, at the serving shapes, with its time, the plain version's, one
     library call's (a yardstick the port never calls) and its bound;
  2b. backward kernels: dq and dk/dv against the plain backward at the
     phase-2 shapes and the llama_1b training shape, with the same timings;
  3. model: full-width, full-depth llama3_8b logits with attention through
     the kernel against the same weights through the plain version;
  4. serving: a llama3_8b bundle behind the port's HTTP server answering
     concurrent :generate requests; the kernel launch counts show that every
     first-chunk prefill ran through the kernel;
  5. training: llama_1b at full width and depth through the trainer's entry
     point (batch 12, seq 1024, 3 warm-up + 10 timed steps): finite losses,
     the first near ln(V), every step's launches (2 forward per layer under
     remat, one dq, one dk/dv), ms/step, tok/s, MFU, peak memory, the
     data-wait share and a profiler breakdown of one step; then one step
     through the kernels against one through the plain attention (and the
     bf16 naive_attention path) on the same weights and batch, and the loss
     falling over a few steps on one repeated batch.
Then one JSON line of kernel numbers, the card's name and power limit, and
the final {"ok": true, "device": ...} line.

Weights are random, made from a seed. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from kubeflow_tpu_torch.models import llama as llama_mod  # noqa: E402
from kubeflow_tpu_torch.ops import _build  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from kubeflow_tpu_torch.ops.reference import naive_attention  # noqa: E402
from kubeflow_tpu_torch.serve.runtimes import export_for_serving  # noqa: E402
from kubeflow_tpu_torch.serve.server import ModelServer  # noqa: E402
from kubeflow_tpu_torch.train import optim  # noqa: E402
from kubeflow_tpu_torch.train import step as train_step  # noqa: E402
from kubeflow_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from kubeflow_tpu_torch.utils import registry  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain bounds. out: the kernel rounds P to bf16 for P.V and its
# output to bf16 (half an ulp is 2^-8 at |o| in [1, 2)); lse: fp32 sums of
# exact bf16 products in another order.
OUT_TOL, LSE_TOL = 2e-2, 1e-3
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
PROMPT_LENS = (5, 100, 400, 1000, 1900, 3000)
MAX_TOKENS, CHUNK = 32, 16
SEED = 0
MODEL, MODEL_KWARGS, DEVICE = "llama3_8b", {}, "cuda"


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


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    ops_s, mem_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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
        plain_ms = time_ms(lambda: fa._flash_bwd_plain(
            q, k, v, out, lse, do, None, mask, seg), reps=3)
        library_ms = _sdpa_backward_ms(q, k, v, do,
                                       _sdpa_kwargs(mask, seg, s, t, vis))
        name = _case_name(*case)
        log(f"  {name:48s} " + " ".join(
            f"{n} max_abs {e['max_abs']:.3e} (of {e['scale']:.2e}) rel_l2 "
            f"{e['rel_l2']:.3e};" for n, e in errs.items())
            + f" {'OK' if ok else 'FAIL'}")
        log(f"    dq_ms {dq_ms:.4f} (bound {dq_bound:.4f}, {dq_by}) dkv_ms "
            f"{dkv_ms:.4f} (bound {dkv_bound:.4f}, {dkv_by}) delta_ms "
            f"{delta_ms:.4f} fwd_ms {fwd_ms:.4f} plain_bwd_ms "
            f"{plain_ms:.4f} library_bwd_ms {library_ms:.4f}")
        if not ok:
            raise RuntimeError(f"flash backward kernels disagree with the "
                               f"plain version at {name}")
        for n, e in errs.items():
            for key in ("max_abs", "rel_l2"):
                worst[n][key] = max(worst[n][key], e[key])
        rows.append({"shape": name, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
                     "delta_ms": delta_ms, "fwd_ms": fwd_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "dq_bound_ms": dq_bound, "dq_bound_by": dq_by,
                     "dkv_bound_ms": dkv_bound, "dkv_bound_by": dkv_by})
    return {"rows": rows, "main": rows[-1], "worst": worst}


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


def phase_serving() -> int:
    """The port's main path: bundle -> server -> concurrent :generate.
    Returns the kernel launches of the run."""
    cfg = registry.model_config(MODEL, **MODEL_KWARGS)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    bundle = tempfile.mkdtemp(prefix="chip_smoke_bundle_",
                              dir=os.path.join(ROOT, "build"))
    export_for_serving(bundle, model=MODEL, model_kwargs=MODEL_KWARGS,
                       seed=SEED, extra={
        "generative": {"slots": 4, "max_len": 4096, "chunk": CHUNK,
                       "prefill_buckets": [128, 512, 2048]}})
    server = ModelServer()
    t0 = time.monotonic()
    server.load(bundle, name=MODEL, device=DEVICE)
    port = server.start_background(0)
    base = f"http://127.0.0.1:{port}"
    log(f"  server up in {time.monotonic() - t0:.1f}s on port {port}")
    try:
        with urllib.request.urlopen(base + "/v2/health/ready",
                                    timeout=30) as r:
            if json.loads(r.read()) != {"ready": True}:
                raise RuntimeError("server not ready")
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in PROMPT_LENS]
        bodies = [{"input_ids": p, "max_tokens": MAX_TOKENS}
                  for p in prompts]
        bodies[2].update(temperature=0.8, top_k=50)  # one sampled request
        url = f"{base}/v1/models/{MODEL}:generate"
        results: list = [None] * len(bodies)

        def run(i):
            try:
                results[i] = _post(url, bodies[i])
            except Exception as e:  # reported below as a failed request
                results[i] = e

        torch.cuda.reset_peak_memory_stats()
        fa.flash_fwd_launches = 0
        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        # Engine counters of the concurrent batch alone, before the repeat.
        stats = json.loads(urllib.request.urlopen(
            f"{base}/v2/models/{MODEL}", timeout=30).read())["stats"]
        # The longest prompt again, alone: it decodes at the same cache
        # bucket (4096) either way, so greedy ids must repeat exactly.
        again = _post(url, bodies[-1])
        launches = fa.flash_fwd_launches
        for i, res in enumerate(results):
            if not isinstance(res, dict):
                raise RuntimeError(f"request {i} failed: {res!r}")
            ids = res["output_ids"]
            if len(ids) != MAX_TOKENS or not all(
                    0 <= t < cfg.vocab_size for t in ids):
                raise RuntimeError(f"request {i}: bad output ids {ids}")
            log(f"  request {i}: prompt {PROMPT_LENS[i]:5d} tokens, "
                f"{res['num_output_tokens']} out, latency "
                f"{res['latency_s']:.3f}s"
                + (" (temperature 0.8, top_k 50)" if i == 2 else ""))
        if again["output_ids"] != results[-1]["output_ids"]:
            raise RuntimeError("repeated greedy prompt gave other ids")
        prefills = len(bodies) + 1  # each request's first chunk, + repeat
        expect = cfg.num_layers * prefills
        log(f"  6 concurrent requests in {wall:.3f}s; repeat greedy ids "
            f"identical; engine decode {stats['decode_tokens']} tokens in "
            f"{stats['decode_seconds']:.3f}s = "
            f"{stats['decode_tokens'] / stats['decode_seconds']:.1f} tok/s "
            f"(chunk tokens of active rows, slots 4); peak memory "
            f"{peak / 2**30:.2f} GiB")
        steps = stats["decode_dispatches"] * CHUNK
        weights = cfg.num_params * 2  # bf16
        log(f"  decode: {stats['decode_dispatches']} chunks x {CHUNK} steps, "
            f"{stats['decode_seconds'] / steps * 1e3:.2f} ms per 4-row step "
            f"(bound {weights / PEAK_BYTES * 1e3:.2f} ms: bf16 weights read "
            f"once per step); admission and prefill "
            f"{wall - stats['decode_seconds']:.3f}s of the {wall:.3f}s")
        log(f"  flash_fwd launches {launches} (expected {cfg.num_layers} x "
            f"{prefills} first-chunk prefills = {expect})")
        if launches != expect:
            raise RuntimeError("prefill did not go through the kernel")
        return launches
    finally:
        server.stop()
        shutil.rmtree(bundle, ignore_errors=True)


def _counts() -> tuple:
    return (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches)


def _reset_counts() -> None:
    fa.flash_fwd_launches = 0
    fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0


class _StepTap(io.TextIOBase):
    """The trainer's stdout: forwards every line and, at each per-step
    metrics line, records it with the kernel launches since the last."""

    def __init__(self, out):
        self.out, self.buf, self.steps, self.last = out, "", [], _counts()

    def write(self, text):
        self.out.write(text)
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "step" in rec and "event" not in rec:
                now = _counts()
                self.steps.append((rec, tuple(
                    a - b for a, b in zip(now, self.last))))
                self.last = now
        return len(text)

    def flush(self):
        self.out.flush()


def _profile_step(step_fn, state, batch) -> None:
    """Device time of one train step by kernel family (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    families = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
                "matmul (cuBLAS)": 0.0, "other": 0.0}
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    for evt in kernels:
        name = evt.key.lower()
        if "flash_fwd" in name:
            fam = "flash_fwd"
        elif "flash_bwd_dq" in name:
            fam = "flash_bwd_dq"
        elif "flash_bwd_dkv" in name:
            fam = "flash_bwd_dkv"
        elif any(x in name for x in ("gemm", "cutlass", "xmma", "nvjet",
                                     "cublas", "sm90")):
            fam = "matmul (cuBLAS)"
        else:
            fam = "other"
        families[fam] += evt.self_device_time_total / 1e3
    busy = sum(families.values())
    if busy <= 0:
        log("  profiler saw no device time: breakdown not measured")
        return
    log(f"  profiled step: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / (wall * 1e3):.1%}; idle share "
        f"{1 - busy / (wall * 1e3):.1%})")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"    {fam:18s} {ms:9.2f} ms  {ms / busy:6.1%}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for evt in kernels[:8]:
        log(f"    top: {evt.self_device_time_total / 1e3:8.2f} ms "
            f"x{evt.count:<5d} {evt.key[:90]}")


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
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    t0 = time.monotonic()
    log("phase 2: kernels vs plain versions")
    kern = phase_kernels()
    log("phase 2b: backward kernels vs the plain backward")
    bwd = phase_backward()
    log(f"phase 3: {MODEL} forward, kernel vs plain attention")
    phase_model()
    log(f"phase 4: serving {MODEL} over HTTP")
    launches = phase_serving()
    log(f"phase 5: training {TRAIN_MODEL} through the trainer")
    train = phase_training()
    log(f"  phases 2-5 took {time.monotonic() - t0:.1f}s")
    main_row, bmain = kern["main"], bwd["main"]
    fwd_launches = {"serving": launches, "training": train["launches"][0]}
    bwd_common = {"route": "cuda",
                  "source": "kubeflow_tpu_torch/ops/csrc/flash_bwd.cu",
                  "plain_ms": bmain["plain_ms"],
                  "library_ms": bmain["library_ms"],
                  "shape": bmain["shape"]}
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
    }, {
        "name": "flash_bwd_dq",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:234",
        "launches": train["launches"][1],
        "max_abs_err": bwd["worst"]["dq"]["max_abs"],
        "rel_l2_err": bwd["worst"]["dq"]["rel_l2"],
        "ms": bmain["dq_ms"], "bound_ms": bmain["dq_bound_ms"],
        "bound_by": bmain["dq_bound_by"], **bwd_common,
    }, {
        "name": "flash_bwd_dkv",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:285",
        "launches": train["launches"][2],
        "max_abs_err": max(bwd["worst"][n]["max_abs"] for n in ("dk", "dv")),
        "rel_l2_err": max(bwd["worst"][n]["rel_l2"] for n in ("dk", "dv")),
        "ms": bmain["dkv_ms"], "bound_ms": bmain["dkv_bound_ms"],
        "bound_by": bmain["dkv_bound_by"], **bwd_common,
    }]}))
    log(smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
