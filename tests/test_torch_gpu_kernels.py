"""The CUDA kernels (flash attention, the W8A8 int8 matmul, ring attention,
the W8A16 matmul) against their plain versions, on the card, and the
serving engine's depth-2 loop under torch.cuda.set_sync_debug_mode (with
multi-LoRA adapters and the prefix cache too, on GPT-2 as on the Llama),
and a text2text request's one host sync.

These tests need an NVIDIA GPU and skip without one. They import nothing
of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops import quant_matmul as tqm
from kubeflow_tpu_torch.ops import rdma_ring_attention as trr
from kubeflow_tpu_torch.ops import w8a16 as tw8
from kubeflow_tpu_torch.parallel import Mesh

CASES = [
    # id, (B, S, T, H, KH), mask kind, mask kwargs, segments
    ("causal_ragged", (2, 200, 200, 4, 2), "causal", {}, False),
    ("full_s_ne_t", (1, 72, 300, 4, 2), "full", {}, False),
    ("prefix_lm", (1, 200, 200, 4, 1), "prefix_lm", {"prefix": 70}, False),
    ("sliding_window", (1, 200, 200, 4, 2), "sliding_window",
     {"window": 50}, False),
    ("causal_segments", (2, 200, 200, 4, 2), "causal", {}, True),
    # A GQA group of 7, as Qwen2-7B's 28 heads over 4 kv heads.
    ("gqa7_causal", (1, 200, 200, 14, 2), "causal", {}, False),
    # llama_1b's attention (16/8 heads) as its fixed-forward :predict runs
    # it: buckets of 8 rows at the registry's 16 tokens and at 128.
    ("llama1b_b8_s16", (8, 16, 16, 16, 8), "causal", {}, False),
    ("llama1b_b8_s128", (8, 128, 128, 16, 8), "causal", {}, False),
    # llama3_8b's attention (32/8 heads) as :predict on its generative
    # bundle runs it: 2 rows of 16 tokens.
    ("llama3_8b_b2_s16", (2, 16, 16, 32, 8), "causal", {}, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,kind,mkw,segments",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_flash_kernel_matches_plain(cuda, shape, kind, mkw, segments, d):
    """bf16 kernel vs the plain version in fp32 on the same inputs; bounds
    as in chip_smoke.py (bf16 P and output rounding)."""
    b, s, t, h, kh = shape
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    seg = None
    if segments:
        seg = torch.from_numpy(np.cumsum(rng.random((b, s)) < 0.05, axis=1)
                               .astype(np.int32)).to(cuda)
    mask = tfa.MaskSpec(kind, **mkw)
    before = tfa.flash_fwd_launches
    out, lse = tfa.flash_attention_lse(q, k, v, segment_ids=seg, mask=mask)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_launches == before + 1
    ref, ref_lse = tfa._flash_fwd_plain(q.float(), k.float(), v.float(),
                                        mask, seg)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def _fwd_inputs(shape, d, seed, cuda):
    b, s, t, h, kh = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
            .to(cuda, torch.bfloat16)
            for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d))]


def _assert_fwd_matches_plain(q, k, v, mask):
    before = tfa.flash_fwd_launches
    out, lse = tfa.flash_attention_lse(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert tfa.flash_fwd_launches == before + 1
    ref, ref_lse = tfa._flash_fwd_plain(q.float(), k.float(), v.float(), mask)
    assert bool(torch.isfinite(out.float()).all())
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_single_tile(cuda, d):
    """One 128-row q tile against one 128-row kv tile (S = T = 128, full):
    every swizzled box, k-step and accumulator fragment of the wgmma
    mainloop, and no mask, as the plain version."""
    q, k, v = _fwd_inputs((1, 128, 128, 2, 1), d, 10, cuda)
    _assert_fwd_matches_plain(q, k, v, tfa.MaskSpec("full"))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_ragged_t(cuda, d):
    """T = 700 is not a multiple of the 128-row kv tile and S = 200 not of
    the q tile: TMA's zero fill past T and S, the mask at T, rows past S
    never written."""
    q, k, v = _fwd_inputs((2, 200, 700, 4, 2), d, 11, cuda)
    _assert_fwd_matches_plain(q, k, v, tfa.MaskSpec("full"))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 200, 300])
def test_flash_kernel_window_inside_a_tile(cuda, window):
    """Sliding windows whose edge row - col = window cuts through 128-row kv
    tiles, so the first visible tile of a q tile is partly masked and the
    walk starts past 0."""
    q, k, v = _fwd_inputs((1, 640, 640, 4, 2), 128, 12, cuda)
    _assert_fwd_matches_plain(q, k, v,
                              tfa.MaskSpec("sliding_window", window=window))


@pytest.mark.gpu
def test_flash_kernel_heaviest_first_changes_nothing(cuda):
    """The grid runs the last q tile first. Rows 0..127 see only keys
    0..127 under causal masking, so the first q tile of a 17-tile launch
    must equal, bit for bit, a 1-tile launch on the same rows; the whole
    17-tile output stays within the bounds of the plain version."""
    q, k, v = _fwd_inputs((1, 17 * 128, 17 * 128, 4, 2), 128, 13, cuda)
    causal = tfa.MaskSpec("causal")
    out, lse = _assert_fwd_matches_plain(q, k, v, causal)
    head = [x[:, :128].contiguous() for x in (q, k, v)]
    out1, lse1 = _assert_fwd_matches_plain(*head, causal)
    assert torch.equal(out[:, :128], out1)
    assert torch.equal(lse[:, :128], lse1)


def _rel_l2(got, want):
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,kind,mkw,segments",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_flash_backward_kernels_match_plain(cuda, shape, kind, mkw, segments,
                                            d):
    """dq and dk/dv kernels (through autograd, with an lse cotangent too)
    vs `_flash_bwd_plain` in fp32 on the same bf16 inputs, saved output
    and lse. Bound: rel-L2 1e-2 per gradient — the kernels round P and dS
    to bf16 for their products and the gradients to bf16 (each ~2^-9
    relative), the plain version rounds only the result."""
    b, s, t, h, kh = shape
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shp).astype(
        np.float32)).to(cuda, torch.bfloat16) for shp in (
        (b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d)))
    g_lse = torch.from_numpy(rng.standard_normal((b, s, h, 1)).astype(
        np.float32)).to(cuda)
    seg = None
    if segments:
        seg = torch.from_numpy(np.cumsum(rng.random((b, s)) < 0.05, axis=1)
                               .astype(np.int32)).to(cuda)
    mask = tfa.MaskSpec(kind, **mkw)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    before = (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches)
    out, lse = tfa.flash_attention_lse(qg, kg, vg, segment_ids=seg,
                                       mask=mask)
    torch.autograd.backward((out, lse), (do, g_lse))
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    want = tfa._flash_bwd_plain(q.float(), k.float(), v.float(),
                                out.detach(), lse.detach(), do.float(),
                                g_lse, mask, seg)
    for name, got, ref in zip(("dq", "dk", "dv"),
                              (qg.grad, kg.grad, vg.grad), want):
        assert got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all()), name
        assert _rel_l2(got, ref) <= 1e-2, (name, _rel_l2(got, ref))


def _bwd_inputs(shape, d, seed, cuda):
    """bf16 q, k, v, dO of (B, S, T, H, KH) at head dim d, from numpy."""
    b, s, t, h, kh = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
            .to(cuda, torch.bfloat16)
            for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                        (b, s, h, d))]


def _assert_bwd_matches_plain(q, k, v, do, mask):
    """Forward kernel, then dq and dk/dv through autograd (one launch each)
    against `_flash_bwd_plain` in fp32 on the same inputs, saved output and
    lse: rel-L2 <= 1e-2 per gradient, as test_flash_backward_kernels_match_
    plain. Returns the gradients and the saved (out, lse)."""
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    before = (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches)
    out = tfa.flash_attention(qg, kg, vg, mask=mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    _, lse = tfa._flash_fwd_cuda(q, k, v, mask)
    want = tfa._flash_bwd_plain(q.float(), k.float(), v.float(), out.detach(),
                                lse, do.float(), None, mask)
    got = (qg.grad, kg.grad, vg.grad)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), name
        assert _rel_l2(g, r) <= 1e-2, (name, _rel_l2(g, r))
    return got, (out.detach(), lse)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["full", "causal"])
def test_flash_backward_single_tile(cuda, d, kind):
    """S = T = 64: one streamed 64-row tile in either pass (dq: one kv
    tile; dk/dv: one q tile), inside one 128-row job whose second consumer
    warpgroup holds only zero-filled rows past S and T."""
    q, k, v, do = _bwd_inputs((1, 64, 64, 2, 1), d, 20, cuda)
    _assert_bwd_matches_plain(q, k, v, do, tfa.MaskSpec(kind))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,kind", [
    ((2, 200, 700, 4, 2), "full"),    # S, T multiples of neither 64 nor 128
    ((1, 333, 333, 4, 2), "causal"),
    ((1, 130, 390, 2, 1), "full"),    # one row past a q job, 6 rows past kv
])
def test_flash_backward_ragged(cuda, d, shape, kind):
    """Ragged S and T: TMA's zero fill past S and T, P selected to 0 for
    the padded q columns of dk/dv (their lse is never read), rows past S or
    T never written."""
    q, k, v, do = _bwd_inputs(shape, d, 21, cuda)
    _assert_bwd_matches_plain(q, k, v, do, tfa.MaskSpec(kind))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [3, 20, 50])
def test_flash_backward_window_narrower_than_a_tile(cuda, window):
    """A window narrower than one 64-row tile: every visible tile of either
    walk crosses the band's edges, and each kv row's q interval [kv, kv +
    window - 1] ends inside a q tile. (Not window 1: a row that sees only
    itself has P = 1 and O = V, so dS = dP - delta is rounding noise of
    either version and its rel-L2 says nothing.)"""
    q, k, v, do = _bwd_inputs((1, 640, 640, 4, 2), 128, 22, cuda)
    _assert_bwd_matches_plain(q, k, v, do,
                              tfa.MaskSpec("sliding_window", window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_window_of_one(cuda, d):
    """Window 1: each row sees only itself, so P = 1, O = V, and dV = Pᵀ dO
    is dO summed over the GQA group: held by rel-L2 <= 1e-2. dS = dP - delta
    is then the difference of two fp32 sums of the same D exact bf16
    products (dO·V in the kernel, dO·O in delta), at most 2·D·2^-24·Σ|dO_i
    V_i| per row; a wrong mask (a second visible column, or none) makes it
    of the order of |dO||V|. So dq and dk are held absolutely, each version
    within that bound: |dq - dq_plain| <= 2·N·max|K|·scale and |dk - dk_
    plain| <= 2·G·N·max|Q|·scale, N the largest row's bound, G the group."""
    b, s, h, kh = 1, 640, 4, 2
    q, k, v, do = _bwd_inputs((b, s, s, h, kh), d, 26, cuda)
    mask = tfa.MaskSpec("sliding_window", window=1)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qg, kg, vg, mask=mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), v.repeat_interleave(h // kh, dim=2))
    _, lse = tfa._flash_fwd_cuda(q, k, v, mask)
    dq_ref, dk_ref, dv_ref = tfa._flash_bwd_plain(
        q.float(), k.float(), v.float(), out.detach(), lse, do.float(), None,
        mask)
    assert _rel_l2(vg.grad, dv_ref) <= 1e-2
    v_rows = v.float().repeat_interleave(h // kh, dim=2)
    row_sums = (do.float().abs() * v_rows.abs()).sum(-1)      # [B, S, H]
    noise = 2 * d * 2.0 ** -24 * row_sums.max().item()
    scale = 1.0 / math.sqrt(d)
    dq_bound = 2 * noise * k.float().abs().max().item() * scale
    dk_bound = 2 * (h // kh) * noise * q.float().abs().max().item() * scale
    assert (qg.grad.float() - dq_ref).abs().max().item() <= dq_bound
    assert (kg.grad.float() - dk_ref).abs().max().item() <= dk_bound


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_gqa_group_of_four(cuda, d):
    """H 8 over KH 2: each dk/dv job walks the q tiles of four q heads in
    turn and sums them without atomics; dq reads the kv head h // 4."""
    q, k, v, do = _bwd_inputs((2, 500, 500, 8, 2), d, 23, cuda)
    _assert_bwd_matches_plain(q, k, v, do, tfa.MaskSpec("causal"))


@pytest.mark.gpu
def test_flash_backward_job_order_changes_nothing(cuda):
    """The persistent grids take dq's last q tile and dk/dv's first kv tile
    first. Under causal masking dq of rows 0..127 needs only rows 0..127 and
    dk/dv of the last 128 kv rows only the last 128 q rows, so a 17-tile
    launch must give, bit for bit, what 1-tile launches on those rows give
    (the same lse and delta, sliced); the whole gradients stay within the
    bounds of the plain version."""
    n = 17 * 128
    q, k, v, do = _bwd_inputs((1, n, n, 4, 2), 128, 24, cuda)
    causal = tfa.MaskSpec("causal")
    (dq, dk, dv), (out, lse) = _assert_bwd_matches_plain(q, k, v, do, causal)
    delta = tfa._bwd_delta(do, out, None)

    def rows(x, sl):
        return x[:, sl].contiguous()

    head, tail = slice(0, 128), slice(n - 128, n)
    dq1 = tfa._flash_bwd_dq_cuda(*(rows(x, head) for x in (q, k, v, do, lse,
                                                           delta)), causal)
    dk1, dv1 = tfa._flash_bwd_dkv_cuda(
        *(rows(x, tail) for x in (q, k, v, do, lse, delta)), causal)
    torch.cuda.synchronize()
    assert torch.equal(dq[:, head], dq1)
    assert torch.equal(dk[:, tail], dk1)
    assert torch.equal(dv[:, tail], dv1)


def _entry(symbol):
    from kubeflow_tpu_torch.ops import _build

    return _build.function("flash_bwd.cu", symbol)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_padded_rows_never_written(cuda, d):
    """Called through the C entry points with output buffers longer than S
    (dq) and T (dk, dv), filled with NaN: the rows past S and T stay NaN
    (the kernels never write a padded row), the rest equals the wrappers'
    result bit for bit."""
    b, s, t, h, kh = 1, 200, 150, 4, 2
    q, k, v, do = _bwd_inputs((b, s, t, h, kh), d, 25, cuda)
    mask = tfa.MaskSpec("full")
    out, lse = tfa._flash_fwd_cuda(q, k, v, mask)
    delta = tfa._bwd_delta(do, out, None)
    want_dq = tfa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask)
    want_dk, want_dv = tfa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask)
    pad = 128
    dq = torch.full((b, s + pad, h, d), float("nan"), device=cuda,
                    dtype=torch.bfloat16)
    dk, dv = (torch.full((b, t + pad, kh, d), float("nan"), device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream
    common = (b, s, t, h, kh, d, 1, 0, 0, 1.0 / math.sqrt(d), stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None)
    assert _entry("tpk_flash_bwd_dq")(*ins, dq.data_ptr(), *common) == 0
    assert _entry("tpk_flash_bwd_dkv")(*ins, dk.data_ptr(), dv.data_ptr(),
                                       *common) == 0
    torch.cuda.synchronize()
    assert torch.equal(dq[:, :s], want_dq)
    assert torch.equal(dk[:, :t], want_dk)
    assert torch.equal(dv[:, :t], want_dv)
    assert bool(torch.isnan(dq[:, s:].float()).all())
    assert bool(torch.isnan(dk[:, t:].float()).all())
    assert bool(torch.isnan(dv[:, t:].float()).all())


# The kernels of csrc/flash_simt.cu against the plain versions, on the same
# inputs widened to fp32. The CUDA-core kernels compute in fp32 and round
# only their outputs to the input dtype; the tensor-core forward (bf16/fp16)
# also rounds P to the input dtype for P.V, as the wgmma forward does.
# Bounds per dtype: out (max abs) and lse (max abs), then the gradients'
# rel-L2. fp32: summation order only (~1e-6). bf16 and fp16: half an ulp of
# |out| <= 4 (2^-7 and 2^-10) plus P's rounding (2^-9 and 2^-11 of |v|),
# and the gradients' rounding (~2^-9 relative), as for the wgmma kernels.
SIMT_TOL = {torch.float32: (1e-4, 1e-4, 1e-5),
            torch.bfloat16: (2e-2, 1e-3, 1e-2),
            torch.float16: (4e-3, 1e-3, 1e-2)}


def _simt_counts():
    return (tfa.flash_simt_fwd_launches, tfa.flash_simt_bwd_dq_launches,
            tfa.flash_simt_bwd_dkv_launches)


# (dtype, head dim) pairs the wgmma kernels do not take.
SIMT_PAIRS = [(dt, d) for dt in (torch.float32, torch.bfloat16, torch.float16)
              for d in (16, 40, 128, 256)
              if not (dt == torch.bfloat16 and d == 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", SIMT_PAIRS,
                         ids=[f"{str(dt)[6:]}-D{d}" for dt, d in SIMT_PAIRS])
@pytest.mark.parametrize("shape,kind,mkw,segments",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_simt_kernels_match_plain(cuda, shape, kind, mkw, segments, d,
                                  dtype):
    """flash_attention on inputs the wgmma kernels do not take (any dtype
    at head_dim 16, 40 or 256; fp32 or fp16 at 128) runs the forward of
    flash_simt.cu (the tensor-core kernel for bf16/fp16, the CUDA-core one
    for fp32: the mma counter says which), and its backward the CUDA-core
    dq and dk/dv kernels, once each; all agree with the plain versions.
    Head dim 40 pads to the 48 bucket of the tensor-core kernel and is no
    multiple of the CUDA-core kernel's 16-thread column groups; T = 300
    against S = 72 and S = 200 leave ragged 16-row and 32-row tiles."""
    b, s, t, h, kh = shape
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shp)
                                    .astype(np.float32)).to(cuda, dtype)
                   for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                               (b, s, h, d)))
    seg = None
    if segments:
        seg = torch.from_numpy(np.cumsum(rng.random((b, s)) < 0.05, axis=1)
                               .astype(np.int32)).to(cuda)
    mask = tfa.MaskSpec(kind, **mkw)
    out_tol, lse_tol, grad_tol = SIMT_TOL[dtype]
    before = _simt_counts()
    mma_before = tfa.flash_simt_fwd_mma_launches
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_lse(qg, kg, vg, segment_ids=seg,
                                       mask=mask)
    out.backward(do)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_simt_counts(), before)) == (1, 1, 1)
    assert tfa.flash_simt_fwd_mma_launches - mma_before == int(
        dtype != torch.float32)
    ref, ref_lse = tfa._flash_fwd_plain(q.float(), k.float(), v.float(),
                                        mask, seg)
    assert out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all())
    assert (out.float() - ref).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol
    want = tfa._flash_bwd_plain(q.float(), k.float(), v.float(),
                                out.detach(), lse.detach(), do.float(), None,
                                mask, seg)
    for name, g, r in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                          want):
        assert g.dtype == dtype
        assert _rel_l2(g, r) <= grad_tol, (name, _rel_l2(g, r))


def _seg_ids(b, s, seed, cuda):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.cumsum(rng.random((b, s)) < 0.05, axis=1)
                            .astype(np.int32)).to(cuda)


def _assert_simt_fwd_matches_plain(q, k, v, mask, seg=None, plan=None):
    """One forward of flash_simt.cu (at `plan`, default the plan's) against
    the plain version at SIMT_TOL; returns the kernel that ran."""
    before = tfa.flash_simt_fwd_mma_launches
    out, lse = tfa._flash_simt_fwd_cuda(q, k, v, mask, seg, plan=plan)
    torch.cuda.synchronize()
    ran = "mma" if tfa.flash_simt_fwd_mma_launches > before else "simt"
    ref, ref_lse = tfa._flash_fwd_plain(q.float(), k.float(), v.float(),
                                        mask, seg)
    out_tol, lse_tol, _ = SIMT_TOL[q.dtype]
    assert out.dtype == q.dtype
    assert bool(torch.isfinite(out.float()).all())
    assert (out.float() - ref).abs().max().item() <= out_tol, ran
    assert (lse - ref_lse).abs().max().item() <= lse_tol, ran
    return ran


# The tensor-core forward at head dims the wgmma kernels refuse (80, 96 and
# Gemma's 256: the 80, 96 and 256 buckets), ragged S and T (37 against 200,
# both ways: partial q blocks, kv tiles past T), GQA groups of 4 (one of
# them over a single kv head), a window narrower than a tile and segments.
MMA_CASES = [
    ("s37_t200_full", (1, 37, 200, 8, 2), "full", {}, False),
    ("s200_t37_causal", (2, 200, 37, 8, 2), "causal", {}, False),
    ("gqa4_window", (1, 200, 200, 8, 2), "sliding_window", {"window": 50},
     False),
    ("gqa4_segments", (2, 200, 200, 8, 2), "causal", {}, True),
    # One kv head under a group of 4, as Gemma-3-1B's.
    ("gqa4_one_kv_head", (1, 200, 200, 4, 1), "causal", {}, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
@pytest.mark.parametrize("d", [80, 96, 256])
@pytest.mark.parametrize("shape,kind,mkw,segments",
                         [c[1:] for c in MMA_CASES],
                         ids=[c[0] for c in MMA_CASES])
def test_simt_tensor_core_forward_matches_plain(cuda, shape, kind, mkw,
                                                segments, d, dtype):
    b, s, t, h, kh = shape
    q, k, v, _ = _simt_inputs(shape, d, dtype, d + 1, cuda)
    seg = _seg_ids(b, s, d + 2, cuda) if segments else None
    assert _assert_simt_fwd_matches_plain(
        q, k, v, tfa.MaskSpec(kind, **mkw), seg) == "mma"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 40),
                                     (torch.float16, 256)],
                         ids=["bfloat16-D40", "float16-D256"])
@pytest.mark.parametrize("rows", tfa.SIMT_MMA_ROWS)
def test_simt_tensor_core_forward_at_every_rows_choice(cuda, rows, dtype, d):
    """1, 2, 4 and 8 warps a CTA (a warp's rows past S compute nothing)."""
    shape = (2, 200, 200, 4, 2)
    q, k, v, _ = _simt_inputs(shape, d, dtype, 35, cuda)
    plan = dataclasses.replace(tfa._simt_fwd_plan(*shape, d, dtype),
                               rows=rows)
    assert _assert_simt_fwd_matches_plain(
        q, k, v, tfa.MaskSpec("causal"), plan=plan) == "mma"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(tfa.SIMT_DTYPES),
                         ids=[str(dt)[6:] for dt in tfa.SIMT_DTYPES])
@pytest.mark.parametrize("d", [16, 40, 128, 256])
@pytest.mark.parametrize("rows", tfa.SIMT_BWD_ROWS)
def test_simt_cuda_core_forward_at_every_dtype(cuda, rows, d, dtype):
    """The CUDA-core forward, which the plan sends only fp32, held at every
    dtype and rows choice (rows capped at 32 above head dim 128, as the
    plan caps them) through a forced plan, with segments."""
    shape = (2, 200, 200, 4, 2)
    rows = min(rows, 64 if d <= 128 else 32)
    q, k, v, _ = _simt_inputs(shape, d, dtype, 36, cuda)
    plan = dataclasses.replace(
        tfa._simt_fwd_plan(*shape, d, dtype, kernel="simt"), rows=rows)
    assert _assert_simt_fwd_matches_plain(
        q, k, v, tfa.MaskSpec("causal"), _seg_ids(2, 200, 37, cuda),
        plan=plan) == "simt"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,kind,kernel", [
    (torch.bfloat16, 256, "causal", "mma"),
    (torch.float16, 80, "sliding_window", "mma"),
    (torch.float32, 128, "causal", "simt"),
    (torch.bfloat16, 40, "prefix_lm", "simt")])
def test_simt_forward_is_deterministic(cuda, dtype, d, kind, kernel):
    """Two launches of either forward give bit-identical out and lse."""
    shape = (2, 200, 200, 8, 2)
    q, k, v, _ = _simt_inputs(shape, d, dtype, 38, cuda)
    mask = tfa.MaskSpec(kind, window=20 if kind == "sliding_window" else 0,
                        prefix=70 if kind == "prefix_lm" else 0)
    plan = tfa._simt_fwd_plan(*shape, d, dtype, kernel=kernel)
    first = tfa._flash_simt_fwd_cuda(q, k, v, mask, plan=plan)
    second = tfa._flash_simt_fwd_cuda(q, k, v, mask, plan=plan)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [(torch.float32, "simt"),
                                          (torch.bfloat16, "mma")])
def test_simt_forward_padded_rows_never_written(cuda, dtype, kernel):
    """Through the C entry point with out and lse longer than S, filled
    with NaN: rows past S stay NaN and the rest equals the wrapper's result
    bit for bit (S 200 leaves a partial row block and, at 16 rows a warp,
    warps with no row)."""
    from kubeflow_tpu_torch.ops import _build

    b, s, t, h, kh, d = 1, 200, 150, 4, 2, 40
    q, k, v, _ = _simt_inputs((b, s, t, h, kh), d, dtype, 39, cuda)
    mask = tfa.MaskSpec("full")
    plan = tfa._simt_fwd_plan(b, s, t, h, kh, d, dtype)
    assert plan.kernel == kernel
    want_out, want_lse = tfa._flash_simt_fwd_cuda(q, k, v, mask)
    pad = 40
    out = torch.full((b, s + pad, h, d), float("nan"), dtype=dtype,
                     device=cuda)
    lse = torch.full((b, s + pad, h, 1), float("nan"), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert _build.function("flash_simt.cu", "tpk_flash_simt_fwd")(
        tfa.SIMT_DTYPES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None, out.data_ptr(), lse.data_ptr(), b, s, t, h, kh, d, 1, 0, 0,
        1.0 / math.sqrt(d), tfa.SIMT_FWD_KERNELS[kernel], plan.rows,
        stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out[:, :s], want_out)
    assert torch.equal(lse[:, :s], want_lse)
    assert bool(torch.isnan(out[:, s:].float()).all())
    assert bool(torch.isnan(lse[:, s:]).all())


@pytest.mark.gpu
def test_simt_backward_padded_rows_never_written(cuda):
    """Through the C entry points with output buffers longer than S (dq)
    and T (dk, dv), filled with NaN: rows past S and T stay NaN and the rest
    equals the wrappers' result bit for bit."""
    from kubeflow_tpu_torch.ops import _build

    b, s, t, h, kh, d = 1, 200, 150, 4, 2, 16
    q, k, v, do = (x.float() for x in _bwd_inputs((b, s, t, h, kh), d, 27,
                                                  cuda))
    mask = tfa.MaskSpec("full")
    out, lse = tfa._flash_simt_fwd_cuda(q, k, v, mask)
    delta = tfa._bwd_delta(do, out, None)
    want_dq = tfa._flash_simt_bwd_dq_cuda(q, k, v, do, lse, delta, mask)
    want_dk, want_dv = tfa._flash_simt_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                    mask)
    pad = 40
    dq = torch.full((b, s + pad, h, d), float("nan"), device=cuda)
    dk, dv = (torch.full((b, t + pad, kh, d), float("nan"), device=cuda)
              for _ in range(2))
    plan = tfa._simt_plan_for(q, k)
    assert plan.splits > 1  # the split path's epilogue writes too
    ws = torch.empty(plan.dkv_ctas * 2 * plan.dkv_rows * 32, device=cuda)
    tickets = torch.zeros(plan.dkv_blocks, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    common = (b, s, t, h, kh, d, 1, 0, 0, 1.0 / math.sqrt(d))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None)
    fn = _build.function
    assert fn("flash_simt.cu", "tpk_flash_simt_bwd_dq")(
        0, *ins, dq.data_ptr(), *common, plan.dq_rows, stream) == 0
    assert fn("flash_simt.cu", "tpk_flash_simt_bwd_dkv")(
        0, *ins, dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
        tickets.data_ptr(), *common, plan.dkv_rows, plan.splits,
        stream) == 0
    torch.cuda.synchronize()
    assert not bool(tickets.any())  # left at zero for the next launch
    assert torch.equal(dq[:, :s], want_dq)
    assert torch.equal(dk[:, :t], want_dk)
    assert torch.equal(dv[:, :t], want_dv)
    assert bool(torch.isnan(dq[:, s:]).all())
    assert bool(torch.isnan(dk[:, t:]).all())
    assert bool(torch.isnan(dv[:, t:]).all())


# Forced grids of the CUDA-core backward, at B2 S200 T200 H4 KH2 causal:
# (dq rows, dk/dv rows, splits). Every rows choice of SIMT_BWD_ROWS, and
# splits of the (GQA head, q tile) walk from 2 to past the walk's length
# (some CTAs then walk nothing and add zero partials).
SIMT_FORCED = [(64, 64, 1), (32, 32, 1), (16, 16, 1), (64, 64, 2),
               (32, 32, 3), (16, 16, 8), (64, 64, 16)]


def _simt_inputs(shape, d, dtype, seed, cuda):
    b, s, t, h, kh = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
            .to(cuda, dtype)
            for shp in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                        (b, s, h, d))]


def _simt_backward(q, k, v, do, mask, seg=None, plan=None):
    out, lse = tfa._flash_simt_fwd_cuda(q, k, v, mask, seg)
    delta = tfa._bwd_delta(do, out, None)
    dq = tfa._flash_simt_bwd_dq_cuda(q, k, v, do, lse, delta, mask, seg,
                                     plan=plan)
    dk, dv = tfa._flash_simt_bwd_dkv_cuda(q, k, v, do, lse, delta, mask, seg,
                                          plan=plan)
    return out, lse, (dq, dk, dv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 40),
                                     (torch.float16, 256)],
                         ids=["float32-D128", "bfloat16-D40", "float16-D256"])
@pytest.mark.parametrize("rows_dq,rows_dkv,splits", SIMT_FORCED,
                         ids=[f"dq{a}-dkv{b}-x{c}" for a, b, c in SIMT_FORCED])
def test_simt_backward_forced_plans_match_plain(cuda, rows_dq, rows_dkv,
                                                splits, dtype, d):
    """dq and dk/dv at every rows choice and split count a plan can name
    (rows capped at 32 above head dim 128, as the plan caps them) agree
    with the plain backward at SIMT_TOL, and leave the tickets at zero."""
    shape = (2, 200, 200, 4, 2)
    cap = 64 if d <= 128 else 32
    base = tfa._simt_bwd_plan(*shape, d, dtype)
    plan = dataclasses.replace(base, dq_rows=min(rows_dq, cap),
                               dkv_rows=min(rows_dkv, cap), splits=splits)
    plan = dataclasses.replace(
        plan, dkv_blocks=shape[0] * shape[4] * -(-shape[2] // plan.dkv_rows))
    q, k, v, do = _simt_inputs(shape, d, dtype, 31, cuda)
    mask = tfa.MaskSpec("causal")
    out, lse, grads = _simt_backward(q, k, v, do, mask, plan=plan)
    torch.cuda.synchronize()
    want = tfa._flash_bwd_plain(q.float(), k.float(), v.float(), out, lse,
                                do.float(), None, mask)
    tol = SIMT_TOL[dtype][2]
    for name, g, r in zip(("dq", "dk", "dv"), grads, want):
        assert _rel_l2(g, r) <= tol, (name, _rel_l2(g, r))
    from kubeflow_tpu_torch.ops.quant_matmul import _tickets_for

    tickets = _tickets_for(q.device, torch.cuda.current_stream().cuda_stream,
                           1)
    assert not bool(tickets.any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,kind,segments", [
    (torch.bfloat16, 16, "causal", False),
    (torch.float32, 128, "sliding_window", False),
    (torch.float32, 64, "causal", True)])
def test_simt_backward_is_deterministic(cuda, dtype, d, kind, segments):
    """Two launches of dq and of dk/dv at a split shape (the plan splits
    dk/dv there) give bit-identical gradients: the last split sums the
    partials in split order, and nothing is added atomically."""
    shape = (2, 96, 96, 4, 2)
    q, k, v, do = _simt_inputs(shape, d, dtype, 33, cuda)
    assert tfa._simt_plan_for(q, k).splits > 1
    seg = None
    if segments:
        rng = np.random.default_rng(34)
        seg = torch.from_numpy(np.cumsum(rng.random((2, 96)) < 0.05, axis=1)
                               .astype(np.int32)).to(cuda)
    mask = tfa.MaskSpec(kind, window=20 if kind == "sliding_window" else 0)
    _, _, first = _simt_backward(q, k, v, do, mask, seg)
    _, _, second = _simt_backward(q, k, v, do, mask, seg)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


# C1: attention_impl="auto" on the card for configs the wgmma kernels do not
# take. The JAX model's auto runs its Pallas kernel there (on the TPU, for
# any dtype and head dim); the port's runs the CUDA-core kernels. Each
# config is held against attention_impl="naive" on the same weights and
# batch: logits by rel-L2, the loss and the grad norm relative to naive's.
# fp32: both paths compute in fp32 (torch's fp32 matmuls stay fp32, no
# TF32), so only summation order differs: 1e-4. bf16: naive rounds scores
# and probabilities to bf16 (as the JAX twin does) and the kernels do not;
# that rounding carried through two layers is ~1e-2 of the logits at most
# (8B's 32 layers give ~2e-2, PERF.md): 2e-2 on the logits, 1e-2 on the
# loss, 5e-2 on the grad norm.
C1_CONFIGS = ("llama_tiny_bf16", "llama_1b_fp32_2l")
C1_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
          torch.bfloat16: (2e-2, 1e-2, 5e-2)}
C1_BATCH, C1_SEQ = 2, 96


def c1_config(name, **kwargs):
    """llama_tiny (head_dim 16) in bf16, or llama_1b's widths (head_dim
    128) in fp32 cut to two layers, with `kwargs` replacing fields."""
    from kubeflow_tpu_torch.models import llama as tl

    cfg = {"llama_tiny_bf16": tl.llama_tiny(),
           "llama_1b_fp32_2l": dataclasses.replace(
               tl.llama_1b(), num_layers=2, dtype=torch.float32,
               param_dtype=torch.float32)}[name]
    return dataclasses.replace(cfg, **kwargs)


def _c1_step(cfg, batch, device):
    """(logits of a prefill into a fresh cache, loss and grad norm of one
    AdamW training step) of a model made from seed 0."""
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.train import optim
    from kubeflow_tpu_torch.train import step as tstep

    model = tl.Llama(cfg, device=device).init_weights(0)
    b, s = batch["inputs"].shape
    cache = tl.init_cache(cfg, b, max_len=2 * s, device=device)
    with torch.no_grad():
        logits, _ = model(batch["inputs"], cache=cache)
    tx = optim.AdamW(1e-3)
    state = tstep.TrainState(step=0, model=model,
                             opt_state=tx.init(list(model.parameters())),
                             tx=tx)
    _, metrics = tstep.make_train_step(model)(state, batch)
    torch.cuda.synchronize(device)
    return logits.float(), float(metrics["loss"]), float(metrics["grad_norm"])


def _launches():
    return (tfa.flash_fwd_launches, tfa.flash_bwd_dq_launches,
            tfa.flash_bwd_dkv_launches) + _simt_counts()


def c1_compare(name, device, seed=30) -> dict:
    """One C1 config under "auto" and under "naive" on `device`: the
    launches "auto" made (wgmma fwd, dq, dk/dv, then CUDA-core fwd, dq,
    dk/dv), the distances and whether each is within C1_TOL."""
    cfg = c1_config(name)
    rng = np.random.default_rng(seed)
    batch = {key: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (C1_BATCH, C1_SEQ))).to(device)
        for key in ("inputs", "targets")}
    before = _launches()
    logits, loss, norm = _c1_step(cfg, batch, device)
    launches = tuple(a - c for a, c in zip(_launches(), before))
    n_logits, n_loss, n_norm = _c1_step(
        dataclasses.replace(cfg, attention_impl="naive"), batch, device)
    tol = C1_TOL[cfg.dtype]
    res = {"dtype": str(cfg.dtype), "head_dim": cfg.head_dim,
           "launches": launches,
           "logits_rel_l2": _rel_l2(logits, n_logits),
           "loss": loss, "loss_naive": n_loss,
           "grad_norm": norm, "grad_norm_naive": n_norm,
           "finite": bool(torch.isfinite(logits).all())}
    res["ok"] = (res["finite"] and res["logits_rel_l2"] <= tol[0]
                 and abs(loss - n_loss) <= tol[1] * abs(n_loss)
                 and abs(norm - n_norm) <= tol[2] * abs(n_norm))
    return res


@pytest.mark.gpu
@pytest.mark.parametrize("name", C1_CONFIGS)
def test_auto_runs_the_simt_kernels_where_wgmma_does_not_take(cuda, name):
    """attention_impl="auto" on the card with head_dim 16 in bf16, or fp32
    at head_dim 128: a prefill and a training step launch the CUDA-core
    forward (once per layer in the prefill and in the step, once more under
    remat) and dq and dk/dv (once per layer), no wgmma kernel, and agree
    with attention_impl="naive"."""
    res = c1_compare(name, cuda)
    cfg = c1_config(name)
    layers = cfg.num_layers
    assert res["launches"] == (0, 0, 0, layers * (2 + int(cfg.remat)),
                               layers, layers), res
    assert res["ok"], res


@pytest.mark.gpu
def test_explicit_flash_on_fp32_runs_the_simt_kernels(cuda):
    """No fallback hides a kernel: an explicit "flash" on an fp32 model
    runs the CUDA-core kernels, the same launches and logits as "auto"."""
    from kubeflow_tpu_torch.models import llama as tl

    tokens = torch.from_numpy(np.random.default_rng(32).integers(
        0, 512, (1, 64))).to(cuda)
    logits = {}
    for impl in ("auto", "flash"):
        cfg = c1_config("llama_1b_fp32_2l", attention_impl=impl)
        model = tl.Llama(cfg, device=cuda).init_weights(0)
        before = _launches()
        with torch.no_grad():
            logits[impl] = model(tokens)
        torch.cuda.synchronize()
        assert tuple(a - c for a, c in zip(_launches(), before)) == (
            0, 0, 0, 2, 0, 0)
    assert torch.equal(logits["auto"], logits["flash"])


@pytest.mark.gpu
def test_auto_refuses_what_no_kernel_takes(cuda):
    """head_dim 512 has no CUDA kernel: "auto" raises on the card, naming
    the limit, rather than running naive in the kernel's place."""
    from kubeflow_tpu_torch.models import llama as tl

    cfg = c1_config("llama_tiny_bf16", head_dim=512)
    model = tl.Llama(cfg, device=cuda).init_weights(0)
    with pytest.raises(ValueError, match="no flash kernel takes"):
        with torch.no_grad():
            model(torch.zeros(1, 16, dtype=torch.long, device=cuda))


@pytest.mark.gpu
def test_auto_still_takes_the_kernels_in_bf16(cuda):
    """A bf16 model at head_dim 128 under auto: one forward kernel launch
    per layer in a prefill, and one of each backward kernel per layer in a
    training step (remat off)."""
    from kubeflow_tpu_torch.models import llama as tl

    cfg = dataclasses.replace(tl.llama_1b(), num_layers=2, remat=False)
    rng = np.random.default_rng(31)
    batch = {key: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96)))
             .to(cuda) for key in ("inputs", "targets")}
    before = _launches()
    logits, loss, _ = _c1_step(cfg, batch, cuda)
    # Prefill 2, the step's forward 2, its backward 2 + 2; no CUDA-core
    # launch.
    assert tuple(a - c for a, c in zip(_launches(), before)) == (
        4, 2, 2, 0, 0, 0)
    assert bool(torch.isfinite(logits).all()) and np.isfinite(loss)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    """The wgmma wrappers refuse what they do not take (fp32 and head_dim
    32 go to the CUDA-core kernels instead); flash_attention refuses what
    no kernel takes."""
    x = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfa._flash_fwd_cuda(x, x, x, tfa.MaskSpec("causal"))
    y = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._flash_fwd_cuda(y, y, y, tfa.MaskSpec("causal"))
    for bad in (x.double(), torch.zeros(1, 8, 2, 512, device=cuda,
                                        dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="no CUDA flash kernel takes"):
            tfa.flash_attention(bad, bad, bad)
    z = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(z.transpose(1, 2), z.transpose(1, 2),
                            z.transpose(1, 2))
    w = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 8, 2, 1, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfa._flash_bwd_cuda(w, w, w, w, lse, w.float(), None,
                            tfa.MaskSpec("causal"))
    with pytest.raises(ValueError, match="lse"):
        tfa._flash_bwd_cuda(w, w, w, w, lse.double(), w, None,
                            tfa.MaskSpec("causal"))


INT8_CASES = [
    # (m, k, n, codes): the JAX test's shapes and earlier cases
    (100, 384, 200, "random"), (64, 128, 128, "random"),
    (32, 100, 64, "random"), (33, 4096, 4096, "random"),
    (130, 64, 136, "random"), (130, 64, 144, "random"), (1, 16, 8, "random"),
    # every wgmma tile height, and M one past or short of a tile
    *((m, 1024, 512, "random") for m in (1, 8, 31, 33, 255, 257)),
    (32, 4112, 512, "random"),  # K not a multiple of the 128-deep stage
    (48, 512, 4112, "random"),  # N a multiple of 16, not of the 128-wide tile
    (48, 512, 16, "random"),
    (32, 4096, 4096, "random"),  # 32 tiles at decode widths: no split
    (32, 4096, 1024, "random"),  # 8 tiles: split-K, 4 runs
    # every product +-127 * 127: int32 partial sums near 2^28 across splits
    (32, 16384, 512, "extreme"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,codes", INT8_CASES)
def test_int8_matmul_kernel_equals_plain(cuda, m, k, n, codes, out_dtype):
    """The int32 sum is exact in both and the epilogue multiplies in the
    same order, so the kernels equal the plain version bit for bit: the
    byte-wise kernel (K % 16 or N % 16 not 0) and the wgmma kernel at every
    tile height, ragged M, N and K, and split along K. Each shape launches
    the kernel `_qmm_plan` names for it."""
    rng = np.random.default_rng(m + k + n)
    if codes == "extreme":  # x = +-1 quantizes to +-127 exactly
        x = np.where(rng.random((m, k)) < 0.5, -1.0, 1.0)
        qw = np.where(rng.random((1, n)) < 0.5, -127, 127).repeat(k, axis=0)
    else:
        x = rng.standard_normal((m, k))
        qw = rng.integers(-127, 128, (k, n))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    qw = torch.from_numpy(qw.astype(np.int8)).to(cuda)
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)
                          ).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tqm._qmm_plan(m, k, n, sms)
    before = tqm.qmm_launches, tqm.qmm_wgmma_launches
    got = tqm.int8_matmul(x, qw, sw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tqm.qmm_launches == before[0] + 1
    assert tqm.qmm_wgmma_launches == before[1] + (plan.kernel == tqm.WGMMA)
    if (m, k, n) == (32, 4096, 1024) or codes == "extreme":
        assert plan.splits > 1
    qx, sx = tqm.quantize_activations(x)
    want = tqm._int8_matmul_plain(qx, sx, qw, sw, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, want)
    # A second launch on the same stream reuses the split tickets: they
    # were left at zero.
    again = tqm.int8_matmul(x, qw, sw, out_dtype=out_dtype)
    assert torch.equal(again, want)


@pytest.mark.gpu
def test_int8_matmul_misaligned_operand_takes_the_bytewise_kernel(cuda):
    """A view whose base is not 16-byte aligned cannot be a TMA map: the
    byte-wise kernel takes it, and the result is still exact."""
    rng = np.random.default_rng(5)
    qx = torch.empty(32 * 256 + 1, dtype=torch.int8, device=cuda)[1:].view(
        32, 256)  # contiguous, its base one byte past an allocation's
    qx.copy_(torch.from_numpy(rng.integers(-127, 128, (32, 256)).astype(
        np.int8)))
    assert qx.data_ptr() % 16 != 0
    qw = torch.from_numpy(rng.integers(-127, 128, (256, 128)).astype(np.int8)
                          ).to(cuda)
    sx, sw = torch.rand(32, device=cuda), torch.rand(128, device=cuda)
    before = tqm.qmm_launches, tqm.qmm_wgmma_launches
    got = tqm._int8_matmul_cuda(qx, sx, qw, sw)
    torch.cuda.synchronize()
    assert (tqm.qmm_launches, tqm.qmm_wgmma_launches) == (before[0] + 1,
                                                          before[1])
    assert torch.equal(got, tqm._int8_matmul_plain(qx, sx, qw, sw))


@pytest.mark.gpu
def test_int8_matmul_kernel_refuses_what_it_does_not_take(cuda):
    qx = torch.zeros(4, 16, dtype=torch.int8, device=cuda)
    qw = torch.zeros(16, 8, dtype=torch.int8, device=cuda)
    s4, s8 = torch.ones(4, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tqm._int8_matmul_cuda(qx, s4, qw, s8, torch.float16)
    with pytest.raises(TypeError, match="qw"):
        tqm._int8_matmul_cuda(qx, s4, qw.float(), s8)
    with pytest.raises(ValueError, match="contiguous"):
        tqm._int8_matmul_cuda(qx, s4, qw.t().contiguous().t(), s8)


RING_CASES = [
    # id, (n, B, S, H, KH, D)
    ("n4_ragged_gqa_d64", (4, 2, 800, 8, 2, 64)),
    ("n8_mha_d128", (8, 1, 512, 4, 4, 128)),
    ("n2_llama_heads", (2, 1, 2048, 32, 8, 128)),
    ("n8_ragged_d64", (8, 2, 800, 8, 2, 64)),
    # every entry of the per-rank tables (s 128: one job tile a shard)
    ("n16_full_table", (16, 1, 2048, 8, 2, 128)),
    # s 48, less than one streamed tile, with a GQA group of 4
    ("n4_short_shard_gqa4_d128", (4, 1, 192, 16, 4, 128)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [c[1] for c in RING_CASES],
                         ids=[c[0] for c in RING_CASES])
def test_rdma_ring_kernels_match_plain(cuda, shape):
    """The three ring kernels, n launches each, through the op and autograd
    vs `_rdma_fwd_plain` and `_rdma_bwd_plain` in fp32 on the same bf16
    inputs (the backward on the kernel forward's out and lse). Bounds as in
    chip_smoke.py: out 2e-2 and lse 1e-3 max abs, gradients 1e-2 rel-L2 (bf16
    P and dS in the kernels' products, bf16 outputs)."""
    n, b, s, h, kh, d = shape
    rng = np.random.default_rng(n * 1000 + s)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shp).astype(
        np.float32)).to(cuda, torch.bfloat16) for shp in (
        (b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
    mesh = Mesh([cuda] * n, ("seq",))
    out, lse = trr._rdma_fwd_cuda(q, k, v, n)
    ref, ref_lse = trr._rdma_fwd_plain(q.float(), k.float(), v.float(), n)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    before = (trr.rdma_fwd_launches, trr.rdma_bwd_dq_launches,
              trr.rdma_bwd_dkv_launches)
    got = trr.rdma_ring_attention(qg, kg, vg, "seq", mesh)
    got.backward(do)
    torch.cuda.synchronize()
    assert (trr.rdma_fwd_launches, trr.rdma_bwd_dq_launches,
            trr.rdma_bwd_dkv_launches) == tuple(x + n for x in before)
    assert torch.equal(got, out)
    want = trr._rdma_bwd_plain(q.float(), k.float(), v.float(), out, lse,
                               do.float(), n)
    for name, g, r in zip(("dq", "dk", "dv"), (qg.grad, kg.grad, vg.grad),
                          want):
        assert g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), name
        assert _rel_l2(g, r) <= 1e-2, (name, _rel_l2(g, r))


@pytest.mark.gpu
@pytest.mark.parametrize("me", [0, 2, 3])
def test_rdma_ring_backward_is_deterministic(cuda, me):
    """One rank's dq and dk/dv launched twice on the same inputs give the
    same bits: each CTA owns its gradient rows, no atomics. Rank 0's dq and
    rank 3's dk/dv walk only the diagonal shard; rank 2 walks both kinds."""
    n, b, s, h, kh, d = 4, 2, 1024, 8, 2, 128
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shp).astype(
        np.float32)).to(cuda, torch.bfloat16) for shp in (
        (b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
    out, lse = trr._rdma_fwd_cuda(q, k, v, n)
    delta = tfa._bwd_delta(do, out, None)
    shards = [trr._shards(x, n) for x in (q, k, v, do, lse, delta)]
    dq1, dq2 = (trr._dq_rank_cuda(me, *shards) for _ in range(2))
    (dk1, dv1), (dk2, dv2) = (trr._dkv_rank_cuda(me, *shards)
                              for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2)
    assert torch.equal(dk1, dk2)
    assert torch.equal(dv1, dv2)
    assert bool(torch.isfinite(dq1.float()).all())
    assert bool(torch.isfinite(dk1.float()).all())


@pytest.mark.gpu
def test_rdma_ring_single_rank_runs_flash_kernels(cuda):
    q = torch.randn(1, 256, 4, 64, device=cuda, dtype=torch.bfloat16)
    before = (tfa.flash_fwd_launches, trr.rdma_fwd_launches)
    out = trr.rdma_ring_attention(q, q, q, "seq", Mesh([cuda], ("seq",)))
    torch.cuda.synchronize()
    assert (tfa.flash_fwd_launches, trr.rdma_fwd_launches) == (
        before[0] + 1, before[1])
    assert torch.equal(out, tfa.flash_attention(q, q, q, True))


@pytest.mark.gpu
def test_rdma_ring_kernels_refuse_what_they_do_not_take(cuda):
    mesh = Mesh([cuda] * 4, ("seq",))
    x = torch.zeros(1, 256, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        trr.rdma_ring_attention(x, x, x, "seq", mesh)
    y = torch.zeros(1, 256, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        trr.rdma_ring_attention(y, y, y, "seq", mesh)
    z = torch.zeros(1, 256, 2, 64, device=cuda, dtype=torch.bfloat16)
    big = Mesh([cuda] * (2 * trr.MAX_RANKS), ("seq",))
    with pytest.raises(ValueError, match="at most"):
        trr.rdma_ring_attention(z, z, z, "seq", big)
    with pytest.raises(ValueError, match="mesh on"):
        trr.rdma_ring_attention(z.cpu(), z.cpu(), z.cpu(), "seq", mesh)


# -- the W8A16 matmul (ops/w8a16.py over csrc/w8a16.cu) ----------------------

#: llama3_8b's projections as (N, K): q and o, k and v, gate and up, down,
#: then the 128256 x 4096 unembedding.
W8A16_8B = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
            (128256, 4096)]
#: The decode kernel beyond the 8B shapes: every M from 1 to 16 (9: the
#: second 8-row product) at K 4096 + 16 (a last k block of 16) and N 130
#: (a cluster of 8, a ragged row block); M 1, 9 and 16 at N 16383 (runs of
#: 64, 32 and 16 rows, the last ragged) and N 130 with K 64 (one k block)
#: and 4096 + 16, k/v's N 1024 (a cluster of 2) and N 512 (a cluster of 4),
#: in fp16 and bf16, with both epilogues; fp16 at the five 8B shapes; N and
#: K narrower than a TMA box (16 rows, 128 k: zero-filled).
W8A16_DECODE_CASES = (
    [(m, 4096 + 16, 130, torch.bfloat16, m % 2 == 0) for m in range(1, 17)]
    + [(4, 16, 8, torch.bfloat16, False), (9, 4096 + 16, 1, torch.float16, True),
       (1, 48, 40, torch.float16, False)]
    + [(m, k, n, dt, rf) for m in (1, 9, 16)
       for k, n in ((64, 16383), (4096 + 16, 16383), (64, 130), (4096, 1024),
                    (4096, 512))
       for dt, rf in ((torch.float16, False), (torch.bfloat16, True))]
    + [(m, k, n, torch.float16, n == 128256) for m in (4, 9)
       for n, k in W8A16_8B])
#: (M, K, N, dtype, unembedding epilogue): the five 8B shapes at decode
#: widths (M 1, 4, 16: the decode kernel), the four projections at prefill
#: buckets (M 128, 512, 2048: the wgmma kernel, split along K at M 128 and
#: at M 512 N 1024) in bf16 and fp16, the unembedding's epilogue at M 2048,
#: ragged M (17, 37, 200, 2047) at 8B widths and with N 130 (split), odd N
#: (16383 unsplit at 256-row tiles, 131 split), and small shapes with
#: ragged M and N in every dtype, both epilogues (K 100: the CUDA-core
#: kernel in every dtype; M 37 K 256 N 130 and M 200 K 96: wgmma tiles past
#: M, N and K). chip_smoke.py phase 2f runs the same list.
W8A16_CASES = (
    [(m, k, n, torch.bfloat16, n == 128256) for m in (1, 4, 16)
     for n, k in W8A16_8B]
    + [(m, k, n, dt, False) for dt in (torch.bfloat16, torch.float16)
       for m in (128, 512, 2048) for n, k in W8A16_8B[:4]]
    + [(2048, 4096, 128256, torch.bfloat16, True)]
    + [(m, k, n, dt, False) for m in (17, 37, 200, 2047)
       for k, n, dt in ((4096, 4096, torch.bfloat16),
                        (4096, 130, torch.float16))]
    + [(2047, 64, 16383, torch.bfloat16, False),
       (37, 2048, 131, torch.float16, True)]
    + [(m, k, n, dt, rf)
       for dt in (torch.bfloat16, torch.float16, torch.float32)
       for m, k, n in ((3, 64, 72), (13, 128, 200), (37, 256, 130),
                       (200, 96, 64), (5, 100, 48))
       for rf in (False, True)]
    + W8A16_DECODE_CASES
    # BERT-base's int8 projections (q/k/v/o and the pooler K 768 N 768,
    # ffn_in K 768 N 3072, ffn_out K 3072 N 768) at buckets 1 and 32 of
    # 128 tokens.
    + [(m, k, n, torch.bfloat16, False) for m in (128, 4096)
       for n, k in ((768, 768), (3072, 768), (768, 3072))])
#: Kernel vs plain, rel-L2: fp32 sums in another order (fp32 activations);
#: bf16/fp16 add one rounding of the output either side (~2^-9 relative).
W8A16_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3, torch.float16: 4e-3}


def w8a16_case_id(case) -> str:
    m, k, n, dtype, rf = case
    return (f"M{m}_K{k}_N{n}_{str(dtype).split('.')[-1]}"
            + ("_unembed" if rf else ""))


def w8a16_inputs(m, k, n, dtype, gen, dev):
    """Activations N(0, 1) in `dtype`; codes uniform over [-127, 127];
    per-channel scales in [1e-3, 1e-2]."""
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device=dev) * 9e-3 + 1e-3
    return x, q, scale


def w8a16_check(x, q, scale, round_first) -> dict:
    """Two launches of the op against the plain version: each launches a
    kernel once (the wgmma one where the plan names it), the two give the
    same bits, and they sit within
    W8A16_TOL of the plain version by rel-L2. Returns the errors."""
    before = tw8.w8a16_launches, tw8.w8a16_wgmma_launches
    got = tw8.int8_weight_matmul(x, q, scale, round_before_scale=round_first)
    again = tw8.int8_weight_matmul(x, q, scale,
                                   round_before_scale=round_first)
    want = tw8._int8_weight_matmul_plain(x, q, scale, round_first)
    torch.cuda.synchronize()
    m, k = x.shape
    plan = tw8._w8a16_plan(m, k, q.shape[0], x.dtype,
                           x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
                           tw8._sm_count(x.device.index))
    assert tw8.w8a16_launches == before[0] + 2
    assert tw8.w8a16_wgmma_launches == before[1] + 2 * (
        plan.kernel == tw8.WGMMA)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, again), "two launches differ"
    rel = _rel_l2(got.float(), want.float())
    assert rel <= W8A16_TOL[x.dtype], rel
    return {"rel_l2": rel,
            "max_abs": (got.float() - want.float()).abs().max().item()}


@pytest.mark.gpu
@pytest.mark.parametrize("case", W8A16_CASES, ids=w8a16_case_id)
def test_w8a16_kernel_matches_plain(cuda, case):
    m, k, n, dtype, rf = case
    gen = torch.Generator(device=cuda).manual_seed(m * 131 + k + n)
    w8a16_check(*w8a16_inputs(m, k, n, dtype, gen, cuda), rf)


def test_w8a16_decode_cases_reach_every_cluster_size():
    """The decode cases run every cluster size the plan makes (1, 2, 4 and
    8 CTAs, each K split summed through distributed shared memory) on an
    H100's 132 SMs, at real shapes rather than forced plans."""
    sizes = {tw8._w8a16_plan(m, k, n, dt, True, tw8.H100_SMS).splits
             for m, k, n, dt, _ in W8A16_DECODE_CASES if dt != torch.float32}
    assert sizes >= {1, 2, 4, 8}


@pytest.mark.gpu
@pytest.mark.parametrize("splits_n", [14336, 1024, 512, 130])
def test_w8a16_decode_reads_a_weight_written_just_before(cuda, splits_n):
    """The decode kernel may start while the kernel before it finishes
    (programmatic dependent launch) and reads nothing before that kernel's
    writes are visible: codes rewritten in place by the kernel just before
    the call (and activations too) give the plain version's result on the
    new values, at each cluster size."""
    m, k, n = 4, 4096, splits_n
    gen = torch.Generator(device=cuda).manual_seed(n)
    x, q, scale = w8a16_inputs(m, k, n, torch.bfloat16, gen, cuda)
    tw8.int8_weight_matmul(x, q, scale)  # builds the library, warms
    for _ in range(3):
        q.neg_()  # in place, on the stream, right before the launch
        got = tw8.int8_weight_matmul(x, q, scale)
        before = x.clone()
        x.mul_(-1.5)
        again = tw8.int8_weight_matmul(x, q, scale)
        torch.cuda.synchronize()
        for out, xs in ((got, before), (again, x)):
            want = tw8._int8_weight_matmul_plain(xs, q, scale)
            assert _rel_l2(out.float(), want.float()) <= W8A16_TOL[
                torch.bfloat16]


@pytest.mark.gpu
def test_w8a16_decode_enqueues_without_sync_or_scratch(cuda):
    """A decode-width call (k/v at M 4: a cluster of two) makes no host
    sync under torch.cuda.set_sync_debug_mode("error") and allocates
    nothing but its output: no workspace, no ticket."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, q, scale = w8a16_inputs(4, 4096, 1024, torch.bfloat16, gen, cuda)
    assert tw8._w8a16_plan(4, 4096, 1024, torch.bfloat16).splits == 2
    tw8.int8_weight_matmul(x, q, scale)  # builds the library, warms
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tw8.int8_weight_matmul(x, q, scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 1
    torch.cuda.synchronize()
    assert _rel_l2(out.float(), tw8._int8_weight_matmul_plain(
        x, q, scale).float()) <= W8A16_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_w8a16_misaligned_activations_take_the_simt_kernel(cuda):
    """A view starting 2 elements in is not 16-byte aligned: the plan names
    the CUDA-core kernel, and it agrees with the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, q, scale = w8a16_inputs(4, 64 + 2, 96, torch.bfloat16, gen, cuda)
    xv = x.view(-1)[2:2 + 4 * 64].view(4, 64)
    assert tw8._w8a16_plan(4, 64, 96, torch.bfloat16,
                           xv.data_ptr() % 16 == 0).kernel == tw8.SIMT
    w8a16_check(xv, q[:, :64].contiguous(), scale, False)


#: The routed experts' W8A16 shapes (M, K, N): Mixtral-8x7B's gate/up and
#: down at a 4-row decode step (C 1: B rows an expert) and at a registry
#: prefill chunk of 2048 (capacity 640 rows); Qwen1.5-MoE-A2.7B's at M 4
#: and dropless 2048, and its shared expert's sigmoid gate (N 1).
MOE_W8A16_CASES = [(4, 4096, 14336), (4, 14336, 4096), (640, 4096, 14336),
                   (640, 14336, 4096), (4, 2048, 1408), (4, 1408, 2048),
                   (2048, 2048, 1408), (2048, 1408, 2048), (4, 2048, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", MOE_W8A16_CASES,
                         ids=[f"M{m}_K{k}_N{n}" for m, k, n in
                              MOE_W8A16_CASES])
def test_w8a16_moe_expert_shapes(cuda, m, k, n):
    """One expert's projection at the MoE serving shapes, bf16, on one
    expert's slice of a stack of codes (a view at its offset): the kernel
    the plan names against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x, q, scale = w8a16_inputs(m, k, 2 * n, torch.bfloat16, gen, cuda)
    stack = q.view(2, n, k)
    w8a16_check(x, stack[1], scale[n:], False)


@pytest.mark.gpu
def test_moe_int8_experts_match_the_dequantized_block(cuda):
    """A routed block with int8 expert stacks on the card (one W8A16 launch
    per expert and projection) against the same block on the same codes
    dequantized to bf16 (three batched matmuls): within the W8A16 op's
    rounding, the same routing."""
    from kubeflow_tpu_torch.models import moe as tm
    from kubeflow_tpu_torch.serve import quant as tq

    cfg = dataclasses.replace(tm.moe_tiny(), hidden_size=256,
                              intermediate_size=512, num_layers=1,
                              head_dim=64)
    model = tm.causal_lm(cfg, device=cuda).init_weights(3)
    q = tq.quantize_model(model).layers[0].mlp
    deq = tm.MoEBlock(cfg, device=cuda)
    with torch.no_grad():
        deq.router.copy_(q.router)
        for name in ("w_gate", "w_up", "w_down"):
            codes = getattr(q, name)
            getattr(deq, name).copy_((codes.q.float() * codes.scale[
                ..., None]).transpose(1, 2).to(cfg.dtype))
        x = torch.randn(2, 16, 256, device=cuda).to(cfg.dtype)
        before = tw8.w8a16_launches
        got = q(x)
        torch.cuda.synchronize()
        assert tw8.w8a16_launches - before == cfg.num_experts * 3
        want = deq(x)
    assert _rel_l2(got.float(), want.float()) <= 1e-2


@pytest.mark.gpu
def test_w8a16_refuses_what_no_kernel_takes(cuda):
    x = torch.zeros(2, 64, device=cuda, dtype=torch.float64)
    q = torch.zeros(8, 64, device=cuda, dtype=torch.int8)
    scale = torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        tw8.int8_weight_matmul(x, q, scale)
    with pytest.raises(TypeError, match="int8"):
        tw8.int8_weight_matmul(x.bfloat16(), q.float(), scale)
    with pytest.raises(ValueError, match="is on"):
        tw8.int8_weight_matmul(x.bfloat16(), q.cpu(), scale)


# -- the depth-2 engine makes no hidden host sync -----------------------------

def _tiny_engine_model(cuda, int8, moe=False):
    """llama_tiny at 2 layers (or moe_tiny, its routed twin) in bf16 on the
    card, seeded, int8 projections (and expert stacks) with `int8`."""
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.models import moe as tm
    from kubeflow_tpu_torch.serve import quant as tq

    cfg = tm.moe_tiny() if moe else tl.llama_tiny()
    model = tm.causal_lm(dataclasses.replace(cfg, num_layers=2),
                         device=cuda).init_weights(0)
    return tq.quantize_model(model) if int8 else model


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged_int8"])
def test_depth2_engine_runs_under_sync_debug_error(cuda, pool, monkeypatch):
    """Dispatch and admission at depth 2 run with
    torch.cuda.set_sync_debug_mode("error"): a pageable copy, an .item()
    or a synchronising op among them fails the request. Only the fetch's
    event wait (serve/generation.py `_wait`) runs outside it. Then greedy
    ids of one request equal those of a depth-1 engine."""
    _depth2_under_sync_debug(cuda, pool, monkeypatch, moe=False)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged_int8"])
def test_depth2_engine_traced_runs_under_sync_debug_error(cuda, pool,
                                                          monkeypatch):
    """The same with tracing on: the batch-gather, prefill, decode-chunk
    and fetch spans read the host clock only, so they add no host sync
    (a fresh enabled tracer, whatever TPK_TRACE says)."""
    from kubeflow_tpu_torch.utils import obs

    prev = obs.set_tracer(obs.Tracer(capacity=4096, enabled=True))
    try:
        _depth2_under_sync_debug(cuda, pool, monkeypatch, moe=False)
        names = {e["name"] for e in obs.get_tracer().events()}
    finally:
        obs.set_tracer(prev)
    assert {"serve.batch_gather", "serve.prefill", "serve.decode_chunk",
            "serve.fetch"} <= names


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged_int8"])
def test_depth2_moe_engine_runs_under_sync_debug_error(cuda, pool,
                                                       monkeypatch):
    """The same on moe_tiny: the routed block's top-k, slot claims,
    scatter into the capacity buffer and gather back (and, int8, one
    W8A16 launch per expert and projection) make no host sync."""
    from kubeflow_tpu_torch.ops import w8a16 as w8

    before = w8.w8a16_launches
    _depth2_under_sync_debug(cuda, pool, monkeypatch, moe=True)
    if pool == "paged_int8":  # every expert's three projections launched
        assert w8.w8a16_launches - before >= 2 * 4 * 3


def _depth2_under_sync_debug(cuda, pool, monkeypatch, moe=False,
                             model=None, pool_kw=None):
    """`model` (default: `_tiny_engine_model`) served at depth 2 with
    `pool_kw` (default: an int8 paged pool for "paged_int8")."""
    from kubeflow_tpu_torch.serve import generation as tg

    int8 = pool == "paged_int8"
    if model is None:
        model = _tiny_engine_model(cuda, int8, moe)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
    if pool_kw is not None:
        kw.update(pool_kw)
    elif int8:
        kw.update(kv_block_size=8, kv_quant="int8")
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    engine = tg.GenerationEngine(model, pipeline_depth=2, **kw)
    prompts = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40)), [8, 1, 4]]
    bodies = [dict(max_tokens=6), dict(max_tokens=9),
              dict(max_tokens=5), dict(max_tokens=7, temperature=0.8,
                                       top_k=5, top_p=0.9)]
    results = [None] * len(prompts)
    try:
        engine.submit([1, 2, 3], max_tokens=5)  # builds and warms outside
        torch.cuda.synchronize()

        def run(i):
            try:
                results[i] = engine.submit(prompts[i], **bodies[i])
            except Exception as e:  # asserted below
                results[i] = e

        torch.cuda.set_sync_debug_mode("error")
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i, res in enumerate(results):
            assert isinstance(res, dict), f"request {i}: {res}"
            assert len(res["output_ids"]) == bodies[i]["max_tokens"]
        stats = engine.stats_snapshot()
        assert stats["decode_fetch_overlapped"] > 0, stats
        if kw.get("kv_block_size"):
            assert engine.kv_info()["blocks_used"] == 0
        deep = engine.submit(prompts[2], max_tokens=12)["output_ids"]
    finally:
        engine.close()
    sync = tg.GenerationEngine(model, pipeline_depth=1, **kw)
    try:
        assert sync.submit(prompts[2], max_tokens=12)["output_ids"] == deep
    finally:
        sync.close()


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged_w8a16"])
def test_depth2_gpt2_engine_runs_under_sync_debug_error(cuda, pool,
                                                        monkeypatch):
    """The same on GPT-2 (gpt2_tiny's layout at 2 layers, hidden 64, bf16:
    naive attention with positions in every branch, learned positions,
    the tied head); "paged_w8a16" pages the cache and quantizes the
    weights (`quantize_fixed`: the projections and the tied head on the
    W8A16 op)."""
    from kubeflow_tpu_torch.models import gpt2 as tgp
    from kubeflow_tpu_torch.ops import w8a16 as w8
    from kubeflow_tpu_torch.serve import quant as tq

    cfg = dataclasses.replace(tgp.gpt2_tiny(), hidden_size=64,
                              intermediate_size=256, vocab_size=128)
    model = tgp.GPT2(cfg, device=cuda).init_weights(0).eval()
    paged = pool == "paged_w8a16"
    if paged:
        tq.quantize_fixed(model)
    before = w8.w8a16_launches
    _depth2_under_sync_debug(cuda, pool, monkeypatch, model=model,
                             pool_kw={"kv_block_size": 8} if paged else {})
    if paged:  # 6 projections a layer and the head, every step
        assert w8.w8a16_launches - before >= 13


@pytest.mark.gpu
def test_text2text_generate_syncs_once(cuda, monkeypatch):
    """A `Text2TextTorchModel.generate` with
    torch.cuda.set_sync_debug_mode("error"): the upload, the encoder, the
    cross K/V and all `max_tokens` decoder steps (argmax, done mask, EOS
    padding on the device) make no host sync; the one fetch
    (serve/text2text.py `_wait`) runs outside the mode, once a request.
    Its ids equal greedy_generate's on the same padded inputs."""
    from kubeflow_tpu_torch.models import t5 as tt
    from kubeflow_tpu_torch.serve import text2text as t2t

    model = tt.T5(dataclasses.replace(tt.t5_tiny(), dtype="float32"),
                  device=cuda).init_weights(0).eval()
    served = t2t.Text2TextTorchModel("t", model, generation={
        "in_buckets": [8, 16], "max_tokens": 8})
    assert served.load()
    real_wait, waits = t2t._wait, []

    def wait_outside(event):
        waits.append(event)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(t2t, "_wait", wait_outside)
    prompt = [5, 9, 2, 41, 7]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = served.generate({"input_ids": prompt, "max_tokens": 8})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(waits) == 1
    ids = torch.tensor([prompt + [0] * 3], device=cuda)
    mask = torch.tensor([[True] * 5 + [False] * 3], device=cuda)
    toks, n_valid = tt.greedy_generate(model, ids, mask, max_tokens=8)
    assert out["output_ids"] == toks[0, :int(n_valid[0])].tolist()


@pytest.mark.gpu
def test_depth2_stream_runs_under_sync_debug_error(cuda, monkeypatch):
    """A stream through `generate_stream` from the depth-2 engine with
    torch.cuda.set_sync_debug_mode("error"): the token callback, the
    event queue and the incremental detokenization add no host sync (only
    the fetch's event wait runs outside the mode). Its frames join to the
    output, and the ids equal a depth-1 engine's."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _tiny_engine_model(cuda, False)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16),
              tokenizer="bytes")
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    served = tg.GenerativeTorchModel("m", model, generation=kw)
    served.load()
    body = {"text": "hello, world", "max_tokens": 14}
    try:
        served.generate({"input_ids": [1, 2, 3], "max_tokens": 5})  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            events = list(served.generate_stream(dict(body)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert served.engine.stats_snapshot()["decode_fetch_overlapped"] > 0
    finally:
        served.unload()
    done = events[-1]
    assert done["done"] is True and len(events) >= 3
    assert [t for ev in events[:-1] for t in ev["tokens"]] == \
        done["output_ids"]
    assert "".join(ev["text_delta"] for ev in events) == done["text"]
    sync = tg.GenerativeTorchModel("m", model, generation={
        **kw, "pipeline_depth": 1})
    sync.load()
    try:
        assert sync.generate(dict(body))["output_ids"] == done["output_ids"]
    finally:
        sync.unload()


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_depth2_remote_admission_runs_under_sync_debug_error(cuda, kv_quant,
                                                             monkeypatch):
    """A decode-role engine at depth 2 admitting shipments with
    torch.cuda.set_sync_debug_mode("error"): the frame's checks, the
    reservation, the pinned non-blocking imports (a fmt-1 frame encoded at
    import into an int8 pool), the adopted generator state and the shipped
    first token make no hidden host sync; only the fetch's event wait runs
    outside the mode. No prefill chunk runs, the pool drains, and a greedy
    request's ids equal a depth-1 unified engine's."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _tiny_engine_model(cuda, False)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16),
              kv_block_size=8)
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    prompts = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40)), [8, 1, 4]]
    bodies = [dict(max_tokens=6), dict(max_tokens=9), dict(max_tokens=5),
              dict(max_tokens=7, temperature=0.8, top_k=5, top_p=0.9)]
    pre = tg.GenerationEngine(model, role="prefill", seed=5, **kw)
    try:
        ships = [pre.prefill_ship(p, **b)["shipment"]
                 for p, b in zip(prompts, bodies)]
        warm = pre.prefill_ship([1, 2, 3], max_tokens=5)["shipment"]
    finally:
        pre.close()
    engine = tg.GenerationEngine(model, role="decode", pipeline_depth=2,
                                 kv_quant=kv_quant, **kw)
    results = [None] * len(ships)
    try:
        engine.submit_remote(warm)  # builds and warms outside
        torch.cuda.synchronize()

        def run(i):
            try:
                results[i] = engine.submit_remote(ships[i])
            except Exception as e:  # asserted below
                results[i] = e

        torch.cuda.set_sync_debug_mode("error")
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(ships))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i, res in enumerate(results):
            assert isinstance(res, dict), f"request {i}: {res}"
            assert len(res["output_ids"]) == bodies[i]["max_tokens"]
        stats = engine.stats_snapshot()
        assert stats["decode_fetch_overlapped"] > 0, stats
        assert stats["remote_admits"] == len(ships) + 1, stats
        assert stats["prefill_chunks"] == 0, stats
        assert engine.kv_info()["blocks_used"] == 0
        deep = engine.submit_remote(ships[2])["output_ids"]
    finally:
        engine.close()
    sync = tg.GenerationEngine(model, pipeline_depth=1, kv_quant=kv_quant,
                               **kw)
    try:
        assert sync.submit(prompts[2], max_tokens=5)["output_ids"] == deep
    finally:
        sync.close()


# -- speculative decoding on the engine ---------------------------------------

def _spec_tiny_model(cuda):
    """llama_tiny in fp32 (head dim 16: the CUDA-core flash kernel admits):
    fp32 keeps the verify's and the decode step's roundings apart by far
    less than any gap between the top two logits, so greedy ids compare
    exactly."""
    from kubeflow_tpu_torch.models import llama as tl

    return tl.Llama(dataclasses.replace(tl.llama_tiny(), num_layers=2,
                                        dtype=torch.float32,
                                        param_dtype=torch.float32),
                    device=cuda).init_weights(0)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged"])
def test_depth2_spec_engine_runs_under_sync_debug_error(cuda, pool,
                                                        monkeypatch):
    """A spec engine (the target as its own draft) at depth 2 with
    torch.cuda.set_sync_debug_mode("error"): admissions with their draft
    replays, chained spec chunks with their acceptance, and the vanilla
    sub-batch of a top-p row make no hidden host sync; only the fetch's
    event wait runs outside the mode. Then one greedy request's ids equal
    a depth-1 vanilla engine's."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _spec_tiny_model(cuda)
    kw = dict(slots=4, max_len=64, chunk=8, prefill_buckets=(8, 16))
    if pool == "paged":
        kw.update(kv_block_size=8)
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    engine = tg.GenerationEngine(model, pipeline_depth=2,
                                 draft={"model": model, "gamma": 3}, **kw)
    prompts = [[5, 9, 2], [17, 3, 3, 8, 1], list(range(3, 40)), [8, 1, 4]]
    bodies = [dict(max_tokens=20), dict(max_tokens=13),
              dict(max_tokens=9, temperature=0.8),
              dict(max_tokens=7, temperature=0.8, top_p=0.9)]
    results = [None] * len(prompts)
    try:
        engine.submit([1, 2, 3], max_tokens=5)  # builds and warms outside
        torch.cuda.synchronize()

        def run(i):
            try:
                results[i] = engine.submit(prompts[i], **bodies[i])
            except Exception as e:  # asserted below
                results[i] = e

        torch.cuda.set_sync_debug_mode("error")
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i, res in enumerate(results):
            assert isinstance(res, dict), f"request {i}: {res}"
            assert len(res["output_ids"]) == bodies[i]["max_tokens"]
        stats = engine.stats_snapshot()
        assert stats["spec_dispatches"] > 0, stats
        assert stats["decode_dispatches"] > stats["spec_dispatches"], stats
        assert stats["decode_fetch_overlapped"] > 0, stats
        assert stats["spec_accepted"] > 0, stats
        if pool == "paged":
            assert engine.kv_info()["blocks_used"] == 0
        deep = engine.submit(prompts[2], max_tokens=30)["output_ids"]
    finally:
        engine.close()
    sync = tg.GenerationEngine(model, pipeline_depth=1, **kw)
    try:
        assert sync.submit(prompts[2], max_tokens=30)["output_ids"] == deep
    finally:
        sync.close()


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged"])
def test_spec_dispatch_launches_the_same_each_time(cuda, pool):
    """Two spec dispatches over the same bucket, with other tokens,
    positions and temperatures (so other acceptances), dispatch the same
    ops in the same order: nothing in a spec chunk branches on the host on
    its data."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _spec_tiny_model(cuda)
    kw = dict(slots=2, max_len=64, chunk=8, prefill_buckets=(8,))
    if pool == "paged":
        kw.update(kv_block_size=8)
    engine = tg.GenerationEngine(model, draft={"model": model, "gamma": 3},
                                 **kw)
    try:
        fn = engine._spec_decode[64]
        logs = []
        for last, idx, temp in (([5, 7], [3, 9], [0.0, 0.0]),
                                ([11, 2], [20, 1], [0.9, 0.0])):
            args = [torch.tensor(last, device=cuda),
                    torch.tensor(idx, device=cuda),
                    torch.tensor(temp, device=cuda)]
            if pool == "paged":
                # The pools are idle: any blocks serve, the draft's too.
                tables = torch.arange(1, 17, device=cuda).view(2, 8)
                args[:0] = [tables, tables]
            with torch.inference_mode(), OpLog() as log:
                fn(engine._cache, engine._dcache, *args, engine._gen, None)
            torch.cuda.synchronize()
            logs.append(log.ops)
    finally:
        engine.close()
    assert len(logs[0]) > 0 and logs[0] == logs[1]


# -- multi-LoRA on the engine -------------------------------------------------

#: aten ops that one decode chunk (chunk 4, 2 rows, a 64-row bucket, 2
#: layers of llama_tiny) dispatches on an engine without adapters: the
#: count the engine had before it served adapters (tests/
#: test_torch_multilora.py holds the same count on the CPU), so an engine
#: without adapters runs, and launches, exactly what it did.
DECODE_CHUNK_OPS = 964


class OpLog(TorchDispatchMode):
    """Every aten op dispatched inside the mode, by name, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def decode_chunk_ops(engine, adapters=None) -> list:
    """The ops of one call of `engine`'s flat 64-row decode chunk over 2
    rows (ids 5 and 7 at positions 3 and 9, greedy), with adapter ids
    `adapters` gathered outside it, as the engine's dispatch does."""
    dev = engine.device
    rows = None
    if adapters is not None:
        rows = engine._adapter_rows(np.asarray(adapters, np.int64))
    args = [torch.tensor(v, device=dev) for v in ([5, 7], [3, 9])]
    args += [torch.zeros(2, device=dev),
             torch.zeros(2, dtype=torch.long, device=dev),
             torch.ones(2, device=dev)]
    with torch.inference_mode(), OpLog() as log:
        engine._decode[(64, False)](engine._cache, *args, engine._gen, rows)
    return log.ops


def synth_adapters(cfg, root) -> dict:
    """Two synthetic PEFT adapters for `cfg`'s widths: "a" (rank 4, q/v)
    and "b" (rank 8, q/v and the MLP)."""
    from kubeflow_tpu_torch.serve.multilora import write_synthetic_adapter

    return {"a": write_synthetic_adapter(cfg, f"{root}/a", 11, r=4),
            "b": write_synthetic_adapter(cfg, f"{root}/b", 12, r=8,
                                         targets="attn_mlp")}


@pytest.mark.gpu
def test_decode_chunk_without_adapters_dispatches_what_it_did(cuda,
                                                              tmp_path):
    """An engine without adapters dispatches DECODE_CHUNK_OPS ops a
    chunk; with adapters, the chunk adds two bmm (and an add) per adapted
    projection, layer and step, and gathers nothing."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _tiny_engine_model(cuda, False)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
    engine = tg.GenerationEngine(model, **kw)
    try:
        assert len(decode_chunk_ops(engine)) == DECODE_CHUNK_OPS
    finally:
        engine.close()
    engine = tg.GenerationEngine(model, adapters=synth_adapters(
        model.cfg, tmp_path), **kw)
    try:
        ops = decode_chunk_ops(engine, [1, 2])
        steps, layers, projections = 4, model.cfg.num_layers, 5
        assert ops.count("aten.bmm.default") == (2 * projections * layers
                                                 * steps)
        assert "aten.index_select.default" not in ops
    finally:
        engine.close()


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged"])
def test_depth2_engine_with_adapters_runs_under_sync_debug_error(
        cuda, pool, monkeypatch, tmp_path):
    """A mixed batch of base and adapter requests at depth 2 under
    torch.cuda.set_sync_debug_mode("error"): the adapter ids reach the
    device by the pinned copy, and the per-chunk gather makes no host
    sync. Each request's greedy ids equal its lone run on a depth-1
    engine, and base rows equal an engine without adapters."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _tiny_engine_model(cuda, False)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
    if pool == "paged":
        kw.update(kv_block_size=8)
    adapters = synth_adapters(model.cfg, tmp_path)
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    reqs = [([5, 9, 2], None), ([17, 3, 3, 8, 1], "a"),
            (list(range(3, 40)), "b"), ([8, 1, 4], None), ([8, 1, 4], "b")]
    results = [None] * len(reqs)
    engine = tg.GenerationEngine(model, pipeline_depth=2, adapters=adapters,
                                 **kw)
    try:
        engine.submit([1, 2, 3], max_tokens=5, adapter="b")  # warm
        torch.cuda.synchronize()

        def run(i):
            try:
                results[i] = engine.submit(reqs[i][0], max_tokens=9,
                                           adapter=reqs[i][1])
            except Exception as e:  # asserted below
                results[i] = e

        torch.cuda.set_sync_debug_mode("error")
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i, res in enumerate(results):
            assert isinstance(res, dict), f"request {i}: {res}"
        assert engine.stats_snapshot()["decode_fetch_overlapped"] > 0
        assert engine.stats_snapshot()["adapter_requests"] == {"a": 1,
                                                               "b": 3}
    finally:
        engine.close()
    sync = tg.GenerationEngine(model, pipeline_depth=1, adapters=adapters,
                               **kw)
    base = tg.GenerationEngine(model, **kw)
    try:
        for (prompt, ad), res in zip(reqs, results):
            lone = sync.submit(prompt, max_tokens=9, adapter=ad)
            assert lone["output_ids"] == res["output_ids"], (prompt, ad)
            if ad is None:
                assert base.submit(prompt, max_tokens=9)["output_ids"] == \
                    res["output_ids"]
    finally:
        sync.close()
        base.close()


# -- the prefix cache on the engine -------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["flat", "paged", "paged_int8"])
def test_depth2_prefix_cache_runs_under_sync_debug_error(cuda, pool,
                                                         monkeypatch):
    """Hits on a shared head at depth 2 under
    torch.cuda.set_sync_debug_mode("error"): the lookup's clone (flat),
    the block references, the fragment rebuilt from the blocks and the
    copy-on-write fork of a partial tail block (paged) make no host sync.
    Each request's greedy ids equal a depth-1 engine's without the cache
    (an int8 pool's hit attends dequantized rows: its ids are held to the
    same engine's cold run of the request instead)."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _tiny_engine_model(cuda, False)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
    if pool != "flat":
        kw.update(kv_block_size=8)
    if pool == "paged_int8":
        kw.update(kv_quant="int8")
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    head = list(range(3, 19))
    a = head + [40, 41, 42, 43, 44]  # 21 = 2 blocks + a 5-row tail
    # A miss, a hit at a's whole prompt (a CoW fork when paged), then hits
    # at the 16-token boundary.
    prompts = [a, a + [7, 8, 9], head + [50, 51], head + [60] * 12]
    engine = tg.GenerationEngine(model, pipeline_depth=2, prefix_cache=4,
                                 **kw)
    got = []
    try:
        engine.submit([1, 2, 3], max_tokens=5)  # builds and warms outside
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for p in prompts:
                got.append(engine.submit(p, max_tokens=9)["output_ids"])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        stats = engine.stats_snapshot()
        assert (stats["prefix_misses"], stats["prefix_hits"]) == (2, 3)
        assert stats["prefix_hit_tokens"] == len(a) + 16 + 16
        if pool != "flat":
            assert stats["kv_cow_copies"] == 1
            assert stats["prefix_zero_copy_hits"] == 3
            while engine._prefix_lru:
                engine._prefix_evict(next(iter(engine._prefix_lru)))
            assert engine.kv_info()["blocks_used"] == 0
        assert stats["kv_dequant_fallbacks"] == (3 if pool == "paged_int8"
                                                 else 0)
    finally:
        engine.close()
    sync = tg.GenerationEngine(model, pipeline_depth=1, **kw)
    try:
        want = [sync.submit(p, max_tokens=9)["output_ids"] for p in prompts]
    finally:
        sync.close()
    if pool == "paged_int8":
        assert all(len(ids) == 9 for ids in got)
    else:
        assert got == want


@pytest.mark.gpu
def test_decode_chunk_with_prefix_cache_dispatches_what_it_did(cuda):
    """The prefix cache changes admission only: an engine with it (flat)
    dispatches DECODE_CHUNK_OPS ops a decode chunk."""
    from kubeflow_tpu_torch.serve import generation as tg

    model = _tiny_engine_model(cuda, False)
    engine = tg.GenerationEngine(model, slots=2, max_len=64, chunk=4,
                                 prefill_buckets=(8, 16), prefix_cache=4)
    try:
        assert len(decode_chunk_ops(engine)) == DECODE_CHUNK_OPS
    finally:
        engine.close()


# -- the rolling-window cache -------------------------------------------------

def _windowed_tiny(device, window=8):
    """llama_tiny's widths in fp32 with a sliding window of `window`, from
    seed 0."""
    from kubeflow_tpu_torch.models import llama as tl

    cfg = dataclasses.replace(tl.llama_tiny(), dtype=torch.float32,
                              mask_kind="sliding_window", mask_window=window)
    return tl.Llama(cfg, device=device).init_weights(0)


@pytest.mark.gpu
@pytest.mark.parametrize("draft", [False, True], ids=["vanilla", "spec"])
def test_depth2_rolling_engine_runs_under_sync_debug_error(cuda, draft,
                                                           monkeypatch):
    """A rolling engine (window 8 of a 64-token context) at depth 2, alone
    or with a causal draft: admission (padded prefill, continuation chunks
    past the window), decode and the spec revert run with
    torch.cuda.set_sync_debug_mode("error"), only the fetch's event wait
    outside it; then one request's greedy ids equal a depth-1 engine's."""
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.serve import generation as tg

    model = _windowed_tiny(cuda)
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(8, 16))
    if draft:
        dcfg = dataclasses.replace(model.cfg, num_layers=1,
                                   mask_kind="causal", mask_window=0)
        kw["draft"] = {"model": tl.Llama(dcfg, device=cuda).init_weights(5),
                       "gamma": 3}
    real_wait = tg._wait

    def wait_outside(event):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(event)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tg, "_wait", wait_outside)
    engine = tg.GenerationEngine(model, pipeline_depth=2, **kw)
    assert engine._rolling == 8
    prompts = [[5, 9, 2], list(range(3, 30)), [17, 3, 3, 8, 1]]
    results = [None] * len(prompts)
    try:
        engine.submit([1, 2, 3], max_tokens=5)  # builds and warms outside
        torch.cuda.synchronize()

        def run(i):
            try:
                results[i] = engine.submit(prompts[i], max_tokens=12)
            except Exception as e:  # asserted below
                results[i] = e

        torch.cuda.set_sync_debug_mode("error")
        try:
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i, res in enumerate(results):
            assert isinstance(res, dict), f"request {i}: {res}"
            assert len(res["output_ids"]) == 12
        stats = engine.stats_snapshot()
        assert stats["spec_dispatches" if draft
                     else "decode_fetch_overlapped"] > 0, stats
        deep = engine.submit(prompts[1], max_tokens=20)["output_ids"]
    finally:
        engine.close()
    kw.pop("draft", None)
    sync = tg.GenerationEngine(model, pipeline_depth=1, **kw)
    try:
        assert sync.submit(prompts[1], max_tokens=20)["output_ids"] == deep
    finally:
        sync.close()


@pytest.mark.gpu
def test_rolling_engine_ids_equal_the_plain_path(cuda):
    """A small rolling engine's greedy ids on the card equal the same
    engine's on the CPU (the same weights) and the rollout of uncached
    full forwards through naive attention on the card: prompts of 13 and 5
    tokens, 24 ids each, past the window of 8."""
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.serve import generation as tg

    model = _windowed_tiny(cuda)
    cpu = tl.Llama(model.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    naive = tl.config_view(model, dataclasses.replace(
        model.cfg, attention_impl="naive"))
    kw = dict(slots=2, max_len=64, chunk=4, prefill_buckets=(4, 16))
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, 512, n).tolist() for n in (13, 5)]
    got = {}
    for name, m in (("cuda", model), ("cpu", cpu)):
        engine = tg.GenerationEngine(m, **kw)
        try:
            got[name] = [engine.submit(p, max_tokens=24)["output_ids"]
                         for p in prompts]
        finally:
            engine.close()
    want = []
    for p in prompts:
        seq = list(p)
        with torch.no_grad():
            for _ in range(24):
                logits = naive(torch.tensor([seq], device=cuda))
                seq.append(int(logits[0, -1].argmax()))
        want.append(seq[len(p):])
    assert got["cuda"] == got["cpu"] == want


@pytest.mark.gpu
def test_windowed_forward_through_the_kernel_within_the_naive_gate(cuda):
    """A windowed model's full forward (bf16, head_dim 128: flash_fwd.cu
    with mask code 3, window 100 of 512 tokens) launches the kernel once a
    layer, and its logits lie within 1.25x naive_attention's distance from
    the plain version's (phase 3's gate)."""
    from kubeflow_tpu_torch.models import llama as tl
    from kubeflow_tpu_torch.ops.reference import naive_attention

    cfg = dataclasses.replace(tl.llama_1b(), num_layers=2, remat=False,
                              mask_kind="sliding_window", mask_window=100,
                              attention_impl="flash")
    model = tl.Llama(cfg, device=cuda).init_weights(0)
    tokens = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg.vocab_size, (2, 512))).to(cuda)

    def plain(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return tfa._flash_fwd_plain(q, k, v, tfa._norm_mask(causal, mask),
                                    segment_ids)[0]

    def naive(q, k, v, causal=True, block_q=512, block_kv=512,
              segment_ids=None, mask=None):
        return naive_attention(q, k, v, causal=causal, mask=mask,
                               segment_ids=segment_ids)

    real = tl.flash_attention
    with torch.no_grad():
        before = tfa.flash_fwd_launches
        kernel = model(tokens).float()
        torch.cuda.synchronize()
        assert tfa.flash_fwd_launches - before == cfg.num_layers
        try:
            tl.flash_attention = plain
            ref = model(tokens).float()
            tl.flash_attention = naive
            floor = model(tokens).float()
        finally:
            tl.flash_attention = real
    rel, naive_rel = _rel_l2(kernel, ref), _rel_l2(floor, ref)
    assert bool(torch.isfinite(kernel).all())
    assert rel <= 1.25 * naive_rel, (rel, naive_rel)


# -- an MoE training step makes no hidden host sync ----------------------------

@pytest.mark.gpu
def test_moe_train_step_runs_under_sync_debug_error(cuda):
    """One moe_tiny training step (remat "nothing", capacity 0.5 so
    choices drop: the route, the adjoint gathers forward and back, the
    flash kernels, the Switch term, AdamW) with
    torch.cuda.set_sync_debug_mode("error"): no count leaves the card when
    training either. The step's metrics stay device tensors."""
    from kubeflow_tpu_torch.models import moe as tm
    from kubeflow_tpu_torch.train import optim
    from kubeflow_tpu_torch.train import step as tstep

    cfg = dataclasses.replace(tm.moe_tiny(), param_dtype=torch.float32,
                              capacity_factor=0.5, remat=True)
    model = tm.MoELlama(cfg, device=cuda)
    state = tstep.init_train_state(model, optim.AdamW(1e-3), seed=0)
    fn = tstep.make_train_step(model, loss_impl="chunked", loss_chunk=64)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                              device=cuda) for k in ("inputs", "targets")}
    launches = tfa.flash_simt_fwd_launches
    fn(state, batch)  # builds the kernels outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 2
    assert math.isfinite(float(metrics["loss"]))
    assert float(metrics["aux_loss"]) > 0
    assert tfa.flash_simt_fwd_launches - launches == 2 * 2 * 2
