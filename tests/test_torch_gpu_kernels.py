"""The CUDA kernels (flash attention, the W8A8 int8 matmul, ring attention)
against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import nothing
of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash_attention as tfa
from kubeflow_tpu_torch.ops import quant_matmul as tqm
from kubeflow_tpu_torch.ops import rdma_ring_attention as trr
from kubeflow_tpu_torch.parallel import Mesh

CASES = [
    # id, (B, S, T, H, KH), mask kind, mask kwargs, segments
    ("causal_ragged", (2, 200, 200, 4, 2), "causal", {}, False),
    ("full_s_ne_t", (1, 72, 300, 4, 2), "full", {}, False),
    ("prefix_lm", (1, 200, 200, 4, 1), "prefix_lm", {"prefix": 70}, False),
    ("sliding_window", (1, 200, 200, 4, 2), "sliding_window",
     {"window": 50}, False),
    ("causal_segments", (2, 200, 200, 4, 2), "causal", {}, True),
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


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tfa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(y, y, y)
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


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(100, 384, 200), (64, 128, 128),
                                   (32, 100, 64), (33, 4096, 4096),
                                   (130, 64, 136), (130, 64, 144),
                                   (1, 16, 8)])
def test_int8_matmul_kernel_equals_plain(cuda, m, k, n, out_dtype):
    """The int32 sum is exact in both and the epilogue multiplies in the
    same order, so the kernel equals its plain version bit for bit: on
    shapes staged byte-wise (K % 16 or N % 16 not 0) and through cp.async,
    ragged M and N included."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                         ).to(cuda)
    qw = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)
                          ).to(cuda)
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)
                          ).to(cuda)
    before = tqm.qmm_launches
    got = tqm.int8_matmul(x, qw, sw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tqm.qmm_launches == before + 1
    qx, sx = tqm.quantize_activations(x)
    want = tqm._int8_matmul_plain(qx, sx, qw, sw, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, want)


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
