"""Port W8A8 matmul (`ops/quant_matmul.py`) against the JAX op on the CPU:
the JAX `int8_matmul` runs its Pallas kernel in interpret mode, the port's
its plain version (the CUDA kernel is held against that plain version on
the card, in test_torch_gpu_kernels.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.quant_matmul import int8_matmul as jax_int8_matmul
from kubeflow_tpu_torch.ops import quant_matmul as tqm

# The JAX test's shapes (tests/test_quant.py): ragged M, N and K included.
SHAPES = [(100, 384, 200), (64, 128, 128), (32, 100, 64)]


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * np.linspace(0.1, 2.0, n)[None, :]
         ).astype(np.float32)
    sw = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
    qw = np.clip(np.round(w / sw[None, :]), -127, 127).astype(np.int8)
    return x, w, qw, sw


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_activation_codes_equal_jax(m, k, n):
    """The per-row activation quantization outside the kernel: the JAX
    op's expressions (quant_matmul.py) give the same codes and scales."""
    x, _, _, _ = _operands(m, k, n)
    x32 = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(x32), axis=1, keepdims=True),
                     1e-12) / 127.0
    qx = jnp.clip(jnp.round(x32 / sx), -127, 127).astype(jnp.int8)
    tqx, tsx = tqm.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(qx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx)[:, 0])


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_matches_jax(m, k, n, out_dtype):
    """Same int32 sums, same fp32 epilogue in the same order: the outputs
    agree to 1e-6 relative (exact in practice)."""
    x, w, qw, sw = _operands(m, k, n)
    want = np.asarray(jax_int8_matmul(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sw), block_m=64,
        block_n=64, out_dtype=getattr(jnp, out_dtype))).astype(np.float32)
    got = tqm.int8_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                          torch.from_numpy(sw), block_m=64, block_n=64,
                          out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_meets_the_jax_tests_bounds(m, k, n):
    """The JAX test's own bounds: < 0.01 relative to the dequantized
    product, < 0.02 to the full-precision one."""
    x, w, qw, sw = _operands(m, k, n)
    got = tqm.int8_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                          torch.from_numpy(sw)).numpy()
    ref = x @ (qw.astype(np.float32) * sw[None, :])
    assert _rel(got, ref) < 0.01
    assert _rel(got, x @ w) < 0.02


def test_plain_version_sums_exactly():
    """float64 holds every partial sum: the plain version's accumulator is
    the exact integer product, before the epilogue."""
    rng = np.random.default_rng(1)
    qx = rng.integers(-127, 128, (7, 300)).astype(np.int8)
    qw = rng.integers(-127, 128, (300, 5)).astype(np.int8)
    ones = torch.ones(7), torch.ones(5)
    got = tqm._int8_matmul_plain(torch.from_numpy(qx), ones[0],
                                 torch.from_numpy(qw), ones[1])
    exact = qx.astype(np.int64) @ qw.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def test_int8_matmul_shape_validation():
    with pytest.raises(ValueError, match="shape"):
        tqm.int8_matmul(torch.zeros(4, 8), torch.zeros(9, 3, dtype=torch.int8),
                        torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        tqm.int8_matmul(torch.zeros(4, 8), torch.zeros(8, 3, dtype=torch.int8),
                        torch.zeros(4))
    with pytest.raises(ValueError, match="shape"):
        tqm.int8_matmul(torch.zeros(4, 8, 1),
                        torch.zeros(8, 3, dtype=torch.int8), torch.zeros(3))


def test_cpu_tensors_never_launch_the_kernel():
    x, _, qw, sw = _operands(8, 32, 16)
    before = tqm.qmm_launches
    tqm.int8_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                    torch.from_numpy(sw))
    assert tqm.qmm_launches == before


# (M, K, N) for the plan's checks: the 2c and A/B shapes, ragged edges,
# shapes TMA cannot describe, and tiny and huge outputs.
PLAN_SHAPES = [(2048, 4096, 14336), (2048, 14336, 4096), (32, 4096, 14336),
               (32, 4096, 4096), (1, 4096, 14336), (8, 4096, 4096),
               (512, 4096, 14336), (33, 4096, 4096), (257, 1024, 512),
               (32, 4112, 512), (48, 512, 4112), (48, 512, 16),
               (32, 16384, 512), (130, 64, 144), (64, 128, 128),
               (100, 384, 200), (32, 100, 64), (1, 16, 8), (7, 0, 32),
               (32, 4096, 1024), (8, 4096, 2048)]
SM_COUNTS = (132, 114, 8)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_covers_k_m_and_n_exactly(m, k, n, sms):
    """The splits' [k0, k1) runs tile [0, K) with no gap, overlap or empty
    run, each starting on a 128-deep stage; the tiles cover M and N with
    no tile wholly past either."""
    plan = tqm._qmm_plan(m, k, n, sms)
    if plan.kernel == tqm.WGMMA:
        ranges = plan.k_ranges(k)
        assert len(ranges) == plan.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        assert all(k0 < k1 and k0 % 128 == 0 for k0, k1 in ranges)
        assert plan.bm in (32, 64, 128, 256)
        assert plan.bm >= m or plan.bm == 256
    else:
        assert (plan.bm, plan.splits) == (0, 1)
    bm = plan.bm or 128
    assert (plan.m_tiles - 1) * bm < m <= plan.m_tiles * bm
    assert (plan.n_tiles - 1) * 128 < n <= plan.n_tiles * 128


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_splits_only_where_the_tiles_leave_sms_idle(m, k, n, sms):
    """No split where the tiles alone fill the card; never more splits
    than 128-deep stages or than the cap; a split plan puts no more stages
    on the busiest SM than one split would."""
    plan = tqm._qmm_plan(m, k, n, sms)
    if plan.tiles >= sms or plan.kernel == tqm.BYTEWISE:
        assert plan.splits == 1
    n_k = -(-k // 128)
    assert 1 <= plan.splits <= max(1, min(n_k, 16))
    assert plan.splits == 1 or plan.bm <= 64
    if plan.splits > 1:
        # every unit runs at once, and the busiest SM streams fewer stages
        assert plan.tiles * plan.splits <= min(32, sms)
        assert -(-n_k // plan.splits) < n_k


def test_plan_splits_at_decode_widths():
    """llama3_8b's k/v projections at 32 decode rows (N 1024: 8 tiles) split
    K into 4 runs; its 4096- and 14336-wide projections (32 and 112 tiles)
    already give 32 weight streams or more, and prefill widths fill the
    card: no split there."""
    assert tqm._qmm_plan(32, 4096, 1024, 132).splits == 4
    assert tqm._qmm_plan(32, 16384, 512, 132).splits == 8
    assert tqm._qmm_plan(32, 4096, 4096, 132).splits == 1
    assert tqm._qmm_plan(32, 14336, 4096, 132).splits == 1
    assert tqm._qmm_plan(32, 4096, 14336, 132).splits == 1
    assert tqm._qmm_plan(2048, 4096, 14336, 132).splits == 1
    assert tqm._qmm_plan(2048, 14336, 4096, 132).splits == 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_takes_the_bytewise_kernel_exactly_where_tma_cannot(m, k, n,
                                                                 aligned):
    """TMA needs 16-byte row strides and bases: K % 16, N % 16, an
    unaligned operand (or K = 0) send the shape to the byte-wise kernel,
    and nothing else does."""
    plan = tqm._qmm_plan(m, k, n, 132, aligned=aligned)
    tma_out = k % 16 != 0 or n % 16 != 0 or not aligned or k == 0
    assert (plan.kernel == tqm.BYTEWISE) == tma_out
