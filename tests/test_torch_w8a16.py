"""The W8A16 op (`ops/w8a16.py`) on the CPU: its plain version is the int8
serving arithmetic the port had before the kernel (bit for bit, fp32 and
bf16), it agrees with the JAX `Int8DenseGeneral` int8 branch and
`quant_unembed`, `_w8a16_plan` names a kernel for every llama3_8b shape
(the wgmma kernel for every shape the earlier tile kernel took, its split-K
in whole stages, emulated in split order) and refuses what no kernel
takes, and the decode-step guard of
tests/test_torch_quant.py still sees a weight-side dequant made inside the
op. The kernels themselves run on the card (tests/test_torch_gpu_kernels.py,
chip_smoke.py phase 2f)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.serve import quant as jq
from kubeflow_tpu_torch.ops import w8a16 as tw8
from kubeflow_tpu_torch.serve import quant as tq
from tests.test_torch_quant import (LOGITS_RTOL, _decode_step_mul_shapes,
                                    _violations, int8_model)  # noqa: F401

SHAPES = [(1, 64, 96), (5, 64, 96), (3, 48, 130), (17, 128, 200)]


def _inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    return x.to(dtype), q, scale


def _dense_before(x, q, scale):
    """Int8Dense.forward as the port had it before the op existed."""
    cd = x.dtype
    if cd == torch.float32:
        y = F.linear(x, q.to(cd))
    else:
        y = F.linear(x.float(), q.to(cd).float())
    return y.mul_(scale).to(cd)


def _unembed_before(x, q, scale):
    """quant_unembed's int8 branch as the port had it."""
    logits = F.linear(x, q.to(x.dtype))
    return (logits.float() * scale).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_is_the_earlier_int8_arithmetic(m, k, n, dtype):
    x, q, scale = _inputs(m, k, n, dtype)
    mod = tq.Int8Dense(k, n, dtype)
    mod.q, mod.scale = q, scale
    with torch.no_grad():
        assert torch.equal(mod(x), _dense_before(x, q, scale))
        assert torch.equal(tw8.int8_weight_matmul(x, q, scale),
                           _dense_before(x, q, scale))
        assert torch.equal(tq.quant_unembed(x, mod, dtype),
                           _unembed_before(x, q, scale))
        assert torch.equal(tw8.int8_weight_matmul(
            x, q, scale, round_before_scale=True),
            _unembed_before(x, q, scale))


def test_leading_dims_and_cpu_launch_nothing():
    x, q, scale = _inputs(6, 64, 40, torch.float32)
    before = tw8.w8a16_launches
    out = tw8.int8_weight_matmul(x.view(2, 3, 64), q, scale)
    assert out.shape == (2, 3, 40)
    assert torch.equal(out.reshape(6, 40), tw8.int8_weight_matmul(x, q,
                                                                  scale))
    assert tw8.w8a16_launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="shape mismatch"):
        tw8.int8_weight_matmul(x, q[:, :32], scale)
    with pytest.raises(ValueError, match="shape mismatch"):
        tw8.int8_weight_matmul(x, q, scale[:8])


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matches_jax_int8_dense_general(m, k, n):
    """fp32, the tolerance of tests/test_torch_quant.py's logits: the JAX
    dot and the port's matmul sum in different orders."""
    x, q, scale = _inputs(m, k, n, torch.float32, seed=m + n)
    leaf = jq.Int8Leaf(q=jnp.asarray(q.numpy().T),
                       scale=jnp.asarray(scale.numpy()[None, :]))
    dense = jq.Int8DenseGeneral(features=n, use_bias=False,
                                dtype=jnp.float32)
    want = np.asarray(dense.apply({"params": {"kernel": leaf}},
                                  jnp.asarray(x.numpy())))
    got = tw8.int8_weight_matmul(x, q, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL,
                               atol=LOGITS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matches_jax_quant_unembed(m, k, n):
    x, q, scale = _inputs(m, k, n, torch.float32, seed=2 * m + n)
    table = jq.Int8Leaf(q=jnp.asarray(q.numpy()),
                        scale=jnp.asarray(scale.numpy()[:, None]))
    want = np.asarray(jq.quant_unembed(jnp.asarray(x.numpy())[None], table,
                                       jnp.float32))[0]
    got = tw8.int8_weight_matmul(x, q, scale,
                                 round_before_scale=True).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_RTOL,
                               atol=LOGITS_RTOL * np.abs(want).max())


# -- _w8a16_plan ----------------------------------------------------------------

#: llama3_8b: (N, K) of q/o, k/v, gate/up, down and the unembedding.
LLAMA3_8B = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
             (128256, 4096)]


@pytest.mark.parametrize("n,k", LLAMA3_8B)
@pytest.mark.parametrize("m", [1, 4, 16])
def test_plan_takes_the_decode_kernel_at_decode_widths(m, k, n):
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    assert plan.kernel == tw8.GEMV
    groups = -(-n // 64)
    assert plan.grid == (groups, plan.splits)
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 - k0 >= 2 * 64 for k0, k1 in ranges)  # two blocks a split
    if groups >= tw8._GEMV_CTAS:
        assert plan.splits == 1
    else:  # split until the CTAs reach the target, the limit or K's blocks
        assert (groups * plan.splits >= tw8._GEMV_CTAS
                or plan.splits == tw8._MAX_SPLITS
                or 4 * plan.splits > -(-k // 64))


def test_plan_splits_where_few_weight_rows_stream():
    """k/v at N 1024: 16 CTAs of 64 rows would leave most SMs idle."""
    assert tw8._w8a16_plan(4, 4096, 1024, torch.bfloat16).splits == 16
    assert tw8._w8a16_plan(4, 4096, 4096, torch.bfloat16).splits == 8
    assert tw8._w8a16_plan(4, 4096, 14336, torch.bfloat16).splits == 2
    assert tw8._w8a16_plan(4, 4096, 128256, torch.bfloat16).splits == 1
    assert tw8._w8a16_plan(4, 128, 1024, torch.bfloat16).splits == 1


def _tiles(m, n, bm):
    return -(-m // bm) * -(-n // 128)


@pytest.mark.parametrize("n,k", LLAMA3_8B[:4] + [(130, 1024)])
@pytest.mark.parametrize("m", [17, 128, 2048, 37, 200, 2047, 1024])
def test_plan_takes_the_tensor_core_kernel_past_16_rows(m, k, n):
    """The wgmma kernel: the smallest tile of 64, 128 or 256 rows holding
    m (128 where 256-row tiles would fill at most half the SMs, 64 where
    128-row units would too), 128 weight rows, K
    split only at 64 and 128 rows where at most half the SMs would have a
    tile (runs of at least 16 stages), and one persistent CTA per unit up
    to the SM count."""
    sms = tw8.H100_SMS

    def splits(bm):
        tiles = _tiles(m, n, bm)
        if bm == 256 or 2 * tiles > sms:
            return 1
        return max(1, min(sms // tiles, -(-k // 64) // 16, 16))

    plan = tw8._w8a16_plan(m, k, n, torch.float16)
    assert plan.kernel == tw8.WGMMA
    bm = next((b for b in (64, 128, 256) if m <= b), 256)
    if bm == 256 and 2 * _tiles(m, n, 256) <= sms:
        bm = 128
    if bm == 128 and 2 * _tiles(m, n, 128) * splits(128) <= sms:
        bm = 64
    assert plan.bm == bm and plan.tiles == _tiles(m, n, bm)
    assert plan.splits == splits(bm)
    assert plan.grid == (min(plan.units, sms),)


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in (17, 128, 512, 2048)
                                   for n, k in LLAMA3_8B[:4]]
                         + [(37, 4096, 130), (200, 2048, 64), (300, 16, 8)])
def test_every_split_covers_k_once_in_whole_stages(m, k, n, sms):
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 < k1 and k0 % 64 == 0 for k0, k1 in ranges)
    assert all(k1 % 64 == 0 for _, k1 in ranges[:-1])


#: The eight prefill shapes of chip_smoke.py's phase 2f as (M, K, N), and
#: the splits the plan gives each on an H100 (132 SMs): at 128 rows q/o
#: and down have 32 tiles, gate/up 112, k/v 16 of 64 rows (its 64 stages
#: allow 4 runs of 16).
PREFILL_SPLITS = [((128, 4096, 4096), 4), ((128, 4096, 1024), 4),
                  ((128, 4096, 14336), 1), ((128, 14336, 4096), 4),
                  ((2048, 4096, 4096), 1), ((2048, 4096, 1024), 1),
                  ((2048, 4096, 14336), 1), ((2048, 14336, 4096), 1)]


@pytest.mark.parametrize("shape,splits", PREFILL_SPLITS)
def test_plan_splits_exactly_below_its_tile_threshold(shape, splits):
    m, k, n = shape
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    assert plan.splits == splits
    below = (2 * plan.tiles <= tw8.H100_SMS and plan.bm <= tw8._MAX_SPLIT_BM
             and k >= 2 * 64 * tw8._MIN_SPLIT_STAGES)
    assert (plan.splits > 1) == below
    assert plan.units <= tw8.H100_SMS or plan.splits == 1


def _old_plan_took_the_tile_kernel(m, k, n, dtype, aligned):
    """The rule by which the plan before the wgmma kernel sent a shape to
    its mma.sync tile kernel (and raised past 65535 column tiles)."""
    return (dtype in (torch.bfloat16, torch.float16) and k >= 1
            and k % 16 == 0 and aligned and m > 16
            and max(m * k, n * k, m * n) <= 2**31 - 1)


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_what_the_tile_kernel_took_now_takes_wgmma(dtype, sms):
    """Every shape the old plan sent to the tile kernel goes to WGMMA,
    never to the CUDA-core kernel or a raise; the old kernel's limit of
    65535 column tiles (N 2**24 at M 32) is gone."""
    taken = 0
    for m in (17, 33, 64, 65, 128, 129, 256, 257, 2047, 2048, 4096):
        for k in (16, 48, 64, 96, 4096, 14336):
            for n in (1, 7, 130, 4096, 128256, 1 << 24):
                if not _old_plan_took_the_tile_kernel(m, k, n, dtype, True):
                    continue
                plan = tw8._w8a16_plan(m, k, n, dtype, True, sms)
                assert plan.kernel == tw8.WGMMA, (m, k, n)
                assert 1 <= plan.splits <= max(1, -(-k // 64))
                taken += 1
    assert taken > 300
    assert tw8._w8a16_plan(32, 16, 1 << 24, dtype).kernel == tw8.WGMMA


@pytest.mark.parametrize("m,k,n", [(128, 4096, 1024), (128, 14336, 4096),
                                   (37, 4096, 130), (200, 2048, 64)])
def test_split_order_reduction_matches_plain(m, k, n):
    """The wgmma kernel's split-K, emulated: the fp32 partial product over
    each split's k run, summed in split order, then scaled and cast, is the
    plain version within fp32 rounding."""
    x, q, scale = _inputs(m, k, n, torch.bfloat16, seed=k + n)
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    assert plan.splits > 1
    xf, qf = x.float(), q.float()
    acc = torch.zeros(m, n)
    for k0, k1 in plan.k_ranges(k):
        acc = acc + xf[:, k0:k1] @ qf[:, k0:k1].t()
    full = xf @ qf.t()
    bound = 4 * k * 2.0**-24 * (xf.abs() @ qf.abs().t())
    assert bool(((acc - full).abs() <= bound).all())
    got = (acc * scale).to(torch.bfloat16).float()
    want = tw8._int8_weight_matmul_plain(x, q, scale).float()
    assert (got - want).abs().max() <= 2.0**-7 * want.abs().max()


@pytest.mark.parametrize("m,k,n,dtype,aligned", [
    (4, 4096, 4096, torch.float32, True),
    (2048, 4096, 4096, torch.float32, True),
    (4, 100, 64, torch.bfloat16, True),
    (300, 72, 64, torch.float16, True),
    (4, 4096, 4096, torch.bfloat16, False),
])
def test_plan_takes_the_cuda_core_kernel(m, k, n, dtype, aligned):
    plan = tw8._w8a16_plan(m, k, n, dtype, aligned)
    assert plan == tw8.W8a16Plan(tw8.SIMT, 1, (-(-n // 64), -(-m // 32)))


@pytest.mark.parametrize("args,error,match", [
    ((4, 64, 64, torch.float64), TypeError, "fp32, bf16 or fp16"),
    ((4, 64, 64, torch.int8), TypeError, "fp32, bf16 or fp16"),
    ((4, 0, 64, torch.bfloat16), ValueError, "K >= 1"),
    ((1 << 20, 4096, 64, torch.bfloat16), ValueError, "2\\*\\*31"),
    ((1, 1 << 31, 8, torch.float16), ValueError, "2\\*\\*31"),
    ((1 << 22, 16, 64, torch.float32), ValueError, "row tiles"),
])
def test_plan_refuses_what_no_kernel_takes(args, error, match):
    with pytest.raises(error, match=match):
        tw8._w8a16_plan(*args)


# -- the guard --------------------------------------------------------------------


def test_guard_sees_a_weight_side_dequant_inside_the_op(int8_model,
                                                        monkeypatch):
    """Red switch: the op's plain version dequantizing the codes before
    the matmul makes [out, in] multiplies that the decode-step guard of
    tests/test_torch_quant.py reports; the real one makes none."""
    assert _violations(int8_model, _decode_step_mul_shapes(int8_model)) == []

    def weight_side(x, q, scale, round_before_scale=False):
        return F.linear(x, (q.float() * scale[:, None]).to(x.dtype))

    monkeypatch.setattr(tw8, "_int8_weight_matmul_plain", weight_side)
    assert _violations(int8_model, _decode_step_mul_shapes(int8_model))
