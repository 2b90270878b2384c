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


#: The decode kernel's shapes: llama3_8b's five at M 1, 4 and 16, then
#: ragged ones (N 72, 130, 200, 16383; K 64, 128, 4096 + 16).
DECODE_8B = [(m, k, n) for m in (1, 4, 16) for n, k in LLAMA3_8B]
DECODE_RAGGED = [(4, 4096, 72), (1, 4096, 130), (9, 4096, 200),
                 (16, 4096, 16383), (3, 64, 4096), (4, 128, 1024),
                 (16, 4096 + 16, 4096), (5, 4096 + 16, 130), (2, 64, 72)]


def _decode_work(plan, k, n):
    """What each CTA of a decode launch streams, as the kernel deals it:
    {cta: [(n0, rows, k0, k1), ...]}, CTA c * splits + s taking split s of
    cluster c's chunks."""
    ranges = plan.k_ranges(k)
    work = {}
    for c, chunks in enumerate(plan.chunks(n)):
        for s, (k0, k1) in enumerate(ranges):
            work[c * plan.splits + s] = [(n0, rows, k0, k1)
                                         for n0, rows in chunks]
    return work


@pytest.mark.parametrize("m,k,n", DECODE_8B)
def test_plan_takes_the_decode_kernel_at_decode_widths(m, k, n):
    """Up to 16 rows: the decode kernel, dealing whole 16-row blocks in
    contiguous runs, one cluster of `splits` CTAs a run, no more CTAs than
    SMs, each split whole 64-deep blocks of K, at least one stage each."""
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    assert plan.kernel == tw8.GEMV and plan.bm == 0
    assert plan.grid == (plan.clusters * plan.splits,)
    assert plan.grid[0] <= tw8.H100_SMS
    assert plan.clusters == min(-(-n // 16), tw8.H100_SMS // plan.splits)
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 - k0 >= tw8._GEMV_STAGE_K for k0, k1 in ranges)
    runs = plan.runs(n)
    assert runs[0][0] == 0 and runs[-1][1] == n  # the 8B widths are whole blocks
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(runs, runs[1:]))


def test_plan_splits_where_few_weight_rows_stream():
    """k/v at N 1024: 64 blocks of 16 rows would leave half the SMs idle,
    so K splits in two (128 CTAs of 32 KB). q/o and down have the blocks to
    fill 132 SMs, in runs of 16-32 rows: each CTA streams one chunk, and
    splitting K halves the copy requests it issues (four TMA boxes and M
    activation rows a stage) for a cluster's sum. down's 28 stages split
    from M 4 on, q/o's 8 only at M 16; gate/up's runs are past a chunk.
    Small N splits up to the portable cluster of 8, and never below one
    512-deep stage a split."""
    def splits(m, k, n, sms=tw8.H100_SMS):
        return tw8._w8a16_plan(m, k, n, torch.bfloat16, True, sms).splits
    assert splits(4, 4096, 1024) == 2
    assert splits(16, 4096, 1024) == 2  # 4 stages x 20 copies: no further
    assert splits(1, 4096, 4096) == 1  # 8 stages x 5 copies a CTA
    assert splits(4, 4096, 4096) == 1  # 8 x 8
    assert splits(16, 4096, 4096) == 2  # 8 x 20
    assert splits(1, 14336, 4096) == 1  # 28 x 5
    assert splits(4, 14336, 4096) == 2  # 28 x 8, then runs of 64 rows
    assert splits(16, 14336, 4096) == 2
    assert splits(16, 2048, 4096) == 1  # 4 x 20
    assert splits(4, 4096, 14336) == 1
    assert splits(4, 4096, 128256) == 1
    assert splits(4, 4096, 130) == 8  # 9 blocks
    assert splits(4, 128, 1024) == 1  # two 64-deep blocks: not a stage each
    assert splits(4, 1024, 72) == 2  # 5 blocks; 16 blocks of K: a stage each
    assert splits(4, 4096, 1024, 114) == 1  # 64 blocks fill over half
    assert splits(16, 4096, 1024, 114) == 2  # 8 stages x 20 copies
    assert splits(4, 4096, 1024, 264) == 4


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("m,k,n", DECODE_8B + DECODE_RAGGED)
def test_decode_plan_covers_every_block_once(m, k, n, sms):
    """Every (16-row block, 64-deep k block) of the weight is streamed by
    exactly one CTA, and inside it by exactly one consumer warp (warp w
    takes the blocks w modulo 8, counted from the CTA's k0: block w of
    every 512-deep stage, for all the chunk's row groups)."""
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16, True, sms)
    assert plan.kernel == tw8.GEMV
    assert plan.grid[0] <= sms or plan.clusters == 1
    n_kb = -(-k // 64)
    seen = {}
    for cta, items in _decode_work(plan, k, n).items():
        for n0, rows, k0, k1 in items:
            assert rows in (16, 32, 48, 64) and n0 % 16 == 0 and k0 % 64 == 0
            nb = rows // 16
            for b in range(nb):
                if n0 + 16 * b >= n:
                    continue
                for j in range(-(-(k1 - k0) // 64)):
                    warps = [w for w in range(8) if j % 8 == w]
                    assert len(warps) == 1
                    key = ((n0 + 16 * b) // 16, k0 // 64 + j)
                    assert key not in seen, (key, cta, seen.get(key))
                    seen[key] = cta
    assert len(seen) == -(-n // 16) * n_kb


@pytest.mark.parametrize("m,k,n", DECODE_8B)
def test_decode_plan_balances_bytes_across_sms(m, k, n):
    """One CTA an SM: no SM streams more than 5% above the mean weight
    bytes at llama3_8b's decode shapes on an H100 (132 SMs)."""
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    shares = [sum(min(rows, n - n0) * (k1 - k0)
                  for n0, rows, k0, k1 in items)
              for items in _decode_work(plan, k, n).values()]
    assert sum(shares) == n * k
    assert max(shares) <= 1.05 * n * k / tw8.H100_SMS, (
        max(shares), n * k / tw8.H100_SMS)


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("m,k,n", DECODE_8B + DECODE_RAGGED)
def test_decode_plan_cluster_is_portable(m, k, n, sms):
    """Clusters of 1, 2, 4 or 8 CTAs (portable sizes: no non-portable
    attribute), one cluster per unit at most, no split without a 64-deep
    block of K."""
    plan = tw8._w8a16_plan(m, k, n, torch.float16, True, sms)
    assert plan.splits in (1, 2, 4, 8)
    assert plan.grid[0] % plan.splits == 0
    assert 1 <= plan.clusters <= -(-n // 16)
    assert plan.splits <= -(-k // 64)


@pytest.mark.parametrize("m,k,n", DECODE_8B + DECODE_RAGGED)
def test_decode_plan_ring_fits_and_keeps_32kb_in_flight(m, k, n):
    """The ring has at least four stages, fits a CTA's shared memory with
    the partials and rank 0's buffers, and holds at least 32 KB of weight
    (or all a CTA streams, where that is less): about Little's law for
    3.35 TB/s over 132 SMs at ~1 us of loaded latency."""
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    _, slot, _, _, _, smem = plan.layout
    assert tw8._GEMV_STAGES >= 4
    assert smem <= tw8._GEMV_SMEM_MAX
    assert slot % 1024 == 0  # the 128-byte swizzle's period
    k_st = tw8._GEMV_STAGE_K
    assert slot >= plan.slot_rows * k_st + m * (2 * k_st + 16)
    most = max(sum(min(rows, n - n0) * (k1 - k0)
                   for n0, rows, k0, k1 in items)
               for items in _decode_work(plan, k, n).values())
    assert plan.slot_rows >= max(rows for chunks in plan.chunks(n)
                                 for _, rows in chunks)
    for (r0, r1), chunks in zip(plan.runs(n), plan.chunks(n)):
        assert len(chunks) == -(-(r1 - r0) // 64)  # the fewest chunks
    assert tw8._GEMV_STAGES * plan.slot_rows * k_st >= min(32768, most)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,k,n", DECODE_8B + DECODE_RAGGED)
def test_decode_layout_passes_the_kernels_checks(m, k, n, sms):
    """The plan owns the decode kernel's shared-memory layout and the
    kernel takes it as it is, refusing only what tpk_w8a16 checks (a
    misplaced region, more than a CTA's shared memory): every plan passes
    those checks, its regions lie in order without overlap, each as large
    as the kernel's use of it, and the launch fills the grid it names."""
    plan = tw8._w8a16_plan(m, k, n, torch.float16, True, sms)
    layout = dict(zip(tw8._GEMV_LAYOUT, plan.layout))
    rows, slot = layout["slot_rows"], layout["slot_bytes"]
    part, red, bars, smem = (layout[f] for f in ("part", "red", "bars",
                                                  "smem"))
    s = plan.splits
    # tpk_w8a16's checks of a decode launch, in its order.
    assert m <= 16 and s in (1, 2, 4, 8)
    assert s <= plan.grid[0] and plan.grid[0] % s == 0
    assert plan.grid[0] // s <= -(-n // 16)
    assert 16 <= rows <= 64 and rows % 16 == 0 and slot % 1024 == 0
    assert part >= tw8._GEMV_STAGES * slot and red > part and bars >= red
    assert bars % 8 == 0 and bars < smem <= tw8._GEMV_SMEM_MAX
    # The kernel's use of each region.
    assert slot >= rows * 512 + m * (2 * 512 + 16)
    assert red - part >= 4 * (8 if m <= 8 else 16) * (64 + 4) * 4
    assert bars - red >= 2 * (s - 1) * rows * m * 4
    assert smem - bars >= 8 * (2 * tw8._GEMV_STAGES + 4) + 1024
    assert tw8._launch_tail(plan) == (1, 0, s, plan.grid[0], *plan.layout)


def _decode_emulated(x, q, scale, plan, round_first=False):
    """The decode kernel's sums in fp32, in its order: per CTA and chunk,
    each warp's 64-deep blocks (warp w: blocks w modulo 8 of the CTA's K
    range, all the chunk's rows), the warps summed in warp order, then the
    cluster's ranks in rank order; then the epilogue."""
    m, k = x.shape
    n = q.shape[0]
    xf, qf = x.float(), q.float()
    out = torch.empty(m, n)
    ranges = plan.k_ranges(k)
    for chunks in plan.chunks(n):
        for n0, rows in chunks:
            rs = slice(n0, min(n0 + rows, n))
            total = None
            for k0, k1 in ranges:  # rank order
                rank_sum = None
                for w in range(8):  # warp order
                    part = torch.zeros(m, rs.stop - rs.start)
                    for j in range(w, -(-(k1 - k0) // 64), 8):
                        lo, hi = k0 + 64 * j, min(k0 + 64 * (j + 1), k1)
                        part += xf[:, lo:hi] @ qf[rs, lo:hi].t()
                    rank_sum = part if rank_sum is None else rank_sum + part
                total = rank_sum if total is None else total + rank_sum
            out[:, rs] = total
    if round_first:
        out = out.to(x.dtype).float()
    return (out * scale).to(x.dtype)


@pytest.mark.parametrize("m,k,n,rf", [(4, 4096, 1024, False),
                                      (9, 4096 + 16, 130, True),
                                      (16, 2048, 200, False),
                                      (1, 1024, 72, True)])
def test_decode_cluster_split_order_sum_matches_plain(m, k, n, rf):
    """The decode kernel's split-K, emulated: the fp32 partial of every
    warp of every rank, summed in warp order and then rank order, scaled
    and cast, is the plain version within one rounding of the output; the
    fp32 sum itself is the plain product within fp32 rounding."""
    x, q, scale = _inputs(m, k, n, torch.bfloat16, seed=k + n)
    plan = tw8._w8a16_plan(m, k, n, torch.bfloat16)
    assert plan.kernel == tw8.GEMV and plan.splits > 1
    got = _decode_emulated(x, q, scale, plan, rf).float()
    want = tw8._int8_weight_matmul_plain(x, q, scale, rf).float()
    assert (got - want).abs().max() <= 2.0**-7 * want.abs().max()
    ones = torch.ones(n)
    acc = _decode_emulated(x.float(), q, ones, plan)
    full = x.float() @ q.float().t()
    bound = 4 * k * 2.0**-24 * (x.float().abs() @ q.float().abs().t())
    assert bool(((acc - full).abs() <= bound).all())


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
