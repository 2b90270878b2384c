"""The grid plans of csrc/flash_simt.cu (`_simt_bwd_plan`, `_simt_fwd_plan`),
on the CPU.

The plan is a pure function of the shape, the dtype and the SM count: the
rows a dq and a dk/dv CTA own, the streamed tile of each pass, and the
splits of a dk/dv key block's walk over (GQA head, q tile) pairs. These
tests hold it to its rules at chip_smoke.py's phase 2e shapes and at ragged
and edge shapes, check that every plan fits in an H100 CTA's shared memory,
and walk the kernels' tiling (key and query ranges, the per-tile mask
classification, the split ranges) in Python to show that every visible
(query, key) pair is visited exactly once by dq and once by dk/dv. The
forward's plan picks the kernel by dtype (the tensor cores for bf16/fp16,
the CUDA cores for fp32) and its rows by the same fill rule.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import flash_attention as tfa

SMS = 132
# (B, S, T, H, KH, D, dtype): phase 6's two configs, SIMT_EXTRA_CASE, the
# Gemma-width case, head dims 40 and 256, ragged S and T.
SHAPES = [
    (2, 96, 96, 4, 2, 16, torch.bfloat16),
    (2, 96, 96, 16, 8, 128, torch.float32),
    (2, 1024, 1024, 16, 8, 128, torch.float32),
    (1, 2048, 2048, 16, 16, 256, torch.bfloat16),
    (1, 200, 200, 4, 2, 40, torch.float32),
    (2, 200, 200, 4, 2, 256, torch.float16),
    (1, 333, 333, 8, 2, 64, torch.bfloat16),
    (2, 72, 300, 4, 2, 128, torch.float32),
    (1, 1, 1, 1, 1, 1, torch.float32),
]
IDS = [f"B{b}-S{s}-T{t}-H{h}-KH{kh}-D{d}-{str(dt)[6:]}"
       for b, s, t, h, kh, d, dt in SHAPES]


def _plan(shape, sms=SMS):
    return tfa._simt_bwd_plan(*shape, sms)


def _split_ranges(walk, splits):
    """[begin, end) of each split's steps of a key block's walk, as the
    dk/dv kernel cuts it."""
    return [(j * walk // splits, (j + 1) * walk // splits)
            for j in range(splits)]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_rows_fill_the_sms_or_are_the_smallest(shape):
    """Each pass owns the most rows (64, or 32 above head dim 128) whose
    CTAs fill the SMs; only where none would does it fall to 16."""
    b, s, t, h, kh, d, dtype = shape
    plan = _plan(shape)
    top = 64 if d <= 128 else 32
    for rows, units, n in ((plan.dq_rows, b * h, s),
                           (plan.dkv_rows, b * kh, t)):
        assert rows in tfa.SIMT_BWD_ROWS and rows <= top
        ctas = units * -(-n // rows)
        assert ctas >= SMS or rows == tfa.SIMT_BWD_ROWS[-1]
        if rows < top:  # twice the rows would have left SMs idle
            assert units * -(-n // (2 * rows)) < SMS
    assert plan.dq_ctas == b * h * -(-s // plan.dq_rows)
    assert plan.dkv_blocks == b * kh * -(-t // plan.dkv_rows)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_splits_only_where_the_grid_leaves_sms_idle(shape):
    plan = _plan(shape)
    if plan.dkv_blocks >= SMS:
        assert plan.splits == 1
    else:
        assert plan.splits == min(plan.walk, -(-SMS // plan.dkv_blocks),
                                  tfa.SIMT_MAX_SPLITS)
    assert plan.dkv_ctas == plan.dkv_blocks * plan.splits


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_split_walks_a_tile_and_splits_never_exceed_the_tiles(shape):
    b, s, t, h, kh, d, dtype = shape
    plan = _plan(shape)
    assert plan.walk == h // kh * -(-s // plan.dkv_tile)
    assert 1 <= plan.splits <= plan.walk
    ranges = _split_ranges(plan.walk, plan.splits)
    assert all(end > begin for begin, end in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.walk
    assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))


def test_phase6_and_extra_case_plans():
    """The grids phase 2e's shapes run at (their times: PERF.md)."""
    tiny = _plan(SHAPES[0])
    assert (tiny.dq_rows, tiny.dkv_rows, tiny.splits) == (16, 16, 4)
    fp32 = _plan(SHAPES[1])
    assert (fp32.dq_rows, fp32.dkv_rows, fp32.splits) == (16, 16, 2)
    assert (tiny.dq_tile, tiny.dkv_tile) == (64, 64)
    assert (fp32.dq_tile, fp32.dkv_tile) == (32, 32)
    extra = _plan(SHAPES[2])
    assert (extra.dq_rows, extra.dkv_rows, extra.splits) == (64, 64, 1)
    assert (extra.dq_tile, extra.dkv_tile) == (64, 64)
    gemma = _plan(SHAPES[3])
    assert (gemma.dq_rows, gemma.dkv_rows, gemma.splits) == (32, 32, 1)


def test_more_sms_split_more_and_fewer_split_less():
    shape = SHAPES[1]
    assert _plan(shape, 1).splits == 1
    assert _plan(shape, 1).dq_rows == 64
    assert _plan(shape, 1024).splits > 1


@pytest.mark.parametrize("dtype", list(tfa.SIMT_DTYPES))
@pytest.mark.parametrize("d", [1, 32, 33, 64, 65, 128, 129, 256])
@pytest.mark.parametrize("rows", tfa.SIMT_BWD_ROWS)
def test_every_tile_fits_in_shared_memory(dtype, d, rows):
    """Every (dtype, head-dim bucket, rows) a plan can name fits in an
    H100 CTA's 227 KB with its streamed tile; 64-row tiles wherever they
    fit (dk/dv sharing one P/dS buffer where that is what fits)."""
    dm = tfa._simt_bucket(d)
    if dm > 128 and rows > 32:
        return
    size = torch.empty((), dtype=dtype).element_size()
    for dkv in (False, True):
        n = tfa._simt_tile(dkv, size, dm, rows)
        assert n in (32, 64)
        pbufs = 2 if dkv else 1
        fits = tfa._simt_smem(dkv, size, dm, rows, n, pbufs) <= 232448
        shared = tfa._simt_smem(dkv, size, dm, rows, n, 1) <= 232448
        assert fits or (dkv and n == 64 and shared)
        own64 = tfa._simt_smem(dkv, size, dm, rows, 64, pbufs)
        if n == 32 and rows == 16:  # 64 would keep a second CTA off the SM
            assert own64 > 232448 // 2
        elif n == 32:
            assert tfa._simt_smem(dkv, size, dm, rows, 64, 1) > 232448
        if rows == 16 and dm <= 128:  # two CTAs share an SM
            assert tfa._simt_smem(dkv, size, dm, rows, n, pbufs) <= 232448 // 2


def test_the_dkv_tile_at_the_extra_case_shares_p_and_ds():
    """fp32 at head dim 128 with 64 key rows: 64-row q tiles fit only with
    P and dS through one buffer (222,720 bytes; two would take 241,152)."""
    assert tfa._simt_smem(True, 4, 128, 64, 64, 2) == 241152
    assert tfa._simt_smem(True, 4, 128, 64, 64, 1) == 222720
    assert tfa._simt_tile(True, 4, 128, 64) == 64
    assert tfa._simt_tile(False, 4, 128, 64) == 64
    assert tfa._simt_tile(False, 4, 256, 32) == 32


@pytest.mark.parametrize("bad,exc", [
    (dict(d=257), ValueError), (dict(d=0), ValueError),
    (dict(dtype=torch.float64), TypeError), (dict(h=3, kh=2), ValueError),
    (dict(s=0), ValueError)])
def test_the_plan_raises_on_what_no_kernel_takes(bad, exc):
    args = dict(b=1, s=64, t=64, h=4, kh=2, d=64, dtype=torch.float32)
    args.update(bad)
    with pytest.raises(exc):
        tfa._simt_bwd_plan(**args)


# ---- the kernels' tiling, walked in Python --------------------------------
# key_range, query_range and all_visible as csrc/flash_simt.cu states them.

def _mask_visible(kind, window, prefix, row, col):
    if kind == "causal":
        return row >= col
    if kind == "prefix_lm":
        return row >= col or col < prefix
    if kind == "sliding_window":
        return row >= col and row - col < window
    return True


def _key_range(kind, window, prefix, t, r0, r1):
    lo, hi = 0, t - 1
    if kind in ("causal", "sliding_window"):
        hi = min(hi, r1)
    if kind == "prefix_lm":
        hi = min(hi, max(r1, prefix - 1))
    if kind == "sliding_window":
        lo = max(0, r0 - window + 1)
    return lo, hi


def _query_range(kind, window, prefix, s, c0, c1):
    lo, hi = 0, s - 1
    if kind in ("causal", "sliding_window"):
        lo = c0
    if kind == "prefix_lm":
        lo = 0 if c0 < prefix else c0
    if kind == "sliding_window":
        hi = min(hi, c1 + window - 1)
    return lo, hi


def _all_visible(kind, window, prefix, r0, r1, c0, c1):
    if kind == "causal":
        return c1 <= r0
    if kind == "prefix_lm":
        return c1 <= r0 or c1 < prefix
    if kind == "sliding_window":
        return c1 <= r0 and r1 - c0 < window
    return True


def _visible_grid(kind, window, prefix, s, t):
    return np.array([[_mask_visible(kind, window, prefix, r, c)
                      for c in range(t)] for r in range(s)])


def _tile_pairs(kind, window, prefix, s, t, rows, cols, whole):
    """The (row, col) pairs of a tile that count: all of a whole tile
    (checked to be all visible and in range), else the per-element test."""
    got = np.zeros((s, t), dtype=np.int64)
    for r in rows:
        for c in cols:
            if whole:
                assert r < s and c < t and _mask_visible(kind, window,
                                                         prefix, r, c)
                got[r, c] += 1
            elif r < s and c < t and _mask_visible(kind, window, prefix, r,
                                                   c):
                got[r, c] += 1
    return got


MASKS = [("causal", 0, 0), ("full", 0, 0), ("prefix_lm", 0, 23),
         ("sliding_window", 17, 0), ("sliding_window", 1, 0)]


@pytest.mark.parametrize("kind,window,prefix", MASKS,
                         ids=[f"{k}-{w}-{p}" for k, w, p in MASKS])
@pytest.mark.parametrize("s,t,rows,tile", [(70, 70, 16, 32), (45, 100, 32, 64),
                                           (100, 45, 16, 64)])
def test_the_dq_walk_visits_every_visible_pair_once(kind, window, prefix, s,
                                                    t, rows, tile):
    got = np.zeros((s, t), dtype=np.int64)
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s) - 1
        lo, hi = _key_range(kind, window, prefix, t, r0, r1)
        if lo > hi:
            continue
        for t0 in range(lo // tile * tile, hi + 1, tile):
            whole = (t0 + tile <= t and _all_visible(kind, window, prefix,
                                                     r0, r1, t0,
                                                     t0 + tile - 1))
            # Rows past S are computed but never written: not counted.
            got += _tile_pairs(kind, window, prefix, s, t,
                               range(r0, r1 + 1), range(t0, t0 + tile),
                               whole)
    want = _visible_grid(kind, window, prefix, s, t).astype(np.int64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind,window,prefix", MASKS,
                         ids=[f"{k}-{w}-{p}" for k, w, p in MASKS])
@pytest.mark.parametrize("s,t,rows,tile,group,splits", [
    (70, 70, 16, 32, 2, 1), (70, 70, 16, 32, 2, 3), (45, 100, 32, 64, 1, 2),
    (100, 45, 16, 64, 4, 8), (100, 100, 64, 64, 2, 16)])
def test_the_dkv_walk_and_its_splits_visit_every_visible_pair_once(
        kind, window, prefix, s, t, rows, tile, group, splits):
    """Every (GQA head, q row, key) visible pair is visited by exactly one
    step of exactly one split, however many splits (some may walk nothing
    where a key block sees few q tiles)."""
    got = np.zeros((group, s, t), dtype=np.int64)
    for c0 in range(0, t, rows):
        c1 = min(c0 + rows, t) - 1
        lo, hi = _query_range(kind, window, prefix, s, c0, c1)
        nq = 0 if lo > hi else hi // tile - lo // tile + 1
        walk = group * nq
        for begin, end in _split_ranges(walk, splits):
            for step in range(begin, end):
                g, q0 = step // nq, (lo // tile + step % nq) * tile
                whole = (q0 + tile <= s and _all_visible(
                    kind, window, prefix, q0, q0 + tile - 1, c0, c1))
                got[g] += _tile_pairs(kind, window, prefix, s, t,
                                      range(q0, q0 + tile),
                                      range(c0, c1 + 1), whole)
    want = _visible_grid(kind, window, prefix, s, t).astype(np.int64)
    for g in range(group):
        assert np.array_equal(got[g], want)


# ---- the forward's plan ----------------------------------------------------

def _fwd(shape, sms=SMS, **kw):
    return tfa._simt_fwd_plan(*shape, sms, **kw)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_forward_kernel_follows_the_dtype(shape):
    """bf16 and fp16 go to the tensor cores, fp32 keeps the CUDA cores."""
    plan = _fwd(shape)
    assert plan.kernel == ("simt" if shape[-1] == torch.float32 else "mma")
    for dtype in (torch.bfloat16, torch.float16):
        assert _fwd(shape[:-1] + (dtype,)).kernel == "mma"
    assert _fwd(shape[:-1] + (torch.float32,)).kernel == "simt"


@pytest.mark.parametrize("kernel", ["simt", "mma"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_rows_fill_the_sms_and_halve_only_while_they_do_not(shape,
                                                                    kernel):
    b, s, t, h, kh, d, dtype = shape
    if kernel == "mma" and dtype == torch.float32:
        dtype = torch.bfloat16
    plan = tfa._simt_fwd_plan(b, s, t, h, kh, d, dtype, SMS, kernel=kernel)
    top = 128 if kernel == "mma" else (64 if d <= 128 else 32)
    choices = tfa.SIMT_MMA_ROWS if kernel == "mma" else tfa.SIMT_BWD_ROWS
    assert plan.rows in choices and plan.rows <= top
    assert plan.ctas == b * h * -(-s // plan.rows)
    assert plan.ctas >= SMS or plan.rows == 16
    if plan.rows < top:  # twice the rows would have left SMs idle
        assert b * h * -(-s // (2 * plan.rows)) < SMS


def test_phase_2e_forward_plans():
    """The grids phase 2e's shapes run at (their times: PERF.md)."""
    tiny, fp32, extra, gemma = (_fwd(shape) for shape in SHAPES[:4])
    assert (tiny.kernel, tiny.bucket, tiny.rows, tiny.ctas) == (
        "mma", 16, 16, 48)
    assert (fp32.kernel, fp32.rows, fp32.tile, fp32.ctas) == (
        "simt", 16, 32, 192)
    assert (extra.kernel, extra.rows, extra.tile, extra.ctas) == (
        "simt", 64, 64, 512)
    assert (gemma.kernel, gemma.bucket, gemma.rows, gemma.tile,
            gemma.ctas) == ("mma", 256, 128, 64, 256)


@pytest.mark.parametrize("d,bucket", [(1, 16), (16, 16), (17, 32), (40, 48),
                                      (80, 80), (96, 96), (100, 112),
                                      (128, 128), (129, 160), (161, 192),
                                      (193, 256), (256, 256)])
def test_the_tensor_core_buckets_are_multiples_of_16(d, bucket):
    plan = tfa._simt_fwd_plan(1, 64, 64, 2, 1, d, torch.float16)
    assert plan.bucket == bucket and bucket % 16 == 0 and bucket >= d


@pytest.mark.parametrize("dtype", list(tfa.SIMT_DTYPES))
@pytest.mark.parametrize("d", [1, 16, 32, 33, 64, 65, 80, 96, 128, 129, 160,
                               192, 256])
def test_every_forward_plan_fits_in_shared_memory(dtype, d):
    """Every (kernel, bucket, rows) a forward plan can name fits in an H100
    CTA's 227 KB; the CUDA-core kernel's 64-row kv tiles wherever they fit
    (at 16 rows: with room for a second CTA)."""
    size = torch.empty((), dtype=dtype).element_size()
    for rows in tfa.SIMT_MMA_ROWS:
        if dtype != torch.float32:
            assert tfa._mma_smem(tfa._mma_bucket(d), rows) <= 232448
    dm = tfa._simt_bucket(d)
    for rows in tfa.SIMT_BWD_ROWS:
        if dm > 128 and rows > 32:
            continue
        n = tfa._simt_fwd_tile(size, dm, rows)
        assert n in (32, 64)
        assert tfa._simt_fwd_smem(size, dm, rows, n) <= 232448
        own64 = tfa._simt_fwd_smem(size, dm, rows, 64)
        if n == 32:
            assert own64 > 232448 or (rows == 16 and own64 > 232448 // 2)
    for kernel in ("simt", "mma"):
        if kernel == "mma" and dtype == torch.float32:
            continue
        for s in (1, 96, 1024, 4096):
            plan = tfa._simt_fwd_plan(1, s, s, 8, 2, d, dtype, SMS,
                                      kernel=kernel)
            assert plan.smem <= 232448


def test_the_forward_smem_at_the_phase_2e_shapes():
    """fp32 D128: 64 rows with 64-row kv tiles take 187,904 bytes (one CTA
    an SM); 16 rows take 32-row tiles (78,848: two CTAs). Gemma widths on
    the tensor cores: 128 rows of D256 take 203,264."""
    assert tfa._simt_fwd_smem(4, 128, 64, 64) == 187904
    assert tfa._simt_fwd_tile(4, 128, 16) == 32
    assert tfa._simt_fwd_smem(4, 128, 16, 32) == 78848
    assert tfa._mma_smem(256, 128) == 203264


@pytest.mark.parametrize("bad,exc", [
    (dict(d=257), ValueError), (dict(d=0), ValueError),
    (dict(dtype=torch.float64), TypeError), (dict(h=3, kh=2), ValueError),
    (dict(s=0), ValueError), (dict(kernel="mma"), TypeError),
    (dict(kernel="wgmma"), ValueError)])
def test_the_forward_plan_raises_on_what_no_kernel_takes(bad, exc):
    args = dict(b=1, s=64, t=64, h=4, kh=2, d=64, dtype=torch.float32)
    args.update(bad)
    with pytest.raises(exc):
        tfa._simt_fwd_plan(**args)


def test_the_forward_plan_is_pure():
    """Same arguments, same plan (cached, but equal also when computed
    anew); the SM count and a forced kernel are part of the key."""
    shape = SHAPES[3]
    first = _fwd(shape)
    tfa._simt_fwd_plan.cache_clear()
    again = _fwd(shape)
    assert first == again and first is not again
    assert _fwd(shape) is again
    assert _fwd(shape, 8).rows == 128
    assert _fwd(shape, 1024).rows < 128
    forced = _fwd(shape, kernel="simt")
    assert forced.kernel == "simt" and forced.rows == 32
    assert _fwd(shape).kernel == "mma"
