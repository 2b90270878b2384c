"""W8A16 matmul: activations times int8 weight codes, scaled per output.

    y[..., n] = cast(sum_k x[..., k] * q[n, k] * scale[n])

The port's counterpart of what XLA does for the int8 branch of the JAX
package's `Int8DenseGeneral` and `quant_unembed`
(`kubeflow_tpu/serve/quant.py`): the codes reach the dot through a bare
convert that XLA fuses into the operand read, so no weight-sized temporary
exists. Not a TPU kernel: the JAX package has no `pallas_call` here.

On a CUDA tensor `int8_weight_matmul` launches one of the three kernels of
`csrc/w8a16.cu`, chosen by shape before the launch (`_w8a16_plan`): the
decode kernel (at most 16 activation rows: one persistent CTA an SM
streams a contiguous run of weight rows through a ring of bulk copies, K
split across the CTAs of a thread-block cluster where the rows alone would
leave SMs idle), the wgmma + TMA tile kernel (more rows; split along K
where its tiles alone would leave SMs idle), or the CUDA-core kernel (fp32
activations, K not a multiple of 16, an operand not 16-byte aligned). Accumulation is fp32 throughout and the
scale lands on the fp32 sum. On a CPU tensor it runs
`_int8_weight_matmul_plain`: the codes cast to the compute dtype, an
fp32-output matmul, the scale, the cast back. Nothing falls back: a CUDA
tensor no kernel takes raises.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops.quant_matmul import _tickets_for

#: Launches of any of the CUDA kernels (never of the plain version), for
#: callers that must show a run went through them. Reset by assigning 0.
w8a16_launches = 0
#: Of those, launches of the wgmma + TMA tile kernel. Reset by assigning 0.
w8a16_wgmma_launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SIMT, GEMV, WGMMA = "simt", "gemv", "wgmma"
_KERNEL_IDS = {SIMT: 0, GEMV: 1, WGMMA: 2}
_GEMV_MAX_M = 16  # the decode kernel's activation rows: two 8-row products
_BMS = (64, 128, 256)  # the wgmma kernel's activation rows per tile
_BN = 128  # ... and weight rows per tile
_MAX_SPLIT_BM = 128  # the wgmma kernel splits K only at tiles of 64 and 128 rows
#: Stages (of 64 k) a wgmma split runs at least: shorter runs spend their
#: time filling the ring and reducing partials (at M 128, K 4096, N 1024 on
#: an H100: 0.0191 ms at 16 stages a split, 0.0252 at 4; tools/w8a16_ab.py).
_MIN_SPLIT_STAGES = 16
_SIMT_M, _SIMT_N = 32, 64  # the CUDA-core kernel's output tiles
#: The decode kernel's k block and the wgmma kernel's stage: 64 deep, the
#: unit of a split.
_KBLOCK = 64
_MAX_SPLITS = 16
#: SMs of an H100 SXM: the plan's default card.
H100_SMS = 132
#: The decode kernel (csrc/w8a16.cu, w8a16_decode_kernel; its kDecRows,
#: kDecChunk, kDecStageK and kDecStages): weight rows of a unit of the deal
#: (whole 16-row blocks: the finest that mma.sync's 16-row A operand
#: allows, and within ~3% of the mean bytes an SM at llama3_8b's shapes on
#: 132 SMs), the rows a CTA streams at once at most, the k (bytes of a
#: weight row) of a ring stage (8 consumer warps' 64-deep blocks), the
#: largest (portable) cluster, and a CTA's dynamic shared memory on an H100.
_GEMV_ROWS = 16
_GEMV_CHUNK = 64
_GEMV_STAGE_K = 512
#: The ring's slots: at least four (32 KB of weight in flight at 16-row
#: chunks); within 5% of the best of 2, 3, 4 and 8 at every llama3_8b decode
#: shape at M 1, 4 and 16 on an H100, where 2 were up to 11% slower
#: (tools/w8a16_decode_variants.py's stage sweep).
_GEMV_STAGES = 4
_GEMV_MAX_CLUSTER = 8
_GEMV_BOX_K = 128  # k of a TMA box of the weight: four a stage
#: Copy requests (a TMA box of the weight and a bulk copy of each
#: activation row, per stage) above which a CTA streaming one short chunk
#: pays for a cluster's sum by splitting K (see `_gemv_splits`).
_GEMV_SPLIT_REQUESTS = 150
_GEMV_BLOCKS = 8  # 64-deep blocks of a stage, the partials summed in block order
_GEMV_SMEM_MAX = 232448
_GRID_Y_MAX = 65535
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class W8a16Plan:
    """How csrc/w8a16.cu runs one [m, k] x [n, k]^T product: which kernel,
    how many ways K is split (the decode and wgmma kernels) and its grid;
    for the wgmma kernel also its tile's activation rows (`bm`, by 128
    weight rows) and the number of tiles, whose units (tiles x splits) its
    persistent CTAs (`grid`) take in turn. For the decode kernel: its grid
    is clusters x `splits` CTAs, one cluster a contiguous run of 16-row
    units, each CTA of a cluster one share of K; `layout` is its shared
    memory (`_gemv_layout`), which the kernel takes as it is."""

    kernel: str
    splits: int
    grid: tuple
    bm: int = 0
    tiles: int = 0
    layout: tuple = ()

    @property
    def slot_rows(self) -> int:
        return self.layout[0]

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    @property
    def clusters(self) -> int:
        return self.grid[0] // self.splits

    def k_ranges(self, k: int) -> list:
        """[k0, k1) of each split, as the kernels compute them: split j
        takes the 64-deep blocks (stages) [j * n_kb // splits, (j + 1) *
        n_kb // splits) of n_kb = ceil(k / 64), the last one cut at k."""
        n_kb = -(-k // _KBLOCK)
        return [(j * n_kb // self.splits * _KBLOCK,
                 min((j + 1) * n_kb // self.splits * _KBLOCK, k))
                for j in range(self.splits)]

    def runs(self, n: int) -> list:
        """The decode kernel's deal, as it computes it: [r0, r1) of the
        weight rows of each cluster, its units [c U / C, (c + 1) U / C) of
        U = ceil(n / 16), the last cut at n rounded up to 16."""
        units, c, rows = -(-n // _GEMV_ROWS), self.clusters, _GEMV_ROWS
        end = -(-n // 16) * 16
        return [(i * units // c * rows, min((i + 1) * units // c * rows, end))
                for i in range(c)]

    def chunks(self, n: int) -> list:
        """Per cluster, the (n0, rows) chunks the decode kernel streams its
        run in: the fewest of at most 64 rows, ceil(L / 64) for a run of L,
        as equal as whole 16-row groups allow, the larger first."""
        out = []
        for r0, r1 in self.runs(n):
            count, groups = -(-(r1 - r0) // _GEMV_CHUNK), (r1 - r0) // 16
            q, r = divmod(groups, count)
            starts = [r0 + 16 * (i * q + min(i, r)) for i in range(count + 1)]
            out.append([(a, b - a) for a, b in zip(starts, starts[1:])])
        return out


#: Fields of a decode plan's `layout`, in tpk_w8a16's order.
_GEMV_LAYOUT = ("slot_rows", "slot_bytes", "part", "red", "bars", "smem")


def _gemv_layout(m: int, splits: int, slot_rows: int) -> tuple:
    """A decode launch's shared memory, in bytes from its 1024-byte aligned
    base (the 128-byte swizzle's period), in _GEMV_LAYOUT's order: the
    weight rows a ring slot holds; a slot's bytes (the weight's TMA boxes,
    [4 k-boxes][slot_rows][128 k], then the activation rows padded to
    2 * 512 + 16 bytes); then, after the _GEMV_STAGES slots, four blocks'
    partials of a chunk ([8 or 16 activation rows][64 + 4] fp32 each; the
    8 blocks' go through it in two halves); rank 0's buffers for the other
    ranks' sums (two of [splits - 1][slot_rows x m] fp32); the mbarriers
    (full and empty a slot, two each for the sums); and the bytes to ask
    for, 1024 more for the alignment. The kernel lays out nothing itself."""
    k = _GEMV_STAGE_K
    slot = -(-(slot_rows * k + m * (2 * k + 16)) // 1024) * 1024
    part = _GEMV_STAGES * slot
    red = part + (_GEMV_BLOCKS // 2 * (8 if m <= 8 else 16)
                  * (_GEMV_CHUNK + 4) * 4)
    bars = -(-(red + 2 * (splits - 1) * slot_rows * m * 4) // 8) * 8
    return (slot_rows, slot, part, red, bars,
            bars + 8 * (2 * _GEMV_STAGES + 4) + 1024)


def _gemv_splits(m: int, k: int, units: int, sm_count: int) -> int:
    """The decode kernel's K splits (its cluster size) for `units` 16-row
    blocks and m activation rows: where the units alone would leave at
    least half the SMs idle, K is split over the CTAs of a cluster (2, 4 or
    8, each split at least one 512-deep stage of K), so that units x splits
    still fit the SMs; and where the runs are shorter than a 64-row chunk
    and a CTA would issue more than _GEMV_SPLIT_REQUESTS copy requests, K
    splits until either no longer holds."""
    n_kb = -(-k // _KBLOCK)
    per_stage = _GEMV_STAGE_K // _KBLOCK
    splits = 1
    while (2 * splits <= _GEMV_MAX_CLUSTER
           and 2 * splits * units <= sm_count
           and n_kb >= 2 * splits * per_stage):
        splits *= 2
    # A run shorter than a chunk is one chunk, so a split halves the copy
    # requests each CTA issues, at the cost of a cluster's sum: that pays
    # for down at M 4 and 16 (K 14336: 28 stages a CTA) and is even for q/o
    # at M 16, while q/o at M 1 and 4 ran 12% faster unsplit
    # (tools/w8a16_decode_variants.py's cluster sweep on an H100).
    while (2 * splits <= _GEMV_MAX_CLUSTER
           and -(-units // min(units, sm_count // splits)) * _GEMV_ROWS
           < _GEMV_CHUNK
           and n_kb >= 2 * splits * per_stage
           and -(-(-(-n_kb // splits)) // per_stage)
           * (_GEMV_STAGE_K // _GEMV_BOX_K + m) > _GEMV_SPLIT_REQUESTS):
        splits *= 2
    return splits


def _gemv_launch(m: int, n: int, splits: int, sm_count: int) -> W8a16Plan:
    """The decode kernel's launch at `splits` K splits: whole 16-row units
    dealt to clusters in contiguous runs, one cluster an SM (at most one
    per unit), and the layout of a slot as long as the longest run's
    chunks."""
    units = -(-n // _GEMV_ROWS)
    clusters = min(units, max(1, sm_count // splits))
    slot_rows = min(_GEMV_CHUNK, -(-units // clusters) * _GEMV_ROWS)
    return W8a16Plan(GEMV, splits, (clusters * splits,),
                     layout=_gemv_layout(m, splits, slot_rows))


def _gemv_plan(m: int, k: int, n: int, sm_count: int = H100_SMS
               ) -> W8a16Plan:
    """The decode kernel's plan: `_gemv_splits`, then `_gemv_launch`."""
    return _gemv_launch(m, n, _gemv_splits(m, k, -(-n // _GEMV_ROWS),
                                           sm_count), sm_count)


@functools.lru_cache(maxsize=1024)  # pure, and on every decode step's path
def _w8a16_plan(m: int, k: int, n: int, dtype: torch.dtype,
                aligned: bool = True, sm_count: int = H100_SMS) -> W8a16Plan:
    """The kernel and grid for x [m, k] in `dtype` times codes [n, k] on a
    card of `sm_count` SMs.

    fp32 activations, K not a multiple of 16 or an operand not 16-byte
    aligned (`aligned`: TMA's rule too) take the CUDA-core kernel. Otherwise
    up to 16 rows take the decode kernel (`_gemv_plan`: runs of 16-row
    blocks, K split in a cluster where the blocks alone would leave at
    least half the SMs idle). More rows take the wgmma kernel: the smallest
    tile of 64, 128 or 256 rows that holds m (256 beyond), 128 rows where
    256-row tiles would fill at most half the SMs, and 64 where 128-row
    units (tiles x splits) would too. Where at most half the
    SMs would have a tile (at 64 and 128 rows), K is split into as many runs
    of 64-deep stages as give each SM a unit, at most _MAX_SPLITS and each
    run at least _MIN_SPLIT_STAGES stages. Raises, naming the limit, for a
    dtype, a K or a size that no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"the W8A16 kernels take fp32, bf16 or fp16 "
                        f"activations, not {dtype}")
    if k < 1:
        raise ValueError(f"the W8A16 kernels need K >= 1, got {k}")
    if max(m * k, n * k, m * n) > _INT32_MAX:
        raise ValueError(f"M{m} K{k} N{n}: an operand or the output exceeds "
                         f"2**31 - 1 elements (the kernels' 32-bit sizes)")
    if dtype == torch.float32 or k % 16 or not aligned:
        grid = (-(-n // _SIMT_N), -(-m // _SIMT_M))
        if grid[1] > _GRID_Y_MAX:
            raise ValueError(f"M{m}: more than {_GRID_Y_MAX} row tiles of "
                             f"{_SIMT_M} for the CUDA-core kernel")
        return W8a16Plan(SIMT, 1, grid)
    n_kb = -(-k // _KBLOCK)
    if m <= _GEMV_MAX_M:
        return _gemv_plan(m, k, n, sm_count)
    bm = next((b for b in _BMS if m <= b), _BMS[-1])
    tiles, splits = _tiling(m, n, n_kb, bm, sm_count)
    if bm == 256 and 2 * tiles <= sm_count:
        bm = 128
        tiles, splits = _tiling(m, n, n_kb, bm, sm_count)
    # A split needs its stages, so a few 128-row tiles (k/v at 128 rows:
    # 8 tiles, 4 runs of 16 stages) leave most SMs idle, and 64-row tiles
    # double the units (tools/w8a16_ab.py's forced tile rows).
    if bm == 128 and 2 * tiles * splits <= sm_count:
        bm = 64
        tiles, splits = _tiling(m, n, n_kb, bm, sm_count)
    return W8a16Plan(WGMMA, splits, (min(tiles * splits, sm_count),), bm,
                     tiles)


def _tiling(m: int, n: int, n_kb: int, bm: int, sm_count: int) -> tuple:
    """(tiles, splits) of the wgmma kernel at bm-row tiles: K is split
    where at most half the SMs would have a tile, at bm <= 128."""
    tiles = -(-m // bm) * -(-n // _BN)
    if bm > _MAX_SPLIT_BM or 2 * tiles > sm_count:
        return tiles, 1
    return tiles, max(1, min(sm_count // tiles, n_kb // _MIN_SPLIT_STAGES,
                             _MAX_SPLITS))


@functools.lru_cache(maxsize=64)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [out, in]^T with fp32 output, both operands already
    in the compute dtype. Half-precision operands on CUDA go through one
    matmul with fp32 accumulation and fp32 output; elsewhere the operands
    are widened to fp32 first (the same products: a half-precision product
    is exact in fp32)."""
    if x.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def _int8_weight_matmul_plain(x, q, scale, round_before_scale=False):
    """The kernels' function in eager PyTorch: the codes cast to x's dtype,
    an fp32-accumulating matmul, then the fp32 scale and the cast back
    (`round_before_scale`: the matmul's output rounded to x's dtype before
    the scale, as the unembedding's einsum returns it). The CPU path of the
    wrapper, and the reference the kernels are held against on the card."""
    cd = x.dtype
    if round_before_scale:
        logits = F.linear(x, q.to(cd))
        return (logits.float() * scale).to(cd)
    y = _matmul_f32(x, q.to(cd))
    return y.mul_(scale).to(cd)  # in place: y is this call's own


def _int8_weight_matmul_cuda(x2, q, scale, round_before_scale=False):
    """Launch the kernel of csrc/w8a16.cu that `_w8a16_plan` picks for x2
    [M, K], on the current stream (no synchronise)."""
    global w8a16_launches, w8a16_wgmma_launches
    dev = x2.device
    for name, t, dtype in (("q", q, torch.int8), ("scale", scale,
                                                  torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"the W8A16 kernels take {name} as {dtype}, not "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x2.shape
    n = q.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    plan = _w8a16_plan(m, k, n, x2.dtype, x2.data_ptr() % 16 == 0
                       and q.data_ptr() % 16 == 0, _sm_count(dev.index))
    from kubeflow_tpu_torch.ops import _build

    fn = _build.function("w8a16.cu", "tpk_w8a16")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = tickets = None  # held until the launch is enqueued
    if plan.kernel == WGMMA and plan.splits > 1:
        # A whole tile of fp32 partials per unit; the tickets are the W8A8
        # op's counters (one per tile): every launch leaves them at zero, and
        # launches on one stream run in order. The decode kernel sums its
        # splits inside a cluster and takes neither.
        ws = torch.empty(plan.units * plan.bm * _BN, dtype=torch.float32,
                         device=dev)
        tickets = _tickets_for(dev, stream, plan.tiles)
    args = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), m, k, n,
            _DTYPES[x2.dtype], int(round_before_scale),
            *_launch_tail(plan), stream)
    # A launch goes to the thread's current device: enter x's only when it
    # is another (the context costs host time on every decode projection).
    if torch.cuda.current_device() == dev.index:
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed: CUDA error {err}")
    with _count_lock:
        w8a16_launches += 1
        w8a16_wgmma_launches += plan.kernel == WGMMA
    return out


def _launch_tail(plan: W8a16Plan) -> tuple:
    """tpk_w8a16's arguments from `kernel` to the layout's last: the decode
    kernel's grid and layout; zeros for the kernels that take neither."""
    if plan.kernel == GEMV:
        return (_KERNEL_IDS[GEMV], 0, plan.splits, plan.grid[0],
                *plan.layout)
    return (_KERNEL_IDS[plan.kernel], plan.bm, plan.splits, 0,
            *(0,) * len(_GEMV_LAYOUT))


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor, *,
                       round_before_scale: bool = False) -> torch.Tensor:
    """x [..., K] in the compute dtype; q [N, K] int8 codes; scale [N] fp32
    per output channel. Returns [..., N] in x's dtype: the fp32 sum of x
    times the codes, times the scale (`round_before_scale`: the sum first
    rounded to x's dtype, the unembedding's epilogue), cast to x's dtype.

    On the card the call is enqueued on the current stream after whatever
    is there, x and q included: the decode kernel may be launched while the
    kernel before it finishes (programmatic dependent launch), but reads
    neither operand before that kernel's writes are visible."""
    if q.dim() != 2 or scale.shape != (q.shape[0],) or x.shape[-1:] != (
            q.shape[1],):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if x.device.type == "cpu":
        return _int8_weight_matmul_plain(x, q, scale, round_before_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_weight_matmul runs on cuda or cpu, not "
                         f"{x.device.type}")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _int8_weight_matmul_cuda(x2, q, scale, round_before_scale)
    return out.reshape(*x.shape[:-1], q.shape[0])
