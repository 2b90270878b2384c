// W8A8 int8 matmul for Hopper (sm_90a): int8 x int8 -> int32 on the tensor
// cores, with the per-row x per-column rescale fused into the epilogue.
//
// Replaces the TPU kernel kubeflow_tpu/ops/quant_matmul.py::_qmm_kernel
// (launched by int8_matmul):
//
//     out[m, n] = (float)(sum_k qx[m, k] * qw[k, n]) * sx[m] * sw[n]
//
// multiplied in that order, each product rounded to fp32 (no FMA
// contraction), then cast to the output type (fp32 or bf16). The int32 sum
// is exact for K <= 133,000, in any order, so the kernel agrees bit for bit
// with a plain version that sums exactly and applies the same epilogue.
// Per-row activation quantization (sx, qx) stays outside, in the wrapper,
// as the JAX package keeps it outside its pallas_call.
//
// Layout (the JAX package's, no transposes or packed copies on the host):
//   qx [M, K] int8 (K contiguous), sx [M] fp32,
//   qw [K, N] int8 (N contiguous), sw [N] fp32, out [M, N] fp32 or bf16.
//
// What bounds it on this card. At prefill widths (M = 2048, K = 4096,
// N = 14336) the product is 2*M*K*N int8 operations against ~(M*K + K*N)
// bytes in and 4*M*N bytes out: far above the H100's int8 ridge, so the
// tensor cores bound it (1,979 TOP/s dense), and only wgmma reaches that
// rate. At decode widths (M = 32) every weight byte serves only 2*M
// operations: reading qw once (K*N bytes at 3.35 TB/s) bounds it, and the
// stream has to come from every SM.
//
// The design (qmm_wgmma_kernel). s8 wgmma reads shared-memory operands
// K-major only (the transpose bits exist for 16-bit types), and qw is
// N-major. So A and B are swapped: each consumer warpgroup computes a tile
// of out^T, whose 64 wgmma rows are 64 weight columns n and whose wgmma
// columns are BM activation rows m (32 at decode, up to 256 at prefill).
//   * B, the activations, arrive by TMA as K-major [BM][128 k] tiles with
//     the 128-byte swizzle, and wgmma reads them by descriptor.
//   * A, the weight, lands by TMA as it lies, a [128 k][128 n] tile (also
//     128-byte swizzled), and each consumer builds its register fragments
//     from it: one ldmatrix.x4.trans a 32-deep k step gives each thread the
//     16-bit pairs (n, n + 1) of four k rows, and four byte permutes turn
//     them into the four words of 4 k bytes that wgmma's A fragment wants.
//     A row g of a warp's 16 is column 2g of its 16 n, row g + 8 column
//     2g + 1 (the rows' order is free: the epilogue maps them back).
//     Nothing is written back to shared memory, so the whole transpose
//     costs 4 ldmatrix and 16 prmt a warp per 128-deep stage.
//     The alternative, transposing the tile into a K-major shared copy and
//     reading both operands by descriptor, would add two bytes of
//     shared-memory traffic per weight byte; it was not built.
//   * One persistent CTA per SM: a producer warp (registers given away with
//     setmaxnreg.dec) issues both copies of each stage into a ring of
//     full/empty mbarriers, running ahead across tiles, so one tile's
//     epilogue overlaps the next tile's copies; two consumer warpgroups of
//     64 n each (setmaxnreg.inc) issue a stage's four wgmma in one group
//     while the next stage's fragments are built into the other of two
//     register sets. At 32- to 128-row tiles the four rotate over four or
//     two accumulators, summed once a tile: four products into one
//     accumulator wait for each other, and there the math is too short to
//     hide that.
//   * Work units are (tile, split). Tiles are dealt with m fastest, so the
//     CTAs running together share one 128-column strip of qw (58.7 MB at 8B
//     widths, more than the 50 MB L2) while the activations stay in L2.
//   * Split-K at decode widths. A CTA streams the weight at well under the
//     card's share of memory bandwidth per SM, so a few tiles alone (k/v
//     projections at N 1024: 8 tiles) leave the stream short. There the
//     wrapper splits K (a pure function of the shape, _qmm_plan in
//     ops/quant_matmul.py) into contiguous runs of 128-deep stages, at 32-
//     and 64-row tiles only. Each split stores its int32 partial tile to
//     ws[split]; the last split of a tile to arrive (a ticket counter per
//     tile, behind one release fence) sums every split's partial from L2,
//     rescales once and writes the output, then resets the ticket to 0, so
//     the counters stay zero between launches. int32 sums are exact in any
//     order: the same bits as one split.
//   * The epilogue writes each m row's 16 consecutive n of a warp as one
//     64-byte (fp32) or 32-byte (bf16) run: whole sectors.
//
// Shapes TMA cannot describe (K % 16 or N % 16 not 0, an operand not
// 16-byte aligned, K = 0) run qmm_bytewise_kernel: mma.sync m16n8k32 with
// tiles staged byte by byte into shared memory and zero-filled past the
// edges (the JAX test's K 100 and N 200 go there). The wrapper chooses by
// shape before the launch; this entry point refuses a wgmma plan for a
// shape TMA cannot take, and never switches kernels itself.

#include "gemm_sm90.cuh"  // gemm90 (and fwd90): TMA, units, the split-K ticket

namespace {

using fwd90::smem_u32;
using gemm90::Unit;

// ---------------------------------------------------------------- wgmma kernel

constexpr int kBN = 128;           // weight columns n per tile: two warpgroups of 64
constexpr int kBK = 128;           // k bytes per stage: one swizzle row of each operand
constexpr int kWBytes = kBK * kBN;  // one weight tile
constexpr int kRingBytes = 196608;  // the stage ring's budget of shared memory

// Dynamic shared memory from a 1024-byte aligned base: kStages of (weight
// tile, activation tile), each 128-byte swizzled, then the full and empty
// mbarriers and the ticket flag.
template <int BM>
struct Layout {
  static constexpr int kABytes = BM * kBK;
  static constexpr int kStageBytes = kWBytes + kABytes;
  static constexpr int kStages = kRingBytes / kStageBytes < 9 ? kRingBytes / kStageBytes : 9;
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kBytes = kBars + 16 * kStages + 16 + 1024;
  // Independent accumulators a stage's four k steps rotate over: four
  // wgmma into one accumulator wait for each other, and at 32 to 128
  // columns that latency, not the math, would set the pace.
  static constexpr int kAccs = BM <= 64 ? 4 : BM == 128 ? 2 : 1;
  // Whether K may be split: at the decode heights (32 and 64 rows) where
  // few tiles leave the weight stream short of streams; compiled out of the
  // larger tiles (beside the split reduction the 256-row tile spilled).
  static constexpr bool kSplits = BM <= 64;
  __device__ static uint32_t w(int st) { return st * kStageBytes; }
  __device__ static uint32_t a(int st) { return st * kStageBytes + kWBytes; }
};

struct Params {
  CUtensorMap wmap;  // qw: dims (N, K), boxes of 128 n x 128 k
  CUtensorMap amap;  // qx: dims (K, M), boxes of 128 k x BM m
  const float* sx;
  const float* sw;
  void* out;
  int* ws;       // [splits, M, N] int32 partial tiles (splits > 1)
  int* tickets;  // one per tile (splits > 1): 0 before and after a launch
  int M, N, splits, m_tiles, n_k;
  int units;     // tiles x splits
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d += A B for one m64n32k32 step: A (64 x 32 int8) from registers, B
// (32 x 32 int8) from shared memory, K-major; int32 accumulators.
__device__ __forceinline__ void wgmma_s8(int (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for one m64n64k32 step: A (64 x 32 int8) from registers, B
// (64 x 32 int8) from shared memory, K-major; int32 accumulators.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for one m64n128k32 step: A (64 x 32 int8) from registers, B
// (128 x 32 int8) from shared memory, K-major; int32 accumulators.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for one m64n256k32 step: A (64 x 32 int8) from registers, B
// (256 x 32 int8) from shared memory, K-major; int32 accumulators.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A fragments of the four 32-deep k steps of one stage for this thread's
// rows g, g + 8 (weight columns 2g, 2g + 1 of the warp's 16). `lane_at`
// is the lane's ldmatrix row address within a weight tile: matrix q = lane
// / 8 (k half q / 2, k pair q % 2), row r = lane % 8 -> k row 16(q / 2) +
// 4(r / 2) + 2(q % 2) + r % 2, so that .trans hands thread t the k rows 4t,
// 4t + 1 (matrix 0), 4t + 2, 4t + 3 (matrix 1), and 16 more (2 and 3).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t wtile, uint32_t lane_at) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t r[4];
    ldsm_x4_trans(r, wtile + lane_at + kk * 32 * kBK);  // 32 k rows a step
    // r[q] = (k, n) (k, n + 1) (k + 1, n) (k + 1, n + 1), lowest byte first
    a[kk][0] = __byte_perm(r[0], r[1], 0x6420);  // row g:     k 4t .. 4t + 3
    a[kk][1] = __byte_perm(r[0], r[1], 0x7531);  // row g + 8
    a[kk][2] = __byte_perm(r[2], r[3], 0x6420);  // row g:     k 16 + 4t ..
    a[kk][3] = __byte_perm(r[2], r[3], 0x7531);  // row g + 8
  }
}

// One stage of the ring for the consumers: wait for its copies, build its
// fragments into `a`, issue its four products (rotating over the
// accumulators) as one group, then, once the previous stage's group has
// landed, free the previous stage's slot.
template <int BM>
__device__ __forceinline__ void mma_stage(int (&acc)[Layout<BM>::kAccs][BM / 2],
                                          uint32_t (&a)[4][4], uint32_t base, uint32_t bars,
                                          uint32_t lane_at, int& g, bool free_prev) {
  using L = Layout<BM>;
  constexpr int S = L::kStages;
  const int st = g % S;
  fwd90::mbar_wait(bars + 8u * st, (g / S) & 1);
  load_a(a, base + L::w(st), lane_at);
  fwd90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_s8(acc[kk % L::kAccs], a[kk], fwd90::sw128_desc(base + L::a(st) + kk * 32, 16, 1024));
  fwd90::wgmma_commit();
  fwd90::wgmma_wait<1>();
  if (free_prev) fwd90::mbar_arrive(bars + 8u * (S + (g + S - 1) % S));
  ++g;
}

template <int BM, bool kBf16Out>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ Params p) {
  using L = Layout<BM>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBars;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (S + st); };
  volatile int* last_flag = reinterpret_cast<volatile int*>(smem_raw + (bars + 16u * S - raw));

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      fwd90::mbar_init(full(st), 1);
      fwd90::mbar_init(empty(st), fwd90::kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    fwd90::regs_dec<40>();
    if (threadIdx.x == 0) {
      int g = 0;  // stages loaded by this CTA: the ring runs on across units
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit w = gemm90::unit_of(u, p.splits, p.m_tiles, p.n_k, BM, kBN);
        for (int c = w.c0; c < w.c1; ++c, ++g) {
          const int st = g % S;
          fwd90::mbar_wait(empty(st), ((g / S) & 1) ^ 1);  // round 0 passes at once
          fwd90::mbar_expect_tx(full(st), L::kStageBytes);
          gemm90::tma_load_2d(base + L::w(st), &p.wmap, full(st), w.n0, c * kBK);
          gemm90::tma_load_2d(base + L::a(st), &p.amap, full(st), c * kBK, w.m0);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  fwd90::regs_inc<232>();
  const int ct = threadIdx.x - 128;
  const int cw = __shfl_sync(0xffffffffu, ct >> 7, 0);  // warp-uniform
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int chunk = cw * 4 + warp;  // the warp's 16 n bytes of a 128-byte row
  const int q = lane >> 3, r = lane & 7;
  const int krow = (q >> 1) * 16 + 4 * (r >> 1) + 2 * (q & 1) + (r & 1);
  const uint32_t lane_at = krow * kBK + ((chunk ^ (krow & 7)) << 4);  // 128-byte swizzle

  uint32_t af[2][4][4];  // two stages' A fragments: one built while the other is read
  int g = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = gemm90::unit_of(u, p.splits, p.m_tiles, p.n_k, BM, kBN);
    int accs[L::kAccs][BM / 2];
#pragma unroll
    for (int x = 0; x < L::kAccs; ++x)
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) accs[x][i] = 0;

    // Stages alternate between the two fragment sets, so that one stage's
    // fragments are built while the other's products still read theirs.
    int c = w.c0;
    for (; c + 1 < w.c1; c += 2) {
      mma_stage<BM>(accs, af[0], base, bars, lane_at, g, c > w.c0);
      mma_stage<BM>(accs, af[1], base, bars, lane_at, g, true);
    }
    if (c < w.c1) mma_stage<BM>(accs, af[0], base, bars, lane_at, g, c > w.c0);
    fwd90::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < L::kAccs; ++x) fence_acc(accs[x]);
    fwd90::mbar_arrive(empty((g + S - 1) % S));
    int (&acc)[BM / 2] = accs[0];
#pragma unroll
    for (int x = 1; x < L::kAccs; ++x)
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) acc[i] += accs[x][i];

    // acc[4j + 2i + e] is column n_lo + i, row m0 + 8j + 2t + e.
    const int n_lo = w.n0 + chunk * 16 + 2 * g8;
    const bool n_ok = n_lo < p.N;  // N % 16 == 0: a warp's 16 columns are in or out
    if (L::kSplits && p.splits > 1) {
      int* own = p.ws + static_cast<size_t>(w.split) * p.M * p.N;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = w.m0 + 8 * j + 2 * t + e;
          if (n_ok && m < p.M)
            *reinterpret_cast<int2*>(own + static_cast<size_t>(m) * p.N + n_lo) =
                make_int2(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
      }
      if (!gemm90::last_split(p.tickets, w.tile, p.splits, ct, last_flag)) continue;
      // The last split sums every partial (its own included) from L2: four
      // rows of 8 m at a time, from four splits at once.
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
#pragma unroll
      for (int j0 = 0; j0 < BM / 8; j0 += 4) {
#pragma unroll 4
        for (int sp = 0; sp < p.splits; ++sp) {
          const int* part = p.ws + static_cast<size_t>(sp) * p.M * p.N;
#pragma unroll
          for (int j = j0; j < j0 + 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = w.m0 + 8 * j + 2 * t + e;
              if (n_ok && m < p.M) {
                const int2 v = __ldcg(reinterpret_cast<const int2*>(
                    part + static_cast<size_t>(m) * p.N + n_lo));
                acc[4 * j + e] += v.x;
                acc[4 * j + 2 + e] += v.y;
              }
            }
          }
        }
      }
    }
    if (!n_ok) continue;
    const float sw0 = __ldg(p.sw + n_lo), sw1 = __ldg(p.sw + n_lo + 1);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = w.m0 + 8 * j + 2 * t + e;
        if (m >= p.M) continue;
        const float sxm = __ldg(p.sx + m);
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), sxm), sw0);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 + e]), sxm), sw1);
        const size_t at = static_cast<size_t>(m) * p.N + n_lo;
        if (kBf16Out) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at) =
              __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) = make_float2(v0, v1);
        }
      }
    }
  }
}

// The map of a contiguous int8 [outer, inner] matrix: boxes of (128,
// box_outer), 128-byte swizzle, zero fill out of bounds.
bool encode_2d(CUtensorMap* map, const void* ptr, int inner, int outer, int box_outer) {
  return gemm90::encode_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, inner, outer, 128,
                           box_outer, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BM>
int launch_wgmma(Params& p, const void* qx, const void* qw, int K, bool bf16,
                 cudaStream_t st) {
  if (!encode_2d(&p.wmap, qw, p.N, K, kBK) || !encode_2d(&p.amap, qx, K, p.M, BM))
    return static_cast<int>(cudaErrorInvalidValue);
  p.m_tiles = (p.M + BM - 1) / BM;
  p.units = p.m_tiles * ((p.N + kBN - 1) / kBN) * p.splits;
  constexpr int kSmem = Layout<BM>::kBytes;
  return bf16 ? fwd90::launch<qmm_wgmma_kernel<BM, true>, kSmem>(p, p.units, st)
              : fwd90::launch<qmm_wgmma_kernel<BM, false>, kSmem>(p, p.units, st);
}

// ---------------------------------------------------------------- byte-wise kernel
// The mma.sync design for the shapes TMA cannot take: 128 x 128 output tiles, 8
// warps of 64 x 32 on mma.sync m16n8k32, tiles staged byte by byte into
// shared memory and zero-filled past M, N and K (zeros add nothing to the
// sums). Each B tile lands raw ([BK][BN], n contiguous) and is transposed
// shared-to-shared with byte permutes into k-contiguous rows, so that a
// plain ldmatrix yields the A and the B fragments alike.
namespace bw {

constexpr int kBM = 128;   // output rows per CTA
constexpr int kBN = 128;   // output columns per CTA
constexpr int kBK = 64;    // k bytes per stage
constexpr int kStages = 4;
constexpr int kLds = kBK + 16;   // padded A / transposed-B row, bytes
constexpr int kLdr = kBN + 16;   // padded raw-B row, bytes
constexpr int kThreads = 256;
constexpr int kWM = 64;    // rows per warp
constexpr int kWN = 32;    // columns per warp
constexpr int kMT = kWM / 16;  // m16 tiles per warp
constexpr int kNT = kWN / 8;   // n8 tiles per warp

struct Smem {
  int8_t a[kStages][kBM][kLds];    // A tiles, k contiguous
  int8_t raw[kStages][kBK][kLdr];  // B tiles as they land, n contiguous
  int8_t b[kBN][kLds];             // the current B tile, k contiguous
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b for one m16n8k32 tile: a row-major 16x32 int8 (4 regs),
// b column-major 32x8 int8 (2 regs), c 16x8 int32 (4 regs).
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of a row-major int8 matrix from (row, col), zero past its edges,
// byte by byte.
__device__ __forceinline__ uint4 load16_bytewise(const int8_t* __restrict__ p,
                                                 int rows, int cols, int row,
                                                 int col) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) {
      const int c = col + q * 4 + byte;
      const uint32_t v =
          (row < rows && c < cols) ? (uint8_t)p[(size_t)row * cols + c] : 0u;
      word |= v << (8 * byte);
    }
    w[q] = word;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage K tile `k0` of A and of raw B into stage `st`: 512 16-byte chunks of
// each, two per thread.
__device__ __forceinline__ void load_tile(Smem& s, int st,
                                          const int8_t* __restrict__ qx,
                                          const int8_t* __restrict__ qw,
                                          int M, int K, int N, int m0, int n0,
                                          int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    const int ar = c / 4, ac = (c % 4) * 16;       // A: 128 rows x 4
    const int br = c / 8, bc = (c % 8) * 16;       // B: 64 rows x 8
    *reinterpret_cast<uint4*>(&s.a[st][ar][ac]) =
        load16_bytewise(qx, M, K, m0 + ar, k0 + ac);
    *reinterpret_cast<uint4*>(&s.raw[st][br][bc]) =
        load16_bytewise(qw, K, N, k0 + br, n0 + bc);
  }
}

// Four words of column bytes j = 0..3 of rows r0..r3: word j holds
// (r0[j], r1[j], r2[j], r3[j]), lowest byte first.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t out[4]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Raw B tile of stage `st` -> s.b, k contiguous: each thread moves a 4 (k) x
// 8 (n) block.
__device__ __forceinline__ void transpose_b(Smem& s, int st, int tid) {
  const int kg = tid % 16, ng = tid / 16;
  uint2 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const uint2*>(&s.raw[st][kg * 4 + i][ng * 8]);
  uint32_t lo[4], hi[4];
  transpose4(r[0].x, r[1].x, r[2].x, r[3].x, lo);  // n + 0..3
  transpose4(r[0].y, r[1].y, r[2].y, r[3].y, hi);  // n + 4..7
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<uint32_t*>(&s.b[ng * 8 + j][kg * 4]) = lo[j];
    *reinterpret_cast<uint32_t*>(&s.b[ng * 8 + 4 + j][kg * 4]) = hi[j];
  }
}

}  // namespace bw

template <bool kBf16Out>
__global__ void __launch_bounds__(bw::kThreads, 2)
qmm_bytewise_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
                    const int8_t* __restrict__ qw, const float* __restrict__ sw,
                    void* __restrict__ out, int M, int K, int N) {
  using bw::kBM, bw::kBN, bw::kBK, bw::kStages, bw::kWM, bw::kWN, bw::kMT, bw::kNT;
  using bw::Smem, bw::ldmatrix_x4, bw::mma_s8, bw::load_tile, bw::transpose_b;
  extern __shared__ __align__(16) uint8_t smem_bytes[];
  Smem& s = *reinterpret_cast<Smem*>(smem_bytes);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;
  // Rows wholly past M hold zeros: their warps only help move tiles.
  const bool active = m0 + wm < M;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int n_tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(s, t, qx, qw, M, K, N, m0, n0, t * kBK, tid);
  }

  // ldmatrix lane addressing: lane l gives row (l % 8) of matrix (l / 8).
  const int lrow = lane % 8, lmat = lane / 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    // Every thread's stores of tile t are done, and every warp is done
    // with tile t - 1 (its A stage and s.b may be overwritten).
    __syncthreads();
    transpose_b(s, st, tid);
    const int next = t + kStages - 1;
    if (next < n_tiles)
      load_tile(s, next % kStages, qx, qw, M, K, N, m0, n0, next * kBK, tid);
    __syncthreads();  // s.b holds tile t
    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // matrices: rows 0-7 / 8-15 of k bytes 0-15, then of 16-31.
        ldmatrix_x4(a[i], &s.a[st][wm + i * 16 + (lmat % 2) * 8 + lrow]
                                 [kk + (lmat / 2) * 16]);
      }
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        // matrices: n-tile j k 0-15, k 16-31, then n-tile j + 1.
        uint32_t r[4];
        ldmatrix_x4(r, &s.b[wn + (j + lmat / 2) * 8 + lrow]
                           [kk + (lmat % 2) * 16]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  if (!active) return;
  // Accumulator layout: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row
  // g + 8 (g = lane / 4, t = lane % 4).
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float sxm = sx[m];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + tq * 2 + e;
          if (n >= N) continue;
          const float v = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), sxm), sw[n]);
          if (kBf16Out) {
            static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] =
                __float2bfloat16_rn(v);
          } else {
            static_cast<float*>(out)[(size_t)m * N + n] = v;
          }
        }
      }
    }
  }
}

template <bool kBf16Out>
cudaError_t launch_bytewise(const int8_t* qx, const float* sx, const int8_t* qw,
                            const float* sw, void* out, int M, int K, int N,
                            cudaStream_t st) {
  auto* kernel = qmm_bytewise_kernel<kBf16Out>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(bw::Smem)));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + bw::kBM - 1) / bw::kBM, (N + bw::kBN - 1) / bw::kBN);
  kernel<<<grid, bw::kThreads, sizeof(bw::Smem), st>>>(qx, sx, qw, sw, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// bm: 0 = the byte-wise kernel, else the wgmma kernel's activation rows per
// tile (32, 64, 128 or 256), with K cut into `splits` runs of 128-deep
// stages (bm 32 and 64 only); ws ([splits, M, N] int32) and tickets (one int
// per tile, all 0) are read only when splits > 1. out_bf16: 0 = fp32 output, 1 = bf16.
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for a plan the
// kernel does not take.
extern "C" int tpk_qmm(const void* qx, const void* sx, const void* qw, const void* sw,
                       void* out, void* ws, void* tickets, int M, int K, int N,
                       int out_bf16, int bm, int splits, void* stream) {
  if (M < 0 || K < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  if (bm == 0) {
    if ((N + bw::kBN - 1) / bw::kBN > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const auto* a = static_cast<const int8_t*>(qx);
    const auto* b = static_cast<const int8_t*>(qw);
    return static_cast<int>(out_bf16 ? launch_bytewise<true>(a, sxp, b, swp, out, M, K, N, st)
                                     : launch_bytewise<false>(a, sxp, b, swp, out, M, K, N, st));
  }
  const int n_k = (K + kBK - 1) / kBK;
  if (K == 0 || K % 16 != 0 || N % 16 != 0 || reinterpret_cast<uintptr_t>(qx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qw) % 16 != 0 || splits < 1 || splits > n_k ||
      (splits > 1 && (bm > 64 || ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.sx = sxp;
  p.sw = swp;
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.M = M;
  p.N = N;
  p.splits = splits;
  p.n_k = n_k;
  const bool bf16 = out_bf16 != 0;
  switch (bm) {
    case 32: return launch_wgmma<32>(p, qx, qw, K, bf16, st);
    case 64: return launch_wgmma<64>(p, qx, qw, K, bf16, st);
    case 128: return launch_wgmma<128>(p, qx, qw, K, bf16, st);
    case 256: return launch_wgmma<256>(p, qx, qw, K, bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
