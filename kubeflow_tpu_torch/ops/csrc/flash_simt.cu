// Flash attention on the CUDA cores (sm_90a): forward, dq and dk/dv for the
// inputs the wgmma kernels (flash_fwd.cu, flash_bwd.cu) do not take — fp32,
// bf16 or fp16 q/k/v at any head dim up to 256.
//
// Replaces, for those inputs, the same TPU kernels as the wgmma kernels:
// kubeflow_tpu/ops/flash_attention.py::_flash_fwd_kernel, _flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel. The TPU kernels read any dtype and head dim and
// compute in fp32 (Mosaic pads a narrow head dim to the 128 lanes); so do
// these: every input is widened to fp32 before it is multiplied, every
// product and sum is fp32 on the CUDA cores, and only the outputs are
// rounded to the input dtype. An fp32 model therefore gets fp32 attention,
// not a bf16 one.
//
// What bounds them on this card: fp32 FMAs on the CUDA cores (67 TFLOP/s at
// 700 W), not the tensor cores and not memory. Each visible (q, k) pair
// costs 4*D flops forward, 6*D for dq and 8*D for dk/dv. An SM issues 128
// fp32 FMAs a clock but serves 32 words of shared memory a clock, so a
// kernel that reads an operand from shared memory for every FMA runs at a
// quarter of the FMA rate at best.
//
// The forward is the simple design: a warp owns 4 rows; each lane owns one
// key of a 32-row tile for the dot products, and D/32 columns of the
// accumulator, with the per-key weights broadcast by shuffle.
//
// The backward pair is register-tiled. 256 threads form a 16 x 16 grid. A
// CTA owns R rows (dq: query rows of one head; dk/dv: key rows of one kv
// head) and streams the other operand in tiles of N rows (64, or 32 where
// two stages of 64 would not fit in shared memory, or would keep a second
// 16-row CTA off the SM; BwdTile) through a two-stage ring filled by
// 16-byte cp.async copies, so the next tile lands while this one is
// computed. Shared tiles keep the input dtype; a thread widens each
// 4-element fragment to fp32 as it loads it (an exact conversion), and
// computes a (R/16) x (N/16) micro-tile of S and dP as outer products over
// d: R/16 + N/16 vector loads per 4 * (R/16) * (N/16) FMAs. P and dS go
// through shared memory once per tile; dQ += dS K (or dV += P^T dO and
// dK += dS^T Q) is a second register-tiled product into per-thread slices
// of the [R, D] accumulators, which stay in registers across the walk. A
// tile that lies wholly inside the visible region runs no per-element mask
// test; only tiles on the causal diagonal, a window edge, the prefix
// boundary, past S or T, or with segment ids (read from the tile's ids in
// shared memory) do. The host's plan (_simt_bwd_plan) picks R per pass so
// the grid fills the SMs and, where dk/dv's key blocks still would not,
// splits each block's walk over (GQA head, q tile) across CTAs: each split
// writes fp32 partials to a workspace, and the last to arrive sums them in
// split order behind gemm90::last_split's ticket (deterministic; no atomics
// on the gradients).
//
// Semantics are the plain versions' (_flash_fwd_plain, _flash_bwd_plain):
// scale 1/sqrt(D), masked scores -1e30 (a row's visible columns: below T,
// causal, prefix-LM, sliding window, equal segment ids), lse = m + log(max(l,
// 1e-30)); p = exp(s - lse) set to exactly 0 where masked; ds = p (dp -
// delta); dk, dv summed over the GQA group without atomics.
//
// Layout (the JAX package's): q/dO/o/dq [B, S, H, D], k/v/dk/dv [B, T, KH,
// D], lse and delta [B, S, H] fp32, seg [B, S] int32 or null.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"  // gemm90::last_split: the split ticket the matmuls use

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a CTA owns
constexpr int kTile = 32;                     // rows a streamed tile holds
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

enum MaskKind { kCausal = 0, kFullMask = 1, kPrefixLM = 2, kSlidingWindow = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Params {
  const void *q, *k, *v, *dout, *out;
  const float *lse_in, *delta;
  const int* seg;
  void *o, *dq, *dk, *dv;
  float* lse;
  float* ws;     // dk/dv split partials, or null
  int* tickets;  // one per dk/dv key block where split, or null
  int B, S, T, H, KH, D, kind, window, prefix;
  int splits;  // dk/dv CTAs per key block
  bool vec;    // 16-byte copies: q, k, v, dO 16-byte aligned and D * size a multiple of 16
  float scale;
};

// Whether query row `row` sees key column `col` under the mask kind alone.
__device__ __forceinline__ bool mask_visible(const Params& p, int row, int col) {
  switch (p.kind) {
    case kCausal: return row >= col;
    case kPrefixLM: return row >= col || col < p.prefix;
    case kSlidingWindow: return row >= col && row - col < p.window;
    default: return true;
  }
}

// Whether query row `row` sees key column `col` (both in range) under the
// mask kind and the segment ids of batch row `seg` (null: no segments).
__device__ __forceinline__ bool visible(const Params& p, const int* seg, int row, int col) {
  return mask_visible(p, row, col) && (seg == nullptr || seg[row] == seg[col]);
}

// Whether every query row of [r0, r1] sees every key column of [c0, c1]
// under the mask kind alone.
__device__ __forceinline__ bool all_visible(const Params& p, int r0, int r1, int c0, int c1) {
  switch (p.kind) {
    case kCausal: return c1 <= r0;
    case kPrefixLM: return c1 <= r0 || c1 < p.prefix;
    case kSlidingWindow: return c1 <= r0 && r1 - c0 < p.window;
    default: return true;
  }
}

// The key columns [lo, hi] that query rows [r0, r1] may see.
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1, int& lo, int& hi) {
  lo = 0;
  hi = p.T - 1;
  if (p.kind == kCausal || p.kind == kSlidingWindow) hi = min(hi, r1);
  if (p.kind == kPrefixLM) hi = min(hi, max(r1, p.prefix - 1));
  if (p.kind == kSlidingWindow) lo = max(0, r0 - p.window + 1);
}

// The query rows [lo, hi] that key columns [c0, c1] may be seen by.
__device__ __forceinline__ void query_range(const Params& p, int c0, int c1, int& lo, int& hi) {
  lo = 0;
  hi = p.S - 1;
  if (p.kind == kCausal || p.kind == kSlidingWindow) lo = c0;
  if (p.kind == kPrefixLM) lo = c0 < p.prefix ? 0 : c0;
  if (p.kind == kSlidingWindow) hi = min(hi, c1 + p.window - 1);
}

// rows x DM floats at `dst` (row stride `ld`) from rows [r0, r0 + rows) of
// head `head` of a [B, N, heads, D] tensor; zeros past N and past D.
template <typename T, int DM>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int rows, int r0,
                                          int N, int b, int heads, int head, int D) {
  for (int i = threadIdx.x; i < rows * DM; i += kThreads) {
    const int r = i / DM, c = i % DM, n = r0 + r;
    float x = 0.f;
    if (n < N && c < D) x = to_f(src[((static_cast<long>(b) * N + n) * heads + head) * D + c]);
    dst[r * ld + c] = x;
  }
}

// dot of two D-float rows of shared memory.
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// ---- forward ------------------------------------------------------------
// CTA: kRows query rows of one (b, h). Shared: Q [kRows][DM], K [kTile][DM+1]
// (padded so that lane j's row walk hits its own bank), V [kTile][DM].
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_simt_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kRows * DM;
  float* sv = sk + kTile * (DM + 1);
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<long>(b) * p.S;
  constexpr int kC = DM / 32;

  load_rows<T, DM>(sq, DM, static_cast<const T*>(p.q), kRows, r0, p.S, b, p.H, h, p.D);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf * kLog2e;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  key_range(p, r0, min(r0 + kRows, p.S) - 1, lo, hi);
  const float scale_log2 = p.scale * kLog2e;
  for (int t0 = lo / kTile * kTile; t0 <= hi; t0 += kTile) {
    __syncthreads();
    load_rows<T, DM>(sk, DM + 1, static_cast<const T*>(p.k), kTile, t0, p.T, b, p.KH, kh, p.D);
    load_rows<T, DM>(sv, DM, static_cast<const T*>(p.v), kTile, t0, p.T, b, p.KH, kh, p.D);
    __syncthreads();
    const int col = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rr = warp * kRowsPerWarp + i, row = r0 + rr;
      if (row >= p.S) continue;  // uniform across the warp
      const bool vis = col < p.T && visible(p, seg, row, col);
      // Log2 domain: s2 = s * scale * log2(e); masked scores are -1e30.
      const float s2 = vis ? dot(sq + rr * DM, sk + lane * (DM + 1), p.D) * scale_log2
                           : kNegInf * kLog2e;
      const float m_new = fmaxf(m[i], warp_max(s2));
      const float alpha = exp2f(m[i] - m_new);
      const float pr = exp2f(s2 - m_new);
      l[i] = l[i] * alpha + warp_sum(pr);
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(kFull, pr, j);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pj, sv[j * DM + lane + 32 * c], acc[i][c]);
      }
      m[i] = m_new;
    }
  }
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    if (row >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const long base = ((static_cast<long>(b) * p.S + row) * p.H + h);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) o[base * p.D + d] = from_f<T>(acc[i][c] / lc);
    }
    if (lane == 0) p.lse[base] = m[i] * kLn2 + logf(lc);
  }
}

// ---- backward: the register-tiled pair ------------------------------------
constexpr int kBwdThreads = 256;  // a kGrid x kGrid grid of threads
constexpr int kGrid = 16;
constexpr int kStages = 2;            // streamed tiles in flight
constexpr int kSmemMax = 232448;      // an H100 CTA's dynamic shared memory
constexpr int kMaxSplits = 16;
static_assert(kBwdThreads == fwd90::kConsumerThreads,
              "gemm90::last_split's barrier counts fwd90::kConsumerThreads threads");

// The shared-memory plan of one pass (dq, or dk/dv when kDkv) at head-dim
// bucket DM, R owned rows and element type T: the owned rows' two operands
// [R][kLd] (Q and dO, or K and V), a ring of kStages stages of the streamed
// tile's two operands [kN][kLd] and its per-row words (the keys' segment
// ids; or the queries' lse, delta and segment ids), then fp32 dS [R][kLdw]
// (and P for dk/dv). Rows are padded by 16 bytes, so that the rows of a
// warp's fragment loads fall in distinct banks.
template <typename T, bool kDkv>
constexpr int bwd_smem_bytes(int dm, int rows, int n, int pbufs) {
  const int size = static_cast<int>(sizeof(T));
  const int ld = dm + 16 / size;
  const int stage = 2 * n * ld * size + (kDkv ? 3 : 1) * n * 4;
  return 2 * rows * ld * size + kStages * stage + pbufs * rows * (n + 8) * 4;
}

template <typename T, int DM, int R, bool kDkv>
struct BwdTile {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kLd = DM + 16 / kSize;
  static constexpr bool kFits64 = bwd_smem_bytes<T, kDkv>(DM, R, 64, kDkv ? 2 : 1) <= kSmemMax;
  // dk/dv keeps 64-row tiles by passing P and then dS through one buffer
  // where a buffer each would not fit.
  static constexpr bool kShareP =
      kDkv && !kFits64 && bwd_smem_bytes<T, kDkv>(DM, R, 64, 1) <= kSmemMax;
  // At 16 owned rows (the plan's choice for small grids) the streamed tile
  // is 32 rows where 64-row ones would leave no room for a second CTA on
  // the SM (more than half its shared memory).
  static constexpr bool kHalf =
      R == 16 && bwd_smem_bytes<T, kDkv>(DM, R, 64, kDkv ? 2 : 1) > kSmemMax / 2;
  static constexpr int kN = (kFits64 || kShareP) && !kHalf ? 64 : 32;  // streamed rows a tile
  // Two CTAs an SM where their tiles allow it, with registers capped at
  // 128: the fragment loops then unroll by 2 (by 4 they spill there).
  static constexpr int kMinBlocks = R == 16 && DM <= 128 ? 2 : 1;
  static constexpr int kUnroll = kMinBlocks == 2 ? 2 : 4;
  static constexpr int kPBufs = kDkv && !kShareP ? 2 : 1;
  static constexpr int kStageBytes = 2 * kN * kLd * kSize + (kDkv ? 3 : 1) * kN * 4;
  static constexpr int kBytes = bwd_smem_bytes<T, kDkv>(DM, R, kN, kPBufs);
  static constexpr int kLdw = kN + 8;  // fp32 P / dS row stride
  static constexpr int kTM = R / kGrid, kTN = kN / kGrid;  // S micro-tile
  static constexpr int kVW = DM / kGrid < 4 ? DM / kGrid : 4;  // accumulator vector width
  static constexpr int kNch = DM / (kGrid * kVW);              // ... and vectors a row
  static constexpr int kCols = kNch * kVW;                     // accumulator columns a row
  static_assert(kBytes <= kSmemMax, "the tiles do not fit in shared memory");
  static_assert(R % kGrid == 0 && kN % kGrid == 0 && kCols * kGrid == DM, "tile shape");
};

// 16 (or 4) bytes from global to shared memory, zero-filled where `bytes` is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of head `head` of a [B, N, heads, D] tensor into
// `dst` [ROWS][LD]: 16-byte cp.async chunks where `vec` (zero-filled past N;
// columns past D are not written and never reach an output or a dot), else
// element copies with zeros past N and past D.
template <int ROWS, int DM, int LD, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0, int N, int b, int heads,
                                           int head, int D, bool vec) {
  if (vec) {
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = DM / kE;
    const int chunks = D / kE;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += kBwdThreads) {
      const int r = i / kChunks, c = i % kChunks, n = r0 + r;
      if (c >= chunks) continue;
      const bool in = n < N;
      const T* g = src + (in ? ((static_cast<long>(b) * N + n) * heads + head) * D + c * kE : 0);
      cp_async16(fwd90::smem_u32(dst + r * LD + c * kE), g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DM; i += kBwdThreads) {
      const int r = i / DM, c = i % DM, n = r0 + r;
      T x = from_f<T>(0.f);
      if (n < N && c < D) x = src[((static_cast<long>(b) * N + n) * heads + head) * D + c];
      dst[r * LD + c] = x;
    }
  }
}

// ROWS 4-byte words src[base + (r0 + r) * stride] into dst[r], zeros past N.
template <int ROWS>
__device__ __forceinline__ void stage_words(void* dst, const void* src, int r0, int N, long base,
                                            int stride) {
  for (int r = threadIdx.x; r < ROWS; r += kBwdThreads) {
    const int n = r0 + r;
    const bool in = n < N;
    const char* g = static_cast<const char*>(src) + 4 * (in ? base + static_cast<long>(n) * stride : 0);
    cp_async4(fwd90::smem_u32(static_cast<char*>(dst) + 4 * r), g, in ? 4 : 0);
  }
}

// Four (two) consecutive elements of shared memory, widened to fp32.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 c = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 ld2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

template <int VW, typename T>
__device__ __forceinline__ void ldv(const T* p, float* x) {
  if constexpr (VW == 4) {
    const float4 v = ld4(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const float2 v = ld2(p);
    x[0] = v.x;
    x[1] = v.y;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// This thread's place (ty, tx) in the 16 x 16 grid: a warp covers 4 rows of
// ty by 8 of tx, so its fragment loads touch 4 rows of one operand and 8
// of the other.
__device__ __forceinline__ void grid_pos(int& ty, int& tx) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ty = (warp / 2) * 4 + lane / 8;
  tx = (warp % 2) * 8 + lane % 8;
}

// s[i][j] = sum over d < 4 * dsteps of A[ty + 16 i][d] * B[tx + 16 j][d],
// for shared A [.][LD] and B [.][LD]: TM + TN vector loads per 4*TM*TN FMAs.
// The d loop unrolls by U.
template <int TM, int TN, int LD, int U, typename T>
__device__ __forceinline__ void tile_dots(float (&s)[TM][TN], const T* A, const T* B, int ty,
                                          int tx, int dsteps) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
  const T* a0 = A + ty * LD;
  const T* b0 = B + tx * LD;
#pragma unroll (U)
  for (int d = 0; d < 4 * dsteps; d += 4) {
    float4 a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = ld4(a0 + i * kGrid * LD + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = ld4(b0 + j * kGrid * LD + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][j * VW + v] += sum over c < NC of W[ty + 16 i][c] *
// X[c][(tx + 16 j) * VW + v], for fp32 W [.][LDW] and X [NC][LD] in shared
// memory: the thread's rows of the [R, DM] accumulator, in NCH vectors of
// VW columns 16 vectors apart. The c loop unrolls by U.
template <int TM, int NCH, int VW, int NC, int LDW, int LD, int U, typename T>
__device__ __forceinline__ void tile_accumulate(float (&acc)[TM][NCH * VW], const float* W,
                                                const T* X, int ty, int tx) {
  const float* w0 = W + ty * LDW;
  const T* x0 = X + tx * VW;
#pragma unroll (U)
  for (int c = 0; c < NC; c += 4) {
    float4 w[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) w[i] = ld4(w0 + i * kGrid * LDW + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float x[NCH][VW];
#pragma unroll
      for (int j = 0; j < NCH; ++j) ldv<VW>(x0 + (c + cc) * LD + j * kGrid * VW, x[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float wi = lane4(w[i], cc);
#pragma unroll
        for (int j = 0; j < NCH; ++j)
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[i][j * VW + v] = fmaf(wi, x[j][v], acc[i][j * VW + v]);
      }
    }
  }
}

// Writes a thread's accumulator rows (local rows ty + 16 i, below `rows`)
// to the [*, N, heads, D] tensor `out` at row r0 + local row, scaled.
template <int TM, int NCH, int VW, typename T>
__device__ __forceinline__ void store_rows(T* out, float (&acc)[TM][NCH * VW], float scale,
                                           int r0, int N, int b, int heads, int head, int D, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = r0 + ty + kGrid * i;
    if (n >= N) continue;
    const long base = ((static_cast<long>(b) * N + n) * heads + head) * D;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const int d = (tx + kGrid * j) * VW + v;
        if (d < D) out[base + d] = from_f<T>(acc[i][j * VW + v] * scale);
      }
  }
}

// ---- backward: dq -------------------------------------------------------
// CTA: R query rows of one (b, h); the grid runs the last row blocks (the
// heaviest under a causal mask) first. Shared: Q, dO [R][kLd]; the ring of K, V [kN][kLd] and
// the keys' segment ids; dS [R][kLdw]. Per key tile: S and dP by
// tile_dots, P and dS in registers, dS to shared, dQ += dS K.
template <typename T, int DM, int R>
__global__ void __launch_bounds__(kBwdThreads, (BwdTile<T, DM, R, false>::kMinBlocks))
flash_simt_dq_kernel(const Params p) {
  using L = BwdTile<T, DM, R, false>;
  constexpr int kN = L::kN, kLd = L::kLd, kLdw = L::kLdw, kTM = L::kTM, kTN = L::kTN;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* sq = reinterpret_cast<T*>(bwd_smem);
  T* sdo = sq + R * kLd;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sdo + R * kLd);
  float* sds = reinterpret_cast<float*>(ring + kStages * L::kStageBytes);
  int ty, tx;
  grid_pos(ty, tx);
  // Row blocks slowest, last (heaviest under a causal mask) first; then
  // the (b, h) pairs.
  const int nrb = (p.S + R - 1) / R, bh = blockIdx.x % (p.B * p.H);
  const int r0 = (nrb - 1 - static_cast<int>(blockIdx.x) / (p.B * p.H)) * R;
  const int r1 = min(r0 + R, p.S) - 1;
  const int h = bh % p.H, b = bh / p.H, kh = h / (p.H / p.KH);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  stage_rows<R, DM, kLd>(sq, static_cast<const T*>(p.q), r0, p.S, b, p.H, h, p.D, p.vec);
  stage_rows<R, DM, kLd>(sdo, static_cast<const T*>(p.dout), r0, p.S, b, p.H, h, p.D, p.vec);
  int lo, hi;
  key_range(p, r0, r1, lo, hi);
  const int t_first = lo / kN * kN;
  const int ntiles = lo > hi ? 0 : hi / kN - lo / kN + 1;
  auto issue = [&](int t0, int st) {
    T* sk = reinterpret_cast<T*>(ring + st * L::kStageBytes);
    stage_rows<kN, DM, kLd>(sk, k, t0, p.T, b, p.KH, kh, p.D, p.vec);
    stage_rows<kN, DM, kLd>(sk + kN * kLd, v, t0, p.T, b, p.KH, kh, p.D, p.vec);
    if (p.seg != nullptr)
      stage_words<kN>(sk + 2 * kN * kLd, p.seg, t0, p.T, static_cast<long>(b) * p.S, 1);
  };
  if (ntiles > 0) issue(t_first, 0);
  cp_async_commit();

  float lse2[kTM], dlt[kTM];
  int srow[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r0 + ty + kGrid * i;
    const bool in = row < p.S;
    const long at = (static_cast<long>(b) * p.S + row) * p.H + h;
    lse2[i] = in ? p.lse_in[at] * kLog2e : 0.f;
    dlt[i] = in ? p.delta[at] : 0.f;
    srow[i] = in && p.seg != nullptr ? p.seg[static_cast<long>(b) * p.S + row] : 0;
  }
  float acc[kTM][L::kCols];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const int dsteps = (p.D + 3) / 4;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * kN, st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; the other stage and dS are free
    if (it + 1 < ntiles) issue(t0 + kN, st ^ 1);
    cp_async_commit();
    const T* sk = reinterpret_cast<const T*>(ring + st * L::kStageBytes);
    const T* sv = sk + kN * kLd;
    const int* sseg = reinterpret_cast<const int*>(sk + 2 * kN * kLd);
    const bool whole = p.seg == nullptr && t0 + kN <= p.T && all_visible(p, r0, r1, t0, t0 + kN - 1);
    float s[kTM][kTN], dp[kTM][kTN];
    tile_dots<kTM, kTN, kLd, L::kUnroll>(s, sq, sk, ty, tx, dsteps);
    tile_dots<kTM, kTN, kLd, L::kUnroll>(dp, sdo, sv, ty, tx, dsteps);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int cl = tx + kGrid * j;
        float ds = exp2f(fmaf(s[i][j], scale_log2, -lse2[i])) * (dp[i][j] - dlt[i]);
        if (!whole) {
          const int row = r0 + ty + kGrid * i, col = t0 + cl;
          if (!(col < p.T && mask_visible(p, row, col) &&
                (p.seg == nullptr || srow[i] == sseg[cl])))
            ds = 0.f;
        }
        sds[(ty + kGrid * i) * kLdw + cl] = ds;
      }
    __syncthreads();  // dS is whole
    tile_accumulate<kTM, L::kNch, L::kVW, kN, kLdw, kLd, L::kUnroll>(acc, sds, sk, ty, tx);
  }
  cp_async_wait_all();
  store_rows<kTM, L::kNch, L::kVW>(static_cast<T*>(p.dq), acc, p.scale, r0, p.S, b, p.H, h, p.D,
                                   ty, tx);
}

// ---- backward: dk, dv ---------------------------------------------------
// CTA: R key rows of one (b, kv head) and one split of their walk over
// (GQA head g, q tile) pairs, g slowest. The grid runs key blocks from the
// first (the heaviest under a causal mask), a block's p.splits CTAs
// adjacent. Shared: K, V [R][kLd]; the ring of Q, dO [kN][kLd] with the q
// rows' lse, delta and segment ids; P, dS [R][kLdw] (the key row as the
// row; one buffer taking P, then dS, where kShareP). Per step: S^T and
// dP^T by tile_dots, P and dS to shared, dV += P^T dO and dK += dS^T Q.
template <typename T, int DM, int R>
__global__ void __launch_bounds__(kBwdThreads, (BwdTile<T, DM, R, true>::kMinBlocks))
flash_simt_dkv_kernel(const Params p) {
  using L = BwdTile<T, DM, R, true>;
  constexpr int kN = L::kN, kLd = L::kLd, kLdw = L::kLdw, kTM = L::kTM, kTN = L::kTN;
  constexpr int kVW = L::kVW, kNch = L::kNch, kCols = L::kCols;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __shared__ int last_flag;
  T* sk = reinterpret_cast<T*>(bwd_smem);
  T* sv = sk + R * kLd;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sv + R * kLd);
  float* sp = reinterpret_cast<float*>(ring + kStages * L::kStageBytes);
  float* sds = L::kShareP ? sp : sp + R * kLdw;
  int ty, tx;
  grid_pos(ty, tx);
  // block: the key block, numbered (b, kv head) fastest; its ticket.
  const int splits = p.splits, split = blockIdx.x % splits;
  const int block = blockIdx.x / splits, bk = block % (p.B * p.KH);
  const int kb = block / (p.B * p.KH), kh = bk % p.KH, b = bk / p.KH, group = p.H / p.KH;
  const int c0 = kb * R, c1 = min(c0 + R, p.T) - 1;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);

  stage_rows<R, DM, kLd>(sk, static_cast<const T*>(p.k), c0, p.T, b, p.KH, kh, p.D, p.vec);
  stage_rows<R, DM, kLd>(sv, static_cast<const T*>(p.v), c0, p.T, b, p.KH, kh, p.D, p.vec);
  int lo, hi;
  query_range(p, c0, c1, lo, hi);
  const int nq = lo > hi ? 0 : hi / kN - lo / kN + 1;
  const int walk = group * nq;
  const int s_begin = static_cast<int>(static_cast<long>(split) * walk / splits);
  const int s_end = static_cast<int>(static_cast<long>(split + 1) * walk / splits);
  auto issue = [&](int step, int st) {
    const int h = kh * group + step / nq, q0 = (lo / kN + step % nq) * kN;
    T* sq = reinterpret_cast<T*>(ring + st * L::kStageBytes);
    stage_rows<kN, DM, kLd>(sq, q, q0, p.S, b, p.H, h, p.D, p.vec);
    stage_rows<kN, DM, kLd>(sq + kN * kLd, dout, q0, p.S, b, p.H, h, p.D, p.vec);
    float* words = reinterpret_cast<float*>(sq + 2 * kN * kLd);
    const long at = static_cast<long>(b) * p.S * p.H + h;
    stage_words<kN>(words, p.lse_in, q0, p.S, at, p.H);
    stage_words<kN>(words + kN, p.delta, q0, p.S, at, p.H);
    if (p.seg != nullptr) stage_words<kN>(words + 2 * kN, p.seg, q0, p.S, static_cast<long>(b) * p.S, 1);
  };
  if (s_begin < s_end) issue(s_begin, 0);
  cp_async_commit();

  int scol[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int col = c0 + ty + kGrid * i;
    scol[i] = col < p.T && p.seg != nullptr ? p.seg[static_cast<long>(b) * p.S + col] : 0;
  }
  float dk[kTM][kCols], dv[kTM][kCols];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const int dsteps = (p.D + 3) / 4;

  for (int step = s_begin; step < s_end; ++step) {
    const int st = (step - s_begin) & 1, q0 = (lo / kN + step % nq) * kN;
    cp_async_wait_all();
    __syncthreads();  // step's tile has landed; the other stage, P and dS are free
    if (step + 1 < s_end) issue(step + 1, st ^ 1);
    cp_async_commit();
    const T* sq = reinterpret_cast<const T*>(ring + st * L::kStageBytes);
    const T* sdo = sq + kN * kLd;
    const float* slse = reinterpret_cast<const float*>(sq + 2 * kN * kLd);
    const float* sdelta = slse + kN;
    const int* sseg = reinterpret_cast<const int*>(sdelta + kN);
    const bool whole = p.seg == nullptr && q0 + kN <= p.S && all_visible(p, q0, q0 + kN - 1, c0, c1);
    // s becomes P and dp becomes dS, in place.
    float s[kTM][kTN], dp[kTM][kTN];
    tile_dots<kTM, kTN, kLd, L::kUnroll>(s, sk, sq, ty, tx, dsteps);
    tile_dots<kTM, kTN, kLd, L::kUnroll>(dp, sv, sdo, ty, tx, dsteps);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int rl = tx + kGrid * j;
      const float l2 = slse[rl] * kLog2e, dl = sdelta[rl];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float pr = exp2f(fmaf(s[i][j], scale_log2, -l2));
        float ds = pr * (dp[i][j] - dl);
        if (!whole) {
          const int row = q0 + rl, col = c0 + ty + kGrid * i;
          // Padded q rows (row >= S) never count: p and ds are exactly 0.
          if (!(row < p.S && mask_visible(p, row, col) &&
                (p.seg == nullptr || sseg[rl] == scol[i]))) {
            pr = 0.f;
            ds = 0.f;
          }
        }
        s[i][j] = pr;
        dp[i][j] = ds;
        sp[(ty + kGrid * i) * kLdw + rl] = pr;
        if (!L::kShareP) sds[(ty + kGrid * i) * kLdw + rl] = ds;
      }
    }
    __syncthreads();  // P (and dS) are whole
    tile_accumulate<kTM, kNch, kVW, kN, kLdw, kLd, L::kUnroll>(dv, sp, sdo, ty, tx);
    if (L::kShareP) {
      __syncthreads();  // every thread is done with P
#pragma unroll
      for (int j = 0; j < kTN; ++j)
#pragma unroll
        for (int i = 0; i < kTM; ++i) sds[(ty + kGrid * i) * kLdw + tx + kGrid * j] = dp[i][j];
      __syncthreads();  // dS is whole
    }
    tile_accumulate<kTM, kNch, kVW, kN, kLdw, kLd, L::kUnroll>(dk, sds, sq, ty, tx);
  }
  cp_async_wait_all();

  if (splits > 1) {
    // This split's fp32 partials, then the last split to arrive sums every
    // split's (its own included, from L2) in split order.
    float* part = p.ws + (static_cast<long>(block) * splits + split) * 2 * R * DM;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kNch; ++j)
#pragma unroll
        for (int v = 0; v < kVW; ++v) {
          const int at = (ty + kGrid * i) * DM + (tx + kGrid * j) * kVW + v;
          part[at] = dk[i][j * kVW + v];
          part[R * DM + at] = dv[i][j * kVW + v];
        }
    if (!gemm90::last_split(p.tickets, block, splits, threadIdx.x, &last_flag)) return;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;
    for (int sp_i = 0; sp_i < splits; ++sp_i) {
      const float* src = p.ws + (static_cast<long>(block) * splits + sp_i) * 2 * R * DM;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kNch; ++j)
#pragma unroll
          for (int v = 0; v < kVW; ++v) {
            const int at = (ty + kGrid * i) * DM + (tx + kGrid * j) * kVW + v;
            dk[i][j * kVW + v] += __ldcg(src + at);
            dv[i][j * kVW + v] += __ldcg(src + R * DM + at);
          }
    }
  }
  store_rows<kTM, kNch, kVW>(static_cast<T*>(p.dk), dk, p.scale, c0, p.T, b, p.KH, kh, p.D, ty,
                             tx);
  store_rows<kTM, kNch, kVW>(static_cast<T*>(p.dv), dv, 1.f, c0, p.T, b, p.KH, kh, p.D, ty, tx);
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };
constexpr int kMaxDevices = 64;

// Raises `kernel`'s dynamic shared-memory limit to `bytes` once per device,
// where it is above the default; `raised` is the instantiation's cache.
int allow_smem(const void* kernel, int bytes, bool* raised) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  return 0;
}

// Launches the forward at head-dim bucket DM.
template <typename T, int DM>
int launch_fwd(const Params& p, cudaStream_t st) {
  constexpr int bytes = 4 * (kRows * DM + kTile * (DM + 1) + kTile * DM);
  static bool raised[kMaxDevices] = {};
  const int err = allow_smem(reinterpret_cast<const void*>(flash_simt_fwd_kernel<T, DM>), bytes,
                             raised);
  if (err != 0) return err;
  const dim3 grid((p.S + kRows - 1) / kRows, p.H, p.B);
  flash_simt_fwd_kernel<T, DM><<<grid, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches dq or dk/dv at head-dim bucket DM with R owned rows a CTA.
template <typename T, int DM, int R>
int launch_bwd(int pass, const Params& p, cudaStream_t st) {
  static bool raised[2][kMaxDevices] = {};
  const bool dkv = pass == kDkv;
  const int bytes = dkv ? BwdTile<T, DM, R, true>::kBytes : BwdTile<T, DM, R, false>::kBytes;
  void (*kernel)(const Params) =
      dkv ? flash_simt_dkv_kernel<T, DM, R> : flash_simt_dq_kernel<T, DM, R>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), bytes, raised[dkv]);
  if (err != 0) return err;
  const long blocks = static_cast<long>((dkv ? p.T : p.S) + R - 1) / R * p.B *
                      (dkv ? p.KH : p.H) * (dkv ? p.splits : 1);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DM>
int launch_dm(int pass, const Params& p, int rows, cudaStream_t st) {
  if (pass == kFwd) return launch_fwd<T, DM>(p, st);
  if (rows == 16) return launch_bwd<T, DM, 16>(pass, p, st);
  if (rows == 32) return launch_bwd<T, DM, 32>(pass, p, st);
  if constexpr (DM <= 128) {
    if (rows == 64) return launch_bwd<T, DM, 64>(pass, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_t(int pass, const Params& p, int rows, cudaStream_t st) {
  if (p.D <= 32) return launch_dm<T, 32>(pass, p, rows, st);
  if (p.D <= 64) return launch_dm<T, 64>(pass, p, rows, st);
  if (p.D <= 128) return launch_dm<T, 128>(pass, p, rows, st);
  return launch_dm<T, 256>(pass, p, rows, st);
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

// dtype: 0 fp32, 1 bf16, 2 fp16. rows and splits are the backward's (the
// forward ignores them).
int launch(int pass, int dtype, Params& p, int B, int S, int T, int H, int KH, int D, int kind,
           int window, int prefix, float sm_scale, int rows, int splits, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 ||
      kind < 0 || kind > 3 || D < 1 || D > 256 || dtype < 0 || dtype > 2 || splits < 1 ||
      splits > kMaxSplits || (splits > 1 && (pass != kDkv || p.ws == nullptr ||
                                             p.tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.D = D;
  p.kind = kind;
  p.window = window;
  p.prefix = prefix;
  p.scale = sm_scale;
  p.splits = splits;
  const int size = dtype == 0 ? 4 : 2;
  p.vec = D * size % 16 == 0 && aligned16(p.q) && aligned16(p.k) && aligned16(p.v) &&
          (p.dout == nullptr || aligned16(p.dout));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(pass, p, rows, st);
  if (dtype == 1) return launch_t<__nv_bfloat16>(pass, p, rows, st);
  return launch_t<__half>(pass, p, rows, st);
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() after the
// launch (0 = ok), or cudaErrorInvalidValue for arguments they do not take.
// dtype: 0 fp32, 1 bf16, 2 fp16 (of every q/k/v/dO/o/dq/dk/dv tensor).
// kind: 0 causal, 1 full, 2 prefix_lm, 3 sliding_window. seg may be null.
// rows: query rows (dq) or key rows (dk/dv) a CTA owns: 16, 32 or 64 (at
// most 32 above head dim 128). splits: CTAs a dk/dv key block's walk is
// split over (1..16); above 1, ws holds splits * 2 * rows * bucket fp32
// for each of the B * KH * ceil(T / rows) key blocks and tickets one zeroed
// int32 each (left at zero).
extern "C" int tpk_flash_simt_fwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* seg, void* o, void* lse, int B, int S, int T,
                                  int H, int KH, int D, int kind, int window, int prefix,
                                  float sm_scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  return launch(kFwd, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, 0, 1, stream);
}

extern "C" int tpk_flash_simt_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* seg, void* dq, int B, int S, int T, int H,
                                     int KH, int D, int kind, int window, int prefix,
                                     float sm_scale, int rows, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg = static_cast<const int*>(seg);
  p.dq = dq;
  return launch(kDq, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, rows, 1,
                stream);
}

extern "C" int tpk_flash_simt_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* seg, void* dk, void* dv, void* ws,
                                      void* tickets, int B, int S, int T, int H, int KH, int D,
                                      int kind, int window, int prefix, float sm_scale,
                                      int rows, int splits, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg = static_cast<const int*>(seg);
  p.dk = dk;
  p.dv = dv;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  return launch(kDkv, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, rows, splits,
                stream);
}
