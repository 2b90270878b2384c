// Flash attention for the inputs the wgmma kernels (flash_fwd.cu,
// flash_bwd.cu) do not take: fp32, bf16 or fp16 q/k/v at any head dim up to
// 256. The forward runs on the tensor cores for bf16 and fp16 and on the
// CUDA cores for fp32; dq and dk/dv run on the CUDA cores for all three.
//
// Replaces, for those inputs, the same TPU kernels as the wgmma kernels:
// kubeflow_tpu/ops/flash_attention.py::_flash_fwd_kernel, _flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel. The TPU kernels read any dtype and head dim and
// compute in fp32 (Mosaic pads a narrow head dim to the 128 lanes). Here the
// fp32 forward and the whole backward do the same: every input is widened
// to fp32 before it is multiplied, every product and sum is fp32, and only
// the outputs are rounded to the input dtype. An fp32 model therefore gets
// fp32 attention, not a bf16 one. The bf16/fp16 forward multiplies the
// input dtype on the tensor cores with fp32 accumulation and rounds P to the
// input dtype for P.V, exactly as B1's wgmma kernel does (and as
// naive_attention does in bf16); the row sum l is taken from P before that
// rounding.
//
// What bounds them on this card: the forward in bf16/fp16, the tensor
// cores (989 TFLOP/s at 700 W); everything else, fp32 FMAs on the CUDA
// cores (67 TFLOP/s), not memory. Each visible (q, k) pair costs 4*D flops
// forward, 6*D for dq and 8*D for dk/dv. An SM issues 128 fp32 FMAs a clock
// but serves 32 words of shared memory a clock, so a kernel that reads an
// operand from shared memory for every FMA runs at a quarter of the FMA
// rate at best.
//
// The CUDA-core kernels (flash_simt_fwd_kernel for fp32, the backward pair
// for every dtype) are register-tiled. 256 threads form a 16 x 16 grid. A
// CTA owns R rows (forward and dq: query rows of one head; dk/dv: key rows
// of one kv head) and streams the other operand in tiles of N rows (64, or
// 32 where two stages of 64 would not fit in shared memory, or would keep a
// second 16-row CTA off the SM; FwdTile, BwdTile) through a two-stage ring
// filled by 16-byte cp.async copies, so the next tile lands while this one
// is computed. Shared tiles keep the input dtype; a thread widens each
// 4-element fragment to fp32 as it loads it (an exact conversion), and
// computes a (R/16) x (N/16) micro-tile of S (and dP) as outer products over
// d: R/16 + N/16 vector loads per 4 * (R/16) * (N/16) FMAs. P (and dS) go
// through shared memory once per tile; O += P V (dQ += dS K, or dV += P^T dO
// and dK += dS^T Q) is a second register-tiled product into per-thread
// slices of the [R, D] accumulators, which stay in registers across the
// walk. In the forward a row's 16 threads share a warp, so its online
// softmax (row max, row sum, the rescale of the accumulator by alpha =
// exp2(m_old - m_new)) needs only xor-shuffles within 16 lanes. A tile that
// lies wholly inside the visible region runs no per-element mask test; only
// tiles on the causal diagonal, a window edge, the prefix boundary, past S
// or T, or with segment ids (read from the tile's ids in shared memory) do.
// The host's plans (_simt_fwd_plan, _simt_bwd_plan) pick R so the grid
// fills the SMs and, where dk/dv's key blocks still would not, split each
// block's walk over (GQA head, q tile) across CTAs: each split writes fp32
// partials to a workspace, and the last to arrive sums them in split order
// behind gemm90::last_split's ticket (deterministic; no atomics on the
// gradients).
//
// The tensor-core forward (flash_simt_fwd_mma_kernel) is FlashAttention-2 in
// shape on mma.sync m16n8k16: a warp owns 16 query rows, a CTA 1, 2, 4 or 8
// warps (the plan's rows), and 64-row K and V tiles stream through the same
// two-stage cp.async ring, rows padded by 16 bytes so that every ldmatrix
// (x4 for Q and K, x4.trans for V) reads 8 distinct bank groups. S
// accumulates in fp32 on the C-fragment layout, the online softmax runs in
// registers (row max over the four lanes of a quad), P is packed to the
// input dtype straight into A fragments, and O += P V accumulates in fp32.
// The head dim is padded with zero columns to a multiple of 16 (the
// instantiated bucket); output columns past D are never stored.
//
// Semantics are the plain versions' (_flash_fwd_plain, _flash_bwd_plain):
// scale 1/sqrt(D), masked scores -1e30 (a row's visible columns: below T,
// causal, prefix-LM, sliding window, equal segment ids), lse = m + log(max(l,
// 1e-30)); p = exp(s - lse) set to exactly 0 where masked; ds = p (dp -
// delta); dk, dv summed over the GQA group without atomics. Rows past S are
// never written.
//
// Layout (the JAX package's): q/dO/o/dq [B, S, H, D], k/v/dk/dv [B, T, KH,
// D], lse and delta [B, S, H] fp32, seg [B, S] int32 or null.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"  // gemm90::last_split: the split ticket the matmuls use

namespace {

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

// ---- the register-tiled machinery ------------------------------------------
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

// Rows [r0, r0 + rows) of head `head` of a [B, N, heads, D] tensor into
// `dst` [rows][LD], by `nthreads` threads: 16-byte cp.async chunks where
// `vec` (zero-filled past N; columns past D are not written), else element
// copies with zeros past N and past D.
template <int DM, int LD, typename T>
__device__ __forceinline__ void stage_rows_by(T* dst, const T* src, int rows, int r0, int N,
                                              int b, int heads, int head, int D, bool vec,
                                              int nthreads) {
  if (vec) {
    constexpr int kE = 16 / static_cast<int>(sizeof(T));
    constexpr int kChunks = DM / kE;
    const int chunks = D / kE;
    for (int i = threadIdx.x; i < rows * kChunks; i += nthreads) {
      const int r = i / kChunks, c = i % kChunks, n = r0 + r;
      if (c >= chunks) continue;
      const bool in = n < N;
      const T* g = src + (in ? ((static_cast<long>(b) * N + n) * heads + head) * D + c * kE : 0);
      cp_async16(fwd90::smem_u32(dst + r * LD + c * kE), g, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DM; i += nthreads) {
      const int r = i / DM, c = i % DM, n = r0 + r;
      T x = from_f<T>(0.f);
      if (n < N && c < D) x = src[((static_cast<long>(b) * N + n) * heads + head) * D + c];
      dst[r * LD + c] = x;
    }
  }
}

// stage_rows_by for ROWS rows by the register-tiled kernels' 256 threads
// (the columns past D that are not written never reach an output or a dot
// there: those kernels' dots stop at D).
template <int ROWS, int DM, int LD, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0, int N, int b, int heads,
                                           int head, int D, bool vec) {
  stage_rows_by<DM, LD>(dst, src, ROWS, r0, N, b, heads, head, D, vec, kBwdThreads);
}

// `rows` 4-byte words src[base + (r0 + r) * stride] into dst[r], zeros past
// N, by `nthreads` threads.
__device__ __forceinline__ void stage_words_by(void* dst, const void* src, int rows, int r0, int N,
                                               long base, int stride, int nthreads) {
  for (int r = threadIdx.x; r < rows; r += nthreads) {
    const int n = r0 + r;
    const bool in = n < N;
    const char* g = static_cast<const char*>(src) + 4 * (in ? base + static_cast<long>(n) * stride : 0);
    cp_async4(fwd90::smem_u32(static_cast<char*>(dst) + 4 * r), g, in ? 4 : 0);
  }
}

template <int ROWS>
__device__ __forceinline__ void stage_words(void* dst, const void* src, int r0, int N, long base,
                                            int stride) {
  stage_words_by(dst, src, ROWS, r0, N, base, stride, kBwdThreads);
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

// ---- forward on the CUDA cores (fp32) -------------------------------------
constexpr float kMasked2 = kNegInf * kLog2e;  // a masked score in log2 units

// The forward's shared memory at head-dim bucket `dm`, `rows` owned query
// rows and `n`-row kv tiles: Q [rows][ld], kStages stages of K and V [n][ld]
// with the keys' segment ids, and fp32 P [rows][n + 8].
template <typename T>
constexpr int fwd_smem_bytes(int dm, int rows, int n) {
  const int size = static_cast<int>(sizeof(T));
  const int ld = dm + 16 / size;
  return rows * ld * size + kStages * (2 * n * ld * size + n * 4) + rows * (n + 8) * 4;
}

// The fp32 forward's tiles, by BwdTile's rules: 64-row kv tiles where two
// stages fit (and, at 16 owned rows, leave room for a second CTA), else 32.
template <typename T, int DM, int R>
struct FwdTile {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kLd = DM + 16 / kSize;
  static constexpr int kOwn64 = fwd_smem_bytes<T>(DM, R, 64);
  static constexpr int kN = kOwn64 <= kSmemMax && !(R == 16 && kOwn64 > kSmemMax / 2) ? 64 : 32;
  static constexpr int kMinBlocks = R == 16 && DM <= 128 ? 2 : 1;
  static constexpr int kUnroll = kMinBlocks == 2 ? 2 : 4;
  static constexpr int kStageBytes = 2 * kN * kLd * kSize + kN * 4;
  static constexpr int kBytes = fwd_smem_bytes<T>(DM, R, kN);
  static constexpr int kLdw = kN + 8;                     // fp32 P row stride
  static constexpr int kTM = R / kGrid, kTN = kN / kGrid;  // S micro-tile
  static constexpr int kVW = DM / kGrid < 4 ? DM / kGrid : 4;
  static constexpr int kNch = DM / (kGrid * kVW);
  static constexpr int kCols = kNch * kVW;
  static_assert(kBytes <= kSmemMax, "the tiles do not fit in shared memory");
  static_assert(R % kGrid == 0 && kN % kGrid == 0 && kCols * kGrid == DM, "tile shape");
};

// The max (sum) of x over the 16 lanes of a half-warp.
__device__ __forceinline__ float max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// CTA: R query rows of one (b, h), heaviest row block first (as dq). The
// grid is dq's but row-major within a warp (a warp covers 2 rows of ty by
// all 16 of tx), so a row's 16 threads are one half-warp. Shared: Q
// [R][kLd]; the ring of K, V [kN][kLd] and the keys' segment ids; P
// [R][kLdw]. Per key tile: S by tile_dots; the row max by xor-shuffles, the
// accumulator rescaled by alpha, P = exp2(s * scale * log2(e) - m) to
// shared; O += P V by tile_accumulate. A thread keeps its share of a row's
// l; the shares are summed once, at the end.
template <typename T, int DM, int R>
__global__ void __launch_bounds__(kBwdThreads, (FwdTile<T, DM, R>::kMinBlocks))
flash_simt_fwd_kernel(const Params p) {
  using L = FwdTile<T, DM, R>;
  constexpr int kN = L::kN, kLd = L::kLd, kLdw = L::kLdw, kTM = L::kTM, kTN = L::kTN;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* sq = reinterpret_cast<T*>(fwd_smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(sq + R * kLd);
  float* sp = reinterpret_cast<float*>(ring + kStages * L::kStageBytes);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const int nrb = (p.S + R - 1) / R, bh = blockIdx.x % (p.B * p.H);
  const int r0 = (nrb - 1 - static_cast<int>(blockIdx.x) / (p.B * p.H)) * R;
  const int r1 = min(r0 + R, p.S) - 1;
  const int h = bh % p.H, b = bh / p.H, kh = h / (p.H / p.KH);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  stage_rows<R, DM, kLd>(sq, static_cast<const T*>(p.q), r0, p.S, b, p.H, h, p.D, p.vec);
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

  int srow[kTM];
  float m[kTM], l[kTM], acc[kTM][L::kCols];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = r0 + ty + kGrid * i;
    srow[i] = row < p.S && p.seg != nullptr ? p.seg[static_cast<long>(b) * p.S + row] : 0;
    m[i] = kMasked2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;
  const int dsteps = (p.D + 3) / 4;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * kN, st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; the other stage and P are free
    if (it + 1 < ntiles) issue(t0 + kN, st ^ 1);
    cp_async_commit();
    const T* sk = reinterpret_cast<const T*>(ring + st * L::kStageBytes);
    const T* sv = sk + kN * kLd;
    const int* sseg = reinterpret_cast<const int*>(sk + 2 * kN * kLd);
    const bool whole = p.seg == nullptr && t0 + kN <= p.T && all_visible(p, r0, r1, t0, t0 + kN - 1);
    float s[kTM][kTN];
    tile_dots<kTM, kTN, kLd, L::kUnroll>(s, sq, sk, ty, tx, dsteps);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      // Whole tiles take the max of the raw dots and fold the scale into
      // the exponent's FMA; others scale first and mask to kMasked2.
      float mx = whole ? -3.0e38f : kMasked2;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (!whole) {
          const int row = r0 + ty + kGrid * i, cl = tx + kGrid * j, col = t0 + cl;
          const bool vis = col < p.T && mask_visible(p, row, col) &&
                           (p.seg == nullptr || srow[i] == sseg[cl]);
          s[i][j] = vis ? s[i][j] * scale_log2 : kMasked2;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], whole ? max16(mx) * scale_log2 : max16(mx));
      const float alpha = exp2f(m[i] - m_new);
      const float mul = whole ? scale_log2 : 1.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float pr = exp2f(fmaf(s[i][j], mul, -m_new));
        sum += pr;
        sp[(ty + kGrid * i) * kLdw + tx + kGrid * j] = pr;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is whole
    tile_accumulate<kTM, L::kNch, L::kVW, kN, kLdw, kLd, L::kUnroll>(acc, sp, sv, ty, tx);
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float lc = fmaxf(sum16(l[i]), 1e-30f);
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] /= lc;
    const int row = r0 + ty + kGrid * i;
    if (tx == 0 && row < p.S)
      p.lse[(static_cast<long>(b) * p.S + row) * p.H + h] = m[i] * kLn2 + logf(lc);
  }
  store_rows<kTM, L::kNch, L::kVW>(static_cast<T*>(p.o), acc, 1.f, r0, p.S, b, p.H, h, p.D, ty,
                                   tx);
}

// ---- forward on the tensor cores (bf16, fp16) -----------------------------
constexpr int kMmaTile = 64;      // kv rows a streamed tile
constexpr int kMmaMaxRows = 128;  // query rows a CTA at most: 8 warps of 16

// The tensor-core forward's shared memory at head-dim bucket `dm` and
// `rows` query rows: Q [rows][dm + 8] and kStages stages of K and V
// [kMmaTile][dm + 8] (2-byte elements) with the keys' segment ids.
constexpr int mma_smem_bytes(int dm, int rows) {
  return 2 * rows * (dm + 8) + kStages * (4 * kMmaTile * (dm + 8) + 4 * kMmaTile);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return fwd90::pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: a row-major 16 x 16 (4 registers), b
// column-major 16 x 8 (2), d 16 x 8 fp32 (4).
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 2-byte elements from shared memory; lane l gives
// the address of row l % 8 of matrix l / 8 and gets, of each matrix,
// elements (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1), or with .trans
// those of the transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// CTA: blockDim.x / 2 query rows of one (b, h), 16 a warp, heaviest row
// block first. Shared: Q [rows][kLd], then the ring of K, V [kMmaTile][kLd]
// and the keys' segment ids; rows of DM + 8 elements, so the 8 row
// addresses of an ldmatrix fall in 8 distinct groups of 4 banks (DM is a
// multiple of 16). Fragments (lane l, g = l / 4, t = l % 4): S and O on the
// C layout (rows g and g + 8, columns 8j + 2t and + 1 of 8-column block
// j); Q's A fragments by ldmatrix.x4 (row l % 16, column 8 (l / 16)), K's B
// fragments for two key blocks by ldmatrix.x4 (key l % 8 + 8 (l / 16),
// column 8 ((l / 8) % 2)), V's by ldmatrix.x4.trans (key l % 16, column 8
// (l / 16)). A warp skips the tiles none of its rows can see.
template <typename T, int DM>
__global__ void __launch_bounds__(2 * kMmaMaxRows)
flash_simt_fwd_mma_kernel(const Params p) {
  constexpr int kN = kMmaTile, kLd = DM + 8, kDt = DM / 8;
  constexpr int kStageBytes = 4 * kN * kLd + 4 * kN;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int nthreads = blockDim.x, rows = nthreads / 2;
  T* sq = reinterpret_cast<T*>(mma_smem);
  unsigned char* ring = reinterpret_cast<unsigned char*>(sq + rows * kLd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int nrb = (p.S + rows - 1) / rows, bh = blockIdx.x % (p.B * p.H);
  const int r0 = (nrb - 1 - static_cast<int>(blockIdx.x) / (p.B * p.H)) * rows;
  const int r1 = min(r0 + rows, p.S) - 1;
  const int h = bh % p.H, b = bh / p.H, kh = h / (p.H / p.KH);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // Columns [D, DM) of the tiles hold zeros for good: the 16-byte copies
  // never write them, and they add nothing to Q K^T.
  if (p.vec && p.D < DM) {
    const int w = DM - p.D;
    for (int i = threadIdx.x; i < (rows + kStages * 2 * kN) * w; i += nthreads) {
      const int r = i / w, c = p.D + i % w;
      T* row = r < rows ? sq + r * kLd
                        : reinterpret_cast<T*>(ring + (r - rows) / (2 * kN) * kStageBytes) +
                              (r - rows) % (2 * kN) * kLd;
      row[c] = from_f<T>(0.f);
    }
  }
  stage_rows_by<DM, kLd>(sq, static_cast<const T*>(p.q), rows, r0, p.S, b, p.H, h, p.D, p.vec,
                         nthreads);
  int lo, hi;
  key_range(p, r0, r1, lo, hi);
  const int t_first = lo / kN * kN;
  const int ntiles = lo > hi ? 0 : hi / kN - lo / kN + 1;
  auto issue = [&](int t0, int st) {
    T* sk = reinterpret_cast<T*>(ring + st * kStageBytes);
    stage_rows_by<DM, kLd>(sk, k, kN, t0, p.T, b, p.KH, kh, p.D, p.vec, nthreads);
    stage_rows_by<DM, kLd>(sk + kN * kLd, v, kN, t0, p.T, b, p.KH, kh, p.D, p.vec, nthreads);
    if (p.seg != nullptr)
      stage_words_by(sk + 2 * kN * kLd, p.seg, kN, t0, p.T, static_cast<long>(b) * p.S, 1,
                     nthreads);
  };
  if (ntiles > 0) issue(t_first, 0);
  cp_async_commit();

  // This warp's rows [w0, w1] and the keys they may see.
  const int w0 = r0 + 16 * warp, w1 = min(w0 + 15, p.S - 1);
  const bool live = w0 < p.S;
  int wlo = 0, whi = -1;
  if (live) key_range(p, w0, w1, wlo, whi);
  int srow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + g + 8 * i;
    srow[i] = row < p.S && p.seg != nullptr ? p.seg[static_cast<long>(b) * p.S + row] : 0;
  }
  float o[kDt][4], m[2] = {kMasked2, kMasked2}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kDt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const uint32_t q_lane = fwd90::smem_u32(sq + (16 * warp + lane % 16) * kLd + 8 * (lane / 16));
  const int k_lane = (lane % 8 + 8 * (lane / 16)) * kLd + 8 * ((lane / 8) % 2);
  const int v_lane = (lane % 16) * kLd + 8 * (lane / 16);

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * kN, st = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with the other stage
    if (it + 1 < ntiles) issue(t0 + kN, st ^ 1);
    cp_async_commit();
    if (t0 > whi || t0 + kN - 1 < wlo) continue;  // no row of this warp sees the tile
    const T* sk = reinterpret_cast<const T*>(ring + st * kStageBytes);
    const int* sseg = reinterpret_cast<const int*>(sk + 2 * kN * kLd);
    const uint32_t k_base = fwd90::smem_u32(sk + k_lane);
    const uint32_t v_base = fwd90::smem_u32(sk + kN * kLd + v_lane);

    float s[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_lane + 32 * kk);
#pragma unroll
      for (int nn = 0; nn < kN / 16; ++nn) {
        uint32_t bk[4];
        ldsm_x4(bk, k_base + 2 * (16 * nn * kLd + 16 * kk));
        mma16816<T>(s[2 * nn], a, bk[0], bk[1]);
        mma16816<T>(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // Online softmax on the C layout: element e of block j is row g + 8 (e
    // / 2), key t0 + 8j + 2t + e % 2; a row's max spans the quad.
    const bool whole =
        p.seg == nullptr && t0 + kN <= p.T && all_visible(p, w0, w1, t0, t0 + kN - 1);
    float mx[2] = {whole ? -3.0e38f : kMasked2, whole ? -3.0e38f : kMasked2};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!whole) {
          const int row = w0 + g + 8 * (e >> 1), cl = 8 * j + 2 * t4 + (e & 1), col = t0 + cl;
          const bool vis = col < p.T && mask_visible(p, row, col) &&
                           (p.seg == nullptr || srow[e >> 1] == sseg[cl]);
          s[j][e] = vis ? s[j][e] * scale_log2 : kMasked2;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], whole ? mx[i] * scale_log2 : mx[i]);
      alpha[i] = fwd90::ex2(m[i] - m_new);
      neg_m[i] = -m_new;
      m[i] = m_new;
    }
    const float mul = whole ? scale_log2 : 1.f;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fwd90::ex2(fmaf(s[j][e], mul, neg_m[e >> 1]));
        rs[e >> 1] += s[j][e];  // l sums P before its rounding
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < kDt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // O += P V: P's C-layout pairs of key blocks 2kk and 2kk + 1 are the A
    // fragment of key step kk.
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                             pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                             pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DM / 16; ++dd) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_base + 2 * (16 * kk * kLd + 16 * dd));
        mma16816<T>(o[2 * dd], a, bv[0], bv[1]);
        mma16816<T>(o[2 * dd + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();

  T* out = static_cast<T*>(p.o);
  const bool pairs = p.D % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(kFull, li, 1);
    li += __shfl_xor_sync(kFull, li, 2);
    const float lc = fmaxf(li, 1e-30f);
    const int row = w0 + g + 8 * i;
    if (row >= p.S) continue;
    const long at = (static_cast<long>(b) * p.S + row) * p.H + h;
    T* orow = out + at * p.D;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      const int c = 8 * j + 2 * t4;
      const float x0 = o[j][2 * i] / lc, x1 = o[j][2 * i + 1] / lc;
      if (pairs && c + 1 < p.D) {
        *reinterpret_cast<uint32_t*>(orow + c) = pack2<T>(x0, x1);
      } else {
        if (c < p.D) orow[c] = from_f<T>(x0);
        if (c + 1 < p.D) orow[c + 1] = from_f<T>(x1);
      }
    }
    if (t4 == 0) p.lse[at] = m[i] * kLn2 + logf(lc);
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

// Launches the fp32 forward, dq or dk/dv at head-dim bucket DM with R owned
// rows a CTA.
template <typename T, int DM, int R>
int launch_rows(int pass, const Params& p, cudaStream_t st) {
  static bool raised[3][kMaxDevices] = {};
  const int bytes = pass == kFwd   ? FwdTile<T, DM, R>::kBytes
                    : pass == kDkv ? BwdTile<T, DM, R, true>::kBytes
                                   : BwdTile<T, DM, R, false>::kBytes;
  void (*kernel)(const Params) = pass == kFwd   ? flash_simt_fwd_kernel<T, DM, R>
                                 : pass == kDkv ? flash_simt_dkv_kernel<T, DM, R>
                                                : flash_simt_dq_kernel<T, DM, R>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), bytes, raised[pass]);
  if (err != 0) return err;
  const bool dkv = pass == kDkv;
  const long blocks = static_cast<long>((dkv ? p.T : p.S) + R - 1) / R * p.B *
                      (dkv ? p.KH : p.H) * (dkv ? p.splits : 1);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DM>
int launch_dm(int pass, const Params& p, int rows, cudaStream_t st) {
  if (rows == 16) return launch_rows<T, DM, 16>(pass, p, st);
  if (rows == 32) return launch_rows<T, DM, 32>(pass, p, st);
  if constexpr (DM <= 128) {
    if (rows == 64) return launch_rows<T, DM, 64>(pass, p, st);
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

// Launches the tensor-core forward at head-dim bucket DM, `rows` (16, 32,
// 64 or 128) query rows a CTA.
template <typename T, int DM>
int launch_mma(const Params& p, int rows, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  if (rows != 16 && rows != 32 && rows != 64 && rows != kMmaMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(reinterpret_cast<const void*>(flash_simt_fwd_mma_kernel<T, DM>),
                             mma_smem_bytes(DM, kMmaMaxRows), raised);
  if (err != 0) return err;
  const long blocks = static_cast<long>(p.S + rows - 1) / rows * p.B * p.H;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  flash_simt_fwd_mma_kernel<T, DM>
      <<<static_cast<unsigned>(blocks), 2 * rows, mma_smem_bytes(DM, rows), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core forward's head-dim buckets: every multiple of 16 up to
// 128, then 160, 192 and 256 (ops/flash_attention.py SIMT_MMA_BUCKETS).
template <typename T>
int launch_mma_t(const Params& p, int rows, cudaStream_t st) {
  switch ((p.D + 15) / 16) {
    case 1: return launch_mma<T, 16>(p, rows, st);
    case 2: return launch_mma<T, 32>(p, rows, st);
    case 3: return launch_mma<T, 48>(p, rows, st);
    case 4: return launch_mma<T, 64>(p, rows, st);
    case 5: return launch_mma<T, 80>(p, rows, st);
    case 6: return launch_mma<T, 96>(p, rows, st);
    case 7: return launch_mma<T, 112>(p, rows, st);
    case 8: return launch_mma<T, 128>(p, rows, st);
    case 9:
    case 10: return launch_mma<T, 160>(p, rows, st);
    case 11:
    case 12: return launch_mma<T, 192>(p, rows, st);
    default: return launch_mma<T, 256>(p, rows, st);
  }
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

// dtype: 0 fp32, 1 bf16, 2 fp16. kernel: the forward's (0 CUDA cores, 1
// tensor cores, bf16/fp16 only; the backward passes ignore it). rows and
// splits as the entry points below.
int launch(int pass, int dtype, Params& p, int B, int S, int T, int H, int KH, int D, int kind,
           int window, int prefix, float sm_scale, int kernel, int rows, int splits,
           void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 ||
      kind < 0 || kind > 3 || D < 1 || D > 256 || dtype < 0 || dtype > 2 || splits < 1 ||
      splits > kMaxSplits || (splits > 1 && (pass != kDkv || p.ws == nullptr ||
                                             p.tickets == nullptr)) ||
      kernel < 0 || kernel > 1 || (kernel == 1 && (pass != kFwd || dtype == 0)))
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
  if (kernel == 1)
    return dtype == 1 ? launch_mma_t<__nv_bfloat16>(p, rows, st) : launch_mma_t<__half>(p, rows, st);
  if (dtype == 0) return launch_t<float>(pass, p, rows, st);
  if (dtype == 1) return launch_t<__nv_bfloat16>(pass, p, rows, st);
  return launch_t<__half>(pass, p, rows, st);
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() after the
// launch (0 = ok), or cudaErrorInvalidValue for arguments they do not take.
// dtype: 0 fp32, 1 bf16, 2 fp16 (of every q/k/v/dO/o/dq/dk/dv tensor).
// kind: 0 causal, 1 full, 2 prefix_lm, 3 sliding_window. seg may be null.
// The forward's kernel: 0 the CUDA-core kernel (any dtype; rows 16, 32 or
// 64, at most 32 above head dim 128), 1 the tensor-core kernel (bf16 and
// fp16; rows 16, 32, 64 or 128). rows: query rows (forward, dq) or key rows
// (dk/dv) a CTA owns: 16, 32 or 64 (at most 32 above head dim 128).
// splits: CTAs a dk/dv key block's walk is split over (1..16); above 1, ws
// holds splits * 2 * rows * bucket fp32 for each of the B * KH * ceil(T /
// rows) key blocks and tickets one zeroed int32 each (left at zero).
extern "C" int tpk_flash_simt_fwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* seg, void* o, void* lse, int B, int S, int T,
                                  int H, int KH, int D, int kind, int window, int prefix,
                                  float sm_scale, int kernel, int rows, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = static_cast<const int*>(seg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  return launch(kFwd, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, kernel, rows,
                1, stream);
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
  return launch(kDq, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, 0, rows, 1,
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
  return launch(kDkv, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, 0, rows,
                splits, stream);
}
