// Flash attention on the CUDA cores (sm_90a): forward, dq and dk/dv for the
// inputs the wgmma kernels (flash_fwd.cu, flash_bwd.cu) do not take — fp32,
// bf16 or fp16 q/k/v at any head dim up to 256.
//
// Replaces, for those inputs, the same TPU kernels as the wgmma kernels:
// kubeflow_tpu/ops/flash_attention.py::_flash_fwd_kernel, _flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel. The TPU kernels read any dtype and head dim and
// compute in fp32 (Mosaic pads a narrow head dim to the 128 lanes); so do
// these: every input is widened to fp32 in shared memory, every product and
// sum is fp32 on the CUDA cores, and only the outputs are rounded to the
// input dtype. An fp32 model therefore gets fp32 attention, not a bf16 one.
//
// What bounds them on this card: fp32 FMAs on the CUDA cores (67 TFLOP/s at
// 700 W), not the tensor cores and not memory. Each (q, k) pair costs 4*D
// flops forward and 8*D backward; each CTA reads every visible K/V (or Q/dO)
// row once into shared memory for its 16 rows. The design is the simple one
// that is right: a warp owns 4 rows; each lane owns one key (or q row) of a
// 32-row tile for the dot products, and D/32 columns of the accumulators,
// with the per-key weights broadcast by shuffle. Making them fast is later
// work; the configs they serve (head dim 16, fp32 models) are small.
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
  int B, S, T, H, KH, D, kind, window, prefix;
  float scale;
};

// Whether query row `row` sees key column `col` (both in range) under the
// mask kind and the segment ids of batch row `seg` (null: no segments).
__device__ __forceinline__ bool visible(const Params& p, const int* seg, int row, int col) {
  bool vis = true;
  switch (p.kind) {
    case kCausal: vis = row >= col; break;
    case kPrefixLM: vis = row >= col || col < p.prefix; break;
    case kSlidingWindow: vis = row >= col && row - col < p.window; break;
    default: break;
  }
  return vis && (seg == nullptr || seg[row] == seg[col]);
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

// ---- backward: dq -------------------------------------------------------
// CTA: kRows query rows of one (b, h). Shared: Q, dO [kRows][DM]; K, V
// [kTile][DM+1]. Lane j takes key j of a tile for s and dp; the ds row is
// then broadcast to accumulate dq = ds K over the lanes' columns.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_simt_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kRows * DM;
  float* sk = sdo + kRows * DM;
  float* sv = sk + kTile * (DM + 1);
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const int kh = h / (p.H / p.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<long>(b) * p.S;
  constexpr int kC = DM / 32;

  load_rows<T, DM>(sq, DM, static_cast<const T*>(p.q), kRows, r0, p.S, b, p.H, h, p.D);
  load_rows<T, DM>(sdo, DM, static_cast<const T*>(p.dout), kRows, r0, p.S, b, p.H, h, p.D);
  float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    const long at = (static_cast<long>(b) * p.S + row) * p.H + h;
    lse[i] = row < p.S ? p.lse_in[at] : 0.f;
    delta[i] = row < p.S ? p.delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }
  int lo, hi;
  key_range(p, r0, min(r0 + kRows, p.S) - 1, lo, hi);
  for (int t0 = lo / kTile * kTile; t0 <= hi; t0 += kTile) {
    __syncthreads();
    load_rows<T, DM>(sk, DM + 1, static_cast<const T*>(p.k), kTile, t0, p.T, b, p.KH, kh, p.D);
    load_rows<T, DM>(sv, DM + 1, static_cast<const T*>(p.v), kTile, t0, p.T, b, p.KH, kh, p.D);
    __syncthreads();
    const int col = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int rr = warp * kRowsPerWarp + i, row = r0 + rr;
      if (row >= p.S) continue;
      const bool vis = col < p.T && visible(p, seg, row, col);
      float ds = 0.f;
      if (vis) {
        const float s = dot(sq + rr * DM, sk + lane * (DM + 1), p.D) * p.scale;
        const float pr = expf(s - lse[i]);
        const float dp = dot(sdo + rr * DM, sv + lane * (DM + 1), p.D);
        ds = pr * (dp - delta[i]);
      }
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int c = 0; c < kC; ++c)
          acc[i][c] = fmaf(dsj, sk[j * (DM + 1) + lane + 32 * c], acc[i][c]);
      }
    }
  }
  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = r0 + warp * kRowsPerWarp + i;
    if (row >= p.S) continue;
    const long base = ((static_cast<long>(b) * p.S + row) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) dq[base + d] = from_f<T>(acc[i][c] * p.scale);
    }
  }
}

// ---- backward: dk, dv ---------------------------------------------------
// CTA: kRows key rows of one (b, kv head), walking the GQA group's q heads
// and, for each, the q tiles that may see those keys. Shared: K, V
// [kRows][DM]; Q, dO [kTile][DM+1]; lse, delta [kTile]. Lane j takes q row
// j of a tile for s and dp; p and ds are broadcast to accumulate dv = pᵀ dO
// and dk = dsᵀ Q over the lanes' columns.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_simt_dkv_kernel(const Params p) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kRows * DM;
  float* sq = sv + kRows * DM;
  float* sdo = sq + kTile * (DM + 1);
  float* slse = sdo + kTile * (DM + 1);
  float* sdelta = slse + kTile;
  const int b = blockIdx.z, kh = blockIdx.y, c0 = blockIdx.x * kRows;
  const int group = p.H / p.KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* seg = p.seg == nullptr ? nullptr : p.seg + static_cast<long>(b) * p.S;
  constexpr int kC = DM / 32;

  load_rows<T, DM>(sk, DM, static_cast<const T*>(p.k), kRows, c0, p.T, b, p.KH, kh, p.D);
  load_rows<T, DM>(sv, DM, static_cast<const T*>(p.v), kRows, c0, p.T, b, p.KH, kh, p.D);
  float dk[kRowsPerWarp][kC], dv[kRowsPerWarp][kC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.f;
  int lo, hi;
  query_range(p, c0, min(c0 + kRows, p.T) - 1, lo, hi);
  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    for (int q0 = lo / kTile * kTile; q0 <= hi; q0 += kTile) {
      __syncthreads();
      load_rows<T, DM>(sq, DM + 1, static_cast<const T*>(p.q), kTile, q0, p.S, b, p.H, h, p.D);
      load_rows<T, DM>(sdo, DM + 1, static_cast<const T*>(p.dout), kTile, q0, p.S, b, p.H, h,
                       p.D);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        const long at = (static_cast<long>(b) * p.S + row) * p.H + h;
        slse[threadIdx.x] = row < p.S ? p.lse_in[at] : 0.f;
        sdelta[threadIdx.x] = row < p.S ? p.delta[at] : 0.f;
      }
      __syncthreads();
      const int row = q0 + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int cc = warp * kRowsPerWarp + i, col = c0 + cc;
        if (col >= p.T) continue;  // uniform across the warp
        // Padded q rows (row >= S) never reach exp: p stays exactly 0.
        const bool vis = row < p.S && visible(p, seg, row, col);
        float pr = 0.f, ds = 0.f;
        if (vis) {
          const float s = dot(sq + lane * (DM + 1), sk + cc * DM, p.D) * p.scale;
          pr = expf(s - slse[lane]);
          const float dp = dot(sdo + lane * (DM + 1), sv + cc * DM, p.D);
          ds = pr * (dp - sdelta[lane]);
        }
        for (int j = 0; j < kTile; ++j) {
          const float pj = __shfl_sync(kFull, pr, j);
          const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int d = lane + 32 * c;
            dv[i][c] = fmaf(pj, sdo[j * (DM + 1) + d], dv[i][c]);
            dk[i][c] = fmaf(dsj, sq[j * (DM + 1) + d], dk[i][c]);
          }
        }
      }
    }
  }
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int col = c0 + warp * kRowsPerWarp + i;
    if (col >= p.T) continue;
    const long base = ((static_cast<long>(b) * p.T + col) * p.KH + kh) * p.D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) {
        dkp[base + d] = from_f<T>(dk[i][c] * p.scale);
        dvp[base + d] = from_f<T>(dv[i][c]);
      }
    }
  }
}

enum Pass { kFwd = 0, kDq = 1, kDkv = 2 };

template <int DM>
constexpr int smem_bytes(int pass) {
  return 4 * (pass == kFwd  ? kRows * DM + kTile * (DM + 1) + kTile * DM
              : pass == kDq ? 2 * kRows * DM + 2 * kTile * (DM + 1)
                            : 2 * kRows * DM + 2 * kTile * (DM + 1) + 2 * kTile);
}

// Launches one pass at head-dim bucket DM. The shared-memory limit of an
// instantiation is raised once per device, where it is above the default.
template <typename T, int DM>
int launch_dm(int pass, const Params& p, cudaStream_t st) {
  const int bytes = pass == kFwd ? smem_bytes<DM>(kFwd)
                    : pass == kDq ? smem_bytes<DM>(kDq)
                                  : smem_bytes<DM>(kDkv);
  void (*kernel)(const Params) = pass == kFwd  ? flash_simt_fwd_kernel<T, DM>
                                 : pass == kDq ? flash_simt_dq_kernel<T, DM>
                                               : flash_simt_dkv_kernel<T, DM>;
  if (bytes > 48 * 1024) {
    constexpr int kMaxDevices = 64;
    static bool raised[3][kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[pass][dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[pass][dev] = true;
    }
  }
  const int rows = pass == kDkv ? p.T : p.S;
  const dim3 grid((rows + kRows - 1) / kRows, pass == kDkv ? p.KH : p.H, p.B);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int pass, const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch_dm<T, 32>(pass, p, st);
  if (p.D <= 64) return launch_dm<T, 64>(pass, p, st);
  if (p.D <= 128) return launch_dm<T, 128>(pass, p, st);
  return launch_dm<T, 256>(pass, p, st);
}

// dtype: 0 fp32, 1 bf16, 2 fp16.
int launch(int pass, int dtype, Params& p, int B, int S, int T, int H, int KH, int D, int kind,
           int window, int prefix, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535 ||
      kind < 0 || kind > 3 || D < 1 || D > 256 || dtype < 0 || dtype > 2)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(pass, p, st);
  if (dtype == 1) return launch_t<__nv_bfloat16>(pass, p, st);
  return launch_t<__half>(pass, p, st);
}

}  // namespace

// All three launch on `stream` and return cudaGetLastError() after the
// launch (0 = ok), or cudaErrorInvalidValue for arguments they do not take.
// dtype: 0 fp32, 1 bf16, 2 fp16 (of every q/k/v/dO/o/dq/dk/dv tensor).
// kind: 0 causal, 1 full, 2 prefix_lm, 3 sliding_window. seg may be null.
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
  return launch(kFwd, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, stream);
}

extern "C" int tpk_flash_simt_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* seg, void* dq, int B, int S, int T, int H,
                                     int KH, int D, int kind, int window, int prefix,
                                     float sm_scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg = static_cast<const int*>(seg);
  p.dq = dq;
  return launch(kDq, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, stream);
}

extern "C" int tpk_flash_simt_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* seg, void* dk, void* dv, int B, int S, int T,
                                      int H, int KH, int D, int kind, int window, int prefix,
                                      float sm_scale, void* stream) {
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
  return launch(kDkv, dtype, p, B, S, T, H, KH, D, kind, window, prefix, sm_scale, stream);
}
