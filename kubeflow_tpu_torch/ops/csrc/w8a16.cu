// W8A16 matmul for Hopper (sm_90a): activations in the compute dtype times
// int8 weight codes, the per-output-channel scale applied in the epilogue.
//
// Not a TPU kernel. It is the port's counterpart of what XLA fuses for the
// JAX package: the int8 branch of kubeflow_tpu/serve/quant.py::
// Int8DenseGeneral (and quant_unembed) reads the codes "through a bare
// convert" into the dot's operand read, so no weight-sized temporary exists.
// Eager PyTorch has no such fusion; this kernel is it:
//
//     out[m, n] = cast(acc[m, n] * scale[n])                 (dense)
//     out[m, n] = cast(float(cast(acc[m, n])) * scale[n])    (unembed)
//     acc[m, n] = sum_k float(x[m, k]) * float(q[n, k])      (fp32)
//
// Layout (Int8Dense's, no host-side copies): x [M, K] in the compute dtype
// (fp32, bf16 or fp16), q [N, K] int8 (K contiguous), scale [N] fp32, out
// [M, N] in the compute dtype.
//
// What bounds it on this card. At decode widths (M <= 16) every weight byte
// serves at most 2*16 flops: reading q once (K*N bytes at 3.35 TB/s) bounds
// it, e.g. 17.5 us for llama3_8b's gate projection, 157 us for its 128256 x
// 4096 unembedding. At prefill widths (M 128..2048) the bf16 tensor cores
// (989 TFLOP/s) do. Three kernels, chosen by the wrapper from the shape
// (_w8a16_plan in ops/w8a16.py), never by this file:
//
//   * w8a16_gemv_kernel (M <= 16, bf16/fp16): each warp streams 16 weight
//     rows along K, every lane 16 bytes of two rows per 64-deep k block
//     (loads that skip L1, four blocks in flight), and feeds them to
//     mma.sync m16n8k16 with the weight as the 16-row A operand and up to 8
//     activation rows as the 8-column B operand (two products for 9..16
//     rows). The k order inside a product is free as long as both operands
//     use the same one, so a lane's 16 contiguous bytes are its own
//     fragments: in k step s it holds bytes 4s..4s+3 of each row, and reads
//     the matching 4 activations of its B column straight from global
//     memory (the activations are small and stay in L1/L2). Each byte is
//     widened exactly: a byte permute into the fp32 2^23 magic and one
//     subtract, then a round to the 16-bit type (exact: |q| <= 127). Where
//     N leaves fewer than ~2 CTAs per SM, K is split across CTAs; each split
//     stores its fp32 partial tile, and the last to arrive (a ticket per
//     CTA column, reset to 0 by it) sums the partials in split order, so
//     two launches give the same bits. No float atomics.
//   * w8a16_mma_kernel (M > 16, bf16/fp16): 128 x 128 output tiles, eight
//     warps of 64 x 32 on mma.sync m16n8k16 with the activations as A and
//     the codes as B, 32-deep k tiles streamed by cp.async through a
//     3-stage shared-memory ring; the codes are widened when a warp loads
//     its B fragments (each widened pair feeds four products). Tiles are
//     dealt m fastest, so the CTAs running together share one strip of the
//     weight and it is read from memory about once; the 128-row tiles halve
//     the L2 traffic of 64-row ones. Not wgmma: a simple kernel first.
//   * w8a16_simt_kernel (fp32 activations, or K % 16 != 0, or an operand
//     not 16-byte aligned): 32 x 64 tiles on the CUDA cores in fp32, both
//     operands widened to fp32 in shared memory, each output summed in k
//     order. fp32 models get fp32 products, as the JAX branch gives them.
//
// Accumulation is fp32 everywhere (mma.sync's f32 accumulators); the
// epilogue multiplies with __fmul_rn, so no FMA contraction changes the
// rounding of the scale product.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 4;   // 16 weight rows each: 64 rows a CTA
constexpr int kGemvRows = 16 * kGemvWarps;
constexpr int kGemvUnroll = 4;  // 64-deep k blocks in flight per lane
constexpr int kTile = 128;      // mma kernel: 128 x 128 output tiles
constexpr int kTileK = 32;      // ... over 32-deep k tiles
constexpr int kMmaThreads = 256;
constexpr int kStages = 3;      // k tiles in flight
constexpr int kXStride = 96;    // bytes per staged activation row (64 + 32 pad)
constexpr int kWStride = 48;    // bytes per staged weight row (32 + 16 pad)
constexpr int kStageBytes = kTile * (kXStride + kWStride);
constexpr int kSimtM = 32, kSimtN = 64, kSimtK = 32;

enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };
enum Kernel { kSimt = 0, kGemv = 1, kMma = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// The epilogue: the dense form scales the fp32 sum; the unembedding's rounds
// the sum to the compute dtype first, as the einsum it replaces returns
// logits in that dtype before the scale.
template <typename T>
__device__ __forceinline__ T finish(float acc, float scale, int round_first) {
  if (round_first) acc = to_f(from_f<T>(acc));
  return from_f<T>(__fmul_rn(acc, scale));
}

// Four int8 codes (k order, low byte first) to fp32, exactly: each byte,
// biased to unsigned, becomes the low mantissa byte of 2^23, and 2^23 + 128
// comes off.
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four codes to two 16-bit pairs: (k0, k1) and (k2, k3).
template <typename T>
__device__ __forceinline__ void codes_to_pairs(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  widen4(w, f);
  lo = pack2<T>(f[0], f[1]);
  hi = pack2<T>(f[2], f[3]);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 weight bytes that are read once: past L1, which keeps the activations.
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------ gemv

// CTA: 4 warps, 64 weight rows (warp w: rows n0 + 16w .. +15), K split
// `splits` ways over gridDim.y in whole 64-deep blocks. MT: 8-row groups of
// activations (1 for M <= 8, 2 for M <= 16).
//
// Lane (g = lane / 4, c = lane % 4) of a warp owns weight rows g and g + 8
// and, in every 64-deep block at k, their bytes k + 16c .. k + 16c + 15;
// mma step s (0..3) takes bytes 4s..4s+3 of those as the A fragment's
// columns {2c, 2c+1} (bytes 0, 1) and {2c+8, 2c+9} (bytes 2, 3), and the B
// fragment of activation row g (column g of B) takes the same four k.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * kGemvWarps)
    w8a16_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ out,
                      float* __restrict__ ws, int* __restrict__ tickets, int M, int K, int N,
                      int splits, int round_first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int row_a = blockIdx.x * kGemvRows + warp * 16 + g, row_b = row_a + 8;
  const bool a_ok = row_a < N, b_ok = row_b < N;
  const int8_t* qa = q + static_cast<size_t>(a_ok ? row_a : 0) * K;
  const int8_t* qb = q + static_cast<size_t>(b_ok ? row_b : 0) * K;
  const int n_kb = (K + 63) / 64;
  const int kb0 = static_cast<int>(static_cast<long long>(blockIdx.y) * n_kb / splits);
  const int kb1 = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * n_kb / splits);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;

  for (int kb = kb0; kb < kb1; kb += kGemvUnroll) {
    uint4 wa[kGemvUnroll], wb[kGemvUnroll], xv[kGemvUnroll][MT][2];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int k = (kb + u) * 64 + 16 * c;
      const bool in = kb + u < kb1 && k < K;
      wa[u] = in && a_ok ? load_stream(qa + k) : zero;
      wb[u] = in && b_ok ? load_stream(qb + k) : zero;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + g;
        const bool m_in = in && m < M;
        const uint4* xp = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m_in ? m : 0) * K +
                                                         (in ? k : 0));
        xv[u][mt][0] = m_in ? __ldg(xp) : zero;
        xv[u][mt][1] = m_in ? __ldg(xp + 1) : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4];
        codes_to_pairs<T>(word(wa[u], s), a[0], a[2]);
        codes_to_pairs<T>(word(wb[u], s), a[1], a[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4& v = xv[u][mt][s >> 1];
          mma16816<T>(acc[mt], a, word(v, 2 * (s & 1)), word(v, 2 * (s & 1) + 1));
        }
      }
    }
  }

  // acc[mt][e]: weight row (e < 2 ? row_a : row_b), activation row
  // mt * 8 + 2c + (e & 1).
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = e < 2 ? row_a : row_b, m = mt * 8 + 2 * c + (e & 1);
        if (m < M && n < N)
          out[static_cast<size_t>(m) * N + n] = finish<T>(acc[mt][e], scale[n], round_first);
      }
    return;
  }
  float* part = ws + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? row_a : row_b, m = mt * 8 + 2 * c + (e & 1);
      if (m < M && n < N) part[static_cast<size_t>(m) * N + n] = acc[mt][e];
    }
  // The ticket: every thread's partial is visible device-wide before the
  // count; the last split of this CTA column resets it and reduces.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
    if (last) {
      tickets[blockIdx.x] = 0;
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? row_a : row_b, m = mt * 8 + 2 * c + (e & 1);
      if (m >= M || n >= N) continue;
      float sum = 0.0f;
      for (int sp = 0; sp < splits; ++sp)  // split order: the same bits every launch
        sum += __ldcg(ws + (static_cast<size_t>(sp) * M + m) * N + n);
      out[static_cast<size_t>(m) * N + n] = finish<T>(sum, scale[n], round_first);
    }
}

// ------------------------------------------------------------------- mma

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// CTA: 8 warps as 2 (m) x 4 (n), each a 64 x 32 tile of a 128 x 128 output
// tile: four m16 A fragments (activations) by four n8 B fragments (codes)
// per 16-deep k step. 32-deep k tiles stream through a ring of kStages
// shared-memory stages by cp.async (zero-filled past the edges). In a step,
// lane (g, c) reads elements 4c..4c+3 of activation rows g and g + 8 (A
// columns {2c, 2c+1} and {2c+8, 2c+9}) and bytes 4c..4c+3 of weight row g
// (the same B rows): one k order for both operands. The row pads make both
// reads free of bank conflicts.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, 2)
    w8a16_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N,
                     int round_first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // One k tile into stage st: 128 activation rows x 32 elements (two
  // 16-byte chunks a thread), 128 weight rows x 32 bytes (one a thread).
  auto load = [&](int st, int k0) {
    const uint32_t xs = base + st * kStageBytes, ws = xs + kTile * kXStride;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + kMmaThreads * i, row = idx >> 2, k = k0 + (idx & 3) * 8;
      const bool ok = m0 + row < M && k < K;
      cp_async16(xs + row * kXStride + (idx & 3) * 16,
                 ok ? x + static_cast<size_t>(m0 + row) * K + k : x, ok);
    }
    const int row = tid >> 1, k = k0 + (tid & 1) * 16;
    const bool ok = n0 + row < N && k < K;
    cp_async16(ws + row * kWStride + (tid & 1) * 16,
               ok ? q + static_cast<size_t>(n0 + row) * K + k : q, ok);
  };

  const int n_kt = (K + kTileK - 1) / kTileK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) load(st, st * kTileK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread, and tile kt-1 is consumed
    const int next = kt + kStages - 1;
    if (next < n_kt) load(next % kStages, next * kTileK);
    cp_async_commit();
    const unsigned char* xs = smem + (kt % kStages) * kStageBytes;
    const unsigned char* wsm = xs + kTile * kXStride;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        const int col = (s * 16 + 4 * c) * static_cast<int>(sizeof(T));
        const uint2 lo = *reinterpret_cast<const uint2*>(&xs[r * kXStride + col]);
        const uint2 hi = *reinterpret_cast<const uint2*>(&xs[(r + 8) * kXStride + col]);
        a[i][0] = lo.x;
        a[i][1] = hi.x;
        a[i][2] = lo.y;
        a[i][3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        uint32_t b0, b1;
        codes_to_pairs<T>(*reinterpret_cast<const uint32_t*>(&wsm[n * kWStride + s * 16 + 4 * c]),
                          b0, b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma16816<T>(acc[i][j], a[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // acc[i][j][e]: activation row m0 + wm + 16i + g (+8 for e >= 2), weight
  // row n0 + wn + 8j + 2c + (e & 1).
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h, n = n0 + wn + 8 * j + 2 * c;
        if (m >= M) continue;
        T* o = out + static_cast<size_t>(m) * N + n;
        if (n < N) o[0] = finish<T>(acc[i][j][2 * h], scale[n], round_first);
        if (n + 1 < N) o[1] = finish<T>(acc[i][j][2 * h + 1], scale[n + 1], round_first);
      }
}

// ------------------------------------------------------------------ simt

// CTA: 256 threads, a 32 (m) x 64 (n) tile; thread (tm, tn) = (tid / 16,
// tid % 16) computes rows 2tm, 2tm + 1 and columns tn + 16j (j < 4), each
// an fp32 FMA chain in k order. Any K, any alignment.
template <typename T>
__global__ void __launch_bounds__(256)
    w8a16_simt_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N,
                      int round_first) {
  __shared__ float xs[kSimtM][kSimtK + 1];
  __shared__ float wsm[kSimtN][kSimtK + 1];
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const int n0 = blockIdx.x * kSimtN, m0 = blockIdx.y * kSimtM;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSimtK) {
#pragma unroll
    for (int i = 0; i < kSimtM * kSimtK / 256; ++i) {
      const int idx = tid + 256 * i, r = idx / kSimtK, kk = idx % kSimtK;
      const int m = m0 + r, k = k0 + kk;
      xs[r][kk] = m < M && k < K ? to_f(x[static_cast<size_t>(m) * K + k]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kSimtN * kSimtK / 256; ++i) {
      const int idx = tid + 256 * i, r = idx / kSimtK, kk = idx % kSimtK;
      const int n = n0 + r, k = k0 + kk;
      wsm[r][kk] = n < N && k < K ? static_cast<float>(q[static_cast<size_t>(n) * K + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSimtK; ++kk) {
      const float a0 = xs[2 * tm][kk], a1 = xs[2 * tm + 1][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = wsm[tn + 16 * j][kk];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 2 * tm + i, n = n0 + tn + 16 * j;
      if (m < M && n < N)
        out[static_cast<size_t>(m) * N + n] = finish<T>(acc[i][j], scale[n], round_first);
    }
}

// ---------------------------------------------------------------- launch

template <typename T>
cudaError_t launch(int kernel, const void* x, const int8_t* q, const float* scale, void* out,
                   float* ws, int* tickets, int M, int K, int N, int splits, int round_first,
                   cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (kernel == kSimt) {
    const dim3 grid((N + kSimtN - 1) / kSimtN, (M + kSimtM - 1) / kSimtM);
    w8a16_simt_kernel<T><<<grid, 256, 0, st>>>(xp, q, scale, op, M, K, N, round_first);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 2) {
    if (kernel == kGemv) {
      const dim3 grid((N + kGemvRows - 1) / kGemvRows, splits);
      if (M <= 8)
        w8a16_gemv_kernel<T, 1><<<grid, 32 * kGemvWarps, 0, st>>>(xp, q, scale, op, ws, tickets,
                                                                   M, K, N, splits, round_first);
      else
        w8a16_gemv_kernel<T, 2><<<grid, 32 * kGemvWarps, 0, st>>>(xp, q, scale, op, ws, tickets,
                                                                   M, K, N, splits, round_first);
      return cudaGetLastError();
    }
    const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
    const cudaError_t err = cudaFuncSetAttribute(
        w8a16_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStages * kStageBytes);
    if (err != cudaSuccess) return err;
    w8a16_mma_kernel<T><<<grid, kMmaThreads, kStages * kStageBytes, st>>>(xp, q, scale, op, M, K,
                                                                          N, round_first);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (x and out). kernel: 0 simt, 1 gemv (M <=
// 16; K split `splits` ways, ws [splits, M, N] fp32 and tickets (one int per
// 64 weight rows, all 0) read only when splits > 1), 2 mma. round_first: the
// unembedding's epilogue. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int tpk_w8a16(const void* x, const void* q, const void* scale, void* out, void* ws,
                         void* tickets, int M, int K, int N, int dtype, int round_first,
                         int kernel, int splits, void* stream) {
  if (M < 0 || K < 1 || N < 0 || dtype < kF32 || dtype > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  if (kernel != kSimt) {
    const int n_kb = (K + 63) / 64;
    if (dtype == kF32 || K % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(q) % 16 != 0 || (kernel != kGemv && kernel != kMma) ||
        (kernel == kGemv && (M > 16 || splits < 1 || splits > n_kb || splits > 65535 ||
                             (splits > 1 && (ws == nullptr || tickets == nullptr)))) ||
        (kernel == kMma && (N + kTile - 1) / kTile > 65535))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if ((M + kSimtM - 1) / kSimtM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* wsp = static_cast<float*>(ws);
  auto* tp = static_cast<int*>(tickets);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch<float>(kernel, x, qp, sp, out, wsp, tp, M, K, N, splits, round_first, st);
      break;
    case kBf16:
      err = launch<__nv_bfloat16>(kernel, x, qp, sp, out, wsp, tp, M, K, N, splits, round_first,
                                  st);
      break;
    default:
      err = launch<__half>(kernel, x, qp, sp, out, wsp, tp, M, K, N, splits, round_first, st);
  }
  return static_cast<int>(err);
}
