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
// is exact for K <= 133,000, so the kernel agrees bit for bit with a plain
// version that sums exactly and applies the same epilogue. Per-row
// activation quantization (sx, qx) stays outside, in the wrapper, as the
// JAX package keeps it outside its pallas_call.
//
// Layout (the JAX package's, no transposes on the host):
//   qx [M, K] int8 (K contiguous), sx [M] fp32,
//   qw [K, N] int8 (N contiguous), sw [N] fp32, out [M, N] fp32 or bf16.
//
// What bounds it on this card. At prefill widths (M = 2048, K = 4096,
// N = 14336) the product is 2*M*K*N int8 operations against ~(M*K + K*N)
// bytes in and 4*M*N bytes out: far above the H100's int8 ridge, so it is
// bound by tensor-core throughput (1,979 TOP/s dense). At decode widths
// (M = 32) every weight byte serves only 2*M operations, far below the ridge:
// it is bound by reading qw once (K*N bytes at 3.35 TB/s).
//
// What this design does about each. Operations: every product runs on the
// int8 tensor cores (mma.sync m16n8k32, int32 accumulators in registers),
// each warp owning a 64x32 output tile (16 mma per 32-deep k step from 4 A
// and 4 B fragments); the grid walks M fastest, so the CTAs that run
// together share one 128-column strip of qw and the activations stay in L2.
// Bytes: qw is read once per 128-row strip of M, and a four-stage cp.async
// pipeline keeps three 64-deep K tiles of A and B in flight per CTA while
// the fourth is consumed, copied straight into shared memory (no register
// staging). Warps whose 64 rows lie wholly past M skip their products, so a
// decode call with M = 32 spends its time on the weight reads. It does not
// use wgmma or TMA: that is later work.
//
// The B layout. mma's B fragment wants 4 consecutive k bytes of one column n
// in each register, but qw keeps n contiguous and ldmatrix.trans moves only
// 16-bit elements. So each B tile lands raw ([BK][BN], n contiguous) and,
// once it has landed, is transposed shared-to-shared: each thread reads 4
// k-rows x 8 n-bytes, regroups them with byte permutes (prmt) into 8 words
// of 4 k-bytes, and stores them as [BN][BK + pad] k-contiguous rows. A plain
// ldmatrix (16-bit pairs = int8 pairs along k) then yields the A and the B
// fragments alike. The public layout stays [K, N] and the weight is never
// transposed on the host.
//
// Ragged edges. Tiles are zero-filled in shared memory past M, N and K
// (zeros add nothing to the sums) and nothing is written past M or N. The
// cp.async path moves 16-byte chunks, so it needs K % 16 == 0, N % 16 == 0
// and 16-byte aligned operands; any other shape stages its tiles with
// byte-wise loads and the same zero fill (the JAX test shapes K = 100 and
// N = 200 go there), so the wrapper never pads or copies an operand.
//
// Grid: (ceil(M / 128), ceil(N / 128)). 256 threads = 8 warps as 2 (m) x 4
// (n). Shared memory (dynamic): four stages of a 128x64 A tile and a raw
// 64x128 B tile, and one transposed 128x64 B tile; A and transposed-B rows
// are padded to 80 bytes (ldmatrix reads are conflict-free at that stride):
// 88,064 bytes, two CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// 16 bytes global -> shared without registers; zero-filled when !valid
// (src-size 0: nothing is read from `src`).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// 16 bytes of a row-major int8 matrix from (row, col), zero past its edges,
// byte by byte (the path for shapes the 16-byte copies cannot take).
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

// Start copying K tile `k0` of A and of raw B into stage `st`: 512 16-byte
// chunks of each, two per thread.
template <bool kFast>
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
    const int m = m0 + ar, ka = k0 + ac, kb = k0 + br, n = n0 + bc;
    if (kFast) {
      const bool va = m < M && ka < K, vb = kb < K && n < N;
      cp_async16(&s.a[st][ar][ac], va ? qx + (size_t)m * K + ka : qx, va);
      cp_async16(&s.raw[st][br][bc], vb ? qw + (size_t)kb * N + n : qw, vb);
    } else {
      *reinterpret_cast<uint4*>(&s.a[st][ar][ac]) =
          load16_bytewise(qx, M, K, m, ka);
      *reinterpret_cast<uint4*>(&s.raw[st][br][bc]) =
          load16_bytewise(qw, K, N, kb, n);
    }
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

template <bool kFast, bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 2)
qmm_kernel(const int8_t* __restrict__ qx, const float* __restrict__ sx,
           const int8_t* __restrict__ qw, const float* __restrict__ sw,
           void* __restrict__ out, int M, int K, int N) {
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
    if (t < n_tiles)
      load_tile<kFast>(s, t, qx, qw, M, K, N, m0, n0, t * kBK, tid);
    cp_async_commit();
  }

  // ldmatrix lane addressing: lane l gives row (l % 8) of matrix (l / 8).
  const int lrow = lane % 8, lmat = lane / 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
    // Every thread's copies of tile t have landed, and every warp is done
    // with tile t - 1 (its A stage and s.b may be overwritten).
    __syncthreads();
    transpose_b(s, st, tid);
    const int next = t + kStages - 1;
    if (next < n_tiles)
      load_tile<kFast>(s, next % kStages, qx, qw, M, K, N, m0, n0,
                       next * kBK, tid);
    cp_async_commit();
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
  cp_async_wait<0>();

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

template <bool kFast, bool kBf16Out>
cudaError_t launch(const int8_t* qx, const float* sx, const int8_t* qw,
                   const float* sw, void* out, int M, int K, int N,
                   cudaStream_t st) {
  auto* kernel = qmm_kernel<kFast, kBf16Out>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  kernel<<<grid, kThreads, sizeof(Smem), st>>>(qx, sx, qw, sw, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// out_bf16: 0 = fp32 output, 1 = bf16. Returns a cudaError_t (0 = launched).
extern "C" int tpk_qmm(const void* qx, const void* sx, const void* qw,
                       const void* sw, void* out, int M, int K, int N,
                       int out_bf16, void* stream) {
  if (M < 0 || K < 0 || N < 0 || (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const auto* a = static_cast<const int8_t*>(qx);
  const auto* b = static_cast<const int8_t*>(qw);
  const bool fast = K % 16 == 0 && N % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  cudaError_t err;
  if (fast) {
    err = out_bf16 ? launch<true, true>(a, sxp, b, swp, out, M, K, N, st)
                   : launch<true, false>(a, sxp, b, swp, out, M, K, N, st);
  } else {
    err = out_bf16 ? launch<false, true>(a, sxp, b, swp, out, M, K, N, st)
                   : launch<false, false>(a, sxp, b, swp, out, M, K, N, st);
  }
  return static_cast<int>(err);
}
