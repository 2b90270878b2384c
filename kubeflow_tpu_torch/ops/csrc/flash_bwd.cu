// Flash-attention backward for Hopper (sm_90a): dq, then dk/dv. bf16 in,
// fp32 accumulation, the softmax recomputed from the forward's saved lse.
//
// Replaces the TPU kernels of kubeflow_tpu/ops/flash_attention.py, launched
// by _flash_bwd_impl:
//   * tpk_flash_bwd_dq  <- _flash_bwd_dq_kernel: one CTA per (b, h, 64-row
//     q tile) walks the kv tiles _q_visible says it can see, recomputes
//     S = Q K^T and dP = dO V^T, forms dS = P * (dP - delta) with
//     P = exp(S * scale - lse), and accumulates dq = dS K in fp32
//     registers; sm_scale is applied once at the end.
//   * tpk_flash_bwd_dkv <- _flash_bwd_dkv_kernel: one CTA per (b, kv head,
//     64-row kv tile) loops over the GQA group's q heads and the q tiles
//     _kv_visible says see it, and accumulates dk = dS^T (Q * scale) and
//     dv = P^T dO in fp32 registers. Each CTA owns its dk/dv rows outright:
//     no atomics, no second reduction pass, as in the JAX kernel.
// delta = rowsum(dO * O) - g_lse is plain tensor arithmetic outside the
// kernels, as it is in JAX (flash_attention.py computes it in PyTorch).
//
// Layout (the JAX package's, so no transposes or pads on the host):
//   q, do, dq [B, S, H, D]; k, v, dk, dv [B, T, KH, D] (bf16, contiguous)
//   lse, delta [B, S, H] fp32; seg [B, S] int32 or null (self-attention)
// Both kernels mask cols < T and rows < S themselves and zero-fill tiles
// past the edge, so no padded copies exist; rows past the edge are never
// written.
//
// What bounds them on this card: per visible (q, k) pair dq does three
// products (S, dP, dS K: 6*D flops) and dk/dv four (S, dP, P^T dO, dS^T Q:
// 8*D flops) against 2*D bytes of K/V per kv row (dq) or 4*D bytes of Q/dO
// per q row (dk/dv): far above the H100's ~295 flop/byte ridge at training
// shapes, so tensor-core throughput bounds both. The design does the simple
// thing about that: every product runs on tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate) and only visible tiles are walked. It
// does not yet use wgmma, TMA, a copy pipeline or warp specialisation.
//
// Registers are the constraint that shaped it. dk/dv keeps a warp's 16 kv
// rows of dk AND dv in fp32 registers (2 * 16 * D / 32 = 128 per thread at
// D = 128), so everything else is kept small: the products are formulated
// transposed (S^T = K Q^T, dP^T = V dO^T, dv += P^T dO, dk += dS^T Q, rows
// = kv rows, FlashAttention-2's layout), K and V stay in shared memory and
// are read as A fragments per k-slice instead of being held in registers,
// and the q walk takes 32-row tiles. dq holds its Q and dO fragments in
// registers for the whole walk and takes each 64-row kv tile in two 32-
// column halves to bound the live score fragments. B operands that need a
// transpose (K in dS K, dO and Q in the dk/dv products) come from
// ldmatrix.trans; P and dS are re-packed from the accumulator layout as
// bf16 A fragments. Masked and padded entries get p = 0 exactly (a select,
// never a product with exp of garbage), so no inf or stale lse reaches a
// product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // 16 rows per warp
constexpr int kBQ = 64;     // dq: q rows per CTA
constexpr int kBKV = 64;    // dq: kv rows per tile; dk/dv: kv rows per CTA
constexpr int kBQT = 32;    // dk/dv: q rows per tile of its walk

enum MaskKind { kCausal = 0, kFull = 1, kPrefixLM = 2, kSlidingWindow = 3 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one m16n8k16 tile: a row-major 16x16 bf16 (4 regs),
// b column-major 16x8 bf16 (2 regs), c 16x8 fp32 (4 regs).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory; lane i gives the
// address of row (i % 8) of matrix (i / 8).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment of rows [row0, row0 + 16) x cols [col0, col0 + 16) of a
// row-major shared tile with row stride lds (bf16 elements).
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile, int lds,
                                            int row0, int col0, int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + g) * lds + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * lds);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * lds + 8);
}

__device__ __forceinline__ bool visible(int row, int col, int kind, int window,
                                        int prefix) {
  if (kind == kCausal) return row >= col;
  if (kind == kPrefixLM) return row >= col || col < prefix;
  if (kind == kSlidingWindow) return row >= col && row - col < window;
  return true;
}

// Copy rows [row0, row0 + ROWS) of a [*, D] slab with row stride `stride`
// into a padded shared tile, zero-filling rows at or past `limit`.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, long stride,
                                          int row0, int limit) {
  constexpr int kLds = D + 8;
  constexpr int kChunks = ROWS * D / 8;  // 16-byte pieces
  for (int c = threadIdx.x; c < kChunks; c += kWarps * 32) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dq, int S, int T, int H,
                    int KH, int kind, int window, int prefix,
                    float sm_scale) {
  constexpr int kLds = D + 8;  // padded smem row: conflict-free reads
  constexpr int kKD = D / 16;  // k-slices over the head dim
  constexpr int kND = D / 8;   // n-tiles of dq over the head dim
  __shared__ __align__(16) __nv_bfloat16 ks[kBKV * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[kBKV * kLds];
  __shared__ int kseg[kBKV];

  const int qi = blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int rows[2];
  rows[0] = qi * kBQ + warp * 16 + g;
  rows[1] = rows[0] + 8;

  // Q and dO fragments, read once from global and held for the whole walk.
  const long q_stride = static_cast<long>(H) * D;
  uint32_t qf[kKD][4], df[kKD][4];
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t qv = 0u, dv = 0u;
        if (rows[r] < S) {
          const long off = (static_cast<long>(b) * S + rows[r]) * q_stride +
                           static_cast<long>(h) * D + kk * 16 + half * 8 + 2 * t;
          qv = ld32(q + off);
          dv = ld32(dout + off);
        }
        qf[kk][half * 2 + r] = qv;
        df[kk][half * 2 + r] = dv;
      }
    }
  }
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  int qseg[2] = {-1, -1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < S) {
      const long idx = (static_cast<long>(b) * S + rows[r]) * H + h;
      row_lse[r] = lse[idx];
      row_delta[r] = delta[idx];
      if (seg != nullptr) qseg[r] = seg[static_cast<long>(b) * S + rows[r]];
    }
  }

  // Visible kv tiles, as _q_visible computes them, at this kernel's tiles.
  const int num_kv = (T + kBKV - 1) / kBKV;
  int first = 0, bound = num_kv;
  if (kind != kFull) {
    const int last = (qi + 1) * kBQ - 1;
    const int causal_bound = min(last / kBKV + 1, num_kv);
    bound = causal_bound;
    if (kind == kPrefixLM) {
      const int prefix_bound =
          (qi * kBQ < prefix) ? min((prefix + kBKV - 1) / kBKV, num_kv) : 0;
      bound = max(causal_bound, prefix_bound);
    } else if (kind == kSlidingWindow) {
      first = max((qi * kBQ - window + 1) / kBKV, 0);
    }
  }

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const long kv_stride = static_cast<long>(KH) * D;
  const __nv_bfloat16* kbase = k + static_cast<long>(b) * T * kv_stride + static_cast<long>(kh) * D;
  const __nv_bfloat16* vbase = v + static_cast<long>(b) * T * kv_stride + static_cast<long>(kh) * D;
  const int mi = lane >> 3;
  const int mr = lane & 7;

  for (int j = first; j < bound; ++j) {
    const int kv0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, kBKV>(ks, kbase, kv_stride, kv0, T);
    load_tile<D, kBKV>(vs, vbase, kv_stride, kv0, T);
    if (seg != nullptr && threadIdx.x < kBKV) {
      const int c = kv0 + threadIdx.x;
      kseg[threadIdx.x] = c < T ? seg[static_cast<long>(b) * T + c] : -1;
    }
    __syncthreads();

    // Two 32-column halves of the tile, one after the other: only 2 x 16
    // score registers are live next to the dq accumulators.
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int row = (hf * 32 + n * 8 + g) * kLds + kk * 16 + 2 * t;
          mma_bf16(s[n], qf[kk], ld32(&ks[row]), ld32(&ks[row + 8]));
          mma_bf16(dp[n], df[kk], ld32(&vs[row]), ld32(&vs[row + 8]));
        }
      }
      // dS = P * (dP - delta), P exactly 0 where masked or padded.
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int row = rows[r];
          const int cl = hf * 32 + n * 8 + 2 * t + (e & 1);
          const int col = kv0 + cl;
          bool ok = row < S && col < T && visible(row, col, kind, window, prefix);
          if (seg != nullptr) ok = ok && qseg[r] == kseg[cl];
          const float p = ok ? __expf(s[n][e] * sm_scale - row_lse[r]) : 0.f;
          s[n][e] = p * (dp[n][e] - row_delta[r]);
        }
      }
      // dq += dS K: dS re-packed as the A operand, K^T's B from ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < kND; n += 2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(
              kb, &ks[(hf * 32 + kk * 16 + (mi & 1) * 8 + mr) * kLds + n * 8 + (mi >> 1) * 8]);
          mma_bf16(acc[n], pa, kb[0], kb[1]);
          mma_bf16(acc[n + 1], pa, kb[2], kb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= S) continue;
    __nv_bfloat16* op = dq + (static_cast<long>(b) * S + row) * q_stride + static_cast<long>(h) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8 + 2 * t) = __floats2bfloat162_rn(
          acc[n][2 * r] * sm_scale, acc[n][2 * r + 1] * sm_scale);
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBKV + 2 * kBQT) * (D + 8) * 2 + 3 * kBQT * 4;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int T, int H,
                     int KH, int kind, int window, int prefix,
                     float sm_scale) {
  constexpr int kLds = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kNQ = kBQT / 8;  // n-tiles of S^T over the q tile
  // K, V tiles (resident), Q, dO tiles (per step), lse, delta, q segments.
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBKV * kLds;
  __nv_bfloat16* qs = vs + kBKV * kLds;
  __nv_bfloat16* dos = qs + kBQT * kLds;
  float* lse_s = reinterpret_cast<float*>(dos + kBQT * kLds);
  float* delta_s = lse_s + kBQT;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kBQT);

  const int j = blockIdx.x;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const int group = H / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;
  const int kv0 = j * kBKV;
  int cols[2];  // the kv rows of this thread's accumulator rows
  cols[0] = kv0 + warp * 16 + g;
  cols[1] = cols[0] + 8;

  const long kv_stride = static_cast<long>(KH) * D;
  load_tile<D, kBKV>(ks, k + static_cast<long>(b) * T * kv_stride + static_cast<long>(kh) * D,
                     kv_stride, kv0, T);
  load_tile<D, kBKV>(vs, v + static_cast<long>(b) * T * kv_stride + static_cast<long>(kh) * D,
                     kv_stride, kv0, T);
  int kseg[2] = {-1, -1};
  if (seg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (cols[r] < T) kseg[r] = seg[static_cast<long>(b) * T + cols[r]];
  }

  // Visible q tiles, as _kv_visible computes them, at this kernel's tiles.
  const int num_q = (S + kBQT - 1) / kBQT;
  int first = 0, bound = num_q;
  if (kind != kFull) {
    const int causal_first = min(kv0 / kBQT, num_q);
    first = causal_first;
    if (kind == kPrefixLM) {
      first = kv0 < prefix ? 0 : causal_first;
    } else if (kind == kSlidingWindow) {
      bound = min((kv0 + kBKV - 1 + window - 1) / kBQT + 1, num_q);
    }
  }

  float dka[kND][4], dva[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const long q_stride = static_cast<long>(H) * D;
  for (int gq = 0; gq < group; ++gq) {
    const int h = kh * group + gq;
    const __nv_bfloat16* qbase = q + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    const __nv_bfloat16* dobase = dout + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    for (int qt = first; qt < bound; ++qt) {
      const int q0 = qt * kBQT;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, kBQT>(qs, qbase, q_stride, q0, S);
      load_tile<D, kBQT>(dos, dobase, q_stride, q0, S);
      if (threadIdx.x < kBQT) {
        const int row = q0 + threadIdx.x;
        const bool in = row < S;
        const long idx = (static_cast<long>(b) * S + row) * H + h;
        lse_s[threadIdx.x] = in ? lse[idx] : 0.f;
        delta_s[threadIdx.x] = in ? delta[idx] : 0.f;
        qseg_s[threadIdx.x] =
            (in && seg != nullptr) ? seg[static_cast<long>(b) * S + row] : -1;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows = this warp's 16 kv rows.
      float st[kNQ][4], dpt[kNQ][4];
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        uint32_t ka[4], va[4];
        load_a_frag(ka, ks, kLds, warp * 16, kk * 16, g, t);
        load_a_frag(va, vs, kLds, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < kNQ; ++n) {
          const int row = (n * 8 + g) * kLds + kk * 16 + 2 * t;
          mma_bf16(st[n], ka, ld32(&qs[row]), ld32(&qs[row + 8]));
          mma_bf16(dpt[n], va, ld32(&dos[row]), ld32(&dos[row + 8]));
        }
      }
      // P^T and dS^T = P^T * (dP^T - delta), P exactly 0 where masked.
#pragma unroll
      for (int n = 0; n < kNQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = cols[r];
          const int rl = n * 8 + 2 * t + (e & 1);
          const int row = q0 + rl;
          bool ok = row < S && col < T && visible(row, col, kind, window, prefix);
          if (seg != nullptr) ok = ok && qseg_s[rl] == kseg[r];
          const float p = ok ? __expf(st[n][e] * sm_scale - lse_s[rl]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[rl]);
        }
      }
      // dv += P^T dO and dk += dS^T Q, the q rows as the k dimension.
#pragma unroll
      for (int kk = 0; kk < kBQT / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
        const int trow = (kk * 16 + (mi & 1) * 8 + mr) * kLds + (mi >> 1) * 8;
#pragma unroll
        for (int n = 0; n < kND; n += 2) {
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, &dos[trow + n * 8]);
          mma_bf16(dva[n], pa, ob[0], ob[1]);
          mma_bf16(dva[n + 1], pa, ob[2], ob[3]);
          ldmatrix_x4_trans(qb, &qs[trow + n * 8]);
          mma_bf16(dka[n], da, qb[0], qb[1]);
          mma_bf16(dka[n + 1], da, qb[2], qb[3]);
        }
      }
    }
  }

  // q carried no scale in S^T's product: dk = scale * dS^T Q.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = cols[r];
    if (col >= T) continue;
    const long off = (static_cast<long>(b) * T + col) * kv_stride + static_cast<long>(kh) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + 2 * t) = __floats2bfloat162_rn(
          dka[n][2 * r] * sm_scale, dka[n][2 * r + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               const __nv_bfloat16* dout, const float* lse, const float* delta,
               const int* seg, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int S,
               int T, int H, int KH, int kind, int window, int prefix, float sm_scale,
               cudaStream_t st) {
  // Above 48 KB of shared memory only as dynamic shared memory, after
  // raising the kernel's limit (per device; cheap to repeat).
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBKV - 1) / kBKV, B * KH);
  flash_bwd_dkv_kernel<D><<<grid, kWarps * 32, smem, st>>>(
      q, k, v, dout, lse, delta, seg, dk, dv, S, T, H, KH, kind, window, prefix,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int B, int S, int T, int H, int KH, int kind) {
  return B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || kind < 0 || kind > 3;
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok). kind: 0 causal, 1 full, 2 prefix_lm, 3 sliding_window. seg may
// be null. lse and delta are [B, S, H] fp32.
extern "C" int tpk_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg, void* dq,
                                int B, int S, int T, int H, int KH, int D,
                                int kind, int window, int prefix,
                                float sm_scale, void* stream) {
  if (bad_args(B, S, T, H, KH, kind)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* sp = static_cast<const int*>(seg);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  if (D == 128) {
    flash_bwd_dq_kernel<128><<<grid, block, 0, st>>>(qp, kp, vp, dop, lp, dp, sp, out, S,
                                                    T, H, KH, kind, window, prefix,
                                                    sm_scale);
  } else if (D == 64) {
    flash_bwd_dq_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, dop, lp, dp, sp, out, S,
                                                   T, H, KH, kind, window, prefix,
                                                   sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seg, void* dk,
                                 void* dv, int B, int S, int T, int H, int KH,
                                 int D, int kind, int window, int prefix,
                                 float sm_scale, void* stream) {
  if (bad_args(B, S, T, H, KH, kind)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* sp = static_cast<const int*>(seg);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D == 128)
    return launch_dkv<128>(qp, kp, vp, dop, lp, dp, sp, dkp, dvp, B, S, T, H, KH, kind,
                           window, prefix, sm_scale, st);
  if (D == 64)
    return launch_dkv<64>(qp, kp, vp, dop, lp, dp, sp, dkp, dvp, B, S, T, H, KH, kind,
                          window, prefix, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
