// Tile math of the ring attention backward kernels (rdma_ring.cu): bf16
// tensor-core products with mma.sync m16n8k16, fp32 accumulation, P and dS
// rounded to bf16 for their products. (The forward kernels run
// attn_fwd_sm90.cuh, the flash backward attn_bwd_sm90.cuh.)
//
// Each kernel runs 4 warps; a warp owns 16 rows of its CTA's 64-row tile.
// The per-tile functions below take a `visible(r, c)` predicate: r indexes
// the thread's two accumulator rows (g and g + 8 of the warp's 16), c a
// column of the tile; it folds in the kernel's mask and its ragged edges.
// Masked entries get p = 0 exactly (a select, never a product with exp of
// garbage).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;  // 16 rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;    // dq: q rows per CTA
constexpr int kBKV = 64;   // dq: kv rows per tile; dk/dv: per CTA
constexpr int kBQT = 32;   // dk/dv: q rows per tile of its walk

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
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
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const bf16* tile,
                                            int lds, int row0, int col0, int g,
                                            int t) {
  const bf16* p = tile + (row0 + g) * lds + col0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * lds);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * lds + 8);
}

// Two fp32 accumulator n-tiles (c0 | c1) packed as one bf16 A fragment.
__device__ __forceinline__ void pack_a_frag(uint32_t a[4], const float c0[4],
                                            const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Asynchronous 16- and 4-byte copies into shared memory; an invalid one
// zero-fills (source size 0, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most kPending of this thread's newest groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Rows [row0, row0 + ROWS) of a [*, D] slab with row stride `stride` into a
// padded shared tile (row stride D + 8), zero-filling rows at or past
// `limit`: with plain loads, or with cp.async (the caller commits).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int row0, int limit) {
  constexpr int kLds = D + 8;
  constexpr int kChunks = ROWS * D / 8;  // 16-byte pieces
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long stride, int row0,
                                                int limit) {
  constexpr int kLds = D + 8;
  constexpr int kChunks = ROWS * D / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * kLds + col, ok ? src + (row0 + r) * stride + col : src, ok);
  }
}

// The thread's fragments (A layout) of rows `rows` of a [*, D] slab with row
// stride `stride`, read from global; rows at or past `limit` are zeros.
template <int D>
__device__ __forceinline__ void load_row_frags(uint32_t (&f)[D / 16][4],
                                               const bf16* base, long stride,
                                               const int (&rows)[2], int limit) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        f[kk][half * 2 + r] =
            rows[r] < limit ? ld32(base + rows[r] * stride + kk * 16 + half * 8 + 2 * t)
                            : 0u;
      }
    }
  }
}

// Writes the thread's accumulator rows (times `scale`) as bf16 into a
// [*, D] slab with row stride `stride`; rows at or past `limit` are skipped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], bf16* base,
                                           long stride, const int (&rows)[2],
                                           int limit, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= limit) continue;
    bf16* p = base + rows[r] * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(p + n * 8 + 2 * t) = __floats2bfloat162_rn(
          acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// One 64-row kv tile of dq for the warp's 16 q rows (fragments qf, df and
// the rows' lse and delta): S = Q K^T and dP = dO V^T, dS = P * (dP - delta)
// with P = exp(S * scale - lse), then dq += dS K (the scale is applied by
// the caller at the end). The tile goes in two 32-column halves, one after
// the other, so only 2 x 16 score registers are live beside the dq
// accumulators.
template <int D, typename Visible>
__device__ __forceinline__ void dq_tile(const uint32_t (&qf)[D / 16][4],
                                        const uint32_t (&df)[D / 16][4],
                                        const bf16* ks, const bf16* vs,
                                        float (&acc)[D / 8][4],
                                        const float (&row_lse)[2],
                                        const float (&row_delta)[2],
                                        float sm_scale, Visible visible) {
  constexpr int kLds = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;
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
        const float p = visible(r, hf * 32 + n * 8 + 2 * t + (e & 1))
                            ? __expf(s[n][e] * sm_scale - row_lse[r])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - row_delta[r]);
      }
    }
    // dq += dS K: dS re-packed as the A operand, K^T's B from ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      pack_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
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

// One 32-row q tile of dk/dv for the warp's 16 kv rows of the CTA's
// resident K and V tiles, in the transposed formulation (rows = kv rows,
// FlashAttention-2's layout, so P and dS land in the A-operand layout and
// no atomics are needed): S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T *
// scale - lse), dS^T = P^T * (dP^T - delta), then dv += P^T dO and dk +=
// dS^T Q (the scale is applied by the caller at the end). qs, dos: the q
// tile's Q and dO in shared memory; lse_s, delta_s: its rows' stats.
template <int D, typename Visible>
__device__ __forceinline__ void dkv_tile(const bf16* ks, const bf16* vs,
                                         const bf16* qs, const bf16* dos,
                                         const float* lse_s, const float* delta_s,
                                         float (&dka)[D / 8][4],
                                         float (&dva)[D / 8][4], float sm_scale,
                                         Visible visible) {
  constexpr int kLds = D + 8;
  constexpr int kKD = D / 16;
  constexpr int kND = D / 8;
  constexpr int kNQ = kBQT / 8;  // n-tiles of S^T over the q tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;

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
      const int rl = n * 8 + 2 * t + (e & 1);
      const float p = visible(e >> 1, rl) ? __expf(st[n][e] * sm_scale - lse_s[rl]) : 0.f;
      st[n][e] = p;
      dpt[n][e] = p * (dpt[n][e] - delta_s[rl]);
    }
  }
  // dv += P^T dO and dk += dS^T Q, the q rows as the k dimension.
#pragma unroll
  for (int kk = 0; kk < kBQT / 16; ++kk) {
    uint32_t pa[4], da[4];
    pack_a_frag(pa, st[2 * kk], st[2 * kk + 1]);
    pack_a_frag(da, dpt[2 * kk], dpt[2 * kk + 1]);
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

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

}  // namespace tiles
