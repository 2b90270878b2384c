// The attention backward for Hopper (sm_90a): the dq and dk/dv mainloops on
// wgmma, TMA and mbarriers, built from the forward's primitives
// (attn_fwd_sm90.cuh). flash_bwd.cu gives them their walks.
//
// Replaces the tile math of the TPU kernels kubeflow_tpu/ops/
// flash_attention.py::_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel: with
// P = exp(S * scale - lse) recomputed from the forward's lse and
// dS = P * (dP - delta), dq = scale * dS K, dk = scale * dS^T Q and
// dv = P^T dO, accumulated in fp32, P and dS rounded to bf16 for their
// products.
//
// What bounds it: per visible (q, k) pair dq does three products (6*D
// flops) and dk/dv four (8*D) against 2*D bytes of K/V per kv row (dq) or
// 4*D bytes of Q/dO per q row (dk/dv) read by each 128-row job tile: far
// above the H100's ~295 flop/byte ridge, so the tensor cores bound both.
// So the design is the forward's, fitted to each pass:
//   * a persistent CTA per SM takes jobs heaviest first, in snake order
//     (fwd90::Jobs for dq: 128-row q tiles, last first; KvJobs for dk/dv:
//     128-row kv tiles, first first, the longest walks under causal);
//   * one producer warpgroup (setmaxnreg.dec) and two consumer warpgroups
//     of 64 rows (setmaxnreg.inc). The producer's thread 0 loads the job's
//     resident tiles once (dq: Q and dO; dk/dv: K and V) and streams
//     64-row tiles (dq: K and V; dk/dv: Q and dO) through a ring of
//     kStages shared-memory stages with full and empty mbarriers;
//   * every product is a wgmma over 128-byte swizzled shared memory:
//       dq:    S = Q K^T and dP = dO V^T (m64n64, both K-major), then
//              dQ += dS K (dS from registers, K read MN-major under the
//              transpose bit, as the forward reads V);
//       dk/dv: S^T = K Q^T and dP^T = V dO^T (m64n64, K-major), then
//              dV += P^T dO and dK += dS^T Q (P^T and dS^T from registers,
//              dO and Q MN-major): FlashAttention-2's transposed form, so
//              each CTA owns its dk/dv rows outright, no atomics;
//   * dq issues tile j+1's S and dP with tile j's dQ product, so dS of j+1
//     is formed while dQ accumulates (the forward's overlap). dk/dv holds
//     dK and dV (2 * D / 2 fp32 a thread) for the whole walk, so it issues
//     its two pairs of products in turn and relies on the other consumer
//     warpgroup to fill the tensor cores in between (the two take turns
//     to issue through named barriers, as in the forward);
//   * dk/dv's per-column lse and delta ([B, S, H] fp32: one head's rows
//     lie H floats apart, too narrow for a TMA box) are loaded by the
//     producer's second warp into the stage beside its Q and dO, and
//     arrive on the stage's full barrier with the copies;
//   * masks: only tiles that cross a mask edge, S or T are masked, by each
//     row's interval of visible columns (and a segment bitmask); a masked
//     entry's p is selected to exactly 0 before any product, so no exp of
//     a padded row's garbage lse reaches a sum.
//
// Layout: the JAX package's. q, dO, dq [B, S, H, D]; k, v, dk, dv
// [B, T, KH, D] (bf16); lse, delta [B, S, H] fp32. TMA's zero fill stands
// in for ragged tiles; rows past S (dq) or T (dk, dv) are never written.

#pragma once

#include "attn_fwd_sm90.cuh"

namespace bwd90 {

using fwd90::bf16;
using fwd90::kBoxCols;
using fwd90::kConsumerThreads;
using fwd90::kLog2e;
using fwd90::Visible;

constexpr int kBM = 128;   // rows of a job's resident tile (two warpgroups of 64)
static_assert(kBM == fwd90::kBM, "dq's jobs are fwd90::Jobs, whose q tiles are fwd90::kBM rows");
constexpr int kBN = 64;    // rows of a streamed tile
constexpr int kStages = 3;
// Registers a thread after setmaxnreg: producer, consumer. A launch of 384
// threads starts at 168 each; what the producer gives up (128 threads) is
// what the consumers (256) take: 128 * (168 - 40) = 256 * (232 - 168).
// (24 and 240 made dk/dv's producer spill.)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// d (+)= A B for one m64n64k16 step, A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d = A B for the first m64n64k16 step (d is write-only).
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// Issues d = A B^T over the D columns of two K-major tiles (no commit): A
// is 64 rows of a tile whose 64-column boxes are a_box bytes apart, B the
// 64 rows of a tile whose boxes are b_box bytes apart; a k-step is 32 bytes
// along the swizzled row, box kk / 4 from k-step 4 at D 128.
template <int D>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a, uint32_t a_box, uint32_t b,
                                        uint32_t b_box) {
  wgmma_ss_n64_first(d, fwd90::sw128_desc(a, 16, 1024), fwd90::sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(d, fwd90::sw128_desc(a + (kk / 4) * a_box + off, 16, 1024),
                 fwd90::sw128_desc(b + (kk / 4) * b_box + off, 16, 1024));
  }
}

// Issues acc += A B (no commit): A the 64 x 64 operand in registers (four
// k-steps of bf16 pairs), B a 64-row tile read MN-major under the transpose
// bit (16 rows = 2048 B a k-step), its 64-column boxes b_box bytes apart.
template <int D>
__device__ __forceinline__ void mma_rb(float (&acc)[D / 2], const uint32_t (&a)[kBN / 16][4],
                                       uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = fwd90::sw128_desc(b + kk * 2048, b_box, 1024);
    if constexpr (D == 128) {
      fwd90::wgmma_rs_n128_tb(acc, a[kk], db);
    } else {
      fwd90::wgmma_rs_n64_tb(acc, a[kk], db);
    }
  }
}

// A 64-column accumulator as wgmma's register A operand: k-step kk is
// columns [16kk, 16kk + 16), the accumulator's n-blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack64(const float (&s)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = fwd90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// What a tile that crosses a mask edge lets each of the thread's two
// accumulator rows see: columns [lo, hi] (walk.range, in the walk's
// absolute column numbers) made relative to the thread's first column
// col0 + 2t, and, with segment ids, one bit per score (bit 2j + e for
// column 8j + 2t + e) where the keys are equal. The segment loads run in a
// rolled loop while the products do.
template <typename Walk, typename Tile>
__device__ __forceinline__ void visible_of(const Walk& walk, const Tile& tile, int col0,
                                           const int (&rows)[2], const int (&keys)[2], int t,
                                           Visible& vis) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    walk.range(tile, rows[i], vis.lo[i], vis.hi[i]);
    vis.lo[i] -= col0 + 2 * t;
    vis.hi[i] -= col0 + 2 * t;
  }
  vis.keyed = walk.keyed();
  if (vis.keyed) {
    vis.same[0] = vis.same[1] = 0u;
#pragma unroll 1
    for (int c = 0; c < kBN / 4; ++c) {
      const int ck = walk.col_key(tile, col0 + 8 * (c >> 1) + 2 * t + (c & 1));
#pragma unroll
      for (int i = 0; i < 2; ++i) vis.same[i] |= static_cast<uint32_t>(keys[i] == ck) << c;
    }
  }
}

__device__ __forceinline__ bool sees(const Visible& vis, int i, int j, int e) {
  const int c = 8 * j + e;  // the column, less col0 + 2t
  return c >= vis.lo[i] && c <= vis.hi[i] && (!vis.keyed || ((vis.same[i] >> (2 * j + e)) & 1u));
}

// ------------------------------------------------------------------ dq

// Dynamic shared memory of the dq pass, from a 1024-byte aligned base: Q
// and dO of the job (128 rows each), then kStages of (K, V) 64-row tiles,
// then the mbarriers (q_full, q_empty, then full and empty per stage).
template <int D>
struct DqSmem {
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kQBox = kBM * 128;
  static constexpr uint32_t kTileBytes = kBN * D * 2;
  static constexpr uint32_t kKVBox = kBN * 128;
  static constexpr uint32_t kDo = kQBytes;
  static constexpr uint32_t kBars = 2 * kQBytes + kStages * 2 * kTileBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
  __device__ static uint32_t k(int st) { return 2 * kQBytes + st * 2 * kTileBytes; }
  __device__ static uint32_t v(int st) { return k(st) + kTileBytes; }
};

// dS = P * (dP - delta) on the accumulator layout (s[4j + 2i + e] is row
// rows[i], column 8j + 2t + e), with P = exp2(S * scale * log2(e) -
// lse * log2(e)), exactly 0 where the pair is not visible. s becomes dS.
__device__ __forceinline__ void dq_scores(float (&s)[kBN / 2], const float (&dp)[kBN / 2],
                                          bool masked, const Visible& vis, float scale_log2,
                                          const float (&lse2)[2], const float (&dl)[2]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = fwd90::ex2(fmaf(s[4 * j + e], scale_log2, -lse2[i]));
      if (masked) p = sees(vis, i, j, e & 1) ? p : 0.f;
      s[4 * j + e] = p * (dp[4 * j + e] - dl[i]);
    }
  }
}

// dq of every q tile of `jobs` (q, dO and dq [B, jobs.rows, H, D]), a
// persistent CTA per SM taking its jobs in turn. make_walk(qi, b) gives
// the kv tiles of q tile qi of batch row b, a walk with the interface of
// attn_fwd's (attn_fwd_sm90.cuh) over 64-row fwd90::Tiles: size(),
// tile(it), masked(tile, row_lo, row_hi), range(tile, row, lo, hi),
// keyed(), row_key(row), col_key(tile, col). lse and delta [B, rows, H].
template <int D, typename MakeWalk>
__device__ __forceinline__ void attn_bwd_dq(unsigned char* smem_raw, const CUtensorMap* qmap,
                                            const CUtensorMap* domap, const fwd90::Jobs& jobs,
                                            const MakeWalk& make_walk, const float* lse,
                                            const float* delta, bf16* dq, float scale_log2,
                                            float scale) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = DqSmem<D>;
  constexpr int kBoxes = D / kBoxCols;
  const uint32_t base = (fwd90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8u;
  auto full = [&](int st) { return q_full + 8u * (2 + st); };
  auto empty = [&](int st) { return q_full + 8u * (2 + kStages + st); };
  const int bh = jobs.B * jobs.H;
  const int group = jobs.H / jobs.KH;

  if (threadIdx.x == 0) {
    fwd90::mbar_init(q_full, 1);
    fwd90::mbar_init(q_empty, kConsumerThreads);
    for (int st = 0; st < kStages; ++st) {
      fwd90::mbar_init(full(st), 1);
      fwd90::mbar_init(empty(st), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    fwd90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;
      for (int j = 0, w; (w = jobs.job(j)) >= 0; ++j) {
        const int qi = jobs.n_q() - 1 - w / bh;
        const int b = (w % bh) / jobs.H;
        const int h = w % jobs.H;
        const auto walk = make_walk(qi, b);
        const int n = walk.size();
        fwd90::mbar_wait(q_empty, (j & 1) ^ 1);
        fwd90::mbar_expect_tx(q_full, 2 * L::kQBytes);
        for (int c = 0; c < kBoxes; ++c) {
          fwd90::tma_load(base + c * L::kQBox, qmap, q_full, c * kBoxCols, h, qi * kBM, b);
          fwd90::tma_load(base + L::kDo + c * L::kQBox, domap, q_full, c * kBoxCols, h,
                          qi * kBM, b);
        }
        for (int it = 0; it < n; ++it, ++g) {
          const int st = g % kStages;
          fwd90::mbar_wait(empty(st), ((g / kStages) & 1) ^ 1);
          const fwd90::Tile t = walk.tile(it);
          fwd90::mbar_expect_tx(full(st), 2 * L::kTileBytes);
          for (int c = 0; c < kBoxes; ++c) {
            fwd90::tma_load(base + L::k(st) + c * L::kKVBox, t.k, full(st), c * kBoxCols,
                            h / group, t.kv0, b);
            fwd90::tma_load(base + L::v(st) + c * L::kKVBox, t.v, full(st), c * kBoxCols,
                            h / group, t.kv0, b);
          }
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  // Tile it's S and dP are issued together with tile it-1's dQ product;
  // dS of tile it is formed while that product holds the tensor cores.
  fwd90::regs_inc<kConsumerRegs>();
  const int cw = __shfl_sync(0xffffffffu, (threadIdx.x - 128) >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int t = threadIdx.x & 3;
  const int row_in_tile = cw * 64 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const uint32_t q_base = base + cw * 64 * 128;  // the warpgroup's rows in each box
  const uint32_t do_base = q_base + L::kDo;
  if (cw == 1) fwd90::turn_pass(1);

  int g = 0;
  for (int j = 0, w; (w = jobs.job(j)) >= 0; ++j) {
    const int qi = jobs.n_q() - 1 - w / bh;
    const int b = (w % bh) / jobs.H;
    const int h = w % jobs.H;
    const auto walk = make_walk(qi, b);
    const int n = walk.size();
    const int row_lo = qi * kBM + cw * 64;
    const int rows[2] = {qi * kBM + row_in_tile, qi * kBM + row_in_tile + 8};
    const int keys[2] = {walk.row_key(rows[0]), walk.row_key(rows[1])};
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long at = (static_cast<long>(b) * jobs.rows + rows[i]) * jobs.H + h;
      const bool in = rows[i] < jobs.rows;
      lse2[i] = in ? lse[at] * kLog2e : 0.f;
      dl[i] = in ? delta[at] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[kBN / 2], dp[kBN / 2];
    uint32_t pa[kBN / 16][4];
    Visible vis;

    fwd90::mbar_wait(q_full, j & 1);
    if (n > 0) {
      fwd90::Tile tile = walk.tile(0);
      int st = g % kStages;
      fwd90::mbar_wait(full(st), (g / kStages) & 1);
      __syncwarp();
      fwd90::turn_wait(cw);
      fwd90::wgmma_fence();
      mma_abt<D>(s, q_base, L::kQBox, base + L::k(st), L::kKVBox);
      mma_abt<D>(dp, do_base, L::kQBox, base + L::v(st), L::kKVBox);
      fwd90::wgmma_commit();
      fwd90::turn_pass(cw);
      bool masked = walk.masked(tile, row_lo, row_lo + 63);
      if (masked) visible_of(walk, tile, tile.kv0, rows, keys, t, vis);
      fwd90::wgmma_wait<0>();
      fwd90::fence_regs(s);
      fwd90::fence_regs(dp);
      if (n == 1) fwd90::mbar_arrive(q_empty);  // Q's and dO's last reader has landed
      dq_scores(s, dp, masked, vis, scale_log2, lse2, dl);
      pack64(s, pa);
      for (int it = 1; it < n; ++it) {
        const int prev = st;
        st = (g + it) % kStages;
        tile = walk.tile(it);
        fwd90::mbar_wait(full(st), ((g + it) / kStages) & 1);
        __syncwarp();
        fwd90::turn_wait(cw);
        fwd90::fence_regs(acc);
        fwd90::wgmma_fence();
        mma_abt<D>(s, q_base, L::kQBox, base + L::k(st), L::kKVBox);
        mma_abt<D>(dp, do_base, L::kQBox, base + L::v(st), L::kKVBox);
        fwd90::wgmma_commit();
        mma_rb<D>(acc, pa, base + L::k(prev), L::kKVBox);
        fwd90::wgmma_commit();
        fwd90::turn_pass(cw);
        masked = walk.masked(tile, row_lo, row_lo + 63);
        if (masked) visible_of(walk, tile, tile.kv0, rows, keys, t, vis);
        fwd90::wgmma_wait<1>();  // S and dP have landed; dQ may still run
        fwd90::fence_regs(s);
        fwd90::fence_regs(dp);
        if (it == n - 1) fwd90::mbar_arrive(q_empty);
        dq_scores(s, dp, masked, vis, scale_log2, lse2, dl);
        fwd90::wgmma_wait<0>();
        fwd90::fence_regs(acc);
        fwd90::mbar_arrive(empty(prev));
        pack64(s, pa);
      }
      __syncwarp();
      fwd90::turn_wait(cw);
      fwd90::fence_regs(acc);
      fwd90::wgmma_fence();
      mma_rb<D>(acc, pa, base + L::k(st), L::kKVBox);
      fwd90::wgmma_commit();
      fwd90::turn_pass(cw);
      fwd90::wgmma_wait<0>();
      fwd90::fence_regs(acc);
      fwd90::mbar_arrive(empty(st));
      g += n;
    } else {
      fwd90::mbar_arrive(q_empty);
    }

    // dq = scale * acc, in 16-byte stores that drain while the next job runs.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t packed[D / 8];
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        packed[jj] = fwd90::pack_bf16(acc[4 * jj + 2 * i] * scale, acc[4 * jj + 2 * i + 1] * scale);
      const long at = (static_cast<long>(b) * jobs.rows + rows[i]) * jobs.H + h;
      fwd90::store_row<D>(packed, dq + at * D, rows[i] < jobs.rows, t);
    }
  }
}

// --------------------------------------------------------------- dk, dv

// The jobs of the dk/dv pass: the 128-row kv tiles of k and v [B, rows,
// KH, D]. Job w is kv tile w / (B * KH) of (b, kh) = divmod(w % (B * KH),
// KH): the first kv tiles, whose causal walks are the longest, first. The
// CTAs take them in snake order, as fwd90::Jobs.
struct KvJobs {
  int B, rows, KH;
  __device__ int n_kv() const { return (rows + kBM - 1) / kBM; }
  __device__ int size() const { return n_kv() * B * KH; }
  __device__ int job(int j) const {
    const int w = j * gridDim.x + ((j & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    return w < size() ? w : -1;
  }
};

// One step of a dk/dv walk: a 64-row q tile of head h from row q0, read
// from the Q and dO maps; lse and delta [B, S, H] of the same q tensor.
struct QStep {
  const CUtensorMap* q;
  const CUtensorMap* dout;
  const float* lse;
  const float* delta;
  int q0, h;
};

// Dynamic shared memory of the dk/dv pass, from a 1024-byte aligned base:
// K and V of the job (128 rows each), kStages of (Q, dO) 64-row tiles, the
// stages' lse (log2 units) and delta, then the mbarriers (kv_full,
// kv_empty, then full and empty per stage).
template <int D>
struct DkvSmem {
  static constexpr uint32_t kKBytes = kBM * D * 2;
  static constexpr uint32_t kKBox = kBM * 128;
  static constexpr uint32_t kTileBytes = kBN * D * 2;
  static constexpr uint32_t kQBox = kBN * 128;
  static constexpr uint32_t kV = kKBytes;
  static constexpr uint32_t kStats = 2 * kKBytes + kStages * 2 * kTileBytes;
  static constexpr uint32_t kBars = kStats + kStages * 2 * kBN * 4;
  static constexpr uint32_t kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
  __device__ static uint32_t q(int st) { return 2 * kKBytes + st * 2 * kTileBytes; }
  __device__ static uint32_t dout(int st) { return q(st) + kTileBytes; }
  __device__ static uint32_t lse(int st) { return kStats + st * 2 * kBN * 4; }
  __device__ static uint32_t delta(int st) { return lse(st) + kBN * 4; }
};

// P^T and dS^T = P^T * (dP^T - delta) on the accumulator layout (st[4j +
// 2i + e] is kv row rows[i], q column 8j + 2t + e of the step), with the
// columns' lse (log2 units) and delta from shared memory; p is exactly 0
// where the pair is not visible. st becomes P^T, dpt dS^T.
__device__ __forceinline__ void dkv_scores(float (&st)[kBN / 2], float (&dpt)[kBN / 2],
                                           bool masked, const Visible& vis, float scale_log2,
                                           const float* lse2, const float* dl, int t) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool odd = e & 1;
      float p = fwd90::ex2(fmaf(st[4 * j + e], scale_log2, -(odd ? l.y : l.x)));
      if (masked) p = sees(vis, e >> 1, j, odd) ? p : 0.f;
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - (odd ? d.y : d.x));
    }
  }
}

// dk and dv of every kv tile of `jobs` (k, v, dk, dv [B, jobs.rows, KH,
// D]), a persistent CTA per SM taking its jobs in turn. make_walk(kt, b,
// kh) gives the q tiles that see kv tile kt of (b, kh), over every q head
// of the GQA group: size(), QStep step(it), masked(step, kv_lo, kv_hi),
// range(step, kv_row, lo, hi) (the q rows [lo, hi] that see the kv row),
// keyed(), row_key(kv_row), col_key(step, q_row). S is the q rows of the
// maps and H their heads (for lse and delta).
template <int D, typename MakeWalk>
__device__ __forceinline__ void attn_bwd_dkv(unsigned char* smem_raw, const CUtensorMap* kmap,
                                             const CUtensorMap* vmap, const KvJobs& jobs,
                                             const MakeWalk& make_walk, int S, int H, bf16* dk,
                                             bf16* dv, float scale_log2, float scale) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = DkvSmem<D>;
  constexpr int kBoxes = D / kBoxCols;
  unsigned char* aligned = smem_raw + (((fwd90::smem_u32(smem_raw) + 1023u) & ~1023u) -
                                       fwd90::smem_u32(smem_raw));
  const uint32_t base = fwd90::smem_u32(aligned);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t kv_empty = kv_full + 8u;
  auto full = [&](int st) { return kv_full + 8u * (2 + st); };
  auto empty = [&](int st) { return kv_full + 8u * (2 + kStages + st); };
  auto lse_at = [&](int st) { return reinterpret_cast<float*>(aligned + L::lse(st)); };
  auto delta_at = [&](int st) { return reinterpret_cast<float*>(aligned + L::delta(st)); };
  const int bkh = jobs.B * jobs.KH;

  if (threadIdx.x == 0) {
    fwd90::mbar_init(kv_full, 1);
    fwd90::mbar_init(kv_empty, kConsumerThreads);
    for (int st = 0; st < kStages; ++st) {
      fwd90::mbar_init(full(st), 1 + 32);  // the copies' arrival, warp 1's lanes
      fwd90::mbar_init(empty(st), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    // Thread 0 issues the copies; warp 1 loads each step's lse and delta.
    fwd90::regs_dec<kProducerRegs>();
    const int lane = threadIdx.x & 31;
    const int pwarp = threadIdx.x >> 5;
    if ((pwarp == 0 && lane == 0) || pwarp == 1) {
      int g = 0;
      for (int j = 0, w; (w = jobs.job(j)) >= 0; ++j) {
        const int kt = w / bkh;
        const int b = (w % bkh) / jobs.KH;
        const int kh = w % jobs.KH;
        const auto walk = make_walk(kt, b, kh);
        const int n = walk.size();
        if (pwarp == 0) {
          fwd90::mbar_wait(kv_empty, (j & 1) ^ 1);
          fwd90::mbar_expect_tx(kv_full, 2 * L::kKBytes);
          for (int c = 0; c < kBoxes; ++c) {
            fwd90::tma_load(base + c * L::kKBox, kmap, kv_full, c * kBoxCols, kh, kt * kBM, b);
            fwd90::tma_load(base + L::kV + c * L::kKBox, vmap, kv_full, c * kBoxCols, kh,
                            kt * kBM, b);
          }
        }
        for (int it = 0; it < n; ++it, ++g) {
          const int st = g % kStages;
          fwd90::mbar_wait(empty(st), ((g / kStages) & 1) ^ 1);
          const QStep sp = walk.step(it);
          if (pwarp == 0) {
            fwd90::mbar_expect_tx(full(st), 2 * L::kTileBytes);
            for (int c = 0; c < kBoxes; ++c) {
              fwd90::tma_load(base + L::q(st) + c * L::kQBox, sp.q, full(st), c * kBoxCols,
                              sp.h, sp.q0, b);
              fwd90::tma_load(base + L::dout(st) + c * L::kQBox, sp.dout, full(st),
                              c * kBoxCols, sp.h, sp.q0, b);
            }
          } else {
            for (int r = lane; r < kBN; r += 32) {
              const int row = sp.q0 + r;
              const long at = (static_cast<long>(b) * S + row) * H + sp.h;
              const bool in = row < S;
              lse_at(st)[r] = in ? sp.lse[at] * kLog2e : 0.f;
              delta_at(st)[r] = in ? sp.delta[at] : 0.f;
            }
            fwd90::mbar_arrive(full(st));
          }
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  // Each step: S^T and dP^T in one turn, P^T and dS^T in registers, then
  // dV += P^T dO and dK += dS^T Q in the next; the other warpgroup's
  // products fill the tensor cores in between.
  fwd90::regs_inc<kConsumerRegs>();
  const int cw = __shfl_sync(0xffffffffu, (threadIdx.x - 128) >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int t = threadIdx.x & 3;
  const int row_in_tile = cw * 64 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const uint32_t k_base = base + cw * 64 * 128;  // the warpgroup's rows in each box
  const uint32_t v_base = k_base + L::kV;
  if (cw == 1) fwd90::turn_pass(1);

  int g = 0;
  for (int j = 0, w; (w = jobs.job(j)) >= 0; ++j) {
    const int kt = w / bkh;
    const int b = (w % bkh) / jobs.KH;
    const int kh = w % jobs.KH;
    const auto walk = make_walk(kt, b, kh);
    const int n = walk.size();
    const int row_lo = kt * kBM + cw * 64;
    const int rows[2] = {kt * kBM + row_in_tile, kt * kBM + row_in_tile + 8};
    const int keys[2] = {walk.row_key(rows[0]), walk.row_key(rows[1])};

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    fwd90::mbar_wait(kv_full, j & 1);
    if (n == 0) fwd90::mbar_arrive(kv_empty);
    for (int it = 0; it < n; ++it) {
      const int st = (g + it) % kStages;
      const QStep sp = walk.step(it);
      float sa[kBN / 2], dpa[kBN / 2];
      fwd90::mbar_wait(full(st), ((g + it) / kStages) & 1);
      __syncwarp();
      fwd90::turn_wait(cw);
      fwd90::wgmma_fence();
      mma_abt<D>(sa, k_base, L::kKBox, base + L::q(st), L::kQBox);
      mma_abt<D>(dpa, v_base, L::kKBox, base + L::dout(st), L::kQBox);
      fwd90::wgmma_commit();
      fwd90::turn_pass(cw);
      Visible vis;
      const bool masked = walk.masked(sp, row_lo, row_lo + 63);
      if (masked) visible_of(walk, sp, sp.q0, rows, keys, t, vis);
      fwd90::wgmma_wait<0>();
      fwd90::fence_regs(sa);
      fwd90::fence_regs(dpa);
      if (it == n - 1) fwd90::mbar_arrive(kv_empty);  // K's and V's last reader has landed
      dkv_scores(sa, dpa, masked, vis, scale_log2, lse_at(st), delta_at(st), t);
      uint32_t pp[kBN / 16][4], pd[kBN / 16][4];
      pack64(sa, pp);
      pack64(dpa, pd);
      __syncwarp();
      fwd90::turn_wait(cw);
      fwd90::fence_regs(dva);
      fwd90::fence_regs(dka);
      fwd90::wgmma_fence();
      mma_rb<D>(dva, pp, base + L::dout(st), L::kQBox);
      mma_rb<D>(dka, pd, base + L::q(st), L::kQBox);
      fwd90::wgmma_commit();
      fwd90::turn_pass(cw);
      fwd90::wgmma_wait<0>();
      fwd90::fence_regs(dva);
      fwd90::fence_regs(dka);
      fwd90::mbar_arrive(empty(st));
    }
    g += n;

    // dk = scale * dS^T Q (Q carried no scale), dv = P^T dO.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long at = (static_cast<long>(b) * jobs.rows + rows[i]) * jobs.KH + kh;
      const bool keep = rows[i] < jobs.rows;
      uint32_t packed[D / 8];
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        packed[jj] = fwd90::pack_bf16(dka[4 * jj + 2 * i] * scale, dka[4 * jj + 2 * i + 1] * scale);
      fwd90::store_row<D>(packed, dk + at * D, keep, t);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        packed[jj] = fwd90::pack_bf16(dva[4 * jj + 2 * i], dva[4 * jj + 2 * i + 1]);
      fwd90::store_row<D>(packed, dv + at * D, keep, t);
    }
  }
}

}  // namespace bwd90
