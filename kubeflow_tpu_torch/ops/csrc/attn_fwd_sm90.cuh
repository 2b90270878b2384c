// The attention forward for Hopper (sm_90a): one warp-specialised mainloop
// on wgmma, TMA and mbarriers, shared by flash_fwd.cu and the forward of
// rdma_ring.cu, which differ only in the kv tiles they walk. Its primitives
// (the PTX wrappers, the TMA maps, the launch) also build the backward's
// mainloops in attn_bwd_sm90.cuh.
//
// Replaces the tile math of two TPU kernels: kubeflow_tpu/ops/
// flash_attention.py::_flash_fwd_kernel and kubeflow_tpu/ops/
// rdma_ring_attention.py::_rdma_kernel (blockwise online softmax with fp32
// accumulators, the finite -1e30 mask, out = acc / max(l, 1e-30) and lse =
// m + log(max(l, 1e-30)) per row).
//
// What bounds it: per visible (q, k) pair the two products do 4*D flops
// against 2*D bytes of K/V per kv row read by a 128-row q tile, ~256
// flop/byte at D 128 and more as long kv walks amortise the q tile's own
// bytes: at or above the H100's ~295 flop/byte ridge, so the tensor cores
// bound it, and short walks (S 1024) sit near both bounds. So the design
// keeps the tensor cores fed and the copies out of their way:
//   * a persistent CTA per SM takes q tiles (jobs) heaviest first, in
//     snake order, so one job's stores and the next one's copies overlap;
//   * the CTA is one producer warpgroup and two consumer warpgroups. The
//     producer gives its registers away (setmaxnreg.dec) and one of its
//     threads issues TMA copies: each job's Q, then K and V tiles of 128 kv
//     rows through a ring of kStages shared-memory stages with full and
//     empty mbarriers, running ahead of the math without any CTA barrier;
//   * each consumer warpgroup owns 64 q rows (setmaxnreg.inc to 232) and
//     runs S = Q K^T as wgmma m64n128k16 with both operands in 128-byte
//     swizzled shared memory (K as it lies, K-major), the online softmax in
//     registers on the accumulator layout (exp2 with scale * log2(e)
//     folded into one FMA), then O += P V as wgmma with P packed to bf16 in
//     registers and V read MN-major from shared memory (the transpose bit);
//   * tile j+1's S is issued together with tile j's P V, so the softmax of
//     j+1 runs under P V; the two warpgroups take turns to issue (named
//     barriers), so one's softmax runs under the other's products;
//   * only tiles that cross a mask edge or T are masked, by each row's
//     interval of visible columns (two compares a score; segment ids add a
//     bitmask built while the products run);
//   * the output rows are transposed across each quad of threads and
//     leave in 16-byte stores, every 32-byte sector written in full.
//
// Layout: the JAX package's. q and o [B, S, H, D], k and v [B, T, KH, D]
// (bf16), lse [B, S, H] fp32. The TMA maps are 4-D over (D, heads, rows, B)
// with 64-column boxes (128 B, one swizzle row); a D-128 row is two boxes.
// TMA's out-of-bounds zero fill stands in for ragged tiles past S or T: the
// host pads nothing, and rows past S are never written.
//
// Numerics: scores fp32; the running max m is kept in log2 units (scores
// times scale * log2(e)); P is rounded to bf16 for P V, the row sum l is
// taken from the fp32 P before that rounding.

#pragma once

#include <atomic>

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fwd90 {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;       // q rows per CTA: two consumer warpgroups of 64
constexpr int kBN = 128;       // kv rows per tile
constexpr int kStages = 3;     // K/V tiles in flight
constexpr int kThreads = 384;  // the producer warpgroup, then two consumers
constexpr int kConsumerThreads = 256;
constexpr int kBoxCols = 64;   // one TMA box: 64 bf16 = 128 B, one swizzle row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory, from a 1024-byte aligned base (128-byte swizzle
// repeats every 1024 B, and wgmma's descriptors assume tiles on that
// grid): Q, then kStages of (K, V), then the mbarriers. Each tile is
// D / 64 boxes of [rows][64] bf16, 128-byte swizzled.
template <int D>
struct Smem {
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr uint32_t kQBox = kBM * 128;         // bytes of one Q box
  static constexpr uint32_t kKVBox = kBN * 128;
  static constexpr uint32_t kBars = kQBytes + kStages * 2 * kTileBytes;
  // q_full, q_empty, then k_full, v_full and empty for each stage.
  static constexpr uint32_t kBytes = kBars + 8 * (2 + 3 * kStages) + 1024;
  __device__ static uint32_t k(int st) { return kQBytes + st * 2 * kTileBytes; }
  __device__ static uint32_t v(int st) { return k(st) + kTileBytes; }
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Spins until the barrier's phase of the given parity has completed. (A
// timeout that traps here costs the consumers their overlap: ptxas then
// serialises the wgmmas and spills.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// A shared-memory matrix descriptor for a 128-byte swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B) in bits 62-63. K-major tiles (Q, K) use only the stride
// offset, 1024 B between groups of 8 rows; the MN-major V uses the leading
// offset too, the distance between its 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (+)= A B for one m64n128k16 step, A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = A B for the first m64n128k16 step: d is write-only, so what it held
// before is dead from here on.
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// d += A B for one m64n128k16 step, A from registers (four bf16 pairs a
// thread), B from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for one m64n64k16 step, A from registers (four bf16 pairs a
// thread), B from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// 2^x on the special-function unit (denormal results flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- mainloop

// One kv tile of a walk: the K and V tensor maps it is read from, its
// first kv row there, and whether it is the ring's diagonal shard.
struct Tile {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int kv0;
  bool diag;
};

// The consumer warpgroups take turns to issue their products (named
// barriers 1 and 2; 0 is __syncthreads): one's softmax then runs while the
// other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + cw), "n"(kConsumerThreads));
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(2 - cw), "n"(kConsumerThreads));
}

// Issues S = Q K^T for the warpgroup's 64 rows (one commit group): D / 16
// k-steps; box c holds columns [64c, 64c + 64), a k-step is 32 bytes along
// the swizzled row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t q, uint32_t k) {
  wgmma_fence();
  wgmma_ss_n128_first(s, sw128_desc(q, 16, 1024), sw128_desc(k, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q + (kk / 4) * Smem<D>::kQBox + off, 16, 1024),
                  sw128_desc(k + (kk / 4) * Smem<D>::kKVBox + off, 16, 1024), 1);
  }
  wgmma_commit();
}

// Issues O += P V (one commit group): V's rows are the k dimension (16
// rows = 2048 B a k-step), its 64-column boxes the leading-offset steps of N.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBN / 16][4], uint32_t v) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = sw128_desc(v + kk * 2048, Smem<D>::kKVBox, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128_tb(acc, pa[kk], db);
    } else {
      wgmma_rs_n64_tb(acc, pa[kk], db);
    }
  }
  wgmma_commit();
}

// Which of the thread's 2 x 32 scores of a tile have equal segment keys,
// one bit each: bit 2j + e of same[i] for row rows[i], column 8j + 2t + e.
// A rolled loop keeps the segment-id loads out of the score registers; it
// runs while the products do.
template <typename Walk>
__device__ __forceinline__ void same_keys(const Walk& walk, const Tile& tile,
                                          const int (&keys)[2], int t, uint32_t (&same)[2]) {
  same[0] = same[1] = 0u;
#pragma unroll 1
  for (int c = 0; c < kBN / 4; ++c) {
    const int ck = walk.col_key(tile, tile.kv0 + 8 * (c >> 1) + 2 * t + (c & 1));
#pragma unroll
    for (int i = 0; i < 2; ++i) same[i] |= static_cast<uint32_t>(keys[i] == ck) << c;
  }
}

// What a tile that crosses a mask edge lets each of the thread's two rows
// see: the columns [lo, hi] of the mask kind (an interval for every kind),
// relative to the thread's first column kv0 + 2t, and the segment bits.
struct Visible {
  int lo[2], hi[2];
  uint32_t same[2];
  bool keyed;
};

template <typename Walk>
__device__ __forceinline__ void visible_of(const Walk& walk, const Tile& tile,
                                           const int (&rows)[2], const int (&keys)[2],
                                           int t, Visible& vis) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    walk.range(tile, rows[i], vis.lo[i], vis.hi[i]);
    vis.lo[i] -= tile.kv0 + 2 * t;
    vis.hi[i] -= tile.kv0 + 2 * t;
  }
  vis.keyed = walk.keyed();
  if (vis.keyed) same_keys(walk, tile, keys, t, vis.same);
}

// The online-softmax update on the accumulator layout (s[4j + 2i + e] is
// row rows[i], column 8j + 2t + e): scores become p = exp2(score * scale *
// log2(e) - m), one FMA and one exp2 each, m and the thread's share of l
// move on, alpha = exp2(m_old - m_new) rescales what O holds.
__device__ __forceinline__ void online_softmax(float (&s)[kBN / 2], bool masked,
                                               const Visible& vis, float scale_log2,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2];
  if (masked) {  // masked tiles carry the scaled score from here on
    mx[0] = mx[1] = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = 8 * j + (e & 1);  // the column, less kv0 + 2t
        const bool ok = c >= vis.lo[i] && c <= vis.hi[i] &&
                        (!vis.keyed || ((vis.same[i] >> (2 * j + (e & 1))) & 1u));
        float& x = s[4 * j + e];
        x = ok ? x * scale_log2 : kNegInf;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  } else {
    mx[0] = mx[1] = -3.0e38f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], masked ? mx[i] : mx[i] * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    neg_m[i] = -m_new;
    m[i] = m_new;
  }
  const float mul = masked ? 1.f : scale_log2;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], mul, neg_m[e >> 1]));
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// P as wgmma's register A operand: k-step kk is columns [16kk, 16kk + 16),
// the accumulator's n-blocks 2kk and 2kk + 1 (the layout of 16-bit A).
__device__ __forceinline__ void pack_p(const float (&s)[kBN / 2],
                                       uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// One output row from the accumulator layout, where thread t of a quad
// holds columns 8j + 2t, 8j + 2t + 1 (one packed bf16 pair) of every 8-column
// block j. Each group of four blocks is transposed across the quad (two
// xor shuffles) so that thread t writes block 4k + t whole: 16-byte stores,
// every 32-byte sector written in full. All lanes shuffle; only `keep`
// rows store.
template <int D>
__device__ __forceinline__ void store_row(const uint32_t (&v)[D / 8], bf16* row, bool keep,
                                          int t) {
  const bool hi = t & 2, lo = t & 1;
#pragma unroll
  for (int k = 0; k < D / 32; ++k) {
    const uint32_t* w = v + 4 * k;
    // Swap halves with thread t ^ 2: keep the two blocks of t's half
    // (own: this thread's pieces, rcv: t ^ 2's).
    const uint32_t own0 = hi ? w[2] : w[0], own1 = hi ? w[3] : w[1];
    const uint32_t rcv0 = __shfl_xor_sync(0xffffffffu, hi ? w[0] : w[2], 2);
    const uint32_t rcv1 = __shfl_xor_sync(0xffffffffu, hi ? w[1] : w[3], 2);
    // Swap with thread t ^ 1: keep block t's pieces of this thread and of
    // t ^ 2, take those of t ^ 1 and t ^ 3.
    const uint32_t p_t = lo ? own1 : own0;   // from thread t
    const uint32_t p_t2 = lo ? rcv1 : rcv0;  // from thread t ^ 2
    const uint32_t p_t1 = __shfl_xor_sync(0xffffffffu, lo ? own0 : own1, 1);
    const uint32_t p_t3 = __shfl_xor_sync(0xffffffffu, lo ? rcv0 : rcv1, 1);
    uint32_t word[4];
#pragma unroll
    for (int src = 0; src < 4; ++src) {
      const int d = src ^ t;
      word[src] = d == 0 ? p_t : d == 1 ? p_t1 : d == 2 ? p_t2 : p_t3;
    }
    if (keep)
      *reinterpret_cast<uint4*>(row + 8 * (4 * k + t)) =
          make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// The shape of one launch: q (and o) [B, rows, H, D], kv heads KH; its q
// tiles are the jobs. Job w is q tile n_q - 1 - w / (B * H) of (b, h) =
// divmod(w % (B * H), H): the tiles with the longest causal walks first.
// The persistent CTAs take them in rounds of gridDim.x, in snake order (CTA
// c takes job c of even rounds and gridDim.x - 1 - c of odd ones), so that
// no CTA is dealt the heaviest job of every round.
struct Jobs {
  int B, rows, H, KH;
  __device__ int n_q() const { return (rows + kBM - 1) / kBM; }
  __device__ int size() const { return n_q() * B * H; }
  // The job of this CTA's round j, or -1 past the last.
  __device__ int job(int j) const {
    const int w = j * gridDim.x + ((j & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    return w < size() ? w : -1;
  }
};

// The forward of every q tile of `jobs`, a persistent CTA per SM taking its
// jobs in turn, so that one job's last P V and epilogue overlap the next
// job's Q and K/V copies. make_walk(qi, b) gives the kv tiles of q tile qi
// of batch row b, a walk that provides
//   int size(): the number of tiles;
//   Tile tile(int it): tile `it` of the walk;
//   bool masked(const Tile&, int row_lo, int row_hi): whether some pair of
//     rows [row_lo, row_hi] x the tile's columns is not visible;
//   void range(const Tile&, int row, int& lo, int& hi): the columns [lo,
//     hi] the row sees under the mask kind and the ragged edge;
//   bool keyed(), int row_key(int row), int col_key(const Tile&, int col):
//     whether segment ids confine the row further (then a pair attends only
//     where the keys are equal), and the keys.
// o [B, rows, H, D] and lse [B, rows, H]; rows past `rows` are not written.
template <int D, typename MakeWalk>
__device__ __forceinline__ void attn_fwd(unsigned char* smem_raw, const CUtensorMap* qmap,
                                         const Jobs& jobs, const MakeWalk& make_walk,
                                         bf16* o, float* lse, float scale_log2) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = Smem<D>;
  constexpr int kBoxes = D / kBoxCols;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // q_full, q_empty, then k_full, v_full and empty for each stage.
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8u;
  auto k_full = [&](int st) { return q_full + 8u * (2 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (2 + kStages + st); };
  auto empty = [&](int st) { return q_full + 8u * (2 + 2 * kStages + st); };
  const int bh = jobs.B * jobs.H;
  const int group = jobs.H / jobs.KH;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    // Q of the next job as soon as the consumers' last Q K^T of this one
    // has landed; K/V tiles whenever a stage is free. The stage ring runs on
    // across jobs (g counts every tile this CTA loads).
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int g = 0;
      for (int j = 0, w; (w = jobs.job(j)) >= 0; ++j) {
        const int qi = jobs.n_q() - 1 - w / bh;
        const int b = (w % bh) / jobs.H;
        const int h = w % jobs.H;
        const auto walk = make_walk(qi, b);
        const int n = walk.size();
        mbar_wait(q_empty, (j & 1) ^ 1);  // the first job's passes at once
        mbar_expect_tx(q_full, L::kQBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + c * L::kQBox, qmap, q_full, c * kBoxCols, h, qi * kBM, b);
        for (int it = 0; it < n; ++it, ++g) {
          const int st = g % kStages;
          mbar_wait(empty(st), ((g / kStages) & 1) ^ 1);  // round 0 passes at once
          const Tile t = walk.tile(it);
          mbar_expect_tx(k_full(st), L::kTileBytes);
          for (int c = 0; c < kBoxes; ++c)
            tma_load(base + L::k(st) + c * L::kKVBox, t.k, k_full(st), c * kBoxCols,
                     h / group, t.kv0, b);
          mbar_expect_tx(v_full(st), L::kTileBytes);
          for (int c = 0; c < kBoxes; ++c)
            tma_load(base + L::v(st) + c * L::kKVBox, t.v, v_full(st), c * kBoxCols,
                     h / group, t.kv0, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  // Tile it's S = Q K^T is issued together with tile it-1's O += P V; the
  // softmax of tile it runs while P V still holds the tensor cores, and O
  // is rescaled once P V has landed.
  regs_inc<232>();
  // The consumer warpgroup (64 rows each), made warp-uniform for the compiler.
  const int cw = __shfl_sync(0xffffffffu, (threadIdx.x - 128) >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int t = threadIdx.x & 3;  // accumulator column pair
  const int row_in_tile = cw * 64 + warp * 16 + ((threadIdx.x & 31) >> 2);
  const uint32_t q_base = base + cw * 64 * 128;  // the warpgroup's rows in each box
  if (cw == 1) turn_pass(1);  // the first turn is warpgroup 0's

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

    float acc[D / 2];
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sum
    float alpha[2];
    Visible vis;
    uint32_t pa[kBN / 16][4];

    mbar_wait(q_full, j & 1);
    if (n > 0) {
      Tile tile = walk.tile(0);
      mbar_wait(k_full(g % kStages), (g / kStages) & 1);
      __syncwarp();
      turn_wait(cw);
      issue_qk<D>(s, q_base, base + L::k(g % kStages));
      turn_pass(cw);
      bool masked = walk.masked(tile, row_lo, row_lo + 63);
      if (masked) visible_of(walk, tile, rows, keys, t, vis);
      wgmma_wait<0>();
      fence_regs(s);
      if (n == 1) mbar_arrive(q_empty);  // Q's last reader has landed
      online_softmax(s, masked, vis, scale_log2, m, l, alpha);  // O is still 0
      pack_p(s, pa);
      for (int it = 1; it < n; ++it) {
        const int st = (g + it) % kStages;
        const int prev = (g + it - 1) % kStages;
        tile = walk.tile(it);
        mbar_wait(k_full(st), ((g + it) / kStages) & 1);
        mbar_wait(v_full(prev), ((g + it - 1) / kStages) & 1);
        __syncwarp();
        turn_wait(cw);
        issue_qk<D>(s, q_base, base + L::k(st));
        issue_pv<D>(acc, pa, base + L::v(prev));
        turn_pass(cw);
        masked = walk.masked(tile, row_lo, row_lo + 63);
        if (masked) visible_of(walk, tile, rows, keys, t, vis);
        wgmma_wait<1>();  // S has landed; P V may still run
        fence_regs(s);
        if (it == n - 1) mbar_arrive(q_empty);
        online_softmax(s, masked, vis, scale_log2, m, l, alpha);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty(prev));
        rescale(acc, alpha);
        pack_p(s, pa);
      }
      const int last = (g + n - 1) % kStages;
      mbar_wait(v_full(last), ((g + n - 1) / kStages) & 1);
      __syncwarp();
      turn_wait(cw);
      issue_pv<D>(acc, pa, base + L::v(last));
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(last));
      g += n;
    } else {
      mbar_arrive(q_empty);
    }

    // out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)) (m back in
    // natural units; a row that saw nothing keeps the -1e30 of the
    // reference), in 16-byte stores that drain while the next job runs.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lc = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lc;
      uint32_t packed[D / 8];
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        packed[jj] = pack_bf16(acc[4 * jj + 2 * i] * inv, acc[4 * jj + 2 * i + 1] * inv);
      const long at = (static_cast<long>(b) * jobs.rows + rows[i]) * jobs.H + h;
      store_row<D>(packed, o + at * D, rows[i] < jobs.rows, t);
      if (t == 0 && rows[i] < jobs.rows)
        lse[at] = (m[i] == kNegInf ? kNegInf : m[i] * kLn2) + logf(lc);
    }
  }
}

// ---------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPointByVersion (CUDA 12.5+), so that the library needs
// no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a contiguous bf16 [B, rows, heads, D] tensor: dims (D, heads,
// rows, B), boxes of (64, 1, box_rows, 1), 128-byte swizzle, zero fill out
// of bounds. False if it cannot be encoded (an address not 16-byte aligned).
inline bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
                        int D, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row_bytes,
                                 row_bytes * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBoxCols), 1u,
                             static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;  // devices whose set-up a launch caches

// Launches kKernel with kSmem bytes of dynamic shared memory and one CTA of
// 384 threads per SM (fewer if there are fewer jobs); returns the launch's
// error. The first launch on a device reads its SM count and raises the
// kernel's dynamic shared-memory limit there; later ones reuse both, so a
// launch costs the host one cudaGetDevice besides the launch itself. Each
// kernel is its own instantiation, so each keeps its own record.
template <auto kKernel, int kSmem, typename Params>
int launch(const Params& p, int jobs, cudaStream_t stream) {
  static std::atomic<int> sms_ready[kMaxDevices];  // 0 until set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = dev < kMaxDevices ? sms_ready[dev].load(std::memory_order_acquire) : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) sms_ready[dev].store(sms, std::memory_order_release);
  }
  kKernel<<<jobs < sms ? jobs : sms, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd90
