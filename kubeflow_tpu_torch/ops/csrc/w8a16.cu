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
// 4096 unembedding. At 128 rows the weight bytes still bound it; from 512
// rows the bf16 tensor cores (989 TFLOP/s) do. Three kernels, chosen by the
// wrapper from the shape (_w8a16_plan in ops/w8a16.py), never by this file:
//
//   * w8a16_decode_kernel (M <= 16, bf16/fp16): at decode widths the
//     weight is read once and nothing else counts, so the kernel is a
//     weight stream that never stalls. Four causes held the earlier
//     one-pass kernel to 12-55% of that bound; each design point answers
//     one:
//       - A ring of four shared-memory stages, each
//         up to 64 weight rows by 512 k and the same k slice of the
//         activations, fed by one producer warp onto full/empty mbarriers.
//         The weight arrives by TMA in boxes of 128 k by the whole chunk
//         (16, 32, 48 or 64 rows: tensor maps encoded once per weight and
//         box height, kept on the host); each activation row's k slice by
//         one cp.async.bulk. A bulk request costs ~40 ns of an SM's copy
//         engine on an H100 whatever its size, so requests are few and
//         large: per-row copies of the weight could not feed an SM's
//         25 GB/s share. Copies stay in flight while eight consumer warps
//         widen and multiply the stages that have landed (the earlier
//         kernel had none in flight while a warp computed).
//       - A persistent grid of one CTA an SM, each given a contiguous run
//         of whole 16-row blocks, so
//         no SM streams more than ~3% above the mean at llama3_8b's
//         shapes; where the row blocks alone would leave SMs idle (k/v's
//         64 blocks) K is split, so each SM still streams ~32 KB.
//       - The K splits of a run are one thread-block cluster: ranks 1..S-1
//         store their fp32 partials into rank 0's shared memory
//         (st.shared::cluster) behind an mbarrier, and rank 0 sums them in
//         rank order and writes the output. No partial goes through device
//         memory: no workspace, no ticket, no allocation but the output.
//       - Widening overlaps the copies: bf16 by the fp32 2^23 magic (exact,
//         as before), fp16 by halves 1024 + u (two codes a packed
//         subtract). Consumers read the stage with 16-byte shared loads
//         free of bank conflicts: the weight boxes carry TMA's 128-byte
//         swizzle, and the mma rows of a load phase are box rows 4 apart,
//         so their chunks fall in opposite halves of the 128 bank bytes;
//         the activation rows are padded to 2 * 512 + 16 bytes.
//     A warp's product is mma.sync m16n8k16 with 16 weight rows as A and up
//     to 8 activation rows as B (two products for 9..16 rows). The k order
//     inside a product is free as long as both operands share it, so lane
//     (g, c) takes bytes 16c..16c+15 of a 64-deep block of rows g and g + 8
//     and, in mma step s, their bytes 4s..4s+3 with the matching 4
//     activations of B column g. A run is cut into the fewest chunks of at
//     most 64 rows (whole 16-row groups), each shared by the 8 warps: warp
//     w takes the 64-deep block w of every 512-deep stage for all the
//     chunk's row groups (one read of the activations' block feeds up to
//     four independent accumulator chains); at the chunk's end the blocks'
//     partials go through shared memory and are summed in block order, then
//     across the cluster in rank order, so two launches give the same bits.
//   * w8a16_wgmma_kernel (M > 16, bf16/fp16): bf16/fp16 wgmma fed by TMA in
//     persistent, warp-specialised CTAs (attn_fwd_sm90.cuh's shape, the
//     units and split-K ticket of gemm_sm90.cuh, as qmm.cu's W8A8 kernel).
//     wgmma reads a shared-memory operand only in its own type and the
//     weight is int8, so A and B are swapped: each consumer warpgroup
//     computes a tile of out^T whose 64 wgmma rows are 64 weight rows n and
//     whose wgmma columns are BM activation rows m (64, 128 or 256); the
//     scale is a per-row factor of the accumulator.
//       - B, the activations, arrive by TMA as K-major [BM][64 k] 16-bit
//         tiles with the 128-byte swizzle; wgmma reads them by descriptor.
//       - A, the weight, arrives by TMA as it lies, a K-major [128 n][64 k]
//         int8 tile with the 64-byte swizzle (16-byte chunk j of row r
//         sits at chunk j ^ ((r / 2) % 4)), and each consumer builds its
//         register fragments from it, widening the codes in registers.
//         B read by descriptor fixes the k order of a fragment to
//         mma.sync m16n8k16's A layout: in each 16-deep k step s, thread
//         (g, c) of a warp holds k {2c, 2c+1} of its rows g and g + 8
//         (registers 0 and 1) and k {2c+8, 2c+9} of both (2 and 3). Only
//         the rows are free: row g is weight row 2g + h of the warp's 16
//         and row g + 8 is 2g + 1 - h, h = (g / 4) % 2, which the epilogue
//         maps back (the two are columns n, n + 1 of one 32-bit store). In step
//         s the thread reads, from each row, the 32-bit words at bytes
//         16s + 4(c / 2) (part 0) and + 8 (part 1) (chunk s, swizzled by
//         g % 4: rows 2g + h and 2g + 1 - h both give (r / 2) % 4 = g % 4),
//         and keeps bytes 2(c % 2), 2(c % 2) + 1 of each: 16 loads a stage.
//         Across a warp one load touches rows with all eight values of
//         (r % 2, (r / 2) % 4), so the 16 distinct words sit in 16 banks:
//         free of conflicts (h exists for that; with h = 0 rows g and g + 4
//         would collide).
//       - Widening is exact. bf16: each byte, biased to unsigned, becomes
//         the low byte of the fp32 2^23 magic, 2^23 + 128 comes off, and
//         the high halves of two such floats are the bf16 pair (|q| <= 128
//         needs 8 significant bits, so the low halves are zero). fp16: the
//         bias trick, halves 1024 + (q + 128) less 1152, two codes a
//         packed subtract.
//       - One producer warp (its registers given away with setmaxnreg.dec)
//         issues both copies of each stage into a ring of full/empty
//         mbarriers, running ahead across tiles; the two consumer
//         warpgroups (64 weight rows each, setmaxnreg.inc) issue a
//         stage's four k steps as one wgmma group while the next stage's
//         fragments are built into a second register set.
//       - Tiles are dealt m fastest, so the CTAs running together share one
//         strip of the weight (58.7 MB at the 8B gate/up projection, more
//         than the 50 MB L2) while the activations stay in L2. A tile of
//         256 weight rows (two row blocks a warpgroup, half the activation
//         reads of L2 per product) ran slower than 128 at every 8B
//         prefill shape on an H100 (tools/w8a16_ab.py), and is not built.
//       - Split-K where the tiles alone would leave most SMs without work
//         (128 activation rows: 32 tiles at N 4096, 16 of 64 rows at N
//         1024): the wrapper (_w8a16_plan) splits K into contiguous runs of
//         whole 64-deep stages, at tiles of 64 and 128 rows. Each split stores its
//         fp32 partial, in the accumulators' own order, to ws; the last
//         split of a tile to arrive sums the partials in split order behind
//         a ticket it resets to 0, so two launches give the same bits. No
//         float atomics.
//   * w8a16_simt_kernel (fp32 activations, or K % 16 != 0, or an operand
//     not 16-byte aligned): 32 x 64 tiles on the CUDA cores in fp32, both
//     operands widened to fp32 in shared memory, each output summed in k
//     order. fp32 models get fp32 products, as the JAX branch gives them.
//
// Accumulation is fp32 everywhere (f32 accumulators of mma.sync and wgmma); the
// epilogue multiplies with __fmul_rn, so no FMA contraction changes the
// rounding of the scale product.

#include <cuda_fp16.h>

#include <atomic>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "gemm_sm90.cuh"  // gemm90 (and fwd90): TMA, mbarriers, units, the split-K ticket

namespace {

constexpr int kSimtM = 32, kSimtN = 64, kSimtK = 32;

enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };
enum Kernel { kSimt = 0, kGemv = 1, kWgmma = 2 };

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

// Four codes to two 16-bit pairs, exactly: (k0, k1) and (k2, k3). bf16
// through the fp32 magic; fp16 as halves 1024 + (q + 128) less 1152, two
// codes a packed subtract.
template <typename T>
__device__ __forceinline__ void codes_to_pairs(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const uint32_t u = w ^ 0x80808080u;
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(__byte_perm(u, 0x64646464u, 0x4140)),
        "r"(0x64806480u));
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(__byte_perm(u, 0x64646464u, 0x4342)),
        "r"(0x64806480u));
  } else {
    float f[4];
    widen4(w, f);
    lo = pack2<T>(f[0], f[1]);
    hi = pack2<T>(f[2], f[3]);
  }
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

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------- decode

constexpr int kDecBlocks = 8;    // 64-deep blocks of a stage, one for each consumer warp
constexpr int kDecWarps = kDecBlocks;  // consumer warps; then one producer warp
constexpr int kDecThreads = 32 * (kDecWarps + 1);
constexpr int kDecConsumers = 32 * kDecWarps;
constexpr int kDecRows = 16;    // weight rows of a unit of the deal
constexpr int kDecChunk = 64;   // weight rows a CTA streams at once, at most
constexpr int kDecStages = 4;   // ring slots
constexpr int kPartStride = kDecChunk + 4;  // floats from one activation row of a partial to the next
constexpr int kDecSmemMax = 232448;  // an H100 CTA's dynamic shared memory
constexpr int kDecMaxCluster = 8;    // portable cluster sizes only
constexpr int kDecStageK = 512;  // k (bytes of a weight row) a stage holds
constexpr int kDecBoxK = 128;    // one TMA box: 16 weight rows by 128 k, one swizzle span
constexpr int kDecXStride = 2 * kDecStageK + 16;  // bytes from one activation row to the next

// One launch of the decode kernel. The layout is the plan's
// (ops/w8a16.py, _gemv_layout): offsets in bytes from the 1024-byte
// aligned base of dynamic shared memory (the 128-byte swizzle repeats
// every 1024 bytes).
struct DParams {
  // q as (K, N), 128-byte swizzle, boxes of 128 k by 16 (i + 1) rows: a
  // whole chunk a box. Box heights past N are not encoded (16 always is).
  CUtensorMap wmaps[kDecChunk / 16];
  const void* x;     // [M, K] 16-bit
  const float* scale;
  void* out;  // [M, N]
  int M, K, N, round_first;
  int splits;     // CTAs of a cluster, each one contiguous share of K's 64-deep blocks
  int slot_rows;  // weight rows a slot holds: the longest chunk of any run
  uint32_t slot_bytes;  // [4 k-boxes][slot_rows][128 k] int8, then [M][kDecXStride] 16-bit
  uint32_t part;  // 4 blocks' partials, [8 MT m][kPartStride] fp32 each
  uint32_t red;   // 2 x (splits - 1) x [slot_rows x M] fp32: the other ranks' sums (rank 0)
  uint32_t bars;  // full[kDecStages], empty[kDecStages], red_full[2], red_empty[2]
  uint32_t smem;  // bytes to request
};

// The weight's tensor map with boxes of `rows` rows, encoded once per
// (pointer, N, K, rows) and kept: a decode step calls the kernel 225 times
// on the same weights, and an encode costs more host time than the launch.
// The map depends on nothing else, so an address reused by another weight
// of the same shape finds a map that is right for it too.
inline bool weight_map(CUtensorMap* map, const void* q, int N, int K, int rows) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CUtensorMap> maps;
  const auto key = std::make_tuple(q, N, K, rows);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const fwd90::EncodeTiled encode = fwd90::tensor_map_encoder();
  if (encode == nullptr) return false;
  if (!gemm90::encode_2d(map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kDecBoxK, rows,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (maps.size() >= 4096) maps.clear();  // a bound, far above a model's weights
  maps.emplace(key, *map);
  return true;
}

// The weight rows [r0, r1) of cluster c of C: its units [c U / C, (c + 1)
// U / C) of kDecRows rows each, the last cut at N rounded up to 16
// (ops/w8a16.py's W8a16Plan.runs states the same deal for the plan's tests).
struct Run {
  int r0, r1;
};
__device__ __forceinline__ Run run_of(int c, int C, int N) {
  const int U = (N + kDecRows - 1) / kDecRows;
  const int u0 = static_cast<int>(static_cast<long long>(c) * U / C);
  const int u1 = static_cast<int>(static_cast<long long>(c + 1) * U / C);
  return {u0 * kDecRows, min(u1 * kDecRows, (N + 15) & ~15)};
}
// A run of L rows (a multiple of 16) is streamed in the fewest chunks of
// at most 64 rows, ceil(L / 64), as equal as whole 16-row groups allow, the
// larger first: chunk i of the run starts at row_of(i) and has
// row_of(i + 1) - row_of(i) rows.
struct Chunks {
  int n, units;  // chunks, 16-row groups of the run
  __device__ int row_of(int i) const {
    const int q = units / n, r = units % n;
    return 16 * (i * q + min(i, r));
  }
};
__device__ __forceinline__ Chunks chunks_of(int rows) {
  return {(rows + kDecChunk - 1) / kDecChunk, rows / 16};
}

// The consumer threads (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kDecConsumers) : "memory");
}

// A contiguous run of bytes into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// The cluster barrier of every thread of every CTA, in its two halves (each
// thread alternates them; the warp reconverged first: they are .aligned).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// A shared::cta address of this CTA as the same offset in CTA `rank` of the
// cluster.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

// Arrive on an mbarrier of any CTA of the cluster, releasing this thread's
// earlier writes (remote ones included) at cluster scope.
__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

// Wait for a phase of this CTA's mbarrier, acquiring at cluster scope what
// the arriving threads of other CTAs released.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// CTA: 8 consumer warps, then one producer warp; launched in clusters of
// p.splits CTAs (rank s streams its share of K), gridDim.x / p.splits
// clusters, each streaming its run of weight rows chunk by chunk. MT:
// 8-row groups of activations (1 for M <= 8, 2 for M <= 16).
// One stage's products for a consumer warp: its 64-deep block (the lane's
// 16 bytes at `col` of each row) of the chunk's NB row groups, every load
// first, then NB independent accumulator chains.
template <typename T, int MT, int NB>
__device__ __forceinline__ void stage_products(float (&acc)[4][MT][4], const unsigned char* slot,
                                               const unsigned char* xrow, int pi, int col,
                                               int g8, bool in, int M) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 xv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = min(mt * 8 + g8, M - 1);  // columns past M are never stored
    const uint4* xp = reinterpret_cast<const uint4*>(xrow + m * kDecXStride);
    xv[mt][0] = in ? xp[0] : zero;
    xv[mt][1] = in ? xp[1] : zero;
  }
  uint4 wa[NB], wb[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    const unsigned char* wrow = slot + (16 * r + pi) * kDecBoxK + col;
    wa[r] = *reinterpret_cast<const uint4*>(wrow);
    wb[r] = *reinterpret_cast<const uint4*>(wrow + 8 * kDecBoxK);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      uint32_t a[4];
      codes_to_pairs<T>(word(wa[r], s), a[0], a[2]);
      codes_to_pairs<T>(word(wb[r], s), a[1], a[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4& xb = xv[mt][s >> 1];
        mma16816<T>(acc[r][mt], a, word(xb, 2 * (s & 1)), word(xb, 2 * (s & 1) + 1));
      }
    }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kDecThreads, 1)
    w8a16_decode_kernel(const __grid_constant__ DParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = fwd90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int S = p.splits;
  const int rank = blockIdx.x % S, cl = blockIdx.x / S;  // clusters are (S, 1, 1)
  const Run run = run_of(cl, gridDim.x / S, p.N);
  const int n_kb = (p.K + 63) / 64;
  const int k0 = rank * n_kb / S * 64, k1 = min((rank + 1) * n_kb / S * 64, p.K);
  const uint32_t bars = base + p.bars;
  const uint32_t red_full = bars + 16u * kDecStages, red_empty = red_full + 16u;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (kDecStages + st); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kDecStages; ++st) {
      fwd90::mbar_init(full(st), 1);
      fwd90::mbar_init(empty(st), kDecConsumers);
    }
    if (S > 1)
      for (int b = 0; b < 2; ++b) {
        fwd90::mbar_init(red_full + 8u * b, (S - 1) * kDecWarps);  // a warp's lane 0 each
        fwd90::mbar_init(red_empty + 8u * b, kDecWarps);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // The next kernel in the stream may be scheduled now (as this grid's
    // CTAs leave the SMs); its own griddepcontrol.wait orders its reads of
    // this one's output. This kernel's own reads wait for the one before
    // it in the producer's griddepcontrol.wait.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }
  __syncthreads();
  // The cluster's first barrier: every CTA has started and set up its
  // mbarriers before any thread reaches another CTA's shared memory. Each
  // thread arrives here and waits only before its first remote access, so
  // the producer's first copies do not wait for the other CTAs.
  if (S > 1) cluster_arrive();

  if (warp == kDecWarps) {
    // ------------------------------------------------------- producer
    // Lane 0 claims a slot and sets its byte count; it issues the TMA boxes
    // (128 k by the chunk's R rows, or R / 16 boxes of 16 rows where N < R;
    // none past the stage's k) and lanes 1..M one bulk copy each of an
    // activation row's k slice. A copy request costs an SM's copy engine
    // about the same whatever its size, so the boxes are as tall as the
    // chunk.
    // A programmatic dependent launch may start this grid while the kernel
    // before it still runs: nothing is read before griddepcontrol.wait,
    // neither the activations nor the weight (either may be that kernel's
    // output).
    const auto* x = static_cast<const unsigned char*>(p.x);
    if (lane < kDecChunk / 16 && (lane == 0 || 16 * (lane + 1) <= p.N))
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&p.wmaps[lane])) : "memory");
    const Chunks ch = chunks_of(run.r1 - run.r0);
    const int n_st = (k1 - k0 + kDecStageK - 1) / kDecStageK;  // stages a chunk
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    // Stage g of the CTA's walk: chunk g / n_st, k0 + (g % n_st) 512.
    for (int g = 0; g < ch.n * n_st; ++g) {
      const int i = g / n_st, st = g % kDecStages;
      const int n0 = run.r0 + ch.row_of(i), R = ch.row_of(i + 1) - ch.row_of(i);
      const int k = k0 + g % n_st * kDecStageK, len = min(kDecStageK, k1 - k);
      const int boxes = (len + kDecBoxK - 1) / kDecBoxK;
      const uint32_t slot = base + st * p.slot_bytes;
      if (lane == 0) {
        fwd90::mbar_wait(empty(st), ((g / kDecStages) & 1) ^ 1);  // round 0 passes at once
        fwd90::mbar_expect_tx(full(st), (R / 16) * boxes * 16 * kDecBoxK + p.M * 2 * len);
      }
      __syncwarp();  // the slot claimed and its bytes set before any copy lands
      if (lane == 0) {
        for (int b = 0; b < boxes; ++b) {  // k-box b: [slot_rows][128 k] from slot + b ...
          const uint32_t dst = slot + b * p.slot_rows * kDecBoxK;
          if (R <= p.N)  // one box for the chunk's rows
            gemm90::tma_load_2d(dst, &p.wmaps[R / 16 - 1], full(st), k + b * kDecBoxK, n0);
          else
            for (int r = 0; r < R / 16; ++r)
              gemm90::tma_load_2d(dst + 16 * r * kDecBoxK, &p.wmaps[0], full(st),
                                  k + b * kDecBoxK, n0 + 16 * r);
        }
      } else if (lane <= p.M) {
        const int m = lane - 1;
        bulk_load(slot + p.slot_rows * kDecStageK + m * kDecXStride,
                  x + (static_cast<size_t>(m) * p.K + k) * 2, 2 * len, full(st));
      }
    }
    if (S > 1) {
      cluster_wait();
      cluster_sync();  // no CTA leaves while another may reach its shared memory
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int g8 = lane >> 2, c = lane & 3;
  const int t = threadIdx.x;
  const Chunks ch = chunks_of(run.r1 - run.r0);
  T* out = static_cast<T*>(p.out);
  // Warp w takes the 64-deep block w of every stage, for every row group
  // of the chunk: one read of the activations' block serves up to four
  // independent accumulator chains.
  //
  // A stage holds the weight as 4 k-boxes of [slot_rows][128 k] (row group
  // r: rows 16r..16r+15), each with the 128-byte swizzle: 16-byte chunk u
  // of row p sits at u ^ (p % 8). mma rows g and g + 8 are rows pi and pi +
  // 8 of the group, pi = g / 2 + 4 (g % 2): the two rows of a load phase (g
  // = 2i, 2i + 1) differ by 4, so their chunks fall in opposite halves of
  // the 128 bank bytes.
  const int pi = (g8 >> 1) + 4 * (g8 & 1);
  const int kk = 64 * warp;
  const int col = p.slot_rows * kDecBoxK * (warp >> 1) + 16 * ((4 * (warp & 1) + c) ^ pi);
  float* part = reinterpret_cast<float*>(sm + p.part);
  int g = 0;
  for (int chunk = 0; chunk < ch.n; ++chunk) {
    const int n0 = run.r0 + ch.row_of(chunk), R = ch.row_of(chunk + 1) - ch.row_of(chunk);
    const int nb = R >> 4;
    float acc[4][MT][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][mt][e] = 0.0f;

    for (int k = k0; k < k1; k += kDecStageK, ++g) {
      const int st = g % kDecStages;
      const int len = min(kDecStageK, k1 - k);
      fwd90::mbar_wait(full(st), (g / kDecStages) & 1);
      if (kk < len) {
        const unsigned char* slot = sm + st * p.slot_bytes;
        const unsigned char* xrow = slot + p.slot_rows * kDecStageK + 32 * c + 2 * kk;
        const bool in = kk + 16 * c < len;  // K % 64 != 0 leaves lanes past the end
        switch (nb) {
          case 4: stage_products<T, MT, 4>(acc, slot, xrow, pi, col, g8, in, p.M); break;
          case 3: stage_products<T, MT, 3>(acc, slot, xrow, pi, col, g8, in, p.M); break;
          case 2: stage_products<T, MT, 2>(acc, slot, xrow, pi, col, g8, in, p.M); break;
          default: stage_products<T, MT, 1>(acc, slot, xrow, pi, col, g8, in, p.M);
        }
      }
      fwd90::mbar_arrive(empty(st));
    }

    // acc[r][mt][e]: chunk row 16 r + pi + 8 (e / 2), activation row mt * 8
    // + 2c + (e & 1). Each output is summed over the warps' partials in
    // warp order, through a buffer of four: warps 0-3 write theirs, every
    // thread adds them up, then warps 4-7 (each write behind a barrier
    // that the last reads of the buffer have passed).
    const int outs = R * p.M;  // (row, m) = (idx % R, idx / R): stores along n
    float v[kDecChunk * 16 / kDecConsumers];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      consumers_sync();
      if ((warp >> 2) == h) {
        float* mine = part + (warp & 3) * 8 * MT * kPartStride;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r >= nb) break;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mine[(mt * 8 + 2 * c + (e & 1)) * kPartStride + 16 * r + pi + 8 * (e >> 1)] =
                  acc[r][mt][e];
        }
      }
      consumers_sync();
#pragma unroll
      for (int u = 0; u < kDecChunk * 16 / kDecConsumers; ++u) {
        const int idx = t + u * kDecConsumers;
        if (idx >= outs) continue;
        const float* src = part + (idx / R) * kPartStride + idx % R;
        float sum = h == 0 ? src[0] : v[u] + src[0];
#pragma unroll
        for (int w = 1; w < kDecWarps / 2; ++w) sum += src[w * 8 * MT * kPartStride];
        v[u] = sum;
      }
    }
    const int buf = chunk & 1;
    const uint32_t red = base + p.red + buf * (S - 1) * p.slot_rows * p.M * 4;
    if (S > 1 && chunk == 0) cluster_wait();  // the first barrier, before remote access
    if (S > 1 && rank > 0) {
      // Into rank 0's shared memory, once it has read this buffer's last use.
      if (chunk >= 2) wait_cluster(red_empty + 8u * buf, ((chunk >> 1) - 1) & 1);
      const uint32_t dst = at_rank(red + (rank - 1) * p.slot_rows * p.M * 4, 0);
#pragma unroll
      for (int u = 0; u < kDecChunk * 16 / kDecConsumers; ++u) {
        const int idx = t + u * kDecConsumers;
        if (idx < outs) st_cluster(dst + 4u * idx, v[u]);
      }
      __syncwarp();  // the warp's stores, released by its lane 0
      if (lane == 0) arrive_cluster(at_rank(red_full + 8u * buf, 0));
      continue;
    }
    if (S > 1) {
      wait_cluster(red_full + 8u * buf, (chunk >> 1) & 1);
      const float* others = reinterpret_cast<const float*>(sm + (red - base));
#pragma unroll
      for (int u = 0; u < kDecChunk * 16 / kDecConsumers; ++u) {
        const int idx = t + u * kDecConsumers;
        if (idx >= outs) continue;
        for (int s = 1; s < S; ++s)  // rank order: the same bits every launch
          v[u] += others[(s - 1) * p.slot_rows * p.M + idx];
      }
      __syncwarp();  // the warp's reads of the buffer, before its lane 0 frees it
      if (chunk + 2 < ch.n && lane == 0)
        for (int s = 1; s < S; ++s) arrive_cluster(at_rank(red_empty + 8u * buf, s));
    }
#pragma unroll
    for (int u = 0; u < kDecChunk * 16 / kDecConsumers; ++u) {
      const int idx = t + u * kDecConsumers;
      if (idx >= outs) continue;
      const int n = n0 + idx % R, m = idx / R;
      if (n < p.N)
        out[static_cast<size_t>(m) * p.N + n] = finish<T>(v[u], __ldg(p.scale + n), p.round_first);
    }
  }
  if (S > 1) cluster_sync();
}

// Raises the kernel's shared-memory limit once per device, then launches it
// in clusters of p.splits. Returns the launch's error.
template <typename T, int MT>
int launch_decode_t(const DParams& p, int grid, cudaStream_t st) {
  static std::atomic<bool> ready[fwd90::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= fwd90::kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(w8a16_decode_kernel<T, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDecSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < fwd90::kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, w8a16_decode_kernel<T, MT>, p));
}

template <typename T>
int launch_decode(const DParams& p, int grid, cudaStream_t st) {
  return p.M <= 8 ? launch_decode_t<T, 1>(p, grid, st) : launch_decode_t<T, 2>(p, grid, st);
}

// ----------------------------------------------------------------- wgmma

constexpr int kWK = 64;              // k per stage: one 128-byte row of 16-bit activations
constexpr int kWN = 128;             // weight rows per tile: two warpgroups of 64
constexpr int kWRingBytes = 204800;  // the stage ring's budget of shared memory

// Dynamic shared memory from a 1024-byte aligned base: kStages of (the
// weight tile [128 n][64 k] int8, 64-byte swizzle; the activation tile [BM
// m][64 k] 16-bit, 128-byte swizzle), then the full and empty mbarriers and
// the ticket flag.
template <int BM>
struct Ring {
  static constexpr int kWBytes = kWN * kWK;
  static constexpr int kStageBytes = kWBytes + BM * kWK * 2;
  static constexpr int kStages = kWRingBytes / kStageBytes < 8 ? kWRingBytes / kStageBytes : 8;
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kBytes = kBars + 16 * kStages + 16 + 1024;
  // Whether K may be split: at the tiles of 64 and 128 rows, where few
  // tiles leave SMs idle; compiled out of the 256-row one.
  static constexpr bool kSplits = BM <= 128;
  __device__ static uint32_t w(int st) { return st * kStageBytes; }
  __device__ static uint32_t x(int st) { return st * kStageBytes + kWBytes; }
};

struct WParams {
  CUtensorMap wmap;  // q: dims (K, N) int8, boxes of 64 k x 128 n, 64-byte swizzle
  CUtensorMap xmap;  // x: dims (K, M) 16-bit, boxes of 64 k x BM m, 128-byte swizzle
  const float* scale;
  void* out;
  float* ws;     // [tiles * splits][BM / 2][256] fp32 partials (splits > 1)
  int* tickets;  // one per tile (splits > 1): 0 before and after a launch
  int M, N, splits, m_tiles, n_k, units, round_first;
};

// Where consumer thread (g, c) finds its A fragments in a weight tile (the
// note at the top): at[s] is the byte offset, in k step s, of the part-0
// word of its row g (weight row 2g + h of the warp's 16); part 1 lies 8
// bytes on, row g + 8 (weight row 2g + 1 - h) db bytes on. sel0 and sel1
// pick its two codes of a word: into the fp32 magic (bf16), or both into
// 1024 + u halves (fp16, sel0).
struct Frag {
  int at[4];
  int db;
  uint32_t sel0, sel1;
};

// d += A B for one m64nNk16 step: A (64 x 16) from registers (four 16-bit
// pairs a thread), B (N x 16) from shared memory, K-major; fp32
// accumulators. N = 64, 128, 256: the activation rows of a tile.
#define TPK_RS_N64(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
#define TPK_RS_N128(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
#define TPK_RS_N256(TY) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
#define TPK_D8(d, i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TPK_D32(d, i) TPK_D8(d, i), TPK_D8(d, i + 8), TPK_D8(d, i + 16), TPK_D8(d, i + 24)
#define TPK_AB(a, b) "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)

template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf)
    asm volatile(TPK_RS_N64("f16") : TPK_D32(d, 0) : TPK_AB(a, b));
  else
    asm volatile(TPK_RS_N64("bf16") : TPK_D32(d, 0) : TPK_AB(a, b));
}
template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf)
    asm volatile(TPK_RS_N128("f16") : TPK_D32(d, 0), TPK_D32(d, 32) : TPK_AB(a, b));
  else
    asm volatile(TPK_RS_N128("bf16") : TPK_D32(d, 0), TPK_D32(d, 32) : TPK_AB(a, b));
}
template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf)
    asm volatile(TPK_RS_N256("f16")
                 : TPK_D32(d, 0), TPK_D32(d, 32), TPK_D32(d, 64), TPK_D32(d, 96)
                 : TPK_AB(a, b));
  else
    asm volatile(TPK_RS_N256("bf16")
                 : TPK_D32(d, 0), TPK_D32(d, 32), TPK_D32(d, 64), TPK_D32(d, 96)
                 : TPK_AB(a, b));
}

// The thread's two codes of a weight word, widened exactly to a 16-bit
// pair (the lower k in the low half).
template <bool kHalf>
__device__ __forceinline__ uint32_t widen_pair(uint32_t word, const Frag& f) {
  const uint32_t u = word ^ 0x80808080u;  // each code biased to unsigned: q + 128
  if constexpr (kHalf) {
    // Halves 1024 + u (fp16 spaces 1024..2047 by 1), less 1152 (0x6480).
    uint32_t r;
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(__byte_perm(u, 0x64646464u, f.sel0)),
        "r"(0x64806480u));
    return r;
  } else {
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, f.sel0)) - 8388736.0f;
    const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, f.sel1)) - 8388736.0f;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);  // the bf16 halves
  }
}

// The A fragments of one stage's four k steps, from its weight tile.
template <bool kHalf>
__device__ __forceinline__ void build_a(uint32_t (&a)[4][4], const unsigned char* wtile,
                                        const Frag& f) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const unsigned char* row_g = wtile + f.at[s] + 8 * part;
      a[s][2 * part] = widen_pair<kHalf>(*reinterpret_cast<const uint32_t*>(row_g), f);
      a[s][2 * part + 1] = widen_pair<kHalf>(*reinterpret_cast<const uint32_t*>(row_g + f.db), f);
    }
}

// One stage of the ring for the consumers: wait for its copies, build its
// fragments into `a`, issue its four k steps as one group, then, once the
// previous stage's group has landed, free the previous stage's slot.
template <int BM, bool kHalf>
__device__ __forceinline__ void wgmma_stage(float (&acc)[BM / 2], uint32_t (&a)[4][4],
                                            const unsigned char* tiles, uint32_t base,
                                            uint32_t bars, const Frag& f, int& g,
                                            bool free_prev) {
  using R = Ring<BM>;
  constexpr int S = R::kStages;
  const int st = g % S;
  fwd90::mbar_wait(bars + 8u * st, (g / S) & 1);
  build_a<kHalf>(a, tiles + R::w(st), f);
  fwd90::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_rs<kHalf>(acc, a[s], fwd90::sw128_desc(base + R::x(st) + s * 32, 16, 1024));
  fwd90::wgmma_commit();
  fwd90::wgmma_wait<1>();
  if (free_prev) fwd90::mbar_arrive(bars + 8u * (S + (g + S - 1) % S));
  ++g;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* o, T lo, T hi) {
  *reinterpret_cast<uint32_t*>(o) = static_cast<uint32_t>(reinterpret_cast<uint16_t&>(lo)) |
                                    static_cast<uint32_t>(reinterpret_cast<uint16_t&>(hi)) << 16;
}

template <int BM, bool kHalf>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
    w8a16_wgmma_kernel(const __grid_constant__ WParams p) {
  using T = typename std::conditional<kHalf, __half, __nv_bfloat16>::type;
  using R = Ring<BM>;
  constexpr int S = R::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = fwd90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + R::kBars;
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
        const gemm90::Unit w = gemm90::unit_of(u, p.splits, p.m_tiles, p.n_k, BM, kWN);
        for (int kc = w.c0; kc < w.c1; ++kc, ++g) {
          const int st = g % S;
          fwd90::mbar_wait(empty(st), ((g / S) & 1) ^ 1);  // round 0 passes at once
          fwd90::mbar_expect_tx(full(st), R::kStageBytes);
          gemm90::tma_load_2d(base + R::w(st), &p.wmap, full(st), kc * kWK, w.n0);
          gemm90::tma_load_2d(base + R::x(st), &p.xmap, full(st), kc * kWK, w.m0);
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
  const int g8 = lane >> 2, c = lane & 3, h = (g8 >> 2) & 1;
  const int row0 = cw * 64 + 16 * warp;  // the warp's first weight row in the tile
  Frag f;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    f.at[s] = (row0 + 2 * g8 + h) * kWK + ((s ^ (g8 & 3)) << 4) + 4 * (c >> 1);
  f.db = (1 - 2 * h) * kWK;
  const uint32_t b0 = 2 * (c & 1);  // the thread's first code in a word
  f.sel0 = kHalf ? 0x4040u | b0 | ((b0 + 1) << 8) : 0x7650u + b0;
  f.sel1 = 0x7651u + b0;
  const unsigned char* tiles = smem_raw + (base - raw);

  uint32_t af[2][4][4];  // two stages' A fragments: one built while the other is read
  int g = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const gemm90::Unit w = gemm90::unit_of(u, p.splits, p.m_tiles, p.n_k, BM, kWN);
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;

    // Stages alternate between the two fragment sets, so that one stage's
    // fragments are built while the other's products still read theirs.
    int kc = w.c0;
    for (; kc + 1 < w.c1; kc += 2) {
      wgmma_stage<BM, kHalf>(acc, af[0], tiles, base, bars, f, g, kc > w.c0);
      wgmma_stage<BM, kHalf>(acc, af[1], tiles, base, bars, f, g, true);
    }
    if (kc < w.c1) wgmma_stage<BM, kHalf>(acc, af[0], tiles, base, bars, f, g, kc > w.c0);
    fwd90::wgmma_wait<0>();
    fwd90::fence_regs(acc);
    fwd90::mbar_arrive(empty((g + S - 1) % S));

    if constexpr (R::kSplits) {
      if (p.splits > 1) {
        // This split's partial, coalesced in the accumulators' order; the
        // last split sums all of them (its own included) from L2 in split
        // order.
        float* part = p.ws + static_cast<size_t>(w.tile) * p.splits * (BM / 2) * 256 + ct;
#pragma unroll
        for (int i = 0; i < BM / 2; ++i)
          __stcg(part + (w.split * (BM / 2) + i) * 256, acc[i]);
        if (!gemm90::last_split(p.tickets, w.tile, p.splits, ct, last_flag)) continue;
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
        for (int sp = 0; sp < p.splits; ++sp)
#pragma unroll
          for (int i = 0; i < BM / 2; ++i) acc[i] += __ldcg(part + (sp * (BM / 2) + i) * 256);
      }
    }

    // acc[4j + 2i + e]: activation row m0 + 8j + 2c + e; weight row n + h
    // (i = 0) or n + 1 - h (i = 1), n = the thread's even column.
    const int n = w.n0 + row0 + 2 * g8;
    if (n >= p.N) continue;
    const bool two = n + 1 < p.N, even = (p.N & 1) == 0;
    const float s0 = __ldg(p.scale + n), s1 = two ? __ldg(p.scale + n + 1) : 0.0f;
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = w.m0 + 8 * j + 2 * c + e;
        if (m >= p.M) continue;
        const float va = acc[4 * j + e], vb = acc[4 * j + 2 + e];
        const T lo = finish<T>(h ? vb : va, s0, p.round_first);
        T* o = out + static_cast<size_t>(m) * p.N + n;
        if (!two) {
          o[0] = lo;
          continue;
        }
        const T hi = finish<T>(h ? va : vb, s1, p.round_first);
        if (even) {
          store_pair(o, lo, hi);
        } else {
          o[0] = lo;
          o[1] = hi;
        }
      }
    }
  }
}

template <int BM, bool kHalf>
int launch_wgmma(WParams& p, const void* x, const void* q, int K, cudaStream_t st) {
  if (!gemm90::encode_2d(&p.wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, p.N, kWK, kWN,
                         CU_TENSOR_MAP_SWIZZLE_64B) ||
      !gemm90::encode_2d(&p.xmap, x, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, K, p.M, kWK, BM,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  p.m_tiles = (p.M + BM - 1) / BM;
  p.units = p.m_tiles * ((p.N + kWN - 1) / kWN) * p.splits;
  return fwd90::launch<w8a16_wgmma_kernel<BM, kHalf>, Ring<BM>::kBytes>(p, p.units, st);
}

// The tile the plan names: bm activation rows by 128 weight rows.
template <bool kHalf>
int launch_tile(WParams& p, const void* x, const void* q, int K, int bm, cudaStream_t st) {
  switch (bm) {
    case 64: return launch_wgmma<64, kHalf>(p, x, q, K, st);
    case 128: return launch_wgmma<128, kHalf>(p, x, q, K, st);
    case 256: return launch_wgmma<256, kHalf>(p, x, q, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// The CUDA-core kernel (the wgmma kernel: launch_tile; the decode kernel:
// launch_decode).
template <typename T>
cudaError_t launch_simt(const void* x, const int8_t* q, const float* scale, void* out, int M,
                        int K, int N, int round_first, cudaStream_t st) {
  const dim3 grid((N + kSimtN - 1) / kSimtN, (M + kSimtM - 1) / kSimtM);
  w8a16_simt_kernel<T><<<grid, 256, 0, st>>>(static_cast<const T*>(x), q, scale,
                                             static_cast<T*>(out), M, K, N, round_first);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (x and out). kernel: 0 simt; 1 gemv, the
// decode kernel (M <= 16; splits: CTAs of a cluster, 1, 2, 4 or 8, each
// one share of K's 64-deep blocks; grid: CTAs, a multiple of splits, at
// most one cluster per 16-row unit; slot_rows .. smem: the shared-memory
// layout, DParams', laid out by the plan; bm, ws and tickets unused); 2
// wgmma (tiles of bm activation rows, 64, 128 or 256, by 128 weight rows;
// K split `splits` ways in 64-deep stages, at bm <= 128 only, ws [tiles *
// splits, bm * 128] fp32 and tickets (one int per tile, all 0) read only
// when splits > 1; grid and the layout unused). round_first: the
// unembedding's epilogue. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a plan the kernels do not take (a wgmma plan
// TMA cannot describe, a decode layout past a CTA's shared memory, among
// them). The kernel is the caller's choice: this never switches kernels.
extern "C" int tpk_w8a16(const void* x, const void* q, const void* scale, void* out, void* ws,
                         void* tickets, int M, int K, int N, int dtype, int round_first,
                         int kernel, int bm, int splits, int grid, int slot_rows,
                         int slot_bytes, int part, int red, int bars, int smem, void* stream) {
  if (M < 0 || K < 1 || N < 0 || dtype < kF32 || dtype > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const auto bad = [] { return static_cast<int>(cudaErrorInvalidValue); };
  const int n_k = (K + 63) / 64;  // 64-deep k blocks (gemv) or stages (wgmma)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == kSimt) {
    if ((M + kSimtM - 1) / kSimtM > 65535) return bad();
    const auto* qp = static_cast<const int8_t*>(q);
    const auto* sp = static_cast<const float*>(scale);
    cudaError_t err;
    switch (dtype) {
      case kF32: err = launch_simt<float>(x, qp, sp, out, M, K, N, round_first, st); break;
      case kBf16: err = launch_simt<__nv_bfloat16>(x, qp, sp, out, M, K, N, round_first, st); break;
      default: err = launch_simt<__half>(x, qp, sp, out, M, K, N, round_first, st);
    }
    return static_cast<int>(err);
  }
  if (kernel != kGemv && kernel != kWgmma) return bad();
  if (dtype == kF32 || K % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || splits < 1 || splits > n_k)
    return bad();
  if (kernel == kGemv) {
    const int units = (N + kDecRows - 1) / kDecRows;
    if (M > 16 || (splits & (splits - 1)) != 0 || splits > kDecMaxCluster || grid < splits ||
        grid % splits != 0 || grid / splits > units || slot_rows < 16 ||
        slot_rows > kDecChunk || slot_rows % 16 != 0 || slot_bytes % 1024 != 0 ||
        part < kDecStages * slot_bytes || red <= part || bars < red || bars % 8 != 0 ||
        smem <= bars || smem > kDecSmemMax)
      return bad();
    DParams p;
    for (int rows = 16; rows <= kDecChunk; rows += 16)
      if ((rows == 16 || rows <= N) && !weight_map(&p.wmaps[rows / 16 - 1], q, N, K, rows))
        return bad();
    p.x = x;
    p.scale = static_cast<const float*>(scale);
    p.out = out;
    p.M = M;
    p.K = K;
    p.N = N;
    p.round_first = round_first;
    p.splits = splits;
    p.slot_rows = slot_rows;
    p.slot_bytes = slot_bytes;
    p.part = part;
    p.red = red;
    p.bars = bars;
    p.smem = smem;
    return dtype == kF16 ? launch_decode<__half>(p, grid, st)
                         : launch_decode<__nv_bfloat16>(p, grid, st);
  }
  if ((splits > 1 && (ws == nullptr || tickets == nullptr)) || (splits > 1 && bm > 128))
    return bad();
  WParams p;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.M = M;
  p.N = N;
  p.splits = splits;
  p.n_k = n_k;
  p.round_first = round_first;
  return dtype == kF16 ? launch_tile<true>(p, x, q, K, bm, st)
                       : launch_tile<false>(p, x, q, K, bm, st);
}
