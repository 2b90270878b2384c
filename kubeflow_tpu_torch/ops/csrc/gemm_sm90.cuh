// What the two weight-times-activation matmuls for Hopper share: the int8
// one (qmm.cu, qmm_wgmma_kernel) and the W8A16 one (w8a16.cu,
// w8a16_wgmma_kernel). Both are persistent, warp-specialised CTAs in the
// shape of attn_fwd_sm90.cuh (one producer warp issuing TMA copies into a
// full/empty mbarrier ring, two consumer warpgroups on wgmma), both walk
// the same units of work (an output tile and a contiguous run of K's
// stages), and both reduce a split K behind the same ticket. What they do
// not share is the operand types, the fragment build and the epilogue.

#pragma once

#include "attn_fwd_sm90.cuh"  // fwd90: mbarrier, TMA-map, wgmma and launch primitives

namespace gemm90 {

// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The 256 consumer threads (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(fwd90::kConsumerThreads) : "memory");
}

// One unit of work: the output tile `tile` (bm activation rows from m0, bn
// weight rows from n0) and the stages [c0, c1) of K. Units are numbered
// split fastest, then tiles m fastest, so the CTAs running together share
// one strip of the weight and a tile's splits run side by side.
struct Unit {
  int tile, split, m0, n0, c0, c1;
};

__device__ __forceinline__ Unit unit_of(int u, int splits, int m_tiles, int n_k, int bm,
                                        int bn) {
  Unit w;
  w.split = u % splits;
  w.tile = u / splits;
  w.m0 = (w.tile % m_tiles) * bm;
  w.n0 = (w.tile / m_tiles) * bn;
  w.c0 = w.split * n_k / splits;
  w.c1 = (w.split + 1) * n_k / splits;
  return w;
}

// The split-K ticket, for the consumers once each has stored its share of
// the tile's partial: every consumer's stores, then one release fence and
// the add by consumer thread 0 (the barrier orders the others' stores
// before its fence). The last split to arrive resets the ticket to 0, so
// the counters stay zero between launches, and acquires the others'
// partials. Returns, to every consumer, whether this split is the last;
// `flag` is a word of shared memory.
__device__ __forceinline__ bool last_split(int* tickets, int tile, int splits, int ct,
                                           volatile int* flag) {
  consumers_sync();
  if (ct == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const int last = atomicAdd(tickets + tile, 1) == splits - 1;
    if (last) {
      tickets[tile] = 0;  // every split has arrived: ready for the next launch
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // acquire the others' partials
    }
    *flag = last;
  }
  consumers_sync();
  return *flag != 0;
}

// The map of a contiguous row-major [outer, inner] matrix of `elem`-byte
// elements: boxes of (box_inner, box_outer), the given swizzle, zero fill
// out of bounds. False if it cannot be encoded (an address not 16-byte
// aligned, a row stride not a multiple of 16 bytes).
inline bool encode_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem,
                      int inner, int outer, int box_inner, int box_outer,
                      CUtensorMapSwizzle swizzle) {
  const fwd90::EncodeTiled encode = fwd90::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem_strides[2] = {1u, 1u};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace gemm90
