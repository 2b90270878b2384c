// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (launched by _flash_fwd): blockwise online-softmax attention with fp32
// accumulators, scale 1/sqrt(D), the finite -1e30 mask, GQA without copies,
// the four mask kinds with fully masked kv tiles skipped, optional segment
// ids, and a per-row lse = m + log(max(l, 1e-30)).
//
// Layout (the JAX package's, so no transposes on the host):
//   q [B, S, H, D], k/v [B, T, KH, D], o [B, S, H, D] (bf16, contiguous)
//   lse [B, S, H] fp32, seg [B, S] int32 or null (self-attention only)
//
// What bounds it on this card: at serving prefill shapes (S = 128..2048,
// D = 128) the two products per tile are 4*D flops per visible (q, k) pair
// against 2*D bytes of K/V per kv row, so the work sits above the H100's
// ~295 flop/byte ridge: it is bound by tensor-core throughput. This first
// design does the simple thing about that: both products run on tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate) instead of FMA, Q stays in
// registers for the whole kv walk, and the kv walk covers only the visible
// tiles. It does not yet use wgmma, TMA, a multi-stage copy pipeline or warp
// specialisation; each kv tile is loaded, then consumed, with the CTA
// synchronised in between.
//
// Grid: (ceil(S / 64), B * H). One CTA of 4 warps owns a 64-row q tile; each
// warp owns 16 rows and walks the kv tiles [first, bound) of its CTA (the
// tile math, fwd_tile, is shared with rdma_ring.cu in attn_tiles.cuh). K and V
// tiles (64 rows) are staged in shared memory, zero-filled past T, so the
// kernel never reads K/V beyond T and needs no padded copies on the host.
// Query rows past S are computed from zeros and never written.
//
// Numerics: scores are fp32 and scaled there (not in bf16 q). P is rounded to
// bf16 for the P.V product (the tensor-core input type); the row sum l is
// taken from the fp32 P before that rounding.

#include "attn_tiles.cuh"

namespace {

using namespace tiles;

enum MaskKind { kCausal = 0, kFull = 1, kPrefixLM = 2, kSlidingWindow = 3 };

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int S, int T,
                 int H, int KH, int kind, int window, int prefix,
                 float sm_scale) {
  constexpr int kLds = D + 8;  // padded smem row: conflict-free reads
  __shared__ __align__(16) bf16 ks[kBKV * kLds];
  __shared__ __align__(16) bf16 vs[kBKV * kLds];
  __shared__ int kseg[kBKV];

  const int qi = blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  int rows[2];
  rows[0] = qi * kBQ + warp * 16 + g;
  rows[1] = rows[0] + 8;

  // Q fragments, read once from global and held for the whole kv walk.
  const long q_stride = static_cast<long>(H) * D;
  const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  uint32_t qf[D / 16][4];
  load_row_frags<D>(qf, q + q_off, q_stride, rows, S);
  int qseg[2] = {-1, -1};
  if (seg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < S) qseg[r] = seg[static_cast<long>(b) * S + rows[r]];
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
      // A negative numerator truncates to 0 or below; either way clamps to 0.
      first = max((qi * kBQ - window + 1) / kBKV, 0);
    }
  }

  float acc[D / 8][4];
  zero<D>(acc);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const long kv_stride = static_cast<long>(KH) * D;
  const long kv_off = static_cast<long>(b) * T * kv_stride + static_cast<long>(kh) * D;
  for (int j = first; j < bound; ++j) {
    const int kv0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, kBKV>(ks, k + kv_off, kv_stride, kv0, T);
    load_tile<D, kBKV>(vs, v + kv_off, kv_stride, kv0, T);
    if (seg != nullptr && threadIdx.x < kBKV) {
      const int c = kv0 + threadIdx.x;
      kseg[threadIdx.x] = c < T ? seg[static_cast<long>(b) * T + c] : -1;
    }
    __syncthreads();
    fwd_tile<D>(qf, ks, vs, acc, m, l, sm_scale, [&](int r, int cl) {
      const int row = rows[r];
      const int col = kv0 + cl;
      bool ok = col < T;
      if (kind == kCausal) {
        ok = ok && row >= col;
      } else if (kind == kPrefixLM) {
        ok = ok && (row >= col || col < prefix);
      } else if (kind == kSlidingWindow) {
        ok = ok && row >= col && row - col < window;
      }
      if (seg != nullptr) ok = ok && qseg[r] == kseg[cl];
      return ok;
    });
  }

  store_fwd<D>(acc, m, l, rows, S, o + q_off, q_stride,
               lse + static_cast<long>(b) * S * H + h, H);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// kind: 0 causal, 1 full, 2 prefix_lm, 3 sliding_window. seg may be null.
extern "C" int tpk_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, void* o, void* lse, int B, int S,
                             int T, int H, int KH, int D, int kind, int window,
                             int prefix, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || kind < 0 || kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* sp = static_cast<const int*>(seg);
  auto* op = static_cast<bf16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, block, 0, st>>>(qp, kp, vp, sp, op, lp, S, T, H, KH,
                                                 kind, window, prefix, sm_scale);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, block, 0, st>>>(qp, kp, vp, sp, op, lp, S, T, H, KH,
                                                kind, window, prefix, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
