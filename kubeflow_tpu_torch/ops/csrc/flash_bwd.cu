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
// The per-tile math (dq_tile, dkv_tile) is shared with rdma_ring.cu in
// attn_tiles.cuh. Registers are the constraint that shaped it. dk/dv keeps a warp's 16 kv
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

#include "attn_tiles.cuh"

namespace {

using namespace tiles;

enum MaskKind { kCausal = 0, kFull = 1, kPrefixLM = 2, kSlidingWindow = 3 };

__device__ __forceinline__ bool visible(int row, int col, int kind, int window,
                                        int prefix) {
  if (kind == kCausal) return row >= col;
  if (kind == kPrefixLM) return row >= col || col < prefix;
  if (kind == kSlidingWindow) return row >= col && row - col < window;
  return true;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, bf16* __restrict__ dq, int S,
                    int T, int H, int KH, int kind, int window, int prefix,
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

  // Q and dO fragments, read once from global and held for the whole walk.
  const long q_stride = static_cast<long>(H) * D;
  const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_row_frags<D>(qf, q + q_off, q_stride, rows, S);
  load_row_frags<D>(df, dout + q_off, q_stride, rows, S);
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

  float acc[D / 8][4];
  zero<D>(acc);

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
    dq_tile<D>(qf, df, ks, vs, acc, row_lse, row_delta, sm_scale, [&](int r, int cl) {
      const int row = rows[r];
      const int col = kv0 + cl;
      bool ok = row < S && col < T && visible(row, col, kind, window, prefix);
      if (seg != nullptr) ok = ok && qseg[r] == kseg[cl];
      return ok;
    });
  }

  store_rows<D>(acc, dq + q_off, q_stride, rows, S, sm_scale);
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBKV + 2 * kBQT) * (D + 8) * 2 + 3 * kBQT * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int T, int H, int KH,
                     int kind, int window, int prefix, float sm_scale) {
  constexpr int kLds = D + 8;
  // K, V tiles (resident), Q, dO tiles (per step), lse, delta, q segments.
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBKV * kLds;
  bf16* qs = vs + kBKV * kLds;
  bf16* dos = qs + kBQT * kLds;
  float* lse_s = reinterpret_cast<float*>(dos + kBQT * kLds);
  float* delta_s = lse_s + kBQT;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kBQT);

  const int j = blockIdx.x;
  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const int group = H / KH;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int kv0 = j * kBKV;
  int cols[2];  // the kv rows of this thread's accumulator rows
  cols[0] = kv0 + warp * 16 + g;
  cols[1] = cols[0] + 8;

  const long kv_stride = static_cast<long>(KH) * D;
  const long kv_off = static_cast<long>(b) * T * kv_stride + static_cast<long>(kh) * D;
  load_tile<D, kBKV>(ks, k + kv_off, kv_stride, kv0, T);
  load_tile<D, kBKV>(vs, v + kv_off, kv_stride, kv0, T);
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

  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);

  const long q_stride = static_cast<long>(H) * D;
  for (int gq = 0; gq < group; ++gq) {
    const int h = kh * group + gq;
    const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    for (int qt = first; qt < bound; ++qt) {
      const int q0 = qt * kBQT;
      __syncthreads();  // the previous tile's readers are done
      load_tile<D, kBQT>(qs, q + q_off, q_stride, q0, S);
      load_tile<D, kBQT>(dos, dout + q_off, q_stride, q0, S);
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
      dkv_tile<D>(ks, vs, qs, dos, lse_s, delta_s, dka, dva, sm_scale, [&](int r, int rl) {
        const int col = cols[r];
        const int row = q0 + rl;
        bool ok = row < S && col < T && visible(row, col, kind, window, prefix);
        if (seg != nullptr) ok = ok && qseg_s[rl] == kseg[r];
        return ok;
      });
    }
  }

  // q carried no scale in S^T's product: dk = scale * dS^T Q.
  store_rows<D>(dka, dk + kv_off, kv_stride, cols, T, sm_scale);
  store_rows<D>(dva, dv + kv_off, kv_stride, cols, T, 1.f);
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v,
               const bf16* dout, const float* lse, const float* delta,
               const int* seg, bf16* dk, bf16* dv, int B, int S,
               int T, int H, int KH, int kind, int window, int prefix, float sm_scale,
               cudaStream_t st) {
  // Above 48 KB of shared memory only as dynamic shared memory, after
  // raising the kernel's limit (per device; cheap to repeat).
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBKV - 1) / kBKV, B * KH);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
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
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* sp = static_cast<const int*>(seg);
  auto* out = static_cast<bf16*>(dq);
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
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  const auto* sp = static_cast<const int*>(seg);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  if (D == 128)
    return launch_dkv<128>(qp, kp, vp, dop, lp, dp, sp, dkp, dvp, B, S, T, H, KH, kind,
                           window, prefix, sm_scale, st);
  if (D == 64)
    return launch_dkv<64>(qp, kp, vp, dop, lp, dp, sp, dkp, dvp, B, S, T, H, KH, kind,
                          window, prefix, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
