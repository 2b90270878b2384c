// Flash-attention backward for Hopper (sm_90a): dq, then dk/dv. bf16 in,
// fp32 accumulation, the softmax recomputed from the forward's saved lse.
//
// Replaces the TPU kernels of kubeflow_tpu/ops/flash_attention.py, launched
// by _flash_bwd_impl:
//   * tpk_flash_bwd_dq  <- _flash_bwd_dq_kernel: each 128-row q tile walks
//     the kv tiles _q_visible says it can see, recomputes S = Q K^T and
//     dP = dO V^T, forms dS = P * (dP - delta) with P = exp(S * scale -
//     lse), and accumulates dq = dS K in fp32; sm_scale is applied once at
//     the end.
//   * tpk_flash_bwd_dkv <- _flash_bwd_dkv_kernel: each 128-row kv tile
//     loops over the GQA group's q heads and the q tiles _kv_visible says
//     see it, and accumulates dk = dS^T (Q * scale) and dv = P^T dO in fp32.
//     Each CTA owns its dk/dv rows outright: no atomics, no second reduction
//     pass, as in the JAX kernel.
// delta = rowsum(dO * O) - g_lse is plain tensor arithmetic outside the
// kernels, as it is in JAX (flash_attention.py computes it in PyTorch).
//
// What bounds them on this card: per visible (q, k) pair dq does three
// products (6*D flops) and dk/dv four (8*D) against a few bytes per row:
// far above the H100's ~295 flop/byte ridge, so tensor-core throughput
// bounds both. What the design does about that is attn_bwd_sm90.cuh's
// mainloops (a persistent, warp-specialised CTA per SM: wgmma fed by TMA
// through an mbarrier ring, the products' operands in 128-byte swizzled
// shared memory); this file gives them their walks: the visible tiles under
// the mask kind, which of them cross a mask edge, S or T, each row's
// interval of visible columns there, and the segment ids.
//
// Layout (the JAX package's, so no transposes or pads on the host):
//   q, do, dq [B, S, H, D]; k, v, dk, dv [B, T, KH, D] (bf16, contiguous)
//   lse, delta [B, S, H] fp32; seg [B, S] int32 or null (self-attention)
// Rows past S (dq) and T (dk, dv) are never written.

#include "attn_bwd_sm90.cuh"

namespace {

using bwd90::kBM;
using bwd90::kBN;
using fwd90::bf16;

enum MaskKind { kCausal = 0, kFull = 1, kPrefixLM = 2, kSlidingWindow = 3 };

struct Params {
  CUtensorMap q, dout, k, v;  // dq: q, dout 128-row boxes, k, v 64; dk/dv the reverse
  const float* lse;
  const float* delta;
  const int* seg;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, T, H, KH, kind, window, prefix;
  float scale, scale_log2;
};

// The 64-row kv tiles [first, bound) of one 128-row q tile, as _q_visible
// computes them at these tiles, and the mask (the forward's FlashWalk at
// the backward's tiles).
struct QWalk {
  const Params& p;
  const int* seg;  // batch row b of the segment ids, or null
  int first, bound;

  __device__ int size() const { return bound > first ? bound - first : 0; }
  __device__ fwd90::Tile tile(int it) const { return {&p.k, &p.v, (first + it) * kBN, false}; }
  __device__ bool keyed() const { return seg != nullptr; }
  __device__ int row_key(int row) const {
    return seg != nullptr && row < p.S ? seg[row] : -1;
  }
  __device__ int col_key(const fwd90::Tile&, int col) const { return col < p.T ? seg[col] : -2; }
  __device__ bool masked(const fwd90::Tile& t, int row_lo, int row_hi) const {
    const int c_lo = t.kv0, c_hi = t.kv0 + kBN - 1;
    if (seg != nullptr || c_hi >= p.T) return true;
    switch (p.kind) {
      case kCausal: return c_hi > row_lo;
      case kPrefixLM: return c_hi > row_lo && c_hi >= p.prefix;
      case kSlidingWindow: return c_hi > row_lo || row_hi - c_lo >= p.window;
      default: return false;
    }
  }
  // The columns a row sees: below T, and causal, prefix-LM or a window.
  __device__ void range(const fwd90::Tile&, int row, int& lo, int& hi) const {
    lo = 0;
    hi = p.T - 1;
    if (p.kind == kCausal) {
      hi = min(hi, row);
    } else if (p.kind == kPrefixLM) {
      hi = min(hi, max(row, p.prefix - 1));
    } else if (p.kind == kSlidingWindow) {
      hi = min(hi, row);
      lo = row - p.window + 1;
    }
  }
};

struct MakeQWalk {
  const Params& p;

  __device__ QWalk operator()(int qi, int b) const {
    const int num_kv = (p.T + kBN - 1) / kBN;
    int first = 0, bound = num_kv;
    if (p.kind != kFull) {
      const int last = (qi + 1) * kBM - 1;
      const int causal_bound = min(last / kBN + 1, num_kv);
      bound = causal_bound;
      if (p.kind == kPrefixLM) {
        const int prefix_bound =
            (qi * kBM < p.prefix) ? min((p.prefix + kBN - 1) / kBN, num_kv) : 0;
        bound = max(causal_bound, prefix_bound);
      } else if (p.kind == kSlidingWindow) {
        // A negative numerator truncates to 0 or below; either way clamps to 0.
        first = max((qi * kBM - p.window + 1) / kBN, 0);
      }
    }
    return {p, p.seg == nullptr ? nullptr : p.seg + static_cast<long>(b) * p.S, first, bound};
  }
};

// The 64-row q tiles that see one 128-row kv tile, as _kv_visible computes
// them at these tiles, for each q head of the GQA group in turn: step it is
// q tile first + it % nq of group head it / nq. Each kv row sees one
// interval of q rows under every mask kind.
struct KvWalk {
  const Params& p;
  const int* seg;  // batch row b of the segment ids, or null
  int kh, first, nq;

  __device__ int size() const { return nq * (p.H / p.KH); }
  __device__ bwd90::QStep step(int it) const {
    return {&p.q, &p.dout, p.lse, p.delta, (first + it % nq) * kBN,
            kh * (p.H / p.KH) + it / nq};
  }
  __device__ bool keyed() const { return seg != nullptr; }
  __device__ int row_key(int kv) const {
    return seg != nullptr && kv < p.T ? seg[kv] : -1;
  }
  __device__ int col_key(const bwd90::QStep&, int q) const { return q < p.S ? seg[q] : -2; }
  // Whether some pair of kv rows [kv_lo, kv_hi] x the step's q rows is not
  // visible.
  __device__ bool masked(const bwd90::QStep& s, int kv_lo, int kv_hi) const {
    const int c_lo = s.q0, c_hi = s.q0 + kBN - 1;
    if (seg != nullptr || c_hi >= p.S) return true;
    switch (p.kind) {
      case kCausal: return c_lo < kv_hi;
      case kPrefixLM: return c_lo < kv_hi && kv_hi >= p.prefix;
      case kSlidingWindow: return c_lo < kv_hi || c_hi - kv_lo >= p.window;
      default: return false;
    }
  }
  // The q rows [lo, hi] that see kv row kv: below S, and from kv on
  // (causal; prefix-LM past the prefix), up to kv + window - 1 (window).
  __device__ void range(const bwd90::QStep&, int kv, int& lo, int& hi) const {
    lo = 0;
    hi = p.S - 1;
    if (p.kind == kCausal || p.kind == kSlidingWindow || (p.kind == kPrefixLM && kv >= p.prefix))
      lo = kv;
    if (p.kind == kSlidingWindow) hi = min(hi, kv + p.window - 1);
  }
};

struct MakeKvWalk {
  const Params& p;

  __device__ KvWalk operator()(int kt, int b, int kh) const {
    const int num_q = (p.S + kBN - 1) / kBN;
    const int kv0 = kt * kBM;
    int first = 0, bound = num_q;
    if (p.kind != kFull) {
      const int causal_first = min(kv0 / kBN, num_q);
      first = causal_first;
      if (p.kind == kPrefixLM) {
        first = kv0 < p.prefix ? 0 : causal_first;
      } else if (p.kind == kSlidingWindow) {
        bound = min((kv0 + kBM - 1 + p.window - 1) / kBN + 1, num_q);
      }
    }
    return {p, p.seg == nullptr ? nullptr : p.seg + static_cast<long>(b) * p.S, kh, first,
            bound > first ? bound - first : 0};
  }
};

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem[];
  bwd90::attn_bwd_dq<D>(smem, &p.q, &p.dout, fwd90::Jobs{p.B, p.S, p.H, p.KH}, MakeQWalk{p},
                        p.lse, p.delta, p.dq, p.scale_log2, p.scale);
}

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem[];
  bwd90::attn_bwd_dkv<D>(smem, &p.k, &p.v, bwd90::KvJobs{p.B, p.T, p.KH}, MakeKvWalk{p}, p.S,
                         p.H, p.dk, p.dv, p.scale_log2, p.scale);
}

// The shared arguments, and the four maps with `q_rows`-row boxes for q and
// dO and `kv_rows`-row boxes for k and v. False for arguments the kernels
// do not take (and for a map that cannot be encoded).
bool make_params(Params& p, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* seg, int B, int S, int T,
                 int H, int KH, int D, int kind, int window, int prefix, float sm_scale,
                 int q_rows, int kv_rows) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || kind < 0 || kind > 3 ||
      (D != 64 && D != 128))
    return false;
  if (!fwd90::encode_bshd(&p.q, q, B, S, H, D, q_rows) ||
      !fwd90::encode_bshd(&p.dout, dout, B, S, H, D, q_rows) ||
      !fwd90::encode_bshd(&p.k, k, B, T, KH, D, kv_rows) ||
      !fwd90::encode_bshd(&p.v, v, B, T, KH, D, kv_rows))
    return false;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg = static_cast<const int*>(seg);
  p.dq = p.dk = p.dv = nullptr;
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.kind = kind;
  p.window = window;
  p.prefix = prefix;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * fwd90::kLog2e;
  return true;
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 = ok), or cudaErrorInvalidValue for arguments the kernels do not take.
// kind: 0 causal, 1 full, 2 prefix_lm, 3 sliding_window. seg may be null.
// lse and delta are [B, S, H] fp32.
extern "C" int tpk_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg, void* dq,
                                int B, int S, int T, int H, int KH, int D,
                                int kind, int window, int prefix,
                                float sm_scale, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, seg, B, S, T, H, KH, D, kind, window, prefix,
                   sm_scale, kBM, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dq = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int jobs = (S + kBM - 1) / kBM * B * H;
  if (D == 128)
    return fwd90::launch<flash_bwd_dq_kernel<128>, bwd90::DqSmem<128>::kBytes>(p, jobs, st);
  return fwd90::launch<flash_bwd_dq_kernel<64>, bwd90::DqSmem<64>::kBytes>(p, jobs, st);
}

extern "C" int tpk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seg, void* dk,
                                 void* dv, int B, int S, int T, int H, int KH,
                                 int D, int kind, int window, int prefix,
                                 float sm_scale, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, seg, B, S, T, H, KH, D, kind, window, prefix,
                   sm_scale, kBN, kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int jobs = (T + kBM - 1) / kBM * B * KH;
  if (D == 128)
    return fwd90::launch<flash_bwd_dkv_kernel<128>, bwd90::DkvSmem<128>::kBytes>(p, jobs, st);
  return fwd90::launch<flash_bwd_dkv_kernel<64>, bwd90::DkvSmem<64>::kBytes>(p, jobs, st);
}
