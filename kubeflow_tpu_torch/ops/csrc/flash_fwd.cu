// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (launched by _flash_fwd): blockwise online-softmax attention with fp32
// accumulators, scale 1/sqrt(D), the finite -1e30 mask, GQA without copies,
// the four mask kinds with fully masked kv tiles skipped, optional segment
// ids, and a per-row lse = m + log(max(l, 1e-30)).
//
// What bounds it on this card: the two products do 4*D flops per visible
// (q, k) pair against 2*D bytes of K/V per kv row read by each 128-row q
// tile, about 256 flop/byte at D 128 and more as the q tile's own bytes
// amortise over longer walks: at or above the H100's ~295 flop/byte ridge,
// so tensor-core throughput bounds it. What the design does about that is
// attn_fwd_sm90.cuh's mainloop (a persistent, warp-specialised CTA per SM:
// wgmma fed by TMA through an mbarrier ring, S of one tile issued with P V
// of the last, exp2 softmax in registers); this file gives it the walk: the
// visible kv tiles [first, bound) of one K/V tensor under the mask kind,
// which of them cross a mask edge or T, each row's interval of visible
// columns there, and the segment ids.
//
// Layout (the JAX package's, so no transposes on the host):
//   q [B, S, H, D], k/v [B, T, KH, D], o [B, S, H, D] (bf16, contiguous)
//   lse [B, S, H] fp32, seg [B, S] int32 or null (self-attention only)
// Grid: one persistent CTA per SM taking the B * H * ceil(S / 128) q tiles
// in turn, those with the longest causal walks first.

#include "attn_fwd_sm90.cuh"

namespace {

using fwd90::Tile;
using fwd90::bf16;
using fwd90::kBM;
using fwd90::kBN;

enum MaskKind { kCausal = 0, kFull = 1, kPrefixLM = 2, kSlidingWindow = 3 };

struct Params {
  CUtensorMap q, k, v;
  const int* seg;
  bf16* o;
  float* lse;
  int B, S, T, H, KH, kind, window, prefix;
  float scale_log2;
};

// The kv tiles [first, first + size()) of one q tile, as _q_visible
// computes them at this kernel's tiles, and the mask.
struct FlashWalk {
  const Params& p;
  const int* seg;  // batch row b of the segment ids, or null
  int first, bound;

  __device__ int size() const { return bound > first ? bound - first : 0; }
  __device__ Tile tile(int it) const { return {&p.k, &p.v, (first + it) * kBN, false}; }
  __device__ bool keyed() const { return seg != nullptr; }
  __device__ int row_key(int row) const {
    return seg != nullptr && row < p.S ? seg[row] : -1;
  }
  __device__ int col_key(const Tile&, int col) const { return col < p.T ? seg[col] : -2; }
  __device__ bool masked(const Tile& t, int row_lo, int row_hi) const {
    const int c_lo = t.kv0, c_hi = t.kv0 + kBN - 1;
    if (seg != nullptr || c_hi >= p.T) return true;
    switch (p.kind) {
      case kCausal: return c_hi > row_lo;
      case kPrefixLM: return c_hi > row_lo && c_hi >= p.prefix;
      case kSlidingWindow: return c_hi > row_lo || row_hi - c_lo >= p.window;
      default: return false;
    }
  }
  // The columns a row sees: below T, and causal (up to the row), prefix-LM
  // (up to the row or the prefix's end) or a sliding window (the `window`
  // keys up to the row).
  __device__ void range(const Tile&, int row, int& lo, int& hi) const {
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

// The walk of q tile qi of batch row b.
struct MakeFlashWalk {
  const Params& p;

  __device__ FlashWalk operator()(int qi, int b) const {
    // Visible kv tiles, as _q_visible computes them, at this kernel's tiles.
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

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem[];
  fwd90::attn_fwd<D>(smem, &p.q, fwd90::Jobs{p.B, p.S, p.H, p.KH}, MakeFlashWalk{p}, p.o,
                     p.lse, p.scale_log2);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue for arguments the kernel does not take (and for a
// tensor map that cannot be encoded). kind: 0 causal, 1 full, 2 prefix_lm, 3
// sliding_window. seg may be null.
extern "C" int tpk_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, void* o, void* lse, int B, int S,
                             int T, int H, int KH, int D, int kind, int window,
                             int prefix, float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || kind < 0 || kind > 3 ||
      (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  if (!fwd90::encode_bshd(&p.q, q, B, S, H, D, kBM) ||
      !fwd90::encode_bshd(&p.k, k, B, T, KH, D, kBN) ||
      !fwd90::encode_bshd(&p.v, v, B, T, KH, D, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  p.seg = static_cast<const int*>(seg);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KH = KH;
  p.kind = kind;
  p.window = window;
  p.prefix = prefix;
  p.scale_log2 = sm_scale * fwd90::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_tiles = (S + kBM - 1) / kBM * B * H;
  if (D == 128) return fwd90::launch<flash_fwd_kernel<128>, fwd90::Smem<128>::kBytes>(p, q_tiles, st);
  return fwd90::launch<flash_fwd_kernel<64>, fwd90::Smem<64>::kBytes>(p, q_tiles, st);
}
