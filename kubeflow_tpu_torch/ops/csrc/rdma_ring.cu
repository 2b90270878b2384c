// Context-parallel (ring) causal attention for Hopper (sm_90a): the forward,
// then the two-pass backward (dq, then dk/dv). bf16 in, fp32 softmax and
// accumulation, the softmax recomputed from the forward's saved lse.
//
// Replaces the TPU kernels of kubeflow_tpu/ops/rdma_ring_attention.py:
//   * tpk_rdma_fwd     <- _rdma_kernel: the resident q shard against every
//     K/V shard it can see, online-softmax partials carried across shards,
//     out and lse = m + log(max(l, 1e-30)) per row;
//   * tpk_rdma_bwd_dq  <- _rdma_bwd_dq_kernel: K/V travel, the resident dq
//     accumulates dS K from the saved lse and delta;
//   * tpk_rdma_bwd_dkv <- _rdma_bwd_dkv_kernel: q, dO, lse and delta
//     travel, the resident dk/dv accumulate dS^T Q and P^T dO.
// delta = rowsum(dO * O) is plain tensor arithmetic outside the kernels, as
// the JAX package computes it at the lax level.
//
// The ring. The sequence is cut into n contiguous shards of s rows, one per
// rank; rank `me` holds rows [me*s, (me+1)*s) of q, k, v (and dO, lse,
// delta) in tensors of its own. Each entry point is launched once per rank
// and gets that rank's resident shard plus a by-value table of n per-rank
// handles to what travels: TMA tensor maps of K and V (forward, dq) or of q
// and dO with pointers to lse and delta (dk/dv). A rank's kernel reads
// another rank's tensors only through that table: on one card every handle
// is local; across cards the same kernel takes peer addresses.
//
// Pull, not push. The TPU kernel pushes each shard into its right-hand
// neighbour's VMEM, which holds two slots, and so needs slot-free acks for
// backpressure. Here every owner's shard stays in device memory for the
// whole launch and a rank reads it where it lies: no slots, no acks, no
// waiting on another rank (stream order makes every shard ready before any
// rank's launch starts; no launch waits on a flag another CTA writes, which
// would deadlock where those CTAs are not co-resident). The overlap that the
// TPU kernel gets from start()/wait_recv() comes from the producer warp's
// TMA copies running ahead of the products through the stage ring.
//
// Order and causality. Rows are masked by global position (row me*s + r
// against col src*s + c), so a shard src < me is visible in full, src == me
// is the causal diagonal and src > me is masked in full. Pulling reads only
// what is visible: the forward and dq walk src = me, me-1, ..., 0 (the TPU
// kernel's ring order with the masked shards left out); dk/dv walk src = me,
// then n-1, n-2, ..., me+1. Tiles within a shard go in increasing order.
// Skipping is exact: the diagonal shard comes first and every row sees its
// own position there, so the forward's running max is finite after the
// first tile and a masked shard would only add exp(-1e30 - m) = 0.
//
// Layout (the JAX package's, per shard, so no transposes on the host):
//   q, dO, out, dq [B, s, H, D]; k, v, dk, dv [B, s, KH, D] (bf16,
//   contiguous); lse, delta [B, s, H] fp32. GQA by index: kv head h/(H/KH).
// TMA's zero fill stands in for tiles past s; rows past s are never written.
//
// What bounds them on this card: per visible (q, k) pair the forward does 4*D
// flops, dq 6*D and dk/dv 8*D, against 2*D bytes of K/V per kv row read by a
// q tile (forward, dq) or 4*D bytes of Q/dO per q row (dk/dv): far above the
// H100's ~295 flop/byte ridge at long context, so tensor-core throughput
// bounds all three. So all three run the Hopper mainloops of flash
// attention over the ring walks below: the forward attn_fwd_sm90.cuh's, the
// backward attn_bwd_sm90.cuh's (a persistent, warp-specialised CTA per SM:
// wgmma fed by TMA through an mbarrier ring, 128-row jobs heaviest first,
// streamed tiles of 128 rows in the forward and 64 in the backward; dk/dv
// sums the GQA group's heads without atomics). A walk step names the rank
// it reads through a pointer into the table, which stays in parameter
// space (__grid_constant__). None balances the ranks: under the causal
// contiguous layout rank n-1 does about 2n-1 times rank 0's forward and dq
// work, and rank 0 that multiple of rank n-1's dk/dv work.

#include "attn_bwd_sm90.cuh"

namespace {

using fwd90::bf16;

constexpr int kMaxRanks = 16;  // the largest ring a launch takes

// The kv tiles one q tile of rank `me` sees, in the TPU kernel's ring
// order: the diagonal shard up to the last kv tile the q tile reaches, then
// every tile of src = me - 1, ..., 0.
struct KVWalk {
  int me, num_kv, diag_tiles;
  __device__ int size() const { return diag_tiles + me * num_kv; }
  __device__ void at(int it, int& src, int& j) const {
    if (it < diag_tiles) {
      src = me;
      j = it;
      return;
    }
    const int u = it - diag_tiles;
    src = me - 1 - u / num_kv;
    j = u % num_kv;
  }
};

// The forward: rank me's q tile of 128 rows against the ring's K/V shards
// through a table of TMA maps (128-row boxes), one K and one V map per rank.
struct FwdParams {
  CUtensorMap q;
  CUtensorMap k[kMaxRanks];
  CUtensorMap v[kMaxRanks];
  bf16* o;
  float* lse;
  int me, B, s, H, KH;
  float scale_log2;
};
// The tables are passed by value (__grid_constant__, read in place): past the
// classic 4 KB of kernel parameters, within the 32,764 bytes that CUDA 12.1
// and later allow on sm_90.
static_assert(sizeof(FwdParams) <= 32764, "kernel parameters past the sm_90 limit");

// dq: rank me's Q and dO (128-row boxes), lse and delta, against the ring's
// K/V shards (64-row boxes).
struct DqParams {
  CUtensorMap q, dout;
  CUtensorMap k[kMaxRanks];
  CUtensorMap v[kMaxRanks];
  const float* lse;
  const float* delta;
  bf16* dq;
  int me, B, s, H, KH;
  float scale, scale_log2;
};
static_assert(sizeof(DqParams) <= 32764, "kernel parameters past the sm_90 limit");

// dk/dv: rank me's K and V (128-row boxes) against the ring's q and dO
// shards (64-row boxes) and their lse and delta.
struct DkvParams {
  CUtensorMap k, v;
  CUtensorMap q[kMaxRanks];
  CUtensorMap dout[kMaxRanks];
  const float* lse[kMaxRanks];
  const float* delta[kMaxRanks];
  bf16* dk;
  bf16* dv;
  int n, me, B, s, H, KH;
  float scale, scale_log2;
};
static_assert(sizeof(DkvParams) <= 32764, "kernel parameters past the sm_90 limit");

// KVWalk at kRows-row kv tiles (the forward's 128, dq's 64) with the
// global-position mask: the diagonal shard is causal, earlier shards
// visible in full, columns past s never.
template <typename Params, int kRows>
struct RingWalk {
  const Params& p;
  KVWalk walk;

  __device__ int size() const { return walk.size(); }
  __device__ fwd90::Tile tile(int it) const {
    int src, j;
    walk.at(it, src, j);
    return {&p.k[src], &p.v[src], j * kRows, src == p.me};
  }
  __device__ bool keyed() const { return false; }
  __device__ int row_key(int) const { return 0; }
  __device__ int col_key(const fwd90::Tile&, int) const { return 0; }
  __device__ bool masked(const fwd90::Tile& t, int row_lo, int) const {
    const int c_hi = t.kv0 + kRows - 1;
    return c_hi >= p.s || (t.diag && c_hi > row_lo);
  }
  __device__ void range(const fwd90::Tile& t, int row, int& lo, int& hi) const {
    lo = 0;
    hi = t.diag ? min(row, p.s - 1) : p.s - 1;
  }
};

// The ring walk of q tile qi: the diagonal shard up to the tile itself.
template <typename Params, int kRows>
struct MakeRingWalk {
  const Params& p;

  __device__ RingWalk<Params, kRows> operator()(int qi, int) const {
    static_assert(fwd90::kBM % kRows == 0, "a q tile spans whole kv tiles");
    const int num_kv = (p.s + kRows - 1) / kRows;
    return {p, KVWalk{p.me, num_kv, min((qi + 1) * (fwd90::kBM / kRows), num_kv)}};
  }
};

// The 64-row q tiles that see one 128-row kv tile of rank `me`: on the
// diagonal shard from the kv tile's own rows on, then every q tile of
// src = n-1, ..., me+1 (the TPU kernel's ring order with the masked shards
// left out); within a shard, the GQA group's heads one after the other. A
// step is on the diagonal if it reads rank me's own q map.
struct RingQWalk {
  const DkvParams& p;
  int kh, group, num_q, first_diag;

  __device__ int diag_steps() const { return group * (num_q - first_diag); }
  __device__ int size() const { return diag_steps() + (p.n - 1 - p.me) * group * num_q; }
  __device__ bwd90::QStep step(int it) const {
    int src, gq, qt;
    if (it < diag_steps()) {
      const int nd = num_q - first_diag;
      src = p.me;
      gq = it / nd;
      qt = first_diag + it % nd;
    } else {
      const int u = it - diag_steps();
      const int per_src = group * num_q;
      src = p.n - 1 - u / per_src;
      gq = (u % per_src) / num_q;
      qt = u % num_q;
    }
    return {&p.q[src], &p.dout[src], p.lse[src], p.delta[src], qt * bwd90::kBN,
            kh * group + gq};
  }
  __device__ bool diag(const bwd90::QStep& st) const { return st.q == &p.q[p.me]; }
  __device__ bool keyed() const { return false; }
  __device__ int row_key(int) const { return 0; }
  __device__ int col_key(const bwd90::QStep&, int) const { return 0; }
  __device__ bool masked(const bwd90::QStep& st, int, int kv_hi) const {
    return st.q0 + bwd90::kBN - 1 >= p.s || (diag(st) && st.q0 < kv_hi);
  }
  // The q rows [lo, hi] that see kv row kv: from kv on, on the diagonal.
  __device__ void range(const bwd90::QStep& st, int kv, int& lo, int& hi) const {
    lo = diag(st) ? kv : 0;
    hi = p.s - 1;
  }
};

struct MakeRingQWalk {
  const DkvParams& p;

  __device__ RingQWalk operator()(int kt, int, int kh) const {
    return {p, kh, p.H / p.KH, (p.s + bwd90::kBN - 1) / bwd90::kBN,
            kt * (bwd90::kBM / bwd90::kBN)};
  }
};

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
rdma_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem[];
  fwd90::attn_fwd<D>(smem, &p.q, fwd90::Jobs{p.B, p.s, p.H, p.KH},
                     MakeRingWalk<FwdParams, fwd90::kBN>{p}, p.o, p.lse, p.scale_log2);
}

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
rdma_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  extern __shared__ unsigned char smem[];
  bwd90::attn_bwd_dq<D>(smem, &p.q, &p.dout, fwd90::Jobs{p.B, p.s, p.H, p.KH},
                        MakeRingWalk<DqParams, bwd90::kBN>{p}, p.lse, p.delta, p.dq,
                        p.scale_log2, p.scale);
}

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
rdma_bwd_dkv_kernel(const __grid_constant__ DkvParams p) {
  extern __shared__ unsigned char smem[];
  bwd90::attn_bwd_dkv<D>(smem, &p.k, &p.v, bwd90::KvJobs{p.B, p.s, p.KH}, MakeRingQWalk{p},
                         p.s, p.H, p.dk, p.dv, p.scale_log2, p.scale);
}

bool bad_ring(int n, int me, int B, int s, int H, int KH, int D) {
  return n < 1 || n > kMaxRanks || me < 0 || me >= n || B <= 0 || s <= 0 || KH <= 0 ||
         H % KH != 0 || (D != 64 && D != 128);
}

// The map of one shard [B, s, heads, D] with box_rows-row boxes; false for
// a null pointer or a map that cannot be encoded.
bool encode(CUtensorMap* map, const void* ptr, int B, int s, int heads, int D, int box_rows) {
  return ptr != nullptr && fwd90::encode_bshd(map, ptr, B, s, heads, D, box_rows);
}

// The maps of a table from a host array of n shard pointers; the unused
// ranks stay zero.
bool encode_ring(CUtensorMap (&maps)[kMaxRanks], const void* const* ptrs, int n, int B, int s,
                 int heads, int D, int box_rows) {
  for (int r = 0; r < kMaxRanks; ++r) maps[r] = CUtensorMap{};
  for (int r = 0; r < n; ++r)
    if (!encode(&maps[r], ptrs[r], B, s, heads, D, box_rows)) return false;
  return true;
}

// Fills a table of n pointers from a host array; false if one is null.
template <typename T>
bool fill(const T* (&dst)[kMaxRanks], const void* const* src, int n) {
  for (int r = 0; r < kMaxRanks; ++r) dst[r] = nullptr;
  for (int r = 0; r < n; ++r) {
    if (src[r] == nullptr) return false;
    dst[r] = static_cast<const T*>(src[r]);
  }
  return true;
}

}  // namespace

// Each entry point launches rank `me`'s kernel of an n-rank ring on `stream`
// and returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for arguments the kernels do not take. The *_ring
// arguments are host arrays of n device pointers, one per rank, indexed by
// rank; the other pointers are rank me's own shards. s is the shard length.

extern "C" int tpk_rdma_fwd(const void* q, const void* const* k_ring,
                            const void* const* v_ring, void* o, void* lse, int n,
                            int me, int B, int s, int H, int KH, int D,
                            float sm_scale, void* stream) {
  FwdParams p;
  if (bad_ring(n, me, B, s, H, KH, D) || !encode(&p.q, q, B, s, H, D, fwd90::kBM) ||
      !encode_ring(p.k, k_ring, n, B, s, KH, D, fwd90::kBN) ||
      !encode_ring(p.v, v_ring, n, B, s, KH, D, fwd90::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.me = me;
  p.B = B;
  p.s = s;
  p.H = H;
  p.KH = KH;
  p.scale_log2 = sm_scale * fwd90::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_tiles = (s + fwd90::kBM - 1) / fwd90::kBM * B * H;
  if (D == 128) return fwd90::launch<rdma_fwd_kernel<128>, fwd90::Smem<128>::kBytes>(p, q_tiles, st);
  return fwd90::launch<rdma_fwd_kernel<64>, fwd90::Smem<64>::kBytes>(p, q_tiles, st);
}

extern "C" int tpk_rdma_bwd_dq(const void* q, const void* const* k_ring,
                               const void* const* v_ring, const void* dout,
                               const void* lse, const void* delta, void* dq, int n,
                               int me, int B, int s, int H, int KH, int D,
                               float sm_scale, void* stream) {
  DqParams p;
  if (bad_ring(n, me, B, s, H, KH, D) || lse == nullptr || delta == nullptr ||
      !encode(&p.q, q, B, s, H, D, bwd90::kBM) || !encode(&p.dout, dout, B, s, H, D, bwd90::kBM) ||
      !encode_ring(p.k, k_ring, n, B, s, KH, D, bwd90::kBN) ||
      !encode_ring(p.v, v_ring, n, B, s, KH, D, bwd90::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.me = me;
  p.B = B;
  p.s = s;
  p.H = H;
  p.KH = KH;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * fwd90::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int jobs = (s + bwd90::kBM - 1) / bwd90::kBM * B * H;
  if (D == 128)
    return fwd90::launch<rdma_bwd_dq_kernel<128>, bwd90::DqSmem<128>::kBytes>(p, jobs, st);
  return fwd90::launch<rdma_bwd_dq_kernel<64>, bwd90::DqSmem<64>::kBytes>(p, jobs, st);
}

extern "C" int tpk_rdma_bwd_dkv(const void* const* q_ring, const void* const* do_ring,
                                const void* const* lse_ring,
                                const void* const* delta_ring, const void* k,
                                const void* v, void* dk, void* dv, int n, int me, int B,
                                int s, int H, int KH, int D, float sm_scale,
                                void* stream) {
  DkvParams p;
  if (bad_ring(n, me, B, s, H, KH, D) || !encode(&p.k, k, B, s, KH, D, bwd90::kBM) ||
      !encode(&p.v, v, B, s, KH, D, bwd90::kBM) ||
      !encode_ring(p.q, q_ring, n, B, s, H, D, bwd90::kBN) ||
      !encode_ring(p.dout, do_ring, n, B, s, H, D, bwd90::kBN) ||
      !fill(p.lse, lse_ring, n) || !fill(p.delta, delta_ring, n))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.n = n;
  p.me = me;
  p.B = B;
  p.s = s;
  p.H = H;
  p.KH = KH;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * fwd90::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int jobs = (s + bwd90::kBM - 1) / bwd90::kBM * B * KH;
  if (D == 128)
    return fwd90::launch<rdma_bwd_dkv_kernel<128>, bwd90::DkvSmem<128>::kBytes>(p, jobs, st);
  return fwd90::launch<rdma_bwd_dkv_kernel<64>, bwd90::DkvSmem<64>::kBytes>(p, jobs, st);
}
