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
// handles to what travels: TMA tensor maps for the forward, pointers for the
// backward. A rank's kernel reads another rank's tensors only through that
// table: on one card every handle is local; across cards the same kernel
// takes peer addresses.
//
// Pull, not push. The TPU kernel pushes each K/V shard into its right-hand
// neighbour's VMEM, which holds two slots, and so needs slot-free acks for
// backpressure. Here every owner's shard stays in device memory for the
// whole launch and a rank reads it where it lies: no slots, no acks, no
// waiting on another rank (stream order makes every shard ready before any
// rank's launch starts; no launch waits on a flag another CTA writes, which
// would deadlock where those CTAs are not co-resident). The overlap that the
// TPU kernel gets from start()/wait_recv() comes from the copies running
// ahead of the products: the forward's TMA producer warp keeps two K/V tiles
// in flight, the backward double-buffers with cp.async.
//
// Order and causality. Rows are masked by global position (row me*s + r
// against col src*s + c), so a shard src < me is visible in full, src == me
// is the causal diagonal and src > me is masked in full. Pulling reads only
// what is visible: the forward and dq walk src = me, me-1, ..., 0 (the TPU
// kernel's ring order with the masked shards left out); dk/dv walk src = me,
// then n-1, n-2, ..., me+1. kv tiles within a shard go in increasing order.
// Skipping is exact: the diagonal shard comes first and every row sees its
// own position there, so its running max is finite after the first tile and
// a masked shard would only add exp(-1e30 - m) = 0.
//
// Layout (the JAX package's, per shard, so no transposes on the host):
//   q, dO, out, dq [B, s, H, D]; k, v, dk, dv [B, s, KH, D] (bf16,
//   contiguous); lse, delta [B, s, H] fp32. GQA by index: kv head h/(H/KH).
// Rows past s are never written; the forward's TMA zero-fills tiles past s,
// the backward's copies zero-fill them.
//
// What bounds them on this card: per visible (q, k) pair the forward does 4*D
// flops, dq 6*D and dk/dv 8*D, against 2*D bytes of K/V per kv row read by a
// q tile (forward, dq) or 4*D bytes of Q/dO per q row (dk/dv): far above the
// H100's ~295 flop/byte ridge at long context, so tensor-core throughput
// bounds all three. The forward runs attn_fwd_sm90.cuh's mainloop (a
// persistent, warp-specialised CTA per SM: wgmma fed by TMA through an
// mbarrier ring, 128-row q and kv tiles, heaviest q tiles first) over the
// ring walk below. The backward kernels share flash_bwd.cu's tile math in
// attn_tiles.cuh (mma.sync m16n8k16, 64x64 tiles, dk/dv in the transposed
// formulation over 32-row q tiles, no atomics). None balances the ranks: under
// the causal contiguous layout rank n-1 does about 2n-1 times rank 0's
// forward and dq work, and rank 0 that multiple of rank n-1's dk/dv work.

#include "attn_fwd_sm90.cuh"
#include "attn_tiles.cuh"

namespace {

using namespace tiles;

constexpr int kMaxRanks = 16;  // the largest ring a launch takes

// What travels around the ring: one pointer per rank, passed by value
// (__grid_constant__: indexed by a runtime rank in parameter space, with no
// per-thread copy).
struct KVRing {
  const bf16* k[kMaxRanks];
  const bf16* v[kMaxRanks];
};
struct QRing {
  const bf16* q[kMaxRanks];
  const bf16* dout[kMaxRanks];
  const float* lse[kMaxRanks];
  const float* delta[kMaxRanks];
};

// The kv tiles one q tile of rank `me` sees, in the TPU kernel's ring
// order: the diagonal shard up to the q tile's own kv tile (q and kv tiles
// of one size: 64 rows for dq, 128 for the forward), then every tile of
// src = me - 1, ..., 0.
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

// Shared memory of dq: two stages of a K and a V tile.
template <int D>
constexpr int kv_smem_bytes() {
  return 2 * 2 * kBKV * (D + 8) * 2;
}

// Copies walk step `it`'s K and V tiles into its stage (it & 1) and commits.
template <int D>
__device__ __forceinline__ void issue_kv(bf16* smem, const KVRing& ring,
                                         const KVWalk& walk, int it,
                                         long kv_off, long kv_stride, int s) {
  constexpr int kTile = kBKV * (D + 8);
  int src, j;
  walk.at(it, src, j);
  bf16* ks = smem + (it & 1) * 2 * kTile;
  load_tile_async<D, kBKV>(ks, ring.k[src] + kv_off, kv_stride, j * kBKV, s);
  load_tile_async<D, kBKV>(ks + kTile, ring.v[src] + kv_off, kv_stride, j * kBKV, s);
  cp_async_commit();
}

// The walk of dq over K/V tiles of the ring: step it + 1's
// copies fly while `tile(src, kv0, ks, vs)` computes step it. Two barriers
// a step: one after the step's copies landed, one before its stage refills.
template <int D, typename Tile>
__device__ __forceinline__ void walk_kv(bf16* smem, const KVRing& ring, int me,
                                        int qi, int b, int kh, int s, int KH,
                                        Tile tile) {
  constexpr int kTile = kBKV * (D + 8);
  const long kv_stride = static_cast<long>(KH) * D;
  const long kv_off = static_cast<long>(b) * s * kv_stride + static_cast<long>(kh) * D;
  const KVWalk walk{me, (s + kBKV - 1) / kBKV, qi + 1};
  const int n_tiles = walk.size();
  issue_kv<D>(smem, ring, walk, 0, kv_off, kv_stride, s);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue_kv<D>(smem, ring, walk, it + 1, kv_off, kv_stride, s);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of step `it` have landed
    int src, j;
    walk.at(it, src, j);
    const bf16* ks = smem + (it & 1) * 2 * kTile;
    tile(src, j * kBKV, ks, ks + kTile);
    __syncthreads();  // readers of stage it & 1 are done before its refill
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rdma_bwd_dq_kernel(const bf16* __restrict__ q, const __grid_constant__ KVRing ring,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int me, int s, int H, int KH, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qi = blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  int rows[2];
  rows[0] = qi * kBQ + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  rows[1] = rows[0] + 8;

  // Q and dO fragments and the row stats, read once and held for the walk.
  const long q_stride = static_cast<long>(H) * D;
  const long q_off = static_cast<long>(b) * s * q_stride + static_cast<long>(h) * D;
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_row_frags<D>(qf, q + q_off, q_stride, rows, s);
  load_row_frags<D>(df, dout + q_off, q_stride, rows, s);
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < s) {
      const long idx = (static_cast<long>(b) * s + rows[r]) * H + h;
      row_lse[r] = lse[idx];
      row_delta[r] = delta[idx];
    }
  }
  float acc[D / 8][4];
  zero<D>(acc);

  walk_kv<D>(reinterpret_cast<bf16*>(smem_raw), ring, me, qi, b, h / (H / KH), s, KH,
             [&](int src, int kv0, const bf16* ks, const bf16* vs) {
               const bool diag = src == me;
               dq_tile<D>(qf, df, ks, vs, acc, row_lse, row_delta, sm_scale,
                          [&](int r, int cl) {
                            const int col = kv0 + cl;
                            return rows[r] < s && col < s && (!diag || rows[r] >= col);
                          });
             });

  store_rows<D>(acc, dq + q_off, q_stride, rows, s, sm_scale);
}

// The q tiles one 64-row kv tile of rank `me` sees: on the diagonal shard
// from the kv tile's own rows on, then every q tile of src = n-1, ..., me+1
// (the TPU kernel's ring order with the masked shards left out); within a
// shard, the GQA group's heads one after the other.
struct QWalk {
  int me, n, group, num_q, first_diag;
  __device__ int diag_steps() const { return group * (num_q - first_diag); }
  __device__ int size() const { return diag_steps() + (n - 1 - me) * group * num_q; }
  __device__ void at(int it, int& src, int& gq, int& qt) const {
    const int nd = num_q - first_diag;
    if (it < diag_steps()) {
      src = me;
      gq = it / nd;
      qt = first_diag + it % nd;
      return;
    }
    const int u = it - diag_steps();
    const int per_src = group * num_q;
    src = n - 1 - u / per_src;
    gq = (u % per_src) / num_q;
    qt = u % num_q;
  }
};

// dk/dv shared memory: the resident K and V tiles, then two stages of a Q
// and a dO tile, then two stages of the tile's lse and delta.
template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBKV + 2 * 2 * kBQT) * (D + 8) * 2 + 2 * 2 * kBQT * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rdma_bwd_dkv_kernel(const __grid_constant__ QRing ring, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n_ranks, int me, int s, int H,
                    int KH, float sm_scale) {
  constexpr int kLds = D + 8;
  constexpr int kQTile = kBQT * kLds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBKV * kLds;
  bf16* qstage = vs + kBKV * kLds;  // [2][Q | dO][kBQT][kLds]
  float* stat = reinterpret_cast<float*>(qstage + 2 * 2 * kQTile);  // [2][lse | delta][kBQT]

  const int b = blockIdx.y / KH;
  const int kh = blockIdx.y % KH;
  const int group = H / KH;
  const int kv0 = blockIdx.x * kBKV;
  int cols[2];  // the shard-local kv rows of this thread's accumulator rows
  cols[0] = kv0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  cols[1] = cols[0] + 8;

  const long kv_stride = static_cast<long>(KH) * D;
  const long kv_off = static_cast<long>(b) * s * kv_stride + static_cast<long>(kh) * D;
  load_tile_async<D, kBKV>(ks, k + kv_off, kv_stride, kv0, s);
  load_tile_async<D, kBKV>(vs, v + kv_off, kv_stride, kv0, s);
  cp_async_commit();

  const QWalk walk{me, n_ranks, group, (s + kBQT - 1) / kBQT, kv0 / kBQT};
  const int n_tiles = walk.size();
  const long q_stride = static_cast<long>(H) * D;
  // Copies walk step `it`'s Q, dO, lse and delta into its stage and commits.
  auto issue = [&](int it) {
    int src, gq, qt;
    walk.at(it, src, gq, qt);
    const int h = kh * group + gq;
    const int q0 = qt * kBQT;
    const long q_off = static_cast<long>(b) * s * q_stride + static_cast<long>(h) * D;
    bf16* qs = qstage + (it & 1) * 2 * kQTile;
    load_tile_async<D, kBQT>(qs, ring.q[src] + q_off, q_stride, q0, s);
    load_tile_async<D, kBQT>(qs + kQTile, ring.dout[src] + q_off, q_stride, q0, s);
    if (threadIdx.x < 2 * kBQT) {
      const int which = threadIdx.x / kBQT;  // 0: lse, 1: delta
      const int rl = threadIdx.x % kBQT;
      const float* base = which == 0 ? ring.lse[src] : ring.delta[src];
      const bool ok = q0 + rl < s;
      cp_async4(stat + ((it & 1) * 2 + which) * kBQT + rl,
                ok ? base + (static_cast<long>(b) * s + q0 + rl) * H + h : base, ok);
    }
    cp_async_commit();
  };
  issue(0);

  float dka[D / 8][4], dva[D / 8][4];
  zero<D>(dka);
  zero<D>(dva);

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait<1>();  // the resident tiles and step `it` have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int src, gq, qt;
    walk.at(it, src, gq, qt);
    const bool diag = src == me;
    const int q0 = qt * kBQT;
    const bf16* qs = qstage + (it & 1) * 2 * kQTile;
    const float* lse_s = stat + (it & 1) * 2 * kBQT;
    dkv_tile<D>(ks, vs, qs, qs + kQTile, lse_s, lse_s + kBQT, dka, dva, sm_scale,
                [&](int r, int rl) {
                  const int row = q0 + rl;
                  return row < s && cols[r] < s && (!diag || row >= cols[r]);
                });
    __syncthreads();  // readers of stage it & 1 are done before its refill
  }

  // q carried no scale in S^T's product: dk = scale * dS^T Q.
  store_rows<D>(dka, dk + kv_off, kv_stride, cols, s, sm_scale);
  store_rows<D>(dva, dv + kv_off, kv_stride, cols, s, 1.f);
}

bool bad_ring(int n, int me, int B, int s, int H, int KH) {
  return n < 1 || n > kMaxRanks || me < 0 || me >= n || B <= 0 || s <= 0 || KH <= 0 ||
         H % KH != 0;
}

// Fills a ring table from a host array of n pointers; false if one is null.
template <typename T>
bool fill(const T* (&dst)[kMaxRanks], const void* const* src, int n) {
  for (int r = 0; r < kMaxRanks; ++r) dst[r] = nullptr;
  for (int r = 0; r < n; ++r) {
    if (src[r] == nullptr) return false;
    dst[r] = static_cast<const T*>(src[r]);
  }
  return true;
}

// Above 48 KB of shared memory only as dynamic shared memory, after raising
// the kernel's limit (per device; cheap to repeat).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The forward: rank me's q tile of 128 rows against the ring's K/V shards
// through a table of TMA maps, one K and one V map per rank.
struct FwdParams {
  CUtensorMap q;
  CUtensorMap k[kMaxRanks];
  CUtensorMap v[kMaxRanks];
  bf16* o;
  float* lse;
  int me, B, s, H, KH;
  float scale_log2;
};
// The table is passed by value (__grid_constant__, read in place): past the
// classic 4 KB of kernel parameters, within the 32,764 bytes that CUDA 12.1
// and later allow on sm_90.
static_assert(sizeof(FwdParams) <= 32764, "kernel parameters past the sm_90 limit");

// KVWalk at the forward's 128-row tiles, with the global-position mask: the
// diagonal shard is causal, earlier shards visible in full, columns past s
// never.
struct RingWalk {
  const FwdParams& p;
  KVWalk walk;

  __device__ int size() const { return walk.size(); }
  __device__ fwd90::Tile tile(int it) const {
    int src, j;
    walk.at(it, src, j);
    return {&p.k[src], &p.v[src], j * fwd90::kBN, src == p.me};
  }
  __device__ bool keyed() const { return false; }
  __device__ int row_key(int) const { return 0; }
  __device__ int col_key(const fwd90::Tile&, int) const { return 0; }
  __device__ bool masked(const fwd90::Tile& t, int row_lo, int) const {
    const int c_hi = t.kv0 + fwd90::kBN - 1;
    return c_hi >= p.s || (t.diag && c_hi > row_lo);
  }
  __device__ void range(const fwd90::Tile& t, int row, int& lo, int& hi) const {
    lo = 0;
    hi = t.diag ? min(row, p.s - 1) : p.s - 1;
  }
};

// The ring walk of q tile qi: the diagonal shard up to the tile itself.
struct MakeRingWalk {
  const FwdParams& p;

  __device__ RingWalk operator()(int qi, int) const {
    static_assert(fwd90::kBM == fwd90::kBN, "the diagonal walk needs square tiles");
    return {p, KVWalk{p.me, (p.s + fwd90::kBN - 1) / fwd90::kBN, qi + 1}};
  }
};

template <int D>
__global__ void __launch_bounds__(fwd90::kThreads, 1)
rdma_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem[];
  fwd90::attn_fwd<D>(smem, &p.q, fwd90::Jobs{p.B, p.s, p.H, p.KH}, MakeRingWalk{p}, p.o,
                     p.lse, p.scale_log2);
}

template <int D>
int launch_dq(const bf16* q, const KVRing& ring, const bf16* dout, const float* lse,
              const float* delta, bf16* dq, int me, int B, int s, int H, int KH,
              float sm_scale, cudaStream_t st) {
  constexpr int smem = kv_smem_bytes<D>();
  cudaError_t err = allow_smem(rdma_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, B * H);
  rdma_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(q, ring, dout, lse, delta, dq, me, s,
                                                      H, KH, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const QRing& ring, const bf16* k, const bf16* v, bf16* dk, bf16* dv, int n,
               int me, int B, int s, int H, int KH, float sm_scale, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(rdma_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBKV - 1) / kBKV, B * KH);
  rdma_bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(ring, k, v, dk, dv, n, me, s, H, KH,
                                                       sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches rank `me`'s kernel of an n-rank ring on `stream`
// and returns cudaGetLastError() after the launch (0 = ok). The *_ring
// arguments are host arrays of n device pointers, one per rank, indexed by
// rank; the other pointers are rank me's own shards. s is the shard length.

extern "C" int tpk_rdma_fwd(const void* q, const void* const* k_ring,
                            const void* const* v_ring, void* o, void* lse, int n,
                            int me, int B, int s, int H, int KH, int D,
                            float sm_scale, void* stream) {
  if (bad_ring(n, me, B, s, H, KH) || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  if (!fwd90::encode_bshd(&p.q, q, B, s, H, D, fwd90::kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < kMaxRanks; ++r) {  // unused ranks stay zero
    p.k[r] = CUtensorMap{};
    p.v[r] = CUtensorMap{};
  }
  for (int r = 0; r < n; ++r) {
    if (k_ring[r] == nullptr || v_ring[r] == nullptr ||
        !fwd90::encode_bshd(&p.k[r], k_ring[r], B, s, KH, D, fwd90::kBN) ||
        !fwd90::encode_bshd(&p.v[r], v_ring[r], B, s, KH, D, fwd90::kBN))
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  KVRing ring;
  if (bad_ring(n, me, B, s, H, KH) || !fill(ring.k, k_ring, n) || !fill(ring.v, v_ring, n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* dop = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  auto* out = static_cast<bf16*>(dq);
  if (D == 128)
    return launch_dq<128>(qp, ring, dop, lp, dp, out, me, B, s, H, KH, sm_scale, st);
  if (D == 64)
    return launch_dq<64>(qp, ring, dop, lp, dp, out, me, B, s, H, KH, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tpk_rdma_bwd_dkv(const void* const* q_ring, const void* const* do_ring,
                                const void* const* lse_ring,
                                const void* const* delta_ring, const void* k,
                                const void* v, void* dk, void* dv, int n, int me, int B,
                                int s, int H, int KH, int D, float sm_scale,
                                void* stream) {
  QRing ring;
  if (bad_ring(n, me, B, s, H, KH) || !fill(ring.q, q_ring, n) ||
      !fill(ring.dout, do_ring, n) || !fill(ring.lse, lse_ring, n) ||
      !fill(ring.delta, delta_ring, n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* dkp = static_cast<bf16*>(dk);
  auto* dvp = static_cast<bf16*>(dv);
  if (D == 128)
    return launch_dkv<128>(ring, kp, vp, dkp, dvp, n, me, B, s, H, KH, sm_scale, st);
  if (D == 64)
    return launch_dkv<64>(ring, kp, vp, dkp, dvp, n, me, B, s, H, KH, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
