// Fused multi-head attention backward for Hopper (sm_90a), the gradient of
// csrc/mha_fwd.cu: out = softmax(Q K^T / sqrt(D) + bias) V, bias = -1e30 on
// padded keys.
//
// Replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_bwd_kernel and
// keeps its semantics: P is recomputed from q and k (nothing but q, k, v and
// the mask is saved by the forward), scores and softmax in f32,
//   dV = P^T dO  (P rounded to dO's dtype first),
//   dP = dO V^T,  dS = P (dP - rowsum(dP P))  (the row sum in f32, of the
//   unrounded P, as the TPU kernel takes it),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)  (dS rounded to Q's dtype),
// every product accumulated in f32 and the outputs in the input dtype.  The
// finite -1e30 bias keeps a fully padded row finite: its P is uniform, as in
// the forward.
//
// Three routes, chosen by dtype and S alone (ops/mha_bwd.py::route):
// - "fused", bf16 with S <= 128 (every training shape): one kernel, one block
//   per (batch row, head), one pass (mha_bwd_fused_kernel, below).
// - "long", bf16 with S > 128: a dq kernel and a dk/dv kernel on wgmma and
//   TMA, the statistics through a small f32 scratch (below).
// - "f32" (the --f32 training path): split TF32 on the tensor cores, in
//   csrc/mha_bwd_f32.cu.
//
// What bounds it on an H100: at the training shapes ([64, 8, 64, 64] dual,
// [64, 8, 80, 64] joint) the 10 B H S^2 D FLOPs (1.3-2.1 GFLOP) take 1.4-2.1
// us of bf16 tensor-core time against 29-37 MB of q, k, v, dO, dq, dk, dv
// (9-11 us): bound by bytes.  Nothing of size S^2 touches device memory.
//
// Layout: q, k, v, dout, dq, dk, dv are [B, H, S, D] contiguous; pad is
// [B, S] bytes (nonzero = padded key) or null.  Built by
// temporalalignnet_torch/ops/_build.py into a shared library with a plain C
// interface, called through ctypes.

#include "hopper.cuh"
#include <math.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BT = 64;         // queries or keys per tile
constexpr float MASK_BIAS = -1.0e30f;

// ------------------------------------------- bf16, S > 128: long, wgmma + TMA
//
// Past S = 128 a head's score rows no longer fit a block's registers, so the
// long route streams: two kernels, each a consumer warpgroup (128 threads)
// and a producer warp that keeps TMA loads in flight into a two-stage ring
// guarded by mbarriers (full: the tile landed; empty: the four consumer
// warps are done with it).  Tiles are [64 rows][64 D] bf16, 128-byte
// swizzled, loaded through 3-D tensor maps over [B H, S, D] (rows past S
// zero-filled, never the next head's), and every product is wgmma with f32
// accumulators.
//
// - mha_bwd_long_dq_kernel, a block per (64 queries, batch row, head): Q and
//   dO resident; the key tiles (K, V, and their keys' bias, which the
//   producer stages beside them) stream twice.  Sweep 0: S = Q K^T and dP =
//   dO V^T (A and B K-major), and per row an online max m, sum and sum of
//   e^s dP (the unrounded P's rowsum(dP P), in f32).  Sweep 1: the same two
//   products, P = e^(s - m) / sum, dS = P (dP - rowsum) from them in
//   registers, and dQ += dS K with dS, rounded to bf16, as the A operand from
//   registers (B = K read MN-major).  Each row's m, 1 / sum and rowsum(dP P)
//   go to a [B H, tiles, 3, 64] f32 scratch, kept apart (not folded into one
//   log-sum-exp: at -1e30 the sum's log would vanish in f32); rows past S get
//   1 / sum = 0, so their P is 0.
// - mha_bwd_long_dkdv_kernel, a block per (64 keys, batch row, head): K and
//   V resident; the query tiles (Q, dO and their rows' statistics) stream
//   once.  It computes the transposed products S^T = K Q^T and dP^T = V dO^T
//   (A and B K-major), so that P^T and dS^T come out in the accumulator
//   layout of the keys' rows and feed dV += P^T dO and dK += dS^T Q as the A
//   operand from registers (B = dO and Q read MN-major): no shared-memory
//   round trip of P or dS.  dK and dV stay in registers over the whole query
//   stream and are stored once, by TMA.
// The last tile of a stream takes its 16-row chunks up to the last row < S
// only (m64n16 products; NL, a template parameter of both kernels, so that
// no branch stands around a wgmma): S = 200 streams 208 keys, not 256.
// Nine products per (query, key) pair (dQ's two sweeps five, dK/dV's four).
// No atomics: every sum is taken in a fixed order, so two calls are
// bit-equal.
//
// What bounds it on an H100: bytes at [64, 8, 200, 64] (q, k, v, dO, dq, dk,
// dv, 78 MB with a ragged mask, 23 us at 3.35 TB/s, against 13 GFLOP of the
// five products the function needs, 13 us of bf16 tensor-core time).  What
// holds the kernels back is latency: each warpgroup's chain of products,
// exponentials and products within a tile.  The dq kernel runs 3 blocks an
// SM (the keys' bias comes from shared memory, not from 16 byte loads and
// registers a thread), the dk/dv kernel 2.  (Tried on an H100 and slower:
// A operands from registers for the first products, two consumer warpgroups
// sharing one stream, a third ring stage, and issuing the next tile's
// products before waiting on this one's last.)

namespace lng {

constexpr int TILE_BYTES = BT * 128;  // one [64][64] bf16 tile
constexpr int STAGES = 2;
constexpr int THREADS = 128 + 32;  // a consumer warpgroup and the producer warp
constexpr int STATS = 3 * BT;      // m, 1 / sum, rowsum(dP P) of a tile's rows

// shared memory of the dq kernel: Q | dO | STAGES x (K | V | the keys' bias,
// padded to 1024) | barriers
constexpr int DQ_RING = 2 * TILE_BYTES;
constexpr int DQ_BIAS = 2 * TILE_BYTES;  // offset of the bias in a stage
constexpr int DQ_STAGE = DQ_BIAS + 1024;
constexpr int DQ_BAR = DQ_RING + STAGES * DQ_STAGE;
constexpr int DQ_BYTES = DQ_BAR + (2 * STAGES + 1) * 8 + 1024;  // + room to align to 1024
// of the dk/dv kernel: K | V | STAGES x (Q | dO | the queries' statistics,
// padded to 1024) | barriers
constexpr int KV_RING = 2 * TILE_BYTES;
constexpr int KV_STATS = 2 * TILE_BYTES;  // offset of the statistics in a stage
constexpr int KV_STAGE = KV_STATS + 1024;
constexpr int KV_BAR = KV_RING + STAGES * KV_STAGE;
constexpr int KV_BYTES = KV_BAR + (2 * STAGES + 1) * 8 + 1024;
static_assert(STATS * 4 <= 1024 && BT * 4 <= 1024, "a stage's statistics and bias");

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (hopper::smem_addr(p) & 1023u)) & 1023u);
}

// key bias: 0 real, -1e30 padded, -inf past S
__device__ __forceinline__ float key_bias(const uint8_t* pb, int key, int S) {
  return key >= S ? -INFINITY : ((pb != nullptr && pb[key]) ? MASK_BIAS : 0.f);
}

// full[i], empty[i] (one arrival per consumer warp), and the resident tiles' barrier
__device__ __forceinline__ void init_barriers(uint64_t* bar) {
  using namespace hopper;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar[i], 1);
      mbar_init(&bar[STAGES + i], 4);
    }
    mbar_init(&bar[2 * STAGES], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  hopper::fence_regs(acc);
}

// acc += A B^T over D: A = the K-major [64][64] tile at shared address a, B =
// the rows of the K-major [64][64] tile at b, its 16-row chunks below NCH only
// (the rest of acc is left as it was); issued into the open commit group
template <int NCH>
__device__ __forceinline__ void rows_product(float (&acc)[32], uint32_t a, uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sw128_desc(a + kk * 32, 0);
    if constexpr (NCH == 4) {
      wgmma_ss_n64<0, 0>(acc, da, sw128_desc(b + kk * 32, 0));
    } else {
      wgmma_ss_n16_of64<0, 0, 0>(acc, da, sw128_desc(b + kk * 32, 0));
      if constexpr (NCH > 1) wgmma_ss_n16_of64<0, 0, 1>(acc, da, sw128_desc(b + 2048 + kk * 32, 0));
      if constexpr (NCH > 2) wgmma_ss_n16_of64<0, 0, 2>(acc, da, sw128_desc(b + 4096 + kk * 32, 0));
    }
  }
}

// the bf16 A fragments of the four 16-deep k-steps of a 64 x 64 accumulator
__device__ __forceinline__ void a_fragments(uint32_t (&af)[4][4], const float (&x)[32]) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) af[kk][i] = pack_bf16x2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// acc += A B, A = the fragments af over 64 rows of K, B = a [64 K][64 N] tile
// at shared address b read MN-major, its first NK k-steps; issued into the
// open commit group
template <int NK>
__device__ __forceinline__ void frag_product(float (&acc)[32], const uint32_t (&af)[4][4],
                                             uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) wgmma_rs_n64<1>(acc, af[kk], sw128_desc(b + kk * 2048, 0));
}

// the 64 x 64 accumulator x (times s) as bf16 into a swizzled tile at dst
__device__ __forceinline__ void stage_tile(uint8_t* dst, const float (&x)[32], float s, int warp,
                                           int g, int t) {
  using namespace hopper;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(dst + sw128_offset(16 * warp + g + 8 * h, 8 * j + 2 * t)) =
          pack_bf16x2(x[4 * j + 2 * h] * s, x[4 * j + 2 * h + 1] * s);
}

// accumulator register r of a 64 x 64 product: row 16 warp + g + 8 ((r >> 1) & 1),
// column 8 (r >> 2) + 2 t + (r & 1)
__device__ __forceinline__ int acc_col(int r, int t) { return 8 * (r >> 2) + 2 * t + (r & 1); }

// what a consumer thread of the dq kernel carries through the key stream
struct DqThread {
  uint32_t qa;  // the shared address of Q (dO follows)
  int t, lane;
  float scale2;
  // this thread's rows' online max (shared by the quad), its lanes' share of
  // the sum and of the sum of e^s dP; then 1 / sum and rowsum(dP P)
  float m[2], l[2], a[2], li[2], dl[2];
  float dq[32];
};

// one key tile of the dq kernel (NCH: its 16-key chunks holding a key < S;
// SWEEP1: dS and dQ, else the row statistics) at ring stage `ring` (K | V |
// bias), then released
template <int NCH, bool SWEEP1>
__device__ __forceinline__ void dq_tile(DqThread& th, const uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint32_t parity) {
  using namespace hopper;
  const uint32_t ka = smem_addr(ring);
  const float* bias = reinterpret_cast<const float*>(ring + DQ_BIAS);
  mbar_wait(full, parity);
  float sc[32], dp[32];
  zero(sc);
  zero(dp);
  wgmma_fence();
  rows_product<NCH>(sc, th.qa, ka);                            // S = Q K^T
  rows_product<NCH>(dp, th.qa + TILE_BYTES, ka + TILE_BYTES);  // dP = dO V^T
  wgmma_commit();
  float kb[16];  // the bias of this thread's 16 keys, while the tensor cores run
#pragma unroll
  for (int c = 0; c < 16; ++c) kb[c] = bias[8 * (c >> 1) + 2 * th.t + (c & 1)];
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  if constexpr (!SWEEP1) {
    float mx[2] = {th.m[0], th.m[1]};
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      sc[r] = fmaf(sc[r], th.scale2, kb[2 * (r >> 2) + (r & 1)]);
      mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // finite: the tile holds a key < S
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float corr = ex2(th.m[h] - mx[h]);
      th.l[h] *= corr;
      th.a[h] *= corr;
      th.m[h] = mx[h];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1;
      const float p = ex2(sc[r] - th.m[h]);
      th.l[h] += p;
      th.a[h] += p * dp[r];
    }
  } else {  // dS = P (dP - rowsum(dP P)), then dQ += dS K
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1;
      const float p =
          ex2(fmaf(sc[r], th.scale2, kb[2 * (r >> 2) + (r & 1)]) - th.m[h]) * th.li[h];
      dp[r] = p * (dp[r] - th.dl[h]);
    }
    uint32_t af[4][4];
    a_fragments(af, dp);
    wgmma_fence();
    frag_product<NCH>(th.dq, af, ka);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(th.dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
  }
  __syncwarp();
  if (th.lane == 0) mbar_arrive(empty);  // this warp is done with the stage
}

// grid (query tiles, B H); NL: the 16-key chunks of the last key tile
template <int NL>
__global__ void __launch_bounds__(THREADS, 3)
mha_bwd_long_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq, const uint8_t* __restrict__ pad,
                       float* __restrict__ stats, int H, int S, float scale, float scale2) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + DQ_BAR);  // full | empty | Q and dO
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * BT;
  const int nt = (S + BT - 1) / BT;
  init_barriers(bar);
  auto ring = [&](int n) { return sm + DQ_RING + (n % STAGES) * DQ_STAGE; };

  if (warp == 4) {  // the producer: Q and dO, then the key tiles and their bias twice
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar[2 * STAGES], 2 * TILE_BYTES);
      tma_load_3d(sm, &tq, &bar[2 * STAGES], 0, q0, bh);
      tma_load_3d(sm + TILE_BYTES, &tdo, &bar[2 * STAGES], 0, q0, bh);
    }
    const uint8_t* pb = pad != nullptr ? pad + size_t(bh / H) * S : nullptr;
    for (int n = 0; n < 2 * nt; ++n) {
      const int st = n % STAGES, k0 = (n % nt) * BT;
      mbar_wait(&bar[STAGES + st], (uint32_t(n / STAGES) & 1u) ^ 1u);
      if (lane == 0) {
        mbar_expect_tx(&bar[st], 2 * TILE_BYTES);
        tma_load_3d(ring(n), &tk, &bar[st], 0, k0, bh);
        tma_load_3d(ring(n) + TILE_BYTES, &tv, &bar[st], 0, k0, bh);
      }
      float* bias = reinterpret_cast<float*>(ring(n) + DQ_BIAS);
      for (int e = lane; e < BT; e += 32) bias[e] = key_bias(pb, k0 + e, S);
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[st]);
    }
    return;
  }

  DqThread th;
  th.qa = smem_addr(sm);
  th.t = t, th.lane = lane, th.scale2 = scale2;
#pragma unroll
  for (int h = 0; h < 2; ++h) th.m[h] = -INFINITY, th.l[h] = th.a[h] = 0.f;
  zero(th.dq);
  mbar_wait(&bar[2 * STAGES], 0);
  auto parity = [&](int n) { return uint32_t(n / STAGES) & 1u; };
  auto full = [&](int n) { return &bar[n % STAGES]; };
  auto empty = [&](int n) { return &bar[STAGES + n % STAGES]; };
  // sweep 0, the row statistics, online; the last key tile NL chunks wide
  int n = 0;
  for (; n < nt - 1; ++n) dq_tile<4, false>(th, ring(n), full(n), empty(n), parity(n));
  dq_tile<NL, false>(th, ring(n), full(n), empty(n), parity(n));
  ++n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    th.l[h] += __shfl_xor_sync(0xffffffffu, th.l[h], 1);
    th.l[h] += __shfl_xor_sync(0xffffffffu, th.l[h], 2);
    th.a[h] += __shfl_xor_sync(0xffffffffu, th.a[h], 1);
    th.a[h] += __shfl_xor_sync(0xffffffffu, th.a[h], 2);
    const int row = 16 * warp + g + 8 * h;
    th.li[h] = q0 + row < S ? 1.f / th.l[h] : 0.f;  // a row past S gets P = 0
    th.dl[h] = th.a[h] * th.li[h];
    if (t == 0) {
      float* o = stats + (size_t(bh) * nt + qt) * STATS + row;
      o[0] = th.m[h];
      o[BT] = th.li[h];
      o[2 * BT] = th.dl[h];
    }
  }
  // sweep 1: dS and dQ
  for (; n < 2 * nt - 1; ++n) dq_tile<4, true>(th, ring(n), full(n), empty(n), parity(n));
  dq_tile<NL, true>(th, ring(n), full(n), empty(n), parity(n));
  // dq as bf16 over the Q tile, which every product has read, stored by TMA
  // (rows past S are not written)
  named_barrier<1, 128>();
  stage_tile(sm, th.dq, scale, warp, g, t);
  fence_async_smem();
  named_barrier<1, 128>();
  if (threadIdx.x == 0) {
    tma_store_3d(&tdq, sm, 0, q0, bh);
    tma_store_commit_and_wait();
  }
}

// one query tile of the dk/dv kernel (NCH: its 16-query chunks holding a
// query < S) at ring stage qs (Q | dO | the queries' statistics), then released
template <int NCH>
__device__ __forceinline__ void dkdv_tile(float (&dk)[32], float (&dv)[32], uint32_t ka,
                                          const uint8_t* qs, const float (&kb)[2], float scale2,
                                          int t, int lane, uint64_t* full, uint64_t* empty,
                                          uint32_t parity) {
  using namespace hopper;
  const float* ms = reinterpret_cast<const float*>(qs + KV_STATS);
  const uint32_t qa = smem_addr(qs);
  mbar_wait(full, parity);
  float sc[32], dp[32];
  zero(sc);
  zero(dp);
  wgmma_fence();
  rows_product<NCH>(sc, ka, qa);                            // S^T = K Q^T
  rows_product<NCH>(dp, ka + TILE_BYTES, qa + TILE_BYTES);  // dP^T = V dO^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  // P^T and dS^T: register r is key row 16 warp + g + 8 ((r >> 1) & 1), query acc_col(r)
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int qc = acc_col(r, t);
    const float p = ex2(fmaf(sc[r], scale2, kb[(r >> 1) & 1]) - ms[qc]) * ms[BT + qc];
    sc[r] = p;
    dp[r] = p * (dp[r] - ms[2 * BT + qc]);
  }
  uint32_t ap[4][4], as[4][4];
  a_fragments(ap, sc);
  a_fragments(as, dp);
  wgmma_fence();
  frag_product<NCH>(dv, ap, qa + TILE_BYTES);  // dV += P^T dO
  frag_product<NCH>(dk, as, qa);               // dK += dS^T Q
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ap[kk]);
    fence_regs(as[kk]);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// grid (key tiles, B H); NL: the 16-query chunks of the last query tile
template <int NL>
__global__ void __launch_bounds__(THREADS, 2)
mha_bwd_long_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tdk,
                         const __grid_constant__ CUtensorMap tdv,
                         const uint8_t* __restrict__ pad, const float* __restrict__ stats, int H,
                         int S, float scale, float scale2) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + KV_BAR);  // full | empty | K and V
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.x, bh = blockIdx.y, k0 = kt * BT;
  const int nt = (S + BT - 1) / BT;
  init_barriers(bar);
  auto ring = [&](int n) { return sm + KV_RING + (n % STAGES) * KV_STAGE; };

  if (warp == 4) {  // the producer: K and V, then each query tile with its statistics
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar[2 * STAGES], 2 * TILE_BYTES);
      tma_load_3d(sm, &tk, &bar[2 * STAGES], 0, k0, bh);
      tma_load_3d(sm + TILE_BYTES, &tv, &bar[2 * STAGES], 0, k0, bh);
    }
    for (int n = 0; n < nt; ++n) {
      const int st = n % STAGES;
      mbar_wait(&bar[STAGES + st], (uint32_t(n / STAGES) & 1u) ^ 1u);
      if (lane == 0) {
        mbar_expect_tx(&bar[st], 2 * TILE_BYTES);
        tma_load_3d(ring(n), &tq, &bar[st], 0, n * BT, bh);
        tma_load_3d(ring(n) + TILE_BYTES, &tdo, &bar[st], 0, n * BT, bh);
      }
      const float* src = stats + (size_t(bh) * nt + n) * STATS;
      float* dst = reinterpret_cast<float*>(ring(n) + KV_STATS);
      for (int e = lane; e < STATS; e += 32) dst[e] = src[e];
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar[st]);
    }
    return;
  }

  const uint8_t* pb = pad != nullptr ? pad + size_t(bh / H) * S : nullptr;
  const float kb[2] = {key_bias(pb, k0 + 16 * warp + g, S), key_bias(pb, k0 + 16 * warp + g + 8, S)};
  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  mbar_wait(&bar[2 * STAGES], 0);
  const uint32_t ka = smem_addr(sm);
  auto parity = [&](int n) { return uint32_t(n / STAGES) & 1u; };
  int n = 0;
  for (; n < nt - 1; ++n)
    dkdv_tile<4>(dk, dv, ka, ring(n), kb, scale2, t, lane, &bar[n % STAGES],
                 &bar[STAGES + n % STAGES], parity(n));
  dkdv_tile<NL>(dk, dv, ka, ring(n), kb, scale2, t, lane, &bar[n % STAGES],
                &bar[STAGES + n % STAGES], parity(n));
  // dk, dv as bf16 over the K and V tiles, stored by TMA (keys past S are not written)
  named_barrier<1, 128>();
  stage_tile(sm, dk, scale, warp, g, t);
  stage_tile(sm + TILE_BYTES, dv, 1.f, warp, g, t);
  fence_async_smem();
  named_barrier<1, 128>();
  if (threadIdx.x == 0) {
    tma_store_3d(&tdk, sm, 0, k0, bh);
    tma_store_3d(&tdv, sm + TILE_BYTES, 0, k0, bh);
    tma_store_commit_and_wait();
  }
}

template <int NL>
cudaError_t launch_nl(const CUtensorMap* maps, const uint8_t* pad, float* stats, int BH, int H,
                      int S, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_long_dq_kernel<NL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_long_dkdv_kernel<NL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, KV_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid{unsigned((S + BT - 1) / BT), unsigned(BH)};
  const float scale = 1.0f / sqrtf(float(D)), scale2 = scale * 1.4426950408889634f;
  mha_bwd_long_dq_kernel<NL><<<grid, THREADS, DQ_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], pad, stats, H, S, scale, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_long_dkdv_kernel<NL><<<grid, THREADS, KV_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[5], maps[6], pad, stats, H, S, scale, scale2);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* pad, const void* dout,
                   void* dq, void* dk, void* dv, void* stats, int B, int H, int S,
                   cudaStream_t stream) {
  const int BH = B * H;
  const uint64_t dims[3] = {uint64_t(D), uint64_t(S), uint64_t(BH)};
  const uint64_t strides[2] = {uint64_t(D) * 2, uint64_t(S) * D * 2};
  const uint32_t box[3] = {uint32_t(D), uint32_t(BT), 1};
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  CUtensorMap maps[7];
  for (int i = 0; i < 7; ++i)
    if (!hopper::make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides,
                          box, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  const auto* pb = static_cast<const uint8_t*>(pad);
  auto* st = static_cast<float*>(stats);
  switch ((S - 1) % BT / 16 + 1) {  // the last tile's 16-row chunks
    case 1: return launch_nl<1>(maps, pb, st, BH, H, S, stream);
    case 2: return launch_nl<2>(maps, pb, st, BH, H, S, stream);
    case 3: return launch_nl<3>(maps, pb, st, BH, H, S, stream);
  }
  return launch_nl<4>(maps, pb, st, BH, H, S, stream);
}

}  // namespace lng

// ------------------------------------------- bf16, S <= 128: fused, wgmma + TMA
//
// The TPU kernel's own schedule: a block holds a whole head, so each score
// row is complete and the softmax exact, with no statistics scratch and no
// second sweep.  Five products instead of the long route's nine, each input
// read once.
//
// - TMA loads q, k, v, dO of the head into shared memory (3-D tensor maps
//   over [B H, S, D], 128-byte swizzle; rows past S, up to the tile, are
//   zero-filled, never the next head's rows) and stores dq, dk, dv the same
//   way (rows past S are not written).
// - One warpgroup per 64 query rows (one for S <= 64, two up to 128).  All
//   products are wgmma (f32 accumulate):
//     S  = Q K^T, dP = dO V^T   A, B K-major in shared memory, 16 keys a chunk
//     dQ = dS K                 A = dS from registers, B = K MN-major
//     dV = P^T dO, dK = dS^T Q  A = P, dS written as bf16 to shared "panels"
//                               (64 keys x the queries, read MN-major), B MN-major
//   For dV and dK warpgroup w owns keys 64 w .. +63, so the panels are the
//   one exchange between the warpgroups (one barrier).
// - Keys are computed in 16-wide chunks up to the last real key (NCH = S / 16
//   rounded up, a template parameter): S = 80 costs 80 keys, not 128.
//
// What bounds it on an H100: bytes (7 [S, D] tensors per head, ~30
// MB at the joint training shape against ~2 us of tensor-core work).  With
// every input read once and the stats scratch gone, the kernel moves only
// those bytes; what is left is the latency of one head's load -> five
// products -> store chain, hidden by running 2-4 blocks per SM.

namespace fused {

constexpr int TILE_BYTES = 64 * 128;  // one [64][64] bf16 tile

template <int NCH>
struct Plan {
  static constexpr int NWG = NCH > 4 ? 2 : 1;  // warpgroups: one per 64 query rows
  static constexpr int QR = 64 * NWG;          // rows of the Q and dO tiles
  static constexpr int KR = 16 * NCH;          // rows of the K and V tiles; rows of a panel
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + QR * 128;
  static constexpr int K_OFF = DO_OFF + QR * 128;
  static constexpr int V_OFF = K_OFF + KR * 128;
  static constexpr int P_OFF = V_OFF + KR * 128;           // NWG panels [KR queries][64 keys]
  static constexpr int DS_OFF = P_OFF + NWG * KR * 128;    // the same for dS
  static constexpr int BIAS_OFF = DS_OFF + NWG * KR * 128;  // [KR] f32 key bias
  static constexpr int BAR_OFF = BIAS_OFF + KR * 4;
  // dq, dk, dv staging of each warpgroup, over the inputs once they are read
  static constexpr int OUT_BYTES = 3 * NWG * TILE_BYTES;
  static_assert(OUT_BYTES <= BIAS_OFF, "staging must not reach the bias and the barrier");
  static constexpr int BYTES = BAR_OFF + 8 + 1024;  // + room to align the base to 1024
};

// blocks per SM the registers must allow: 4 of one warpgroup (S <= 64), 2 of
// two up to S = 96; S > 96 needs more than 128 registers a thread for its
// score rows, so one block
template <int NCH>
constexpr int min_blocks() {
  return NCH >= 7 ? 1 : (Plan<NCH>::NWG == 2 ? 2 : 4);
}

template <int NCH>
__global__ void __launch_bounds__(128 * Plan<NCH>::NWG, min_blocks<NCH>())
mha_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdq,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const uint8_t* __restrict__ pad,
                     int H, int S, float scale) {
  using P = Plan<NCH>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  float* bias = reinterpret_cast<float*>(sm + P::BIAS_OFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  const uint32_t base = smem_addr(sm);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, uint32_t(2 * P::QR + 2 * P::KR) * 128u);
    tma_load_3d(sm + P::Q_OFF, &tq, bar, 0, 0, bh);
    tma_load_3d(sm + P::DO_OFF, &tdo, bar, 0, 0, bh);
    tma_load_3d(sm + P::K_OFF, &tk, bar, 0, 0, bh);
    tma_load_3d(sm + P::V_OFF, &tv, bar, 0, 0, bh);
  }
  // key bias: 0 real, -1e30 padded, -inf past S
  for (int c = tid; c < P::KR; c += blockDim.x)
    bias[c] = c >= S ? -INFINITY : ((pad != nullptr && pad[size_t(b) * S + c]) ? MASK_BIAS : 0.f);
  __syncthreads();
  mbar_wait(bar, 0);

  // S = Q K^T and dP = dO V^T for this warpgroup's 64 query rows, 16 keys a chunk
  float sc[NCH][8], dp[NCH][8];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[j][e] = dp[j][e] = 0.f;
    fence_regs(sc[j]);
    fence_regs(dp[j]);
  }
  const uint32_t qa = base + P::Q_OFF + wg * TILE_BYTES, doa = base + P::DO_OFF + wg * TILE_BYTES;
  const uint32_t ka = base + P::K_OFF, va = base + P::V_OFF;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // D = 64: four 16-deep steps along the row
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      wgmma_ss_n16<0, 0>(sc[j], sw128_desc(qa + kk * 32, 0), sw128_desc(ka + j * 2048 + kk * 32, 0));
      wgmma_ss_n16<0, 0>(dp[j], sw128_desc(doa + kk * 32, 0), sw128_desc(va + j * 2048 + kk * 32, 0));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    fence_regs(sc[j]);
    fence_regs(dp[j]);
  }

  // exact softmax of whole rows; register e of chunk j: row g + 8 ((e >> 1) & 1),
  // key 16 j + 8 (e >> 2) + 2 t + (e & 1)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = sc[j][e] * scale + bias[16 * j + 8 * (e >> 2) + 2 * t + (e & 1)];
      sc[j][e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // finite: key 0 is real
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float p = expf(sc[j][e] - mx[(e >> 1) & 1]);
      sc[j][e] = p;
      sum[(e >> 1) & 1] += p;
    }
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sum[h] = 1.f / sum[h];
  }
  // P (unrounded, f32), then rowsum(dP P) of it; queries past S give nothing
  const int row0 = 64 * wg + 16 * warp + g;
  const bool live[2] = {row0 < S, row0 + 8 < S};
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int h = (e >> 1) & 1;
      const float p = live[h] ? sc[j][e] * sum[h] : 0.f;
      sc[j][e] = p;
      delta[h] += p * dp[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 1);
    delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 2);
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) dp[j][e] = sc[j][e] * (dp[j][e] - delta[(e >> 1) & 1]);  // dS

  // P and dS as bf16 into the panels (key chunks past the last one as zeros)
#pragma unroll
  for (int j = 0; j < 4 * P::NWG; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < P::KR) {
          const int e = 4 * hh + 2 * h;
          const int col = (j % 4) * 16 + 8 * hh + 2 * t;
          const uint32_t off = uint32_t(j / 4) * P::KR * 128 + sw128_offset(row, col);
          uint32_t pv = 0u, dv2 = 0u;
          if (j < NCH) {
            pv = pack_bf16x2(sc[j < NCH ? j : 0][e], sc[j < NCH ? j : 0][e + 1]);
            dv2 = pack_bf16x2(dp[j < NCH ? j : 0][e], dp[j < NCH ? j : 0][e + 1]);
          }
          *reinterpret_cast<uint32_t*>(sm + P::P_OFF + off) = pv;
          *reinterpret_cast<uint32_t*>(sm + P::DS_OFF + off) = dv2;
        }
      }
  fence_async_smem();

  // dQ = dS K, dS from registers (the same bf16 values as the panel); the
  // wgmma reads them asynchronously, so they stay live until its wait
  uint32_t af[NCH][4];
#pragma unroll
  for (int kk = 0; kk < NCH; ++kk) {
    af[kk][0] = pack_bf16x2(dp[kk][0], dp[kk][1]);
    af[kk][1] = pack_bf16x2(dp[kk][2], dp[kk][3]);
    af[kk][2] = pack_bf16x2(dp[kk][4], dp[kk][5]);
    af[kk][3] = pack_bf16x2(dp[kk][6], dp[kk][7]);
  }
  float dq[32], dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = dk[e] = dv[e] = 0.f;
  fence_regs(dq);
  fence_regs(dk);
  fence_regs(dv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NCH; ++kk) wgmma_rs_n64<1>(dq, af[kk], sw128_desc(ka + kk * 2048, 0));
  wgmma_commit();
  __syncthreads();  // both warpgroups' panels are written

  // dV = P^T dO and dK = dS^T Q for keys 64 wg .. +63, over the real queries
  const uint32_t pa = base + P::P_OFF + wg * P::KR * 128;
  const uint32_t dsa = base + P::DS_OFF + wg * P::KR * 128;
#pragma unroll
  for (int kk = 0; kk < NCH; ++kk) {
    wgmma_ss_n64<1, 1>(dv, sw128_desc(pa + kk * 2048, P::KR * 128),
                       sw128_desc(base + P::DO_OFF + kk * 2048, 0));
    wgmma_ss_n64<1, 1>(dk, sw128_desc(dsa + kk * 2048, P::KR * 128),
                       sw128_desc(base + P::Q_OFF + kk * 2048, 0));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(dk);
  fence_regs(dv);
#pragma unroll
  for (int kk = 0; kk < NCH; ++kk) fence_regs(af[kk]);
  __syncthreads();  // every read of the inputs and the panels is done

  // stage dq (this warpgroup's queries), dk, dv (its keys) as bf16 tiles and
  // store them with TMA
  uint8_t* out = sm + wg * TILE_BYTES;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = sw128_offset(16 * warp + g + 8 * h, 8 * j + 2 * t);
      const int e = 4 * j + 2 * h;
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16x2(dq[e] * scale, dq[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(out + P::NWG * TILE_BYTES + off) =
          pack_bf16x2(dk[e] * scale, dk[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(out + 2 * P::NWG * TILE_BYTES + off) =
          pack_bf16x2(dv[e], dv[e + 1]);
    }
  fence_async_smem();
  if (wg == 0)  // this warpgroup's staging is written (constant ids: one barrier each)
    named_barrier<1, 128>();
  else
    named_barrier<2, 128>();
  if (tid % 128 == 0) {
    tma_store_3d(&tdq, out, 0, 64 * wg, bh);
    tma_store_3d(&tdk, out + P::NWG * TILE_BYTES, 0, 64 * wg, bh);
    tma_store_3d(&tdv, out + 2 * P::NWG * TILE_BYTES, 0, 64 * wg, bh);
    tma_store_commit_and_wait();
  }
}

template <int NCH>
cudaError_t launch_nch(const CUtensorMap* maps, const uint8_t* pad, int BH, int H, int S,
                       cudaStream_t stream) {
  using P = Plan<NCH>;
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_fused_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  mha_bwd_fused_kernel<NCH><<<BH, 128 * P::NWG, P::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], pad, H, S,
      1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* pad, const void* dout,
                   void* dq, void* dk, void* dv, int B, int H, int S, cudaStream_t stream) {
  const int nch = (S + 15) / 16, nwg = nch > 4 ? 2 : 1;
  const int BH = B * H;
  const uint64_t dims[3] = {uint64_t(D), uint64_t(S), uint64_t(BH)};
  const uint64_t strides[2] = {uint64_t(D) * 2, uint64_t(S) * D * 2};
  const uint32_t box_q[3] = {uint32_t(D), uint32_t(64 * nwg), 1};
  const uint32_t box_k[3] = {uint32_t(D), uint32_t(16 * nch), 1};
  const uint32_t box_out[3] = {uint32_t(D), 64, 1};
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  const uint32_t* boxes[7] = {box_q, box_k, box_k, box_q, box_out, box_out, box_out};
  CUtensorMap maps[7];
  for (int i = 0; i < 7; ++i)
    if (!hopper::make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides,
                          boxes[i], CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  const auto* pb = static_cast<const uint8_t*>(pad);
  switch (nch) {
    case 1: return launch_nch<1>(maps, pb, BH, H, S, stream);
    case 2: return launch_nch<2>(maps, pb, BH, H, S, stream);
    case 3: return launch_nch<3>(maps, pb, BH, H, S, stream);
    case 4: return launch_nch<4>(maps, pb, BH, H, S, stream);
    case 5: return launch_nch<5>(maps, pb, BH, H, S, stream);
    case 6: return launch_nch<6>(maps, pb, BH, H, S, stream);
    case 7: return launch_nch<7>(maps, pb, BH, H, S, stream);
    case 8: return launch_nch<8>(maps, pb, BH, H, S, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fused

}  // namespace

// The long route: bf16 at any S (taken past S = 128), the dq and the dk/dv
// kernels.  stats: 3 x 64 x B H x ceil(S / 64) f32 of scratch.  Pointers
// 16-byte aligned (TMA).  Returns a cudaError_t (0 = launched).
extern "C" int mha_bwd_long(const void* q, const void* k, const void* v, const void* pad,
                            const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
                            int H, int S, int head_dim, void* stream) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != D || size_t(B) * H > 65535 || stats == nullptr)
    return int(cudaErrorInvalidValue);
  return int(lng::launch(q, k, v, pad, dout, dq, dk, dv, stats, B, H, S,
                         static_cast<cudaStream_t>(stream)));
}

// The fused route: bf16, S <= 128, no scratch.  Pointers 16-byte aligned
// (TMA).  Returns a cudaError_t (0 = launched).
extern "C" int mha_bwd_fused(const void* q, const void* k, const void* v, const void* pad,
                             const void* dout, void* dq, void* dk, void* dv, int B, int H, int S,
                             int head_dim, void* stream) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 0 || S > 128 || head_dim != D)
    return int(cudaErrorInvalidValue);
  return int(fused::launch(q, k, v, pad, dout, dq, dk, dv, B, H, S,
                           static_cast<cudaStream_t>(stream)));
}
