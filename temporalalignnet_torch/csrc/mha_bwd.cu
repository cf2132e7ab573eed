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
// - "v2", bf16 with S > 128: two kernels on mma.sync (FlashAttention-2 shape,
//   any S).  dq: a block owns (batch row, head, a run of queries) and streams
//   the keys twice: first an online (max, sum, sum of e^s dP) recurrence
//   gives each row's max m, 1 / sum and rowsum(dP P); then dS and dQ.  m,
//   1 / sum and the row sum go to a [3, B H S] scratch, kept apart (not
//   folded into one log-sum-exp), because at -1e30 the sum's log would
//   vanish in f32.  dkdv: a block owns (batch row, head, a run of keys) and
//   streams the queries, recomputing P from the saved m and 1 / sum.
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
#include "mma.cuh"

namespace {

constexpr int D = 64;          // head dim
constexpr int BT = 64;         // queries or keys per tile
constexpr float MASK_BIAS = -1.0e30f;

// key bias of keys [k0, k0 + BT): 0 real, -1e30 padded, -inf past S
__device__ __forceinline__ void stage_bias(float* bias, const uint8_t* pad, int b, int k0,
                                           int S) {
  for (int j = threadIdx.x; j < BT; j += blockDim.x) {
    const int key = k0 + j;
    bias[j] = key >= S ? -INFINITY
                       : ((pad != nullptr && pad[size_t(b) * S + key]) ? MASK_BIAS : 0.f);
  }
}

// ------------------------------------------------------- bf16: tensor cores
//
// One warp per 16 queries (dq) or 16 keys (dk, dv); up to S = 128 a block
// holds all of a head's rows, longer S takes 64-row blocks.  The streamed
// tiles (keys and values, or queries and dO) are double buffered in shared
// memory by cp.async.  Every product is mma.sync m16n8k16 (f32 accumulate);
// the score, dP, P and dS fragments never leave registers: a C fragment pair
// is the A fragment of the next product (mma.cuh), rounded to bf16 there as
// the TPU kernel rounds P and dS.  Entries are computed in 16-wide chunks up
// to the last real row, so S = 80 costs 80 rows, not 128.

constexpr int TC_MAX_WARPS = 8;
constexpr int LDB = D + 8;  // padded rows: ldmatrix rows hit distinct banks

// rows [n0, n0 + 64) of a [S, D] bf16 head into dst[64][LDB], zero past S
__device__ __forceinline__ void tc_stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int n0,
                                         int S) {
  for (int e = threadIdx.x; e < BT * (D / 8); e += blockDim.x) {
    const int j = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool in = n0 + j < S;
    cp_async_16(dst + j * LDB + c, src + size_t(in ? n0 + j : 0) * D + c, in);
  }
}

// the A fragments of 16 rows (r0 = row g, r1 = row g + 8) over D, zero past S
__device__ __forceinline__ void tc_rows(uint32_t f[D / 16][4], const __nv_bfloat16* src, int r0,
                                        int r1, int S, int t) {
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const int c = s * 16 + 2 * t;
    f[s][0] = r0 < S ? ld_pair(src + size_t(r0) * D + c) : 0u;
    f[s][1] = r1 < S ? ld_pair(src + size_t(r1) * D + c) : 0u;
    f[s][2] = r0 < S ? ld_pair(src + size_t(r0) * D + c + 8) : 0u;
    f[s][3] = r1 < S ? ld_pair(src + size_t(r1) * D + c + 8) : 0u;
  }
}

// acc[n] (+)= A . tile^T for the 8-wide column chunks n < 2 chunks of a
// staged [64][LDB] tile, over the D dims
__device__ __forceinline__ void tc_dot(float acc[8][4], const uint32_t a[D / 16][4],
                                       const __nv_bfloat16* tile, int chunks, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (n / 2 < chunks) {
#pragma unroll
      for (int s = 0; s < D / 16; s += 2) {
        uint32_t r[4];
        ldsm_x4(r, &tile[(n * 8 + (lane & 7)) * LDB + (s + (lane >> 4)) * 16 +
                         ((lane >> 3) & 1) * 8]);
        mma_16816(acc[n], a[s], r[0], r[1]);
        mma_16816(acc[n], a[s + 1], r[2], r[3]);
      }
    }
  }
}

// out[c] += X . tile over 16-row chunks kc < chunks, X given as C fragments
// x[8][4] (rounded to bf16 here), tile [64 rows][LDB] read transposed
__device__ __forceinline__ void tc_acc(float out[D / 8][4], const float x[8][4],
                                       const __nv_bfloat16* tile, int chunks, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (kc < chunks) {
      const uint32_t xa[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                              pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                              pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                              pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
      for (int c = 0; c < D / 8; c += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, &tile[(kc * 16 + (lane & 15)) * LDB + (c + (lane >> 4)) * 8]);
        mma_16816(out[c], xa, r[0], r[1]);
        mma_16816(out[c + 1], xa, r[2], r[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
mha_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ pad,
                       const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ stats, int H, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][BT * LDB];
  __shared__ __align__(16) __nv_bfloat16 vs[2][BT * LDB];
  __shared__ float bias[2][BT];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * (blockDim.x / 2) + warp * 16;  // 16 queries per warp
  const bool active = q0 < S;
  const size_t base = size_t(bh) * S * D;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  const int ntiles = (S + BT - 1) / BT;

  auto load_tile = [&](int stage, int k0) {
    tc_stage(ks[stage], k + base, k0, S);
    tc_stage(vs[stage], v + base, k0, S);
    stage_bias(bias[stage], pad, b, k0, S);
    cp_async_commit();
  };
  uint32_t qf[D / 16][4], df[D / 16][4];
  tc_rows(qf, q + base, r0, r1, S, t);
  tc_rows(df, dout + base, r0, r1, S, t);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  float linv[2], delta[2];
  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  // pass 0: row max, sum and sum of e^s dP, online; pass 1: dS and dQ
  for (int pass = 0; pass < 2; ++pass) {
    load_tile(0, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int stage = it & 1, k0 = it * BT;
      if (it + 1 < ntiles) {
        load_tile(stage ^ 1, k0 + BT);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const int chunks = (min(BT, S - k0) + 15) / 16;
        float sc[8][4], dp[8][4];
        tc_dot(sc, qf, ks[stage], chunks, lane);
        tc_dot(dp, df, vs[stage], chunks, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i)  // chunks past the last key leave the softmax
            sc[n][i] = n / 2 < chunks ? sc[n][i] * scale + bias[stage][n * 8 + 2 * t + (i & 1)]
                                      : -INFINITY;
        }
        if (pass == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[h], mx);  // finite: the tile holds a key
            float sl = 0.f, sa = 0.f;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float e = expf(sc[n][2 * h + j] - m_new);
                sl += e;
                sa += e * dp[n][2 * h + j];
              }
            }
            sl += __shfl_xor_sync(0xffffffffu, sl, 1);
            sl += __shfl_xor_sync(0xffffffffu, sl, 2);
            sa += __shfl_xor_sync(0xffffffffu, sa, 1);
            sa += __shfl_xor_sync(0xffffffffu, sa, 2);
            const float corr = expf(m[h] - m_new);
            l[h] = l[h] * corr + sl;
            a[h] = a[h] * corr + sa;
            m[h] = m_new;
          }
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = expf(sc[n][i] - m[i / 2]) * linv[i / 2];
              sc[n][i] = p * (dp[n][i] - delta[i / 2]);  // dS
            }
          tc_acc(acc, sc, ks[stage], chunks, lane);
        }
      }
      __syncthreads();  // every warp is done with `stage` before it is refilled
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        linv[h] = 1.f / l[h];
        delta[h] = a[h] * linv[h];
        const int r = h ? r1 : r0;
        if (active && t == 0 && r < S) {
          const size_t plane = size_t(gridDim.x) * S;
          stats[size_t(bh) * S + r] = m[h];
          stats[plane + size_t(bh) * S + r] = linv[h];
          stats[2 * plane + size_t(bh) * S + r] = delta[h];
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dq + base + size_t(r0) * D + col) =
          pack_bf16(acc[c][0] * scale, acc[c][1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dq + base + size_t(r1) * D + col) =
          pack_bf16(acc[c][2] * scale, acc[c][3] * scale);
  }
}

__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
mha_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ pad,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[2][BT * LDB];
  __shared__ __align__(16) __nv_bfloat16 dos[2][BT * LDB];
  __shared__ float rm[2][BT], rl[2][BT], rd[2][BT];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * (blockDim.x / 2) + warp * 16;  // 16 keys per warp
  const bool active = k0 < S;
  const size_t base = size_t(bh) * S * D;
  const size_t plane = size_t(gridDim.x) * S;
  const int r0 = k0 + g, r1 = k0 + g + 8;
  const int ntiles = (S + BT - 1) / BT;

  auto load_tile = [&](int stage, int q0) {
    tc_stage(qs[stage], q + base, q0, S);
    tc_stage(dos[stage], dout + base, q0, S);
    for (int j = tid; j < BT; j += blockDim.x) {
      const bool in = q0 + j < S;  // a query past S gets P = 0
      rm[stage][j] = in ? stats[size_t(bh) * S + q0 + j] : 0.f;
      rl[stage][j] = in ? stats[plane + size_t(bh) * S + q0 + j] : 0.f;
      rd[stage][j] = in ? stats[2 * plane + size_t(bh) * S + q0 + j] : 0.f;
    }
    cp_async_commit();
  };
  uint32_t kf[D / 16][4], vf[D / 16][4];
  tc_rows(kf, k + base, r0, r1, S, t);
  tc_rows(vf, v + base, r0, r1, S, t);
  float kb[2];  // this thread's keys' bias: 0 real, -1e30 padded, -inf past S
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? r1 : r0;
    kb[h] = key >= S ? -INFINITY
                     : ((pad != nullptr && pad[size_t(b) * S + key]) ? MASK_BIAS : 0.f);
  }
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) gk[c][i] = gv[c][i] = 0.f;

  load_tile(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1, q0 = it * BT;
    if (it + 1 < ntiles) {
      load_tile(stage ^ 1, q0 + BT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int chunks = (min(BT, S - q0) + 15) / 16;
      float p[8][4], ds[8][4];
      tc_dot(p, kf, qs[stage], chunks, lane);    // s^T [key][query]
      tc_dot(ds, vf, dos[stage], chunks, lane);  // dP^T [key][query]
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qj = n * 8 + 2 * t + (i & 1);
          const float pr = n / 2 < chunks
                               ? expf(p[n][i] * scale + kb[i / 2] - rm[stage][qj]) * rl[stage][qj]
                               : 0.f;
          p[n][i] = pr;
          ds[n][i] = pr * (ds[n][i] - rd[stage][qj]);
        }
      tc_acc(gv, p, dos[stage], chunks, lane);   // dV += P^T dO
      tc_acc(gk, ds, qs[stage], chunks, lane);   // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with `stage` before it is refilled
  }
  if (!active) return;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dk + base + size_t(r0) * D + col) =
          pack_bf16(gk[c][0] * scale, gk[c][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + size_t(r0) * D + col) =
          pack_bf16(gv[c][0], gv[c][1]);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dk + base + size_t(r1) * D + col) =
          pack_bf16(gk[c][2] * scale, gk[c][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + size_t(r1) * D + col) =
          pack_bf16(gv[c][2], gv[c][3]);
    }
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* pad,
                        const void* dout, void* dq, void* dk, void* dv, void* stats, int B, int H,
                        int S, cudaStream_t stream) {
  // up to 128 rows: one block per (row, head), one warp per 16 rows; longer
  // S: 64-row blocks
  const int warps = S <= 16 * TC_MAX_WARPS ? (S + 15) / 16 : 4;
  const int rows = 16 * warps;
  const dim3 grid(unsigned(B) * unsigned(H), unsigned((S + rows - 1) / rows));
  const float scale = 1.0f / sqrtf(float(D));
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* pb = static_cast<const uint8_t*>(pad);
  mha_bwd_dq_bf16_kernel<<<grid, 32 * warps, 0, stream>>>(
      qb, kb, vb, pb, db, static_cast<__nv_bfloat16*>(dq), static_cast<float*>(stats), H, S,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkdv_bf16_kernel<<<grid, 32 * warps, 0, stream>>>(
      qb, kb, vb, pb, db, static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, S, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16, S <= 128: fused, wgmma + TMA
//
// The TPU kernel's own schedule: a block holds a whole head, so each score
// row is complete and the softmax exact, with no statistics scratch and no
// second sweep.  Five products instead of v2's nine, each input read once.
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
// What bounds it on an H100: bytes, as for v2 (7 [S, D] tensors per head, ~30
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

// The v2 route: bf16 at any S (taken past S = 128), the dq kernel and the
// dk/dv kernel on mma.sync.  stats: 3 B H S f32 of scratch.  Returns a
// cudaError_t (0 = launched).
extern "C" int mha_bwd_v2(const void* q, const void* k, const void* v, const void* pad,
                          const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
                          int H, int S, int head_dim, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != D || (S + BT - 1) / BT > 65535 ||
      stats == nullptr)
    return int(cudaErrorInvalidValue);
  return int(launch_bf16(q, k, v, pad, dout, dq, dk, dv, stats, B, H, S,
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
