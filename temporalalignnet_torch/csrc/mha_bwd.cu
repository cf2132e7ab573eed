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
// Two kernels per dtype (FlashAttention-2 shape, any S, D = 64):
// - dq: a block owns (batch row, head, a run of queries) and streams the keys
//   twice: first an online (max, sum, sum of e^s dP) recurrence gives each
//   row's max m, 1 / sum and rowsum(dP P); then dS and dQ.  m, 1 / sum and
//   the row sum go to a [3, B H S] scratch.  1 / sum and m are kept apart
//   (not folded into one log-sum-exp), because at -1e30 the sum's log would
//   vanish in f32.
// - dkdv: a block owns (batch row, head, a run of keys) and streams the
//   queries, recomputing P from the saved m and 1 / sum.
// bf16 (the training path) runs every product on the tensor cores
// (mha_bwd_*_bf16_kernel, below); f32 runs them as f32 FMAs on the CUDA
// cores (mha_bwd_dq_kernel, mha_bwd_dkdv_kernel: 64-row tiles through shared
// memory), the parity path.
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

#include "mma.cuh"

namespace {

constexpr int D = 64;           // head dim
constexpr int BT = 64;          // queries or keys per tile
constexpr int NTHREADS = 128;   // 16 row groups x 8 column groups
constexpr int LDT = BT + 4;     // stride of the transposed [D][BT] and [BT][BT] tiles
constexpr int LDR = D + 4;      // stride of the row-major [BT][D] tiles
constexpr float MASK_BIAS = -1.0e30f;

// ------------------------------------------------------- f32: CUDA cores
//
// 128 threads per 64-row tile; thread (rg, cg) owns rows 4 rg .. +3 and
// columns (or dims) 8 cg .. +7.  Tiles are staged in shared memory as f32,
// transposed for the dot products and row-major for the accumulations.

// rows [n0, n0 + BT) of a [S, D] head into dst transposed ([D][LDT]) and, if
// rows is not null, row-major ([BT][LDR]); rows past S are zero
__device__ __forceinline__ void stage(float* dst_t, float* rows, const float* src, int n0,
                                      int S) {
  for (int e = threadIdx.x; e < BT * D; e += NTHREADS) {
    const int j = e / D, d = e % D;
    const float x = (n0 + j < S) ? src[size_t(n0 + j) * D + d] : 0.f;
    dst_t[d * LDT + j] = x;
    if (rows != nullptr) rows[j * LDR + d] = x;
  }
}

// key bias of keys [k0, k0 + BT): 0 real, -1e30 padded, -inf past S
__device__ __forceinline__ void stage_bias(float* bias, const uint8_t* pad, int b, int k0,
                                           int S) {
  for (int j = threadIdx.x; j < BT; j += blockDim.x) {
    const int key = k0 + j;
    bias[j] = key >= S ? -INFINITY
                       : ((pad != nullptr && pad[size_t(b) * S + key]) ? MASK_BIAS : 0.f);
  }
}

// acc[i][j] = sum_d at[d][4 rg + i] * bt[d][8 cg + j] over the D dims
__device__ __forceinline__ void tile_dot(float acc[4][8], const float* at, const float* bt,
                                         int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 av = *reinterpret_cast<const float4*>(&at[d * LDT + rg * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bt[d * LDT + cg * 8]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bt[d * LDT + cg * 8 + 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j wt[j][4 rg + i] * rows[j][8 cg + c] over the BT tile entries
__device__ __forceinline__ void tile_acc(float acc[4][8], const float* wt, const float* rows,
                                         int rg, int cg) {
#pragma unroll 4
  for (int j = 0; j < BT; ++j) {
    const float4 wv = *reinterpret_cast<const float4*>(&wt[j * LDT + rg * 4]);
    const float4 r0 = *reinterpret_cast<const float4*>(&rows[j * LDR + cg * 8]);
    const float4 r1 = *reinterpret_cast<const float4*>(&rows[j * LDR + cg * 8 + 4]);
    const float w[4] = {wv.x, wv.y, wv.z, wv.w};
    const float r[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(w[i], r[c], acc[i][c]);
  }
}

// reduce over the 8 column-group lanes that share a row group
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t DQ_SMEM = sizeof(float) * (5 * size_t(D) * LDT + size_t(BT) * LDR + BT);
constexpr size_t DKDV_SMEM =
    sizeof(float) * (4 * size_t(D) * LDT + 2 * size_t(BT) * LDR + 2 * size_t(BT) * LDT + 3 * BT);

__global__ void __launch_bounds__(NTHREADS)
mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const uint8_t* __restrict__ pad, const float* __restrict__ dout,
                  float* __restrict__ dq, float* __restrict__ stats, int H, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][LDT] query tile, transposed
  float* dot = qt + D * LDT;     // [D][LDT] dO tile, transposed
  float* kt = dot + D * LDT;     // [D][LDT] key tile, transposed
  float* vt = kt + D * LDT;      // [D][LDT] value tile, transposed
  float* dst = vt + D * LDT;     // [BT keys][LDT] dS, transposed
  float* ks = dst + BT * LDT;    // [BT][LDR] key tile, row-major
  float* bias = ks + BT * LDR;   // [BT]

  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;
  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * BT;
  const size_t base = size_t(bh) * S * D;
  stage(qt, nullptr, q + base, q0, S);
  stage(dot, nullptr, dout + base, q0, S);

  float m[4], l[4], a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f, a[i] = 0.f;
  float s[4][8], dp[4][8];

  // pass 1: row max, sum and sum of e^s dP, online over the key tiles
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();
    stage(kt, nullptr, k + base, k0, S);
    stage(vt, nullptr, v + base, k0, S);
    stage_bias(bias, pad, b, k0, S);
    __syncthreads();
    tile_dot(s, qt, kt, rg, cg);
    tile_dot(dp, dot, vt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = s[i][j] * scale + bias[cg * 8 + j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));  // finite: the tile holds a key
      const float corr = expf(m[i] - m_new);
      float sl = 0.f, sa = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - m_new);
        sl += e;
        sa += e * dp[i][j];
      }
      l[i] = l[i] * corr + group_sum(sl);
      a[i] = a[i] * corr + group_sum(sa);
      m[i] = m_new;
    }
  }
  float linv[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    linv[i] = 1.f / l[i];
    delta[i] = a[i] * linv[i];
    const int r = q0 + rg * 4 + i;
    if (cg == 0 && r < S) {
      const size_t plane = size_t(gridDim.x) * S;
      stats[size_t(bh) * S + r] = m[i];
      stats[plane + size_t(bh) * S + r] = linv[i];
      stats[2 * plane + size_t(bh) * S + r] = delta[i];
    }
  }

  // pass 2: dS = P (dP - delta), dQ += dS K
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < S; k0 += BT) {
    __syncthreads();
    stage(kt, ks, k + base, k0, S);
    stage(vt, nullptr, v + base, k0, S);
    stage_bias(bias, pad, b, k0, S);
    __syncthreads();
    tile_dot(s, qt, kt, rg, cg);
    tile_dot(dp, dot, vt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] * scale + bias[cg * 8 + j] - m[i]) * linv[i];
        dst[(cg * 8 + j) * LDT + rg * 4 + i] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    tile_acc(acc, dst, ks, rg, cg);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) dq[base + size_t(r) * D + cg * 8 + c] = acc[i][c] * scale;
  }
}

__global__ void __launch_bounds__(NTHREADS)
mha_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const uint8_t* __restrict__ pad, const float* __restrict__ dout,
                    const float* __restrict__ stats, float* __restrict__ dk, float* __restrict__ dv,
                    int H, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // [D][LDT] key tile, transposed (resident)
  float* vt = kt + D * LDT;      // [D][LDT] value tile, transposed (resident)
  float* qt = vt + D * LDT;      // [D][LDT] query tile, transposed
  float* dot = qt + D * LDT;     // [D][LDT] dO tile, transposed
  float* qs = dot + D * LDT;     // [BT][LDR] query tile, row-major
  float* dos = qs + BT * LDR;    // [BT][LDR] dO tile, row-major
  float* pt = dos + BT * LDR;    // [BT queries][LDT] P, rounded
  float* dst = pt + BT * LDT;    // [BT queries][LDT] dS, rounded
  float* rm = dst + BT * LDT;    // [BT] row max of each query
  float* rl = rm + BT;           // [BT] 1 / row sum
  float* rd = rl + BT;           // [BT] rowsum(dP P)

  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;
  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * BT;
  const size_t base = size_t(bh) * S * D;
  const size_t plane = size_t(gridDim.x) * S;
  stage(kt, nullptr, k + base, k0, S);
  stage(vt, nullptr, v + base, k0, S);
  float kb[4];  // this thread's keys' bias
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    kb[i] = key >= S ? -INFINITY
                     : ((pad != nullptr && pad[size_t(b) * S + key]) ? MASK_BIAS : 0.f);
  }

  float gk[4][8], gv[4][8], s[4][8], dp[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BT) {
    __syncthreads();
    stage(qt, qs, q + base, q0, S);
    stage(dot, dos, dout + base, q0, S);
    for (int j = tid; j < BT; j += NTHREADS) {
      const bool in = q0 + j < S;  // a query past S gets P = 0
      rm[j] = in ? stats[size_t(bh) * S + q0 + j] : 0.f;
      rl[j] = in ? stats[plane + size_t(bh) * S + q0 + j] : 0.f;
      rd[j] = in ? stats[2 * plane + size_t(bh) * S + q0 + j] : 0.f;
    }
    __syncthreads();
    tile_dot(s, kt, qt, rg, cg);   // s[key i][query j]
    tile_dot(dp, vt, dot, rg, cg);  // dP[query j][key i]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qj = cg * 8 + j;
        const float p = expf(s[i][j] * scale + kb[i] - rm[qj]) * rl[qj];
        pt[qj * LDT + rg * 4 + i] = p;
        dst[qj * LDT + rg * 4 + i] = p * (dp[i][j] - rd[qj]);
      }
    __syncthreads();
    tile_acc(gv, pt, dos, rg, cg);
    tile_acc(gk, dst, qs, rg, cg);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      dk[base + size_t(key) * D + cg * 8 + c] = gk[i][c] * scale;
      dv[base + size_t(key) * D + cg * 8 + c] = gv[i][c];
    }
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

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* pad,
                       const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
                       int H, int S, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(DQ_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(DKDV_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(B) * unsigned(H), unsigned((S + BT - 1) / BT));
  const float scale = 1.0f / sqrtf(float(D));
  mha_bwd_dq_kernel<<<grid, NTHREADS, DQ_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(stats), H, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_dkdv_kernel<<<grid, NTHREADS, DKDV_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const float*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(dk), static_cast<float*>(dv), H, S,
      scale);
  return cudaGetLastError();
}

}  // namespace

// stats: 3 B H S f32 of scratch.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = launched).
extern "C" int mha_bwd(const void* q, const void* k, const void* v, const void* pad,
                       const void* dout, void* dq, void* dk, void* dv, void* stats, int B, int H,
                       int S, int head_dim, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != D || (S + BT - 1) / BT > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch_f32(q, k, v, pad, dout, dq, dk, dv, stats, B, H, S, st));
  if (dtype == 1) return int(launch_bf16(q, k, v, pad, dout, dq, dk, dv, stats, B, H, S, st));
  return int(cudaErrorInvalidValue);
}
