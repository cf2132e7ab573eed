// The f32 route of mha_bwd (split TF32; csrc/mha_bwd_f32.cu says what it
// computes, what bounds it and why it is built so): the whole-head kernel
// and its building blocks, shared by the two sources that instantiate it,
// mha_bwd_f32.cu (up to 5 warps, and the two-kernel plan past S = 128) and
// mha_bwd_f32_wide.cu (6 and 8 warps).  Two sources build in parallel: the
// unrolled instantiations took one nvcc ~63 s.

#pragma once

#include "tf32x3.cuh"

namespace {

constexpr int D = 64;   // head dim
constexpr int BT = 64;  // queries or keys per tile of the two-kernel plan
constexpr float MASK_BIAS = -1.0e30f;

// ------------------------------------------ f32: split TF32 on the tensor cores
//
// Every product is tf32x3's: f32 tiles staged by cp.async in [rows][LD]
// shared memory, three mma.sync m16n8k8 .tf32 per product into f32
// accumulators.  Scores in the log2 domain (x = s log2(e) / sqrt(D) + key
// bias, the bias -1e30 log2(e) padded, -inf past S), P = exp2(x - max) / sum.
// A warp owns 16 rows: query rows for dQ, key rows for dK and dV.
// - S <= 128 (every f32 training shape): mha_bwd_f32_fused_kernel, one block
//   per (batch row, head), q, k, v, dO of the head staged once.  Phase 1, a
//   warp per 16 queries: S = Q K^T and dP = dO V^T over all keys, the exact
//   softmax of whole rows, delta = rowsum(dP P), dS = P (dP - delta), dQ =
//   dS K with dS straight from the registers; each row's max, 1 / sum and
//   delta go to shared memory.  Phase 2, a warp per 16 keys, in 32-query
//   steps: S^T = K Q^T and dP^T = V dO^T, P and dS recomputed from the row
//   statistics, dV += P^T dO and dK += dS^T Q from the registers.  Seven
//   products (the bf16 fused kernel's five, plus S^T and dP^T, which keep P
//   and dS out of shared memory), one pass over device memory, no scratch.
// - S > 128: two kernels, 64 rows a block.  mha_bwd_f32_dq_kernel streams
//   the keys twice (the online row max, sum and sum of e^x dP, then dS and
//   dQ) and writes each row's (max, 1 / sum, delta) to a [3, B H S] scratch;
//   mha_bwd_f32_dkdv_kernel streams the queries with their statistics.

namespace f32 {

using tf32x3::LD;
constexpr int QT = 32;  // queries per step of the key-side products
constexpr float LOG2E = 1.4426950408889634f;

// a key's bias, log2 domain: 0 real, -1e30 log2(e) padded, -inf past S
__device__ __forceinline__ float key_bias(const uint8_t* pad, int key, int S) {
  return key >= S ? -INFINITY : ((pad != nullptr && pad[key]) ? MASK_BIAS * LOG2E : 0.f);
}

// dv += P^T dO and dk += dS^T Q for this warp's 16 keys (staged rows kw of K
// and vw of V, their bias kb) over a step of 8 NQ staged queries (qs, dos;
// the queries' log2 max m2, 1 / sum linv and delta, all 0 past S, which
// makes P = 0 there), the first 8 nch of them real rows (FULL: all NQ chunks)
template <int NQ, bool FULL>
__device__ __forceinline__ void keys_step(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                          const float* kw, const float* vw, const float* qs,
                                          const float* dos, const float* m2, const float* linv,
                                          const float* delta, const float (&kb)[2], int nch,
                                          float scale2, int lane) {
  const int t = lane & 3;
  float p[NQ][4], ds[NQ][4];
  tf32x3::rows_dot<NQ, FULL>(p, kw, qs, nch, lane);    // S^T [key][query]
  tf32x3::rows_dot<NQ, FULL>(ds, vw, dos, nch, lane);  // dP^T [key][query]
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = 8 * j + 2 * t + (e & 1);
      const float pr = exp2f(fmaf(p[j][e], scale2, kb[e >> 1]) - m2[qi]) * linv[qi];
      p[j][e] = pr;
      ds[j][e] = pr * (ds[j][e] - delta[qi]);
    }
  tf32x3::acc_mul<NQ, FULL>(dv, p, dos, nch, lane);
  tf32x3::acc_mul<NQ, FULL>(dk, ds, qs, nch, lane);
}

__host__ __device__ constexpr int stats_len(int nc) { return QT * ((nc + 1) / 2); }

template <int NC>
constexpr size_t fused_smem() {  // q, k, v, dO [16 NC][LD]; m2, linv, delta; key bias
  return sizeof(float) * (4 * size_t(16 * NC) * LD + 3 * stats_len(NC) + 16 * NC);
}

// one block per (batch row, head) of NC warps, 16 rows each: ceil(S / 16)
// rounded up to 2, 4, 5, 6 or 8 as in mha_fwd_f32.cu, the rows past S zero
// (their queries give P = 0, their keys a -inf bias)
template <int NC>
__global__ void __launch_bounds__(32 * NC, NC <= 4 ? 3 : (NC <= 6 ? 2 : 1))
mha_bwd_f32_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ pad,
                         const float* __restrict__ dout, float* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int S,
                         float scale, float scale2) {
  constexpr int R = 16 * NC;  // staged rows of each input
  constexpr int NK = 2 * NC;  // 8-key chunks of a score row
  constexpr int RS = stats_len(NC);
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + R * LD;
  float* vs = ks + R * LD;
  float* dos = vs + R * LD;
  float* m2 = dos + R * LD;  // [RS] per query, 0 past S
  float* linv = m2 + RS;
  float* delta = linv + RS;
  float* kbias = delta + RS;  // [R] per key
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const size_t base = size_t(bh) * S * D;
  const uint8_t* pb = pad != nullptr ? pad + size_t(bh / H) * S : nullptr;

  tf32x3::load_rows(qs, q + base, 0, R, S);
  tf32x3::load_rows(ks, k + base, 0, R, S);
  tf32x3::load_rows(vs, v + base, 0, R, S);
  tf32x3::load_rows(dos, dout + base, 0, R, S);
  cp_async_commit();
  for (int i = threadIdx.x; i < RS; i += blockDim.x) m2[i] = linv[i] = delta[i] = 0.f;
  for (int i = threadIdx.x; i < R; i += blockDim.x) kbias[i] = key_bias(pb, i, S);
  cp_async_wait<0>();
  __syncthreads();

  // phase 1: this warp's 16 query rows against every key
  {
    float sc[NK][4], dp[NK][4];
    tf32x3::rows_dot<NK, true>(sc, qs + 16 * warp * LD, ks, NK, lane);
    tf32x3::rows_dot<NK, true>(dp, dos + 16 * warp * LD, vs, NK, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(sc[j][e], scale2, kbias[8 * j + 2 * t + (e & 1)]);
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = tf32x3::quad_max(mx[h]);  // finite: key 0 is real
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        sc[j][e] = p;
        sum[e >> 1] += p;
      }
    // P (f32, unrounded), then rowsum(dP P) of it; queries past S give nothing
    float li[2], dl[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // every lane takes part in the shuffles
      const float total = tf32x3::quad_sum(sum[h]);
      li[h] = 16 * warp + g + 8 * h < S ? 1.f / total : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] *= li[e >> 1];
        dl[e >> 1] += sc[j][e] * dp[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) dl[h] = tf32x3::quad_sum(dl[h]);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = sc[j][e] * (dp[j][e] - dl[e >> 1]);  // dS
    float acc[D / 8][4];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
    tf32x3::acc_mul<NK, true>(acc, dp, ks, NK, lane);  // dQ = dS K
    tf32x3::store_rows(dq + base, acc, 16 * warp, S, scale, scale, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      if (t == 0 && r < S) m2[r] = mx[h], linv[r] = li[h], delta[r] = dl[h];
    }
  }
  __syncthreads();  // every row's statistics are in shared memory

  // phase 2: this warp's 16 keys against every query
  const float kb[2] = {kbias[16 * warp + g], kbias[16 * warp + g + 8]};
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;
  // every staged query row in whole steps (rows past S give P = 0), the
  // last 16 rows alone when NC is odd
  const float* kw = ks + 16 * warp * LD;
  const float* vw = vs + 16 * warp * LD;
#pragma unroll 1
  for (int s0 = 0; s0 + QT <= R; s0 += QT)
    keys_step<QT / 8, true>(gk, gv, kw, vw, qs + s0 * LD, dos + s0 * LD, m2 + s0, linv + s0,
                            delta + s0, kb, QT / 8, scale2, lane);
  if constexpr (R % QT != 0) {
    constexpr int s0 = R - R % QT;
    keys_step<(R % QT) / 8, true>(gk, gv, kw, vw, qs + s0 * LD, dos + s0 * LD, m2 + s0,
                                  linv + s0, delta + s0, kb, (R % QT) / 8, scale2, lane);
  }
  tf32x3::store_rows(dk + base, gk, 16 * warp, S, scale, scale, lane);
  tf32x3::store_rows(dv + base, gv, 16 * warp, S, 1.f, 1.f, lane);
}

template <int NC>
cudaError_t launch_fused(const float* q, const float* k, const float* v, const uint8_t* pad,
                         const float* dout, float* dq, float* dk, float* dv, int BH, int H, int S,
                         cudaStream_t stream) {
  constexpr size_t smem = fused_smem<NC>();
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_f32_fused_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  mha_bwd_f32_fused_kernel<NC><<<BH, 32 * NC, smem, stream>>>(
      q, k, v, pad, dout, dq, dk, dv, H, S, 1.0f / sqrtf(float(D)), LOG2E / sqrtf(float(D)));
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace
