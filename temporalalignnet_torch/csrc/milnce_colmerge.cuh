// The column merge of the MIL-NCE forward, shared by its kernels
// (milnce_fwd.cu, the f32 route and the earlier bf16 kernel; milnce_wgmma.cu,
// the bf16 route): each writes, per layer s, 64-row block rb and text column
// k, the (max, sum) pairs of the column's positives and negatives over the
// block's rows in natural-log terms (m, sum exp(x - m)) into a
// [4, S, ceil(R/64), K] f32 scratch (planes mp, sp, mn, sn), and
// milnce_colmerge_kernel folds them into tnum, tden [S, K] (pallas_milnce.py:
// 108-120): eight warps a column block, each over an eighth of the row blocks
// in order, then the eighths in order.  Rows sharded over several cards could merge
// the same partials across ranks.
//
// Also the log2-domain (max, sum) helpers of the f32 and the bf16 route's
// tile epilogues.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace milnce {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the exponent reference of a log2-domain (max, sum): the max, or 0 where it
// is -inf (every entry is, and each 2^(-inf - 0) = 0 keeps the sum at 0)
__device__ __forceinline__ float ex2_ref(float m) { return m == -INFINITY ? 0.f : m; }

// (m, s) with s = sum 2^(x - m), folded with the 8 entries x
__device__ __forceinline__ void fold8(float& m, float& s, const float (&x)[8]) {
  float mx = m;
#pragma unroll
  for (int c = 0; c < 8; ++c) mx = fmaxf(mx, x[c]);
  const float r = ex2_ref(mx);
  float sum = s * hopper::ex2(m - r);
#pragma unroll
  for (int c = 0; c < 8; ++c) sum += hopper::ex2(x[c] - r);
  m = mx, s = sum;
}

// (m, s) merged with (m2, s2)
__device__ __forceinline__ void merge2(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2), r = ex2_ref(mx);
  s = s * hopper::ex2(m - r) + s2 * hopper::ex2(m2 - r);
  m = mx;
}

// over the 8 lanes of a warp that share t = lane % 4 (the rows g of an mma
// fragment's column)
__device__ __forceinline__ float max_over_g(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum_over_g(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (m, s) of a logsumexp merged with another (m2, s2); -inf entries are empty
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

constexpr int MERGE_WARPS = 8;

// tnum, tden [S, K] from the per-row-block partials; block (32 columns,
// layer s): warp w folds row blocks w per .. w per + per - 1 in order, then
// warp 0 folds the warps' pairs in warp order (a fixed order: two calls are
// bit-equal)
__global__ void __launch_bounds__(32 * MERGE_WARPS)
milnce_colmerge_kernel(const float* __restrict__ part, float* __restrict__ tnum,
                       float* __restrict__ tden, int S, int nrb, int K) {
  __shared__ float4 xw[MERGE_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.y, k = blockIdx.x * 32 + lane;
  const size_t plane = size_t(S) * nrb * K;
  const int per = (nrb + MERGE_WARPS - 1) / MERGE_WARPS;
  float mp = -INFINITY, sp = 0.f, mn = -INFINITY, sn = 0.f;
  if (k < K) {
    for (int rb = warp * per; rb < min(nrb, warp * per + per); ++rb) {
      const size_t p = (size_t(s) * nrb + rb) * K + k;
      lse_merge(mp, sp, part[p], part[plane + p]);
      lse_merge(mn, sn, part[2 * plane + p], part[3 * plane + p]);
    }
  }
  xw[warp][lane] = make_float4(mp, sp, mn, sn);
  __syncthreads();
  if (warp == 0 && k < K) {
    for (int w = 1; w < MERGE_WARPS; ++w) {
      const float4 o = xw[w][lane];
      lse_merge(mp, sp, o.x, o.y);
      lse_merge(mn, sn, o.z, o.w);
    }
    tnum[size_t(s) * K + k] = mp + logf(sp);
    tden[size_t(s) * K + k] = mn + logf(sn);
  }
}

// the merge of the partials of S layers, R rows and K columns, on `stream`
inline cudaError_t colmerge(const void* part, void* tnum, void* tden, int S, int R, int K,
                            cudaStream_t stream) {
  milnce_colmerge_kernel<<<dim3(unsigned((K + 31) / 32), unsigned(S)), 32 * MERGE_WARPS, 0,
                           stream>>>(static_cast<const float*>(part), static_cast<float*>(tnum),
                                     static_cast<float*>(tden), S, (R + 63) / 64, K);
  return cudaGetLastError();
}

}  // namespace milnce
