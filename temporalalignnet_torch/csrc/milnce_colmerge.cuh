// The column merge of the MIL-NCE forward, shared by its two kernels
// (milnce_fwd.cu, the f32 route and the earlier bf16 kernel; milnce_wgmma.cu,
// the bf16 route): each writes, per layer s, 64-row block rb and text column
// k, the (max, sum) pairs of the column's positives and negatives over the
// block's rows in natural-log terms (m, sum exp(x - m)) into a
// [4, S, ceil(R/64), K] f32 scratch (planes mp, sp, mn, sn), and
// milnce_colmerge_kernel folds them into tnum, tden [S, K] in row-block order
// (pallas_milnce.py:108-120).  Rows sharded over several cards could merge
// the same partials across ranks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace milnce {

// (m, s) of a logsumexp merged with another (m2, s2); -inf entries are empty
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// tnum, tden [S, K] from the per-row-block partials, in row-block order
__global__ void milnce_colmerge_kernel(const float* __restrict__ part, float* __restrict__ tnum,
                                       float* __restrict__ tden, int S, int nrb, int K) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(S) * K) return;
  const size_t s = idx / K, k = idx % K;
  const size_t plane = size_t(S) * nrb * K;
  float mp = -INFINITY, sp = 0.f, mn = -INFINITY, sn = 0.f;
  for (int rb = 0; rb < nrb; ++rb) {
    const size_t p = (s * nrb + rb) * K + k;
    lse_merge(mp, sp, part[p], part[plane + p]);
    lse_merge(mn, sn, part[2 * plane + p], part[3 * plane + p]);
  }
  tnum[idx] = mp + logf(sp);
  tden[idx] = mn + logf(sn);
}

// the merge of the partials of S layers, R rows and K columns, on `stream`
inline cudaError_t colmerge(const void* part, void* tnum, void* tden, int S, int R, int K,
                            cudaStream_t stream) {
  const size_t n = size_t(S) * K;
  milnce_colmerge_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(tnum), static_cast<float*>(tden), S,
      (R + 63) / 64, K);
  return cudaGetLastError();
}

}  // namespace milnce
