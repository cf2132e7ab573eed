// The merge of mha_fwd's key splits (the bf16 long route and the f32 route
// past S = 128): out[bh, r, :] from the splits' partials, unnormalised O
// [splits][B H][Sq][64] f32 and (max, sum) [splits][B H][Sq] in the log2
// domain, in split order.

#pragma once

#include "hopper.cuh"

namespace mha_merge {

using hopper::ex2;
using hopper::pack_bf16x2;

// 8 output columns of a row, as the output dtype
__device__ __forceinline__ void store8(__nv_bfloat16* out, const float* x) {
  *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]),
                                              pack_bf16x2(x[4], x[5]), pack_bf16x2(x[6], x[7]));
}
__device__ __forceinline__ void store8(float* out, const float* x) {
  reinterpret_cast<float4*>(out)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// out[bh, r, :] from the key splits' partials, in split order: M = max of the
// splits' maxima, out = sum O_s 2^(m_s - M) / sum l_s 2^(m_s - M); one thread
// per 8 output columns of a row; T the output dtype (bf16 or f32)
template <typename T>
__global__ void mha_fwd_merge_kernel(const float* __restrict__ part_o,
                                     const float2* __restrict__ part_ml, T* __restrict__ out,
                                     int BH, int S, int Sq, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BH * S * 8) return;
  const int c = idx % 8, row = idx / 8, bh = row / S, r = row % S;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part_ml[(size_t(s) * BH + bh) * Sq + r].x);
  float L = 0.f, acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const size_t i = (size_t(s) * BH + bh) * Sq + r;
    const float2 ml = part_ml[i];
    const float w = ex2(ml.x - M);
    L += ml.y * w;
    const float4* po = reinterpret_cast<const float4*>(part_o + i * 64 + 8 * c);
    const float4 x0 = po[0], x1 = po[1];
    acc[0] += w * x0.x, acc[1] += w * x0.y, acc[2] += w * x0.z, acc[3] += w * x0.w;
    acc[4] += w * x1.x, acc[5] += w * x1.y, acc[6] += w * x1.z, acc[7] += w * x1.w;
  }
  const float inv = 1.f / L;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] *= inv;
  store8(out + size_t(row) * 64 + 8 * c, acc);
}

template <typename T>
cudaError_t launch_merge(const float* part_o, const float2* part_ml, void* out, int BH, int S,
                         int Sq, int splits, cudaStream_t stream) {
  const int n = BH * S * 8;
  mha_fwd_merge_kernel<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), BH, S, Sq, splits);
  return cudaGetLastError();
}

}  // namespace mha_merge
