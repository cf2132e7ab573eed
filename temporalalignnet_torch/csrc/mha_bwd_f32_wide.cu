// The f32 route of mha_bwd at 80 < S <= 128: the whole-head kernel of
// mha_bwd_f32.cuh at 6 and 8 warps, in a source of its own so that it
// builds beside mha_bwd_f32.cu (csrc/mha_bwd_f32.cu says what the kernel
// computes, what bounds it and why it is built so).

#include "mha_bwd_f32.cuh"

// The f32 route at 80 < S <= 128: one kernel, no scratch.  Pointers 16-byte
// aligned (cp.async).  Returns a cudaError_t (0 = launched).
extern "C" int mha_bwd_f32_wide(const void* q, const void* k, const void* v, const void* pad,
                                const void* dout, void* dq, void* dk, void* dv, void* stats,
                                int B, int H, int S, int head_dim, void* stream) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 80 || S > 128 || head_dim != D) return int(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  const auto* pb = static_cast<const uint8_t*>(pad);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 96)
    return int(f32::launch_fused<6>(qf, kf, vf, pb, df, dqf, dkf, dvf, B * H, H, S, st));
  return int(f32::launch_fused<8>(qf, kf, vf, pb, df, dqf, dkf, dvf, B * H, H, S, st));
}
