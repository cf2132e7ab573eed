// Fused multi-head attention backward for Hopper (sm_90a), the f32 route
// (mha_bwd_f32): dq, dk, dv of csrc/mha_fwd_f32.cu's out = softmax(Q K^T /
// sqrt(D) + bias) V, bias = -1e30 on padded keys, in float32.  The bf16
// routes are csrc/mha_bwd.cu.
//
// Replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_bwd_kernel on
// f32 inputs (train/cli.py --f32) and keeps its semantics: P recomputed from
// q and k, dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) with the row
// sum over the unrounded P, dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D).  The
// TPU kernel's f32 products are Precision.HIGHEST, a level of accuracy
// (f32's), met here by split TF32 on the tensor cores (csrc/tf32x3.cuh: big·
// small + small·big + big·big of TF32 halves into f32 accumulators) at up to
// 495 / 3 TFLOP/s, where f32 FMAs on the CUDA cores give 67.
//
// What bounds it on an H100: at the training shapes ([64, 8, 64, 64] dual,
// [64, 8, 80, 64] joint) bytes: q, k, v, dO, dq, dk, dv in f32 are 59-73 MB
// (18-22 us at 3.35 TB/s), and split TF32 triples the 10 B H S^2 D FLOPs
// (8-13 us at 495 / 3 TFLOP/s), so the products come close behind.  Hence the
// design below for S <= 128: the whole head in shared memory, one read of
// each input and one write of each output, 2-3 blocks per SM so that one
// block's loads overlap another's products, and P and dS kept in registers
// (recomputing S^T and dP^T for the key side costs two products; a shared-
// memory round trip of P and dS would cost more shared memory than two
// blocks per SM allow).  Nothing of size S^2 touches device memory.
//
// Layout: q, k, v, dout, dq, dk, dv are [B, H, S, D] contiguous; pad is
// [B, S] bytes (nonzero = padded key) or null.  Built by
// temporalalignnet_torch/ops/_build.py into a shared library with a plain C
// interface, called through ctypes.

#include "mha_bwd_f32.cuh"

namespace {

namespace f32 {

constexpr size_t DQ_SMEM = sizeof(float) * (4 * size_t(BT) * LD + BT);
constexpr size_t DKDV_SMEM = sizeof(float) * (4 * size_t(BT) * LD + 3 * BT);

// rows of tile i (8-row chunks up to the last row < S)
__device__ __forceinline__ int tile_rows(int S, int i) { return min(BT, (S - BT * i + 7) / 8 * 8); }

// S > 128, dQ: 4 warps, 64 query rows a block; the keys streamed twice
__global__ void __launch_bounds__(128)
mha_bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ pad,
                      const float* __restrict__ dout, float* __restrict__ dq,
                      float* __restrict__ stats, int H, int S, float scale, float scale2) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + BT * LD;
  float* ks = dos + BT * LD;
  float* vs = ks + BT * LD;
  float* kbias = vs + BT * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * BT;
  const size_t base = size_t(bh) * S * D;
  const uint8_t* pb = pad != nullptr ? pad + size_t(bh / H) * S : nullptr;
  tf32x3::load_rows(qs, q + base, q0, BT, S);
  tf32x3::load_rows(dos, dout + base, q0, BT, S);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  float li[2], dl[2];
  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // pass 0: row max, sum and sum of e^x dP, online (this lane's share of the
  // sums); pass 1: dS and dQ
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i * BT < S; ++i) {
      __syncthreads();  // every warp is done with the last tile
      const int rows = tile_rows(S, i);
      tf32x3::load_rows(ks, k + base, BT * i, rows, S);
      tf32x3::load_rows(vs, v + base, BT * i, rows, S);
      for (int j = threadIdx.x; j < BT; j += blockDim.x) kbias[j] = key_bias(pb, BT * i + j, S);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float sc[BT / 8][4], dp[BT / 8][4];
      tf32x3::rows_dot(sc, qs + 16 * warp * LD, ks, rows / 8, lane);
      tf32x3::rows_dot(dp, dos + 16 * warp * LD, vs, rows / 8, lane);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(sc[j][e], scale2, kbias[8 * j + 2 * t + (e & 1)]);
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      if (pass == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = tf32x3::quad_max(mx[h]);  // finite: the tile holds a key < S
          const float corr = exp2f(m[h] - mx[h]);
          l[h] *= corr;
          a[h] *= corr;
          m[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[j][e] - m[e >> 1]);
            l[e >> 1] += p;
            a[e >> 1] += p * dp[j][e];
          }
      } else {
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[j][e] - m[e >> 1]) * li[e >> 1];
            dp[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS
          }
        tf32x3::acc_mul(acc, dp, ks, rows / 8, lane);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        li[h] = 1.f / tf32x3::quad_sum(l[h]);
        dl[h] = tf32x3::quad_sum(a[h]) * li[h];
        const int r = q0 + 16 * warp + g + 8 * h;
        if (t == 0 && r < S) {
          const size_t plane = size_t(gridDim.x) * S;
          stats[size_t(bh) * S + r] = m[h];
          stats[plane + size_t(bh) * S + r] = li[h];
          stats[2 * plane + size_t(bh) * S + r] = dl[h];
        }
      }
    }
  }
  tf32x3::store_rows(dq + base, acc, q0 + 16 * warp, S, scale, scale, lane);
}

// S > 128, dK and dV: 4 warps, 64 keys a block; the queries streamed with
// their statistics
__global__ void __launch_bounds__(128)
mha_bwd_f32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ pad,
                        const float* __restrict__ dout, const float* __restrict__ stats,
                        float* __restrict__ dk, float* __restrict__ dv, int H, int S,
                        float scale, float scale2) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = ks + BT * LD;
  float* qs = vs + BT * LD;
  float* dos = qs + BT * LD;
  float* m2 = dos + BT * LD;  // [BT] per query of the tile, 0 past S
  float* linv = m2 + BT;
  float* delta = linv + BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2;
  const int bh = blockIdx.x, k0 = blockIdx.y * BT;
  const size_t base = size_t(bh) * S * D, plane = size_t(gridDim.x) * S;
  const uint8_t* pb = pad != nullptr ? pad + size_t(bh / H) * S : nullptr;
  tf32x3::load_rows(ks, k + base, k0, BT, S);
  tf32x3::load_rows(vs, v + base, k0, BT, S);
  cp_async_commit();
  const float kb[2] = {key_bias(pb, k0 + 16 * warp + g, S), key_bias(pb, k0 + 16 * warp + g + 8, S)};
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.f;
  for (int i = 0; i * BT < S; ++i) {
    __syncthreads();  // every warp is done with the last tile
    const int rows = tile_rows(S, i), q0 = BT * i;
    tf32x3::load_rows(qs, q + base, q0, rows, S);
    tf32x3::load_rows(dos, dout + base, q0, rows, S);
    for (int j = threadIdx.x; j < BT; j += blockDim.x) {
      const bool in = q0 + j < S;  // a query past S gets P = 0
      const size_t r = size_t(bh) * S + q0 + j;
      m2[j] = in ? stats[r] : 0.f;
      linv[j] = in ? stats[plane + r] : 0.f;
      delta[j] = in ? stats[2 * plane + r] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int s0 = 0; s0 < rows; s0 += QT) {
      const int nch = min(QT / 8, (rows - s0) / 8);
      if (nch == QT / 8)
        keys_step<QT / 8, true>(gk, gv, ks + 16 * warp * LD, vs + 16 * warp * LD, qs + s0 * LD,
                                dos + s0 * LD, m2 + s0, linv + s0, delta + s0, kb, nch, scale2,
                                lane);
      else  // the last queries of a ragged tile
        keys_step<QT / 8, false>(gk, gv, ks + 16 * warp * LD, vs + 16 * warp * LD, qs + s0 * LD,
                                 dos + s0 * LD, m2 + s0, linv + s0, delta + s0, kb, nch, scale2,
                                 lane);
    }
  }
  tf32x3::store_rows(dk + base, gk, k0 + 16 * warp, S, scale, scale, lane);
  tf32x3::store_rows(dv + base, gv, k0 + 16 * warp, S, 1.f, 1.f, lane);
}

cudaError_t launch(const void* q_, const void* k_, const void* v_, const void* pad_,
                   const void* dout_, void* dq_, void* dk_, void* dv_, void* stats, int B, int H,
                   int S, cudaStream_t stream) {
  const auto* q = static_cast<const float*>(q_);
  const auto* k = static_cast<const float*>(k_);
  const auto* v = static_cast<const float*>(v_);
  const auto* dout = static_cast<const float*>(dout_);
  const auto* pad = static_cast<const uint8_t*>(pad_);
  auto* dq = static_cast<float*>(dq_);
  auto* dk = static_cast<float*>(dk_);
  auto* dv = static_cast<float*>(dv_);
  const int BH = B * H;
  switch ((S + 15) / 16) {  // warps rounded up to an instantiated count
    case 1: case 2: return launch_fused<2>(q, k, v, pad, dout, dq, dk, dv, BH, H, S, stream);
    case 3: case 4: return launch_fused<4>(q, k, v, pad, dout, dq, dk, dv, BH, H, S, stream);
    case 5: return launch_fused<5>(q, k, v, pad, dout, dq, dk, dv, BH, H, S, stream);
    case 6: case 7: case 8: return cudaErrorInvalidValue;  // mha_bwd_f32_wide
  }
  if (stats == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_f32_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(DQ_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_f32_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(DKDV_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(BH), unsigned((S + BT - 1) / BT));
  const float scale = 1.0f / sqrtf(float(D)), scale2 = LOG2E * scale;
  mha_bwd_f32_dq_kernel<<<grid, 128, DQ_SMEM, stream>>>(q, k, v, pad, dout, dq,
                                                        static_cast<float*>(stats), H, S, scale,
                                                        scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_f32_dkdv_kernel<<<grid, 128, DKDV_SMEM, stream>>>(
      q, k, v, pad, dout, static_cast<const float*>(stats), dk, dv, H, S, scale, scale2);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// The f32 route at S <= 80 (one kernel, no scratch: stats may be null) and
// past S = 128 (the dq and dk/dv kernels, stats: 3 B H S f32 of scratch);
// 80 < S <= 128 is mha_bwd_f32_wide's.  Pointers 16-byte aligned
// (cp.async).  Returns a cudaError_t (0 = launched).
extern "C" int mha_bwd_f32(const void* q, const void* k, const void* v, const void* pad,
                           const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
                           int H, int S, int head_dim, void* stream) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != D || (S + BT - 1) / BT > 65535)
    return int(cudaErrorInvalidValue);
  return int(f32::launch(q, k, v, pad, dout, dq, dk, dv, stats, B, H, S,
                         static_cast<cudaStream_t>(stream)));
}
