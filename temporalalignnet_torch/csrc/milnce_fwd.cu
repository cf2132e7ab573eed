// Fused MIL-NCE forward (sm_90a), the f32 route and the earlier bf16 kernel
// (milnce_fwd_v1; the bf16 route is milnce_wgmma.cu's milnce_fwd_wgmma): per
// layer s, the four masked logsumexps of sim = inv_temp * v[s] t[s]^T
// without writing sim:
//   vnum[s, r] = lse_k pos,  vden[s, r] = lse_k neg,
//   tnum[s, k] = lse_r pos,  tden[s, k] = lse_r neg,
// pos = where(pm[r, k], sim, mask_value), neg = where(cv[k], sim, mask_value).
//
// Replaces temporalalignnet_tpu/ops/pallas_milnce.py::_milnce_fwd_kernel
// (untiled) and ::_milnce_fwd_tiled_kernel (K streamed in column blocks):
// the TPU needs two plans because its VMEM holds the whole [K, C] text block
// only up to K ~ 1024; here one kernel streams K in tiles of 64 at any R and K.
//
// What bounds it on an H100: at the B = 64 training shape (S = 6 layers,
// R = 4096, K = 1024, C = 512, bf16) the work is 2 S R K C = 25.8 GFLOP
// (26 us of bf16 tensor-core time) against ~36 MB of v, t and pm (11 us), so
// it is bound by operations.  A block owns (layer, 64 rows) and streams the
// text in 64-column tiles (milnce_tile.cuh's sim_tile: the tensor cores in
// bf16, the training path; f32 FMAs in f32, the parity path).  The row
// logsumexps run as an online (max, sum) recurrence, so vnum and vden need no
// second pass;
// every tile's column (max, sum) pairs over its 64 rows go to a
// [4, S, R/64, K] scratch, which milnce_colmerge_kernel (milnce_colmerge.cuh)
// folds into tnum and tden with the same recurrence (pallas_milnce.py:108-120).
//
// The dual branch's text, shared by every layer, is read with a layer stride
// of 0 and never broadcast in memory.  pm is a [R, K] byte mask (nonzero =
// positive) with col_valid already applied, cv a [K] byte mask; both are
// passed as bytes rather than rebuilt from the block-diagonal target, so the
// kernel keeps the general contract of fused_milnce_elements.  Any R and K;
// C a multiple of 64.  Built by temporalalignnet_torch/ops/_build.py into a
// shared library with a plain C interface, called through ctypes.

#include "milnce_colmerge.cuh"
#include "milnce_tile.cuh"

namespace {

using namespace milnce;

// 4 warps; each sim tile through shared memory (sim_tile<T>); the row pass
// takes half a row per thread, the column pass half a column.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
milnce_fwd_kernel(const T* __restrict__ v, const T* __restrict__ t, long long t_ls,
                  const uint8_t* __restrict__ pm, const uint8_t* __restrict__ cv,
                  float* __restrict__ vnum, float* __restrict__ vden,
                  float* __restrict__ part, int R, int K, int C, float mv, float inv_temp) {
  __shared__ __align__(16) unsigned char stage[STAGE_BYTES];
  __shared__ float sim[TILE * SIM_LD];
  __shared__ uint8_t pms[TILE * TILE];
  __shared__ uint8_t cvs[TILE];

  const int rb = blockIdx.x, s = blockIdx.y, nrb = gridDim.x, S = gridDim.y;
  const int r0 = rb * TILE;
  const int nrow = min(TILE, R - r0);
  const T* vs = v + size_t(s) * R * C;
  const T* ts = t + size_t(s) * size_t(t_ls);
  const int tid = threadIdx.x;
  const int half = tid % 2;  // row pass: row tid / 2, columns 32 half ..
  const int row = tid / 2;   // column pass: column tid / 2, rows 32 half ..
  const int col = tid / 2;
  const size_t plane = size_t(S) * nrb * K;  // one of the four partial arrays

  float mp = -INFINITY, sp = 0.f, mn = -INFINITY, sn = 0.f;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    const int ncol = min(TILE, K - k0);
    stage_mask(pms, pm, r0, R, k0, K);
    for (int j = tid; j < TILE; j += NTHREADS) cvs[j] = (j < ncol) ? cv[k0 + j] : 0;
    sim_tile<T>(vs, r0, R, ts, k0, K, C, stage, sim);  // its syncs publish pms, cvs

    // row direction: online (max, sum) over this thread's half row
    {
      const float* srow = sim + row * SIM_LD;
      const uint8_t* prow = pms + row * TILE;
      const int j1 = min(half * 32 + 32, ncol);
      float bmp = -INFINITY, bmn = -INFINITY;
      for (int j = half * 32; j < j1; ++j) {
        const float x = srow[j] * inv_temp;
        bmp = fmaxf(bmp, prow[j] ? x : mv);
        bmn = fmaxf(bmn, cvs[j] ? x : mv);
      }
      float bsp = 0.f, bsn = 0.f;
      for (int j = half * 32; j < j1; ++j) {
        const float x = srow[j] * inv_temp;
        bsp += expf((prow[j] ? x : mv) - bmp);
        bsn += expf((cvs[j] ? x : mv) - bmn);
      }
      lse_merge(mp, sp, bmp, bsp);
      lse_merge(mn, sn, bmn, bsn);
    }

    // column direction: (max, sum) of this tile's real rows, per column
    {
      float cmp = -INFINITY, cmn = -INFINITY, csp = 0.f, csn = 0.f;
      if (col < ncol) {
        const int i1 = min(half * 32 + 32, nrow);
        const bool c_ok = cvs[col] != 0;
        for (int i = half * 32; i < i1; ++i) {
          const float x = sim[i * SIM_LD + col] * inv_temp;
          cmp = fmaxf(cmp, pms[i * TILE + col] ? x : mv);
          cmn = fmaxf(cmn, c_ok ? x : mv);
        }
        for (int i = half * 32; i < i1; ++i) {
          const float x = sim[i * SIM_LD + col] * inv_temp;
          if (cmp != -INFINITY) csp += expf((pms[i * TILE + col] ? x : mv) - cmp);
          if (cmn != -INFINITY) csn += expf((c_ok ? x : mv) - cmn);
        }
      }
      // the two halves of a column are adjacent lanes
      lse_merge(cmp, csp, __shfl_xor_sync(0xffffffffu, cmp, 1),
                __shfl_xor_sync(0xffffffffu, csp, 1));
      lse_merge(cmn, csn, __shfl_xor_sync(0xffffffffu, cmn, 1),
                __shfl_xor_sync(0xffffffffu, csn, 1));
      if (half == 0 && col < ncol) {
        const size_t p = (size_t(s) * nrb + rb) * K + k0 + col;
        part[p] = cmp;
        part[plane + p] = csp;
        part[2 * plane + p] = cmn;
        part[3 * plane + p] = csn;
      }
    }
    __syncthreads();  // pms, cvs and sim are rewritten by the next tile
  }

  lse_merge(mp, sp, __shfl_xor_sync(0xffffffffu, mp, 1), __shfl_xor_sync(0xffffffffu, sp, 1));
  lse_merge(mn, sn, __shfl_xor_sync(0xffffffffu, mn, 1), __shfl_xor_sync(0xffffffffu, sn, 1));
  if (half == 0 && row < nrow) {
    vnum[size_t(s) * R + r0 + row] = mp + logf(sp);
    vden[size_t(s) * R + r0 + row] = mn + logf(sn);
  }
}

template <typename T>
cudaError_t launch(const void* v, const void* t, long long t_ls, const void* pm, const void* cv,
                   void* vnum, void* vden, void* tnum, void* tden, void* part, int S, int R,
                   int K, int C, float mv, float inv_temp, cudaStream_t stream) {
  const int nrb = (R + TILE - 1) / TILE;
  milnce_fwd_kernel<T><<<dim3(unsigned(nrb), unsigned(S)), NTHREADS, 0, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(t), t_ls,
      static_cast<const uint8_t*>(pm), static_cast<const uint8_t*>(cv),
      static_cast<float*>(vnum), static_cast<float*>(vden), static_cast<float*>(part), R, K, C,
      mv, inv_temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colmerge(part, tnum, tden, S, R, K, stream);
}

}  // namespace

// v [S, R, C]; t [K, C] per layer at a stride of t_layer_stride elements (0:
// one text shared by every layer); pm [R, K] and cv [K] bytes; vnum, vden
// [S, R], tnum, tden [S, K] f32; part: 4 S ceil(R/64) K f32 of scratch.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int milnce_fwd(const void* v, const void* t, long long t_layer_stride, const void* pm,
                          const void* cv, void* vnum, void* vden, void* tnum, void* tden,
                          void* part, int S, int R, int K, int C, int dtype, float mask_value,
                          float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, part, S, R, K,
                             C, mask_value, inv_temp, st));
  if (dtype == 1)
    return int(launch<__nv_bfloat16>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, part,
                                     S, R, K, C, mask_value, inv_temp, st));
  return int(cudaErrorInvalidValue);
}
