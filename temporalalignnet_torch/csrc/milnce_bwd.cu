// Fused MIL-NCE backward for Hopper (sm_90a): the feature gradients of
// v_el = vden - vnum and t_el = tden - tnum (milnce_fwd.cu) from the saved
// logsumexps, without writing sim.  Per 64 x 64 tile the sim tile is
// recomputed and turned into
//   dsim = inv_temp * (gv[r] (p_neg - p_pos) + gt[k] (q_neg - q_pos)),
//   p_pos = pm ? exp(sim - vnum[r]) : 0,  p_neg = cv ? exp(sim - vden[r]) : 0,
//   q_pos = pm ? exp(sim - tnum[k]) : 0,  q_neg = cv ? exp(sim - tden[k]) : 0,
// with the probabilities re-masked as _dsim_tile does
// (pallas_milnce.py:128-151), so a fully masked row's uniform softmax never
// leaks into dsim.  gv and gt are the cotangents of v_el and t_el (the JAX
// contract's four cotangents are -gv, gv, -gt, gt).
//
// Two kernels, each one template over the orientation (ROWS_OUTER):
// - milnce_dv, ROWS_OUTER: a block owns 64 rows of one layer and streams the
//   text columns: dv[r] = sum_k dsim[r, k] t[k].
// - milnce_dt: a block owns 64 text columns and streams rows: dt[k] =
//   sum_r dsim[r, k] v[r].  With the dual branch's shared text it also sums
//   over the layers (the broadcast's VJP, pallas_milnce.py:921-924).
// Replaces temporalalignnet_tpu/ops/pallas_milnce.py::_milnce_bwd_kernel
// (untiled: dv and dt in one pass), ::_milnce_dv_kernel and
// ::_milnce_dt_kernel (the column-tiled pair the TPU takes at B >= 128):
// these kernels take any R and K, so one pair covers all three.
//
// dsim is cast to the input dtype before the product, as the TPU kernel does
// (pallas_milnce.py:174-187), and the product accumulates in f32 ([64, C],
// C <= 512): in registers on the bf16 path, in shared memory on the f32 one.
// Both kernels are deterministic: the stream
// over the inner axis may be split across blocks (to fill the card when the
// outer axis is short, e.g. dt at K = 1024), and every split writes its own
// f32 partial, which milnce_reduce_kernel sums in a fixed order and casts.
//
// What bounds it on an H100: 4 S R K C FLOPs per kernel (sim again, then the
// product) = 51.5 GFLOP at the B = 64 training shape, 52 us of bf16
// tensor-core time, against ~40 MB of inputs and outputs: bound by
// operations.  bf16 runs on the tensor cores (mma.sync, ldmatrix, cp.async;
// milnce_grad_bf16_kernel), f32 as f32 FMAs on the CUDA cores
// (milnce_grad_f32_kernel), the parity path.

#include "milnce_tile.cuh"

namespace {

using namespace milnce;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [n0, n0 + 64) x 64 channels from c0 of a row-major f32 [n, C] array
// into dst[64][F_LD]
__device__ __forceinline__ void stage_f32_rows(float* dst, const float* src, int n0, int n,
                                               int C, int c0) {
  for (int e = threadIdx.x; e < TILE * TILE; e += NTHREADS) {
    const int j = e / TILE, c = e % TILE;
    dst[j * F_LD + c] = (n0 + j < n) ? src[size_t(n0 + j) * C + c0 + c] : 0.f;
  }
}

constexpr size_t smem_bytes(int C) {
  // acc [64][C] f32 | stage | sim / dsim [64][SIM_LD] f32 | pm [64][64]
  return size_t(TILE) * C * 4 + STAGE_BYTES + size_t(TILE) * SIM_LD * 4 + size_t(TILE) * TILE;
}

// ------------------------------------------------------- f32: CUDA cores
//
// 4 warps; the sim tile through shared memory (milnce_tile.cuh), dsim in
// place, and the product accumulated into a [64][C] f32 tile in shared
// memory, 64 channels at a time (thread (rg, cg): rows 4 rg .., channels 8 cg ..).

template <bool ROWS_OUTER>
__global__ void __launch_bounds__(NTHREADS)
milnce_grad_f32_kernel(const float* __restrict__ v, const float* __restrict__ t, long long t_ls,
                       const uint8_t* __restrict__ pm, const uint8_t* __restrict__ cv,
                       const float* __restrict__ vnum, const float* __restrict__ vden,
                       const float* __restrict__ tnum, const float* __restrict__ tden,
                       const float* __restrict__ gv, const float* __restrict__ gt,
                       float* __restrict__ part, int R, int K, int C, int layers,
                       int tiles_per_split, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + size_t(TILE) * C * 4;
  float* sim = reinterpret_cast<float*>(stage + STAGE_BYTES);
  uint8_t* pms = reinterpret_cast<uint8_t*>(sim + TILE * SIM_LD);

  const int nO = ROWS_OUTER ? R : K, nI = ROWS_OUTER ? K : R;
  const int o0 = blockIdx.x * TILE;
  const int y = blockIdx.y;  // output layer (dv, per-layer dt) or 0 (shared-text dt)
  const int split = blockIdx.z;
  const int it0 = split * tiles_per_split;
  const int it1 = min(it0 + tiles_per_split, (nI + TILE - 1) / TILE);
  const int tid = threadIdx.x, rg = tid / 8, cg = tid % 8;

  for (int e = tid; e < TILE * C; e += NTHREADS) acc[e] = 0.f;

  for (int s = y * layers; s < (y + 1) * layers; ++s) {
    const float* vs = v + size_t(s) * R * C;
    const float* ts = t + size_t(s) * size_t(t_ls);
    const float* O = ROWS_OUTER ? vs : ts;
    const float* I = ROWS_OUTER ? ts : vs;
    const float* vn = vnum + size_t(s) * R;
    const float* vd = vden + size_t(s) * R;
    const float* gvs = gv + size_t(s) * R;
    const float* tn = tnum + size_t(s) * K;
    const float* td = tden + size_t(s) * K;
    const float* gts = gt + size_t(s) * K;
    for (int it = it0; it < it1; ++it) {
      const int i0 = it * TILE;
      __syncthreads();  // the last tile's readers of pms, sim and stage are done
      if (ROWS_OUTER)
        stage_mask(pms, pm, o0, R, i0, K);
      else
        stage_mask(pms, pm, i0, R, o0, K);
      sim_tile<float>(O, o0, nO, I, i0, nI, C, stage, sim);

      // d loss / d sim of the tile, in place
      for (int e = tid; e < TILE * TILE; e += NTHREADS) {
        const int a = e / TILE, b = e % TILE;  // outer, inner
        const int r = ROWS_OUTER ? o0 + a : i0 + b;
        const int k = ROWS_OUTER ? i0 + b : o0 + a;
        float d = 0.f;
        if (r < R && k < K) {
          const float x = sim[a * SIM_LD + b] * inv_temp;
          const bool pos = (ROWS_OUTER ? pms[a * TILE + b] : pms[b * TILE + a]) != 0;
          if (pos) d -= gvs[r] * expf(x - vn[r]) + gts[k] * expf(x - tn[k]);
          if (cv[k]) d += gvs[r] * expf(x - vd[r]) + gts[k] * expf(x - td[k]);
          d *= inv_temp;
        }
        sim[a * SIM_LD + b] = d;
      }

      // acc[a][:] += dsim[a][b] I[i0 + b][:], 64 channels at a time
      for (int c0 = 0; c0 < C; c0 += TILE) {
        __syncthreads();  // dsim is complete; the last chunk's readers are done
        float* ist = reinterpret_cast<float*>(stage);
        stage_f32_rows(ist, I, i0, nI, C, c0);
        __syncthreads();
        float p[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) p[i][j] = 0.f;
#pragma unroll 4
        for (int b = 0; b < TILE; ++b) {
          const float4 ia = *reinterpret_cast<const float4*>(&ist[b * F_LD + cg * 8]);
          const float4 ib = *reinterpret_cast<const float4*>(&ist[b * F_LD + cg * 8 + 4]);
          const float iv[8] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = sim[(rg * 4 + i) * SIM_LD + b];
#pragma unroll
            for (int j = 0; j < 8; ++j) p[i][j] = fmaf(d, iv[j], p[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[(rg * 4 + i) * C + c0 + cg * 8 + j] += p[i][j];
      }
    }
  }
  __syncthreads();
  const int nrow = min(TILE, nO - o0);
  float* out = part + ((size_t(split) * gridDim.y + y) * nO + o0) * C;
  for (int e = tid; e < nrow * C; e += NTHREADS) out[e] = acc[e];
}

// ------------------------------------------------ bf16: tensor cores, v2
//
// The v2 tile scheme of milnce_tile.cuh: outer rows resident, inner tiles
// double buffered, the sim fragment in registers, where dsim is formed and
// rounded to bf16 into shared memory; the product's f32 accumulator [64][C]
// stays in registers too (warp w: rows 16 (w % 4) .., channels (w / 4) C / 2 ..).

constexpr size_t v2_smem_bytes(int C) {
  // outer rows | two inner tiles ([64][C + 8] bf16 each) | dsim [64][BF_LD] bf16 | two pm tiles
  return 3 * size_t(TILE) * (C + 8) * 2 + size_t(TILE) * BF_LD * 2 + 2 * size_t(TILE) * TILE;
}

template <bool ROWS_OUTER>
__global__ void __launch_bounds__(V2_THREADS, 1)
milnce_grad_bf16_kernel(const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ t,
                        long long t_ls, const uint8_t* __restrict__ pm,
                        const uint8_t* __restrict__ cv, const float* __restrict__ vnum,
                        const float* __restrict__ vden, const float* __restrict__ tnum,
                        const float* __restrict__ tden, const float* __restrict__ gv,
                        const float* __restrict__ gt, float* __restrict__ part, int R, int K,
                        int C, int layers, int tiles_per_split, float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDC = C + 8;
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* is[2] = {os + TILE * LDC, os + 2 * TILE * LDC};
  __nv_bfloat16* ds = os + 3 * TILE * LDC;
  uint8_t* pms[2] = {reinterpret_cast<uint8_t*>(ds + TILE * BF_LD),
                     reinterpret_cast<uint8_t*>(ds + TILE * BF_LD) + TILE * TILE};

  const int nO = ROWS_OUTER ? R : K, nI = ROWS_OUTER ? K : R;
  const int o0 = blockIdx.x * TILE;
  const int y = blockIdx.y, split = blockIdx.z;
  const int it0 = split * tiles_per_split;
  const int it1 = min(it0 + tiles_per_split, (nI + TILE - 1) / TILE);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = (warp % 4) * 16;         // this warp's outer rows
  const int wc = (warp / 4) * 32;         // its inner columns in the sim tile
  const int ch0 = (warp / 4) * (C / 2);   // its channels in the product
  const int nch = C / 16;                 // its 8-channel chunks (<= 32)

  float acc[V2_MAXC / 16][4];
#pragma unroll
  for (int n = 0; n < V2_MAXC / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int s = y * layers; s < (y + 1) * layers; ++s) {
    const __nv_bfloat16* vs = v + size_t(s) * R * C;
    const __nv_bfloat16* ts = t + size_t(s) * size_t(t_ls);
    const __nv_bfloat16* O = ROWS_OUTER ? vs : ts;
    const __nv_bfloat16* I = ROWS_OUTER ? ts : vs;
    const float* vn = vnum + size_t(s) * R;
    const float* vd = vden + size_t(s) * R;
    const float* gvs = gv + size_t(s) * R;
    const float* tn = tnum + size_t(s) * K;
    const float* td = tden + size_t(s) * K;
    const float* gts = gt + size_t(s) * K;
    // this thread's two outer entries' vectors: (g, g + 8) of the warp's rows
    float on[2], od[2], og[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + wr + g + 8 * h;
      const bool in = o < nO;
      on[h] = in ? (ROWS_OUTER ? vn[o] : tn[o]) : 0.f;
      od[h] = in ? (ROWS_OUTER ? vd[o] : td[o]) : 0.f;
      og[h] = in ? (ROWS_OUTER ? gvs[o] : gts[o]) : 0.f;
    }

    __syncthreads();  // the last layer's readers of os, is, ds and pms are done
    v2_stage_rows(os, O, o0, nO, C);
    auto load_tile = [&](int buf, int it) {
      v2_stage_rows(is[buf], I, it * TILE, nI, C);
      if (ROWS_OUTER)
        v2_stage_mask(pms[buf], pm, o0, R, it * TILE, K);
      else
        v2_stage_mask(pms[buf], pm, it * TILE, R, o0, K);
      cp_async_commit();
    };
    if (it0 < it1) load_tile(0, it0);
    for (int it = it0; it < it1; ++it) {
      const int buf = (it - it0) & 1, i0 = it * TILE;
      if (it + 1 < it1) {
        load_tile(buf ^ 1, it + 1);  // that buffer was released at the end of it - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile `it` (and the outer rows) are in shared memory

      // sim on the tensor cores: rows wr .. +15, columns wc .. +31
      const __nv_bfloat16* ib = is[buf];
      float sc[4][4];
      v2_sim(sc, os, ib, C, wr, wc);
      // dsim of the fragment, rounded to bf16 into ds
      const uint8_t* pb = pms[buf];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int b = wc + n * 8 + 2 * tq + j;  // inner entry in the tile
          const int inner = i0 + b;
          const bool in_ok = inner < nI;
          const float in_n = in_ok ? (ROWS_OUTER ? tn[inner] : vn[inner]) : 0.f;
          const float in_d = in_ok ? (ROWS_OUTER ? td[inner] : vd[inner]) : 0.f;
          const float in_g = in_ok ? (ROWS_OUTER ? gts[inner] : gvs[inner]) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int a = wr + g + 8 * h;  // outer entry in the tile
            const int r = ROWS_OUTER ? o0 + a : inner;
            const int k = ROWS_OUTER ? inner : o0 + a;
            float d = 0.f;
            if (r < R && k < K) {
              const float x = sc[n][2 * h + j] * inv_temp;
              // row-side (r) and column-side (k) vectors
              const float rn = ROWS_OUTER ? on[h] : in_n, rd = ROWS_OUTER ? od[h] : in_d;
              const float rg = ROWS_OUTER ? og[h] : in_g;
              const float kn = ROWS_OUTER ? in_n : on[h], kd = ROWS_OUTER ? in_d : od[h];
              const float kg = ROWS_OUTER ? in_g : og[h];
              const bool pos = (ROWS_OUTER ? pb[a * TILE + b] : pb[b * TILE + a]) != 0;
              if (pos) d -= rg * expf(x - rn) + kg * expf(x - kn);
              if (cv[k]) d += rg * expf(x - rd) + kg * expf(x - kd);
              d *= inv_temp;
            }
            ds[a * BF_LD + b] = __float2bfloat16(d);
          }
        }
      }
      __syncthreads();  // ds is complete

      // acc[rows wr ..][channels ch0 ..] += dsim[rows][0 .. 64) I[0 .. 64)[channels]
      uint32_t af[TILE / 16][4];
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        ldsm_x4(af[kk], &ds[(wr + (lane & 15)) * BF_LD + kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int n = 0; n < V2_MAXC / 16; n += 2) {
        if (n < nch) {
#pragma unroll
          for (int kk = 0; kk < TILE / 16; ++kk) {
            uint32_t r4[4];
            ldsm_x4_trans(r4, &ib[(kk * 16 + (lane & 15)) * LDC + ch0 + (n + (lane >> 4)) * 8]);
            mma_16816(acc[n], af[kk], r4[0], r4[1]);
            mma_16816(acc[n + 1], af[kk], r4[2], r4[3]);
          }
        }
      }
      __syncthreads();  // every warp is done with is[buf], ds and pms[buf]
    }
  }

  float* out = part + (size_t(split) * gridDim.y + y) * size_t(nO) * C;
#pragma unroll
  for (int n = 0; n < V2_MAXC / 16; ++n) {
    if (n < nch) {
      const int c = ch0 + n * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wr + g + 8 * h;
        if (o < nO) {
          out[size_t(o) * C + c] = acc[n][2 * h];
          out[size_t(o) * C + c + 1] = acc[n][2 * h + 1];
        }
      }
    }
  }
}

// out[y, o, c] = sum over splits of part[split, y, o, c], cast to T
template <typename T>
__global__ void milnce_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                                     size_t n, int splits) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float x = 0.f;
  for (int s = 0; s < splits; ++s) x += part[size_t(s) * n + idx];
  store_out(out + idx, x);
}

template <typename T, bool ROWS_OUTER>
cudaError_t launch(const void* v, const void* t, long long t_ls, const void* pm, const void* cv,
                   const void* vnum, const void* vden, const void* tnum, const void* tden,
                   const void* gv, const void* gt, void* out, void* part, int S, int R, int K,
                   int C, int out_layers, int splits, float inv_temp, cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  const size_t smem = BF16 ? v2_smem_bytes(C) : smem_bytes(C);
  const void* kernel = BF16 ? reinterpret_cast<const void*>(milnce_grad_bf16_kernel<ROWS_OUTER>)
                            : reinterpret_cast<const void*>(milnce_grad_f32_kernel<ROWS_OUTER>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const int nO = ROWS_OUTER ? R : K, nI = ROWS_OUTER ? K : R;
  const int itiles = (nI + TILE - 1) / TILE;
  const int per_split = (itiles + splits - 1) / splits;
  splits = (itiles + per_split - 1) / per_split;  // no empty split
  const dim3 grid(unsigned((nO + TILE - 1) / TILE), unsigned(out_layers), unsigned(splits));
  const int layers = S / out_layers;
  if constexpr (BF16) {
    milnce_grad_bf16_kernel<ROWS_OUTER><<<grid, V2_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(t), t_ls,
        static_cast<const uint8_t*>(pm), static_cast<const uint8_t*>(cv),
        static_cast<const float*>(vnum), static_cast<const float*>(vden),
        static_cast<const float*>(tnum), static_cast<const float*>(tden),
        static_cast<const float*>(gv), static_cast<const float*>(gt), static_cast<float*>(part),
        R, K, C, layers, per_split, inv_temp);
  } else {
    milnce_grad_f32_kernel<ROWS_OUTER><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const float*>(v), static_cast<const float*>(t), t_ls,
        static_cast<const uint8_t*>(pm), static_cast<const uint8_t*>(cv),
        static_cast<const float*>(vnum), static_cast<const float*>(vden),
        static_cast<const float*>(tnum), static_cast<const float*>(tden),
        static_cast<const float*>(gv), static_cast<const float*>(gt), static_cast<float*>(part),
        R, K, C, layers, per_split, inv_temp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = size_t(out_layers) * nO * C;
  milnce_reduce_kernel<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n, splits);
  return cudaGetLastError();
}

template <bool ROWS_OUTER>
int dispatch(const void* v, const void* t, long long t_ls, const void* pm, const void* cv,
             const void* vnum, const void* vden, const void* tnum, const void* tden,
             const void* gv, const void* gt, void* out, void* part, int S, int R, int K, int C,
             int out_layers, int splits, int dtype, float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0 || C > 512 ||
      splits <= 0 || splits > 65535 || (out_layers != S && out_layers != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch<float, ROWS_OUTER>(v, t, t_ls, pm, cv, vnum, vden, tnum, tden, gv, gt, out,
                                         part, S, R, K, C, out_layers, splits, inv_temp, st));
  if (dtype == 1)
    return int(launch<__nv_bfloat16, ROWS_OUTER>(v, t, t_ls, pm, cv, vnum, vden, tnum, tden, gv,
                                                 gt, out, part, S, R, K, C, out_layers, splits,
                                                 inv_temp, st));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Inputs as milnce_fwd (v [S, R, C]; t at t_layer_stride per layer; pm [R, K],
// cv [K] bytes), the saved vnum, vden [S, R] and tnum, tden [S, K], and the
// cotangents gv [S, R], gt [S, K] (f32).  part: splits * out_layers * n_out * C
// f32 of scratch.  dtype: 0 = float32, 1 = bfloat16.  C <= 512.  Returns a
// cudaError_t (0 = launched).
//
// milnce_dv: dv [S, R, C] (out_layers = S).
extern "C" int milnce_dv(const void* v, const void* t, long long t_layer_stride, const void* pm,
                         const void* cv, const void* vnum, const void* vden, const void* tnum,
                         const void* tden, const void* gv, const void* gt, void* dv, void* part,
                         int S, int R, int K, int C, int splits, int dtype, float inv_temp,
                         void* stream) {
  return dispatch<true>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dv, part,
                        S, R, K, C, S, splits, dtype, inv_temp, stream);
}

// milnce_dt: dt [out_layers, K, C]; out_layers = 1 sums over the layers (the
// shared text of the dual branch), out_layers = S keeps one per layer.
extern "C" int milnce_dt(const void* v, const void* t, long long t_layer_stride, const void* pm,
                         const void* cv, const void* vnum, const void* vden, const void* tnum,
                         const void* tden, const void* gv, const void* gt, void* dt, void* part,
                         int S, int R, int K, int C, int out_layers, int splits, int dtype,
                         float inv_temp, void* stream) {
  return dispatch<false>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dt, part,
                         S, R, K, C, out_layers, splits, dtype, inv_temp, stream);
}
