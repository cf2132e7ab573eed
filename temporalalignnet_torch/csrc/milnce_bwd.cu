// MIL-NCE backward for Hopper (sm_90a), the earlier bf16 kernels (v2): the
// feature gradients of v_el = vden - vnum and t_el = tden - tnum
// (milnce_fwd.cu) from the saved logsumexps, without writing sim.  No route
// takes them any more (bf16 runs csrc/milnce_wgmma.cu, f32
// csrc/milnce_grad_f32.cu); ops/milnce.py's milnce_dv_v2 and milnce_dt_v2
// call them, uncounted, so that a run can time the redesign beside them.
// Per 64 x 64 tile the sim tile is recomputed and turned into
//   dsim = inv_temp * (gv[r] (p_neg - p_pos) + gt[k] (q_neg - q_pos)),
//   p_pos = pm ? exp(sim - vnum[r]) : 0,  p_neg = cv ? exp(sim - vden[r]) : 0,
//   q_pos = pm ? exp(sim - tnum[k]) : 0,  q_neg = cv ? exp(sim - tden[k]) : 0,
// with the probabilities re-masked as _dsim_tile does
// (pallas_milnce.py:128-151), so a fully masked row's uniform softmax never
// leaks into dsim.  gv and gt are the cotangents of v_el and t_el (the JAX
// contract's four cotangents are -gv, gv, -gt, gt).
//
// One template over the orientation (ROWS_OUTER):
// - milnce_dv, ROWS_OUTER: a block owns 64 rows of one layer and streams the
//   text columns: dv[r] = sum_k dsim[r, k] t[k].
// - milnce_dt: a block owns 64 text columns and streams rows: dt[k] =
//   sum_r dsim[r, k] v[r].  With the dual branch's shared text it also sums
//   over the layers (the broadcast's VJP, pallas_milnce.py:921-924).
// The counterparts of temporalalignnet_tpu/ops/pallas_milnce.py::
// _milnce_bwd_kernel, ::_milnce_dv_kernel and ::_milnce_dt_kernel.
//
// dsim is cast to bf16 before the product, as the TPU kernel does
// (pallas_milnce.py:174-187), and the product accumulates in f32 ([64, C],
// C <= 512) in registers, on mma.sync, ldmatrix and cp.async.  The stream
// over the inner axis may be split across blocks, and every split writes its
// own f32 partial, which milnce_reduce_kernel sums in a fixed order and
// casts: deterministic.

#include "milnce_tile.cuh"

namespace {

using namespace milnce;

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

// out[y, o, c] = sum over splits of part[split, y, o, c], cast to bf16
__global__ void milnce_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                                     size_t n, int splits) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float x = 0.f;
  for (int s = 0; s < splits; ++s) x += part[size_t(s) * n + idx];
  out[idx] = __float2bfloat16(x);
}

template <bool ROWS_OUTER>
int dispatch(const void* v, const void* t, long long t_ls, const void* pm, const void* cv,
             const void* vnum, const void* vden, const void* tnum, const void* tden,
             const void* gv, const void* gt, void* out, void* part, int S, int R, int K, int C,
             int out_layers, int splits, int dtype, float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0 || C > 512 ||
      splits <= 0 || splits > 65535 || (out_layers != S && out_layers != 1) || dtype != 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = v2_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(milnce_grad_bf16_kernel<ROWS_OUTER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int nO = ROWS_OUTER ? R : K, nI = ROWS_OUTER ? K : R;
  const int itiles = (nI + TILE - 1) / TILE;
  const int per_split = (itiles + splits - 1) / splits;
  splits = (itiles + per_split - 1) / per_split;  // no empty split
  const dim3 grid(unsigned((nO + TILE - 1) / TILE), unsigned(out_layers), unsigned(splits));
  milnce_grad_bf16_kernel<ROWS_OUTER><<<grid, V2_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(t), t_ls,
      static_cast<const uint8_t*>(pm), static_cast<const uint8_t*>(cv),
      static_cast<const float*>(vnum), static_cast<const float*>(vden),
      static_cast<const float*>(tnum), static_cast<const float*>(tden),
      static_cast<const float*>(gv), static_cast<const float*>(gt), static_cast<float*>(part), R,
      K, C, S / out_layers, per_split, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t n = size_t(out_layers) * nO * C;
  milnce_reduce_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), n, splits);
  return int(cudaGetLastError());
}

}  // namespace

// Inputs as milnce_fwd (v [S, R, C]; t at t_layer_stride per layer; pm [R, K],
// cv [K] bytes), the saved vnum, vden [S, R] and tnum, tden [S, K], and the
// cotangents gv [S, R], gt [S, K] (f32).  part: splits * out_layers * n_out * C
// f32 of scratch.  dtype: 1 = bfloat16, the only one taken.  C <= 512.
// Returns a cudaError_t (0 = launched).
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
