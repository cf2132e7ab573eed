// Shared tile code of the earlier bf16 MIL-NCE kernels (milnce_fwd.cu's
// milnce_fwd_v1_kernel, milnce_bwd.cu), which no route takes any more.
//
// Every one of them walks 64 x 64 tiles of the similarity matrix
// sim[r][k] = v[r] . t[k] of one layer, with r the B*T video rows and k the
// B*N text columns.  A block owns 64 "outer" entries (rows, or for the dt
// kernel columns) and streams the "inner" ones in tiles of 64.  Two schemes:
// - sim_tile (the forward): 4 warps; the tile's dot products land in a
//   shared f32 sim[64][SIM_LD], from which the masked logsumexp passes read
//   in either orientation.  The tensor cores in bf16 (mma.sync m16n8k16, f32
//   accumulate; both operands staged in 64-channel chunks, fragments through
//   ldmatrix; warp w owns outer 16w .. +15 and all 64 inner).
// - "v2" below (the earlier bf16 backward): 8 warps, the outer rows
//   resident, the inner tiles double buffered by cp.async, the sim fragment
//   in registers.
// Entries past the end of either axis are zero-filled; the callers mask them.

#pragma once

#include "mma.cuh"

namespace milnce {

constexpr int TILE = 64;       // outer and inner entries per tile
constexpr int NTHREADS = 128;  // 4 warps (the sim_tile kernels)
constexpr int SIM_LD = TILE + 1;
constexpr int BF_KC = 64;      // channels per staged chunk, bf16
constexpr int BF_LD = BF_KC + 8;  // padded rows: ldmatrix rows hit distinct banks
constexpr int STAGE_BYTES = 2 * TILE * BF_LD * 2;  // two [64][72] bf16 chunks

// rows [n0, n0 + 64) x channels [c0, c0 + BF_KC) of a row-major [n, C] bf16
// array into dst[64][BF_LD]; 16 bytes per load (C is a multiple of 64)
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int n0, int n, int C, int c0) {
  for (int e = threadIdx.x; e < TILE * (BF_KC / 8); e += NTHREADS) {
    const int j = e / (BF_KC / 8), c = (e % (BF_KC / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + j < n) val = *reinterpret_cast<const uint4*>(src + size_t(n0 + j) * C + c0 + c);
    *reinterpret_cast<uint4*>(dst + j * BF_LD + c) = val;
  }
}

// sim[a][b] = O[o0 + a] . I[i0 + b] over C channels, into shared sim[64][SIM_LD].
// Starts and ends with __syncthreads(): the staging area and sim are free
// for the caller afterwards.
inline __device__ void sim_tile(const __nv_bfloat16* O, int o0, int nO, const __nv_bfloat16* I,
                                int i0, int nI, int C, unsigned char* stage, float* sim) {
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* is = os + TILE * BF_LD;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  float sc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
  for (int c0 = 0; c0 < C; c0 += BF_KC) {
    __syncthreads();
    stage_bf16(os, O, o0, nO, C, c0);
    stage_bf16(is, I, i0, nI, C, c0);
    __syncthreads();
    uint32_t a[BF_KC / 16][4];
#pragma unroll
    for (int s = 0; s < BF_KC / 16; ++s)
      ldsm_x4(a[s], &os[(warp * 16 + (lane & 15)) * BF_LD + s * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int s = 0; s < BF_KC / 16; s += 2) {
        // B of k-steps s and s + 1: inner entries 8n .. 8n + 7
        uint32_t r[4];
        ldsm_x4(r, &is[(n * 8 + (lane & 7)) * BF_LD + (s + (lane >> 4)) * 16 +
                       ((lane >> 3) & 1) * 8]);
        mma_16816(sc[n], a[s], r[0], r[1]);
        mma_16816(sc[n], a[s + 1], r[2], r[3]);
      }
    }
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    sim[r0 * SIM_LD + col] = sc[n][0];
    sim[r0 * SIM_LD + col + 1] = sc[n][1];
    sim[(r0 + 8) * SIM_LD + col] = sc[n][2];
    sim[(r0 + 8) * SIM_LD + col + 1] = sc[n][3];
  }
  __syncthreads();
}

// the [64 rows][64 cols] byte tile of the positive mask pm[R][K] at (r0, k0)
// into pms[64][64] (row-major, zero outside), read along k
__device__ __forceinline__ void stage_mask(uint8_t* pms, const uint8_t* pm, int r0, int R,
                                           int k0, int K) {
  for (int e = threadIdx.x; e < TILE * TILE; e += NTHREADS) {
    const int r = e / TILE, k = e % TILE;
    pms[e] = (r0 + r < R && k0 + k < K) ? pm[size_t(r0 + r) * K + k0 + k] : 0;
  }
}

// ---------------------------------------------- v2: bf16 tensor-core tiles
//
// 8 warps.  A block keeps its 64 outer rows of all C channels in shared
// memory and streams the inner tiles ([64][C + 8] bf16, double buffered by
// cp.async); warp w holds the sim fragment of outer rows 16 (w % 4) .. and
// inner columns 32 (w / 4) .. in registers.

constexpr int V2_WARPS = 8;
constexpr int V2_THREADS = 32 * V2_WARPS;
constexpr int V2_MAXC = 512;  // C of the v2 kernels (their register tiles)

__device__ __forceinline__ void v2_stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int n0, int n, int C) {
  const int vec = C / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < TILE * vec; e += V2_THREADS) {
    const int j = e / vec, c = (e % vec) * 8;
    const bool in = n0 + j < n;
    cp_async_16(dst + j * (C + 8) + c, src + size_t(in ? n0 + j : 0) * C + c, in);
  }
}

__device__ __forceinline__ void v2_stage_mask(uint8_t* pms, const uint8_t* pm, int r0, int R,
                                              int k0, int K) {
  for (int e = threadIdx.x; e < TILE * TILE; e += V2_THREADS) {
    const int r = e / TILE, k = e % TILE;
    pms[e] = (r0 + r < R && k0 + k < K) ? pm[size_t(r0 + r) * K + k0 + k] : 0;
  }
}

// sc = the [16 x 32] fragment (rows wr .., columns wc ..) of the tile
// O_rows . I_rows^T over C channels, both staged as [64][C + 8] bf16
__device__ __forceinline__ void v2_sim(float sc[4][4], const __nv_bfloat16* os,
                                       const __nv_bfloat16* is, int C, int wr, int wc) {
  const int lane = threadIdx.x % 32, LDC = C + 8;
#pragma unroll
  for (int n = 0; n < 4; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
  for (int ks = 0; ks < C / 16; ks += 2) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, &os[(wr + (lane & 15)) * LDC + ks * 16 + (lane >> 4) * 8]);
    ldsm_x4(a1, &os[(wr + (lane & 15)) * LDC + (ks + 1) * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t r4[4];
      ldsm_x4(r4, &is[(wc + n * 8 + (lane & 7)) * LDC + (ks + (lane >> 4)) * 16 +
                      ((lane >> 3) & 1) * 8]);
      mma_16816(sc[n], a0, r4[0], r4[1]);
      mma_16816(sc[n], a1, r4[2], r4[3]);
    }
  }
}

}  // namespace milnce
