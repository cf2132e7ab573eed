// Fused MIL-NCE forward (sm_90a): the f32 route (milnce_fwd_f32_kernel,
// split TF32 on the tensor cores) and the earlier bf16 kernel
// (milnce_fwd_v1_kernel; the bf16 route is milnce_wgmma.cu's
// milnce_fwd_wgmma_kernel).  Per layer s, the four masked logsumexps of
// sim = inv_temp * v[s] t[s]^T without writing sim:
//   vnum[s, r] = lse_k pos,  vden[s, r] = lse_k neg,
//   tnum[s, k] = lse_r pos,  tden[s, k] = lse_r neg,
// pos = where(pm[r, k], sim, mask_value), neg = where(cv[k], sim, mask_value).
// A masked but live entry counts as mask_value, never -inf; an entry past R
// or K counts as nothing.
//
// Replaces temporalalignnet_tpu/ops/pallas_milnce.py::_milnce_fwd_kernel
// (untiled) and ::_milnce_fwd_tiled_kernel (K streamed in column blocks):
// the TPU needs two plans because its VMEM holds the whole [K, C] text block
// only up to K ~ 1024; here each kernel streams K in tiles at any R and K.
// Both write, per 64-row block, every column's (max, sum) pairs to a
// [4, S, R/64, K] scratch, which milnce_colmerge_kernel (milnce_colmerge.cuh)
// folds into tnum and tden in row-block order (pallas_milnce.py:108-120).
//
// The f32 route (the --f32 training path).  The TPU kernel's product is
// Precision.HIGHEST, f32's accuracy, met here by split TF32
// (csrc/tf32x3.cuh: big·small + small·big + big·big of TF32 halves).  The
// tensor core truncates a sum at the scale of its largest term, so each
// 16-channel step's six products go into a short partial sum that is added
// to the running sim in f32, rounded to nearest (as csrc/milnce_grad_f32.cu
// does).
//
// What bounds it on an H100: operations.  2 S R K C FLOPs = 25.8 GFLOP at
// the B = 64 training shape (S = 6, R = 4096, K = 1024, C = 512), three TF32
// passes: 0.156 ms at 495 TFLOP/s, against 57-67 MB of v, t and pm (20 us).
// The products are what the design serves:
// - A block owns 64 video rows of one layer (grid (R/64, S): 384 blocks at
//   the training shape, 2.9 waves of one block an SM).  Its rows stay in
//   shared memory for the whole column stream (all C channels, staged once
//   by 16-byte cp.async, at a stride of 16 mod 32 banks); the text streams
//   in tiles of 128 columns x 32 channels (one TMA box, 128-byte swizzle)
//   through a four-stage ring: a producer warp keeps the loads in flight
//   and the 8 consumer warps wait on each stage's mbarrier, never on each
//   other (a cp.async ring with a block barrier a stage was slower on an
//   H100).
//   At C = 512: 132 KB of rows, 64 KB of ring (64 resident rows and two
//   whole 64-column text tiles would not fit in 227 KB).
// - Consumer warp (wr, wc): rows 32 wr .. +31 x columns 32 wc .. +31 of the
//   tile, 2 x 4 tiles of mma.sync m16n8k8 .tf32.  Each warp sums its sim
//   over all C channels in its own C fragments: no warp reduces another's
//   products.  (wgmma takes .tf32 K-major, which both operands are here,
//   but reads B from shared memory: split TF32 would need the big and small
//   halves of every text tile written there too.)
// - Fragments load as float4: within each 16 channels, thread t's k indices
//   t and t + 4 of the first k-step are channels 4 t and 4 t + 1, of the
//   second 4 t + 2 and 4 t + 3 (the same permutation of A's and B's k leaves
//   the dot product unchanged).
// - Within a warp's 32 columns, mma column n of n-tile j is text column
//   8 (n / 2) + j + 4 (n % 2): thread t's C fragments hold columns 8 t .. +7,
//   so its mask bytes of a row are one 8-byte load, and the two rows of a
//   quarter-warp's B loads lie 4 apart, in the swizzle's other half of the
//   banks.  Every fragment load is free of bank conflicts.
// - Per tile, in the log2 domain (x = sim inv_temp log2(e); masked entries
//   mask_value log2(e); dead ones -inf), as milnce_wgmma.cu's forward does:
//   each thread folds its 8 entries of each of its 4 rows into a running
//   (max, sum) for the whole stream (merged over the quad and the 4 column
//   warps at the end); each column's (max, sum) over the thread's 4 rows,
//   over the warp's 32 rows by shuffles, over the two row warps through
//   shared memory, goes to the scratch in natural-log terms.
// - Every sum is taken in a fixed order: two calls are bit-equal.
//
// The earlier bf16 kernel (mma.sync m16n8k16): 4 warps, each sim
// tile through shared memory (milnce_tile.cuh's sim_tile); the row pass takes
// half a row per thread, the column pass half a column.  No route takes it;
// milnce_fwd_v1 in ops/milnce.py times it beside the wgmma route.
//
// The dual branch's text, shared by every layer, is read with a layer stride
// of 0 and never broadcast in memory.  pm is a [R, K] byte mask (nonzero =
// positive) with col_valid already applied, cv a [K] byte mask; both are
// passed as bytes rather than rebuilt from the block-diagonal target, so the
// kernels keep the general contract of fused_milnce_elements.  Any R and K;
// C a multiple of 64 (up to 512 in f32).  Built by
// temporalalignnet_torch/ops/_build.py into a shared library with a plain C
// interface, called through ctypes.

#include "milnce_colmerge.cuh"
#include "milnce_tile.cuh"
#include "tf32x3.cuh"

namespace {

using namespace milnce;

// ------------------------------------------------ the earlier bf16 kernel

__global__ void __launch_bounds__(NTHREADS)
milnce_fwd_v1_kernel(const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ t,
                     long long t_ls, const uint8_t* __restrict__ pm,
                     const uint8_t* __restrict__ cv, float* __restrict__ vnum,
                     float* __restrict__ vden, float* __restrict__ part, int R, int K, int C,
                     float mv, float inv_temp) {
  __shared__ __align__(16) unsigned char stage[STAGE_BYTES];
  __shared__ float sim[TILE * SIM_LD];
  __shared__ uint8_t pms[TILE * TILE];
  __shared__ uint8_t cvs[TILE];

  const int rb = blockIdx.x, s = blockIdx.y, nrb = gridDim.x, S = gridDim.y;
  const int r0 = rb * TILE;
  const int nrow = min(TILE, R - r0);
  const __nv_bfloat16* vs = v + size_t(s) * R * C;
  const __nv_bfloat16* ts = t + size_t(s) * size_t(t_ls);
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
    sim_tile(vs, r0, R, ts, k0, K, C, stage, sim);  // its syncs publish pms, cvs

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

// ------------------------------------------------------ the f32 route

constexpr int F_ROWS = TILE;      // video rows a block (the column merge's row blocks)
constexpr int F_COLS = 128;       // text columns a tile
constexpr int F_KC = 32;          // channels a stage: one 128-byte-swizzled TMA box
constexpr int F_STAGES = 4;
constexpr int F_CONSUMERS = 8;    // warps; warp 8 is the producer
constexpr int F_THREADS = 32 * (F_CONSUMERS + 1);
constexpr int F_STAGE_BYTES = F_COLS * F_KC * 4;  // 16 KB

// dynamic shared memory, from a 1024-byte boundary: the ring [4][128 columns]
// [32 channels] (swizzled) | the rows [64][C + 16] | the column exchange
// [2 wr][4 wc][32] float4 | the row exchange [4 wc][64] float4 | full[4],
// empty[4] barriers
struct FPlan {
  int rows_off, cx_off, rx_off, bar_off, bytes;
  __host__ __device__ explicit FPlan(int C)
      : rows_off(F_STAGES * F_STAGE_BYTES),
        cx_off(rows_off + F_ROWS * (C + 16) * 4),
        rx_off(cx_off + 2 * 4 * 32 * 16),
        bar_off(rx_off + 4 * F_ROWS * 16),
        bytes(bar_off + 2 * F_STAGES * 8 + 1024) {}
};

// the 8 mask bytes p[k .. k + 7] (0 past n) as two words
__device__ __forceinline__ uint2 load8(const uint8_t* p, int k, int n) {
  if (k + 8 <= n && (reinterpret_cast<uintptr_t>(p + k) & 7u) == 0)
    return *reinterpret_cast<const uint2*>(p + k);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (k + e < n) w[e >> 2] |= uint32_t(p[k + e]) << (8 * (e & 3));
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ bool byte_set(uint2 w, int e) {
  return ((e < 4 ? w.x : w.y) >> (8 * (e & 3))) & 0xffu;
}

// grid (ceil(R / 64), S); tt: the text [layers][K][C] f32, box [1][128][32],
// 128-byte swizzle (one layer when shared)
__global__ void __launch_bounds__(F_THREADS, 1)
milnce_fwd_f32_kernel(const __grid_constant__ CUtensorMap tt, const float* __restrict__ v,
                      const uint8_t* __restrict__ pm, const uint8_t* __restrict__ cv,
                      float* __restrict__ vnum, float* __restrict__ vden,
                      float* __restrict__ part, int R, int K, int C, int shared_text, float mv,
                      float inv_temp) {
  using tf32x3::split;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  const FPlan P(C);
  const int rld = C + 16;  // the rows' stride in floats, 16 mod 32 banks
  float* ring = reinterpret_cast<float*>(sm);
  float* rows = reinterpret_cast<float*>(sm + P.rows_off);
  float4* cx = reinterpret_cast<float4*>(sm + P.cx_off);
  float4* rx = reinterpret_cast<float4*>(sm + P.rx_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P.bar_off);
  uint64_t* empty = full + F_STAGES;
  const int rb = blockIdx.x, s = blockIdx.y, nrb = gridDim.x;
  const int r0 = rb * F_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = C / F_KC, total = (K + F_COLS - 1) / F_COLS * chunks;
  if (threadIdx.x == 0) {
    for (int i = 0; i < F_STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], F_CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == F_CONSUMERS) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int n = 0; n < total; ++n) {
        const int st = n % F_STAGES;
        if (n >= F_STAGES) hopper::mbar_wait(&empty[st], uint32_t(n / F_STAGES - 1) & 1u);
        hopper::mbar_arrive_expect_tx(&full[st], F_STAGE_BYTES);
        hopper::tma_load_3d(ring + st * (F_STAGE_BYTES / 4), &tt, &full[st], n % chunks * F_KC,
                            n / chunks * F_COLS, shared_text ? 0 : s);
      }
    }
    return;
  }

  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  const float c2 = inv_temp * LOG2E, mv2 = mv * LOG2E;
  // the block's rows, once, by the consumers (rows past R zero-filled)
  {
    const float* vs = v + size_t(s) * R * C;
    for (int e = threadIdx.x; e < F_ROWS * (C / 4); e += 32 * F_CONSUMERS) {
      const int j = e / (C / 4), c = (e % (C / 4)) * 4;
      const bool in = r0 + j < R;
      cp_async_16(rows + j * rld + c, vs + (in ? size_t(r0 + j) * C + c : 0), in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    hopper::named_barrier<1, 32 * F_CONSUMERS>();
  }

  // this thread's rows: 32 wr + 16 i + 8 h + g ([i][h]); its columns of a
  // tile: 32 wc + 8 tq + e, held by register 2 h + e / 4 of n-tile e % 4
  int row[2][2];
  bool rlive[2][2];
  float rm[2][2][2], rs[2][2][2];  // [i][h][positives, negatives] running (max, sum)
  const float* ar[2][2];  // the rows' A fragments, at channel 4 tq
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[i][h] = r0 + 32 * wr + 16 * i + 8 * h + g;
      rlive[i][h] = row[i][h] < R;
      rm[i][h][0] = rm[i][h][1] = -INFINITY;
      rs[i][h][0] = rs[i][h][1] = 0.f;
      ar[i][h] = rows + (32 * wr + 16 * i + 8 * h + g) * rld + 4 * tq;
    }
  // the B fragments of n-tile j: stage row (tile column) 32 wc + 8 (g / 2) +
  // j + 4 (g % 2), float4 chunk 4 p + tq of pair p, swizzled by the row
  int bo[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 32 * wc + 8 * (g >> 1) + j + 4 * (g & 1);
#pragma unroll
    for (int p = 0; p < 2; ++p) bo[j][p] = r * F_KC + (((4 * p + tq) ^ (r & 7)) << 2);
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  uint2 pmw[2][2], cvw = make_uint2(0u, 0u);

  for (int n = 0; n < total; ++n) {
    const int st = n % F_STAGES;
    const int k0 = n / chunks * F_COLS, c0 = n % chunks * F_KC;
    const bool last = n % chunks == chunks - 1;
    const int kt = k0 + 32 * wc + 8 * tq;  // this thread's first column
    if (last) {  // the tile's mask bytes, read while the tensor cores run
      cvw = load8(cv, kt, K);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          pmw[i][h] = rlive[i][h] ? load8(pm + size_t(row[i][h]) * K, kt, K) : make_uint2(0u, 0u);
    }
    hopper::mbar_wait(&full[st], uint32_t(n / F_STAGES) & 1u);
    const float* stg = ring + st * (F_STAGE_BYTES / 4);

#pragma unroll
    for (int p = 0; p < 2; ++p) {  // 16 channels: two k-steps
      float4 a4[2][2], b4[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a4[i][h] = *reinterpret_cast<const float4*>(ar[i][h] + c0 + 16 * p);
#pragma unroll
      for (int j = 0; j < 4; ++j) b4[j] = *reinterpret_cast<const float4*>(stg + bo[j][p]);
      float x[2][4][4];  // this step's part, added in f32
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j][0] = x[i][j][1] = x[i][j][2] = x[i][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          split(kk ? a4[i][0].z : a4[i][0].x, ab[i][0], as[i][0]);  // row g, k t
          split(kk ? a4[i][1].z : a4[i][1].x, ab[i][1], as[i][1]);  // row g + 8, k t
          split(kk ? a4[i][0].w : a4[i][0].y, ab[i][2], as[i][2]);  // row g, k t + 4
          split(kk ? a4[i][1].w : a4[i][1].y, ab[i][3], as[i][3]);  // row g + 8, k t + 4
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split(kk ? b4[j].z : b4[j].x, bb[j][0], bs[j][0]);
          split(kk ? b4[j].w : b4[j].y, bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) tf32x3::mma_split(x[i][j], ab[i], as[i], bb[j], bs[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += x[i][j][e];
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);  // this warp is done with the stage
    if (!last) continue;

    // the tile's entries in the log2 domain: masked mask_value log2(e), dead -inf
    float xp[2][2][8], xn[2][2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = acc[i][e & 3][2 * h + (e >> 2)] * c2;
          const bool in = rlive[i][h] && kt + e < K;
          xp[i][h][e] = in ? (byte_set(pmw[i][h], e) ? x : mv2) : -INFINITY;
          xn[i][h][e] = in ? (byte_set(cvw, e) ? x : mv2) : -INFINITY;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    // rows: this thread's 8 entries of each into its running (max, sum)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fold8(rm[i][h][0], rs[i][h][0], xp[i][h]);
        fold8(rm[i][h][1], rs[i][h][1], xn[i][h]);
      }

    // columns: (max, sum) over the thread's 4 rows, then the warp's 32 rows
    float4* mine = cx + (wr * 4 + wc) * 32;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float mp = max_over_g(fmaxf(fmaxf(xp[0][0][e], xp[0][1][e]),
                                        fmaxf(xp[1][0][e], xp[1][1][e])));
      const float mn = max_over_g(fmaxf(fmaxf(xn[0][0][e], xn[0][1][e]),
                                        fmaxf(xn[1][0][e], xn[1][1][e])));
      const float rp = ex2_ref(mp), rn = ex2_ref(mn);
      const float sp = sum_over_g((hopper::ex2(xp[0][0][e] - rp) + hopper::ex2(xp[0][1][e] - rp)) +
                                  (hopper::ex2(xp[1][0][e] - rp) + hopper::ex2(xp[1][1][e] - rp)));
      const float sn = sum_over_g((hopper::ex2(xn[0][0][e] - rn) + hopper::ex2(xn[0][1][e] - rn)) +
                                  (hopper::ex2(xn[1][0][e] - rn) + hopper::ex2(xn[1][1][e] - rn)));
      if (g == 0) mine[8 * tq + e] = make_float4(mp, sp, mn, sn);
    }
    hopper::named_barrier<1, 32 * F_CONSUMERS>();  // both row warps' columns are in
    // ... and over the two row warps: the row block's partial of each column
    if (wr == 0) {
      const float4 a = cx[wc * 32 + lane], b = cx[(4 + wc) * 32 + lane];
      float mp = a.x, sp = a.y, mn = a.z, sn = a.w;
      merge2(mp, sp, b.x, b.y);
      merge2(mn, sn, b.z, b.w);
      const int k = k0 + 32 * wc + lane;
      if (k < K) {  // natural-log terms, as milnce_colmerge_kernel reads them
        const size_t plane = size_t(gridDim.y) * nrb * K;
        const size_t q = (size_t(s) * nrb + rb) * K + k;
        part[q] = mp * LN2;
        part[plane + q] = sp;
        part[2 * plane + q] = mn * LN2;
        part[3 * plane + q] = sn;
      }
    }
    // the next tile's columns may overwrite cx: every warp has read it
    // before it reaches the next tile's barrier
  }

  // rows: merged over the quad (the thread's 8 columns of each tile x 4),
  // then over the 4 column warps in order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          merge2(rm[i][h][q], rs[i][h][q], __shfl_xor_sync(0xffffffffu, rm[i][h][q], off),
                 __shfl_xor_sync(0xffffffffu, rs[i][h][q], off));
      if (tq == 0)
        rx[wc * F_ROWS + 32 * wr + 16 * i + 8 * h + g] =
            make_float4(rm[i][h][0], rs[i][h][0], rm[i][h][1], rs[i][h][1]);
    }
  hopper::named_barrier<1, 32 * F_CONSUMERS>();
  if (threadIdx.x < F_ROWS && r0 + int(threadIdx.x) < R) {
    float4 a = rx[threadIdx.x];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float4 b = rx[w * F_ROWS + threadIdx.x];
      merge2(a.x, a.y, b.x, b.y);
      merge2(a.z, a.w, b.z, b.w);
    }
    const size_t r = size_t(s) * R + r0 + threadIdx.x;
    vnum[r] = (a.x + log2f(a.y)) * LN2;
    vden[r] = (a.z + log2f(a.w)) * LN2;
  }
}

cudaError_t launch_f32(const void* v, const void* t, long long t_ls, const void* pm,
                       const void* cv, void* vnum, void* vden, void* part, int S, int R, int K,
                       int C, float mv, float inv_temp, cudaStream_t stream) {
  if (C > 512) return cudaErrorInvalidValue;  // the resident rows' shared memory
  CUtensorMap tt;
  const uint64_t dims[3] = {uint64_t(C), uint64_t(K), uint64_t(t_ls ? S : 1)};
  const uint64_t strides[2] = {uint64_t(C) * 4, uint64_t(K) * C * 4};
  const uint32_t box[3] = {F_KC, F_COLS, 1};
  if (!hopper::make_map(&tt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, t, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int bytes = FPlan(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(milnce_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nrb = (R + F_ROWS - 1) / F_ROWS;
  milnce_fwd_f32_kernel<<<dim3(unsigned(nrb), unsigned(S)), F_THREADS, bytes, stream>>>(
      tt, static_cast<const float*>(v), static_cast<const uint8_t*>(pm),
      static_cast<const uint8_t*>(cv), static_cast<float*>(vnum), static_cast<float*>(vden),
      static_cast<float*>(part), R, K, C, t_ls == 0, mv, inv_temp);
  return cudaGetLastError();
}

cudaError_t launch_v1(const void* v, const void* t, long long t_ls, const void* pm,
                      const void* cv, void* vnum, void* vden, void* part, int S, int R, int K,
                      int C, float mv, float inv_temp, cudaStream_t stream) {
  const int nrb = (R + TILE - 1) / TILE;
  milnce_fwd_v1_kernel<<<dim3(unsigned(nrb), unsigned(S)), NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(t), t_ls,
      static_cast<const uint8_t*>(pm), static_cast<const uint8_t*>(cv),
      static_cast<float*>(vnum), static_cast<float*>(vden), static_cast<float*>(part), R, K, C,
      mv, inv_temp);
  return cudaGetLastError();
}

}  // namespace

// v [S, R, C]; t [K, C] per layer at a stride of t_layer_stride elements (0:
// one text shared by every layer); pm [R, K] and cv [K] bytes; vnum, vden
// [S, R], tnum, tden [S, K] f32; part: 4 S ceil(R/64) K f32 of scratch.
// dtype: 0 = float32 (the split-TF32 kernel, C <= 512), 1 = bfloat16 (the
// earlier kernel).  Returns a cudaError_t (0 = launched).
extern "C" int milnce_fwd(const void* v, const void* t, long long t_layer_stride, const void* pm,
                          const void* cv, void* vnum, void* vden, void* tnum, void* tden,
                          void* part, int S, int R, int K, int C, int dtype, float mask_value,
                          float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_f32(v, t, t_layer_stride, pm, cv, vnum, vden, part, S, R, K, C, mask_value,
                     inv_temp, st);
  else if (dtype == 1)
    err = launch_v1(v, t, t_layer_stride, pm, cv, vnum, vden, part, S, R, K, C, mask_value,
                    inv_temp, st);
  else
    return int(cudaErrorInvalidValue);
  if (err != cudaSuccess) return int(err);
  return int(colmerge(part, tnum, tden, S, R, K, st));
}
