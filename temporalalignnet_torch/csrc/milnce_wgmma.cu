// MIL-NCE feature gradients for Hopper (sm_90a), bf16: the wgmma/TMA kernel
// of milnce_dv and milnce_dt, one template over the orientation
// (csrc/milnce_bwd.cu keeps the f32 route and the earlier v2 kernels).
//
// Replaces temporalalignnet_tpu/ops/pallas_milnce.py::_milnce_bwd_kernel and
// the column-tiled ::_milnce_dv_kernel and ::_milnce_dt_kernel: for each
// layer s, video row r and text column k,
//   dv[r] = sum_k dsim[r, k] t[k],   dt[k] = sum_r dsim[r, k] v[r],
//   dsim = inv_temp * (gv[r] (p_neg - p_pos) + gt[k] (q_neg - q_pos)),
//   p_pos = pm ? exp(sim - vnum[r]) : 0,  p_neg = cv ? exp(sim - vden[r]) : 0,
//   q_pos = pm ? exp(sim - tnum[k]) : 0,  q_neg = cv ? exp(sim - tden[k]) : 0,
// sim = inv_temp v[r] . t[k], recomputed from the features and re-masked as
// _dsim_tile does (pallas_milnce.py:128-151); dsim rounded to bf16 before the
// product, every sum in f32.  dv is per layer, never summed over the layers;
// dt with the dual branch's shared text (out_layers = 1) is.
//
// Orientation: a block owns 64 "outer" entries and streams the "inner" ones,
// accumulating the gradient of the outer entries:
// - ROWS_OUTER (milnce_dv): outer = video rows, inner = text columns;
// - otherwise (milnce_dt): outer = text columns, inner = video rows.
// dsim is symmetric in its row and column terms, so the kernel reads the
// outer entries' (num, den, g) as per-layer register constants and has the
// producer stage the inner entries' beside each tile, whichever side is
// which.  Only the column mask cv (an outer constant for dt, staged with the
// inner tile for dv), the pm tile's index order and which operand a shared
// text is depend on the orientation.
//
// What bounds it on an H100: operations.  4 S R K C FLOPs (sim again, then
// the product): 51.5 GFLOP at the B = 64 training shape, 52 us at 989
// TFLOP/s, against ~40 MB of inputs and outputs (12 us).
//
// The design, for that bound:
// - One block per (64 outer entries, output layer, inner split), warp
//   specialised: warpgroup 2 is the producer (one warp keeps TMA loads in
//   flight into a two-stage ring guarded by mbarriers; setmaxnreg gives its
//   registers to the consumers), warpgroups 0 and 1 consume.
// - The block's 64 outer entries stay resident in shared memory (one TMA
//   load per block).  A stage holds a 64-entry inner tile ([64][C] bf16,
//   128-byte swizzle, entries past R or K zero-filled by TMA; a shared text
//   is read through a depth-1 tensor map at layer 0), its [64 r][64 k]
//   positive-mask tile (TMA when K is a multiple of 16, else staged by the
//   producer warp), and its entries' num log2(e), den log2(e), g inv_temp
//   and, for dv, cv bytes.
// - Per tile, consumer h computes a partial sim[o][i] = outer_o . inner_i over
//   its half of the channels for all 64 inner entries (m64n64k16, A and B
//   K-major: half the shared-memory operand traffic of splitting the inner
//   entries); the two swap the partial sums of each other's entries through
//   shared memory (named barrier), each forms dsim of its 32 inner entries in
//   registers (exp2 on the special-function unit, branch-free re-masking) and
//   writes it as bf16 to a shared [64 outer][64 inner] tile; a second named
//   barrier joins the halves; then grad[64 outer][its channels] += dsim .
//   inner (m64nNk16, N up to 256, B = the same inner tile read MN-major), the
//   f32 accumulator in registers for the whole inner stream.
// - One split: the accumulators go out as bf16 straight away, staged over the
//   resident outer tile and stored by TMA (dv at every training shape).
//   Inner splits (to fill the card when the outer axis x layers is short, as
//   for dt) write f32 partials that milnce_reduce_kernel sums in split
//   order: the result does not depend on the schedule.  (Summing them inside
//   a thread-block cluster through distributed shared memory was tried for
//   dt and was slower on an H100: clusters of up to 8 blocks of 226 KB fit
//   fewer blocks on the card at once.  So was a 32-entry tile with a
//   four-stage ring, the next tile's sim started before this tile's dsim: the
//   halved tiles doubled the per-tile barriers and waits.)
//
// Layout: v [S, R, C] bf16; t [S, K, C] (t_layer_stride = K C) or [K, C]
// (stride 0); pm [R, K] and cv [K] bytes; vnum, vden, gv [S, R] and tnum,
// tden, gt [S, K] f32; dv [S, R, C], dt [out_layers, K, C] bf16.  C a
// multiple of 64 up to 512.  Built by ops/_build.py into a library with a
// plain C interface.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;             // outer entries per block, inner entries per tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;         // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CHUNK = TILE * 128;    // [64 entries][64 channels] bf16, 8 KB
constexpr int MAX_NC = 8;            // C / 64
constexpr float LOG2E = 1.4426950408889634f;

template <int NC>
struct Plan {
  // the block's outer entries: NC chunks [64][64 c]; at the end the staging
  // of a one-split output
  static constexpr int O_OFF = 0;
  // each stage's inner entries: NC chunks [64][64 c]
  static constexpr int I_OFF = O_OFF + NC * CHUNK;
  static constexpr int I_BYTES = NC * CHUNK;
  // the dsim tile [64 outer][64 inner]
  static constexpr int DS_OFF = I_OFF + STAGES * I_BYTES;
  // each stage's pm [64 r][64 k] bytes | inner num log2(e), den log2(e),
  // g inv_temp [64] f32 | inner cv [64] bytes (dv), padded so that the next
  // stage's pm tile keeps the 128-byte alignment of a TMA destination
  static constexpr int AUX_OFF = DS_OFF + CHUNK;
  static constexpr int AUX_VEC = TILE * TILE;
  static constexpr int AUX_CV = AUX_VEC + 3 * TILE * 4;
  static constexpr int AUX_BYTES = AUX_CV + 128;
  // each consumer's partial sim of the other's entries: [16 registers][128 threads] f32
  static constexpr int XCH_OFF = AUX_OFF + STAGES * AUX_BYTES;
  static constexpr int BAR_OFF = XCH_OFF + CONSUMERS * 16 * 128 * 4;  // full, empty, outer
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  // channel chunks of each consumer: consumer 0 the first NB0, consumer 1 the rest
  static constexpr int NB0 = (NC + 1) / 2, NB1 = NC / 2;
};
static_assert(Plan<MAX_NC>::BYTES <= 232448, "a block's shared memory on an H100");
static_assert(Plan<MAX_NC>::AUX_OFF % 128 == 0 && Plan<MAX_NC>::AUX_BYTES % 128 == 0,
              "TMA destinations are 128-byte aligned");

// acc += A B for a 64 x (64 NB) tile, B MN-major (the channels of the inner tile)
template <int NB>
__device__ __forceinline__ void product(float (&acc)[32 * NB], uint64_t da, uint64_t db) {
  if constexpr (NB == 1) wgmma_ss_n64<0, 1>(acc, da, db);
  if constexpr (NB == 2) wgmma_ss_n128<0, 1>(acc, da, db);
  if constexpr (NB == 3) wgmma_ss_n192<0, 1>(acc, da, db);
  if constexpr (NB == 4) wgmma_ss_n256<0, 1>(acc, da, db);
}

struct Args {
  const uint8_t* pm;
  const uint8_t* cv;
  const float *onum, *oden, *og;  // the outer entries' vectors [S, n_outer]
  const float *inum, *iden, *ig;  // the inner entries' [S, n_inner]
  float* part;                    // f32 partials of an inner split, or null (one split)
  int R, K, n_outer, n_inner, C, layers, tiles_per_split, shared_text, pm_tma;
  float inv_temp;
};

// consumer H: channels from chunk C0, NB chunks of them; inner entries
// 32 H .. +31 of each tile for dsim
template <bool ROWS_OUTER, int NC, int NB, int C0, int H>
__device__ __forceinline__ void consume(uint8_t* sm, const Args& a, const CUtensorMap* tout,
                                        int total, int per) {
  using P = Plan<NC>;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * TILE, y = blockIdx.y;
  const int s0 = y * a.layers, it0 = blockIdx.z * a.tiles_per_split;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* obar = empty + STAGES;
  const uint32_t base = smem_addr(sm);

  float acc[32 * (NB > 0 ? NB : 1)];
#pragma unroll
  for (int e = 0; e < 32 * (NB > 0 ? NB : 1); ++e) acc[e] = 0.f;
  fence_regs(acc);

  // this thread's two outer entries (rows of the sim tile): 16 warp + g, + 8
  int oc[2];
  bool oin[2], okeep[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    oc[hh] = o0 + 16 * warp + g + 8 * hh;
    oin[hh] = oc[hh] < a.n_outer;
    // dt: the outer entries are text columns, masked by cv
    okeep[hh] = ROWS_OUTER || (oin[hh] && a.cv[oc[hh]] != 0);
  }
  // exp(inv_temp sim - lse) = exp2(sim c2 - lse log2(e)); the cotangents
  // carry the outer inv_temp
  const float c2 = a.inv_temp * LOG2E;
  float on[2], od[2], og[2];
  int layer = -1;

  mbar_wait(obar, 0);
  for (int n = 0; n < total; ++n) {
    const int st = n % STAGES;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const int s = s0 + n / per, i0 = (it0 + n % per) * TILE;
    if (s != layer) {  // the outer entries' vectors of layer s
      layer = s;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t i = size_t(s) * a.n_outer + (oin[hh] ? oc[hh] : 0);
        on[hh] = oin[hh] ? a.onum[i] * LOG2E : 0.f;
        od[hh] = oin[hh] ? a.oden[i] * LOG2E : 0.f;
        og[hh] = oin[hh] ? a.og[i] * a.inv_temp : 0.f;
      }
    }
    const uint32_t i_a = base + P::I_OFF + st * P::I_BYTES;
    const uint8_t* aux = sm + P::AUX_OFF + st * P::AUX_BYTES;
    mbar_wait(&full[st], ph);

    // partial sim[o][i] over this consumer's channels, all 64 inner entries
    // i: m64n64k16 (A = outer, B = inner, both K-major)
    float sim[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sim[e] = 0.f;
    fence_regs(sim);
    if constexpr (NB > 0) {
      wgmma_fence();
#pragma unroll
      for (int c = C0; c < C0 + NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64<0, 0>(sim, sw128_desc(base + P::O_OFF + c * CHUNK + kk * 32, 0),
                             sw128_desc(i_a + c * CHUNK + kk * 32, 0));
      wgmma_commit();
    }

    // while the tensor cores run: the vectors and mask bits of this
    // consumer's inner entries (register e of chunk j: outer entry 16 warp +
    // g + 8 ((e >> 1) & 1), inner entry 8 j + 2 t + (e & 1))
    const uint8_t* pms = aux;
    const float* vn = reinterpret_cast<const float*>(aux + P::AUX_VEC);
    const float* vd = vn + TILE;
    const float* vg = vd + TILE;
    const uint8_t* vcv = aux + P::AUX_CV;
    float rn[8], rd[8], rg[8];
    bool pos[8][2], live[8], ikeep[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 32 * H + 8 * (c / 2) + 2 * t + c % 2;
      rn[c] = vn[col];
      rd[c] = vd[col];
      rg[c] = vg[col];
      live[c] = i0 + col < a.n_inner;
      ikeep[c] = !ROWS_OUTER || vcv[col] != 0;  // dv: the inner entries are text columns
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ol = 16 * warp + g + 8 * hh;
        pos[c][hh] = pms[ROWS_OUTER ? ol * TILE + col : col * TILE + ol] != 0;
      }
    }
    if constexpr (NB > 0) wgmma_wait<0>();
    fence_regs(sim);

    // swap partial sums: the other consumer's entries out, this one's in (the
    // two consumers' threads hold the same (o, i) entries)
    float* xch = reinterpret_cast<float*>(sm + P::XCH_OFF);
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int e = 0; e < 16; ++e) xch[(H * 16 + e) * 128 + tid] = sim[16 * (1 - H) + e];
    named_barrier<1, 128 * CONSUMERS>();
#pragma unroll
    for (int e = 0; e < 16; ++e) sim[16 * H + e] += xch[((1 - H) * 16 + e) * 128 + tid];

    // dsim of this consumer's inner entries, re-masked, rounded to bf16 into
    // the tile
    uint8_t* ds = sm + P::DS_OFF;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float d2[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * j + i;
          // branch-free (the masked exponents are -inf), so the 16
          // entries' exponentials overlap
          const float x = sim[16 * H + 4 * j + 2 * hh + i] * c2;
          const bool p = pos[c][hh];
          const float neg = (okeep[hh] && ikeep[c]) ? x : -INFINITY, pst = p ? x : -INFINITY;
          const float d = rg[c] * (ex2(neg - rd[c]) - ex2(pst - rn[c])) +
                          og[hh] * (ex2(neg - od[hh]) - ex2(pst - on[hh]));
          d2[i] = live[c] ? d : 0.f;
        }
        *reinterpret_cast<uint32_t*>(ds + sw128_offset(16 * warp + g + 8 * hh,
                                                        32 * H + 8 * j + 2 * t)) =
            pack_bf16x2(d2[0], d2[1]);
      }
    fence_async_smem();
    named_barrier<2, 128 * CONSUMERS>();  // both halves of dsim are written

    // grad[64 outer][this consumer's channels] += dsim . inner, K = the 64
    // inner entries
    if constexpr (NB > 0) {
      const uint32_t ds_a = base + P::DS_OFF;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        product<NB>(acc, sw128_desc(ds_a + kk * 32, 0),
                    sw128_desc(i_a + C0 * CHUNK + kk * 2048, CHUNK));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  // register 4 j + 2 hh + e of acc: outer entry 16 warp + g + 8 hh, channel
  // 64 C0 + 8 j + 2 t + e
  if (a.part == nullptr) {
    // one split: bf16 over the outer tile, which no one reads any more (both
    // consumers' last sims were waited for before the last tile's barriers),
    // stored by TMA (entries past R or K are clipped)
    if constexpr (NB > 0) {
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(sm + P::O_OFF + (C0 + j / 8) * CHUNK +
                                       sw128_offset(16 * warp + g + 8 * hh, 8 * (j % 8) + 2 * t)) =
              pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    fence_async_smem();
    named_barrier<3, 128 * CONSUMERS>();
    if (threadIdx.x == 0) {
      for (int c = 0; c < NC; ++c) tma_store_3d(tout, sm + P::O_OFF + c * CHUNK, c * 64, o0, y);
      tma_store_commit_and_wait();
    }
  } else if constexpr (NB > 0) {  // the f32 partial of this split
    float* out = a.part + (size_t(blockIdx.z) * gridDim.y + blockIdx.y) * size_t(a.n_outer) * a.C;
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (oin[hh])
          *reinterpret_cast<float2*>(out + size_t(oc[hh]) * a.C + C0 * 64 + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// the producer warp: the block's outer entries once, then per tile its inner
// entries (TMA), mask tile (TMA, or staged by the lanes) and the inner
// entries' vectors
template <bool ROWS_OUTER, int NC>
__device__ __forceinline__ void produce(uint8_t* sm, const Args& a, const CUtensorMap* to,
                                        const CUtensorMap* ti, const CUtensorMap* tpm, int total,
                                        int per) {
  using P = Plan<NC>;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* obar = empty + STAGES;
  const int lane = threadIdx.x % 32;
  const int o0 = blockIdx.x * TILE, s0 = blockIdx.y * a.layers;
  const int it0 = blockIdx.z * a.tiles_per_split;
  if (lane == 0) {  // a shared text is the outer operand of dt
    const int layer = (!ROWS_OUTER && a.shared_text) ? 0 : s0;
    mbar_arrive_expect_tx(obar, NC * CHUNK);
    for (int c = 0; c < NC; ++c) tma_load_3d(sm + P::O_OFF + c * CHUNK, to, obar, c * 64, o0, layer);
  }
  for (int n = 0; n < total; ++n) {
    const int st = n % STAGES;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const int s = s0 + n / per, i0 = (it0 + n % per) * TILE;
    const int r0 = ROWS_OUTER ? o0 : i0, k0 = ROWS_OUTER ? i0 : o0;  // the pm tile
    uint8_t* is = sm + P::I_OFF + st * P::I_BYTES;
    uint8_t* aux = sm + P::AUX_OFF + st * P::AUX_BYTES;
    mbar_wait(&empty[st], ph ^ 1u);
    if (lane == 0) {  // ... and the inner operand of dv
      const int layer = (ROWS_OUTER && a.shared_text) ? 0 : s;
      mbar_expect_tx(&full[st], NC * CHUNK + (a.pm_tma ? TILE * TILE : 0));
      for (int c = 0; c < NC; ++c) tma_load_3d(is + c * CHUNK, ti, &full[st], c * 64, i0, layer);
      if (a.pm_tma) tma_load_2d(aux, tpm, &full[st], k0, r0);
    }
    if (!a.pm_tma) {  // K not a multiple of 16: no tensor map over pm's rows
      for (int e = lane; e < TILE * TILE; e += 32) {
        const int r = r0 + e / TILE, k = k0 + e % TILE;
        aux[e] = (r < a.R && k < a.K) ? a.pm[size_t(r) * a.K + k] : 0;
      }
    }
    float* vec = reinterpret_cast<float*>(aux + P::AUX_VEC);
    for (int e = lane; e < TILE; e += 32) {
      const int i = i0 + e;
      const bool in = i < a.n_inner;
      const size_t idx = size_t(s) * a.n_inner + (in ? i : 0);
      vec[e] = in ? a.inum[idx] * LOG2E : 0.f;
      vec[TILE + e] = in ? a.iden[idx] * LOG2E : 0.f;
      vec[2 * TILE + e] = in ? a.ig[idx] * a.inv_temp : 0.f;
      if (ROWS_OUTER) aux[P::AUX_CV + e] = in ? a.cv[i] : 0;
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[st]);
  }
}

// grid (outer / 64, out_layers, splits)
template <bool ROWS_OUTER, int NC>
__global__ void __launch_bounds__(THREADS, 1)
milnce_grad_wgmma_kernel(const __grid_constant__ CUtensorMap to,
                         const __grid_constant__ CUtensorMap ti,
                         const __grid_constant__ CUtensorMap tpm,
                         const __grid_constant__ CUtensorMap tout, const Args a) {
  using P = Plan<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* obar = empty + STAGES;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int n_tiles = (a.n_inner + TILE - 1) / TILE;
  const int it0 = blockIdx.z * a.tiles_per_split;
  const int per = min(it0 + a.tiles_per_split, n_tiles) - it0;  // > 0: no empty split
  const int total = a.layers * per;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    mbar_init(obar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // producer
    setmaxnreg_dec<40>();
    if (warp == 0) produce<ROWS_OUTER, NC>(sm, a, &to, &ti, &tpm, total, per);
  } else {  // consumers
    setmaxnreg_inc<232>();
    if (wg == 0)
      consume<ROWS_OUTER, NC, P::NB0, 0, 0>(sm, a, &tout, total, per);
    else
      consume<ROWS_OUTER, NC, P::NB1, P::NB0, 1>(sm, a, &tout, total, per);
  }
}

// out[y, o, c] = sum over splits of part[split, y, o, c], in split order, as
// bf16; four entries a thread (n is a multiple of 64)
__global__ void milnce_reduce_kernel(const float4* __restrict__ part, uint2* __restrict__ out,
                                     size_t n4, int splits) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n4) return;
  float4 x = part[idx];
  for (int s = 1; s < splits; ++s) {
    const float4 y = part[size_t(s) * n4 + idx];
    x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
  }
  out[idx] = make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
}

template <bool ROWS_OUTER, int NC>
cudaError_t launch_nc(const CUtensorMap* maps, const Args& a, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(milnce_grad_wgmma_kernel<ROWS_OUTER, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<NC>::BYTES);
  if (err != cudaSuccess) return err;
  milnce_grad_wgmma_kernel<ROWS_OUTER, NC><<<grid, THREADS, Plan<NC>::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <bool ROWS_OUTER>
int launch(const void* v, const void* t, long long t_layer_stride, const void* pm, const void* cv,
           const void* vnum, const void* vden, const void* tnum, const void* tden, const void* gv,
           const void* gt, void* out, void* part, int S, int R, int K, int C, int out_layers,
           int splits, float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0 || C > 64 * MAX_NC ||
      splits <= 0 || splits > 65535 || (out_layers != S && out_layers != 1) ||
      (ROWS_OUTER && out_layers != S) ||
      (t_layer_stride != 0 && t_layer_stride != (long long)K * C) ||
      (!ROWS_OUTER && S > 1 && (t_layer_stride == 0) != (out_layers == 1)))
    return int(cudaErrorInvalidValue);
  const void* aligned[5] = {v, t, pm, out, part};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  const int n_outer = ROWS_OUTER ? R : K, n_inner = ROWS_OUTER ? K : R;
  const int itiles = (n_inner + TILE - 1) / TILE;
  const int per_split = (itiles + splits - 1) / splits;
  splits = (itiles + per_split - 1) / per_split;  // no empty split
  if (splits > 1 && part == nullptr) return int(cudaErrorInvalidValue);

  // to, ti, pm, out
  CUtensorMap maps[4];
  const uint64_t v_dims[3] = {uint64_t(C), uint64_t(R), uint64_t(S)};
  const uint64_t v_strides[2] = {uint64_t(C) * 2, uint64_t(R) * C * 2};
  const uint64_t t_dims[3] = {uint64_t(C), uint64_t(K), uint64_t(t_layer_stride ? S : 1)};
  const uint64_t t_strides[2] = {uint64_t(C) * 2, uint64_t(K) * C * 2};
  const uint64_t o_dims[3] = {uint64_t(C), uint64_t(n_outer), uint64_t(out_layers)};
  const uint64_t o_strides[2] = {uint64_t(C) * 2, uint64_t(n_outer) * C * 2};
  const uint32_t box[3] = {64, TILE, 1};
  const bool pm_tma = K % 16 == 0;
  const uint64_t pm_dims[2] = {uint64_t(K), uint64_t(R)};
  const uint64_t pm_strides[1] = {uint64_t(K)};
  const uint32_t pm_box[2] = {TILE, TILE};
  CUtensorMap vmap, tmap;
  if (!make_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, v_dims, v_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, t, t_dims, t_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, o_dims, o_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  maps[0] = ROWS_OUTER ? vmap : tmap;
  maps[1] = ROWS_OUTER ? tmap : vmap;
  if (pm_tma) {
    if (!make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, pm, pm_dims, pm_strides, pm_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
      return int(cudaErrorInvalidValue);
  } else {
    maps[2] = maps[0];  // not read
  }

  const float* rows[3] = {static_cast<const float*>(vnum), static_cast<const float*>(vden),
                          static_cast<const float*>(gv)};
  const float* cols[3] = {static_cast<const float*>(tnum), static_cast<const float*>(tden),
                          static_cast<const float*>(gt)};
  const float* const* outer = ROWS_OUTER ? rows : cols;
  const float* const* inner = ROWS_OUTER ? cols : rows;
  Args a;
  a.pm = static_cast<const uint8_t*>(pm);
  a.cv = static_cast<const uint8_t*>(cv);
  a.onum = outer[0], a.oden = outer[1], a.og = outer[2];
  a.inum = inner[0], a.iden = inner[1], a.ig = inner[2];
  a.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  a.R = R, a.K = K, a.n_outer = n_outer, a.n_inner = n_inner, a.C = C;
  a.layers = S / out_layers, a.tiles_per_split = per_split;
  a.shared_text = t_layer_stride == 0, a.pm_tma = pm_tma, a.inv_temp = inv_temp;

  const dim3 grid(unsigned((n_outer + TILE - 1) / TILE), unsigned(out_layers), unsigned(splits));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (C / 64) {
    case 1: err = launch_nc<ROWS_OUTER, 1>(maps, a, grid, st); break;
    case 2: err = launch_nc<ROWS_OUTER, 2>(maps, a, grid, st); break;
    case 3: err = launch_nc<ROWS_OUTER, 3>(maps, a, grid, st); break;
    case 4: err = launch_nc<ROWS_OUTER, 4>(maps, a, grid, st); break;
    case 5: err = launch_nc<ROWS_OUTER, 5>(maps, a, grid, st); break;
    case 6: err = launch_nc<ROWS_OUTER, 6>(maps, a, grid, st); break;
    case 7: err = launch_nc<ROWS_OUTER, 7>(maps, a, grid, st); break;
    case 8: err = launch_nc<ROWS_OUTER, 8>(maps, a, grid, st); break;
  }
  if (err != cudaSuccess || splits == 1) return int(err);
  const size_t n4 = size_t(out_layers) * n_outer * C / 4;
  milnce_reduce_kernel<<<unsigned((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(part), static_cast<uint2*>(out), n4, splits);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 only.  Inputs as milnce_dv / milnce_dt in milnce_bwd.cu; part: with
// more than one split, splits * out_layers * n_out * C f32 of scratch, else
// unused (may be null).  Pointers of v, t, pm and the output 16-byte aligned
// (TMA).  Returns a cudaError_t (0 = launched).
//
// milnce_dv_wgmma: dv [S, R, C] (out_layers = S).
extern "C" int milnce_dv_wgmma(const void* v, const void* t, long long t_layer_stride,
                               const void* pm, const void* cv, const void* vnum, const void* vden,
                               const void* tnum, const void* tden, const void* gv, const void* gt,
                               void* dv, void* part, int S, int R, int K, int C, int out_layers,
                               int splits, float inv_temp, void* stream) {
  return launch<true>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dv, part, S,
                      R, K, C, out_layers, splits, inv_temp, stream);
}

// milnce_dt_wgmma: dt [out_layers, K, C]; out_layers = 1 sums over the layers
// (the shared text of the dual branch), out_layers = S keeps one per layer.
extern "C" int milnce_dt_wgmma(const void* v, const void* t, long long t_layer_stride,
                               const void* pm, const void* cv, const void* vnum, const void* vden,
                               const void* tnum, const void* tden, const void* gv, const void* gt,
                               void* dt, void* part, int S, int R, int K, int C, int out_layers,
                               int splits, float inv_temp, void* stream) {
  return launch<false>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dt, part, S,
                       R, K, C, out_layers, splits, inv_temp, stream);
}
