// MIL-NCE for Hopper (sm_90a), bf16: the wgmma/TMA kernels of the fused
// loss's forward (milnce_fwd) and of its feature gradients (milnce_dv and
// milnce_dt, one template over the orientation), on one skeleton
// (csrc/milnce_fwd.cu and csrc/milnce_bwd.cu keep the f32 routes and the
// earlier bf16 kernels).
//
// The gradients replace temporalalignnet_tpu/ops/pallas_milnce.py::
// _milnce_bwd_kernel and the column-tiled ::_milnce_dv_kernel and
// ::_milnce_dt_kernel: for each layer s, video row r and text column k,
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
// The forward (milnce_fwd_wgmma_kernel) replaces ::_milnce_fwd_kernel and the
// column-tiled ::_milnce_fwd_tiled_kernel (one kernel at any K): per layer s,
// without writing sim,
//   vnum[s, r] = lse_k pos,  vden[s, r] = lse_k neg,
//   tnum[s, k] = lse_r pos,  tden[s, k] = lse_r neg,
//   pos = pm ? sim : mask_value,  neg = cv ? sim : mask_value.
// Bound by operations too: 2 S R K C FLOPs, 25.8 GFLOP at the training shape
// (26 us), against ~36 MB of v, t and pm (11 us).  It runs on milnce_dv's
// grid, ring and producer (rows outer, one split; no inner vectors staged)
// and its sim with the partial-sum swap; then, in the log2 domain (x = sim
// inv_temp log2(e); masked entries mask_value log2(e), never -inf; entries
// past K or past R -inf), consumer h, holding sim of the 64 rows x its 32
// columns of the tile:
// - rows: folds its 8 entries of each of its 2 rows into a running (max,
//   sum) per row, positives and negatives, kept in registers for the whole
//   stream; at the end the quad's four and the two consumers' merge, and
//   vnum, vden go out as (max + log2 sum) ln 2;
// - columns: (max, sum) over its 2 rows, over the warp's 16 rows by shuffles,
//   then over the 4 warps through shared memory (a per-tile scratch in the
//   dsim tile's place, double buffered by tile parity); one warp writes the
//   row block's column partials in natural-log terms (max ln 2, sum), which
//   milnce_colmerge_kernel (milnce_colmerge.cuh) folds in row-block order, as
//   for the f32 route.
// The exponentials are ex2 without branches: the reference of an all -inf
// (max, sum) is 0 (a select), so it merges as (-inf, 0) and not as NaN.
// (Issuing the next tile's sim before this tile's (max, sum) pairs, so that
// the tensor cores would run during them, was tried and was slower on an
// H100 at every timed shape: ptxas injects a warpgroup wait where the
// epilogue reuses registers, which serialises the two.)
//
// Layout: v [S, R, C] bf16; t [S, K, C] (t_layer_stride = K C) or [K, C]
// (stride 0); pm [R, K] and cv [K] bytes; vnum, vden, gv [S, R] and tnum,
// tden, gt [S, K] f32; dv [S, R, C], dt [out_layers, K, C] bf16.  C a
// multiple of 64 up to 512.  Built by ops/_build.py into a library with a
// plain C interface.

#include "hopper.cuh"
#include "milnce_colmerge.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;             // outer entries per block, inner entries per tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;         // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CHUNK = TILE * 128;    // [64 entries][64 channels] bf16, 8 KB
constexpr int MAX_NC = 8;            // C / 64
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int NC>
struct Plan {
  // the block's outer entries: NC chunks [64][64 c]; at the end the staging
  // of a one-split output
  static constexpr int O_OFF = 0;
  // each stage's inner entries: NC chunks [64][64 c]
  static constexpr int I_OFF = O_OFF + NC * CHUNK;
  static constexpr int I_BYTES = NC * CHUNK;
  // the dsim tile [64 outer][64 inner]; in the forward, the column scratch
  // [2 tile parities][2 consumers][4 warps][32 columns] (max, sum) x 2 f32
  static constexpr int DS_OFF = I_OFF + STAGES * I_BYTES;
  // each stage's pm [64 r][64 k] bytes | inner num log2(e), den log2(e),
  // g inv_temp [64] f32 | inner cv [64] bytes (dv and the forward), padded
  // so that the next stage's pm tile keeps the 128-byte alignment of a TMA
  // destination
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
static_assert(2 * CONSUMERS * 4 * 32 * 16 <= CHUNK, "the forward's column scratch");

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
  float* part;         // f32 partials of an inner split, or null; the forward's column partials
  float *vnum, *vden;  // the forward's row logsumexps [S, R]
  int R, K, n_outer, n_inner, C, layers, tiles_per_split, shared_text, pm_tma;
  float inv_temp, mask_value;
};

// the partial sim[o][i] = outer_o . inner_i over channel chunks C0 .. C0 +
// NB - 1 (a consumer's half), all 64 inner entries (m64n64k16, A and B
// K-major), issued; the caller waits
template <int NC, int NB, int C0>
__device__ __forceinline__ void partial_sim(float (&sim)[32], uint32_t base, uint32_t i_a) {
#pragma unroll
  for (int e = 0; e < 32; ++e) sim[e] = 0.f;
  fence_regs(sim);
  if constexpr (NB > 0) {
    wgmma_fence();
#pragma unroll
    for (int c = C0; c < C0 + NB; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<0, 0>(sim, sw128_desc(base + Plan<NC>::O_OFF + c * CHUNK + kk * 32, 0),
                           sw128_desc(i_a + c * CHUNK + kk * 32, 0));
    wgmma_commit();
  }
}

// swap partial sums: the other consumer's entries out, this one's in (the
// two consumers' threads hold the same (o, i) entries); after it, registers
// 16 H .. 16 H + 15 hold the full sim of this consumer's inner entries
template <int NC, int H>
__device__ __forceinline__ void swap_halves(uint8_t* sm, float (&sim)[32]) {
  float* xch = reinterpret_cast<float*>(sm + Plan<NC>::XCH_OFF);
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int e = 0; e < 16; ++e) xch[(H * 16 + e) * 128 + tid] = sim[16 * (1 - H) + e];
  named_barrier<1, 128 * CONSUMERS>();
#pragma unroll
  for (int e = 0; e < 16; ++e) sim[16 * H + e] += xch[((1 - H) * 16 + e) * 128 + tid];
}

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

    float sim[32];
    partial_sim<NC, NB, C0>(sim, base, i_a);

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
    swap_halves<NC, H>(sm, sim);

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

// ------------------------------------------------- the forward's (max, sum)

// the exponent reference of a log2-domain (max, sum): the max, or 0 where it
// is -inf (every entry is, and each 2^(-inf - 0) = 0 keeps the sum at 0)
__device__ __forceinline__ float ex2_ref(float m) { return m == -INFINITY ? 0.f : m; }

// (m, s) with s = sum 2^(x - m), folded with the 8 entries x
__device__ __forceinline__ void fold8(float& m, float& s, const float (&x)[8]) {
  float mx = m;
#pragma unroll
  for (int c = 0; c < 8; ++c) mx = fmaxf(mx, x[c]);
  const float r = ex2_ref(mx);
  float sum = s * ex2(m - r);
#pragma unroll
  for (int c = 0; c < 8; ++c) sum += ex2(x[c] - r);
  m = mx, s = sum;
}

// (m, s) merged with (m2, s2)
__device__ __forceinline__ void merge2(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2), r = ex2_ref(mx);
  s = s * ex2(m - r) + s2 * ex2(m2 - r);
  m = mx;
}

// over the 8 lanes of a warp that share t (the rows g of a column)
__device__ __forceinline__ float max_over_g(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum_over_g(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// forward consumer H: the partial sim over channel chunks C0 .. C0 + NB - 1,
// then the masked (max, sum) of text columns 32 H .. 32 H + 31 of each tile
template <int NC, int NB, int C0, int H>
__device__ __forceinline__ void consume_fwd(uint8_t* sm, const Args& a, int total) {
  using P = Plan<NC>;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, tid = threadIdx.x % 128;
  const int rb = blockIdx.x, s = blockIdx.y, nrb = gridDim.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* obar = empty + STAGES;
  const uint32_t base = smem_addr(sm);
  float4* scratch = reinterpret_cast<float4*>(sm + P::DS_OFF);
  const float c2 = a.inv_temp * LOG2E, mv2 = a.mask_value * LOG2E;

  // this thread's two rows of the tile, 16 warp + g and + 8, and their
  // running (max, sum) of the positives [0] and negatives [1]
  bool rlive[2];
  float rm[2][2], rs[2][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rlive[hh] = rb * TILE + 16 * warp + g + 8 * hh < a.R;
    rm[hh][0] = rm[hh][1] = -INFINITY;
    rs[hh][0] = rs[hh][1] = 0.f;
  }

  mbar_wait(obar, 0);
  for (int n = 0; n < total; ++n) {
    const int st = n % STAGES, i0 = n * TILE;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const uint8_t* aux = sm + P::AUX_OFF + st * P::AUX_BYTES;
    mbar_wait(&full[st], ph);

    float sim[32];
    partial_sim<NC, NB, C0>(sim, base, base + P::I_OFF + st * P::I_BYTES);

    // while the tensor cores run: the mask bits of this consumer's columns
    // (c = 2 j + i: column 32 H + 8 j + 2 t + i)
    bool pos[8][2], keep[8], live[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 32 * H + 8 * (c / 2) + 2 * t + c % 2;
      live[c] = i0 + col < a.K;
      keep[c] = aux[P::AUX_CV + col] != 0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) pos[c][hh] = aux[(16 * warp + g + 8 * hh) * TILE + col] != 0;
    }
    if constexpr (NB > 0) wgmma_wait<0>();
    fence_regs(sim);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    swap_halves<NC, H>(sm, sim);

    // the entries in the log2 domain: masked mask_value log2(e), dead -inf
    float xp[2][8], xn[2][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 2 * j + i;
          const float x = sim[16 * H + 4 * j + 2 * hh + i] * c2;
          const bool in = rlive[hh] && live[c];
          xp[hh][c] = in ? (pos[c][hh] ? x : mv2) : -INFINITY;
          xn[hh][c] = in ? (keep[c] ? x : mv2) : -INFINITY;
        }

    // rows: this thread's 8 entries of each into the running (max, sum)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      fold8(rm[hh][0], rs[hh][0], xp[hh]);
      fold8(rm[hh][1], rs[hh][1], xn[hh]);
    }

    // columns: (max, sum) over the warp's 16 rows, into the scratch of this
    // tile's parity [consumer][warp][column] as (mp, sp, mn, sn)
    float4* sc = scratch + ((n & 1) * CONSUMERS + H) * 4 * 32;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float mp = max_over_g(fmaxf(xp[0][c], xp[1][c]));
      const float mn = max_over_g(fmaxf(xn[0][c], xn[1][c]));
      const float rp = ex2_ref(mp), rn = ex2_ref(mn);
      const float sp = sum_over_g(ex2(xp[0][c] - rp) + ex2(xp[1][c] - rp));
      const float sn = sum_over_g(ex2(xn[0][c] - rn) + ex2(xn[1][c] - rn));
      if (g == 0) sc[warp * 32 + 8 * (c / 2) + 2 * t + c % 2] = make_float4(mp, sp, mn, sn);
    }
    // every warp's columns are in; and both consumers have read their
    // partial sums, so the next tile may swap again
    named_barrier<2, 128 * CONSUMERS>();

    // ... over the 4 warps: this row block's partial of each column
    if (warp == 0) {
      float4 w[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) w[v] = sc[v * 32 + lane];
      const float mp = fmaxf(fmaxf(w[0].x, w[1].x), fmaxf(w[2].x, w[3].x));
      const float mn = fmaxf(fmaxf(w[0].z, w[1].z), fmaxf(w[2].z, w[3].z));
      const float rp = ex2_ref(mp), rn = ex2_ref(mn);
      float sp = 0.f, sn = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        sp += w[v].y * ex2(w[v].x - rp);
        sn += w[v].w * ex2(w[v].z - rn);
      }
      const int k = i0 + 32 * H + lane;
      if (k < a.K) {  // natural-log terms, as milnce_colmerge_kernel reads them
        const size_t plane = size_t(gridDim.y) * nrb * a.K;
        const size_t p = (size_t(s) * nrb + rb) * a.K + k;
        a.part[p] = mp * LN2;
        a.part[plane + p] = sp;
        a.part[2 * plane + p] = mn * LN2;
        a.part[3 * plane + p] = sn;
      }
    }
  }

  // rows: merged over the quad (the thread's 8 columns of each tile x 4),
  // then consumer 1's into consumer 0's through the exchange area, which no
  // one reads any more (both passed the last tile's barrier 2)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        merge2(rm[hh][q], rs[hh][q], __shfl_xor_sync(0xffffffffu, rm[hh][q], off),
               __shfl_xor_sync(0xffffffffu, rs[hh][q], off));
  float* xch = reinterpret_cast<float*>(sm + P::XCH_OFF);
  if constexpr (H == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        xch[(4 * hh + 2 * q) * 128 + tid] = rm[hh][q];
        xch[(4 * hh + 2 * q + 1) * 128 + tid] = rs[hh][q];
      }
  }
  named_barrier<3, 128 * CONSUMERS>();
  if constexpr (H == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
        merge2(rm[hh][q], rs[hh][q], xch[(4 * hh + 2 * q) * 128 + tid],
               xch[(4 * hh + 2 * q + 1) * 128 + tid]);
      if (t == 0 && rlive[hh]) {
        const size_t r = size_t(s) * a.R + rb * TILE + 16 * warp + g + 8 * hh;
        a.vnum[r] = (rm[hh][0] + log2f(rs[hh][0])) * LN2;
        a.vden[r] = (rm[hh][1] + log2f(rs[hh][1])) * LN2;
      }
    }
  }
}

// ------------------------------------------------------------------ producer

// the producer warp: the block's outer entries once, then per tile its inner
// entries (TMA), mask tile (TMA, or staged by the lanes), and the inner
// entries' vectors (VECS: the gradients) and, rows outer, their cv bytes
template <bool ROWS_OUTER, int NC, bool VECS>
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
    if (lane == 0) {  // ... and the inner operand of dv and the forward
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
    for (int e = lane; e < TILE; e += 32) {
      const int i = i0 + e;
      const bool in = i < a.n_inner;
      if constexpr (VECS) {
        float* vec = reinterpret_cast<float*>(aux + P::AUX_VEC);
        const size_t idx = size_t(s) * a.n_inner + (in ? i : 0);
        vec[e] = in ? a.inum[idx] * LOG2E : 0.f;
        vec[TILE + e] = in ? a.iden[idx] * LOG2E : 0.f;
        vec[2 * TILE + e] = in ? a.ig[idx] * a.inv_temp : 0.f;
      }
      if (ROWS_OUTER) aux[P::AUX_CV + e] = in ? a.cv[i] : 0;
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[st]);
  }
}

template <int NC>
__device__ __forceinline__ void init_barriers(uint8_t* sm) {
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Plan<NC>::BAR_OFF);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    mbar_init(empty + STAGES, 1);  // the outer entries
    mbar_fence_init();
  }
  __syncthreads();
}

// the dynamic shared memory from its first 1024-byte boundary (128-byte
// swizzled tiles)
__device__ __forceinline__ uint8_t* align1024(uint8_t* smem_raw) {
  return smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
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
  uint8_t* sm = align1024(smem_raw);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int n_tiles = (a.n_inner + TILE - 1) / TILE;
  const int it0 = blockIdx.z * a.tiles_per_split;
  const int per = min(it0 + a.tiles_per_split, n_tiles) - it0;  // > 0: no empty split
  const int total = a.layers * per;
  init_barriers<NC>(sm);

  if (wg == CONSUMERS) {  // producer
    setmaxnreg_dec<40>();
    if (warp == 0) produce<ROWS_OUTER, NC, true>(sm, a, &to, &ti, &tpm, total, per);
  } else {  // consumers
    setmaxnreg_inc<232>();
    if (wg == 0)
      consume<ROWS_OUTER, NC, P::NB0, 0, 0>(sm, a, &tout, total, per);
    else
      consume<ROWS_OUTER, NC, P::NB1, P::NB0, 1>(sm, a, &tout, total, per);
  }
}

// grid (R / 64, S); tout is not read
template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
milnce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tt,
                        const __grid_constant__ CUtensorMap tpm,
                        const __grid_constant__ CUtensorMap tout, const Args a) {
  using P = Plan<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int total = (a.K + TILE - 1) / TILE;
  init_barriers<NC>(sm);

  if (wg == CONSUMERS) {
    setmaxnreg_dec<40>();
    if (warp == 0) produce<true, NC, false>(sm, a, &tv, &tt, &tpm, total, total);
  } else {
    setmaxnreg_inc<232>();
    if (wg == 0)
      consume_fwd<NC, P::NB0, 0, 0>(sm, a, total);
    else
      consume_fwd<NC, P::NB1, P::NB0, 1>(sm, a, total);
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

// -------------------------------------------------------------- launchers

enum Kind { FWD, DV, DT };

template <int NC>
cudaError_t launch_nc(Kind kind, const CUtensorMap* maps, const Args& a, dim3 grid,
                      cudaStream_t stream) {
  auto kernel = kind == FWD  ? milnce_fwd_wgmma_kernel<NC>
                : kind == DV ? milnce_grad_wgmma_kernel<true, NC>
                             : milnce_grad_wgmma_kernel<false, NC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<NC>::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, Plan<NC>::BYTES, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

cudaError_t launch_kind(Kind kind, int C, const CUtensorMap* maps, const Args& a, dim3 grid,
                        cudaStream_t stream) {
  switch (C / 64) {
    case 1: return launch_nc<1>(kind, maps, a, grid, stream);
    case 2: return launch_nc<2>(kind, maps, a, grid, stream);
    case 3: return launch_nc<3>(kind, maps, a, grid, stream);
    case 4: return launch_nc<4>(kind, maps, a, grid, stream);
    case 5: return launch_nc<5>(kind, maps, a, grid, stream);
    case 6: return launch_nc<6>(kind, maps, a, grid, stream);
    case 7: return launch_nc<7>(kind, maps, a, grid, stream);
    case 8: return launch_nc<8>(kind, maps, a, grid, stream);
  }
  return cudaErrorInvalidValue;
}

// what every launcher takes: S up to 65535 (a grid dimension), C a multiple
// of 64 up to 512, a text layer stride of 0 (shared) or K C, and 16-byte
// aligned TMA operands
bool inputs_ok(const void* v, const void* t, long long t_layer_stride, const void* pm, int S,
               int R, int K, int C) {
  const void* aligned[3] = {v, t, pm};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return S > 0 && S <= 65535 && R > 0 && K > 0 && C > 0 && C % 64 == 0 && C <= 64 * MAX_NC &&
         (t_layer_stride == 0 || t_layer_stride == (long long)K * C);
}

// tensor maps of v [S, R, C] and t [S or 1, K, C] ([64 entries][64 channels]
// boxes, 128-byte swizzle) and, when K is a multiple of 16, of pm [R, K]
// ([64][64] boxes; else the producer stages it and pmmap is not read)
bool input_maps(CUtensorMap* vmap, CUtensorMap* tmap, CUtensorMap* pmmap, const void* v,
                const void* t, long long t_layer_stride, const void* pm, int S, int R, int K,
                int C) {
  const uint64_t v_dims[3] = {uint64_t(C), uint64_t(R), uint64_t(S)};
  const uint64_t v_strides[2] = {uint64_t(C) * 2, uint64_t(R) * C * 2};
  const uint64_t t_dims[3] = {uint64_t(C), uint64_t(K), uint64_t(t_layer_stride ? S : 1)};
  const uint64_t t_strides[2] = {uint64_t(C) * 2, uint64_t(K) * C * 2};
  const uint32_t box[3] = {64, TILE, 1};
  const uint64_t pm_dims[2] = {uint64_t(K), uint64_t(R)};
  const uint64_t pm_strides[1] = {uint64_t(K)};
  const uint32_t pm_box[2] = {TILE, TILE};
  if (!make_map(vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, v_dims, v_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, t, t_dims, t_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (K % 16 != 0) {
    *pmmap = *vmap;
    return true;
  }
  return make_map(pmmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, pm, pm_dims, pm_strides, pm_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool ROWS_OUTER>
int launch_grad(const void* v, const void* t, long long t_layer_stride, const void* pm,
                const void* cv, const void* vnum, const void* vden, const void* tnum,
                const void* tden, const void* gv, const void* gt, void* out, void* part, int S,
                int R, int K, int C, int out_layers, int splits, float inv_temp, void* stream) {
  if (!inputs_ok(v, t, t_layer_stride, pm, S, R, K, C) || splits <= 0 || splits > 65535 ||
      (out_layers != S && out_layers != 1) || (ROWS_OUTER && out_layers != S) ||
      (!ROWS_OUTER && S > 1 && (t_layer_stride == 0) != (out_layers == 1)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const int n_outer = ROWS_OUTER ? R : K, n_inner = ROWS_OUTER ? K : R;
  const int itiles = (n_inner + TILE - 1) / TILE;
  const int per_split = (itiles + splits - 1) / splits;
  splits = (itiles + per_split - 1) / per_split;  // no empty split
  if (splits > 1 && part == nullptr) return int(cudaErrorInvalidValue);

  // to, ti, pm, out
  CUtensorMap maps[4], vmap, tmap;
  const uint64_t o_dims[3] = {uint64_t(C), uint64_t(n_outer), uint64_t(out_layers)};
  const uint64_t o_strides[2] = {uint64_t(C) * 2, uint64_t(n_outer) * C * 2};
  const uint32_t box[3] = {64, TILE, 1};
  if (!input_maps(&vmap, &tmap, &maps[2], v, t, t_layer_stride, pm, S, R, K, C) ||
      !make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, o_dims, o_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  maps[0] = ROWS_OUTER ? vmap : tmap;
  maps[1] = ROWS_OUTER ? tmap : vmap;

  const float* rows[3] = {static_cast<const float*>(vnum), static_cast<const float*>(vden),
                          static_cast<const float*>(gv)};
  const float* cols[3] = {static_cast<const float*>(tnum), static_cast<const float*>(tden),
                          static_cast<const float*>(gt)};
  const float* const* outer = ROWS_OUTER ? rows : cols;
  const float* const* inner = ROWS_OUTER ? cols : rows;
  Args a{};
  a.pm = static_cast<const uint8_t*>(pm);
  a.cv = static_cast<const uint8_t*>(cv);
  a.onum = outer[0], a.oden = outer[1], a.og = outer[2];
  a.inum = inner[0], a.iden = inner[1], a.ig = inner[2];
  a.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  a.R = R, a.K = K, a.n_outer = n_outer, a.n_inner = n_inner, a.C = C;
  a.layers = S / out_layers, a.tiles_per_split = per_split;
  a.shared_text = t_layer_stride == 0, a.pm_tma = K % 16 == 0, a.inv_temp = inv_temp;

  const dim3 grid(unsigned((n_outer + TILE - 1) / TILE), unsigned(out_layers), unsigned(splits));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_kind(ROWS_OUTER ? DV : DT, C, maps, a, grid, st);
  if (err != cudaSuccess || splits == 1) return int(err);
  const size_t n4 = size_t(out_layers) * n_outer * C / 4;
  milnce_reduce_kernel<<<unsigned((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(part), static_cast<uint2*>(out), n4, splits);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 only.  v [S, R, C]; t [K, C] per layer at a stride of t_layer_stride
// elements (0: one text shared by every layer); pm [R, K] and cv [K] bytes;
// vnum, vden [S, R], tnum, tden [S, K] f32; part: 4 S ceil(R/64) K f32 of
// scratch (the column partials).  Pointers of v, t and pm 16-byte aligned
// (TMA).  Returns a cudaError_t (0 = launched).
extern "C" int milnce_fwd_wgmma(const void* v, const void* t, long long t_layer_stride,
                                const void* pm, const void* cv, void* vnum, void* vden,
                                void* tnum, void* tden, void* part, int S, int R, int K, int C,
                                float mask_value, float inv_temp, void* stream) {
  if (!inputs_ok(v, t, t_layer_stride, pm, S, R, K, C)) return int(cudaErrorInvalidValue);
  CUtensorMap maps[4];  // v, t, pm; the fourth is not read
  if (!input_maps(&maps[0], &maps[1], &maps[2], v, t, t_layer_stride, pm, S, R, K, C))
    return int(cudaErrorInvalidValue);
  maps[3] = maps[0];
  Args a{};
  a.pm = static_cast<const uint8_t*>(pm);
  a.cv = static_cast<const uint8_t*>(cv);
  a.part = static_cast<float*>(part);
  a.vnum = static_cast<float*>(vnum), a.vden = static_cast<float*>(vden);
  a.R = R, a.K = K, a.n_outer = R, a.n_inner = K, a.C = C;
  a.layers = 1, a.tiles_per_split = (K + TILE - 1) / TILE;
  a.shared_text = t_layer_stride == 0, a.pm_tma = K % 16 == 0;
  a.inv_temp = inv_temp, a.mask_value = mask_value;

  const dim3 grid(unsigned((R + TILE - 1) / TILE), unsigned(S));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_kind(FWD, C, maps, a, grid, st);
  if (err != cudaSuccess) return int(err);
  return int(milnce::colmerge(part, tnum, tden, S, R, K, st));
}

// The gradients, bf16 only.  Inputs as milnce_dv / milnce_dt in
// milnce_bwd.cu; part: with more than one split, splits * out_layers * n_out
// * C f32 of scratch, else unused (may be null).  Pointers of v, t, pm and the
// output 16-byte aligned (TMA).  Returns a cudaError_t (0 = launched).
//
// milnce_dv_wgmma: dv [S, R, C] (out_layers = S).
extern "C" int milnce_dv_wgmma(const void* v, const void* t, long long t_layer_stride,
                               const void* pm, const void* cv, const void* vnum, const void* vden,
                               const void* tnum, const void* tden, const void* gv, const void* gt,
                               void* dv, void* part, int S, int R, int K, int C, int out_layers,
                               int splits, float inv_temp, void* stream) {
  return launch_grad<true>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dv, part,
                           S, R, K, C, out_layers, splits, inv_temp, stream);
}

// milnce_dt_wgmma: dt [out_layers, K, C]; out_layers = 1 sums over the layers
// (the shared text of the dual branch), out_layers = S keeps one per layer.
extern "C" int milnce_dt_wgmma(const void* v, const void* t, long long t_layer_stride,
                               const void* pm, const void* cv, const void* vnum, const void* vden,
                               const void* tnum, const void* tden, const void* gv, const void* gt,
                               void* dt, void* part, int S, int R, int K, int C, int out_layers,
                               int splits, float inv_temp, void* stream) {
  return launch_grad<false>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dt,
                            part, S, R, K, C, out_layers, splits, inv_temp, stream);
}
