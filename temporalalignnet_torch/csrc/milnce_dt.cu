// MIL-NCE text gradient for Hopper (sm_90a), bf16: the wgmma/TMA redesign of
// milnce_dt (csrc/milnce_bwd.cu keeps the f32 route and the v2 kernel).
//
// Replaces temporalalignnet_tpu/ops/pallas_milnce.py::_milnce_dt_kernel and
// the dt half of ::_milnce_bwd_kernel: for each layer s and text column k,
//   dt[k] = sum_r dsim[r, k] v[r],
//   dsim = inv_temp * (gv[r] (p_neg - p_pos) + gt[k] (q_neg - q_pos)),
//   p_pos = pm ? exp(sim - vnum[r]) : 0,  p_neg = cv ? exp(sim - vden[r]) : 0,
//   q_pos = pm ? exp(sim - tnum[k]) : 0,  q_neg = cv ? exp(sim - tden[k]) : 0,
// sim = inv_temp v[r] . t[k], recomputed from the features and re-masked as
// _dsim_tile does (pallas_milnce.py:128-151); dsim rounded to bf16 before the
// product, every sum in f32.  With the dual branch's shared text
// (out_layers = 1) the block also sums over the layers.
//
// What bounds it on an H100: operations.  4 S R K C FLOPs (sim again, then
// the product): 51.5 GFLOP at the B = 64 training shape, 52 us at 989
// TFLOP/s, against ~40 MB of inputs and outputs (12 us).
//
// The design, for that bound:
// - One block per (64 text columns, output layer, row split), warp
//   specialised: warpgroup 2 is the producer (one warp keeps TMA loads in
//   flight into a two-stage ring guarded by mbarriers; setmaxnreg gives its
//   registers to the consumers), warpgroups 0 and 1 consume.
// - The block's 64 text columns stay resident in shared memory (one TMA load
//   per block).  A stage holds a 64-row tile of v ([64][C] bf16, 128-byte
//   swizzle, rows past R zero-filled by TMA), its [64 r][64 k] positive-mask
//   tile (TMA when K is a multiple of 16, else staged by the producer warp),
//   and its rows' vnum, vden, gv.
// - Per tile, consumer h computes a partial sim^T[k][r] = t_k . v_r over its
//   half of the channels for all 64 rows r (m64n64k16, A and B K-major: half
//   the shared-memory operand traffic of splitting the rows); the two swap
//   the partial sums of each other's rows through shared memory (named
//   barrier), each forms dsim of its 32 rows in registers (exp2 on the
//   special-function unit, branch-free re-masking) and writes it as bf16 to
//   a shared [64 k][64 r] tile; a second named barrier joins the halves;
//   then dt[64 k][its channels] += dsim . v_rows (m64nNk16, N up to 256, B =
//   the same v tile read MN-major), the f32 accumulator in registers for the
//   whole row stream.
// - Row splits (to fill the card when K / 64 x layers is short) write f32
//   partials that milnce_dt_reduce_kernel sums in split order: the result
//   does not depend on the schedule.  (Summing them inside a thread-block
//   cluster through distributed shared memory was tried and was slower on
//   an H100: clusters of up to 8 blocks of 226 KB fit fewer blocks on the
//   card at once.  So was a 32-row tile with a four-stage ring, the next
//   tile's sim started before this tile's dsim: the halved tiles doubled the
//   per-tile barriers and waits.)
//
// Layout: v [S, R, C] bf16; t [S, K, C] (t_layer_stride = K C) or [K, C]
// (stride 0); pm [R, K] and cv [K] bytes; vnum, vden, gv [S, R] and tnum,
// tden, gt [S, K] f32; dt [out_layers, K, C] bf16.  C a multiple of 64 up to
// 512.  Built by ops/_build.py into a library with a plain C interface.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;             // text columns per block, video rows per tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;         // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CHUNK = TILE * 128;    // [64 rows][64 channels] bf16, 8 KB
constexpr int MAX_NC = 8;            // C / 64
constexpr float LOG2E = 1.4426950408889634f;

template <int NC>
struct Plan {
  // the block's text columns: NC chunks [64 k][64 c]
  static constexpr int T_OFF = 0;
  // each stage's v rows: NC chunks [64 r][64 c]
  static constexpr int V_OFF = T_OFF + NC * CHUNK;
  static constexpr int V_BYTES = NC * CHUNK;
  // the dsim tile [64 k][64 r]
  static constexpr int DS_OFF = V_OFF + STAGES * V_BYTES;
  // each stage's pm [64 r][64 k] bytes | vnum log2(e), vden log2(e), gv inv_temp [64] f32
  static constexpr int AUX_OFF = DS_OFF + CHUNK;
  static constexpr int AUX_VEC = TILE * TILE;
  static constexpr int AUX_BYTES = AUX_VEC + 3 * TILE * 4;
  // each consumer's partial sim of the other's rows: [16 registers][128 threads] f32
  static constexpr int XCH_OFF = AUX_OFF + STAGES * AUX_BYTES;
  static constexpr int BAR_OFF = XCH_OFF + CONSUMERS * 16 * 128 * 4;  // full, empty, t
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;
  // channel chunks of each consumer: consumer 0 the first NB0, consumer 1 the rest
  static constexpr int NB0 = (NC + 1) / 2, NB1 = NC / 2;
};

// 2^x on the special-function unit (relative error 2^-22; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc += A B for a 64 x (64 NB) tile, B MN-major (the channels of the v tile)
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
  const float *vnum, *vden, *tnum, *tden, *gv, *gt;
  float* part;
  int R, K, C, layers, tiles_per_split, shared_text, pm_tma;
  float inv_temp;
};

// consumer H: channels from chunk C0, NB chunks of them; rows 32 H .. +31 of
// each tile for dsim
template <int NC, int NB, int C0, int H>
__device__ __forceinline__ void consume(uint8_t* sm, const Args& a, int total, int per) {
  using P = Plan<NC>;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * TILE, y = blockIdx.y;
  const int s0 = y * a.layers, it0 = blockIdx.z * a.tiles_per_split;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* tbar = empty + STAGES;
  const uint32_t base = smem_addr(sm);

  float acc[32 * (NB > 0 ? NB : 1)];
#pragma unroll
  for (int e = 0; e < 32 * (NB > 0 ? NB : 1); ++e) acc[e] = 0.f;
  fence_regs(acc);

  // this thread's two text columns (rows of sim^T): 16 warp + g, + 8
  int kc[2];
  bool kin[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    kc[hh] = k0 + 16 * warp + g + 8 * hh;
    kin[hh] = kc[hh] < a.K;
  }
  bool cvk[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) cvk[hh] = kin[hh] && a.cv[kc[hh]] != 0;
  // exp(inv_temp sim - lse) = exp2(sim c2 - lse log2(e)); the cotangents
  // carry the outer inv_temp
  const float c2 = a.inv_temp * LOG2E;
  float kn[2], kd[2], kg[2];
  int layer = -1;

  mbar_wait(tbar, 0);
  for (int n = 0; n < total; ++n) {
    const int st = n % STAGES;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const int s = s0 + n / per, r0 = (it0 + n % per) * TILE;
    if (s != layer) {  // the column vectors of layer s
      layer = s;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t i = size_t(s) * a.K + (kin[hh] ? kc[hh] : 0);
        kn[hh] = kin[hh] ? a.tnum[i] * LOG2E : 0.f;
        kd[hh] = kin[hh] ? a.tden[i] * LOG2E : 0.f;
        kg[hh] = kin[hh] ? a.gt[i] * a.inv_temp : 0.f;
      }
    }
    const uint32_t v_a = base + P::V_OFF + st * P::V_BYTES;
    const uint8_t* aux = sm + P::AUX_OFF + st * P::AUX_BYTES;
    mbar_wait(&full[st], ph);

    // partial sim^T[k][r] over this consumer's channels, all 64 rows r:
    // m64n64k16 (A = t, B = v, both K-major)
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
          wgmma_ss_n64<0, 0>(sim, sw128_desc(base + P::T_OFF + c * CHUNK + kk * 32, 0),
                             sw128_desc(v_a + c * CHUNK + kk * 32, 0));
      wgmma_commit();
    }

    // while the tensor cores run: the vectors and mask bits of this
    // consumer's rows (register e of chunk j: text column 16 warp + g +
    // 8 ((e >> 1) & 1), row 8 j + 2 t + (e & 1))
    const uint8_t* pms = aux;
    const float* vn = reinterpret_cast<const float*>(aux + P::AUX_VEC);
    const float* vd = vn + TILE;
    const float* gvs = vd + TILE;
    float rn[8], rd[8], rg[8];
    bool pos[8][2], live[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 32 * H + 8 * (c / 2) + 2 * t + c % 2;
      rn[c] = vn[col];
      rd[c] = vd[col];
      rg[c] = gvs[col];
      live[c] = r0 + col < a.R;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) pos[c][hh] = pms[col * TILE + 16 * warp + g + 8 * hh] != 0;
    }
    if constexpr (NB > 0) wgmma_wait<0>();
    fence_regs(sim);

    // swap partial sums: the other consumer's rows out, this one's in (the
    // two consumers' threads hold the same (k, r) entries)
    float* xch = reinterpret_cast<float*>(sm + P::XCH_OFF);
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int e = 0; e < 16; ++e) xch[(H * 16 + e) * 128 + tid] = sim[16 * (1 - H) + e];
    named_barrier<1, 128 * CONSUMERS>();
#pragma unroll
    for (int e = 0; e < 16; ++e) sim[16 * H + e] += xch[((1 - H) * 16 + e) * 128 + tid];

    // dsim of this consumer's rows, re-masked, rounded to bf16 into the tile
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
          const float neg = cvk[hh] ? x : -INFINITY, pst = p ? x : -INFINITY;
          const float d = rg[c] * (ex2(neg - rd[c]) - ex2(pst - rn[c])) +
                          kg[hh] * (ex2(neg - kd[hh]) - ex2(pst - kn[hh]));
          d2[i] = live[c] ? d : 0.f;
        }
        *reinterpret_cast<uint32_t*>(ds + sw128_offset(16 * warp + g + 8 * hh,
                                                        32 * H + 8 * j + 2 * t)) =
            pack_bf16x2(d2[0], d2[1]);
      }
    fence_async_smem();
    named_barrier<2, 128 * CONSUMERS>();  // both halves of dsim are written

    // dt[64 k][this consumer's channels] += dsim . v_rows, K = the 64 rows
    if constexpr (NB > 0) {
      const uint32_t ds_a = base + P::DS_OFF;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        product<NB>(acc, sw128_desc(ds_a + kk * 32, 0),
                    sw128_desc(v_a + C0 * CHUNK + kk * 2048, CHUNK));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  if constexpr (NB > 0) {  // the f32 partial of this split
    float* out = a.part + (size_t(blockIdx.z) * gridDim.y + blockIdx.y) * size_t(a.K) * a.C;
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (kin[hh])
          *reinterpret_cast<float2*>(out + size_t(kc[hh]) * a.C + C0 * 64 + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// the producer warp: the block's text columns once, then per tile its v rows
// (TMA), mask tile (TMA, or staged by the lanes) and row vectors
template <int NC>
__device__ __forceinline__ void produce(uint8_t* sm, const Args& a, const CUtensorMap* tt,
                                        const CUtensorMap* tv, const CUtensorMap* tpm, int total,
                                        int per) {
  using P = Plan<NC>;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* tbar = empty + STAGES;
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * TILE, s0 = blockIdx.y * a.layers;
  const int it0 = blockIdx.z * a.tiles_per_split;
  if (lane == 0) {
    mbar_arrive_expect_tx(tbar, NC * CHUNK);
    for (int c = 0; c < NC; ++c)
      tma_load_3d(sm + P::T_OFF + c * CHUNK, tt, tbar, c * 64, k0, a.shared_text ? 0 : s0);
  }
  for (int n = 0; n < total; ++n) {
    const int st = n % STAGES;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const int s = s0 + n / per, r0 = (it0 + n % per) * TILE;
    uint8_t* vs = sm + P::V_OFF + st * P::V_BYTES;
    uint8_t* aux = sm + P::AUX_OFF + st * P::AUX_BYTES;
    mbar_wait(&empty[st], ph ^ 1u);
    if (lane == 0) {
      mbar_expect_tx(&full[st], NC * CHUNK + (a.pm_tma ? TILE * TILE : 0));
      for (int c = 0; c < NC; ++c) tma_load_3d(vs + c * CHUNK, tv, &full[st], c * 64, r0, s);
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
      const int r = r0 + e;
      const bool in = r < a.R;
      const size_t i = size_t(s) * a.R + (in ? r : 0);
      vec[e] = in ? a.vnum[i] * LOG2E : 0.f;
      vec[TILE + e] = in ? a.vden[i] * LOG2E : 0.f;
      vec[2 * TILE + e] = in ? a.gv[i] * a.inv_temp : 0.f;
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[st]);
  }
}

// grid (K / 64, out_layers, splits)
template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
milnce_dt_wgmma_kernel(const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tt,
                       const __grid_constant__ CUtensorMap tpm, const Args a) {
  using P = Plan<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* tbar = empty + STAGES;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int n_tiles = (a.R + TILE - 1) / TILE;
  const int it0 = blockIdx.z * a.tiles_per_split;
  const int per = min(it0 + a.tiles_per_split, n_tiles) - it0;  // > 0: no empty split
  const int total = a.layers * per;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    mbar_init(tbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // producer
    setmaxnreg_dec<40>();
    if (warp == 0) produce<NC>(sm, a, &tt, &tv, &tpm, total, per);
  } else {  // consumers
    setmaxnreg_inc<232>();
    if (wg == 0)
      consume<NC, P::NB0, 0, 0>(sm, a, total, per);
    else
      consume<NC, P::NB1, P::NB0, 1>(sm, a, total, per);
  }
}

// dt[y, k, c] = sum over splits of part[split, y, k, c], in split order, as
// bf16; four entries a thread (n is a multiple of 64)
__global__ void milnce_dt_reduce_kernel(const float4* __restrict__ part, uint2* __restrict__ out,
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

template <int NC>
cudaError_t launch_nc(const CUtensorMap* maps, const Args& a, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(milnce_dt_wgmma_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<NC>::BYTES);
  if (err != cudaSuccess) return err;
  milnce_dt_wgmma_kernel<NC><<<grid, THREADS, Plan<NC>::BYTES, stream>>>(maps[0], maps[1],
                                                                         maps[2], a);
  return cudaGetLastError();
}

}  // namespace

// bf16 only.  Inputs and dt as milnce_dt in milnce_bwd.cu; part: splits *
// out_layers * K * C f32 of scratch.  Pointers of v, t and pm 16-byte
// aligned (TMA).  Returns a cudaError_t (0 = launched).
extern "C" int milnce_dt_wgmma(const void* v, const void* t, long long t_layer_stride,
                               const void* pm, const void* cv, const void* vnum, const void* vden,
                               const void* tnum, const void* tden, const void* gv, const void* gt,
                               void* dt, void* part, int S, int R, int K, int C, int out_layers,
                               int splits, float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0 || C > 64 * MAX_NC ||
      splits <= 0 || splits > 65535 || (out_layers != S && out_layers != 1) ||
      (t_layer_stride != 0 && t_layer_stride != (long long)K * C) ||
      (S > 1 && (t_layer_stride == 0) != (out_layers == 1)))
    return int(cudaErrorInvalidValue);
  const void* aligned[5] = {v, t, pm, dt, part};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  const int itiles = (R + TILE - 1) / TILE;
  const int per_split = (itiles + splits - 1) / splits;
  splits = (itiles + per_split - 1) / per_split;  // no empty split

  CUtensorMap maps[3];
  const uint64_t v_dims[3] = {uint64_t(C), uint64_t(R), uint64_t(S)};
  const uint64_t v_strides[2] = {uint64_t(C) * 2, uint64_t(R) * C * 2};
  const uint64_t t_dims[3] = {uint64_t(C), uint64_t(K), uint64_t(t_layer_stride ? S : 1)};
  const uint64_t t_strides[2] = {uint64_t(C) * 2, uint64_t(K) * C * 2};
  const uint32_t box[3] = {64, TILE, 1};
  const bool pm_tma = K % 16 == 0;
  const uint64_t pm_dims[2] = {uint64_t(K), uint64_t(R)};
  const uint64_t pm_strides[1] = {uint64_t(K)};
  const uint32_t pm_box[2] = {TILE, TILE};
  if (!make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v, v_dims, v_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, t, t_dims, t_strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  if (pm_tma) {
    if (!make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, pm, pm_dims, pm_strides, pm_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
      return int(cudaErrorInvalidValue);
  } else {
    maps[2] = maps[0];  // not read
  }

  Args a;
  a.pm = static_cast<const uint8_t*>(pm);
  a.cv = static_cast<const uint8_t*>(cv);
  a.vnum = static_cast<const float*>(vnum);
  a.vden = static_cast<const float*>(vden);
  a.tnum = static_cast<const float*>(tnum);
  a.tden = static_cast<const float*>(tden);
  a.gv = static_cast<const float*>(gv);
  a.gt = static_cast<const float*>(gt);
  a.part = static_cast<float*>(part);
  a.R = R, a.K = K, a.C = C, a.layers = S / out_layers, a.tiles_per_split = per_split;
  a.shared_text = t_layer_stride == 0, a.pm_tma = pm_tma, a.inv_temp = inv_temp;

  const dim3 grid(unsigned((K + TILE - 1) / TILE), unsigned(out_layers), unsigned(splits));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (C / 64) {
    case 1: err = launch_nc<1>(maps, a, grid, st); break;
    case 2: err = launch_nc<2>(maps, a, grid, st); break;
    case 3: err = launch_nc<3>(maps, a, grid, st); break;
    case 4: err = launch_nc<4>(maps, a, grid, st); break;
    case 5: err = launch_nc<5>(maps, a, grid, st); break;
    case 6: err = launch_nc<6>(maps, a, grid, st); break;
    case 7: err = launch_nc<7>(maps, a, grid, st); break;
    case 8: err = launch_nc<8>(maps, a, grid, st); break;
  }
  if (err != cudaSuccess) return int(err);
  const size_t n4 = size_t(out_layers) * K * C / 4;
  milnce_dt_reduce_kernel<<<unsigned((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(part), static_cast<uint2*>(dt), n4, splits);
  return int(cudaGetLastError());
}
