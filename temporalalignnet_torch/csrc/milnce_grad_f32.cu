// MIL-NCE feature gradients for Hopper (sm_90a), the f32 route (the --f32
// training path): milnce_dv and milnce_dt of csrc/milnce_wgmma.cu's bf16
// route, in float32, with the products in split TF32 on the tensor cores.
//
// Replaces temporalalignnet_tpu/ops/pallas_milnce.py::_milnce_bwd_kernel and
// the column-tiled ::_milnce_dv_kernel and ::_milnce_dt_kernel on f32
// features: for each layer s, video row r and text column k,
//   dv[r] = sum_k dsim[r, k] t[k],   dt[k] = sum_r dsim[r, k] v[r],
//   dsim = inv_temp * (gv[r] (p_neg - p_pos) + gt[k] (q_neg - q_pos)),
//   p_pos = pm ? exp(sim - vnum[r]) : 0,  p_neg = cv ? exp(sim - vden[r]) : 0,
//   q_pos = pm ? exp(sim - tnum[k]) : 0,  q_neg = cv ? exp(sim - tden[k]) : 0,
// sim = inv_temp v[r] . t[k], recomputed from the features and re-masked as
// _dsim_tile does (pallas_milnce.py:128-151); dv per layer, dt per layer or,
// for the dual branch's shared text (out_layers = 1), summed over them.  The
// TPU kernel's products are Precision.HIGHEST, f32's accuracy, met here by
// split TF32 (csrc/tf32x3.cuh: big·small + small·big + big·big of TF32 halves
// into f32 accumulators).  The tensor core truncates each sum it forms at the
// scale of its largest term, toward zero: over the thousands of k-steps of a
// gradient a running sum kept in its accumulator drifts toward zero, and
// the drift, the same sign on every element, moves the encoders' small
// gradients that sum many of them (chip_smoke.py's f32 cotrain check).  So
// every product goes into a short partial sum (sim: one 8-deep k-step; the
// product: one 32-entry tile), which is added to the running sum in f32,
// rounded to nearest.
//
// What bounds it on an H100: operations.  4 S R K C FLOPs (sim again, then
// the product) = 51.5 GFLOP at the B = 64 training shape, three TF32 passes
// each: 0.312 ms at 495 TFLOP/s, against ~80 MB of f32 inputs and outputs
// (24 us).  So the products are what the design serves:
// - A block owns 32 outer entries (video rows for dv, text columns for dt)
//   and streams the inner ones in tiles of 32 entries x all C channels,
//   double buffered by 16-byte cp.async (one block barrier a tile).  Its 8
//   warps split the work as warp (rh, q): outer rows 16 rh .. +15, channel
//   quarter q.  Shared memory holds the outer tile and two inner tiles as
//   f32 rows at a stride of 4 mod 32 banks (218 KB at C = 512): every
//   fragment load below is free of bank conflicts, as in tf32x3.cuh.
// - sim: each warp's partial over its quarter of the channels, for its 16
//   rows and all 32 inner entries (mma.sync m16n8k8, A = the outer rows and
//   B = the inner rows, both K-major).  The four warps of a row group then
//   reduce-scatter the partials through shared memory (a 128-thread named
//   barrier), summed in quarter order: warp (rh, q) holds the full sim of
//   its rows and inner entries 8 q .. +7.
// - dsim of those 4 entries a thread, in f32 (expf), then all-gathered
//   through shared memory, so that each warp holds dsim of its 16 rows and
//   all 32 inner entries as C fragments.
// - grad[16 rows][its quarter] += dsim . inner: the C fragments are the A
//   operand in the permuted k order of tf32x3.cuh (no shared-memory round
//   trip of dsim), B the inner tile read MN-major.  The [32, C] f32
//   accumulator lives in registers (C / 32 x 4 a thread at C = 512: 64), for
//   the whole inner stream; 8 warps a block, 255 registers allowed.
// - Inner splits (to fill the card when the outer axis x layers is short, as
//   for dt) write f32 partials that milnce_reduce_f32_kernel sums in split
//   order; one split writes the output straight away.  Every sum is taken
//   in a fixed order: two calls are bit-equal.
//
// Layout: v [S, R, C] f32; t [S, K, C] (t_layer_stride = K C) or [K, C]
// (stride 0); pm [R, K] and cv [K] bytes; vnum, vden, gv [S, R] and tnum,
// tden, gt [S, K] f32; dv [S, R, C], dt [out_layers, K, C] f32.  C a
// multiple of 64 up to 512 (padded with zeros to 128, 256 or 512 channels
// in shared memory).  Built by ops/_build.py into a library with a plain C
// interface.

#include "tf32x3.cuh"

namespace {

using tf32x3::mma_split;

constexpr int TO = 32;  // outer entries per block
constexpr int TI = 32;  // inner entries per tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

// NQ: 8-channel chunks of a warp's channel quarter (channels padded to 32 NQ)
template <int NQ>
struct Plan {
  static constexpr int CP = 32 * NQ;
  static constexpr int LD = CP + 4;  // row stride in floats, 4 mod 32 banks
  static constexpr int I_OFF = TO * LD;  // offsets in floats; the outer tile at 0
  // each warp's partial sim of the other chunks: [8 warps][4 chunks][4 regs][32 lanes]
  static constexpr int XCH_OFF = I_OFF + 2 * TI * LD;
  // each warp's dsim chunk: [8 warps][4 regs][32 lanes]
  static constexpr int DSX_OFF = XCH_OFF + WARPS * 4 * 4 * 32;
  static constexpr size_t BYTES = size_t(DSX_OFF + WARPS * 4 * 32) * 4;
};
static_assert(Plan<16>::BYTES <= 232448, "a block's shared memory on an H100");

// rows [n0, n0 + rows) of a row-major [n, C] f32 array into dst[rows][LD] by
// 16-byte cp.async; rows past n and channels past C are zero-filled
template <int NQ>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n0, int n, int rows,
                                           int C) {
  constexpr int VEC = Plan<NQ>::CP / 4;
  for (int e = threadIdx.x; e < rows * VEC; e += THREADS) {
    const int j = e / VEC, c = (e % VEC) * 4;
    const bool in = n0 + j < n && c < C;
    cp_async_16(dst + j * Plan<NQ>::LD + c, src + (in ? size_t(n0 + j) * C + c : 0), in);
  }
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(128) : "memory");
}

// grid (outer / 32, out_layers, splits); out: the output or the f32 partials
// [splits, out_layers, n_outer, C]
template <bool ROWS_OUTER, int NQ>
__global__ void __launch_bounds__(THREADS, 1)
milnce_grad_f32_kernel(const float* __restrict__ v, const float* __restrict__ t, long long t_ls,
                       const uint8_t* __restrict__ pm, const uint8_t* __restrict__ cv,
                       const float* __restrict__ vnum, const float* __restrict__ vden,
                       const float* __restrict__ tnum, const float* __restrict__ tden,
                       const float* __restrict__ gv, const float* __restrict__ gt,
                       float* __restrict__ out, int R, int K, int C, int layers,
                       int tiles_per_split, float inv_temp) {
  using P = Plan<NQ>;
  using tf32x3::split;
  extern __shared__ __align__(16) float sm[];
  float* xch = sm + P::XCH_OFF;
  float* dsx = sm + P::DSX_OFF;
  const int nO = ROWS_OUTER ? R : K, nI = ROWS_OUTER ? K : R;
  const int o0 = blockIdx.x * TO, y = blockIdx.y;
  const int s0 = y * layers, it0 = blockIdx.z * tiles_per_split;
  const int per = min(it0 + tiles_per_split, (nI + TI - 1) / TI) - it0;  // > 0: no empty split
  const int total = layers * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int rh = warp & 1, q = warp >> 1;  // rows 16 rh .., channel quarter and inner chunk q
  const int ch0 = 8 * NQ * q;

  // the outer operand is the same for the whole stream (dv: one layer a
  // block; dt: one layer, or the shared text); the inner one is per layer
  const float* O = ROWS_OUTER ? v + size_t(s0) * R * C : t + size_t(s0) * size_t(t_ls);
  auto inner = [&](int s) {
    return ROWS_OUTER ? t + size_t(s) * size_t(t_ls) : v + size_t(s) * R * C;
  };
  auto load = [&](int n) {  // tile n of the stream into stage n % 2
    stage_rows<NQ>(sm + P::I_OFF + (n & 1) * TI * P::LD, inner(s0 + n / per),
                   (it0 + n % per) * TI, nI, TI, C);
    cp_async_commit();
  };
  stage_rows<NQ>(sm, O, o0, nO, TO, C);
  load(0);

  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this thread's outer entries (rows 16 rh + g, + 8 of the tile) and inner
  // entries of its chunk (8 q + 2 tq, + 1)
  const int oe[2] = {o0 + 16 * rh + g, o0 + 16 * rh + g + 8};

  for (int n = 0; n < total; ++n) {
    cp_async_wait<0>();
    __syncthreads();  // tile n landed; every warp is done with tile n - 1's stage
    if (n + 1 < total) load(n + 1);
    const int s = s0 + n / per, i0 = (it0 + n % per) * TI;
    const float* is = sm + P::I_OFF + (n & 1) * TI * P::LD;

    // this tile's dsim inputs, loaded while the tensor cores run the sim:
    // (num, den, g) of layer s for the thread's two outer entries oe[h] and
    // two inner entries ie[j], and the positive and column-mask bits of the
    // four pairs (dsim is symmetric in its row and column terms)
    const int ie[2] = {i0 + 8 * q + 2 * tq, i0 + 8 * q + 2 * tq + 1};
    float on[2], od[2], og[2], in[2], id[2], ig[2];
    bool pos[2][2], keep[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = size_t(s) * nO + min(oe[h], nO - 1);
      const size_t i = size_t(s) * nI + min(ie[h], nI - 1);
      on[h] = (ROWS_OUTER ? vnum : tnum)[o];
      od[h] = (ROWS_OUTER ? vden : tden)[o];
      og[h] = (ROWS_OUTER ? gv : gt)[o];
      in[h] = (ROWS_OUTER ? tnum : vnum)[i];
      id[h] = (ROWS_OUTER ? tden : vden)[i];
      ig[h] = (ROWS_OUTER ? gt : gv)[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = min(oe[h], nO - 1), i = min(ie[j], nI - 1);
        const int r = ROWS_OUTER ? o : i, k = ROWS_OUTER ? i : o;
        pos[h][j] = pm[size_t(r) * K + k] != 0;
        keep[h][j] = cv[k] != 0;
      }

    // the partial sim of rows 16 rh .. x all 32 inner entries over this quarter
    float pc[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) pc[nb][0] = pc[nb][1] = pc[nb][2] = pc[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NQ; ++ks) {
      const float* ar = sm + (16 * rh + g) * P::LD + ch0 + 8 * ks + tq;
      uint32_t ab[4], as[4];
      split(ar[0], ab[0], as[0]);
      split(ar[8 * P::LD], ab[1], as[1]);
      split(ar[4], ab[2], as[2]);
      split(ar[8 * P::LD + 4], ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float* br = is + (8 * nb + g) * P::LD + ch0 + 8 * ks + tq;
        uint32_t bb[2], bs[2];
        split(br[0], bb[0], bs[0]);
        split(br[4], bb[1], bs[1]);
        float x[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's part, added in f32
        mma_split(x, ab, as, bb, bs);
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[nb][e] += x[e];
      }
    }
    // reduce-scatter over the row group's four warps (warp 2 q' + rh), in quarter order
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
      if (nb != q)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[((warp * 4 + nb) * 4 + e) * 32 + lane] = pc[nb][e];
    bar_sync(1 + rh);
    float sim[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sim[e] += qq == q ? pc[qq][e] : xch[(((2 * qq + rh) * 4 + q) * 4 + e) * 32 + lane];

    // dsim of register e: outer entry oe[e >> 1], inner entry ie[e & 1]
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = e & 1;
      const float x = sim[e] * inv_temp;
      float d = 0.f;
      if (pos[h][j]) d -= og[h] * expf(x - on[h]) + ig[j] * expf(x - in[j]);
      if (keep[h][j]) d += og[h] * expf(x - od[h]) + ig[j] * expf(x - id[j]);
      ds[e] = oe[h] < nO && ie[j] < nI ? d * inv_temp : 0.f;
    }
    // all-gather: dsim of all 32 inner entries, chunk c from warp 2 c + rh
#pragma unroll
    for (int e = 0; e < 4; ++e) dsx[(warp * 4 + e) * 32 + lane] = ds[e];
    bar_sync(1 + rh);
    float dfull[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dfull[c][e] = c == q ? ds[e] : dsx[((2 * c + rh) * 4 + e) * 32 + lane];

    // grad[rows][quarter] += dsim . inner: A = dsim in the permuted k order
    // (k t is inner 8 c + 2 t, k t + 4 is 8 c + 2 t + 1), B = the inner rows
    // MN-major; the tile's part summed apart and added in f32
    float part[NQ][4];
#pragma unroll
    for (int nn = 0; nn < NQ; ++nn) part[nn][0] = part[nn][1] = part[nn][2] = part[nn][3] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t ab[4], as[4];
      split(dfull[c][0], ab[0], as[0]);
      split(dfull[c][2], ab[1], as[1]);
      split(dfull[c][1], ab[2], as[2]);
      split(dfull[c][3], ab[3], as[3]);
      const float* yr = is + (8 * c + 2 * tq) * P::LD + ch0 + g;
#pragma unroll
      for (int nn = 0; nn < NQ; ++nn) {
        uint32_t bb[2], bs[2];
        split(yr[8 * nn], bb[0], bs[0]);
        split(yr[P::LD + 8 * nn], bb[1], bs[1]);
        mma_split(part[nn], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] += part[nn][e];
  }

  // register 2 h + j of acc[nn]: outer entry oe[h], channel ch0 + 8 nn + 2 tq + j
  float* dst = out + (size_t(blockIdx.z) * gridDim.y + y) * size_t(nO) * C;
#pragma unroll
  for (int nn = 0; nn < NQ; ++nn) {
    const int c = ch0 + 8 * nn + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (oe[h] < nO && c < C)
        *reinterpret_cast<float2*>(dst + size_t(oe[h]) * C + c) =
            make_float2(acc[nn][2 * h], acc[nn][2 * h + 1]);
  }
}

// out[i] = sum over splits of part[split, i], in split order
__global__ void milnce_reduce_f32_kernel(const float* __restrict__ part, float* __restrict__ out,
                                         size_t n, int splits) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = 0.f;
  for (int s = 0; s < splits; ++s) x += part[size_t(s) * n + i];
  out[i] = x;
}

template <bool ROWS_OUTER, int NQ>
cudaError_t launch_nq(dim3 grid, const float* v, const float* t, long long t_ls, const uint8_t* pm,
                      const uint8_t* cv, const float* vnum, const float* vden, const float* tnum,
                      const float* tden, const float* gv, const float* gt, float* out, int R,
                      int K, int C, int layers, int per_split, float inv_temp,
                      cudaStream_t stream) {
  const size_t bytes = Plan<NQ>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(milnce_grad_f32_kernel<ROWS_OUTER, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  milnce_grad_f32_kernel<ROWS_OUTER, NQ><<<grid, THREADS, bytes, stream>>>(
      v, t, t_ls, pm, cv, vnum, vden, tnum, tden, gv, gt, out, R, K, C, layers, per_split,
      inv_temp);
  return cudaGetLastError();
}

template <bool ROWS_OUTER>
int dispatch(const void* v, const void* t, long long t_ls, const void* pm, const void* cv,
             const void* vnum, const void* vden, const void* tnum, const void* tden,
             const void* gv, const void* gt, void* out, void* part, int S, int R, int K, int C,
             int out_layers, int splits, float inv_temp, void* stream) {
  if (S <= 0 || S > 65535 || R <= 0 || K <= 0 || C <= 0 || C % 64 != 0 || C > 512 ||
      splits <= 0 || splits > 65535 || (out_layers != S && out_layers != 1))
    return int(cudaErrorInvalidValue);
  const int nO = ROWS_OUTER ? R : K, nI = ROWS_OUTER ? K : R;
  const int itiles = (nI + TI - 1) / TI;
  const int per_split = (itiles + splits - 1) / splits;
  splits = (itiles + per_split - 1) / per_split;  // no empty split
  if (splits > 1 && part == nullptr) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((nO + TO - 1) / TO), unsigned(out_layers), unsigned(splits));
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const auto* vf = static_cast<const float*>(v);
  const auto* tf = static_cast<const float*>(t);
  const auto* pmb = static_cast<const uint8_t*>(pm);
  const auto* cvb = static_cast<const uint8_t*>(cv);
  const auto* vn = static_cast<const float*>(vnum);
  const auto* vd = static_cast<const float*>(vden);
  const auto* tn = static_cast<const float*>(tnum);
  const auto* td = static_cast<const float*>(tden);
  const auto* gvf = static_cast<const float*>(gv);
  const auto* gtf = static_cast<const float*>(gt);
  const int layers = S / out_layers;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 128)
    err = launch_nq<ROWS_OUTER, 4>(grid, vf, tf, t_ls, pmb, cvb, vn, vd, tn, td, gvf, gtf, dst, R,
                                   K, C, layers, per_split, inv_temp, st);
  else if (C <= 256)
    err = launch_nq<ROWS_OUTER, 8>(grid, vf, tf, t_ls, pmb, cvb, vn, vd, tn, td, gvf, gtf, dst, R,
                                   K, C, layers, per_split, inv_temp, st);
  else
    err = launch_nq<ROWS_OUTER, 16>(grid, vf, tf, t_ls, pmb, cvb, vn, vd, tn, td, gvf, gtf, dst,
                                    R, K, C, layers, per_split, inv_temp, st);
  if (err != cudaSuccess || splits == 1) return int(err);
  const size_t n = size_t(out_layers) * nO * C;
  milnce_reduce_f32_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, splits);
  return int(cudaGetLastError());
}

}  // namespace

// Inputs as milnce_fwd (v [S, R, C]; t at t_layer_stride per layer; pm [R, K],
// cv [K] bytes), the saved vnum, vden [S, R] and tnum, tden [S, K], and the
// cotangents gv [S, R], gt [S, K], all f32.  part: splits * out_layers *
// n_out * C f32 of scratch (may be null with one split).  C <= 512.
// Returns a cudaError_t (0 = launched).
//
// milnce_dv_f32: dv [S, R, C] (out_layers = S).
extern "C" int milnce_dv_f32(const void* v, const void* t, long long t_layer_stride,
                             const void* pm, const void* cv, const void* vnum, const void* vden,
                             const void* tnum, const void* tden, const void* gv, const void* gt,
                             void* dv, void* part, int S, int R, int K, int C, int out_layers,
                             int splits, float inv_temp, void* stream) {
  if (out_layers != S) return int(cudaErrorInvalidValue);
  return dispatch<true>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dv, part,
                        S, R, K, C, S, splits, inv_temp, stream);
}

// milnce_dt_f32: dt [out_layers, K, C]; out_layers = 1 sums over the layers
// (the shared text of the dual branch), out_layers = S keeps one per layer.
extern "C" int milnce_dt_f32(const void* v, const void* t, long long t_layer_stride,
                             const void* pm, const void* cv, const void* vnum, const void* vden,
                             const void* tnum, const void* tden, const void* gv, const void* gt,
                             void* dt, void* part, int S, int R, int K, int C, int out_layers,
                             int splits, float inv_temp, void* stream) {
  return dispatch<false>(v, t, t_layer_stride, pm, cv, vnum, vden, tnum, tden, gv, gt, dt, part,
                         S, R, K, C, out_layers, splits, inv_temp, stream);
}
