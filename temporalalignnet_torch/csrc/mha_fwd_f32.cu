// Fused multi-head attention forward for Hopper (sm_90a), the f32 route
// (mha_fwd_f32): out = softmax(Q K^T / sqrt(D) + bias) V, bias = -1e30 on
// padded keys, in float32.  The bf16 routes are csrc/mha_fwd.cu.
//
// Replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_kernel on f32
// inputs: the eval's --f32, the offline punctuator, f32 training.  The TPU
// kernel asks there for Precision.HIGHEST, which is a level of accuracy,
// f32's (the TPU meets it with several passes of its bf16 matrix unit), not a
// kind of instruction.  Here it is met with split TF32 on the tensor cores
// (csrc/tf32x3.cuh): every product big·small + small·big + big·big of TF32
// halves into f32 accumulators, f32-accurate at up to 495 / 3 TFLOP/s
// instead of the 67 TFLOP/s of f32 FMAs on the CUDA cores.  Same semantics
// as the bf16 routes: scores and softmax in f32, a finite -1e30 bias so a
// fully padded row averages the real keys, keys past S out of the softmax.
//
// What bounds it on an H100: at the TAN shapes bytes (q, k, v, out in f32:
// 34 MB at [64, 8, 64, 64], 10 us at 3.35 TB/s, against 3.3 us of split-TF32
// work); at the punctuator's [4, 12, 258, 64] and the global method's long
// rows operations and latency.  So the design follows the bf16 routes' block
// plan: up to S = 128 one block per (batch row, head) holding the whole head
// (K and V read once, 2-4 blocks per SM so that one block's loads overlap
// another's products), past it 64-query blocks streaming key tiles, with key
// splits where a short grid would walk long key ranges (below).  The softmax
// stays in registers with exp2 and log2(e) folded into the scale, and P
// feeds P V from the score registers (no shared-memory pass).  wgmma takes
// .tf32 operands only K-major, which P V's V ([keys][D], D contiguous) is
// not, and has no transpose for 32-bit types; so both products run on
// mma.sync m16n8k8 fed from shared memory without bank conflicts
// (tf32x3.cuh), whole tiles in branch-free unrolled code (a branch around an
// mma.sync ends the compiler's interleaving of the chunks there).
//
// Layout: q, k, v, out are [B, H, S, D] contiguous; pad is [B, S] bytes
// (nonzero = padded key) or null.  Built by temporalalignnet_torch/ops/_build.py
// into a shared library with a plain C interface, called through ctypes.

#include "mha_merge.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float MASK_BIAS = -1.0e30f;

// ------------------------------------------ f32: split TF32 on the tensor cores
//
// A warp owns 16 query rows.  Up to S = 128 (mha_fwd_f32_head_kernel) a block
// holds a head's queries, keys and values at once (K staged with Q, V behind
// them, so the scores start while V loads): the exact softmax of whole rows
// in registers, one pass, no rescaling.  Past it (mha_fwd_f32_kernel) a block
// holds LONG_QUERIES queries and streams 64-key tiles of K and V by cp.async
// through two stages (the next tile loads while this one computes) with an
// online softmax.  Both take scores as tf32x3::rows_dot (8-key chunks up to
// the last key < S), run the softmax in the log2 domain (x = s log2(e) /
// sqrt(D) + bias, p = exp2(x - max)) and accumulate O += P V with P taken
// straight from the score registers (tf32x3::acc_mul).  With a key split each
// block writes its rows' unnormalised O and (max, sum) and
// mha_fwd_merge_kernel<float> combines them in split order.

namespace f32 {

using tf32x3::LD;
constexpr int KT = 64;            // keys per streamed tile
constexpr int LONG_QUERIES = 64;  // queries per block past S = 128
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const float *q, *k, *v;
  const uint8_t* pad;
  float* out;
  float* part_o;    // [splits][B H][Sq][64] f32, unnormalised O (key splits only)
  float2* part_ml;  // [splits][B H][Sq] (max, sum), log2 domain
  int H, S, Sq, tiles_per_split;
  float scale2;  // log2(e) / sqrt(D)
};

// a key's bias, log2 domain: keys past S leave the softmax (-inf); padded
// keys keep the finite reference bias, so a fully padded row averages the
// real keys
__device__ __forceinline__ float key_bias(const uint8_t* pad, int key, int S) {
  return key >= S ? -INFINITY : ((pad != nullptr && pad[key]) ? MASK_BIAS * LOG2E : 0.f);
}

// x = s log2(e) / sqrt(D) + bias of the C fragments sc (16 rows x 8 N keys,
// bias of key 8 j + 2 t + (e & 1) at bias), and their row max (rows g, g + 8)
// over the quad, folded into mx
template <int N>
__device__ __forceinline__ void log2_scores(float (&sc)[N][4], float (&mx)[2], const float* bias,
                                            float scale2, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(sc[j][e], scale2, (e & 1) ? bb.y : bb.x);
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  mx[0] = tf32x3::quad_max(mx[0]);
  mx[1] = tf32x3::quad_max(mx[1]);
}

// p = exp2(x - max) in place, summed into this lane's share l of the row sums
template <int N>
__device__ __forceinline__ void exp2_rows(float (&sc)[N][4], const float (&mx)[2], float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[j][e] - mx[e >> 1]);
      sc[j][e] = p;
      l[e >> 1] += p;
    }
}

template <int NC>
constexpr size_t head_smem() {  // q, k, v [16 NC][LD]; key bias [16 NC]
  return sizeof(float) * (3 * size_t(16 * NC) * LD + 16 * NC);
}

// S <= 128: one block per (batch row, head) of NC warps, 16 rows each; NC
// is ceil(S / 16) rounded up to 2, 4, 5, 6 or 8 (the lengths the port runs:
// BERT's 32, the TAN's 64, 72 and 80, the retrieval's 96 and 128; fewer
// instantiations build faster), the rows past S zero
template <int NC>
__global__ void __launch_bounds__(32 * NC, NC <= 4 ? 4 : (NC <= 6 ? 3 : 2))
mha_fwd_f32_head_kernel(const Args a) {
  constexpr int R = 16 * NC;  // staged rows
  constexpr int NK = 2 * NC;  // 8-key chunks of a score row
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + R * LD;
  float* vs = ks + R * LD;
  float* bias = vs + R * LD;  // [R], log2 domain
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = size_t(blockIdx.x) * a.S * tf32x3::D;
  const uint8_t* pad = a.pad != nullptr ? a.pad + size_t(blockIdx.x / a.H) * a.S : nullptr;
  tf32x3::load_rows(qs, a.q + base, 0, R, a.S);
  tf32x3::load_rows(ks, a.k + base, 0, R, a.S);
  cp_async_commit();
  tf32x3::load_rows(vs, a.v + base, 0, R, a.S);
  cp_async_commit();
  for (int j = threadIdx.x; j < R; j += blockDim.x) bias[j] = key_bias(pad, j, a.S);
  cp_async_wait<1>();  // q and k are in
  __syncthreads();

  float sc[NK][4];
  tf32x3::rows_dot<NK, true>(sc, qs + 16 * warp * LD, ks, NK, lane);
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  log2_scores(sc, mx, bias, a.scale2, lane);  // finite: key 0 is real
  exp2_rows(sc, mx, l);
  cp_async_wait<0>();  // v is in
  __syncthreads();
  float o[tf32x3::D / 8][4];
#pragma unroll
  for (int c = 0; c < tf32x3::D / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  tf32x3::acc_mul<NK, true>(o, sc, vs, NK, lane);
  const float inv0 = 1.f / tf32x3::quad_sum(l[0]), inv1 = 1.f / tf32x3::quad_sum(l[1]);
  tf32x3::store_rows(a.out + base, o, 16 * warp, a.S, inv0, inv1, lane);
}

// rows of key tile i in shared memory: 8-row chunks up to the last key < S
__device__ __forceinline__ int tile_rows(int S, int i) { return min(KT, (S - KT * i + 7) / 8 * 8); }

// q [LONG_QUERIES][LD]; two stages of K and V [KT][LD]; their key bias [2][KT]
constexpr size_t LONG_SMEM = sizeof(float) * ((LONG_QUERIES + 4 * KT) * size_t(LD) + 2 * KT);

// one key tile of a warp's 16 query rows: scores, the online softmax, O +=
// P V; nch 8-key chunks hold a key < S (FULL: all of them, no branch)
template <bool FULL>
__device__ __forceinline__ void key_tile(float (&o)[tf32x3::D / 8][4], float (&m)[2], float (&l)[2],
                                         const float* qw, const float* ks, const float* vs,
                                         const float* bt, int nch, float scale2, int lane) {
  float sc[KT / 8][4];
  tf32x3::rows_dot<KT / 8, FULL>(sc, qw, ks, nch, lane);
  // chunks past the last key stay 0 and get their keys' -inf bias; mx is
  // finite (every tile holds a key < S); on the first tile m = -inf and the
  // correction is 0
  float mx[2] = {m[0], m[1]};
  log2_scores(sc, mx, bt, scale2, lane);
  const float corr[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] *= corr[h];
    m[h] = mx[h];
  }
  exp2_rows(sc, mx, l);
#pragma unroll
  for (int c = 0; c < tf32x3::D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] *= corr[e >> 1];
  tf32x3::acc_mul<KT / 8, FULL>(o, sc, vs, nch, lane);
}

// S > 128: grid (B H, query blocks of LONG_QUERIES, key splits), 4 warps
__global__ void __launch_bounds__(2 * LONG_QUERIES, 2) mha_fwd_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * LONG_QUERIES;
  const int ktiles = (a.S + KT - 1) / KT;
  const int t0 = blockIdx.z * a.tiles_per_split;
  const int nt = min(t0 + a.tiles_per_split, ktiles) - t0;  // > 0: the launcher makes no empty split
  float* qs = sm;                                // [LONG_QUERIES][LD]
  float* kv = qs + LONG_QUERIES * LD;            // stage st: K at kv + 2 st KT LD, then V
  float* bias = kv + 4 * KT * LD;                // [2][KT], log2 domain
  const size_t base = size_t(bh) * a.S * tf32x3::D;
  const uint8_t* pad = a.pad != nullptr ? a.pad + size_t(bh / a.H) * a.S : nullptr;

  auto load_tile = [&](int n) {  // key tile t0 + n into stage n % 2
    const int st = n & 1, k0 = (t0 + n) * KT, rows = tile_rows(a.S, t0 + n);
    tf32x3::load_rows(kv + 2 * st * KT * LD, a.k + base, k0, rows, a.S);
    tf32x3::load_rows(kv + (2 * st + 1) * KT * LD, a.v + base, k0, rows, a.S);
    for (int j = threadIdx.x; j < KT; j += blockDim.x) bias[st * KT + j] = key_bias(pad, k0 + j, a.S);
  };
  tf32x3::load_rows(qs, a.q + base, q0, LONG_QUERIES, a.S);
  load_tile(0);
  cp_async_commit();
  if (nt > 1) load_tile(1);
  cp_async_commit();

  const float* qw = qs + warp * 16 * LD;
  const bool active = q0 + warp * 16 < a.S;
  float o[tf32x3::D / 8][4];
#pragma unroll
  for (int n = 0; n < tf32x3::D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows g, g + 8), log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the running row sum

  for (int n = 0; n < nt; ++n) {
    cp_async_wait<1>();  // every group but the newest: tile n is in
    __syncthreads();
    const int st = n & 1;
    if (active) {
      const int nch = tile_rows(a.S, t0 + n) / 8;
      const float* ks = kv + 2 * st * KT * LD;
      if (nch == KT / 8)
        key_tile<true>(o, m, l, qw, ks, ks + KT * LD, bias + st * KT, nch, a.scale2, lane);
      else  // a ragged last tile
        key_tile<false>(o, m, l, qw, ks, ks + KT * LD, bias + st * KT, nch, a.scale2, lane);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    if (n + 2 < nt) load_tile(n + 2);
    cp_async_commit();
  }
  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = tf32x3::quad_sum(l[h]);
  const int r0 = q0 + warp * 16;
  if (gridDim.z == 1) {
    tf32x3::store_rows(a.out + base, o, r0, a.S, 1.f / l[0], 1.f / l[1], lane);
    return;
  }
  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // this split's partials of the rows < S
    const int r = r0 + g + 8 * h;
    if (r < a.S) {
      const size_t row = (size_t(blockIdx.z) * gridDim.x + bh) * a.Sq + r;
#pragma unroll
      for (int c = 0; c < tf32x3::D / 8; ++c)
        *reinterpret_cast<float2*>(a.part_o + row * 64 + 8 * c + 2 * t) =
            make_float2(o[c][2 * h], o[c][2 * h + 1]);
      if (t == 0) a.part_ml[row] = make_float2(m[h], l[h]);
    }
  }
}

template <int NC>
cudaError_t launch_head(const Args& a, int BH, cudaStream_t stream) {
  constexpr size_t smem = head_smem<NC>();
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_f32_head_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  mha_fwd_f32_head_kernel<NC><<<BH, 32 * NC, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// The f32 route: split TF32 on the tensor cores, any S; up to S = 128 one
// block per (batch row, head) and splits must be 1, past it LONG_QUERIES
// queries a block and the key range in `splits` parts (fewer if a part would
// be empty).  part: with more than one split, splits * B H * Sq * 66 f32 of
// scratch (Sq = S rounded up to LONG_QUERIES), else unused.  Pointers 16-byte
// aligned (cp.async).  Returns a cudaError_t (0 = launched).
extern "C" int mha_fwd_f32(const void* q, const void* k, const void* v, const void* pad, void* out,
                           void* part, int B, int H, int S, int head_dim, int splits,
                           void* stream) {
  const void* aligned[5] = {q, k, v, out, part};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != tf32x3::D || splits <= 0 || splits > 65535)
    return int(cudaErrorInvalidValue);
  const bool long_route = S > 2 * f32::KT;
  const int qblocks = (S + f32::LONG_QUERIES - 1) / f32::LONG_QUERIES;
  const int BH = B * H, ktiles = (S + f32::KT - 1) / f32::KT;
  const int per = (ktiles + splits - 1) / splits;
  splits = (ktiles + per - 1) / per;  // no empty split
  if ((!long_route && splits != 1) || (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);

  f32::Args a;
  a.q = static_cast<const float*>(q), a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v), a.pad = static_cast<const uint8_t*>(pad);
  a.out = static_cast<float*>(out);
  a.H = H, a.S = S, a.Sq = qblocks * f32::LONG_QUERIES, a.tiles_per_split = per;
  a.part_o = static_cast<float*>(part);
  a.part_ml = splits > 1 ? reinterpret_cast<float2*>(a.part_o + size_t(splits) * BH * a.Sq * 64)
                         : nullptr;
  a.scale2 = f32::LOG2E / sqrtf(float(head_dim));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!long_route) {  // warps: 16 rows each, rounded up to an instantiated count
    switch ((S + 15) / 16) {
      case 1: case 2: return int(f32::launch_head<2>(a, BH, st));
      case 3: case 4: return int(f32::launch_head<4>(a, BH, st));
      case 5: return int(f32::launch_head<5>(a, BH, st));
      case 6: return int(f32::launch_head<6>(a, BH, st));
      default: return int(f32::launch_head<8>(a, BH, st));
    }
  }
  if (qblocks > 65535) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(f32::mha_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(f32::LONG_SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid{unsigned(BH), unsigned(qblocks), unsigned(splits)};
  f32::mha_fwd_f32_kernel<<<grid, 2 * f32::LONG_QUERIES, f32::LONG_SMEM, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  return int(mha_merge::launch_merge<float>(a.part_o, a.part_ml, out, BH, S, a.Sq, splits, st));
}
