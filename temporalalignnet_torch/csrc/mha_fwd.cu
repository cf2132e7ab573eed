// Fused multi-head attention forward for Hopper (sm_90a):
//   out = softmax(Q K^T / sqrt(D) + bias) V,  bias = -1e30 on padded keys.
//
// Replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_kernel (the
// Pallas TPU kernel reached through fused_attention).  Same semantics: scores
// and softmax in f32, P rounded to the value dtype before P.V, output in the
// input dtype, and a finite -1e30 bias so a fully padded row averages V
// uniformly over the real keys instead of producing NaN.  In f32 the TPU
// kernel asks for Precision.HIGHEST: a level of accuracy (f32's), which the
// f32 route meets with split TF32 on the tensor cores (tf32x3.cuh).
//
// What bounds it on an H100: at the TAN shapes (S = 64 dual, 64 + Nb joint,
// D = 64) the whole problem is bound by memory: q, k, v and out are read or
// written once, ~50 MB for [192, 8, 64, 64] bf16 = ~15 us at 3.35 TB/s,
// against ~1.6 us of bf16 tensor-core time.  Neither path writes the [S, S]
// scores or probabilities to device memory: a thread block owns one (batch
// row, head) and a tile of queries, and streams K and V through shared memory
// in tiles of 64 keys with an online softmax (running max, running sum and
// the output accumulator in f32 registers).  Any S works: the number of key
// tiles is a loop inside the block, and keys past S get a -inf score so they
// drop out of the softmax.
//
// - bf16, the wgmma routes (mha_fwd_wgmma, below): warp specialised, TMA and
//   wgmma.  "short" (S <= 128: every encoder block of the train step and of
//   the overlap-seq eval) has one block per (batch row, head) holding all its
//   queries, so K and V are read once; "long" (S > 128: the global eval) a
//   block per (batch row, head, 128 queries), and where that grid is short of
//   the card the key range is split across blocks and a small kernel merges
//   the splits' (max, sum, O) in split order.
// - bf16, v1 (mha_fwd_v1; no route takes it, kept to be timed beside the
//   wgmma routes): one warp per 16 query rows, mma.sync m16n8k16 with
//   ldmatrix, cp.async double buffering.  Past S = 128 it runs 4 warps and 64
//   queries a block, about one block per SM at [1, 8, 1088, 64], each walking
//   17 key tiles in series: latency-bound, 2x slower than SDPA there.
// - f32 (the eval's --f32, the punctuator, f32 training): split TF32 on the
//   tensor cores, in csrc/mha_fwd_f32.cu.
//
// Layout: q, k, v, out are [B, H, S, D] contiguous; pad is [B, S] bytes
// (nonzero = padded key) or null.  Built by temporalalignnet_torch/ops/_build.py
// into a shared library with a plain C interface, called through ctypes.

#include "hopper.cuh"
#include "mha_merge.cuh"
#include "mma.cuh"

namespace {

constexpr float MASK_BIAS = -1.0e30f;

// ------------------------------------------------------- bf16: tensor cores

constexpr int TC_MAX_WARPS = 8;  // 16 query rows per warp
constexpr int TC_BK = 64;        // keys per streamed tile

// Fragment layouts of mma.m16n8k16 (lane = 4 g + t): A rows g and g + 8,
// columns 2t, 2t + 1 (+8); B column g, rows 2t, 2t + 1 (+8); C rows g and
// g + 8, columns 2t, 2t + 1.  A block has blockDim.x / 32 warps (set by the
// launcher from S), each owning 16 query rows.  K and V tiles are double
// buffered in shared memory: cp.async fills tile i + 1 while tile i computes.
template <int D>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
mha_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ pad,
                    __nv_bfloat16* __restrict__ out, int H, int S, float scale) {
  static_assert(D % 32 == 0, "D is an even number of mma k-steps");
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T
  constexpr int DCH = D / 8;      // 8-wide output column chunks
  constexpr int NCH = TC_BK / 8;  // 8-key score chunks per tile
  constexpr int LD = D + 8;       // padded rows: ldmatrix rows hit distinct banks
  __shared__ __align__(16) __nv_bfloat16 ks[2][TC_BK * LD];  // K tiles, [key][d]
  __shared__ __align__(16) __nv_bfloat16 vs[2][TC_BK * LD];  // V tiles, [key][d]
  __shared__ float bias[2][TC_BK];

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * (nthreads / 2) + warp * 16;  // 16 rows per warp
  const bool active = q0 < S;
  const size_t base = size_t(bh) * S * D;
  const int r0 = q0 + g, r1 = q0 + g + 8;

  auto load_tile = [&](int stage, int k0) {
    // whole 16-key chunks up to the last real key; later rows are never read
    const int rows = min(TC_BK, (S - k0 + 15) / 16 * 16);
    for (int e = tid; e < rows * (D / 8); e += nthreads) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool in = k0 + j < S;
      const size_t off = base + size_t(in ? k0 + j : 0) * D + c;
      cp_async_16(&ks[stage][j * LD + c], k + off, in);
      cp_async_16(&vs[stage][j * LD + c], v + off, in);
    }
    for (int j = tid; j < TC_BK; j += nthreads) {
      const int key = k0 + j;
      // keys past S leave the softmax (-inf); padded keys keep the finite
      // reference bias, so a fully padded row averages the real keys
      bias[stage][j] = key >= S ? -INFINITY
                                : ((pad != nullptr && pad[size_t(b) * S + key]) ? MASK_BIAS
                                                                                 : 0.f);
    }
    cp_async_commit();
  };

  const int ntiles = (S + TC_BK - 1) / TC_BK;
  load_tile(0, 0);

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int c = s * 16 + 2 * t;
    qf[s][0] = r0 < S ? ld_pair(q + base + size_t(r0) * D + c) : 0u;
    qf[s][1] = r1 < S ? ld_pair(q + base + size_t(r1) * D + c) : 0u;
    qf[s][2] = r0 < S ? ld_pair(q + base + size_t(r0) * D + c + 8) : 0u;
    qf[s][3] = r1 < S ? ld_pair(q + base + size_t(r1) * D + c + 8) : 0u;
  }

  float o[DCH][4];
#pragma unroll
  for (int c = 0; c < DCH; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1, k0 = it * TC_BK;
    if (it + 1 < ntiles) {
      load_tile(stage ^ 1, k0 + TC_BK);  // that stage was released at the end of it - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every thread

    if (active) {
      const __nv_bfloat16* kt = ks[stage];
      const __nv_bfloat16* vt = vs[stage];
      const float* bt = bias[stage];
      // 16-key chunks holding at least one real key; the rest is skipped
      const int chunks = (min(TC_BK, S - k0) + 15) / 16;
      float sc[NCH][4];
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        if (n / 2 < chunks) {
#pragma unroll
          for (int s = 0; s < KSTEPS; s += 2) {
            // B of steps s and s + 1: keys n*8 .. +7, d in four 8-wide blocks
            uint32_t r[4];
            ldsm_x4(r, &kt[(n * 8 + (lane & 7)) * LD + (s + (lane >> 4)) * 16 +
                           ((lane >> 3) & 1) * 8]);
            mma_16816(sc[n], qf[s], r[0], r[1]);
            mma_16816(sc[n], qf[s + 1], r[2], r[3]);
          }
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        if (n / 2 < chunks) {
          const float b0 = bt[n * 8 + 2 * t], b1 = bt[n * 8 + 2 * t + 1];
          sc[n][0] = sc[n][0] * scale + b0;
          sc[n][1] = sc[n][1] * scale + b1;
          sc[n][2] = sc[n][2] * scale + b0;
          sc[n][3] = sc[n][3] * scale + b1;
          mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 lanes of a quad share rows g and g + 8
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile holds a real key
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        if (n / 2 < chunks) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[n][i] = expf(sc[n][i] - m[i / 2]);
            sum[i / 2] += sc[n][i];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        o[c][0] *= corr[0];
        o[c][1] *= corr[0];
        o[c][2] *= corr[1];
        o[c][3] *= corr[1];
      }
#pragma unroll
      for (int kc = 0; kc < NCH / 2; ++kc) {
        if (kc < chunks) {
          // the C fragments of score chunks 2kc, 2kc + 1 are the A fragment
          // of P, rounded to bf16 as the reference casts P
          const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                                  pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                                  pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                                  pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
          for (int c = 0; c < DCH; c += 2) {
            // B of column chunks c and c + 1: keys kc*16 .. +15, transposed
            uint32_t r[4];
            ldsm_x4_trans(r, &vt[(kc * 16 + (lane & 15)) * LD + (c + (lane >> 4)) * 8]);
            mma_16816(o[c], pa, r[0], r[1]);
            mma_16816(o[c + 1], pa, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with `stage` before it is refilled
  }

  if (!active) return;
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int c = 0; c < DCH; ++c) {
    const int col = c * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + base + size_t(r0) * D + col) =
          pack_bf16(o[c][0] * inv0, o[c][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + base + size_t(r1) * D + col) =
          pack_bf16(o[c][2] * inv1, o[c][3] * inv1);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* pad,
                        void* out, int B, int H, int S, cudaStream_t stream) {
  // up to 128 queries: one block per (row, head), one warp per 16 queries,
  // so K and V are read once; longer S: 64-query blocks, for more blocks
  const int warps = S <= 16 * TC_MAX_WARPS ? (S + 15) / 16 : 4;
  const int bq = 16 * warps;
  const dim3 grid(unsigned(B) * unsigned(H), unsigned((S + bq - 1) / bq));
  mha_fwd_bf16_kernel<D><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(pad),
      static_cast<__nv_bfloat16*>(out), H, S, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// -------------------------------------- bf16: wgmma + TMA, warp specialised
//
// A block has NWG consumer warpgroups, each owning 64 query rows (its Q tile
// loaded once by TMA), and one producer warp that keeps a ring of STAGES
// 64-key K and V tiles in flight by TMA (3-D tensor maps over [B H, S, D],
// 128-byte swizzle: rows past S are zero-filled, never the next head's),
// guarded by full/empty mbarriers, with the tile's key bias staged beside it
// by the producer's lanes (log2 domain: 0 real, -1e30 log2(e) padded, -inf
// past S).  Per key tile each consumer
// - computes S = Q K^T by wgmma (A and B K-major; m64n64, or m64n16 per
//   16-key chunk up to the last real key on a ragged last tile);
// - runs the online softmax in registers: x = s log2(e)/sqrt(D) + bias, the
//   row max across the quad by shfl, p = ex2(x - max) (branch-free: masked
//   keys carry -inf), the running sum kept per thread and summed across the
//   quad once at the end;
// - rounds P to bf16 in registers and accumulates O += P V by wgmma with A
//   from registers (the m64nN accumulator layout is the A-fragment layout, so
//   P never goes to shared memory) and V the MN-major B operand.
// O stays in f32 registers; at the end it is scaled by 1/sum, staged as bf16
// over the warpgroup's Q tile and stored by TMA (rows past S are clipped).
// With a key split (gridDim.z > 1) each block writes its rows' unnormalised
// O and (max, sum) as f32 partials instead, and mha_fwd_merge_kernel combines
// them in split order.
//
// Fully padded rows: every score is -1e30 log2(e) exactly (the product is
// absorbed), so max and score agree, p = 1 for each padded key and the row
// averages V as the reference's does; the max and the sum are kept apart, never
// folded into one log-sum (-1e30 + log S rounds to -1e30).  A split whose
// keys are all padded has a finite max too, and drops out of the merge by its
// max whenever another split holds a real key.
//
// What bounds it on an H100: bytes at the training and overlap-seq shapes
// (q, k, v, out once: 4 B H S D x 2 bytes, e.g. 21 MB at [64, 8, 80, 64] =
// 6.3 us at 3.35 TB/s); operations and latency at the global method's long
// rows (4 B H S^2 D = 2.4 GFLOP at [1, 8, 1088, 64] = 2.5 us at 989 TFLOP/s,
// over only 8 heads).  The short route keeps 2-4 blocks per SM in flight to
// cover the load -> products -> store chain; the long route splits the key
// range so that 2 blocks of two warpgroups run on each SM.

namespace fwd {

using namespace hopper;

constexpr int TILE_BYTES = 64 * 128;  // [64 rows][64 d] bf16
constexpr float LOG2E = 1.4426950408889634f;

template <int NWG, int STAGES>
struct Plan {
  static constexpr int THREADS = 128 * NWG + 32;  // consumer warpgroups, then the producer warp
  static constexpr int Q_OFF = 0;                 // NWG Q tiles; at the end, the output staging
  static constexpr int K_OFF = Q_OFF + NWG * TILE_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BIAS_OFF = V_OFF + STAGES * TILE_BYTES;  // [STAGES][64] f32
  static constexpr int BAR_OFF = BIAS_OFF + STAGES * 64 * 4;   // full, empty, q
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + room to align to 1024
};

// blocks per SM the registers must allow: 4 of one warpgroup, 2 of two
template <int NWG>
constexpr int min_blocks() {
  return NWG == 1 ? 4 : 2;
}

struct Args {
  const uint8_t* pad;
  float* part_o;    // [splits][B H][Sq][64] f32, unnormalised O (key splits only)
  float2* part_ml;  // [splits][B H][Sq] (max, sum), log2 domain
  int H, S, Sq, tiles_per_split;
  float scale2;  // log2(e) / sqrt(D)
};

template <int NWG, int STAGES>
__device__ __forceinline__ void consume(uint8_t* sm, const CUtensorMap* to, const Args& a, int t0,
                                        int nt) {
  using P = Plan<NWG, STAGES>;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * 64 * NWG + 64 * wg;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const uint32_t base = smem_addr(sm);
  const uint32_t qa = base + P::Q_OFF + wg * TILE_BYTES;

  // register 4 j + e of o (and 8 j + e of sc): row g + 8 ((e >> 1) & 1) of
  // this warp's 16; o column 8 j + 2 t + (e & 1), sc key 16 j + 8 (e >> 2) +
  // 2 t + (e & 1)
  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  fence_regs(o);
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the running row sum

  mbar_wait(qbar, 0);
  for (int n = 0; n < nt; ++n) {
    const int st = n % STAGES;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const int k0 = (t0 + n) * 64;
    const int chunks = min(4, (a.S - k0 + 15) / 16);  // 16-key chunks holding a key < S
    const uint32_t ka = base + P::K_OFF + st * TILE_BYTES;
    const uint32_t va = base + P::V_OFF + st * TILE_BYTES;
    mbar_wait(&full[st], ph);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    if (chunks == 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // D = 64: four 16-deep steps
        wgmma_ss_n64<0, 0>(sc, sw128_desc(qa + kk * 32, 0), sw128_desc(ka + kk * 32, 0));
    } else {  // a ragged last tile: its chunks up to the last key < S
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(qa + kk * 32, 0);
        wgmma_ss_n16_of64<0, 0, 0>(sc, da, sw128_desc(ka + kk * 32, 0));
        if (chunks > 1) wgmma_ss_n16_of64<0, 0, 1>(sc, da, sw128_desc(ka + 2048 + kk * 32, 0));
        if (chunks > 2) wgmma_ss_n16_of64<0, 0, 2>(sc, da, sw128_desc(ka + 4096 + kk * 32, 0));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scores in the log2 domain; the skipped chunks (zeros) get their keys'
    // -inf bias like every key past S
    const float* bias = reinterpret_cast<const float*>(sm + P::BIAS_OFF) + st * 64;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 b0 = *reinterpret_cast<const float2*>(&bias[16 * j + 2 * t]);
      const float2 b1 = *reinterpret_cast<const float2*>(&bias[16 * j + 8 + 2 * t]);
      const float bb[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = fmaf(sc[8 * j + e], a.scale2, bb[2 * (e >> 2) + (e & 1)]);
        sc[8 * j + e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the 4 lanes of a quad share rows g and g + 8
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    // mx is finite (every tile holds a key < S); on the first tile m = -inf
    // and the correction is 0
    const float corr[2] = {ex2(m[0] - mx[0]), ex2(m[1] - mx[1])};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = ex2(sc[e] - mx[(e >> 1) & 1]);
      sc[e] = p;
      sum[(e >> 1) & 1] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * corr[h] + sum[h];
      m[h] = mx[h];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] *= corr[(e >> 1) & 1];

    // P rounded to bf16 in registers: chunk kk's registers are the A
    // fragment of the 16-key step kk of P V
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < chunks) wgmma_rs_n64<1>(o, pa[kk], sw128_desc(va + kk * 2048, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (gridDim.z == 1) {
    // O / sum as bf16, staged over this warpgroup's Q tile (every warp's
    // reads of it are done at the first barrier), stored by TMA
    uint8_t* stage = sm + P::Q_OFF + wg * TILE_BYTES;
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    if (wg == 0) named_barrier<1, 128>(); else named_barrier<2, 128>();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stage + sw128_offset(16 * warp + g + 8 * h, 8 * j + 2 * t)) =
            pack_bf16x2(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
    fence_async_smem();
    if (wg == 0) named_barrier<1, 128>(); else named_barrier<2, 128>();
    if (threadIdx.x % 128 == 0) {
      tma_store_3d(to, stage, 0, q0, bh);
      tma_store_commit_and_wait();
    }
  } else {  // this split's partials of the rows < S
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + 16 * warp + g + 8 * h;
      if (r < a.S) {
        const size_t row = (size_t(blockIdx.z) * gridDim.x + bh) * a.Sq + r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(a.part_o + row * 64 + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
        if (t == 0) a.part_ml[row] = make_float2(m[h], l[h]);
      }
    }
  }
}

// the producer warp: the block's Q tiles once, then per key tile K and V by
// TMA and the tile's key bias by the lanes
template <int NWG, int STAGES>
__device__ __forceinline__ void produce(uint8_t* sm, const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const Args& a, int t0, int nt) {
  using P = Plan<NWG, STAGES>;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const uint8_t* pad = a.pad != nullptr ? a.pad + size_t(bh / a.H) * a.S : nullptr;
  if (lane == 0) {
    mbar_arrive_expect_tx(qbar, NWG * TILE_BYTES);
    for (int w = 0; w < NWG; ++w)
      tma_load_3d(sm + P::Q_OFF + w * TILE_BYTES, tq, qbar, 0, blockIdx.y * 64 * NWG + 64 * w, bh);
  }
  for (int n = 0; n < nt; ++n) {
    const int st = n % STAGES;
    const uint32_t ph = uint32_t(n / STAGES) & 1u;
    const int k0 = (t0 + n) * 64;
    mbar_wait(&empty[st], ph ^ 1u);
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * TILE_BYTES);
      tma_load_3d(sm + P::K_OFF + st * TILE_BYTES, tk, &full[st], 0, k0, bh);
      tma_load_3d(sm + P::V_OFF + st * TILE_BYTES, tv, &full[st], 0, k0, bh);
    }
    float* bias = reinterpret_cast<float*>(sm + P::BIAS_OFF) + st * 64;
    for (int j = lane; j < 64; j += 32) {
      const int key = k0 + j;
      bias[j] = key >= a.S ? -INFINITY
                           : ((pad != nullptr && pad[key]) ? MASK_BIAS * LOG2E : 0.f);
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[st]);
  }
}

// grid (B H, query blocks of 64 NWG, key splits)
template <int NWG, int STAGES>
__global__ void __launch_bounds__(Plan<NWG, STAGES>::THREADS, min_blocks<NWG>())
mha_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, const Args a) {
  using P = Plan<NWG, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int ktiles = (a.S + 63) / 64;
  const int t0 = blockIdx.z * a.tiles_per_split;
  const int nt = min(t0 + a.tiles_per_split, ktiles) - t0;  // > 0: the launcher makes no empty split

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128 * NWG)
    produce<NWG, STAGES>(sm, &tq, &tk, &tv, a, t0, nt);
  else
    consume<NWG, STAGES>(sm, &to, a, t0, nt);
}

template <int NWG, int STAGES>
cudaError_t launch_plan(const CUtensorMap* maps, const Args& a, dim3 grid, cudaStream_t stream) {
  using P = Plan<NWG, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_wgmma_kernel<NWG, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return err;
  mha_fwd_wgmma_kernel<NWG, STAGES><<<grid, P::THREADS, P::BYTES, stream>>>(maps[0], maps[1],
                                                                           maps[2], maps[3], a);
  return cudaGetLastError();
}

}  // namespace fwd

}  // namespace

// The v1 bf16 kernel (mma.sync), which no route takes: kept to be timed
// beside the wgmma routes.  Returns a cudaError_t (0 = launched).
extern "C" int mha_fwd_v1(const void* q, const void* k, const void* v, const void* pad, void* out,
                          int B, int H, int S, int D, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D != 64 || (S + 63) / 64 > 65535)
    return int(cudaErrorInvalidValue);
  return int(launch_bf16<64>(q, k, v, pad, out, B, H, S, static_cast<cudaStream_t>(stream)));
}

// The wgmma routes, bf16: "short" for S <= 128 (one block per (row, head),
// splits must be 1), "long" for S > 128 (128 queries a block, the key range
// in `splits` parts, fewer if a part would be empty).  part: with more than
// one split, splits * B H * Sq * 66 f32 of scratch (Sq = S rounded up to
// 128), else unused.  Pointers 16-byte aligned (TMA).  Returns a cudaError_t
// (0 = launched).
extern "C" int mha_fwd_wgmma(const void* q, const void* k, const void* v, const void* pad,
                             void* out, void* part, int B, int H, int S, int head_dim, int splits,
                             void* stream) {
  const void* aligned[5] = {q, k, v, out, part};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 0 || head_dim != 64 || splits <= 0 || splits > 65535)
    return int(cudaErrorInvalidValue);
  const bool long_route = S > 128;
  const int BH = B * H, ktiles = (S + 63) / 64;
  const int per = (ktiles + splits - 1) / splits;
  splits = (ktiles + per - 1) / per;  // no empty split
  if ((!long_route && splits != 1) || (splits > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  const int qblocks = long_route ? (S + 127) / 128 : 1;

  const uint64_t dims[3] = {64, uint64_t(S), uint64_t(BH)};
  const uint64_t strides[2] = {128, uint64_t(S) * 128};
  const uint32_t box[3] = {64, 64, 1};
  const void* ptrs[4] = {q, k, v, out};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!hopper::make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return int(cudaErrorInvalidValue);

  fwd::Args a;
  a.pad = static_cast<const uint8_t*>(pad);
  a.H = H, a.S = S, a.Sq = qblocks * 128, a.tiles_per_split = per;
  a.part_o = static_cast<float*>(part);
  a.part_ml = splits > 1 ? reinterpret_cast<float2*>(a.part_o + size_t(splits) * BH * a.Sq * 64)
                         : nullptr;
  a.scale2 = fwd::LOG2E / sqrtf(float(head_dim));
  const dim3 grid{unsigned(BH), unsigned(qblocks), unsigned(splits)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (S <= 64)
    err = fwd::launch_plan<1, 2>(maps, a, grid, st);
  else if (!long_route)
    err = fwd::launch_plan<2, 2>(maps, a, grid, st);
  else
    err = fwd::launch_plan<2, 4>(maps, a, grid, st);
  if (err != cudaSuccess || splits == 1) return int(err);
  return int(mha_merge::launch_merge<__nv_bfloat16>(a.part_o, a.part_ml, out, BH, S, a.Sq, splits, st));
}
