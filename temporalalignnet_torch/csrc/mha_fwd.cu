// Fused multi-head attention forward for Hopper (sm_90a):
//   out = softmax(Q K^T / sqrt(D) + bias) V,  bias = -1e30 on padded keys.
//
// Replaces temporalalignnet_tpu/ops/pallas_attention.py::_mha_kernel (the
// Pallas TPU kernel reached through fused_attention).  Same semantics: scores
// and softmax in f32, P rounded to the value dtype before P.V, output in the
// input dtype, and a finite -1e30 bias so a fully padded row averages V
// uniformly over the real keys instead of producing NaN.  In f32 every product
// is a true f32 FMA (no TF32), as the TPU kernel asks for Precision.HIGHEST.
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
// - bf16 (the eval path): one warp per 16 query rows, and up to S = 128 one
//   block holds all of a head's queries, so K and V are read from device
//   memory once.  Q K^T and P V run on the tensor cores (mma.sync m16n8k16,
//   f32 accumulate, B operands through ldmatrix).  The score fragment of
//   Q K^T is, register for register, the A fragment of P V, so P never leaves
//   registers; it is rounded to bf16 there, as the reference casts it.  Keys
//   go in 16-key chunks, so S = 72 costs 80 keys, and the key tiles are
//   double buffered with cp.async so the next tile loads while one computes.
// - f32: every product is an f32 FMA on the CUDA cores (128 threads, 4 rows x
//   8 keys each, 64-query tiles), so this path is bound by instruction issue,
//   not by bytes.
//
// Layout: q, k, v, out are [B, H, S, D] contiguous; pad is [B, S] bytes
// (nonzero = padded key) or null.  Built by temporalalignnet_torch/ops/_build.py
// into a shared library with a plain C interface, called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------- f32: CUDA cores

constexpr int BQ = 64;         // queries per block
constexpr int BK = 64;         // keys per streamed tile
constexpr int NTHREADS = 128;  // 16 row groups x 8 column groups
constexpr int RPT = 4;         // query rows per thread (16 x 4 = 64)
constexpr int CPT = 8;         // key columns per thread in the score tile (8 x 8 = 64)
constexpr int LDT = 64 + 4;    // row stride of the transposed [D][64] and [BK][BQ] tiles
constexpr float MASK_BIAS = -1.0e30f;

static_assert(BQ == 16 * RPT && BK == 8 * CPT, "thread layout covers the tile");

template <int D>
constexpr size_t smem_bytes() {
  // q^T [D][LDT], k^T [D][LDT] (reused as P^T [BK][LDT]), v [BK][D + 4], bias [BK]
  return sizeof(float) * (size_t(D) * LDT + size_t(D > BK ? D : BK) * LDT +
                          size_t(BK) * (D + 4) + BK);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
mha_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const uint8_t* __restrict__ pad,
                   float* __restrict__ out, int H, int S, float scale) {
  static_assert(D % 32 == 0, "each thread owns D/8 output dims, a multiple of 4");
  constexpr int DPT = D / 8;  // output dims per thread
  constexpr int LDV = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [D][LDT]: q tile, transposed
  float* kt = qt + D * LDT;               // [D][LDT]: k tile, transposed
  float* pt = kt;                         // [BK][LDT]: P^T, written after the scores
  float* vs = kt + (D > BK ? D : BK) * LDT;  // [BK][LDV]
  float* bias = vs + BK * LDV;            // [BK]

  const int tid = threadIdx.x;
  const int rg = tid / CPT;  // row group: rows rg*RPT .. +RPT
  const int cg = tid % CPT;  // column group: keys cg*CPT .. +CPT, dims cg*DPT .. +DPT
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.y * BQ;
  const size_t base = size_t(bh) * S * D;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, d = e % D;
    qt[d * LDT + r] = (q0 + r < S) ? q[base + size_t(q0 + r) * D + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's P^T and V are no longer read
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < S;
      const size_t off = base + size_t(k0 + j) * D + d;
      kt[d * LDT + j] = in ? k[off] : 0.f;
      vs[j * LDV + d] = in ? v[off] : 0.f;
    }
    for (int j = tid; j < BK; j += NTHREADS) {
      const int key = k0 + j;
      // keys past S leave the softmax (-inf); padded keys keep the finite
      // reference bias, so a fully padded row averages the real keys
      bias[j] = key >= S ? -INFINITY
                         : ((pad != nullptr && pad[size_t(b) * S + key]) ? MASK_BIAS : 0.f);
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[d * LDT + rg * RPT]);
      const float4 ka = *reinterpret_cast<const float4*>(&kt[d * LDT + cg * CPT]);
      const float4 kb = *reinterpret_cast<const float4*>(&kt[d * LDT + cg * CPT + 4]);
      const float qr[RPT] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[CPT] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    float corr[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = s[i][j] * scale + bias[cg * CPT + j];
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row group are adjacent lanes of one warp
#pragma unroll
      for (int o = 1; o < CPT; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = 1; o < CPT; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading k^T before P^T overwrites it
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(&pt[(cg * CPT + j) * LDT + rg * RPT]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr[i];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&pt[j * LDT + rg * RPT]);
      const float pr[RPT] = {pv.x, pv.y, pv.z, pv.w};
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; c += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&vs[j * LDV + cg * DPT + c]);
        vv[c] = t.x;
        vv[c + 1] = t.y;
        vv[c + 2] = t.z;
        vv[c + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + rg * RPT + i;
    if (r >= S) continue;
    const float inv = 1.f / l[i];
    float* o = out + base + size_t(r) * D + cg * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[c] = acc[i][c] * inv;
  }
}

// ------------------------------------------------------- bf16: tensor cores

constexpr int TC_MAX_WARPS = 8;  // 16 query rows per warp
constexpr int TC_BK = 64;        // keys per streamed tile

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane i gives the row address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global -> shared without passing through registers; with
// valid = false the 16 bytes are zero-filled and nothing is read
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// two floats -> a bf16 pair, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* pad,
                       void* out, int B, int H, int S, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory has to be opted into
  cudaError_t err = cudaFuncSetAttribute(mha_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(B) * unsigned(H), unsigned((S + BQ - 1) / BQ));
  mha_fwd_f32_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(pad),
      static_cast<float*>(out), H, S, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int mha_fwd(const void* q, const void* k, const void* v, const void* pad,
                       void* out, int B, int H, int S, int D, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D != 64 || (S + BQ - 1) / BQ > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(launch_f32<64>(q, k, v, pad, out, B, H, S, st));
  if (dtype == 1) return int(launch_bf16<64>(q, k, v, pad, out, B, H, S, st));
  return int(cudaErrorInvalidValue);
}
