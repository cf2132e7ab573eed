// Split-TF32 ("3xTF32") products on the tensor cores, the f32 routes of
// mha_fwd, mha_bwd and the MIL-NCE kernels (sm_80+, built for sm_90a).
//
// The TPU kernels ask for f32 products at Precision.HIGHEST, an accuracy
// level that the TPU meets with several passes of its bf16 matrix unit.  The
// same level here: each f32 operand is split as x = big + small with big =
// tf32(x) (round to nearest, ties away from zero) and small = x - big
// truncated to TF32 (split), and a product a b is accumulated in f32 as a_big b_small +
// a_small b_big + a_big b_big, the two cross products first, each k-step's
// pair summed apart and added to the accumulator in f32 (mma3; the dropped
// a_small b_small and small's truncation are each ~2^-21 of a b or less).  Each term is an exact product of
// 11-bit significands, so what is left is the f32 accumulation: the error of
// an f32 FMA loop, at up to a third of the TF32 rate (495 / 3 TFLOP/s on an
// H100 SXM against 67 TFLOP/s of f32 FMAs on the CUDA cores).
//
// Products are mma.sync m16n8k8 .tf32 (lane = 4 g + t): A rows g, g + 8 and
// columns t, t + 4; B rows (k) t, t + 4 and column g; C rows g, g + 8 and
// columns 2 t, 2 t + 1.  Operands come from f32 tiles staged in shared memory
// as [rows][LD] with LD = 68 (4 mod 32 banks), which makes every fragment
// load below free of bank conflicts.  wgmma takes .tf32 only K-major, which
// fits q k^T but not P V (V is [keys][D] with D contiguous, and there is no
// transpose for 32-bit types), so both products run on mma.sync.
//
// A C fragment feeds the next product as an A fragment without leaving the
// registers when the 8 k indices of its step are taken in the order 0, 2, 4,
// 6, 1, 3, 5, 7: A(row, k = t) is C(row, column 2 t), A(row, k = t + 4) is
// C(row, 2 t + 1), so a = {c0, c2, c1, c3}, and B's row t of the step is row
// 2 t of the staged tile, row t + 4 is row 2 t + 1 (acc_mul).

#pragma once

#include "mma.cuh"

namespace tf32x3 {

constexpr int D = 64;   // head dim: the width of every staged row
constexpr int LD = 68;  // row stride of a staged tile, in floats

// x = big + small, both TF32, by integer arithmetic on the f32 word: big
// rounds to nearest with ties away from zero (adding half a TF32 ulp to the
// magnitude bits, what cvt.rna.tf32.f32 does, which sm_90a runs as a longer
// emulated sequence), small = x - big (exact) truncated to TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy: the two cross products, then the big one.  The
// cross products go into a zeroed accumulator of their own, added to c in
// f32 before the big one: an mma rounds its sum (by truncation) at the
// scale of its largest term, so c, the largest, passes through one mma a
// k-step instead of three
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                     const uint32_t bb[2], const uint32_t bs[2]) {
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(x, ab, bs[0], bs[1]);
  mma_tf32(x, as, bb[0], bb[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += x[i];
  mma_tf32(c, ab, bb[0], bb[1]);
}

// one k-step of a split-TF32 product into x: a_big b_small + a_small b_big +
// a_big b_big (x is a short partial sum that the caller adds to its running
// sum in f32; the MIL-NCE kernels)
__device__ __forceinline__ void mma_split(float x[4], const uint32_t ab[4], const uint32_t as[4],
                                          const uint32_t bb[2], const uint32_t bs[2]) {
  mma_tf32(x, ab, bs[0], bs[1]);
  mma_tf32(x, as, bb[0], bb[1]);
  mma_tf32(x, ab, bb[0], bb[1]);
}

// c[n] = A B_n^T for the 8-row chunks n < nch of B (n < N; the rest are
// zero): A the 16 rows of a staged tile at a, B the rows of one at b, both
// over the D columns.  FULL: nch is N, and the unrolled loops carry no
// branch (a branch around an mma.sync ends the compiler's interleaving of
// the independent chunks' loads, splits and products there)
template <int N, bool FULL = false>
__device__ __forceinline__ void rows_dot(float (&c)[N][4], const float* a, const float* b, int nch,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const float* ar = a + g * LD + 8 * ks + t;
    uint32_t ab[4], as[4];
    split(ar[0], ab[0], as[0]);
    split(ar[8 * LD], ab[1], as[1]);
    split(ar[4], ab[2], as[2]);
    split(ar[8 * LD + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (FULL || n < nch) {
        const float* br = b + (8 * n + g) * LD + 8 * ks + t;
        uint32_t bb[2], bs[2];
        split(br[0], bb[0], bs[0]);
        split(br[4], bb[1], bs[1]);
        mma3(c[n], ab, as, bb, bs);
      }
    }
  }
}

// acc[n] += X Y[:, 8 n .. 8 n + 7] over the first 8 nch rows of Y: X given as
// the C fragments x[kk] of 16 rows by 8 N columns (chunk kk, kk < N, holds
// columns 8 kk .. +7, the rows of Y of the same index), taken as A fragments
// in the permuted k order; Y the rows of a staged tile at y, over the D
// columns (FULL as for rows_dot)
template <int N, bool FULL = false>
__device__ __forceinline__ void acc_mul(float (&acc)[D / 8][4], const float (&x)[N][4],
                                        const float* y, int nch, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    if (FULL || kk < nch) {
      uint32_t ab[4], as[4];
      split(x[kk][0], ab[0], as[0]);
      split(x[kk][2], ab[1], as[1]);
      split(x[kk][1], ab[2], as[2]);
      split(x[kk][3], ab[3], as[3]);
      const float* yr = y + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2], bs[2];
        split(yr[8 * n], bb[0], bs[0]);
        split(yr[LD + 8 * n], bb[1], bs[1]);
        mma3(acc[n], ab, as, bb, bs);
      }
    }
  }
}

// rows [r0, r0 + n) of a [S, D] f32 head into dst[n][LD] by cp.async, 16
// bytes a thread; rows past S are zero-filled (nothing is read for them)
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n, int S) {
  for (int e = threadIdx.x; e < n * (D / 4); e += blockDim.x) {
    const int j = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool in = r0 + j < S;
    cp_async_16(dst + j * LD + c, src + size_t(in ? r0 + j : 0) * D + c, in);
  }
}

// the max and the sum over the 4 lanes of a quad (they share rows g, g + 8)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// store the C fragments acc (16 rows of D columns) times s to rows r0 + g and
// r0 + g + 8 of a [S, D] f32 head, rows < S only
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 8][4], int r0, int S,
                                           float s0, float s1, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r[2] = {r0 + g, r0 + g + 8};
  const float s[2] = {s0, s1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r[h] < S) {
      float* o = dst + size_t(r[h]) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(acc[n][2 * h] * s[h], acc[n][2 * h + 1] * s[h]);
    }
  }
}

}  // namespace tf32x3
