// Warp-level tensor-core and copy helpers for sm_80+ (used on sm_90a):
// mma.sync m16n8k16 bf16 with f32 accumulate, ldmatrix, and cp.async.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t): A rows g and g + 8,
// columns 2t, 2t + 1 (+8); B column g, rows 2t, 2t + 1 (+8); C rows g and
// g + 8, columns 2t, 2t + 1.  The C fragments of two adjacent 8-column
// chunks are, register for register, the A fragment of a 16-deep product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 of global memory as one register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
