// Warp-level tensor-core helpers of K12's tile loop (sliding_window.cu):
// mma.sync m16n8k16 in bf16 with fp32 accumulation and the ldmatrix loads of
// its B fragments; and pack_bf16, which the wgmma kernels (K5, K10, the GEMM)
// and the GEMV use too.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ftcf {

// D += A (16x16, row) * B (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> two bf16 in a word, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory: lanes 8j .. 8j + 7 give the row
// addresses of matrix j, and r[j] holds, for lane l, elements (row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1) of matrix j: from a row-major
// [n][k] tile, the B fragment of m16n8k16 (its column-major [k][n] operand).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8j .. 8j + 7
// give the row addresses of matrix j, and r[j] holds, for lane l, elements
// (row 2 (l % 4), column l / 4) and (row 2 (l % 4) + 1, column l / 4) of
// matrix j: the B fragment of m16n8k16 from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

}  // namespace ftcf
