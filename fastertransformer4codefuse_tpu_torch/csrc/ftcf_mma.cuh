// Warp-level tensor-core helpers of K12's tile loop (sliding_window.cu):
// mma.sync m16n8k16 in bf16 with fp32 accumulation and the ldmatrix loads of
// its B fragments; and pack_bf16, which the wgmma kernels (K5, K10, the GEMM)
// and the GEMV use too. Then the fp32-accurate product of K5's fp32 backward
// (prefill_flash_bwd.cu): mma.sync m16n8k8 in TF32, three times over the
// operands split into a TF32 big and small part (3xTF32).
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

// 3xTF32. TF32 keeps 10 of fp32's 23 mantissa bits (about three digits),
// so one TF32 product cannot hold an fp32 result. Split x = big + small with
// big = rna(x) and small = rna(x - big) (x - big is exact in fp32, at most
// 2^-11 |x|), and sum big*big + big*small + small*big: what is left out is
// small*small (~2^-22 of the product) and small's own rounding (~2^-22), so
// each product keeps about fp32's accuracy. The three MMAs run on the tensor
// cores: the TF32 peak, 495 TFLOP/s, makes 165 of fp32 work against 67 on
// the FMA units, though mma.sync reaches only part of that peak on Hopper
// (gemv_ab.py --kernels mma measures it).

// fp32 -> TF32, rounded to nearest (ties away from zero), in a 32-bit word:
// half a unit of the 13 dropped bits added to the magnitude, then cleared.
// These are the bits of cvt.rna.tf32.f32 on every finite input (a NaN may
// become an infinity, which keeps the product NaN); on sm_90a that
// instruction is four (this add and mask, a range test and a select), and
// the split is the kernels' largest cost after the MMAs.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// N fp32 words (raw bits, as ldmatrix or a load gives them) -> big and small.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t* x, uint32_t* big, uint32_t* small) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = tf32_rna(__uint_as_float(x[i]));
    small[i] = tf32_rna(__uint_as_float(x[i]) - __uint_as_float(big[i]));
  }
}

// D += A (16x8, row) * B (8x8, col), TF32 in, fp32 accumulate. Fragments
// (lane l, g = l / 4, t = l % 4): a = A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; d = D[g][2t], D[g][2t + 1],
// D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_1688_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A * B in about fp32 accuracy: the two small terms first, then big*big.
__device__ __forceinline__ void mma_1688_3xtf32(float* d, const uint32_t* a_big,
                                                const uint32_t* a_small, const uint32_t* b_big,
                                                const uint32_t* b_small) {
  mma_1688_tf32(d, a_small, b_big);
  mma_1688_tf32(d, a_big, b_small);
  mma_1688_tf32(d, a_big, b_big);
}

// A TF32 A fragment of m16n8k8 from a row-major fp32 tile in shared memory
// (row stride ld floats, 16-byte aligned rows): rows r0 .. r0 + 15, columns
// c0 .. c0 + 7, by one ldmatrix (an 8x8 b16 matrix is 8 rows of 4 fp32
// words, and lane l receives word l % 4 of row l / 4: the TF32 fragment).
__device__ __forceinline__ void ldmatrix_a_tf32(uint32_t* a, const float* tile, int ld, int r0,
                                                int c0) {
  const int l = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + c0 + (l >> 4) * 4);
}

// Two TF32 B fragments of m16n8k8 (n-blocks n0 .. n0 + 7 and n0 + 8 ..
// n0 + 15) from a row-major [n][k] fp32 tile, columns c0 .. c0 + 7: b[0..1]
// the first, b[2..3] the second.
__device__ __forceinline__ void ldmatrix_b2_tf32(uint32_t* b, const float* tile, int ld, int n0,
                                                 int c0) {
  const int l = threadIdx.x % 32;
  ldmatrix_x4(b, tile + (n0 + (l & 7) + (l >> 4) * 8) * ld + c0 + ((l >> 3) & 1) * 4);
}

}  // namespace ftcf
