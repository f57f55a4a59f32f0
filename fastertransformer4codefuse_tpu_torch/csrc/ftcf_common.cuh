// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftcf {

// Activation codes; ops/linear.py ACT_CODES holds the same table.
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_RELU = 3, ACT_SILU = 4 };

// Weight formats: int8 [K, N]; int4 [K/2, N] (row pairs packed along K) with
// fp32 per-channel scales; the same int4 payload with bf16 [K/G, N] group
// scales; int8 with fp32 [K/G, N] group scales (GEMV only); int4 with fp32
// group scales (the JAX package's FTCF_GSCALE_BF16=0).
// ops/quant_matmul.py WEIGHT_FORMATS holds the same values.
enum WFmt { W_I8 = 0, W_I4 = 1, W_I4G = 2, W_I8G = 3, W_I4GF = 4 };

// K rows held by one byte row of the weight.
template <int FMT>
struct KPack {
  static constexpr int value = FMT == W_I8 || FMT == W_I8G ? 1 : 2;
};

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
    case ACT_GELU_TANH: {
      const float c = 0.79788456080286536f;  // sqrt(2 / pi)
      return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_SILU:
      return y / (1.0f + expf(-y));
    default:
      return y;
  }
}

// Four signed int8 packed in a word -> four exact floats. Each byte is biased
// to unsigned and placed in the mantissa of 2^23 (one byte permute), then the
// float subtraction removes 2^23 + 128: two instructions per value, no I2F.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t bits = __byte_perm(x, 0x4B000000u, 0x7540u | i);
    f[i] = __uint_as_float(bits) - 8388736.0f;
  }
}

// Eight signed int4 packed in a word, two a byte: the low nibble of byte i is
// the even K row of column i, the high nibble the odd one. Out: lo[i] and
// hi[i], i = 0..3, exact floats. Biasing by 8 (xor 0x8 per nibble) makes each
// nibble unsigned, two mask/shift ops split the nibbles into bytes, and the
// int8 trick above (byte permute into the mantissa of 2^23) with 2^23 + 8
// subtracted gives the value back.
__device__ __forceinline__ void i4x8_to_f32(uint32_t w, float* lo, float* hi) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu;
  const uint32_t h = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540u | i)) - 8388616.0f;
    hi[i] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540u | i)) - 8388616.0f;
  }
}

// As i4x8_to_f32, but each value v comes out as the exact float 136 + v
// (128 + the biased nibble, built by one byte permute: the nibble in the
// mantissa below 2^7), saving the subtraction. A caller that multiplies the
// values by x and sums them removes 136 * sum(x) once per sum; the
// cancellation costs ~5 of fp32's 24 bits over a sum of a few dozen terms.
__device__ __forceinline__ void i4x8_to_f32_plus136(uint32_t w, float* lo, float* hi) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu;
  const uint32_t h = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __uint_as_float(__byte_perm(l, 0x43000000u, 0x7044u | (i << 8)));
    hi[i] = __uint_as_float(__byte_perm(h, 0x43000000u, 0x7044u | (i << 8)));
  }
}

// KV cache payload formats: bf16; int8 (bf16 scale per cached vector);
// packed int4 (the same scales; sequence positions 2i and 2i + 1 share pair
// row i, position 2i in the low nibble of each byte). ops/flash_decode.py
// holds the same values (KV_BF16, KV_I8, KV_I4).
enum KVFmt { KV_BF16 = 0, KV_I8 = 1, KV_I4 = 2 };

// Element offset of cached vector u's payload in a slab of dh-wide rows.
// Packed int4 keeps vector u in pair row u / 2: with an even slab length
// (or page size) per (row, head), ((b nKV + h) S + s) / 2 is
// (b nKV + h) S / 2 + s / 2, so the unpacked index addresses the pair row.
template <int FMT>
__device__ __forceinline__ size_t kv_vec_off(uint32_t u, int dh) {
  return (size_t)(FMT == KV_I4 ? u >> 1 : u) * dh;
}

// Four packed int4 bytes -> the four values of one nibble (the high ones
// when ``odd``), sign-extended, as exact floats: the nibble goes to the
// byte's low half, xor 8 biases it to unsigned, and the int8 trick above
// (2^23 + 8 subtracted) gives the value back.
__device__ __forceinline__ void i4x4_nibble_to_f32(uint32_t w, bool odd, float* f) {
  const uint32_t x = ((odd ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | i)) - 8388616.0f;
}

// Two bf16 in a word (the first in the low half) -> two floats.
__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// bf16x2 d = a * b + c (one rounding; exact on the small integers of the
// weight conversions).
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The second constants of the conversions' logic ops below. A logic op
// takes one immediate; read from the constant bank, the other is an
// operand too, so each ``(x & mask) op constant`` is one instruction on the
// integer pipe, which bounds the int4 conversion, instead of two.
static __constant__ uint32_t kI4Exp = 0x43404308u;
static __constant__ uint32_t kI8Exp = 0x43004300u;
static __constant__ uint32_t kI8Sign = 0xC300C300u;

// Byte I of a packed int4 word as the bf16x2 (low nibble, high nibble), the
// signed values exactly. One byte permute takes byte I of q (its low nibble
// in bits 0-3) and of q >> 1 (its high nibble in bits 3-6) into the two
// halves; one logic op keeps those bits, xors 8 into each nibble (biasing it
// to unsigned u) and writes 0x43 above, so the halves are the bf16 values
// 128 + u and 128 + 8 u; then (1, 1/8) * r + (-136, -24) gives u - 8 in both.
template <int I>
__device__ __forceinline__ uint32_t i4_pair_bf16x2(uint32_t q) {
  const uint32_t r = __byte_perm(q, q >> 1, I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12));
  return fma_bf16x2((r & 0x0078000Fu) ^ kI4Exp, 0x3E003F80u, 0xC1C0C308u);
}

// Bytes 0 and 2 of a word (two int8 values) as the bf16x2 (byte 0, byte 2),
// exactly: a value v with low 7 bits l and sign bit s is l - 128 s = (128 +
// l) + (-128 - 128 s), both halves bf16 bit patterns (0x4300 | l and 0xC300
// | s << 7), added in bf16.
__device__ __forceinline__ uint32_t i8_rows_bf16x2(uint32_t p) {
  return fma_bf16x2((p & 0x007F007Fu) | kI8Exp, 0x3F803F80u, (p & 0x00800080u) | kI8Sign);
}

// The low nibbles of bytes 0 and 2 of a word (two signed int4 values) as the
// bf16x2 (byte 0, byte 2), exactly: one logic op keeps the nibbles, xors 8
// into each (biasing it to unsigned u) and writes 0x43 above (128 + u in
// bf16), then r - 136 gives u - 8.
static __constant__ uint32_t kI4Lo = 0x43084308u;
__device__ __forceinline__ uint32_t i4_rows_bf16x2(uint32_t p) {
  return fma_bf16x2((p & 0x000F000Fu) ^ kI4Lo, 0x3F803F80u, 0xC308C308u);
}

// Byte i of two int8 words (rows k and k + 1 of one column) as the bf16x2
// (row k, row k + 1), exactly.
template <int I>
__device__ __forceinline__ uint32_t i8_pair_bf16x2(uint32_t a, uint32_t b) {
  return i8_rows_bf16x2(__byte_perm(a, b, I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12)));
}

// 16 bytes global -> shared, asynchronously; ``bytes`` < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; ``bytes`` 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_bias(const void* bias, int bias_bf16, int n) {
  if (bias == nullptr) return 0.0f;
  return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
                   : static_cast<const float*>(bias)[n];
}

// 2^x by the SFU (ex2.approx: 2 ulp; -inf gives 0): the attention kernels'
// softmax, log2 e folded into the scale.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace ftcf
