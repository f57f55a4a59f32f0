// Prefill-width (M > 32) weight-only GEMM shared by K1 (quant_matmul.cu),
// K6/K7/K8 (quant_matmul_w4.cu) and K13's prefill form (quant_matmul_fused.cu):
// y = act(x @ dequant(W) * s + b), x bf16 [M, K], fp32 accumulation, y bf16
// or fp32; K13 joins two such outputs over N in one launch.
//
// Bound by the tensor cores at these widths: a tiled GEMM whose weight tile
// is converted to bf16 while it is stored to shared memory, then
// nvcuda::wmma bf16 16x16x16 with fp32 accumulation. One 128x128 tile per
// block, 8 warps of 32x64, BK = 32, the next tile's global loads issued
// before the current tile's MMAs. Staging per format:
//  - int8: exact in bf16 (|q| <= 127 fits its mantissa);
//  - int4: the nibbles are unpacked (low nibble = even K row) and exact;
//  - group-wise int4: each weight is multiplied by its group's bf16 scale
//    in fp32 and the product rounded to bf16 (the scale is folded into a
//    bf16 weight, as the JAX XLA path's dequantize(x.dtype) does; up to
//    2^-9 relative per weight); the epilogue then applies no scale. Staging
//    the product as two bf16 tiles (hi + lo, ~fp32) ran 57% slower on an
//    H100 at M = 512 with no measurable change in a 2-layer model's logits.
// wgmma, TMA and a multi-stage pipeline are later work.
#pragma once

#include <mma.h>

#include "ftcf_common.cuh"

namespace ftcf {

constexpr int GB_M = 128, GB_N = 128, GB_K = 32;
constexpr int GA_LD = GB_K + 8;   // bf16 elements; padded against bank conflicts
constexpr int GB_LD = GB_N + 8;
constexpr int GC_LD = 16 + 4;     // fp32 staging of one 16x16 fragment per warp

// One output segment of the GEMM: its activations, weight, scales, bias,
// activation and output. K13's prefill form joins two over N (the qkv and
// up columns); K1/K6/K7/K8 run one.
struct GemmSeg {
  const __nv_bfloat16* x;       // [M, K]
  const int8_t* w;              // [K, N] int8 or [K/2, N] packed int4
  const float* scale;           // [N] per-channel, or nullptr with group scales
  const __nv_bfloat16* gscale;  // [K/G, N] bf16 group scales (W_I4G)
  const void* bias;
  int bias_bf16;
  int act;
  void* y;                      // [M, N]
  int N;
};

// Grid x runs over s1's column tiles, then s2's (none when s2.N is 0).
template <int FMT>
static __global__ void __launch_bounds__(256)
qmm_gemm_kernel(GemmSeg s1, GemmSeg s2, int G, int out_f32, int M, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[GB_M][GA_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[GB_K][GB_LD];
  __shared__ __align__(32) float Cs[8][16][GC_LD];

  const int t1 = (s1.N + GB_N - 1) / GB_N;
  const bool second = (int)blockIdx.x >= t1;
  const GemmSeg sg = second ? s2 : s1;
  const __nv_bfloat16* __restrict__ x = sg.x;
  const int8_t* __restrict__ w = sg.w;
  const float* __restrict__ scale = sg.scale;
  const __nv_bfloat16* __restrict__ gscale = sg.gscale;
  const void* bias = sg.bias;
  const int bias_bf16 = sg.bias_bf16, act = sg.act, N = sg.N;
  void* y = sg.y;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bm = blockIdx.y * GB_M, bn = (second ? (int)blockIdx.x - t1 : (int)blockIdx.x) * GB_N;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // A tile: 128 rows x 32 bf16 = 512 16-byte chunks, two per thread.
  // B tile, int8: 32 rows x 128 bytes = 256 16-byte chunks, one per thread;
  // int4: 16 byte rows x 128 = 256 8-byte chunks (8 columns x 2 K rows) per
  // thread, plus, group-wise, the 8 bf16 scales of those columns.
  uint4 a_reg[2], b_reg, s_reg;
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256, r = idx >> 2, c = (idx & 3) * 8;
      const int gm = bm + r, gk = k0 + c;
      a_reg[i] = (gm < M && gk < K)
                     ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                     : make_uint4(0, 0, 0, 0);
    }
    if constexpr (FMT == W_I8) {
      const int r = tid >> 3, c = (tid & 7) * 16;
      const int gk = k0 + r, gn = bn + c;
      b_reg = (gk < K && gn < N) ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn))
                                 : make_uint4(0, 0, 0, 0);
    } else {
      const int r = tid >> 4, c = (tid & 15) * 8;
      const int gr = k0 / 2 + r, gn = bn + c;
      const bool in = gr < K / 2 && gn < N;
      const uint2 p =
          in ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)gr * N + gn)) : make_uint2(0, 0);
      b_reg = make_uint4(p.x, p.y, 0, 0);
      if constexpr (FMT == W_I4G)
        s_reg = in ? __ldg(reinterpret_cast<const uint4*>(gscale + (size_t)(2 * gr / G) * N + gn))
                   : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256, r = idx >> 2, c = (idx & 3) * 8;
      *reinterpret_cast<uint4*>(&As[r][c]) = a_reg[i];
    }
    union {
      __nv_bfloat162 h[8];
      uint4 u[2];
    } cvt;
    if constexpr (FMT == W_I8) {
      const int r = tid >> 3, c = (tid & 7) * 16;
      float f[16];
      i8x4_to_f32(b_reg.x, f);
      i8x4_to_f32(b_reg.y, f + 4);
      i8x4_to_f32(b_reg.z, f + 8);
      i8x4_to_f32(b_reg.w, f + 12);
#pragma unroll
      for (int t = 0; t < 8; ++t) cvt.h[t] = __floats2bfloat162_rn(f[2 * t], f[2 * t + 1]);
      *reinterpret_cast<uint4*>(&Bs[r][c]) = cvt.u[0];
      *reinterpret_cast<uint4*>(&Bs[r][c + 8]) = cvt.u[1];
    } else {
      const int r = tid >> 4, c = (tid & 15) * 8;
      float f[16];  // K row 2r in f[0..7], row 2r + 1 in f[8..15]
      i4x8_to_f32(b_reg.x, f, f + 8);
      i4x8_to_f32(b_reg.y, f + 4, f + 12);
      if constexpr (FMT == W_I4G) {
        float sc[8];
        bf16x2_to_f32(s_reg.x, sc);
        bf16x2_to_f32(s_reg.y, sc + 2);
        bf16x2_to_f32(s_reg.z, sc + 4);
        bf16x2_to_f32(s_reg.w, sc + 6);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[j] *= sc[j];
          f[8 + j] *= sc[j];
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) cvt.h[t] = __floats2bfloat162_rn(f[2 * t], f[2 * t + 1]);
      *reinterpret_cast<uint4*>(&Bs[2 * r][c]) = cvt.u[0];
      *reinterpret_cast<uint4*>(&Bs[2 * r + 1][c]) = cvt.u[1];
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += GB_K) {
    store_tiles();
    __syncthreads();
    if (k0 + GB_K < K) load_tiles(k0 + GB_K);
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], GA_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn + j * 16], GB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], GC_LD, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int gm = bm + wm + i * 16 + r, gn = bn + wn + j * 16 + c;
        if (gm < M && gn < N) {
          float v = Cs[warp][r][c];
          if (scale != nullptr) v *= scale[gn];
          v = apply_act(v + load_bias(bias, bias_bf16, gn), act);
          if (out_f32)
            static_cast<float*>(y)[(size_t)gm * N + gn] = v;
          else
            static_cast<__nv_bfloat16*>(y)[(size_t)gm * N + gn] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
}

template <int FMT>
static cudaError_t launch_gemm_ncat(GemmSeg s1, GemmSeg s2, int G, int out_f32, int M, int K,
                                   cudaStream_t stream) {
  const dim3 grid((s1.N + GB_N - 1) / GB_N + (s2.N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M);
  qmm_gemm_kernel<FMT><<<grid, 256, 0, stream>>>(s1, s2, G, out_f32, M, K);
  return cudaGetLastError();
}

template <int FMT>
static cudaError_t launch_gemm(const void* x, const void* w, const float* scale,
                               const void* gscale, int G, int M, int K, int N, const void* bias,
                               int bias_bf16, int act, void* y, int out_f32,
                               cudaStream_t stream) {
  const GemmSeg s1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
                   static_cast<const __nv_bfloat16*>(gscale), bias, bias_bf16, act, y, N};
  const GemmSeg s2{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr, 0};
  return launch_gemm_ncat<FMT>(s1, s2, G, out_f32, M, K, stream);
}

}  // namespace ftcf
