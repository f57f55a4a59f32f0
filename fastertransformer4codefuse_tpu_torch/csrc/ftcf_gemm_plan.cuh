// The prefill-width GEMM's interface to its callers (K1 quant_matmul.cu,
// K6/K7/K8 quant_matmul_w4.cu, K13 quant_matmul_fused.cu): the segments, the
// launch plan and the four block-tile instances. The kernel is
// ftcf_gemm.cuh; each tile's instances, over every weight format, are built
// in a source of their own (gemm_<rows>x<cols>.cu), so that the four
// compile side by side and no caller compiles them again.
//
// The plan is what the tile cache (ops/tile_tuning.py) tunes per shape:
//  - the block tile: 128 rows of x x 128 output channels (the default),
//    64 x 128 (one wgmma N of 64: twice the blocks, for the shapes that
//    quantize badly into waves), 128 x 256 (two 64-channel products a
//    consumer warpgroup, half the blocks and half the x reads) or 256 x 128
//    (one wgmma N of 256: half the blocks, each weight tile converted once
//    for 256 rows);
//  - the width of the group-M raster (row tiles a group of blocks sweeps);
//  - the cap on the ring's stages (the ring takes what shared memory holds,
//    up to the cap).
// ops/quant_matmul.py GemmPlan holds the same fields and GEMM_TILES the same
// instances.
#pragma once

#include "ftcf_common.cuh"

namespace ftcf {

// One output segment of the GEMM: its activations, weight, scales, bias,
// activation and output. K13's prefill form joins two over N (the qkv and
// up columns); K1/K6/K7/K8 run one.
struct GemmSeg {
  const __nv_bfloat16* x;       // [M, K]
  const int8_t* w;              // [K, N] int8 or [K/2, N] packed int4
  const float* scale;           // [N] per-channel, or nullptr with group scales
  const void* gscale;           // [K/G, N] group scales: bf16 (W_I4G) or fp32 (W_I4GF, W_I8G)
  const void* bias;
  int bias_bf16;
  int act;
  void* y;                      // [M, N]
  int N;
};

struct GemmPlan {
  int rows;     // rows of x a block: 128 or 64
  int cols;     // output channels a block: 128 or 256
  int group_m;  // row tiles a group of blocks sweeps (L2 reuse)
  int stages;   // cap on the ring's stages, 2-8
};

// The instances of one block tile, over the weight formats (fmt a WFmt);
// cudaErrorInvalidValue for a plan or shape they do not take.
#define FTCF_GEMM_TILE_DECL(R, C)                                                           \
  cudaError_t gemm_tile_##R##x##C(int fmt, const GemmSeg& s1, const GemmSeg& s2, int G,    \
                                  int out_f32, int M, int K, int group_m, int stages,      \
                                  cudaStream_t stream)
FTCF_GEMM_TILE_DECL(128, 128);
FTCF_GEMM_TILE_DECL(64, 128);
FTCF_GEMM_TILE_DECL(128, 256);
FTCF_GEMM_TILE_DECL(256, 128);

inline cudaError_t launch_gemm_ncat(int fmt, const GemmSeg& s1, const GemmSeg& s2, int G,
                                    int out_f32, int M, int K, const GemmPlan& p,
                                    cudaStream_t stream) {
  if (p.rows == 128 && p.cols == 128)
    return gemm_tile_128x128(fmt, s1, s2, G, out_f32, M, K, p.group_m, p.stages, stream);
  if (p.rows == 64 && p.cols == 128)
    return gemm_tile_64x128(fmt, s1, s2, G, out_f32, M, K, p.group_m, p.stages, stream);
  if (p.rows == 128 && p.cols == 256)
    return gemm_tile_128x256(fmt, s1, s2, G, out_f32, M, K, p.group_m, p.stages, stream);
  if (p.rows == 256 && p.cols == 128)
    return gemm_tile_256x128(fmt, s1, s2, G, out_f32, M, K, p.group_m, p.stages, stream);
  return cudaErrorInvalidValue;
}

// One segment: y = act(x @ dequant(w) * scale + bias), scale per channel or
// gscale by groups of G.
inline cudaError_t launch_gemm(int fmt, const void* x, const void* w, const float* scale,
                               const void* gscale, int G, int M, int K, int N, const void* bias,
                               int bias_bf16, int act, void* y, int out_f32, const GemmPlan& p,
                               cudaStream_t stream) {
  const GemmSeg s1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
                   gscale, bias, bias_bf16, act, y, N};
  const GemmSeg s2{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr, 0};
  return launch_gemm_ncat(fmt, s1, s2, G, out_f32, M, K, p, stream);
}

}  // namespace ftcf
