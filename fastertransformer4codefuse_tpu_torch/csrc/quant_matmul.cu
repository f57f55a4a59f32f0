// K1: weight-only int8 matmul with the scale, bias and activation applied in
// the epilogue, y = act(x @ W * s + b); x bf16 [M, K], W int8 [K, N], s fp32
// [N], y bf16 [M, N], fp32 accumulation. With group scales (fp32 [K/G, N],
// the JAX package's group-wise int8 weights, which it computes in XLA) the
// scale of a K group multiplies that group's part of the sum: the W_I8G
// instances of the same GEMV and GEMM bodies.
//
// Replaces fastertransformer4codefuse_tpu/ops/quant_matmul.py
// quant_matmul_pallas_stacked (and, through a layer's view of the stacked
// weight, the 2-D quant_matmul_pallas): the Pallas kernel streams int8 tiles
// HBM -> VMEM, converts them on the VPU and feeds the MXU.
//
// Two regimes on the H100:
//  - decode widths (M <= 32) are bound by the K*N weight bytes: the
//    weight-streaming GEMV of ftcf_gemv.cuh;
//  - prefill widths are bound by the tensor cores: the TMA + wgmma GEMM of
//    ftcf_gemm.cuh, whose consumer warps convert their channels of each raw
//    int8 weight tile into the products' A fragments, in registers, while
//    the previous tile's products run.
#include "ftcf_gemm_plan.cuh"
#include "ftcf_gemv.cuh"

extern "C" {

// Decode regime: K in `splits` ranges of `chunk` rows (ops/quant_matmul.py
// split_ranges); ws holds splits * M * N floats (allocated by the caller).
// G = 0: per-channel scales `scale` [N]; G > 0: fp32 group scales `gscale`
// [K/G, N], a split holding whole groups (chunk a multiple of G).
int ftcf_quant_matmul_gemv(const void* x, const void* w, const float* scale, const void* gscale,
                           int G, int M, int K, int N, int splits, int chunk, const void* bias,
                           int bias_bf16, int act, void* y, float* ws, void* stream) {
  ftcf::GemvSeg s1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
                   gscale, K, G, splits, chunk};
  ftcf::GemvSeg s2{nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G)
    return (int)ftcf::launch_gemv<ftcf::W_I8G>(s1, s2, M, N, bias, bias_bf16, act, nullptr, y, 0,
                                               ws, st);
  return (int)ftcf::launch_gemv<ftcf::W_I8>(s1, s2, M, N, bias, bias_bf16, act, nullptr, y, 0, ws,
                                            st);
}

// Prefill regime; G as above (G even). The plan (rows, cols, group_m,
// stages): ftcf_gemm_plan.cuh GemmPlan.
int ftcf_quant_matmul_gemm(const void* x, const void* w, const float* scale, const void* gscale,
                           int G, int M, int K, int N, const void* bias, int bias_bf16, int act,
                           void* y, int rows, int cols, int group_m, int stages, void* stream) {
  const ftcf::GemmPlan plan{rows, cols, group_m, stages};
  return (int)ftcf::launch_gemm(G ? ftcf::W_I8G : ftcf::W_I8, x, w, G ? nullptr : scale,
                                G ? gscale : nullptr, G, M, K, N, bias, bias_bf16, act, y, 0,
                                plan, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
