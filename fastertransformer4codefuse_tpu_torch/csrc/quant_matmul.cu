// K1: weight-only int8 matmul with the scale, bias and activation applied in
// the epilogue, y = act(x @ W * s + b); x bf16 [M, K], W int8 [K, N], s fp32
// [N], y bf16 [M, N], fp32 accumulation.
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
#include "ftcf_gemm.cuh"
#include "ftcf_gemv.cuh"

extern "C" {

// Decode regime: K in `splits` ranges of `chunk` rows (ops/quant_matmul.py
// split_ranges); ws holds splits * M * N floats (allocated by the caller).
int ftcf_quant_matmul_gemv(const void* x, const void* w, const float* scale, int M, int K, int N,
                           int splits, int chunk, const void* bias, int bias_bf16, int act,
                           void* y, float* ws, void* stream) {
  ftcf::GemvSeg s1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
                   nullptr, K, 0, splits, chunk};
  ftcf::GemvSeg s2{nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
  return (int)ftcf::launch_gemv<ftcf::W_I8>(s1, s2, M, N, bias, bias_bf16, act, nullptr, y, 0,
                                            ws, static_cast<cudaStream_t>(stream));
}

// Prefill regime.
int ftcf_quant_matmul_gemm(const void* x, const void* w, const float* scale, int M, int K, int N,
                           const void* bias, int bias_bf16, int act, void* y, void* stream) {
  return (int)ftcf::launch_gemm<ftcf::W_I8>(x, w, scale, nullptr, 0, M, K, N, bias, bias_bf16,
                                            act, y, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
