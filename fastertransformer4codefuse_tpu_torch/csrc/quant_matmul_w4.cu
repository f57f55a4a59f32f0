// K6, K7 and K8: W4A16 weight-only matmuls, y = act(x @ dequant(P) + b);
// x bf16 [M, K], P int8 [K/2, N] holding signed int4 row pairs along K (row
// 2i in the low nibble of byte row i, row 2i+1 in the high nibble), fp32
// accumulation.
//
// Replaces fastertransformer4codefuse_tpu/ops/quant_matmul_w4.py:
//  - K6 quant_matmul_w4_pallas_stacked: fp32 per-channel scales [N] applied
//    in the epilogue, bias and activation after them, bf16 out;
//  - K7 quant_matmul_w4_group_stacked: group scales [K/G, N] inside the
//    contraction (an epilogue multiply would be wrong across groups), bf16 by
//    default or fp32 (the JAX package's FTCF_GSCALE_BF16=0), bias and
//    activation in the epilogue, bf16 out;
//  - K8 quant_matmul_w4_pallas, as the JAX package uses it for the int4 LM
//    head [H/2, V_pad]: K6 with fp32 out and no bias.
// On the TPU the packed tile is DMA'd to VMEM and unpacked by an int8 -> int4
// bitcast before the MXU. On the H100 the decode widths (M <= 32) are bound by
// the K*N/2 weight bytes: the weight-streaming GEMV of ftcf_gemv.cuh with an
// int4 payload (one byte is a K row pair of one column: at M = 1 an fp32
// FMA loop, at 2-32 rows a tensor-core A fragment register as it stands;
// with group scales, as the JAX kernel applies them to each group's partial
// sum, a run of K rows inside one group sums into a partial that is
// multiplied by the group's scale row once, and a split holds whole groups). Prefill
// widths are bound by the tensor cores: the TMA + wgmma GEMM of
// ftcf_gemm.cuh, whose consumer warps unpack their channels of each raw
// packed tile into the products' A fragments, in registers (group scales,
// which arrive by TMA beside it, folded into the bf16 weight), while the
// previous tile's products run.
#include "ftcf_gemm_plan.cuh"
#include "ftcf_gemv.cuh"

extern "C" {

// Decode regime. gscale == nullptr: per-channel scales in `scale` (K6, K8);
// else group scales [K/G, N], bf16 or (gscale_f32) fp32, and scale ==
// nullptr (K7). K in `splits` ranges of `chunk` rows; ws holds splits * M * N
// floats (allocated by the caller).
int ftcf_quant_matmul_w4_gemv(const void* x, const void* w, const float* scale,
                              const void* gscale, int gscale_f32, int G, int M, int K, int N,
                              int splits, int chunk, const void* bias, int bias_bf16, int act,
                              void* y, int out_f32, float* ws, void* stream) {
  ftcf::GemvSeg s1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
                   gscale, K, G, splits, chunk};
  ftcf::GemvSeg s2{nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gscale != nullptr && gscale_f32)
    return (int)ftcf::launch_gemv<ftcf::W_I4GF>(s1, s2, M, N, bias, bias_bf16, act, nullptr, y,
                                                out_f32, ws, st);
  if (gscale != nullptr)
    return (int)ftcf::launch_gemv<ftcf::W_I4G>(s1, s2, M, N, bias, bias_bf16, act, nullptr, y,
                                               out_f32, ws, st);
  return (int)ftcf::launch_gemv<ftcf::W_I4>(s1, s2, M, N, bias, bias_bf16, act, nullptr, y,
                                            out_f32, ws, st);
}

// Prefill regime; the same operands, and the plan (rows, cols, group_m,
// stages): ftcf_gemm_plan.cuh GemmPlan.
int ftcf_quant_matmul_w4_gemm(const void* x, const void* w, const float* scale,
                              const void* gscale, int gscale_f32, int G, int M, int K, int N,
                              const void* bias, int bias_bf16, int act, void* y, int out_f32,
                              int rows, int cols, int group_m, int stages, void* stream) {
  const ftcf::GemmPlan plan{rows, cols, group_m, stages};
  const int fmt = gscale == nullptr ? ftcf::W_I4 : gscale_f32 ? ftcf::W_I4GF : ftcf::W_I4G;
  return (int)ftcf::launch_gemm(fmt, x, w, gscale == nullptr ? scale : nullptr, gscale, G, M, K,
                                N, bias, bias_bf16, act, y, out_f32, plan,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
