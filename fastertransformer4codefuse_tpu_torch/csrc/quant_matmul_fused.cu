// K3, K2 and K13: the fused GEMMs of the parallel-residual decode block.
//
// K3 (fused_proj_down) replaces fastertransformer4codefuse_tpu/ops/
// quant_matmul_fused.py fused_proj_down: out = (x1 @ W1) * s1 + (x2 @ W2) * s2
// + b + residual, one contraction over the concatenated K = [K1 | K2] with a
// scale per segment (or, group-wise, one per (K group, column)). Here it is
// one weight-streaming GEMV launch whose splits cover both segments
// (ftcf_gemv.cuh), plus its split-summing epilogue.
//
// K2 (fused_up_proj_down) replaces fused_up_proj_down, the whole block
// out = x + attn @ Wproj * sp + act(ln2 @ Wup * su + b_up) @ Wdown * sd + b_down.
// On the TPU the FFN hidden h stays in VMEM between grid steps. Hopper blocks
// run in no order and cannot hand h from one to the next, so the op is two
// launches from one wrapper (ops/quant_matmul_fused.py): the up phase is the
// weight-streaming GEMV with the activation (ftcf_gemv_ncat with one
// segment), which writes bf16 h (M * F * 2 bytes: 160 KB at M = 4 for
// CodeFuse-13B) to a scratch buffer that stays in the 50 MB L2, and the proj
// + down phase is exactly K3. h is rounded to bf16 before the down
// contraction, as in the Pallas kernel. Bound: the (H*F + H*N + F*N) weight
// bytes, 236 MB per CodeFuse-13B layer in int8, 118 MB in int4 (plus the
// group scales).
//
// K13 (fused_qkv_up) replaces fused_qkv_up: [x1 @ W1 * s1 + b1 | act2(x2 @ W2
// * s2 + b2)] over concatenated output columns, x1 = ln1(x) feeding the QKV
// columns and x2 = ln2(x) the up columns. The Pallas kernel writes one
// [M, N1 + N2] array that its caller slices; here each segment writes its own
// buffer, so the up half (h) is the contiguous [M, F] that K3 then reads.
// Decode widths (M <= 32) run the GEMV with the segments joined over N;
// prefill widths the TMA + wgmma GEMM of ftcf_gemm.cuh with x (its tensor
// map), weight, scales, bias and activation chosen by the column tile. Each segment's
// arithmetic is K1's (K6's, K7's) on its own: the same splits, tiles and
// summation order.
//
// Weight formats (fmt, ftcf_common.cuh WFmt): int8 and int4 with fp32
// per-channel scales, int4 with bf16 or fp32 group scales, and int8 with fp32
// group scales (the JAX package's int8 group-wise cases).
#include "ftcf_gemm_plan.cuh"
#include "ftcf_gemv.cuh"

namespace {

using ftcf::GemvOut;
using ftcf::GemvSeg;

bool grouped(int fmt) {
  return fmt == ftcf::W_I4G || fmt == ftcf::W_I8G || fmt == ftcf::W_I4GF;
}

// scales: per-channel fp32 [N], or with a group format the [K/G, N] group
// scales (bf16 for W_I4G, fp32 for W_I8G and W_I4GF)
GemvSeg gemv_seg(int fmt, int G, const void* x, const void* w, const void* scales, int K,
                 int splits, int chunk) {
  return GemvSeg{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                 grouped(fmt) ? nullptr : static_cast<const float*>(scales),
                 grouped(fmt) ? scales : nullptr, K, G, splits, chunk};
}

}  // namespace

extern "C" {

// K3: out = x1 @ W1 * s1 + x2 @ W2 * s2 + b + residual; both weights of
// format fmt, K_i in splits_i ranges of chunk_i rows. ws holds (splits1 +
// splits2) * M * N floats.
int ftcf_fused_proj_down(int fmt, int G, const void* x1, const void* w1, const void* s1, int K1,
                         int splits1, int chunk1, const void* x2, const void* w2, const void* s2,
                         int K2, int splits2, int chunk2, int M, int N, const void* bias,
                         int bias_bf16, const void* residual, void* out, float* ws,
                         void* stream) {
  const GemvSeg g1 = gemv_seg(fmt, G, x1, w1, s1, K1, splits1, chunk1);
  const GemvSeg g2 = gemv_seg(fmt, G, x2, w2, s2, K2, splits2, chunk2);
  const auto* res = static_cast<const __nv_bfloat16*>(residual);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int none = ftcf::ACT_NONE;
  switch (fmt) {
    case ftcf::W_I8:
      return (int)ftcf::launch_gemv<ftcf::W_I8>(g1, g2, M, N, bias, bias_bf16, none, res, out, 0,
                                                ws, st);
    case ftcf::W_I4:
      return (int)ftcf::launch_gemv<ftcf::W_I4>(g1, g2, M, N, bias, bias_bf16, none, res, out, 0,
                                                ws, st);
    case ftcf::W_I4G:
      return (int)ftcf::launch_gemv<ftcf::W_I4G>(g1, g2, M, N, bias, bias_bf16, none, res, out,
                                                 0, ws, st);
    case ftcf::W_I8G:
      return (int)ftcf::launch_gemv<ftcf::W_I8G>(g1, g2, M, N, bias, bias_bf16, none, res, out,
                                                 0, ws, st);
    case ftcf::W_I4GF:
      return (int)ftcf::launch_gemv<ftcf::W_I4GF>(g1, g2, M, N, bias, bias_bf16, none, res, out,
                                                  0, ws, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K13 at decode widths (and K2's up phase, with N2 = 0): y1 = act1(x1 @ W1 *
// s1 + b1) [M, N1], y2 = act2(x2 @ W2 * s2 + b2) [M, N2], bf16; both weights
// [K(/2), N_i] of format fmt, K in splits_i ranges of chunk_i rows. ws1 / ws2
// hold splits_i * M * N_i floats.
int ftcf_gemv_ncat(int fmt, int G, int M, int K, const void* x1, const void* w1,
                   const void* s1, int N1, int splits1, int chunk1, const void* b1, int b1_bf16,
                   int act1, void* y1, float* ws1, const void* x2, const void* w2,
                   const void* s2, int N2, int splits2, int chunk2, const void* b2, int b2_bf16,
                   int act2, void* y2, float* ws2, void* stream) {
  const GemvSeg g1 = gemv_seg(fmt, G, x1, w1, s1, K, splits1, chunk1);
  const GemvSeg g2 = gemv_seg(fmt, G, x2, w2, s2, K, splits2, chunk2);
  const GemvOut o1{ws1, splits1, N1, g1.scale, b1, b1_bf16, act1,
                   static_cast<__nv_bfloat16*>(y1)};
  const GemvOut o2{ws2, splits2, N2, g2.scale, b2, b2_bf16, act2,
                   static_cast<__nv_bfloat16*>(y2)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case ftcf::W_I8:
      return (int)ftcf::launch_gemv_ncat<ftcf::W_I8>(g1, g2, o1, o2, M, st);
    case ftcf::W_I4:
      return (int)ftcf::launch_gemv_ncat<ftcf::W_I4>(g1, g2, o1, o2, M, st);
    case ftcf::W_I4G:
      return (int)ftcf::launch_gemv_ncat<ftcf::W_I4G>(g1, g2, o1, o2, M, st);
    case ftcf::W_I8G:
      return (int)ftcf::launch_gemv_ncat<ftcf::W_I8G>(g1, g2, o1, o2, M, st);
    case ftcf::W_I4GF:
      return (int)ftcf::launch_gemv_ncat<ftcf::W_I4GF>(g1, g2, o1, o2, M, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K13 at prefill widths: the same two outputs from one GEMM launch
// (int8 or int4, per-channel or group scales), under the plan (rows, cols,
// group_m, stages): ftcf_gemm_plan.cuh GemmPlan.
int ftcf_gemm_ncat(int fmt, int G, int M, int K, const void* x1, const void* w1, const void* s1,
                   int N1, const void* b1, int b1_bf16, int act1, void* y1, const void* x2,
                   const void* w2, const void* s2, int N2, const void* b2, int b2_bf16, int act2,
                   void* y2, int rows, int cols, int group_m, int stages, void* stream) {
  const bool g = grouped(fmt);
  const ftcf::GemmSeg g1{static_cast<const __nv_bfloat16*>(x1), static_cast<const int8_t*>(w1),
                         g ? nullptr : static_cast<const float*>(s1), g ? s1 : nullptr,
                         b1, b1_bf16, act1, y1, N1};
  const ftcf::GemmSeg g2{static_cast<const __nv_bfloat16*>(x2), static_cast<const int8_t*>(w2),
                         g ? nullptr : static_cast<const float*>(s2), g ? s2 : nullptr,
                         b2, b2_bf16, act2, y2, N2};
  const ftcf::GemmPlan plan{rows, cols, group_m, stages};
  return (int)ftcf::launch_gemm_ncat(fmt, g1, g2, G, 0, M, K, plan,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
