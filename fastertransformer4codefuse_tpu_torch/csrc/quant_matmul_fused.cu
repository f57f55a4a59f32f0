// K3 and K2: the post-attention decode block of the parallel-residual model.
//
// K3 (fused_proj_down) replaces fastertransformer4codefuse_tpu/ops/
// quant_matmul_fused.py fused_proj_down: out = (x1 @ W1) * s1 + (x2 @ W2) * s2
// + b + residual, one contraction over the concatenated K = [K1 | K2] with a
// scale per segment. Here it is one weight-streaming GEMV launch whose splits
// cover both segments (ftcf_gemv.cuh), plus its split-summing epilogue.
//
// K2 (fused_up_proj_down) replaces fused_up_proj_down, the whole block
// out = x + attn @ Wproj * sp + act(ln2 @ Wup * su + b_up) @ Wdown * sd + b_down.
// On the TPU the FFN hidden h stays in VMEM between grid steps. Hopper blocks
// run in no order and cannot hand h from one to the next, so the op is two
// launches from one wrapper (ops/quant_matmul_fused.py): the up phase is K1's
// (or, int4, K6's) weight-streaming GEMV with the activation, which
// writes bf16 h (M * F * 2 bytes: 160 KB at M = 4 for CodeFuse-13B) to a scratch
// buffer that stays in the 50 MB L2, and the proj + down phase is exactly K3.
// h is rounded to bf16 before the down contraction, as in the Pallas kernel.
// Bound: the (H*F + H*N + F*N) weight bytes, 236 MB per CodeFuse-13B layer in
// int8, 118 MB in int4. Both kernels take per-channel int8 or int4 (bits = 4:
// the packed [K/2, N] payload of quant_matmul_w4.cu, both segments alike);
// the JAX package sends group-wise layers to the unfused K7 instead.
// A single persistent launch with a grid-wide barrier is later work.
#include "ftcf_gemv.cuh"

extern "C" {

// K3: out = x1 @ W1 * s1 + x2 @ W2 * s2 + b + residual; W int8 (bits = 8) or
// packed int4 (bits = 4).
int ftcf_fused_proj_down(int bits, const void* x1, const void* w1, const float* s1, int K1,
                         int splits1, const void* x2, const void* w2, const float* s2, int K2,
                         int splits2, int M, int N, const void* bias, int bias_bf16,
                         const void* residual, void* out, float* ws, void* stream) {
  ftcf::GemvSeg g1{static_cast<const __nv_bfloat16*>(x1), static_cast<const int8_t*>(w1), s1,
                   nullptr, K1, 0, splits1};
  ftcf::GemvSeg g2{static_cast<const __nv_bfloat16*>(x2), static_cast<const int8_t*>(w2), s2,
                   nullptr, K2, 0, splits2};
  const auto* res = static_cast<const __nv_bfloat16*>(residual);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return (int)ftcf::launch_gemv<ftcf::W_I4>(g1, g2, M, N, bias, bias_bf16, ftcf::ACT_NONE, res,
                                              out, 0, ws, st);
  return (int)ftcf::launch_gemv<ftcf::W_I8>(g1, g2, M, N, bias, bias_bf16, ftcf::ACT_NONE, res,
                                            out, 0, ws, st);
}

}  // extern "C"
