// Weight-streaming GEMV machinery shared by the decode paths of K1
// (quant_matmul.cu), K6/K7/K8 (quant_matmul_w4.cu) and the fused decode
// kernels K2/K3/K13 (quant_matmul_fused.cu).
//
// Two ways to join two weight segments in one launch:
//  - over K (K3): out[m, n] = act(sum_seg (x_seg[m, :] @ W_seg[:, n]) * s_seg[n]
//    + bias[n]) + residual[m, n], one output;
//  - over N (K13): out1 = act1(x1 @ W1 * s1 + b1), out2 = act2(x2 @ W2 * s2 +
//    b2), two outputs; a column tile belongs to one segment, which gives it
//    its x, weight, scales, bias, activation and output buffer.
//
// At decode widths (M <= 32) the whole cost is streaming the weight from
// device memory once: K*N bytes for int8, K*N/2 for int4, at 3.35 TB/s on an
// H100 SXM, against M*K*N multiply-adds. Design:
//  - a block owns 128 output columns and one K range ("split") of one segment;
//    each of its 256 threads loads 16 contiguous weight bytes along N per
//    byte row (one 16-byte load; 8 threads cover a 128-byte line, a warp 4
//    rows) and keeps MT x 16 fp32 sums. An int8 byte row is one K row; an
//    int4 byte row holds two (the low nibbles the even row, the high nibbles
//    the odd one), so each int4 load feeds two x values per row of sums and
//    split boundaries fall on even K;
//  - group-wise weights (W_I4G: bf16 scales; W_I8G: fp32 scales) multiply each
//    dequantized weight by its group's scale before the FMA (one scale load
//    per weight load; an int4 byte row pair never straddles a group since G is
//    even), so the splits need not align with groups and the epilogue applies
//    no scale;
//  - the x rows of the block's K range sit in shared memory as fp32;
//  - there are enough splits that the grid holds about four blocks per SM
//    (the H100 needs ~2 MB in flight to cover memory latency); each split's
//    sums go to an fp32 workspace, and a second small kernel adds the splits
//    in a fixed order (deterministic, no atomics), applies per-segment
//    scales, bias, activation and residual, and writes bf16 or fp32;
//  - a block keeps MT = min(M, 4) rows of sums (M = 3 pads to 4); more than
//    4 rows take more blocks along grid z, which re-read the weight (decode
//    batches of the slice are 1-4 rows).
#pragma once

#include <algorithm>

#include "ftcf_common.cuh"

namespace ftcf {

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_COLS = 128;  // 8 column threads x 16 columns
constexpr int GEMV_MT = 4;      // rows of x per block

struct GemvSeg {
  const __nv_bfloat16* x;  // [M, K] row-major
  const int8_t* w;         // [K, N] int8 or [K/2, N] packed int4, row-major
  const float* scale;      // [N] per-channel (nullptr with group scales)
  const void* gscale;      // [K/G, N] group scales: bf16 (W_I4G) or fp32 (W_I8G)
  int K;
  int G;
  int splits;
};

// One block's partial sums: split ``s`` of segment ``sg``, column tile
// ``tile`` of an N-wide output; the sums go to ``ws_split`` [M, N] (this
// split's plane of the workspace).
template <int MT, int FMT>
__device__ __forceinline__ void gemv_block(const GemvSeg& sg, int s, int M, int N, int tile,
                                           int chunk_stride, float* __restrict__ ws_split) {
  constexpr int PACK = KPack<FMT>::value;
  extern __shared__ float smem[];
  const __nv_bfloat16* __restrict__ x = sg.x;
  const int8_t* __restrict__ w = sg.w;
  const int K = sg.K;
  const int G = sg.G;
  const int rows = K / PACK;                         // weight byte rows
  const int chunk = (rows + sg.splits - 1) / sg.splits;  // byte rows per split
  const int r0 = s * chunk;
  const int r1 = min(rows, r0 + chunk);
  const int k0 = r0 * PACK;
  const int klen = max(r1 - r0, 0) * PACK;
  const int m0 = blockIdx.z * MT;
  const int tid = threadIdx.x;

  for (int i = tid; i < MT * klen; i += GEMV_THREADS) {
    const int m = i / klen, kk = i - m * klen;
    float v = 0.0f;
    if (m0 + m < M) v = __bfloat162float(x[(size_t)(m0 + m) * K + k0 + kk]);
    smem[m * chunk_stride + kk] = v;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int nt = lane & 7;                  // column thread
  const int kl = warp * 4 + (lane >> 3);    // k lane, 0..31
  const int n0 = tile * GEMV_COLS + nt * 16;

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.0f;

  if (n0 < N) {
    const int8_t* wp = w + (size_t)(r0 + kl) * N + n0;
    const size_t wstep = (size_t)32 * N;
#pragma unroll 4
    for (int r = r0 + kl; r < r1; r += 32, wp += wstep) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(wp));
      const float* xs = smem + (r - r0) * PACK;
      if constexpr (FMT == W_I8 || FMT == W_I8G) {
        float f[16];
        i8x4_to_f32(q.x, f);
        i8x4_to_f32(q.y, f + 4);
        i8x4_to_f32(q.z, f + 8);
        i8x4_to_f32(q.w, f + 12);
        if constexpr (FMT == W_I8G) {
          const float4* sp = reinterpret_cast<const float4*>(
              static_cast<const float*>(sg.gscale) + (size_t)(r / G) * N + n0);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float4 sc = __ldg(sp + t);
            f[4 * t] *= sc.x;
            f[4 * t + 1] *= sc.y;
            f[4 * t + 2] *= sc.z;
            f[4 * t + 3] *= sc.w;
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * chunk_stride];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv, f[j], acc[m][j]);
        }
      } else {
        float lo[16], hi[16];  // K rows 2r and 2r + 1
        i4x8_to_f32(q.x, lo, hi);
        i4x8_to_f32(q.y, lo + 4, hi + 4);
        i4x8_to_f32(q.z, lo + 8, hi + 8);
        i4x8_to_f32(q.w, lo + 12, hi + 12);
        if constexpr (FMT == W_I4G) {
          const uint4* sp = reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(sg.gscale) + (size_t)(2 * r / G) * N + n0);
          const uint4 sa = __ldg(sp), sb = __ldg(sp + 1);
          float sc[16];
          bf16x2_to_f32(sa.x, sc);
          bf16x2_to_f32(sa.y, sc + 2);
          bf16x2_to_f32(sa.z, sc + 4);
          bf16x2_to_f32(sa.w, sc + 6);
          bf16x2_to_f32(sb.x, sc + 8);
          bf16x2_to_f32(sb.y, sc + 10);
          bf16x2_to_f32(sb.z, sc + 12);
          bf16x2_to_f32(sb.w, sc + 14);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            lo[j] *= sc[j];
            hi[j] *= sc[j];
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xa = xs[m * chunk_stride], xb = xs[m * chunk_stride + 1];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xb, hi[j], fmaf(xa, lo[j], acc[m][j]));
        }
      }
    }
  }

  // the 4 k lanes of a warp differ in lane bits 3 and 4
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  __syncthreads();  // x staging is dead; reuse smem for the cross-warp sum
  float* red = smem;  // [8 warps][MT][128]
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[(warp * MT + m) * GEMV_COLS + nt * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < MT * GEMV_COLS; i += GEMV_THREADS) {
    const int m = i / GEMV_COLS, c = i - m * GEMV_COLS;
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < GEMV_THREADS / 32; ++wi) v += red[(wi * MT + m) * GEMV_COLS + c];
    const int n = tile * GEMV_COLS + c;
    if (m0 + m < M && n < N) ws_split[(size_t)(m0 + m) * N + n] = v;
  }
}

// Segments joined over K: grid y runs over s1's splits, then s2's.
template <int MT, int FMT>
static __global__ void __launch_bounds__(GEMV_THREADS)
gemv_partial_kernel(GemvSeg s1, GemvSeg s2, int M, int N, int chunk_stride,
                    float* __restrict__ ws) {
  const int split = blockIdx.y;
  const bool second = split >= s1.splits;
  const GemvSeg sg = second ? s2 : s1;
  gemv_block<MT, FMT>(sg, second ? split - s1.splits : split, M, N, blockIdx.x, chunk_stride,
                      ws + (size_t)split * M * N);
}

// Segments joined over N: grid x runs over s1's column tiles (N1 columns),
// then s2's (N2); grid y over the splits of the wider-split segment (a block
// past its own segment's splits exits). Each segment's splits fill its own
// workspace, ws1 [s1.splits, M, N1] and ws2 [s2.splits, M, N2].
template <int MT, int FMT>
static __global__ void __launch_bounds__(GEMV_THREADS)
gemv_ncat_partial_kernel(GemvSeg s1, GemvSeg s2, int N1, int N2, int M, int chunk_stride,
                         float* __restrict__ ws1, float* __restrict__ ws2) {
  const int t1 = (N1 + GEMV_COLS - 1) / GEMV_COLS;
  const bool second = (int)blockIdx.x >= t1;
  const GemvSeg sg = second ? s2 : s1;
  const int split = blockIdx.y;
  if (split >= sg.splits) return;  // uniform over the block
  const int N = second ? N2 : N1;
  gemv_block<MT, FMT>(sg, split, M, N, second ? blockIdx.x - t1 : blockIdx.x, chunk_stride,
                      (second ? ws2 : ws1) + (size_t)split * M * N);
}

// Sums the splits in a fixed order, then scale (none for group scales), bias,
// activation and residual; y is bf16, or fp32 with out_f32.
static __global__ void gemv_epilogue_kernel(const float* __restrict__ ws, int splits1,
                                            int splits2, int M, int N,
                                            const float* __restrict__ scale1,
                                            const float* __restrict__ scale2, const void* bias,
                                            int bias_bf16, int act,
                                            const __nv_bfloat16* __restrict__ residual, void* y,
                                            int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int n = (int)(i % N);
  const size_t plane = (size_t)M * N;
  float a1 = 0.0f;
  for (int s = 0; s < splits1; ++s) a1 += ws[s * plane + i];
  // __fmul_rn: no multiply-add contraction with the bias, so a segment of the
  // N-joined epilogue below rounds exactly as this one does
  float v = scale1 != nullptr ? __fmul_rn(a1, scale1[n]) : a1;
  if (splits2 > 0) {
    float a2 = 0.0f;
    for (int s = splits1; s < splits1 + splits2; ++s) a2 += ws[s * plane + i];
    v += scale2 != nullptr ? __fmul_rn(a2, scale2[n]) : a2;
  }
  v = apply_act(v + load_bias(bias, bias_bf16, n), act);
  if (residual != nullptr) v += __bfloat162float(residual[i]);
  if (out_f32)
    static_cast<float*>(y)[i] = v;
  else
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
}

// The epilogue of one N-joined segment: an output element's value, as
// gemv_epilogue_kernel computes it for one segment and no residual.
struct GemvOut {
  float* ws;           // [splits, M, N]
  int splits;
  int N;
  const float* scale;  // [N] or nullptr
  const void* bias;
  int bias_bf16;
  int act;
  __nv_bfloat16* y;    // [M, N]
};

static __global__ void gemv_ncat_epilogue_kernel(GemvOut o1, GemvOut o2, int M) {
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n1 = (size_t)M * o1.N;
  if (i0 >= n1 + (size_t)M * o2.N) return;
  const bool second = i0 >= n1;
  const GemvOut o = second ? o2 : o1;
  const size_t i = second ? i0 - n1 : i0;
  const int n = (int)(i % o.N);
  const size_t plane = (size_t)M * o.N;
  float a = 0.0f;
  for (int s = 0; s < o.splits; ++s) a += o.ws[s * plane + i];
  float v = o.scale != nullptr ? __fmul_rn(a, o.scale[n]) : a;
  v = apply_act(v + load_bias(o.bias, o.bias_bf16, n), o.act);
  o.y[i] = __float2bfloat16(v);
}

// x elements that one split of a segment covers (a whole number of byte rows).
template <int FMT>
static inline int gemv_chunk(const GemvSeg& s) {
  constexpr int PACK = KPack<FMT>::value;
  return s.splits ? PACK * ((s.K / PACK + s.splits - 1) / s.splits) : 0;
}

template <int MT>
static inline size_t gemv_smem(int chunk) {
  return std::max((size_t)MT * chunk, (size_t)8 * MT * GEMV_COLS) * sizeof(float);
}

template <int MT, int FMT>
static void launch_partial(GemvSeg s1, GemvSeg s2, int M, int N, int chunk, float* ws,
                           cudaStream_t stream) {
  const dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, s1.splits + s2.splits, (M + MT - 1) / MT);
  gemv_partial_kernel<MT, FMT>
      <<<grid, GEMV_THREADS, gemv_smem<MT>(chunk), stream>>>(s1, s2, M, N, chunk, ws);
}

// Both segments share one weight format FMT.
template <int FMT>
static cudaError_t launch_gemv(GemvSeg s1, GemvSeg s2, int M, int N, const void* bias,
                               int bias_bf16, int act, const __nv_bfloat16* residual, void* y,
                               int out_f32, float* ws, cudaStream_t stream) {
  const int chunk = std::max(gemv_chunk<FMT>(s1), gemv_chunk<FMT>(s2));
  if ((size_t)GEMV_MT * chunk * sizeof(float) > 48 * 1024) return cudaErrorInvalidValue;
  // as many accumulator rows as x has, up to MT: no multiply-adds on padding
  if (M == 1)
    launch_partial<1, FMT>(s1, s2, M, N, chunk, ws, stream);
  else if (M == 2)
    launch_partial<2, FMT>(s1, s2, M, N, chunk, ws, stream);
  else
    launch_partial<GEMV_MT, FMT>(s1, s2, M, N, chunk, ws, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  gemv_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ws, s1.splits, s2.splits, M, N, s1.scale, s2.scale, bias, bias_bf16, act, residual, y,
      out_f32);
  return cudaGetLastError();
}

template <int MT, int FMT>
static void launch_ncat_partial(GemvSeg s1, GemvSeg s2, int N1, int N2, int M, int chunk,
                                float* ws1, float* ws2, cudaStream_t stream) {
  const int tiles = (N1 + GEMV_COLS - 1) / GEMV_COLS + (N2 + GEMV_COLS - 1) / GEMV_COLS;
  const dim3 grid(tiles, std::max(s1.splits, s2.splits), (M + MT - 1) / MT);
  gemv_ncat_partial_kernel<MT, FMT><<<grid, GEMV_THREADS, gemv_smem<MT>(chunk), stream>>>(
      s1, s2, N1, N2, M, chunk, ws1, ws2);
}

// Two segments joined over N into two bf16 outputs; o1.ws / o2.ws are the
// segments' workspaces (splits x M x N floats each). An empty second segment
// (N2 = 0, splits 0) makes this one plain GEMV of any format.
template <int FMT>
static cudaError_t launch_gemv_ncat(GemvSeg s1, GemvSeg s2, GemvOut o1, GemvOut o2, int M,
                                    cudaStream_t stream) {
  const int chunk = std::max(gemv_chunk<FMT>(s1), gemv_chunk<FMT>(s2));
  if ((size_t)GEMV_MT * chunk * sizeof(float) > 48 * 1024) return cudaErrorInvalidValue;
  if (M == 1)
    launch_ncat_partial<1, FMT>(s1, s2, o1.N, o2.N, M, chunk, o1.ws, o2.ws, stream);
  else if (M == 2)
    launch_ncat_partial<2, FMT>(s1, s2, o1.N, o2.N, M, chunk, o1.ws, o2.ws, stream);
  else
    launch_ncat_partial<GEMV_MT, FMT>(s1, s2, o1.N, o2.N, M, chunk, o1.ws, o2.ws, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * (o1.N + o2.N);
  gemv_ncat_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(o1, o2, M);
  return cudaGetLastError();
}

}  // namespace ftcf
