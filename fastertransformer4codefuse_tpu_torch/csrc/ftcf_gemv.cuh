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
//  - group-wise weights (W_I4G: bf16 scales; W_I8G: fp32 scales) apply the
//    scale to a partial sum, as the JAX kernel does (one dot per K group,
//    then the [bm, bn] partial times the group's scale row): a split holds
//    whole groups, a k lane walks a run of consecutive byte rows inside one
//    group (the whole group, or an even part of it, so that the split's runs
//    share out evenly over the 32 k lanes), sums the run into
//    MT x 16 fp32 partials and adds partial * scale into its running sums
//    once; a scale row is read once per run and column tile, not once per
//    weight load. An int4 byte row pair never straddles a group (G is even).
//    The epilogue applies no scale;
//  - the x rows of the block's K range sit in shared memory as fp32, staged
//    with 16-byte loads: the caller's ranges are multiples of 8 K rows (and
//    of G with group scales; ops/quant_matmul.py split_ranges);
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
#include <numeric>

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
  int chunk;  // K rows of a split (the last may be shorter): a multiple of 8, and of G
};

// The 16 group scales of one thread's columns at element ``off`` of the
// [K/G, N] scales (bf16 for int4, fp32 for int8), as fp32.
template <int FMT>
__device__ __forceinline__ void load_group_scales(const void* gscale, size_t off, float* sc) {
  if constexpr (FMT == W_I4G) {
    const uint4* sp =
        reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(gscale) + off);
    const uint4 a = __ldg(sp), b = __ldg(sp + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) bf16x2_to_f32(w[i], sc + 2 * i);
  } else {
    const float4* sp = reinterpret_cast<const float4*>(static_cast<const float*>(gscale) + off);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float4 v = __ldg(sp + t);
      sc[4 * t] = v.x;
      sc[4 * t + 1] = v.y;
      sc[4 * t + 2] = v.z;
      sc[4 * t + 3] = v.w;
    }
  }
}

// Byte rows a k lane walks at once inside a group of ``gb`` byte rows: the
// whole group, halved while the split's ``chunk`` byte rows hold fewer runs
// than the 32 k lanes. Long runs spend the least on starting and ending
// runs (zeroing, scales, the partial's multiply-add).
__device__ __forceinline__ int group_run(int gb, int chunk) {
  int run = gb;
  while ((run & 1) == 0 && run * 32 > chunk) run >>= 1;
  return run;
}

// The group-scaled loop of one thread over byte rows r0 .. r1 (whole groups)
// of its 16 columns n0 .. n0 + 15: k lane kl takes runs kl, kl + 32, ... of
// ``run`` consecutive byte rows inside one group, sums each run into
// partials, then adds partial * scale into acc. int4 values come as 136 + v
// (i4x8_to_f32_plus136): the run also sums each row's x, and the partial
// sheds 136 * sum(x) before its scale.
template <int MT, int FMT>
__device__ __forceinline__ void gemv_group_runs(const GemvSeg& sg, int r0, int r1, int chunk,
                                                int n0, int N, int kl, int chunk_stride,
                                                float (&acc)[MT][16]) {
  constexpr int PACK = KPack<FMT>::value;
  extern __shared__ float smem[];
  const int gb = sg.G / PACK;  // byte rows of a group
  const int run = group_run(gb, chunk);
  const int nrun = (r1 - r0) / run;
  for (int qr = kl; qr < nrun; qr += 32) {
    const int rs = r0 + qr * run;
    float part[MT][16], sx[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      sx[m] = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) part[m][j] = 0.0f;
    }
    const int8_t* wr = sg.w + (size_t)rs * N + n0;
    const float* xr = smem + (rs - r0) * PACK;
#pragma unroll 8
    for (int i = 0; i < run; ++i, wr += N, xr += PACK) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(wr));
      if constexpr (FMT == W_I8G) {
        float f[16];
        i8x4_to_f32(q.x, f);
        i8x4_to_f32(q.y, f + 4);
        i8x4_to_f32(q.z, f + 8);
        i8x4_to_f32(q.w, f + 12);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m * chunk_stride];
#pragma unroll
          for (int j = 0; j < 16; ++j) part[m][j] = fmaf(xv, f[j], part[m][j]);
        }
      } else {
        float lo[16], hi[16];  // K rows 2r and 2r + 1, as 136 + v
        i4x8_to_f32_plus136(q.x, lo, hi);
        i4x8_to_f32_plus136(q.y, lo + 4, hi + 4);
        i4x8_to_f32_plus136(q.z, lo + 8, hi + 8);
        i4x8_to_f32_plus136(q.w, lo + 12, hi + 12);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 xv = *reinterpret_cast<const float2*>(xr + m * chunk_stride);
          sx[m] += xv.x + xv.y;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            part[m][j] = fmaf(xv.y, hi[j], fmaf(xv.x, lo[j], part[m][j]));
        }
      }
    }
    // the scales are read after the run's rows: held across the run, their
    // registers would cost more blocks an SM than their latency does
    float sc[16];
    load_group_scales<FMT>(sg.gscale, (size_t)(rs / gb) * N + n0, sc);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float bias = FMT == W_I4G ? -136.0f * sx[m] : 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(part[m][j] + bias, sc[j], acc[m][j]);
    }
  }
}

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
  const int rows = K / PACK;         // weight byte rows
  const int chunk = sg.chunk / PACK;  // byte rows per split
  const int r0 = s * chunk;
  const int r1 = min(rows, r0 + chunk);
  const int k0 = r0 * PACK;
  const int klen = max(r1 - r0, 0) * PACK;
  const int m0 = blockIdx.z * MT;
  const int tid = threadIdx.x;

  // 8 x values a 16-byte load (k0, klen, K and chunk_stride are multiples of 8)
  const int n8 = klen / 8;
  for (int i = tid; i < MT * n8; i += GEMV_THREADS) {
    const int m = i / n8, c = i - m * n8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (m0 + m < M) u = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + k0) + c);
    float f[8];
    bf16x2_to_f32(u.x, f);
    bf16x2_to_f32(u.y, f + 2);
    bf16x2_to_f32(u.z, f + 4);
    bf16x2_to_f32(u.w, f + 6);
    float4* d = reinterpret_cast<float4*>(smem + m * chunk_stride + 8 * c);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
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

  if constexpr (FMT == W_I4G || FMT == W_I8G) {
    if (n0 < N) gemv_group_runs<MT, FMT>(sg, r0, r1, chunk, n0, N, kl, chunk_stride, acc);
  } else if (n0 < N) {
    const int8_t* wp = w + (size_t)(r0 + kl) * N + n0;
    const size_t wstep = (size_t)32 * N;
#pragma unroll 4
    for (int r = r0 + kl; r < r1; r += 32, wp += wstep) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(wp));
      const float* xs = smem + (r - r0) * PACK;
      if constexpr (FMT == W_I8) {
        float f[16];
        i8x4_to_f32(q.x, f);
        i8x4_to_f32(q.y, f + 4);
        i8x4_to_f32(q.z, f + 8);
        i8x4_to_f32(q.w, f + 12);
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

// Blocks an SM must hold (the register cap of each instance). At MT = 1 the
// loop needs few registers and more resident blocks keep more weight loads
// in flight: four (64 registers), or five (48) for the per-channel formats
// joined over K (K1, K6, K8, K3), each measured faster than the other value
// on its own kernels (K13's per-channel instance is slower at five). Above,
// one block, which leaves ptxas free to schedule the MT x 16 sums (measured
// faster at M = 4 than no hint at all).
__host__ __device__ constexpr int gemv_min_blocks(int mt, int fmt, bool ncat) {
  return mt > 1 ? 1 : (!ncat && (fmt == W_I8 || fmt == W_I4) ? 5 : 4);
}

// Segments joined over K: grid y runs over s1's splits, then s2's.
template <int MT, int FMT>
static __global__ void __launch_bounds__(GEMV_THREADS, gemv_min_blocks(MT, FMT, false))
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
static __global__ void __launch_bounds__(GEMV_THREADS, gemv_min_blocks(MT, FMT, true))
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

// Whether a segment's ranges are ones the loop takes: chunks of whole 8-row
// units (and groups), covering K with no empty split. An empty segment
// (splits 0) passes.
template <int FMT>
static inline bool gemv_ranges_ok(const GemvSeg& s) {
  if (s.splits == 0) return true;
  const int unit = FMT == W_I4G || FMT == W_I8G ? std::lcm(8, s.G) : 8;
  return s.chunk > 0 && s.chunk % unit == 0 && s.K % 8 == 0 &&
         (long long)(s.splits - 1) * s.chunk < s.K && (long long)s.splits * s.chunk >= s.K;
}

// The x staging of GEMV_MT rows of the wider chunk, within 48 KB; 0 when a
// segment's ranges are not ones the loop takes.
template <int FMT>
static inline int gemv_stride(const GemvSeg& s1, const GemvSeg& s2) {
  const int chunk = std::max(s1.splits ? s1.chunk : 0, s2.splits ? s2.chunk : 0);
  if (!gemv_ranges_ok<FMT>(s1) || !gemv_ranges_ok<FMT>(s2) ||
      (size_t)GEMV_MT * chunk * sizeof(float) > 48 * 1024)
    return 0;
  return chunk;
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
  const int chunk = gemv_stride<FMT>(s1, s2);
  if (chunk == 0) return cudaErrorInvalidValue;
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
  const int chunk = gemv_stride<FMT>(s1, s2);
  if (chunk == 0) return cudaErrorInvalidValue;
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
