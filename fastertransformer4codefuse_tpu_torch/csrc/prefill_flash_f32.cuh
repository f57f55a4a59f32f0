// The fp32 instances of K5 (causal prefill attention over the prompt's own
// K/V), the forward with its log-sum-exp and the two backward kernels, for
// training: the operand layout they share, and the forward's tiles and
// loads. The entry points are prefill_flash_f32.cu (forward) and
// prefill_flash_bwd.cu (dK/dV and dQ, whose tiles, bound and design are
// there), one source each, so their instances compile in parallel.
//
// Replaces the fp32 use of the library Pallas flash_attention that
// fastertransformer4codefuse_tpu/ops/attention.py prefill_attention_flash
// calls: its forward (_flash_attention_impl, which also keeps the row
// statistics l and m for the backward), and its custom_vjp backward,
// _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
// flash_attention.py:1121) and _flash_attention_bwd_dq (:1456), reached
// through jax.value_and_grad in tools/train_proxy.py. As there, di =
// rowsum(dO * O) is computed outside the kernels (ops/attention.py).
//
// q/dO/out/dq [B, S, nKV * gq, dh], k/v/dk/dv [B, S, nKV, dh] fp32, lens [B]
// int32, lse and delta [B, nKV * gq, S] fp32. Query i of row b attends keys
// 0 .. min(i, lens[b] - 1), as the bf16 K5 (prefill_flash.cuh): rows at or
// past the length attend the valid prefix. The training path is held to
// fp32: no one-term TF32 (which keeps about three digits). The forward's
// products are fp32 FMA; the backward's are 3xTF32 on the tensor cores
// (ftcf_mma.cuh).
//
// Bound: operations. At CodeFuse-13B (40 heads x 128, S = 2048) the forward
// does 4 * S^2 / 2 * dh * heads = 43 GFLOP of causal work against 168 MB of
// q, k, v and out: ~256 FLOP a byte, far above the card's balance, so the
// rate of fp32-accurate products bounds it. That is 3xTF32 on the tensor
// cores, 495 / 3 = 165 TFLOP/s (0.26 ms), though this forward still runs on
// the FMA units (67 TFLOP/s, 0.64 ms): its redesign is the next step.
//
// The forward's design (a simple, correct body first): a block of 256
// threads takes one tile of T = 64 rows (32 at dh 256) against key tiles of
// T keys, all held in shared memory, rows padded to dh + 1 floats so that
// the 16 threads reading 16 different rows at one column hit 16 banks. The
// 16 x 16 threads each hold a (T / 16) x (T / 16) patch of the score block,
// its rows owned by the 16 lanes of a half warp (row max and sum by
// shuffles), and a (T / 16) x (dh / 16) patch of the output, columns d =
// lane + 16 e. Exponentials are exp2 with log2 e folded into the scale. No
// atomics, no split over keys: two calls give equal bytes.
#pragma once

#include "ftcf_common.cuh"

namespace ftcf {
namespace f32attn {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int T = DH == 256 ? 32 : 64;  // rows of a query tile, keys of a key tile
  static constexpr int R = T / 16;               // score rows (or keys) a thread holds
  static constexpr int C = T / 16;               // score columns a thread holds
  static constexpr int D = DH / 16;              // head-dim columns a thread holds
  static constexpr int LD = DH + 1;              // padded row stride in shared memory
  static constexpr int PLD = T + 1;              // padded stride of a score block
  static constexpr size_t ROWS = (size_t)T * LD * sizeof(float);  // one tile of rows
  static constexpr size_t SCORES = (size_t)T * PLD * sizeof(float);
};

// Rows [r0, r0 + T) of one head (row r at src + r * stride floats) into
// shared memory with row stride LD; rows at or past `limit` are zero.
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride, int r0,
                                          int limit) {
  using TL = Tile<DH>;
  constexpr int V = DH / 4;  // float4 a thread
  for (int idx = threadIdx.x; idx < TL::T * V; idx += THREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * stride + c);
    float* d = dst + r * TL::LD + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// Max and sum over the 16 lanes of a half warp (the lanes that share a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[a][c] += sum_d A[ra + a][d] * B[cb + 16 c][d] over shared tiles of
// stride LD: rows ra.. of A (one address a half warp: a broadcast), rows
// cb + 16 c of B (16 lanes, 16 rows, 16 banks).
template <int DH>
__device__ __forceinline__ void dot_rows(float (&acc)[Tile<DH>::R][Tile<DH>::C], const float* A,
                                         int ra, const float* B, int cb) {
  using TL = Tile<DH>;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float x[TL::R], y[TL::C];
#pragma unroll
    for (int a = 0; a < TL::R; ++a) x[a] = A[(ra + a) * TL::LD + d];
#pragma unroll
    for (int c = 0; c < TL::C; ++c) y[c] = B[(cb + 16 * c) * TL::LD + d];
#pragma unroll
    for (int a = 0; a < TL::R; ++a)
#pragma unroll
      for (int c = 0; c < TL::C; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

// acc[a][e] += sum_j W[ra + a][j] * M[j][lane + 16 e]: a score block W
// (stride PLD) times a tile of rows M (stride LD).
template <int DH>
__device__ __forceinline__ void scores_times_rows(float (&acc)[Tile<DH>::R][Tile<DH>::D],
                                                  const float* W, int ra, const float* M,
                                                  int lane) {
  using TL = Tile<DH>;
#pragma unroll 2
  for (int j = 0; j < TL::T; ++j) {
    float m[TL::D];
#pragma unroll
    for (int e = 0; e < TL::D; ++e) m[e] = M[j * TL::LD + lane + 16 * e];
#pragma unroll
    for (int a = 0; a < TL::R; ++a) {
      const float w = W[(ra + a) * TL::PLD + j];
#pragma unroll
      for (int e = 0; e < TL::D; ++e) acc[a][e] = fmaf(w, m[e], acc[a][e]);
    }
  }
}

template <typename Kern>
static cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace f32attn
}  // namespace ftcf
