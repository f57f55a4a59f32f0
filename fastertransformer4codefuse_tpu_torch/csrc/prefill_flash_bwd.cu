// K5's backward in fp32: the C entry points of the dK/dV and dQ kernels, the
// two kernels of the library flash_attention's backward,
// _flash_attention_bwd_dkv (jax/experimental/pallas/ops/tpu/
// flash_attention.py:1121) and _flash_attention_bwd_dq (:1456), reached
// through jax.value_and_grad in tools/train_proxy.py. Both recompute
// P = exp(scale * Q K^T - lse) under the causal / length mask from the
// forward's lse (prefill_flash_f32.cu) and take delta = rowsum(dO * O),
// computed outside as the library computes di; dS = P * (dP - delta) with
// dP = dO V^T. dK/dV takes a key tile: dV = P^T dO, dK = scale * dS^T Q,
// summed over the g query heads of its KV head. dQ takes a query tile:
// dQ = scale * dS K. Operand layouts are in prefill_flash_f32.cuh.
//
// Bound: operations. At CodeFuse-13B (40 heads x 128, S = 2048) the causal
// pairs are 84M; dK/dV does 8 FLOP a pair and head dim (QK^T and dO V^T
// again, P^T dO, dS^T Q: 86 GFLOP), dQ 6 (QK^T, dO V^T, dS K: 64 GFLOP),
// against ~250 MB of operands and gradients: over 250 FLOP a byte. An
// fp32-accurate product has two routes on this card: the FMA units (67
// TFLOP/s) or the tensor cores by 3xTF32 (ftcf_mma.cuh: three TF32 MMAs over
// the operands split into a big and a small TF32 part, 495 / 3 = 165
// TFLOP/s). The bound is the second: 0.52 ms for dK/dV, 0.39 ms for dQ.
//
// Design.
//  - Every product is mma.sync m16n8k8 in 3xTF32 with fp32 accumulators; no
//    one-term TF32 anywhere (it keeps about three digits). The split is
//    made in registers as a fragment is loaded.
//  - A block of 8 warps owns FIX rows (keys in dK/dV, queries in dQ: 128,
//    64 at dh 256), each warp 16 of them; at dh 256 two warps share 16 rows
//    and each accumulates half the head dim (both compute the full scores),
//    so a warp holds at most 16 x 128 fp32 of each gradient. The block's
//    own rows stay in shared memory; the other side streams in tiles of STR
//    rows (32, 16 at dh 256) through a double-buffered cp.async ring, the
//    next tile landing while the current one is multiplied: in dK/dV the Q
//    and dO tiles with their lse and delta, walked over the g heads; in dQ
//    the K and V tiles. Tiles are sized so that no instance spills and the
//    ring fits beside the fixed tiles (203 KB at dh 128).
//  - The score products contract over the head dim: both operands are
//    K-major, and ldmatrix (b16, no .trans) gives the TF32 fragment word for
//    word. The products with P, dS contract over a tile's rows: their A
//    operand is the score block itself, kept in registers, with the
//    contraction index permuted in each step of 8 (k = t is element 2t,
//    k = t + 4 is 2t + 1) so that the accumulator registers are the A
//    fragment as they stand; B then takes rows 2t and 2t + 1 of the tile by
//    scalar loads. A row stride of dh + 4 floats keeps rows 16-byte aligned
//    for cp.async and ldmatrix and leaves both load patterns free of bank
//    conflicts (8 rows of 16 bytes; 8 t + g over the 32 lanes).
//  - No atomics: the two-kernel split stays, so two calls give equal bytes.
//    Key tiles with the most queries and query tiles with the longest rows
//    are scheduled first.
//
// Error: each 3xTF32 product leaves out ~2^-22 of its terms, below fp32's
// own rounding of the sums over up to 2048 keys; the kernels stay within
// 1e-4 of max |plain| (tests/test_torch_flash_prefill.py holds a model of
// the split product to that on the CPU, chip_smoke.py phase 12 the kernels).
#include "ftcf_mma.cuh"
#include "prefill_flash_f32.cuh"

namespace ftcf {
namespace f32attn {

template <int DH>
struct BwdTile {
  static constexpr int NSPLIT = DH == 256 ? 2 : 1;  // warps that share 16 rows
  static constexpr int FIX = DH == 256 ? 64 : 128;  // the block's own rows
  static constexpr int STR = DH == 256 ? 16 : 32;   // rows of a streamed tile
  static constexpr int LD = DH + 4;                 // row stride in shared memory
  static constexpr int DW = DH / NSPLIT;            // gradient columns a warp holds
  static constexpr int NT = STR / 8;                // n-blocks of a score block
  static constexpr int NB = DW / 8;                 // n-blocks of a gradient
  static constexpr int THREADS = FIX / 16 * NSPLIT * 32;
  static constexpr int STAGE = 2 * STR * LD + 2 * STR;  // floats: two tiles, two vectors
  static constexpr size_t SMEM = (size_t)(2 * FIX * LD + 2 * STAGE) * sizeof(float);
};

// Rows [r0, r0 + N) of one head (row r at src + r * stride floats) into
// shared memory with row stride dh + 4, by cp.async; rows at or past
// `limit` are zero.
template <int DH, int N, int NTHREADS>
__device__ __forceinline__ void copy_rows_async(float* dst, const float* src, long long stride,
                                                int r0, int limit) {
  constexpr int V = DH / 4;  // 16 bytes a copy
#pragma unroll 4
  for (int idx = threadIdx.x; idx < N * V; idx += NTHREADS) {
    const int r = idx / V, c = (idx % V) * 4;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * (DH + 4) + c, ok ? src + (long long)(r0 + r) * stride + c : src,
               ok ? 16 : 0);
  }
}

// acc[n] += A B^T over the head dim, 3xTF32: A rows ra .. ra + 15 of one
// tile, B rows 0 .. 8 NT - 1 of another (both stride dh + 4): a 16 x 8 NT
// score block in the accumulator layout (rows g, g + 8; columns 2t, 2t + 1).
template <int DH, int NT>
__device__ __forceinline__ void score_block(float (&acc)[NT][4], const float* A, int ra,
                                            const float* B) {
  constexpr int LD = DH + 4;
#pragma unroll 2
  for (int c = 0; c < DH; c += 8) {
    uint32_t x[4], ab[4], as[4];
    ldmatrix_a_tf32(x, A, LD, ra, c);
    split_tf32<4>(x, ab, as);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t y[4], bb[4], bs[4];
      ldmatrix_b2_tf32(y, B, LD, 8 * n, c);
      split_tf32<4>(y, bb, bs);
      mma_1688_3xtf32(acc[n], ab, as, bb, bs);
      mma_1688_3xtf32(acc[n + 1], ab, as, bb + 2, bs + 2);
    }
  }
}

// acc[nb] += W M, 3xTF32: W a 16 x 8 NT score block in the accumulator
// layout, M rows 0 .. 8 NT - 1 of a tile (stride dh + 4), columns
// c0 .. c0 + 8 NB - 1. The contraction index is permuted in each step of 8
// (k = t is row 2t, k = t + 4 is row 2t + 1), so W's registers are the A
// fragment as they stand and M's B fragment is rows 2t, 2t + 1, column g.
// The tensor cores align and truncate the terms of each MMA to the largest
// one, the accumulator included: over the ~1000 MMAs of a long sum the
// truncations would add up (one way) to ~1e-4 of the sum. So each tile's
// product is summed from zero (NT x 3 MMAs, NG independent chains) and added
// to acc in fp32, rounded to nearest.
template <int DH, int NT, int NB>
__device__ __forceinline__ void scores_times_rows_tf32(float (&acc)[NB][4],
                                                       const float (&w)[NT][4], const float* M,
                                                       int c0) {
  constexpr int LD = DH + 4, NG = 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t ab[NT][4], as[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint32_t x[4] = {__float_as_uint(w[n][0]), __float_as_uint(w[n][2]),
                           __float_as_uint(w[n][1]), __float_as_uint(w[n][3])};
    split_tf32<4>(x, ab[n], as[n]);
  }
  const float* m = M + 2 * t * LD + c0 + g;
#pragma unroll
  for (int nb0 = 0; nb0 < NB; nb0 += NG) {
    float part[NG][4] = {};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float* r = m + 8 * n * LD + 8 * (nb0 + j);
        const uint32_t y[2] = {__float_as_uint(r[0]), __float_as_uint(r[LD])};
        uint32_t bb[2], bs[2];
        split_tf32<2>(y, bb, bs);
        mma_1688_3xtf32(part[j], ab[n], as[n], bb, bs);
      }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb0 + j][e] += part[j][e];
  }
}

// dK/dV: one block a (key tile, KV head, row). It walks the g query heads of
// the KV head and, for each, the query tiles that can see the key tile (every
// query at or after its first key); dV += P^T dO, dK += scale * dS^T Q.
template <int DH>
__global__ void __launch_bounds__(BwdTile<DH>::THREADS)
    prefill_f32_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int* __restrict__ lens, float* __restrict__ dk,
                               float* __restrict__ dv, int S, int nH, int gq, float sm_scale) {
  using BT = BwdTile<DH>;
  constexpr int LD = BT::LD, FIX = BT::FIX, STR = BT::STR, NT = BT::NT, NB = BT::NB;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + FIX * LD;
  float* ring = sV + FIX * LD;  // a stage: Q, dO (STR rows each), lse, delta (STR each)

  const int k0 = blockIdx.x * FIX;  // the first key tiles see the most queries: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nKV = nH / gq;
  const int len = lens[b];
  const long long qs = (long long)nH * DH, ks = (long long)nKV * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp / BT::NSPLIT * 16, wc = warp % BT::NSPLIT * BT::DW;  // keys, columns
  const float sl2 = sm_scale * LOG2E;

  float ak[NB][4] = {}, av[NB][4] = {};
  if (k0 < len) {  // keys at or past the length are seen by no query
    copy_rows_async<DH, FIX, BT::THREADS>(sK, k + ((long long)b * S * nKV + kvh) * DH, ks, k0, S);
    copy_rows_async<DH, FIX, BT::THREADS>(sV, v + ((long long)b * S * nKV + kvh) * DH, ks, k0, S);
    const int n_q = (S - k0 + STR - 1) / STR;  // query tiles a head
    const int n_items = gq * n_q;
    auto fetch = [&](int it) {
      float* st = ring + (it & 1) * BT::STAGE;
      const int h = kvh * gq + it / n_q, q0 = k0 + it % n_q * BT::STR;
      const long long ro = ((long long)b * S * nH + h) * DH;
      copy_rows_async<DH, BT::STR, BT::THREADS>(st, q + ro, qs, q0, S);
      copy_rows_async<DH, BT::STR, BT::THREADS>(st + BT::STR * BT::LD, dout + ro, qs, q0, S);
      if ((int)threadIdx.x < 2 * BT::STR) {
        const int r = threadIdx.x % BT::STR;
        const bool ok = q0 + r < S;
        const float* src =
            ((int)threadIdx.x < BT::STR ? lse : delta) + ((long long)b * nH + h) * S;
        cp_async4(st + 2 * BT::STR * BT::LD + threadIdx.x, ok ? src + q0 + r : src, ok ? 4 : 0);
      }
    };
    fetch(0);
    cp_async_commit();
    for (int it = 0; it < n_items; ++it) {
      if (it + 1 < n_items) fetch(it + 1);
      cp_async_commit();
      cp_async_wait<1>();  // the item's stage (and the key tile) landed
      __syncthreads();
      const float* sQ = ring + (it & 1) * BT::STAGE;
      const float* sO = sQ + STR * LD;  // dO
      const float* sL = sO + STR * LD;  // lse
      const float* sD = sL + STR;       // delta
      const int q0 = k0 + it % n_q * STR;
      float s[NT][4] = {}, dp[NT][4] = {};
      score_block<DH, NT>(s, sK, wr, sQ);   // s[key][query]
      score_block<DH, NT>(dp, sV, wr, sO);  // dp[key][query]
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + wr + g + 8 * (e >> 1), iq = 8 * n + 2 * t + (e & 1), i = q0 + iq;
          const bool ok = i < S && j <= min(i, len - 1);
          const float p = ok ? exp2f(s[n][e] * sl2 - sL[iq] * LOG2E) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sD[iq]);
        }
      scores_times_rows_tf32<DH, NT, NB>(av, s, sO, wc);   // dV += P^T dO
      scores_times_rows_tf32<DH, NT, NB>(ak, dp, sQ, wc);  // dK += dS^T Q
      __syncthreads();  // the stage is free for item it + 2
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + wr + g + 8 * r;
    if (j >= S) continue;
    const long long off = (((long long)b * S + j) * nKV + kvh) * DH + wc + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      *reinterpret_cast<float2*>(dk + off + 8 * nb) =
          make_float2(ak[nb][2 * r] * sm_scale, ak[nb][2 * r + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv + off + 8 * nb) = make_float2(av[nb][2 * r], av[nb][2 * r + 1]);
    }
  }
}

// dQ: one block a (query tile, head, row), walking the key tiles 0 .. the
// tile's last visible key; dQ += scale * dS K.
template <int DH>
__global__ void __launch_bounds__(BwdTile<DH>::THREADS)
    prefill_f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const int* __restrict__ lens, float* __restrict__ dq, int S, int nH,
                              int gq, float sm_scale) {
  using BT = BwdTile<DH>;
  constexpr int LD = BT::LD, FIX = BT::FIX, STR = BT::STR, NT = BT::NT, NB = BT::NB;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + FIX * LD;    // dO
  float* ring = sO + FIX * LD;  // a stage: K, V (STR rows each)

  const int n_tiles = (S + FIX - 1) / FIX;
  const int q0 = (n_tiles - 1 - blockIdx.x) * FIX;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nKV = nH / gq;
  const int len = lens[b];
  const long long qs = (long long)nH * DH, ks = (long long)nKV * DH;
  const float* kb = k + ((long long)b * S * nKV + h / gq) * DH;
  const float* vb = v + ((long long)b * S * nKV + h / gq) * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp / BT::NSPLIT * 16, wc = warp % BT::NSPLIT * BT::DW;  // queries, columns
  const float sl2 = sm_scale * LOG2E;

  copy_rows_async<DH, FIX, BT::THREADS>(sQ, q + ((long long)b * S * nH + h) * DH, qs, q0, S);
  copy_rows_async<DH, FIX, BT::THREADS>(sO, dout + ((long long)b * S * nH + h) * DH, qs, q0, S);
  auto fetch = [&](int kt) {
    float* st = ring + (kt & 1) * BT::STAGE;
    copy_rows_async<DH, BT::STR, BT::THREADS>(st, kb, ks, kt * BT::STR, S);
    copy_rows_async<DH, BT::STR, BT::THREADS>(st + BT::STR * BT::LD, vb, ks, kt * BT::STR, S);
  };
  fetch(0);
  cp_async_commit();
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + wr + g + 8 * r;
    l2[r] = i < S ? lse[((long long)b * nH + h) * S + i] * LOG2E : 0.f;
    dl[r] = i < S ? delta[((long long)b * nH + h) * S + i] : 0.f;
  }
  float acc[NB][4] = {};
  const int n_kt = min(q0 + FIX - 1, len - 1) / STR + 1;  // through the last visible key
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) fetch(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // the key tile's stage (and Q, dO) landed
    __syncthreads();
    const float* sK = ring + (kt & 1) * BT::STAGE;
    const float* sV = sK + STR * LD;
    const int k0 = kt * STR;
    float s[NT][4] = {}, dp[NT][4] = {};
    score_block<DH, NT>(s, sQ, wr, sK);   // s[query][key]
    score_block<DH, NT>(dp, sO, wr, sV);  // dp[query][key]
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = q0 + wr + g + 8 * r, j = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok = i < S && j <= min(i, len - 1);
        const float p = ok ? exp2f(s[n][e] * sl2 - l2[r]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[r]);
      }
    scores_times_rows_tf32<DH, NT, NB>(acc, dp, sK, wc);  // dQ += dS K
    __syncthreads();  // the stage is free for key tile kt + 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + wr + g + 8 * r;
    if (i >= S) continue;
    float* out = dq + (((long long)b * S + i) * nH + h) * DH + wc + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<float2*>(out + 8 * nb) =
          make_float2(acc[nb][2 * r] * sm_scale, acc[nb][2 * r + 1] * sm_scale);
  }
}

template <int DH>
static cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* delta, const int* lens, float* dk,
                              float* dv, int B, int S, int nKV, int gq, float sm_scale,
                              cudaStream_t st) {
  using BT = BwdTile<DH>;
  auto kern = prefill_f32_bwd_dkv_kernel<DH>;
  const cudaError_t e = allow_smem(kern, BT::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BT::FIX - 1) / BT::FIX, nKV, B);
  kern<<<grid, BT::THREADS, BT::SMEM, st>>>(q, k, v, dout, lse, delta, lens, dk, dv, S, nKV * gq,
                                            gq, sm_scale);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                             const float* lse, const float* delta, const int* lens, float* dq,
                             int B, int S, int nKV, int gq, float sm_scale, cudaStream_t st) {
  using BT = BwdTile<DH>;
  auto kern = prefill_f32_bwd_dq_kernel<DH>;
  const cudaError_t e = allow_smem(kern, BT::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BT::FIX - 1) / BT::FIX, nKV * gq, B);
  kern<<<grid, BT::THREADS, BT::SMEM, st>>>(q, k, v, dout, lse, delta, lens, dq, S, nKV * gq, gq,
                                            sm_scale);
  return cudaGetLastError();
}

}  // namespace f32attn
}  // namespace ftcf

extern "C" {

// K5 backward, dK and dV. q/dout [B, S, nKV * gq, dh], k/v [B, S, nKV, dh]
// fp32 (16-byte aligned), lse/delta [B, nKV * gq, S] fp32, lens [B] int32;
// dk/dv like k, every element written (0 for keys no query sees).
int ftcf_prefill_flash_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                               const float* lse, const float* delta, const int* lens, float* dk,
                               float* dv, int B, int S, int nKV, int gq, int dh, float sm_scale,
                               void* stream) {
  using namespace ftcf::f32attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gq < 1 || S < 1 || B < 1 || nKV < 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, delta, lens, dk, dv, B, S, nKV, gq, sm_scale,
                               st);
  if (dh == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, lens, dk, dv, B, S, nKV, gq,
                                sm_scale, st);
  if (dh == 256)
    return (int)launch_dkv<256>(q, k, v, dout, lse, delta, lens, dk, dv, B, S, nKV, gq,
                                sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// K5 backward, dQ: the same operands; dq like q.
int ftcf_prefill_flash_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* delta, const int* lens, float* dq,
                              int B, int S, int nKV, int gq, int dh, float sm_scale,
                              void* stream) {
  using namespace ftcf::f32attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gq < 1 || S < 1 || B < 1 || nKV < 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, lens, dq, B, S, nKV, gq, sm_scale, st);
  if (dh == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, delta, lens, dq, B, S, nKV, gq, sm_scale, st);
  if (dh == 256)
    return (int)launch_dq<256>(q, k, v, dout, lse, delta, lens, dq, B, S, nKV, gq, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
