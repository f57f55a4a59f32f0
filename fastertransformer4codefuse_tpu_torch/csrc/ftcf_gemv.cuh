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
// H100 SXM, against M*K*N multiply-adds. A block owns 128 output columns
// ("tile") and one K range ("split") of one segment, 256 threads, and
// streams that range's weight bytes exactly once for all M rows of x. The
// caller's ranges (ops/quant_matmul.py split_ranges, a function of K, N, the
// SM count and the weight format only) hold whole 8-row units, and whole
// groups with group scales; there are enough splits that the grid holds about
// four blocks per SM (the H100 needs ~2 MB in flight to cover memory
// latency). Each split's sums go to an fp32 workspace, and a second small
// kernel adds the splits in a fixed order (deterministic, no atomics),
// applies per-segment scales, bias, activation and residual, and writes bf16
// or fp32.
//
// Two bodies:
//  - M = 1, the FMA loop (gemv_block<1, FMT>): each thread loads 16 contiguous
//    weight bytes along N per byte row (8 threads cover a 128-byte line, a
//    warp 4 rows), converts them to fp32 and keeps 16 fp32 sums; 32 k lanes
//    (4 a warp) walk the range's byte rows. An int4 byte row holds two K rows
//    (the low nibble the even one). With group scales a k lane walks a run of
//    consecutive byte rows inside one group, sums it into partials and adds
//    partial * scale once (the JAX kernel's per-group dot times its scale
//    row); int4 values come as 136 + v (one byte permute) with 136 * sum(x)
//    taken off each run's partial. x sits in shared memory as fp32;
//  - 2 <= M <= 32, tensor cores (gemv_mma_block): mma.sync m16n8k16, bf16 in,
//    fp32 accumulate. The dequantized weight is the A operand (16 output
//    columns x 16 k), x the B operand (16 k x 8 rows), so each A fragment
//    feeds NB = ceil(M / 8) B tiles (1, 2 or 4; 17-24 rows pad to 4) and the
//    weight is read once for up to 32 rows. Warp w takes the 32-column
//    quarter w % 4 of the tile and k lane w / 4: the range's k16 steps (runs
//    of them with group scales) go to the two k lanes by turns. The weight
//    streams through a ring of 4 stages of 8 KB in shared memory by cp.async
//    (16-byte copies, 8 threads a 128-byte row, 3 stages in flight; a
//    stage holds the next 2 int8 or 4 int4 k16 steps of each k lane), so
//    the loads cost no registers and cover whole lines. Thread (g, t) of a
//    warp (g = lane / 4, t = lane % 4) reads one 32-bit word (4 columns,
//    4g .. 4g + 3 of its quarter) from each of the step's byte rows it owns:
//    int8 rows 4t .. 4t + 3, int4 byte rows 2t and 2t + 1 (K rows 4t .. 4t
//    + 3); the copies store 16-byte chunk c of row r at c ^ 2 (r / rows a
//    thread % 4), so those reads hit 32 banks. Column 4g + 2j is fragment
//    row g of product j (j = 0, 1) and 4g + 2j + 1 row g + 8; the
//    fragment's k columns (2t, 2t + 1, 2t + 8, 2t + 9) are the K rows 4t ..
//    4t + 3 of the step, so the B fragment is 8 consecutive bytes of x in
//    its natural order. Every byte of a word is a fragment register: an
//    int4 byte is the (k, k + 1) pair as it stands (one byte permute and
//    one logic op put its nibbles under the bf16 exponent of 128, one bf16x2
//    multiply-add removes the bias, exactly), an int8 register is the same
//    byte of two rows' words (one byte permute; 128 + the low 7 bits plus
//    -128 or -256 from the sign bit, exactly). x is staged in bf16 with a
//    row pitch of 32 bytes past a multiple of 128 (the B fragments' 8-byte
//    reads are free of bank conflicts); rows M .. 8 NB - 1 and K rows past
//    the range are zeros there and never read from device memory, and a
//    range that ends inside a k16 step copies no weight row past its end
//    (zero-filled). With group scales (G a multiple of 16) a run of k16
//    steps inside one group accumulates into a partial fragment, then acc
//    += partial * scale[n], the scale row read once per run. The two k
//    lanes' sums are added in a fixed order through shared memory. A row's
//    arithmetic is the same at every M from 2 to 32 (the same steps, runs
//    and order; padding rows are separate fragment columns), so its output
//    is bit for bit the same.
#pragma once

#include <algorithm>
#include <atomic>
#include <numeric>

#include "ftcf_common.cuh"
#include "ftcf_mma.cuh"

namespace ftcf {

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_COLS = 128;        // columns of a block's tile
constexpr int GEMV_KLANES = 2;        // k lanes of the tensor-core body (warps w / 4)
constexpr int GEMV_MAX_CHUNK = 3072;  // K rows of a range the x staging takes

struct GemvSeg {
  const __nv_bfloat16* x;  // [M, K] row-major
  const int8_t* w;         // [K, N] int8 or [K/2, N] packed int4, row-major
  const float* scale;      // [N] per-channel (nullptr with group scales)
  const void* gscale;      // [K/G, N] group scales: bf16 (W_I4G) or fp32 (W_I8G, W_I4GF)
  int K;
  int G;
  int splits;
  int chunk;  // K rows of a split (the last may be shorter): a multiple of 8, and of G
};

template <int FMT>
__host__ __device__ constexpr bool grouped_fmt() {
  return FMT == W_I4G || FMT == W_I8G || FMT == W_I4GF;
}

// The 16 group scales of one thread's columns at element ``off`` of the
// [K/G, N] scales (bf16 for W_I4G, fp32 otherwise), as fp32.
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
      const float bias = PACK == 2 ? -136.0f * sx[m] : 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(part[m][j] + bias, sc[j], acc[m][j]);
    }
  }
}

// M = 1 (instantiated at MT = 1 only): one block's partial sums, split
// ``s`` of segment ``sg``, column tile ``tile`` of an N-wide output; the
// sums go to ``ws_split`` [M, N] (this split's plane of the workspace).
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

  if constexpr (grouped_fmt<FMT>()) {
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

// The A fragments of the two products of one k16 step from a thread's weight
// words (int8: rows 4t .. 4t + 3; int4: byte rows 2t, 2t + 1): product j
// takes byte 2j (fragment row g) and byte 2j + 1 (row g + 8).
template <int FMT>
__device__ __forceinline__ void step_fragments(const uint32_t* q, uint32_t (&a)[2][4]) {
  if constexpr (KPack<FMT>::value == 2) {
    a[0][0] = i4_pair_bf16x2<0>(q[0]);
    a[0][1] = i4_pair_bf16x2<1>(q[0]);
    a[0][2] = i4_pair_bf16x2<0>(q[1]);
    a[0][3] = i4_pair_bf16x2<1>(q[1]);
    a[1][0] = i4_pair_bf16x2<2>(q[0]);
    a[1][1] = i4_pair_bf16x2<3>(q[0]);
    a[1][2] = i4_pair_bf16x2<2>(q[1]);
    a[1][3] = i4_pair_bf16x2<3>(q[1]);
  } else {
    a[0][0] = i8_pair_bf16x2<0>(q[0], q[1]);
    a[0][1] = i8_pair_bf16x2<1>(q[0], q[1]);
    a[0][2] = i8_pair_bf16x2<0>(q[2], q[3]);
    a[0][3] = i8_pair_bf16x2<1>(q[2], q[3]);
    a[1][0] = i8_pair_bf16x2<2>(q[0], q[1]);
    a[1][1] = i8_pair_bf16x2<3>(q[0], q[1]);
    a[1][2] = i8_pair_bf16x2<2>(q[2], q[3]);
    a[1][3] = i8_pair_bf16x2<3>(q[2], q[3]);
  }
}

// Elements between two staged x rows of the tensor-core body: the range's K
// rows rounded up to 64, plus 16 (a pitch of 128 a + 32 bytes).
__host__ __device__ constexpr int gemv_xs_pitch(int chunk) { return (chunk + 63) / 64 * 64 + 16; }

// The tensor-core body's ring of weight stages in shared memory: a stage
// is 8 KB, two 16-byte copies a thread, and holds the next k16 steps of each
// k lane (its "slots", 128 bytes a byte row): 2 of int8, 4 of int4.
// GEMV_STAGES stages, all but one in flight.
constexpr int GEMV_STAGES = 4;
constexpr int GEMV_STAGE_BYTES = 2 * 16 * GEMV_THREADS;
constexpr int GEMV_RING_BYTES = GEMV_STAGES * GEMV_STAGE_BYTES;

// 2 <= M <= 32: one block's partial sums on tensor cores (NB 8-row B tiles),
// split ``s`` of segment ``sg``, column tile ``tile``, into ``ws_split``
// [M, N]; ``pitch`` is gemv_xs_pitch of the launch's widest range.
template <int NB, int FMT>
__device__ __forceinline__ void gemv_mma_block(const GemvSeg& sg, int s, int M, int N, int tile,
                                               int pitch, float* __restrict__ ws_split) {
  constexpr int PACK = KPack<FMT>::value;
  constexpr int WORDS = 4 / PACK;       // weight words a thread reads a k16 step
  constexpr int STEP_ROWS = 16 / PACK;  // weight byte rows of a k16 step
  constexpr int SLOT = STEP_ROWS * GEMV_COLS;             // bytes of one k16 step
  constexpr int STEPS = GEMV_THREADS * 16 / SLOT;           // steps of a k lane a stage
  constexpr int STAGE = GEMV_STAGE_BYTES;
  constexpr bool GROUPED = grouped_fmt<FMT>();
  static_assert(GEMV_KLANES == 2 && STAGE == GEMV_KLANES * STEPS * SLOT, "stage layout");
  extern __shared__ float smem[];
  char* ring = reinterpret_cast<char*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ring + GEMV_RING_BYTES);
  const int K = sg.K;
  const int k0 = s * sg.chunk;
  const int klen = max(min(K - k0, sg.chunk), 0);
  const int r0 = k0 / PACK, r1 = r0 + klen / PACK;
  const int nsteps = (klen + 15) / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kl = warp >> 2, quarter = warp & 3;
  const int nw = tile * GEMV_COLS + quarter * 32;
  const int nt = nw + 4 * g;  // the thread's 4 columns

  // runs of R consecutive k16 steps inside one group (single steps without
  // group scales), halved while the range holds fewer runs than k lanes; k
  // lane k takes runs k, k + 2, ...: its l-th step is step (k + 2 (l / R)) R
  // + l % R of the range
  int R = 1;
  if constexpr (GROUPED) {
    R = sg.G / 16;
    while ((R & 1) == 0 && R * GEMV_KLANES > nsteps) R >>= 1;
  }
  const int nruns = nsteps / R;
  const int mine0 = (nruns + 1) / 2 * R, mine1 = nruns / 2 * R;  // steps of k lanes 0, 1
  const int nstage = (mine0 + STEPS - 1) / STEPS;

  // The copies: 16-byte chunk ch of byte row ``row`` of slot k STEPS + ii
  // (k lane k, its step ii of the stage), stored at chunk ch ^ 2 (row / WORDS
  // % 4) of its row, so that a warp's 4-byte fragment reads below hit 32
  // banks. A thread's two copies share ii, row and ch: one for each k lane.
  const int ci_row = (tid % (SLOT / 16)) >> 3, ci_ch = tid & 7;
  const int ci_ii = tid / (SLOT / 16);
  const int ci_off = ci_row * GEMV_COLS + ((ci_ch ^ ((ci_row / WORDS % 4) << 1)) << 4);
  const int8_t* ci_src = sg.w + (size_t)(r0 + ci_row) * N + tile * GEMV_COLS + 16 * ci_ch;
  const bool ci_col = tile * GEMV_COLS + 16 * ci_ch < N;
  int cq = 0, cr_ = ci_ii;  // the copies' cursor: l = 2 j + ii, as (l / R, l % R)
  while (cr_ >= R) cr_ -= R, ++cq;
  auto copy_stage = [&](int j) {
    char* dst = ring + (j % GEMV_STAGES) * STAGE + ci_off;
    const int l = STEPS * j + ci_ii;
#pragma unroll
    for (int k = 0; k < GEMV_KLANES; ++k) {
      const int st = (k + 2 * cq) * R + cr_;
      const bool ok = ci_col && l < (k ? mine1 : mine0) && r0 + ci_row + st * STEP_ROWS < r1;
      cp_async16(dst + (k * STEPS + ci_ii) * SLOT,
                 ok ? ci_src + (size_t)st * STEP_ROWS * N : sg.w, ok ? 16 : 0);
    }
    cr_ += STEPS;
    while (cr_ >= R) cr_ -= R, ++cq;
  };

#pragma unroll
  for (int j = 0; j < GEMV_STAGES - 1; ++j) {
    if (j < nstage) copy_stage(j);
    cp_async_commit();
  }

  const int n8 = nsteps * 2;  // 16-byte units of a staged row
  for (int i = tid; i < 8 * NB * n8; i += GEMV_THREADS) {
    const int m = i / n8, c = i - m * n8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (m < M && 8 * c < klen)
      u = __ldg(reinterpret_cast<const uint4*>(sg.x + (size_t)m * K + k0) + c);
    *reinterpret_cast<uint4*>(xs + m * pitch + 8 * c) = u;
  }

  float acc[NB][2][4], part[NB][2][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const __nv_bfloat16* xt = xs + g * pitch + 4 * t;
  // the thread's 4-byte fragment words in a slot: byte rows t WORDS + h,
  // columns 4g .. 4g + 3 of its quarter (chunk 2 quarter + g / 4, swizzled)
  const int rd_off = t * WORDS * GEMV_COLS + (((2 * quarter + (g >> 2)) ^ (t << 1)) << 4) +
                     4 * (g & 3);
  const int mine = nw < N ? (kl ? mine1 : mine0) : 0;
  int cr = kl, cb = 0;  // the compute cursor: run cr, step cb within it
  float sc[4];
  for (int j = 0; j < nstage; ++j) {
    cp_async_wait<GEMV_STAGES - 2>();
    __syncthreads();  // stage j landed for all; stage j - 1's slots are free
    if (j + GEMV_STAGES - 1 < nstage) copy_stage(j + GEMV_STAGES - 1);
    cp_async_commit();
    const char* sj = ring + (j % GEMV_STAGES) * STAGE + kl * STEPS * SLOT + rd_off;
#pragma unroll
    for (int ii = 0; ii < STEPS; ++ii) {
      if (STEPS * j + ii >= mine) break;
      const int st = cr * R + cb;
      uint32_t q[WORDS];
#pragma unroll
      for (int h = 0; h < WORDS; ++h)
        q[h] = *reinterpret_cast<const uint32_t*>(sj + ii * SLOT + h * GEMV_COLS);
      uint32_t a[2][4];
      step_fragments<FMT>(q, a);
      if constexpr (GROUPED) {
        if (cb == 0) {
#pragma unroll
          for (int i = 0; i < NB; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[i][jj][e] = 0.0f;
          // the run's scale row, used after its last step
          const size_t off = (size_t)((k0 + st * 16) / sg.G) * N + nt;
          if (nt >= N) {
            sc[0] = sc[1] = sc[2] = sc[3] = 0.0f;
          } else if constexpr (FMT == W_I4G) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                static_cast<const __nv_bfloat16*>(sg.gscale) + off));
            bf16x2_to_f32(v.x, sc);
            bf16x2_to_f32(v.y, sc + 2);
          } else {
            const float4 v =
                __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(sg.gscale) + off));
            sc[0] = v.x, sc[1] = v.y, sc[2] = v.z, sc[3] = v.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const uint2 bv = *reinterpret_cast<const uint2*>(xt + 8 * i * pitch + st * 16);
        const uint32_t b[2] = {bv.x, bv.y};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if constexpr (GROUPED)
            mma_16816(part[i][jj], a[jj], b);
          else
            mma_16816(acc[i][jj], a[jj], b);
        }
      }
      if constexpr (GROUPED) {
        if (cb == R - 1) {
#pragma unroll
          for (int i = 0; i < NB; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][jj][e] = fmaf(part[i][jj][e], sc[2 * jj + (e >> 1)], acc[i][jj][e]);
        }
      }
      if (++cb == R) cb = 0, cr += GEMV_KLANES;
    }
  }

  // the k lanes' sums, added in a fixed order: red [k lane][8 NB rows][128]
  cp_async_wait<0>();
  __syncthreads();  // the ring and the x staging are dead
  float* red = smem;
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* p = red + (kl * 8 * NB + 8 * i + 2 * t) * GEMV_COLS + quarter * 32 + 4 * g + 2 * j;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][2]);
      *reinterpret_cast<float2*>(p + GEMV_COLS) = make_float2(acc[i][j][1], acc[i][j][3]);
    }
  __syncthreads();
  for (int i = tid; i < M * GEMV_COLS; i += GEMV_THREADS) {
    const int m = i / GEMV_COLS, c = i - m * GEMV_COLS;
    float v = red[m * GEMV_COLS + c];
#pragma unroll
    for (int k = 1; k < GEMV_KLANES; ++k) v += red[(k * 8 * NB + m) * GEMV_COLS + c];
    const int n = tile * GEMV_COLS + c;
    if (n < N) ws_split[(size_t)m * N + n] = v;
  }
}

// One block of either body: NB = 0 is the M = 1 loop (its x staging is one
// row, so the pitch is not read).
template <int NB, int FMT>
__device__ __forceinline__ void gemv_tile(const GemvSeg& sg, int s, int M, int N, int tile,
                                          int pitch, float* __restrict__ ws_split) {
  if constexpr (NB == 0)
    gemv_block<1, FMT>(sg, s, M, N, tile, pitch, ws_split);
  else
    gemv_mma_block<NB, FMT>(sg, s, M, N, tile, pitch, ws_split);
}

// Blocks an SM must hold (the register cap of each instance). At M = 1 the
// loop needs few registers and more resident blocks keep more weight loads
// in flight: four (64 registers), or five (48) for the per-channel formats
// joined over K (K1, K6, K8, K3), each measured faster than the other value
// on its own kernels (K13's per-channel instance is slower at five). The
// tensor-core body: four blocks at 8 rows (64 registers), three at 16 (80),
// two at 32 (128), as its accumulators grow.
__host__ __device__ constexpr int gemv_min_blocks(int nb, int fmt, bool ncat) {
  return nb == 0 ? (!ncat && (fmt == W_I8 || fmt == W_I4) ? 5 : 4) : nb == 1 ? 4 : nb == 2 ? 3 : 2;
}

// Segments joined over K: grid y runs over s1's splits, then s2's.
template <int NB, int FMT>
static __global__ void __launch_bounds__(GEMV_THREADS, gemv_min_blocks(NB, FMT, false))
gemv_partial_kernel(GemvSeg s1, GemvSeg s2, int M, int N, int pitch, float* __restrict__ ws) {
  const int split = blockIdx.y;
  const bool second = split >= s1.splits;
  const GemvSeg sg = second ? s2 : s1;
  gemv_tile<NB, FMT>(sg, second ? split - s1.splits : split, M, N, blockIdx.x, pitch,
                     ws + (size_t)split * M * N);
}

// Segments joined over N: grid x runs over s1's column tiles (N1 columns),
// then s2's (N2); grid y over the splits of the wider-split segment (a block
// past its own segment's splits exits). Each segment's splits fill its own
// workspace, ws1 [s1.splits, M, N1] and ws2 [s2.splits, M, N2].
template <int NB, int FMT>
static __global__ void __launch_bounds__(GEMV_THREADS, gemv_min_blocks(NB, FMT, true))
gemv_ncat_partial_kernel(GemvSeg s1, GemvSeg s2, int N1, int N2, int M, int pitch,
                         float* __restrict__ ws1, float* __restrict__ ws2) {
  const int t1 = (N1 + GEMV_COLS - 1) / GEMV_COLS;
  const bool second = (int)blockIdx.x >= t1;
  const GemvSeg sg = second ? s2 : s1;
  const int split = blockIdx.y;
  if (split >= sg.splits) return;  // uniform over the block
  const int N = second ? N2 : N1;
  gemv_tile<NB, FMT>(sg, split, M, N, second ? blockIdx.x - t1 : blockIdx.x, pitch,
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

// Whether a segment's ranges are ones the bodies take: chunks of whole 8-row
// units (and groups) up to GEMV_MAX_CHUNK rows, covering K with no empty
// split; above one row of x, groups of whole k16 steps. An empty segment
// (splits 0) passes.
template <int FMT>
static inline bool gemv_ranges_ok(const GemvSeg& s, int M) {
  if (s.splits == 0) return true;
  const bool grouped = grouped_fmt<FMT>();
  const int unit = grouped ? std::lcm(8, s.G) : 8;
  return s.chunk > 0 && s.chunk % unit == 0 && s.chunk <= GEMV_MAX_CHUNK && s.K % 8 == 0 &&
         (!grouped || M == 1 || s.G % 16 == 0) && (long long)(s.splits - 1) * s.chunk < s.K &&
         (long long)s.splits * s.chunk >= s.K;
}

// The wider chunk of the two segments; 0 when a segment's ranges are not
// ones the bodies take.
template <int FMT>
static inline int gemv_chunk(const GemvSeg& s1, const GemvSeg& s2, int M) {
  if (!gemv_ranges_ok<FMT>(s1, M) || !gemv_ranges_ok<FMT>(s2, M)) return 0;
  return std::max(s1.splits ? s1.chunk : 0, s2.splits ? s2.chunk : 0);
}

// Dynamic shared memory of a block: the x staging (after the weight ring in
// the tensor-core body), reused for the cross-warp sums.
template <int NB, int FMT>
static inline size_t gemv_smem(int chunk) {
  if (NB == 0) return std::max((size_t)chunk, (size_t)8 * GEMV_COLS) * sizeof(float);
  return std::max(GEMV_RING_BYTES + (size_t)8 * NB * gemv_xs_pitch(chunk) * sizeof(__nv_bfloat16),
                  (size_t)GEMV_KLANES * 8 * NB * GEMV_COLS * sizeof(float));
}

// Lets ``kernel`` take up to gemv_smem(GEMV_MAX_CHUNK) bytes of dynamic
// shared memory (above 48 KB only after this attribute), once per device:
// ``devices`` (one per kernel instance) holds a bit per device done.
template <int NB, int FMT, class Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t smem,
                                     std::atomic<unsigned long long>& devices) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (err != cudaSuccess || (devices.load() & bit)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gemv_smem<NB, FMT>(GEMV_MAX_CHUNK));
  if (err == cudaSuccess) devices.fetch_or(bit);
  return err;
}

template <int NB, int FMT>
static cudaError_t launch_partial(GemvSeg s1, GemvSeg s2, int M, int N, int chunk, float* ws,
                                  cudaStream_t stream) {
  const dim3 grid((N + GEMV_COLS - 1) / GEMV_COLS, s1.splits + s2.splits);
  const size_t smem = gemv_smem<NB, FMT>(chunk);
  static std::atomic<unsigned long long> devices{0};
  const cudaError_t err = allow_smem<NB, FMT>(gemv_partial_kernel<NB, FMT>, smem, devices);
  if (err != cudaSuccess) return err;
  gemv_partial_kernel<NB, FMT>
      <<<grid, GEMV_THREADS, smem, stream>>>(s1, s2, M, N, gemv_xs_pitch(chunk), ws);
  return cudaGetLastError();
}

// Both segments share one weight format FMT.
template <int FMT>
static cudaError_t launch_gemv(GemvSeg s1, GemvSeg s2, int M, int N, const void* bias,
                               int bias_bf16, int act, const __nv_bfloat16* residual, void* y,
                               int out_f32, float* ws, cudaStream_t stream) {
  const int chunk = gemv_chunk<FMT>(s1, s2, M);
  if (chunk == 0 || M < 1 || M > 32) return cudaErrorInvalidValue;
  // 8-row B tiles of the tensor-core body: as many as x has (17-24 rows take 4)
  const cudaError_t err =
      M == 1    ? launch_partial<0, FMT>(s1, s2, M, N, chunk, ws, stream)
      : M <= 8  ? launch_partial<1, FMT>(s1, s2, M, N, chunk, ws, stream)
      : M <= 16 ? launch_partial<2, FMT>(s1, s2, M, N, chunk, ws, stream)
                : launch_partial<4, FMT>(s1, s2, M, N, chunk, ws, stream);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  gemv_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      ws, s1.splits, s2.splits, M, N, s1.scale, s2.scale, bias, bias_bf16, act, residual, y,
      out_f32);
  return cudaGetLastError();
}

template <int NB, int FMT>
static cudaError_t launch_ncat_partial(GemvSeg s1, GemvSeg s2, int N1, int N2, int M, int chunk,
                                       float* ws1, float* ws2, cudaStream_t stream) {
  const int tiles = (N1 + GEMV_COLS - 1) / GEMV_COLS + (N2 + GEMV_COLS - 1) / GEMV_COLS;
  const dim3 grid(tiles, std::max(s1.splits, s2.splits));
  const size_t smem = gemv_smem<NB, FMT>(chunk);
  static std::atomic<unsigned long long> devices{0};
  const cudaError_t err = allow_smem<NB, FMT>(gemv_ncat_partial_kernel<NB, FMT>, smem, devices);
  if (err != cudaSuccess) return err;
  gemv_ncat_partial_kernel<NB, FMT><<<grid, GEMV_THREADS, smem, stream>>>(
      s1, s2, N1, N2, M, gemv_xs_pitch(chunk), ws1, ws2);
  return cudaGetLastError();
}

// Two segments joined over N into two bf16 outputs; o1.ws / o2.ws are the
// segments' workspaces (splits x M x N floats each). An empty second segment
// (N2 = 0, splits 0) makes this one plain GEMV of any format.
template <int FMT>
static cudaError_t launch_gemv_ncat(GemvSeg s1, GemvSeg s2, GemvOut o1, GemvOut o2, int M,
                                    cudaStream_t stream) {
  const int chunk = gemv_chunk<FMT>(s1, s2, M);
  if (chunk == 0 || M < 1 || M > 32) return cudaErrorInvalidValue;
  const int N1 = o1.N, N2 = o2.N;
  const cudaError_t err =
      M == 1    ? launch_ncat_partial<0, FMT>(s1, s2, N1, N2, M, chunk, o1.ws, o2.ws, stream)
      : M <= 8  ? launch_ncat_partial<1, FMT>(s1, s2, N1, N2, M, chunk, o1.ws, o2.ws, stream)
      : M <= 16 ? launch_ncat_partial<2, FMT>(s1, s2, N1, N2, M, chunk, o1.ws, o2.ws, stream)
                : launch_ncat_partial<4, FMT>(s1, s2, N1, N2, M, chunk, o1.ws, o2.ws, stream);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * (o1.N + o2.N);
  gemv_ncat_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(o1, o2, M);
  return cudaGetLastError();
}

}  // namespace ftcf
