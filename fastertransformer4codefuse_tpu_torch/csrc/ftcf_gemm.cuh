// Prefill-width (M > 32) weight-only GEMM shared by K1 (quant_matmul.cu),
// K6/K7/K8 (quant_matmul_w4.cu) and K13's prefill form (quant_matmul_fused.cu):
// y = act(x @ dequant(W) * s + b), x bf16 [M, K], fp32 accumulation, y bf16
// or fp32; K13 joins two such outputs over N in one launch.
//
// Bound by the tensor cores at these widths (a 1024 x 5120 x 5120 int8
// product is ~54 GFLOP against ~37 MB: ~1450 FLOP a byte, far above the
// card's 295), and only wgmma reaches their rate. Design, on the sm_90a
// pieces K5 proved (ftcf_sm90.cuh):
//  - the operands swapped: each block computes y^T = W^T x^T for 128 output
//    channels x 128 rows of x, the dequantized weight the A operand from
//    registers and x the B operand from shared memory, as it lands (K-major,
//    the 128-byte swizzle). A converted weight never goes through shared
//    memory: with W as B, its conversion's stores and the product's reads
//    of A and B outran the SM's shared-memory bandwidth (PERF.md);
//  - three warpgroups: a producer, whose one thread keeps the 64-deep k
//    tiles of x, of the raw weight (int8 [64][128], packed int4 [32][128],
//    in the 128-byte swizzle) and, with group scales (int4 with bf16 or fp32
//    scales, int8 with fp32 ones), of the scale rows they touch in flight by
//    TMA into a ring of up to eight stages (full and empty mbarriers), and
//    two consumers of 64 channels each;
//  - a warp's 16 channels of a k tile reach its registers by ldmatrix.trans
//    (a thread: channels 2g and 2g + 1 at k rows 2t and 2t + 1, or for int4
//    the pair rows t and t + 4 of a k16 step): they convert to the bf16 A
//    fragments exactly, with ftcf_gemv.cuh's conversions, A's rows g and
//    g + 8 standing for channels 2g and 2g + 1; group scales multiply the
//    bf16 weight, q * scale rounded once to bf16 (an int8 or int4 value is
//    exact in bf16), the same for both payloads;
//  - wgmma m64n128k16, A from registers, B = x K-major; the next k tile is
//    converted and issued before the previous one is waited for, so one k
//    tile's products always wait behind another's (the fragments alternate
//    between two register sets);
//  - blocks in groups of GM_GROUP_M row tiles, so that the blocks in flight
//    share their x and weight panels in L2; TMA zero-fills past M, K and N,
//    so every tail is exact;
//  - the epilogue applies the per-channel scale, bias and activation to the
//    fp32 accumulators in registers and stores channel pairs (bf16x2 or
//    float2);
//  - every output element sums its k tiles in one order, whatever M: a row's
//    output does not depend on M or on the rows beside it, and two calls
//    give equal bytes.
#pragma once

#include "ftcf_common.cuh"
#include "ftcf_gemv.cuh"
#include "ftcf_mma.cuh"
#include "ftcf_sm90.cuh"
#include "ftcf_tma.cuh"

#include <type_traits>

namespace ftcf {

constexpr int GM_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GM_BM = 128;       // rows of x per block (the products' N)
constexpr int GM_BN = 128;       // output channels per block, 64 per consumer
constexpr int GM_BK = 64;        // k per stage: one 128-byte swizzle row of x
constexpr int GM_MAX_STAGES = 8;     // the ring takes what shared memory holds, up to this
constexpr int GM_GROUP_M = 8;        // row tiles a group of blocks sweeps (L2 reuse)
constexpr int GM_SMEM_MAX = 232448;  // what a block may use on an H100

// One output segment of the GEMM: its activations, weight, scales, bias,
// activation and output. K13's prefill form joins two over N (the qkv and
// up columns); K1/K6/K7/K8 run one.
struct GemmSeg {
  const __nv_bfloat16* x;       // [M, K]
  const int8_t* w;              // [K, N] int8 or [K/2, N] packed int4
  const float* scale;           // [N] per-channel, or nullptr with group scales
  const void* gscale;           // [K/G, N] group scales: bf16 (W_I4G) or fp32 (W_I4GF, W_I8G)
  const void* bias;
  int bias_bf16;
  int act;
  void* y;                      // [M, N]
  int N;
};

template <int FMT>
struct GemmTile {
  static constexpr bool I8 = FMT == W_I8 || FMT == W_I8G;     // one K row a byte row
  static constexpr int X_BYTES = GM_BM * GM_BK * 2;          // 16 KB, swizzled
  static constexpr int W_ROWS = I8 ? GM_BK : GM_BK / 2;
  static constexpr int W_BYTES = W_ROWS * GM_BN;             // raw, swizzled
  // bytes of one group scale: bf16 (W_I4G) or fp32 (W_I4GF, W_I8G), else none
  static constexpr int S_BYTES = FMT == W_I4G ? 2 : FMT == W_I4GF || FMT == W_I8G ? 4 : 0;
};

// bf16x2 a (two exact int4 values) times the fp32 scale s, each product
// rounded once to fp32 and then to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2_f32(uint32_t a, float s) {
  float f[2];
  bf16x2_to_f32(a, f);
  return pack_bf16(__fmul_rn(f[0], s), __fmul_rn(f[1], s));
}

// bf16x2 a * s rounded once (the exact product of two bf16, as fp32 would
// hold it, rounded to bf16); -0 as the addend keeps the product's sign.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t s) {
  return fma_bf16x2(a, s, 0x80008000u);
}

// Block b of a 1-D grid: the output tiles in groups of GM_GROUP_M row tiles
// (s1's column tiles, then s2's; none when s2.N is 0), a group's blocks row
// tile fastest, so that the blocks in flight share their x and weight panels
// in L2. ``gr`` group-scale rows a stage holds (W_I4G, W_I4GF, W_I8G); ``stage_bytes`` one
// stage of x, raw weight and scales, 1024-aligned; ``stages`` the ring's
// depth.
template <int FMT>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmm_gemm_kernel(const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap ts1, const __grid_constant__ CUtensorMap tx2,
                const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap ts2,
                GemmSeg s1, GemmSeg s2, int G, int gr, int stage_bytes, int stages, int out_f32,
                int M, int K) {
  using T = GemmTile<FMT>;
  constexpr int BN = GM_BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;  // swizzled tiles: 1024-byte aligned
  unsigned char* sm = smem_raw + (base - raw_base);
  // full[stage] (the producer's arrive + TMA bytes), empty[stage] (every
  // consumer thread, once its products have read the stage's x)
  const uint32_t full = base + stages * stage_bytes, empty = full + 8 * stages;

  const int t1 = (s1.N + BN - 1) / BN, tn = t1 + (s2.N + BN - 1) / BN;
  const int tm = (M + GM_BM - 1) / GM_BM;
  const int per_group = GM_GROUP_M * tn, first = (int)blockIdx.x / per_group * GM_GROUP_M;
  const int rows = min(tm - first, GM_GROUP_M), in_group = (int)blockIdx.x % per_group;
  const int mt = first + in_group % rows, nt = in_group / rows;
  const bool second = nt >= t1;
  const int m0 = mt * GM_BM;
  const int n0 = (second ? nt - t1 : nt) * BN;
  const int nk = (K + GM_BK - 1) / GM_BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread issues every load
    if (tid == 0) {
      const CUtensorMap* mx = second ? &tx2 : &tx1;
      const CUtensorMap* mw = second ? &tw2 : &tw1;
      const CUtensorMap* ms = second ? &ts2 : &ts1;
      const uint32_t bytes = T::X_BYTES + T::W_BYTES + gr * BN * T::S_BYTES;
      for (int kt = 0, st = 0, ph = 0; kt < nk; ++kt) {
        if (kt >= stages) mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t sx = base + st * stage_bytes, bar = full + 8 * st;
        mbar_arrive_expect_tx(bar, bytes);
        tma_load_2d(sx, mx, bar, kt * GM_BK, m0);
        tma_load_2d(sx + T::X_BYTES, mw, bar, n0, kt * T::W_ROWS);
        if constexpr (T::S_BYTES > 0)
          tma_load_2d(sx + T::X_BYTES + T::W_BYTES, ms, bar, n0, kt * GM_BK / G);
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int ct = tid - 128;
  const int cw = ct >> 7;  // consumer warpgroup: channels 64 cw .. 64 cw + 63 of the block
  const int wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int wc = cw * 4 + warp;  // the warp's 16 channels: the 16-byte chunk wc of a row

  float acc[GM_BM / 2];
#pragma unroll
  for (int i = 0; i < GM_BM / 2; ++i) acc[i] = 0.0f;
  const float ginv = T::S_BYTES > 0 ? 1.0f / (float)G : 0.0f;
  uint32_t fa[4][4], fb[4][4];  // A fragments of a k tile's four k16 steps, in turns

  // k tile kt's raw weight -> this warp's A fragments, once its stage landed
  auto load = [&](int kt, uint32_t(&f)[4][4]) {
    const int st = kt % stages;
    mbar_wait(full + 8 * st, (kt / stages) & 1);
    const unsigned char* w = sm + st * stage_bytes + T::X_BYTES;
    // the 16-byte chunk of the warp's channels in raw row r (swizzled)
    auto row = [&](int r) { return w + r * 128 + ((wc ^ (r & 7)) << 4); };
    if constexpr (T::I8) {
      // matrix q of half h: k rows 32 h + 8 q .. + 7 (lane l gives row 32 h + l);
      // step 2 h + q / 2, its k rows 0-7 (q even: a0, a1) or 8-15 (a2, a3)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, row(32 * h + lane));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // bytes 0 and 2 are k rows 2t, 2t + 1 of channel 2g; 1 and 3 of 2g + 1
          uint32_t* a = f[2 * h + (q >> 1)] + 2 * (q & 1);
          a[0] = i8_rows_bf16x2(r[q]);
          a[1] = i8_rows_bf16x2(r[q] >> 8);
        }
      }
    } else {
      // matrix q = k16 step q: its row 2 i is pair row 8 q + i, row 2 i + 1
      // pair row 8 q + i + 4, so a thread's bytes are pair rows t (k rows
      // 2t, 2t + 1) and t + 4 (2t + 8, 2t + 9) of channels 2g, 2g + 1
      const int q = lane >> 3, i = lane & 7;
      uint32_t r[4];
      ldmatrix_x4_trans(r, row(8 * q + (i >> 1) + 4 * (i & 1)));
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        f[s][0] = i4_pair_bf16x2<0>(r[s]);
        f[s][1] = i4_pair_bf16x2<1>(r[s]);
        f[s][2] = i4_pair_bf16x2<2>(r[s]);
        f[s][3] = i4_pair_bf16x2<3>(r[s]);
      }
    }
    if constexpr (T::S_BYTES > 0) {
      // each pair of k rows shares a group (G even; the fragments hold k
      // row pairs of one channel, int8 and int4 alike): the scales of
      // channels 2g, 2g + 1 at k rows 16 s + 2t and 16 s + 2t + 8 of the
      // tile, from the stage's scale rows (the first is group k0 / G)
      const unsigned char* scl = w + T::W_BYTES + (wc * 16 + 2 * g) * T::S_BYTES;
      using SW = std::conditional_t<T::S_BYTES == 2, uint32_t, float2>;
      auto scale = [&](int s, int hh, SW sw) {
        if constexpr (T::S_BYTES == 2) {
          f[s][2 * hh] = mul_bf16x2(f[s][2 * hh], __byte_perm(sw, 0, 0x1010));
          f[s][2 * hh + 1] = mul_bf16x2(f[s][2 * hh + 1], __byte_perm(sw, 0, 0x3232));
        } else {
          f[s][2 * hh] = mul_bf16x2_f32(f[s][2 * hh], sw.x);
          f[s][2 * hh + 1] = mul_bf16x2_f32(f[s][2 * hh + 1], sw.y);
        }
      };
      if (G % GM_BK == 0) {
        // one group holds the whole k tile
        const SW sw = *reinterpret_cast<const SW*>(scl);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          scale(s, 0, sw);
          scale(s, 1, sw);
        }
      } else {
        // the group of k row k0 + kk: floor((k0 + kk + 1/2) / G) by an
        // fp32 reciprocal, exact below 2^22 rows (the error stays under
        // the 1/(2G) to the nearest integer), no integer division
        const int k0 = kt * GM_BK, g0 = k0 / G;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float kr = (float)(k0 + 16 * s + 2 * t + 8 * hh) + 0.5f;
            const int gi = __float2int_rd(kr * ginv) - g0;
            scale(s, hh, *reinterpret_cast<const SW*>(scl + gi * BN * T::S_BYTES));
          }
      }
    }
  };
  // acc += (this warpgroup's 64 channels of k tile kt) x (x tile kt)^T, in
  // 16-deep steps (issued, not waited for)
  auto issue = [&](int kt, uint32_t(&f)[4][4]) {
    const uint32_t sx = base + (kt % stages) * stage_bytes;
    fence_regs(f);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk)
      wgmma_rs_kb_n128(acc, f[kk], desc_sw128(sx + kk * 32, 16, 1024));
    wgmma_commit();
  };
  // tile kt's products are done: its x is read, its fragments free
  auto retire = [&](int kt, uint32_t(&f)[4][4]) {
    wgmma_wait<1>();
    fence_regs(f);
    mbar_arrive(empty + 8 * (kt % stages));
  };

  // Tile kt + 1 is converted and issued while tile kt's products run, then
  // tile kt is waited for: one k tile's products always wait behind
  // another's. acc is touched by nothing but the products from the first
  // issue to the last wait; fa holds the even tiles, fb the odd ones.
  fence_regs(acc);
  load(0, fa);
  issue(0, fa);
  int kt = 0;
  for (; kt + 2 < nk; kt += 2) {
    load(kt + 1, fb);
    issue(kt + 1, fb);
    retire(kt, fa);
    load(kt + 2, fa);
    issue(kt + 2, fa);
    retire(kt + 1, fb);
  }
  if (kt + 1 < nk) {
    load(kt + 1, fb);
    issue(kt + 1, fb);
    retire(kt, fa);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: element 4 j + e of acc is A row g (+ 8 if e & 2) of the warp's
  // 16, i.e. channel 2g (+ 1), and x row 8 j + 2 t + (e & 1)
  const GemmSeg& sg = second ? s2 : s1;
  const int N = sg.N;
  const int n = n0 + wc * 16 + 2 * g;  // this thread's channels n, n + 1
  if (n >= N) return;                  // N % 16 == 0: n and n + 1 lie on one side
  float sa = 1.0f, sb = 1.0f, ba = 0.0f, bb = 0.0f;
  if (sg.scale != nullptr) {
    const float2 sc = *reinterpret_cast<const float2*>(sg.scale + n);
    sa = sc.x;
    sb = sc.y;
  }
  if (sg.bias != nullptr) {
    if (sg.bias_bf16) {
      float fbias[2];
      bf16x2_to_f32(
          *reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(sg.bias) + n),
          fbias);
      ba = fbias[0];
      bb = fbias[1];
    } else {
      const float2 bv = *reinterpret_cast<const float2*>(static_cast<const float*>(sg.bias) + n);
      ba = bv.x;
      bb = bv.y;
    }
  }
#pragma unroll
  for (int j = 0; j < GM_BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= M) continue;
      const float v0 = apply_act(acc[4 * j + e] * sa + ba, sg.act);
      const float v1 = apply_act(acc[4 * j + 2 + e] * sb + bb, sg.act);
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(sg.y) + (size_t)m * N + n) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(sg.y) + (size_t)m * N + n) =
            pack_bf16(v0, v1);
    }
}

// Group-scale rows a 64-deep k tile touches, at most, over the tiles of K
// (a box of that many rows comes with each stage). ops/quant_matmul.py
// gemm_group_rows holds the same rule.
inline int gemm_group_rows(int K, int G) {
  int most = 1;
  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    const int last = (k0 + GM_BK < K ? k0 + GM_BK : K) - 1;
    const int rows = last / G - k0 / G + 1;
    most = rows > most ? rows : most;
  }
  return most;
}

// One segment's tensor maps: x [M, K] bf16 in 64 x 128 boxes and the raw
// weight [K(/2), N] in 128 x 64 (32) boxes, both in the 128-byte swizzle;
// group scales [K/G, N] (bf16 or fp32) in 128 x gr boxes.
template <int FMT>
static bool gemm_maps(const GemmSeg& sg, int M, int K, int G, int gr, CUtensorMap* mx,
                      CUtensorMap* mw, CUtensorMap* ms) {
  using T = GemmTile<FMT>;
  const uint64_t N = sg.N, rows = T::I8 ? K : K / 2;
  if (!tensor_map<2>(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sg.x, {(uint64_t)K, (uint64_t)M},
                     {(uint64_t)K * 2}, {GM_BK, GM_BM}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map<2>(mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, sg.w, {N, rows}, {N},
                     {(uint32_t)GM_BN, (uint32_t)T::W_ROWS}, CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (T::S_BYTES == 0) return true;
  return tensor_map<2>(ms, T::S_BYTES == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       sg.gscale, {N, (uint64_t)(K / G)}, {N * T::S_BYTES},
                       {(uint32_t)GM_BN, (uint32_t)gr}, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int FMT>
static cudaError_t launch_gemm_ncat(GemmSeg s1, GemmSeg s2, int G, int out_f32, int M, int K,
                                   cudaStream_t stream) {
  using T = GemmTile<FMT>;
  constexpr int BN = GM_BN;
  int gr = 0;
  if (T::S_BYTES > 0) {
    if (G < 2 || G % 2 != 0 || K % G != 0) return cudaErrorInvalidValue;
    gr = gemm_group_rows(K, G);
  }
  const int stage_bytes = (T::X_BYTES + T::W_BYTES + gr * BN * T::S_BYTES + 1023) / 1024 * 1024;
  // as many stages as shared memory holds beside the barriers and the
  // alignment slack
  const int stages = min(GM_MAX_STAGES, (GM_SMEM_MAX - 1024) / (stage_bytes + 16));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = stages * (stage_bytes + 16) + 1024;
  CUtensorMap m[6] = {};
  if (!gemm_maps<FMT>(s1, M, K, G, gr, &m[0], &m[1], &m[2]) ||
      (s2.N > 0 && !gemm_maps<FMT>(s2, M, K, G, gr, &m[3], &m[4], &m[5])))
    return cudaErrorInvalidValue;
  auto kern = qmm_gemm_kernel<FMT>;
  // one flag per template instance; benign race: every setter writes the same value
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GM_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int blocks = (M + GM_BM - 1) / GM_BM * ((s1.N + BN - 1) / BN + (s2.N + BN - 1) / BN);
  kern<<<blocks, GM_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], s1, s2, G, gr,
                                             stage_bytes, stages, out_f32, M, K);
  return cudaGetLastError();
}

template <int FMT>
static cudaError_t launch_gemm(const void* x, const void* w, const float* scale,
                               const void* gscale, int G, int M, int K, int N, const void* bias,
                               int bias_bf16, int act, void* y, int out_f32,
                               cudaStream_t stream) {
  const GemmSeg s1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
                   gscale, bias, bias_bf16, act, y, N};
  const GemmSeg s2{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr, 0};
  return launch_gemm_ncat<FMT>(s1, s2, G, out_f32, M, K, stream);
}

}  // namespace ftcf
