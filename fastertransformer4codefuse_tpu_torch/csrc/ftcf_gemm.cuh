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
//  - wgmma m64nROWSk16, A from registers, B = x K-major; the next k tile
//    (or, with 256 channels, the next 64-channel half) is converted and
//    issued before the previous one is waited for, so one step's products
//    always wait behind another's (the fragments alternate between two
//    register sets);
//  - blocks in groups of ``group_m`` row tiles, so that the blocks in flight
//    share their x and weight panels in L2; TMA zero-fills past M, K and N,
//    so every tail is exact;
//  - four block tiles (ftcf_gemm_plan.cuh, chosen per shape by the tile
//    cache): ROWS x CH = 128 x 128, 64 x 128 (wgmma n64, acc[32]), 128 x
//    256 (the weight in two 128-column panels, consumer warpgroup cw owning
//    panel cw as two 64-channel halves with an accumulator each) and 256 x
//    128 (wgmma n256); the last two hold 128 fp32 accumulators a consumer
//    thread, so setmaxnreg gives the producer 40 registers and the consumers
//    232, as K10 does; the k tile is 64 in all four;
//  - the epilogue applies the per-channel scale, bias and activation to the
//    fp32 accumulators in registers and stores channel pairs (bf16x2 or
//    float2);
//  - every output element sums its k tiles in one order, whatever M and
//    whatever the tile: a row's output does not depend on M, on the rows
//    beside it or on the plan, and two calls give equal bytes.
#pragma once

#include "ftcf_common.cuh"
#include "ftcf_gemm_plan.cuh"
#include "ftcf_gemv.cuh"
#include "ftcf_mma.cuh"
#include "ftcf_sm90.cuh"
#include "ftcf_tma.cuh"

#include <type_traits>

namespace ftcf {

constexpr int GM_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GM_BK = 64;        // k per stage: one 128-byte swizzle row of x
constexpr int GM_MAX_STAGES = 8;     // the most stages a plan may ask for
constexpr int GM_SMEM_MAX = 232448;  // what a block may use on an H100

// A block tile: ROWS rows of x (the products' N) x CH output channels.
template <int FMT, int ROWS, int CH>
struct GemmTile {
  static_assert((ROWS == 64 || ROWS == 128 || ROWS == 256) && (CH == 128 || CH == 256),
                "no such GEMM tile");
  static constexpr bool I8 = FMT == W_I8 || FMT == W_I8G;     // one K row a byte row
  static constexpr int HALVES = CH / 128;     // 64-channel products of a consumer warpgroup
  static constexpr int X_BYTES = ROWS * GM_BK * 2;           // swizzled
  static constexpr int W_ROWS = I8 ? GM_BK : GM_BK / 2;
  static constexpr int PANEL = W_ROWS * 128;  // one 128-column box of raw weight, swizzled
  static constexpr int W_BYTES = PANEL * HALVES;
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

// Block b of a 1-D grid: the output tiles in groups of ``group_m`` row tiles
// (s1's column tiles, then s2's; none when s2.N is 0), a group's blocks row
// tile fastest, so that the blocks in flight share their x and weight panels
// in L2. ``gr`` group-scale rows a stage holds (W_I4G, W_I4GF, W_I8G);
// ``stage_bytes`` one stage of x, raw weight and scales, 1024-aligned;
// ``stages`` the ring's depth.
template <int FMT, int ROWS, int CH>
__global__ void __launch_bounds__(GM_THREADS, 1)
qmm_gemm_kernel(const __grid_constant__ CUtensorMap tx1, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap ts1, const __grid_constant__ CUtensorMap tx2,
                const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap ts2,
                GemmSeg s1, GemmSeg s2, int G, int gr, int stage_bytes, int stages, int group_m,
                int out_f32, int M, int K) {
  using T = GemmTile<FMT, ROWS, CH>;
  constexpr int NH = T::HALVES;
  // 128 fp32 accumulators a consumer thread: setmaxnreg moves registers
  // from the producer to the consumers
  constexpr bool WIDE = NH * ROWS >= 256;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;  // swizzled tiles: 1024-byte aligned
  unsigned char* sm = smem_raw + (base - raw_base);
  // full[stage] (the producer's arrive + TMA bytes), empty[stage] (every
  // consumer thread, once its products have read the stage's x)
  const uint32_t full = base + stages * stage_bytes, empty = full + 8 * stages;

  const int t1 = (s1.N + CH - 1) / CH, tn = t1 + (s2.N + CH - 1) / CH;
  const int tm = (M + ROWS - 1) / ROWS;
  const int per_group = group_m * tn, first = (int)blockIdx.x / per_group * group_m;
  const int rows = min(tm - first, group_m), in_group = (int)blockIdx.x % per_group;
  const int mt = first + in_group % rows, nt = in_group / rows;
  const bool second = nt >= t1;
  const int m0 = mt * ROWS;
  const int n0 = (second ? nt - t1 : nt) * CH;
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
    if constexpr (WIDE) regs_dec<40>();
    if (tid == 0) {
      const CUtensorMap* mx = second ? &tx2 : &tx1;
      const CUtensorMap* mw = second ? &tw2 : &tw1;
      const CUtensorMap* ms = second ? &ts2 : &ts1;
      const uint32_t bytes = T::X_BYTES + T::W_BYTES + gr * CH * T::S_BYTES;
      for (int kt = 0, st = 0, ph = 0; kt < nk; ++kt) {
        if (kt >= stages) mbar_wait(empty + 8 * st, ph ^ 1);
        const uint32_t sx = base + st * stage_bytes, bar = full + 8 * st;
        mbar_arrive_expect_tx(bar, bytes);
        tma_load_2d(sx, mx, bar, kt * GM_BK, m0);
#pragma unroll
        for (int p = 0; p < NH; ++p)
          tma_load_2d(sx + T::X_BYTES + p * T::PANEL, mw, bar, n0 + 128 * p, kt * T::W_ROWS);
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
  if constexpr (WIDE) regs_inc<232>();

  const int ct = tid - 128;
  const int cw = ct >> 7;  // consumer warpgroup: channels cw CH/2 .. (cw + 1) CH/2 - 1
  const int wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  // the block channel of this warp's 16 in half h of its warpgroup's channels
  auto chan = [&](int h) { return cw * (CH / 2) + h * 64 + warp * 16; };

  float acc[NH][ROWS / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) acc[h][i] = 0.0f;
  const float ginv = T::S_BYTES > 0 ? 1.0f / (float)G : 0.0f;
  uint32_t fa[4][4], fb[4][4];  // A fragments of a step's four k16 steps, in turns

  // Step s is half h = s % NH of k tile s / NH. Its raw weight -> this
  // warp's A fragments, once its stage landed
  auto load = [&](int s, int h, uint32_t(&f)[4][4]) {
    const int kt = s / NH, st = kt % stages;
    mbar_wait(full + 8 * st, (kt / stages) & 1);
    const int c = chan(h);
    const unsigned char* stage = sm + st * stage_bytes;
    const unsigned char* w = stage + T::X_BYTES + (c >> 7) * T::PANEL;
    const int wc = (c & 127) >> 4;  // the 16-byte chunk of the warp's channels in a panel row
    // the chunk in raw row r (swizzled)
    auto row = [&](int r) { return w + r * 128 + ((wc ^ (r & 7)) << 4); };
    if constexpr (T::I8) {
      // matrix q of half hh: k rows 32 hh + 8 q .. + 7 (lane l gives row 32 hh + l);
      // step 2 hh + q / 2, its k rows 0-7 (q even: a0, a1) or 8-15 (a2, a3)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, row(32 * hh + lane));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // bytes 0 and 2 are k rows 2t, 2t + 1 of channel 2g; 1 and 3 of 2g + 1
          uint32_t* a = f[2 * hh + (q >> 1)] + 2 * (q & 1);
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
      for (int s4 = 0; s4 < 4; ++s4) {
        f[s4][0] = i4_pair_bf16x2<0>(r[s4]);
        f[s4][1] = i4_pair_bf16x2<1>(r[s4]);
        f[s4][2] = i4_pair_bf16x2<2>(r[s4]);
        f[s4][3] = i4_pair_bf16x2<3>(r[s4]);
      }
    }
    if constexpr (T::S_BYTES > 0) {
      // each pair of k rows shares a group (G even; the fragments hold k
      // row pairs of one channel, int8 and int4 alike): the scales of
      // channels 2g, 2g + 1 at k rows 16 s + 2t and 16 s + 2t + 8 of the
      // tile, from the stage's scale rows (the first is group k0 / G; CH
      // scales a row)
      const unsigned char* scl = stage + T::X_BYTES + T::W_BYTES + (c + 2 * g) * T::S_BYTES;
      using SW = std::conditional_t<T::S_BYTES == 2, uint32_t, float2>;
      auto scale = [&](int s4, int hh, SW sw) {
        if constexpr (T::S_BYTES == 2) {
          f[s4][2 * hh] = mul_bf16x2(f[s4][2 * hh], __byte_perm(sw, 0, 0x1010));
          f[s4][2 * hh + 1] = mul_bf16x2(f[s4][2 * hh + 1], __byte_perm(sw, 0, 0x3232));
        } else {
          f[s4][2 * hh] = mul_bf16x2_f32(f[s4][2 * hh], sw.x);
          f[s4][2 * hh + 1] = mul_bf16x2_f32(f[s4][2 * hh + 1], sw.y);
        }
      };
      if (G % GM_BK == 0) {
        // one group holds the whole k tile
        const SW sw = *reinterpret_cast<const SW*>(scl);
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          scale(s4, 0, sw);
          scale(s4, 1, sw);
        }
      } else {
        // the group of k row k0 + kk: floor((k0 + kk + 1/2) / G) by an
        // fp32 reciprocal, exact below 2^22 rows (the error stays under
        // the 1/(2G) to the nearest integer), no integer division
        const int k0 = kt * GM_BK, g0 = k0 / G;
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float kr = (float)(k0 + 16 * s4 + 2 * t + 8 * hh) + 0.5f;
            const int gi = __float2int_rd(kr * ginv) - g0;
            scale(s4, hh, *reinterpret_cast<const SW*>(scl + gi * CH * T::S_BYTES));
          }
      }
    }
  };
  // d += (this warp's channels of step s) x (x tile s / NH)^T, in 16-deep
  // steps (issued, not waited for)
  auto issue = [&](int s, uint32_t(&f)[4][4], float(&d)[ROWS / 2]) {
    const uint32_t sx = base + ((s / NH) % stages) * stage_bytes;
    fence_regs(f);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {
      if constexpr (ROWS == 64)
        wgmma_rs_kb_n64(d, f[kk], desc_sw128(sx + kk * 32, 16, 1024));
      else if constexpr (ROWS == 128)
        wgmma_rs_kb_n128(d, f[kk], desc_sw128(sx + kk * 32, 16, 1024));
      else
        wgmma_rs_kb_n256(d, f[kk], desc_sw128(sx + kk * 32, 16, 1024));
    }
    wgmma_commit();
  };
  // step s's products are done: its fragments are free, and after a k
  // tile's last half its x is read
  auto retire = [&](int s, int h, uint32_t(&f)[4][4]) {
    wgmma_wait<1>();
    fence_regs(f);
    if (h == NH - 1) mbar_arrive(empty + 8 * ((s / NH) % stages));
  };

  // Step s + 1 is converted and issued while step s's products run, then
  // step s is waited for: one step's products always wait behind another's.
  // acc is touched by nothing but the products from the first issue to the
  // last wait; fa holds the even steps, fb the odd ones (with two halves, fa
  // half 0 into acc[0] and fb half 1 into acc[1]).
  const int ns = nk * NH;
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);
  load(0, 0, fa);
  issue(0, fa, acc[0]);
  int s = 0;
  for (; s + 2 < ns; s += 2) {
    load(s + 1, NH - 1, fb);
    issue(s + 1, fb, acc[NH - 1]);
    retire(s, 0, fa);
    load(s + 2, 0, fa);
    issue(s + 2, fa, acc[0]);
    retire(s + 1, NH - 1, fb);
  }
  if (s + 1 < ns) {
    load(s + 1, NH - 1, fb);
    issue(s + 1, fb, acc[NH - 1]);
    retire(s, 0, fa);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs(acc[h]);

  // epilogue: element 4 j + e of acc[h] is A row g (+ 8 if e & 2) of the
  // warp's 16 channels of half h, i.e. channel 2g (+ 1), and x row 8 j + 2 t
  // + (e & 1)
  const GemmSeg& sg = second ? s2 : s1;
  const int N = sg.N;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const int n = n0 + chan(h) + 2 * g;  // this thread's channels n, n + 1
    if (n >= N) continue;                // N % 16 == 0: n and n + 1 lie on one side
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
        const float2 bv =
            *reinterpret_cast<const float2*>(static_cast<const float*>(sg.bias) + n);
        ba = bv.x;
        bb = bv.y;
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= M) continue;
        const float v0 = apply_act(acc[h][4 * j + e] * sa + ba, sg.act);
        const float v1 = apply_act(acc[h][4 * j + 2 + e] * sb + bb, sg.act);
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(sg.y) + (size_t)m * N + n) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(sg.y) + (size_t)m * N + n) =
              pack_bf16(v0, v1);
      }
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

// One segment's tensor maps: x [M, K] bf16 in 64 x ROWS boxes and the raw
// weight [K(/2), N] in 128 x 64 (32) boxes (one per 128-column panel), both
// in the 128-byte swizzle; group scales [K/G, N] (bf16 or fp32) in CH x gr
// boxes.
template <int FMT, int ROWS, int CH>
static bool gemm_maps(const GemmSeg& sg, int M, int K, int G, int gr, CUtensorMap* mx,
                      CUtensorMap* mw, CUtensorMap* ms) {
  using T = GemmTile<FMT, ROWS, CH>;
  const uint64_t N = sg.N, rows = T::I8 ? K : K / 2;
  if (!tensor_map<2>(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sg.x, {(uint64_t)K, (uint64_t)M},
                     {(uint64_t)K * 2}, {GM_BK, ROWS}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map<2>(mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, sg.w, {N, rows}, {N},
                     {128u, (uint32_t)T::W_ROWS}, CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (T::S_BYTES == 0) return true;
  return tensor_map<2>(ms, T::S_BYTES == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       sg.gscale, {N, (uint64_t)(K / G)}, {N * T::S_BYTES},
                       {(uint32_t)CH, (uint32_t)gr}, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int FMT, int ROWS, int CH>
static cudaError_t launch_gemm_tile(const GemmSeg& s1, const GemmSeg& s2, int G, int out_f32,
                                    int M, int K, int group_m, int max_stages,
                                    cudaStream_t stream) {
  using T = GemmTile<FMT, ROWS, CH>;
  if (group_m < 1 || max_stages < 2 || max_stages > GM_MAX_STAGES) return cudaErrorInvalidValue;
  int gr = 0;
  if (T::S_BYTES > 0) {
    if (G < 2 || G % 2 != 0 || K % G != 0) return cudaErrorInvalidValue;
    gr = gemm_group_rows(K, G);
  }
  const int stage_bytes = (T::X_BYTES + T::W_BYTES + gr * CH * T::S_BYTES + 1023) / 1024 * 1024;
  // as many stages as shared memory holds beside the barriers and the
  // alignment slack, up to the plan's cap
  const int stages = min(max_stages, (GM_SMEM_MAX - 1024) / (stage_bytes + 16));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = stages * (stage_bytes + 16) + 1024;
  CUtensorMap m[6] = {};
  if (!gemm_maps<FMT, ROWS, CH>(s1, M, K, G, gr, &m[0], &m[1], &m[2]) ||
      (s2.N > 0 && !gemm_maps<FMT, ROWS, CH>(s2, M, K, G, gr, &m[3], &m[4], &m[5])))
    return cudaErrorInvalidValue;
  auto kern = qmm_gemm_kernel<FMT, ROWS, CH>;
  // one flag per template instance; benign race: every setter writes the same value
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GM_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int blocks = (M + ROWS - 1) / ROWS * ((s1.N + CH - 1) / CH + (s2.N + CH - 1) / CH);
  kern<<<blocks, GM_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], s1, s2, G, gr,
                                             stage_bytes, stages, group_m, out_f32, M, K);
  return cudaGetLastError();
}

// The instances of one block tile over the weight formats: the body of
// gemm_tile_<ROWS>x<CH> (ftcf_gemm_plan.cuh) in gemm_<ROWS>x<CH>.cu.
template <int ROWS, int CH>
static cudaError_t gemm_tile(int fmt, const GemmSeg& s1, const GemmSeg& s2, int G, int out_f32,
                             int M, int K, int group_m, int stages, cudaStream_t stream) {
  switch (fmt) {
    case W_I8:
      return launch_gemm_tile<W_I8, ROWS, CH>(s1, s2, G, out_f32, M, K, group_m, stages, stream);
    case W_I4:
      return launch_gemm_tile<W_I4, ROWS, CH>(s1, s2, G, out_f32, M, K, group_m, stages, stream);
    case W_I4G:
      return launch_gemm_tile<W_I4G, ROWS, CH>(s1, s2, G, out_f32, M, K, group_m, stages, stream);
    case W_I8G:
      return launch_gemm_tile<W_I8G, ROWS, CH>(s1, s2, G, out_f32, M, K, group_m, stages, stream);
    case W_I4GF:
      return launch_gemm_tile<W_I4GF, ROWS, CH>(s1, s2, G, out_f32, M, K, group_m, stages,
                                                stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ftcf
