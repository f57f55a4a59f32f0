// K10: chunked-prefill attention over the paged KV pool, on wgmma + TMA.
//
// Row b brings C consecutive queries starting at logical position pos[b];
// query c with head j of KV group h attends keys 0 .. pos[b] + c. Replaces
// fastertransformer4codefuse_tpu/ops/flash_decode.py flash_chunk_paged
// (_kernel in chunk mode).
//
// Math: the C queries and the gq query heads of a KV head ride one row axis,
// r = c * gq + j, bounded at start + r / gq; scores = (q . k) * k_s *
// sm_scale, masked per row; online softmax in fp32 (exp2, log2 e folded into
// the scale); (p * v_s) rounded to bf16 before the P V product (int8 and
// int4 -> bf16 are exact; bf16 K/V round p alone); the denominator sums the
// unrounded fp32 p. Pages are bf16, int8 or packed int4 (K and V templated
// apart: "int8k_int4v" mixes them); a packed pair row holds positions 2i
// (low nibble) and 2i + 1.
//
// Bound: at CodeFuse-13B with C = 128 queries over ~1000 keys a row is
// ~2.7 GFLOP a layer against ~10.5 MB of int8 K/V, near the card's
// 295 FLOP/byte balance: both products run on the tensor cores by wgmma,
// and the pages arrive by TMA, so no thread spends registers or
// instructions on the copies.
//
// Design (one block per 128-row query tile, KV head and row b, as K5's
// prefill_flash.cu):
//  - schedule: the blocks with the most key tiles start first. The work of a
//    (query tile, row) pair depends on pos[b], which lives on the device, so
//    each block ranks the pairs itself (work descending, index ascending)
//    and takes the pair of its rank; past FC_MAX_RANKED pairs, query tiles
//    descending;
//  - three warpgroups: a producer, whose first warp keeps the K and V tiles
//    of the block's key range (64 keys at dh 128, 32 at dh 256) in flight by
//    TMA into a ring of four stages (full and empty mbarriers), and two
//    consumers of 64 query rows each; setmaxnreg gives the producer 40
//    registers and the consumers 232 (without it the dh 256 instances
//    spill and ptxas serializes their products);
//  - page addressing: the producer reads the block table and issues one TMA
//    box per (page, key range) over a 4-D tensor map of the layer's page
//    slab [P, nKV, ps(/2), dh]: key s of head h is row (page nKV + h) ps +
//    s % ps. A box holds g = gcd(ps, key tile) keys (g / 2 pair rows of
//    packed int4), so no box crosses a page and a tile takes tile / g boxes;
//    keys past the block's last bound are never requested past its tile,
//    and page ids past the row's table are clamped to its last page;
//  - bf16 pages land straight in the 128-byte swizzled layout wgmma reads
//    (64-dim column blocks, K K-major for Q K^T, V MN-major with the
//    transpose bit for P V) where a box holds whole 8-row swizzle groups (g
//    a multiple of 8). int8 and packed int4 pages, and bf16 pages of other
//    sizes, land raw; the two consumers convert a tile to bf16 (a copy for
//    bf16) into one of two swizzled buffers (exactly, as the GEMV's
//    conversions), load its scales through the block table, and release the
//    raw stage (a ring of two stages for raw bf16 rows, so that the two
//    converted buffers still fit). The conversion of tile t + 1 runs
//    while tile t's P V is in flight; one 256-thread barrier a tile (after
//    fence.proxy.async) publishes it and frees the other buffer;
//  - keys past the block's last bound are real memory (stale bytes): S is
//    masked per row in the tiles that hold a bound, and V's rows there are
//    zero before P V reads them (written as zeros by the conversion; for
//    bf16 pages zeroed by the two consumers, rows split between them, then
//    fence.proxy.async and one 256-thread barrier before either's P V);
//  - Q is read once, by the consumers, into the swizzled layout;
//  - S = Q K^T by wgmma (n64 at dh 128, n32 at dh 256), both operands from
//    shared memory; O += P V by wgmma with P (bf16) from registers;
//  - no atomics and no split over keys: two calls give equal bytes.
#include "ftcf_common.cuh"
#include "ftcf_mma.cuh"
#include "ftcf_sm90.cuh"
#include "ftcf_tma.cuh"

namespace ftcf {

constexpr int FC_THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int FC_BM = 128;           // query rows per block, 64 per consumer
constexpr int FC_MAX_RANKED = 256;   // (query tile, row) pairs a block ranks
// The format of bf16 pages landed as raw rows (a page size that is not a
// multiple of 8: a box cannot hold whole 8-row swizzle groups), beside KVFmt.
constexpr int FC_BF16_ROWS = 3;

template <int DH, int KF, int VF>
struct ChunkTile {
  static constexpr bool STAGED = KF != KV_BF16;             // raw tiles, converted
  static constexpr bool QUANT = KF == KV_I8 || KF == KV_I4;  // with scales
  static constexpr int STAGES = KF == FC_BF16_ROWS ? 2 : 4;  // TMA ring depth
  static constexpr int BN = DH == 128 ? 64 : 32;  // keys per tile: 16 KB of bf16 K
  static constexpr int CB = DH / 64;              // 64-wide column blocks
  static constexpr int Q_BYTES = FC_BM * DH * 2;
  static constexpr int TILE = BN * DH * 2;        // a bf16 K (or V) tile, swizzled
  static constexpr int CBLK = BN * 128;           // one column block of it
  // a raw tile as it lands: bf16 swizzled, bf16 rows [BN][dh], int8
  // [BN][dh], int4 [BN/2][dh]
  static constexpr int raw(int f) {
    return f == KV_BF16 || f == FC_BF16_ROWS ? TILE : f == KV_I8 ? BN * DH : BN * DH / 2;
  }
  static constexpr int RAW_K = raw(KF), RAW_V = raw(VF);
  static constexpr int STAGE = RAW_K + RAW_V;
  static constexpr int CONV = STAGED ? 2 * 2 * TILE : 0;  // two converted (K, V) buffers
  static constexpr int SCALES = QUANT ? 2 * 2 * BN * 4 : 0;  // their fp32 k_s and v_s
  static constexpr int RING = Q_BYTES + CONV;
  static constexpr int BARS = RING + STAGES * STAGE + SCALES;
  static constexpr int SCHED = BARS + 2 * STAGES * 8;
  static constexpr size_t SMEM = SCHED + (FC_MAX_RANKED + 1) * 4 + 1024;  // + alignment slack
};

template <int DH>
__device__ __forceinline__ void wgmma_qk(float (&s)[DH == 128 ? 32 : 16], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (DH == 128)
    wgmma_ss_n64(s, da, db, acc);
  else
    wgmma_ss_n32(s, da, db, acc);
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n256(o, a, db);
}

// Sixteen floats as two 16-byte bf16 chunks.
__device__ __forceinline__ void store_bf16x16(unsigned char* c0, unsigned char* c1,
                                              const float* f) {
  *reinterpret_cast<uint4*>(c0) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                             pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  *reinterpret_cast<uint4*>(c1) = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]),
                                             pack_bf16(f[12], f[13]), pack_bf16(f[14], f[15]));
}

// One raw tile (bf16 [BN][dh], int8 [BN][dh] or packed int4 [BN/2][dh]) ->
// the bf16 swizzled tile at dst, 256 threads (ct), keys past key_end as
// zeros. A thread converts 16 bytes at a time: 8 dims of one key (bf16), 16
// dims of one key (int8) or of two keys (int4: the low nibbles hold the
// even key).
template <int DH, int F, int BN>
__device__ __forceinline__ void convert_tile(const unsigned char* raw, unsigned char* dst, int k0,
                                             int key_end, int ct) {
  // the 16-byte chunk of dims d .. d + 7 of key row kr in the swizzled tile
  auto chunk = [&](int kr, int d) {
    return dst + (d >> 6) * (BN * 128) + kr * 128 + ((((d & 63) >> 3) ^ (kr & 7)) << 4);
  };
  if constexpr (F == FC_BF16_ROWS) {
    constexpr int CH = DH / 8;  // 16-byte chunks of a raw row
#pragma unroll
    for (int i = ct; i < BN * CH; i += 256) {
      const int r = i / CH, d = (i - r * CH) * 8;
      uint4 u = *reinterpret_cast<const uint4*>(raw + (r * DH + d) * 2);
      if (k0 + r > key_end) u = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(chunk(r, d)) = u;
    }
    return;
  }
  constexpr int CH = DH / 16;  // 16-byte chunks of a raw row
  constexpr int ROWS = F == KV_I8 ? BN : BN / 2;
#pragma unroll
  for (int i = ct; i < ROWS * CH; i += 256) {
    const int r = i / CH, d = (i - r * CH) * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(raw + r * DH + d);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float f[16];
    if constexpr (F == KV_I8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) i8x4_to_f32(w[e], f + 4 * e);
      if (k0 + r > key_end)
#pragma unroll
        for (int e = 0; e < 16; ++e) f[e] = 0.0f;
      store_bf16x16(chunk(r, d), chunk(r, d + 8), f);
    } else {
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int kr = 2 * r + odd;
#pragma unroll
        for (int e = 0; e < 4; ++e) i4x4_nibble_to_f32(w[e], odd, f + 4 * e);
        if (k0 + kr > key_end)
#pragma unroll
          for (int e = 0; e < 16; ++e) f[e] = 0.0f;
        store_bf16x16(chunk(kr, d), chunk(kr, d + 8), f);
      }
    }
  }
}

template <int DH, int KF, int VF>
__global__ void __launch_bounds__(FC_THREADS, 1)
flash_chunk_kernel(const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ ks, const __nv_bfloat16* __restrict__ vs,
                   const int* __restrict__ pos, const int* __restrict__ pt,
                   __nv_bfloat16* __restrict__ out, int B, int C, int nKV, int gq, int n_pg,
                   int ps, int g, float scale2) {
  using T = ChunkTile<DH, KF, VF>;
  constexpr int BN = T::BN;
  constexpr bool QUANT = T::QUANT, STAGED = T::STAGED;
  constexpr int NST = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw_base);
  const uint32_t sQ = base;
  const uint32_t bars = base + T::BARS;  // full[stage], then empty[stage]
  int* sched = reinterpret_cast<int*>(sm + T::SCHED);
  float* scales = reinterpret_cast<float*>(sm + T::BARS - T::SCALES);  // [2][k_s, v_s][BN]
  auto stage = [&](int t) { return T::RING + (t % NST) * T::STAGE; };  // byte offsets

  const int tid = threadIdx.x;
  const int R = C * gq, nH = nKV * gq;
  const int n_rt = (R + FC_BM - 1) / FC_BM;
  const int keys = n_pg * ps;
  const int h = (int)blockIdx.x % nKV, rank = (int)blockIdx.x / nKV;
  // the last key any row of query tile ``tl`` of row ``bb`` may see (inclusive)
  auto last_key = [&](int tl, int bb) {
    return min(pos[bb] + (min(R, tl * FC_BM + FC_BM) - 1) / gq, keys - 1);
  };

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(bars + 8 * st, 1);            // the producer's arrive + TMA bytes
      mbar_init(bars + 8 * (NST + st), 256);  // every consumer thread
    }
    mbar_fence_init();
  }
  // this block's (query tile, row): rank ``rank`` of the pairs by key tiles
  int tile, b;
  const int n_cand = n_rt * B;
  if (n_cand <= FC_MAX_RANKED) {
    if (tid < n_cand) sched[tid] = last_key(tid / B, tid % B) / BN;
    __syncthreads();
    if (tid < n_cand) {
      const int w = sched[tid];
      int r = 0;
      for (int j = 0; j < n_cand; ++j) {
        const int wj = sched[j];
        r += wj > w || (wj == w && j < tid);
      }
      if (r == rank) sched[FC_MAX_RANKED] = tid;
    }
    __syncthreads();
    const int pick = sched[FC_MAX_RANKED];
    tile = pick / B;
    b = pick - tile * B;
  } else {
    __syncthreads();
    tile = n_rt - 1 - rank / B;
    b = rank % B;
  }
  const int r0 = tile * FC_BM;
  const int p0 = pos[b];
  const int key_end = last_key(tile, b);
  const int n_tiles = key_end / BN + 1;
  const int* ptb = pt + (size_t)b * n_pg;

  if (tid < 128) {
    // producer warpgroup: its first warp issues every load, a lane a box
    regs_dec<40>();
    if (tid < 32) {
      const int nbox = BN / g;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NST;
        int page[2] = {0, 0};  // the pages of this lane's boxes (nbox <= 64)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = tid + 32 * u;
          if (i < nbox) page[u] = ptb[min((t * BN + i * g) / ps, n_pg - 1)];
        }
        if (t >= NST) mbar_wait(bars + 8 * (NST + st), (t / NST - 1) & 1);
        const uint32_t full = bars + 8 * st;
        if (tid == 0) mbar_arrive_expect_tx(full, T::STAGE);
        __syncwarp();
        const uint32_t sK = base + stage(t), sV = sK + T::RAW_K;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = tid + 32 * u;
          if (i >= nbox) continue;
          const int row = (t * BN + i * g) % ps;
          if constexpr (KF == KV_BF16) {
#pragma unroll
            for (int cb = 0; cb < T::CB; ++cb) {
              tma_load_4d(sK + cb * T::CBLK + i * g * 128, &tmk, full, cb * 64, row, h, page[u]);
              tma_load_4d(sV + cb * T::CBLK + i * g * 128, &tmv, full, cb * 64, row, h, page[u]);
            }
          } else {
            if constexpr (KF == FC_BF16_ROWS)
              tma_load_4d(sK + i * g * DH * 2, &tmk, full, 0, row, h, page[u]);
            else if constexpr (KF == KV_I8)
              tma_load_4d(sK + i * g * DH, &tmk, full, 0, row, h, page[u]);
            else
              tma_load_4d(sK + i * (g / 2) * DH, &tmk, full, 0, row / 2, h, page[u]);
            if constexpr (VF == FC_BF16_ROWS)
              tma_load_4d(sV + i * g * DH * 2, &tmv, full, 0, row, h, page[u]);
            else if constexpr (VF == KV_I8)
              tma_load_4d(sV + i * g * DH, &tmv, full, 0, row, h, page[u]);
            else
              tma_load_4d(sV + i * (g / 2) * DH, &tmv, full, 0, row / 2, h, page[u]);
          }
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int ct = tid - 128;
  const int cw = ct >> 7;  // consumer warpgroup: rows 64 cw .. 64 cw + 63 of the tile
  const int wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, grp = lane >> 2, t4 = lane & 3;

  // Q rows of this warpgroup -> shared memory, swizzled as TMA would store
  // them: every load issued before the first store
  constexpr int QN = 64 * (DH / 8) / 128;  // 16-byte chunks a thread
  uint4 qv[QN];
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int i = wt + u * 128, rl = i / (DH / 8), c = i - rl * (DH / 8);
    const int rr = r0 + cw * 64 + rl;
    qv[u] = make_uint4(0, 0, 0, 0);
    if (rr < R) {
      const int cq = rr / gq, j = rr - cq * gq;
      qv[u] = __ldg(reinterpret_cast<const uint4*>(
          q + ((size_t)(b * C + cq) * nH + h * gq + j) * DH + c * 8));
    }
  }
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int i = wt + u * 128, rl = i / (DH / 8), c = i - rl * (DH / 8);
    const int rb = cw * 64 + rl;
    *reinterpret_cast<uint4*>(sm + (c >> 3) * (FC_BM * 128) + rb * 128 +
                              (((c & 7) ^ (rb & 7)) << 4)) = qv[u];
  }
  fence_proxy_async();
  named_bar(1 + cw, 128);

  // this thread's two rows: grp and grp + 8 of its warp's 16
  const int rr0 = r0 + cw * 64 + warp * 16 + grp, rr1 = rr0 + 8;
  const int bound0 = rr0 < R ? min(p0 + rr0 / gq, key_end) : key_end;
  const int bound1 = rr1 < R ? min(p0 + rr1 / gq, key_end) : key_end;
  // every row of the warpgroup sees the keys up to wg_min: tiles within it
  // need no mask
  const int wr = r0 + cw * 64;
  const int wg_min = wr < R ? min(p0 + wr / gq, key_end) : key_end;

  float o[DH / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
  uint32_t pa[BN / 16][4];  // P (bf16, times v_s) as the A fragments of P V
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, al0 = 1.0f, al1 = 1.0f;

  // where tile t's bf16 K (V at + TILE) is read: a converted buffer, or
  // (bf16 pages landed swizzled) its TMA stage
  auto k_tile = [&](int t) {
    return base + (STAGED ? T::Q_BYTES + (t & 1) * 2 * T::TILE : stage(t));
  };
  auto wait_tile = [&](int t) { mbar_wait(bars + 8 * (t % NST), (t / NST) & 1); };
  auto release = [&](int t) { mbar_arrive(bars + 8 * (NST + t % NST)); };

  // raw pages: tile t's raw stage -> converted buffer t & 1, with its scales
  // (quantized pages; zero past key_end); the raw stage is then released
  auto convert = [&](int t) {
    const int k0 = t * BN;
    float* sc = scales + (t & 1) * 2 * BN;
    float a = 0.0f, c = 0.0f;
    if (QUANT && ct < BN && k0 + ct <= key_end) {
      const int key = k0 + ct;
      const size_t vec = ((size_t)ptb[key / ps] * nKV + h) * ps + key % ps;
      a = __bfloat162float(ks[vec]);
      c = __bfloat162float(vs[vec]);
    }
    wait_tile(t);
    unsigned char* dK = sm + T::Q_BYTES + (t & 1) * 2 * T::TILE;
    convert_tile<DH, KF, BN>(sm + stage(t), dK, k0, key_end, ct);
    convert_tile<DH, VF, BN>(sm + stage(t) + T::RAW_K, dK + T::TILE, k0, key_end, ct);
    release(t);
    if (QUANT && ct < BN) {
      sc[ct] = a;
      sc[BN + ct] = c;
    }
    fence_proxy_async();
  };

  // S = Q K^T of tile t over dh in 16-wide steps, waited for
  auto scores = [&](int t) {
    const uint32_t sK = k_tile(t);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // the k step inside a 128-byte row
      const uint64_t da = desc_sw128(sQ + (kk >> 2) * (FC_BM * 128) + cw * 64 * 128 + off, 16,
                                     1024);
      const uint64_t db = desc_sw128(sK + (kk >> 2) * T::CBLK + off, 16, 1024);
      wgmma_qk<DH>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };

  // the online softmax of tile t's scores: k_s, mask, running max, P (times
  // v_s) into pa, the denominator; O's factors al0 / al1
  auto softmax = [&](int t) {
    const int k0 = t * BN;
    const float* sc = scales + (t & 1) * 2 * BN;
    // element i of s: key k0 + 8 (i / 4) + 2 t4 + (i & 1), row grp (+ 8 if i & 2)
    if constexpr (QUANT) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] *= sc[8 * (i >> 2) + 2 * t4 + (i & 1)];
    }
    if (k0 + BN - 1 > wg_min) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key > ((i & 2) ? bound1 : bound0)) s[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2)
        mx1 = fmaxf(mx1, s[i]);
      else
        mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // the running max in the exp2 domain (key 0 is in every row's first
    // tile, so it is finite from there on)
    const float ms0 = mn0 == -INFINITY ? 0.0f : mn0 * scale2;
    const float ms1 = mn1 == -INFINITY ? 0.0f : mn1 * scale2;
    al0 = ex2(m0 * scale2 - ms0);
    al1 = ex2(m1 * scale2 - ms1);
    m0 = mn0;
    m1 = mn1;
    // k step kt of P V holds keys 16 kt .. 16 kt + 15, registers (row grp,
    // 2 t4), (grp + 8, 2 t4), (grp, 2 t4 + 8), (grp + 8, 2 t4 + 8):
    // s[8 kt .. 8 kt + 7] in pairs
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int u = 0; u < BN / 4; ++u) {
      const bool hi = u & 1;  // s[2u], s[2u + 1] lie in row grp + 8 when u is odd
      const float p0 = ex2(fmaf(s[2 * u], scale2, hi ? -ms1 : -ms0));
      const float p1 = ex2(fmaf(s[2 * u + 1], scale2, hi ? -ms1 : -ms0));
      if (hi)
        ps1 += p0 + p1;
      else
        ps0 += p0 + p1;
      if constexpr (QUANT) {
        const int col = 8 * (u >> 1) + 2 * t4;
        pa[u >> 2][u & 3] = pack_bf16(p0 * sc[BN + col], p1 * sc[BN + col + 1]);
      } else {
        pa[u >> 2][u & 3] = pack_bf16(p0, p1);
      }
    }
    l0 = al0 * l0 + ps0;  // this thread's share; the four shares add up at the end
    l1 = al1 * l1 + ps1;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
  };

  // O += P V of tile t over its keys in 16-key steps (issued, not waited for)
  auto issue_pv = [&](int t) {
    const uint32_t sV = k_tile(t) + T::TILE;
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      wgmma_pv<DH>(o, pa[kt], desc_sw128(sV + kt * 16 * 128, T::CBLK, 1024));
    wgmma_commit();
  };
  auto wait_pv = [&]() {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  };

  if constexpr (STAGED) {
    convert(0);
    named_bar(3, 256);
    for (int t = 0; t < n_tiles; ++t) {
      scores(t);
      softmax(t);
      issue_pv(t);
      if (t + 1 < n_tiles) convert(t + 1);  // under tile t's P V
      wait_pv();
      // tile t + 1 is converted and visible; every P V of tile t is done, so
      // tile t + 2 may overwrite its buffer
      named_bar(3, 256);
    }
  } else {
    for (int t = 0; t < n_tiles; ++t) {
      wait_tile(t);
      const int k0 = t * BN;
      if (k0 + BN - 1 > key_end) {
        // V's rows past the last bound are stale page bytes: zero them, the
        // two consumers sharing the 16-byte chunks, then one barrier of both,
        // so that neither's P V (async proxy) reads a row before every zero
        // is written (every consumer passes here for the same tile)
        const uint32_t sV = k_tile(t) + T::TILE;
        const int z0 = key_end + 1 - k0;
        for (int i = ct; i < (BN - z0) * T::CB * 8; i += 256) {
          const int row = z0 + i / (T::CB * 8), rest8 = i % (T::CB * 8);
          *reinterpret_cast<uint4*>(sm + (sV - base) + (rest8 >> 3) * T::CBLK + row * 128 +
                                    ((rest8 & 7) << 4)) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_bar(3, 256);
      }
      scores(t);
      softmax(t);
      issue_pv(t);
      wait_pv();
      release(t);
    }
  }

#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-20f), inv1 = 1.0f / fmaxf(l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = half ? rr1 : rr0;
    if (rr >= R) continue;
    const float inv = half ? inv1 : inv0;
    const int c = rr / gq, j = rr - c * gq;
    __nv_bfloat16* dst = out + ((size_t)(b * C + c) * nH + h * gq + j) * DH + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(o[4 * nt + 2 * half] * inv, o[4 * nt + 2 * half + 1] * inv);
  }
}

static int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The tensor map of one layer's page slab [P, nKV, ps(/2), dh] in format F:
// boxes of g keys (g / 2 pair rows of packed int4) of one head of one page,
// bf16 as 64-dim column blocks in the 128-byte swizzle, bf16 rows, int8 and
// int4 raw rows. The page extent is left open (page ids are trusted, as the
// block table always was).
template <int DH, int F>
static bool page_tensor_map(CUtensorMap* m, const void* p, int nKV, int ps, int g) {
  const uint64_t rows = F == KV_I4 ? ps / 2 : ps;
  const bool bf16 = F == KV_BF16 || F == FC_BF16_ROWS;
  const uint64_t row_bytes = bf16 ? DH * 2 : (uint64_t)DH;
  const uint64_t dims[4] = {(uint64_t)DH, rows, (uint64_t)nKV, 0x7FFFFFFFull};
  const uint64_t strides[3] = {row_bytes, rows * row_bytes, nKV * rows * row_bytes};
  if (F == KV_BF16)
    return tensor_map<4>(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims, strides,
                         {64, (uint32_t)g, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (F == FC_BF16_ROWS)
    return tensor_map<4>(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims, strides,
                         {(uint32_t)DH, (uint32_t)g, 1, 1}, CU_TENSOR_MAP_SWIZZLE_NONE);
  return tensor_map<4>(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, dims, strides,
                       {(uint32_t)DH, (uint32_t)(F == KV_I4 ? g / 2 : g), 1, 1},
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DH, int KF, int VF>
static cudaError_t launch_fc(const void* q, const void* k, const void* ks, const void* v,
                             const void* vs, const int* pos, const int* pt, void* out, int B,
                             int C, int nKV, int gq, int n_pg, int ps, float sm_scale,
                             cudaStream_t stream) {
  using T = ChunkTile<DH, KF, VF>;
  // g keys a box: divides the key tile and the page, so no box crosses a
  // page; bf16 boxes land swizzled, so whole 8-row swizzle groups (other
  // page sizes take FC_BF16_ROWS)
  const int g = gcd_int(ps, T::BN);
  if (KF == KV_BF16 && g % 8 != 0) return cudaErrorInvalidValue;
  CUtensorMap tmk, tmv;
  if (!page_tensor_map<DH, KF>(&tmk, k, nKV, ps, g) ||
      !page_tensor_map<DH, VF>(&tmv, v, nKV, ps, g))
    return cudaErrorInvalidValue;
  auto kern = flash_chunk_kernel<DH, KF, VF>;
  // one flag per template instance; benign race: every setter writes the same value
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_rt = (C * gq + FC_BM - 1) / FC_BM;
  const float scale2 = sm_scale * 1.4426950408889634f;  // log2(e)
  kern<<<n_rt * B * nKV, FC_THREADS, T::SMEM, stream>>>(
      tmk, tmv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), pos, pt, static_cast<__nv_bfloat16*>(out), B, C,
      nKV, gq, n_pg, ps, g, scale2);
  return cudaGetLastError();
}

// The (K, V) page formats served: bf16/bf16 (swizzled by TMA where the
// page size allows it, else raw rows), int8/int8, int4/int4, int8/int4.
template <int DH>
static cudaError_t launch_fc_fmt(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const int* pos, const int* pt, void* out, int B,
                                 int C, int nKV, int gq, int n_pg, int ps, int kfmt, int vfmt,
                                 float sm, cudaStream_t st) {
  if (kfmt == KV_BF16 && vfmt == KV_BF16) {
    if (gcd_int(ps, ChunkTile<DH, KV_BF16, KV_BF16>::BN) % 8 == 0)
      return launch_fc<DH, KV_BF16, KV_BF16>(q, k, ks, v, vs, pos, pt, out, B, C, nKV, gq,
                                             n_pg, ps, sm, st);
    return launch_fc<DH, FC_BF16_ROWS, FC_BF16_ROWS>(q, k, ks, v, vs, pos, pt, out, B, C, nKV,
                                                     gq, n_pg, ps, sm, st);
  }
  if (kfmt == KV_I8 && vfmt == KV_I8)
    return launch_fc<DH, KV_I8, KV_I8>(q, k, ks, v, vs, pos, pt, out, B, C, nKV, gq, n_pg, ps,
                                       sm, st);
  if (kfmt == KV_I4 && vfmt == KV_I4)
    return launch_fc<DH, KV_I4, KV_I4>(q, k, ks, v, vs, pos, pt, out, B, C, nKV, gq, n_pg, ps,
                                       sm, st);
  if (kfmt == KV_I8 && vfmt == KV_I4)
    return launch_fc<DH, KV_I8, KV_I4>(q, k, ks, v, vs, pos, pt, out, B, C, nKV, gq, n_pg, ps,
                                       sm, st);
  return cudaErrorInvalidValue;
}

}  // namespace ftcf

extern "C" {

// K10. q [B, C, nKV * gq, dh] bf16; k/v the layer's [P, nKV, ps, dh] page
// slabs in the formats kfmt / vfmt (KVFmt: bf16; int8; packed int4
// [P, nKV, ps/2, dh] with ps even), the quantized ones with ks/vs
// [P, nKV, ps] bf16 scales; pos [B] int32 chunk starts; pt [B, n_pg] int32
// block table; out like q. dh is 128 or 256; any page size (even if packed).
int ftcf_flash_chunk_paged(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const int* pos, const int* pt, void* out, int B, int C,
                           int nKV, int gq, int n_pg, int ps, int dh, int kfmt, int vfmt,
                           float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gq < 1 || C < 1 || B < 1 || n_pg < 1 || ps < 1) return (int)cudaErrorInvalidValue;
  if (dh == 128)
    return (int)ftcf::launch_fc_fmt<128>(q, k, ks, v, vs, pos, pt, out, B, C, nKV, gq, n_pg, ps,
                                         kfmt, vfmt, sm_scale, st);
  if (dh == 256)
    return (int)ftcf::launch_fc_fmt<256>(q, k, ks, v, vs, pos, pt, out, B, C, nKV, gq, n_pg, ps,
                                         kfmt, vfmt, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
