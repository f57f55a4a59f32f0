// The prefill attention body of K5 (causal prefill over the prompt's own K/V)
// and K12 (Longformer's banded sliding-window attention), on wgmma + TMA.
// One kernel body, templated on the range of keys a query row sees (as
// flash_decode.cuh is templated on how a position is addressed); the entry
// points are prefill_flash.cu (K5, CausalPrefix) and sliding_window.cu (K12,
// Band), one source a policy, so their instances compile in parallel.
//
// Replaces fastertransformer4codefuse_tpu/ops/attention.py
// prefill_attention_flash (K5: the library Pallas flash_attention with
// causal segment ids) and ops/sliding_window.py sliding_window_attention
// (K12: its Pallas body _kernel). q [B, S, nKV * gq, dh], k/v [B, S, nKV, dh]
// bf16, lens [B]. The gq query heads of a KV head ride the row axis, r = c *
// gq + j (query c, head j; K12 has gq = 1). Scores and softmax in fp32; p
// rounded to bf16 before the P V product; the denominator sums the unrounded
// p. A row of query c sees the keys [lo(c'), hi(c')] of c' = min(c, len - 1):
//  - CausalPrefix (K5): [0, min(c, len - 1)], so padded rows attend the
//    valid prefix (the plain masked prefill's rows, every one of them);
//  - Band (K12, q already scaled): [max(0, c - w), min(c + w, len - 1)], or
//    with the causal band [max(0, c - w), min(c, len - 1)]; rows at or past
//    the length are written as 0, and a query tile whose first row is there
//    is written as zeros and loads nothing.
//
// Bound: K5 at CodeFuse-13B (40 heads x 128) and S = 4096 does ~172 GFLOP of
// causal work against ~170 MB of q, k, v and out: ~1000 FLOP a byte, far
// above the card's 295, so the tensor cores bound it (0.174 ms at 989
// TFLOP/s), and only wgmma reaches their rate. K12 at Longformer-base (12
// heads x 64, w = 256) reads 2w + 128 = 640 keys a 128-query tile: ~21 MFLOP
// against ~180 KB of Q, K and V a (tile, head), ~115 FLOP a byte, below the
// balance; and each K/V byte is read by ceil((2w + 128) / 128) = 5
// overlapping query tiles, which L2 serves, so its floor is the bytes: q, k
// and v of the unpadded rows and the whole out, once each (0.0134 ms at
// B = 2, S = 4096, lengths 4096 and 2900).
//
// Design (a work item is a 128-row query tile of one KV head and row b; the
// items with the most keys come first, so K5's causal triangle leaves no
// long tail. K5 runs a block an item. K12's items walk 5 key tiles at w =
// 256, so a block's fixed cost (barriers, Q, the ring's fill, the epilogue)
// would weigh as much as its products: Band runs one block an SM, each
// walking items blockIdx.x, + gridDim.x, ..., the ring running on from one
// item to the next and the next item's Q loaded by TMA as soon as the
// consumers' last Q K^T of this one is done):
//  - three warpgroups: a producer, whose one thread keeps the K and V tiles
//    of the block's key range in flight by TMA into a ring of four stages at
//    dh 64, three at dh 128, two at dh 256 (full and empty mbarriers), and
//    two consumers of 64 query rows each; setmaxnreg gives the producer 24
//    registers and the consumers 240;
//  - the block's key range is [lo, hi] of its first and last (unpadded) row;
//    K and V tiles (128 keys at dh 64 and 128, 64 at dh 256) start at its
//    first key, which need not be a multiple of the tile (the 128-byte
//    swizzle follows the shared-memory address, not the key), and arrive as
//    64-wide column blocks in the 128-byte swizzle (ftcf_sm90.cuh); keys
//    past S are zero-filled by TMA, and no tile past the range is loaded
//    (K12 at w = 256: 5 tiles a block);
//  - Q is read once into the same swizzled layout: K5 by the consumers (a
//    thread's loads all in flight before its first store), K12 by the
//    producer's TMA into one buffer with its own full and empty barriers
//    (rows past the length are read and their outputs selected as 0);
//  - S = Q K^T by wgmma m64n128k16 (n64 at dh 256), both operands from shared
//    memory; online softmax in registers with exp2 (log2 e folded into the
//    scale); only tiles holding a key outside some row's [lo, hi] compute a
//    mask (K5: the diagonal one and the one holding lens[b] - 1; K12 at w =
//    256: the first and the last of a warpgroup's 5);
//  - O += P V by wgmma with P (bf16) from registers and V MN-major from shared
//    memory. In the tile holding lens[b] - 1 the consumers zero V's rows at
//    or past the length first: they are real memory (TMA zero-fills only
//    past S), and a masked p of 0 times a non-finite value is not 0;
//  - at dh 64 and 128 each consumer issues the next tile's Q K^T before this
//    tile's P V and runs the next tile's softmax while P V is in flight (O
//    takes its new factors after P V completes); at dh 256, where O alone
//    takes 128 registers a thread, one tile at a time;
//  - no atomics and no split over keys: two calls give equal bytes.
#pragma once

#include "ftcf_common.cuh"
#include "ftcf_mma.cuh"
#include "ftcf_sm90.cuh"
#include "ftcf_tma.cuh"

namespace ftcf {

// The keys of query c (c < len): [lo(c), hi(c, len)], both nondecreasing in c.
// K5: the causal prefix; every row is computed.
struct CausalPrefix {
  static constexpr bool kLow = false;       // lo is 0
  static constexpr bool kZeroPast = false;  // rows at or past the length attend the prefix
  static constexpr bool kPersistent = false;  // a block a query tile
  __device__ int lo(int) const { return 0; }
  __device__ int hi(int c, int len) const { return min(c, len - 1); }
};

// K12: the band of half width w (causal: the keys at or before the query).
struct Band {
  static constexpr bool kLow = true;
  static constexpr bool kZeroPast = true;  // rows at or past the length are 0
  // a few tiles a query tile: one block an SM walks the query tiles, Q by TMA
  static constexpr bool kPersistent = true;
  int w, causal;
  __device__ int lo(int c) const { return max(0, c - w); }
  __device__ int hi(int c, int len) const { return min(causal ? c : c + w, len - 1); }
};

constexpr int PF_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PF_BM = 128;       // query rows per block, 64 per consumer

template <int DH>
struct PrefillTile {
  static constexpr int BN = DH == 256 ? 64 : 128;   // keys per tile
  // K/V ring depth (144 KB at dh 64, 225 KB at dh 128)
  static constexpr int STAGES = DH == 64 ? 4 : DH == 128 ? 3 : 2;
  static constexpr int CB = DH / 64;                 // 64-wide column blocks
  static constexpr int Q_BYTES = PF_BM * DH * 2;
  static constexpr int KV_BLOCK = BN * 128;          // one column block of a K or V tile
  static constexpr int TILE = BN * DH * 2;           // a K (or V) tile
  static constexpr int BARS = Q_BYTES + STAGES * 2 * TILE;
  static constexpr size_t SMEM = BARS + 128 + 1024;  // + barriers + alignment slack
};

template <int DH>
__device__ __forceinline__ void wgmma_qk(float (&s)[PrefillTile<DH>::BN / 2], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (PrefillTile<DH>::BN == 128)
    wgmma_ss_n128(s, da, db, acc);
  else
    wgmma_ss_n64(s, da, db, acc);
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 64)
    wgmma_rs_n64(o, a, db);
  else if constexpr (DH == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n256(o, a, db);
}

template <int DH, class Pol>
__global__ void __launch_bounds__(PF_THREADS, 1)
prefill_flash_kernel(const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmq, const __nv_bfloat16* __restrict__ q,
                     const int* __restrict__ lens, __nv_bfloat16* __restrict__ out, int S,
                     int nKV, int gq, int B, float scale2, const Pol pol) {
  using T = PrefillTile<DH>;
  constexpr int BN = T::BN;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t sQ = base;
  // full[stage], then empty[stage], then Q's full and empty (persistent)
  const uint32_t bars = base + T::BARS;
  const uint32_t q_full = bars + 16 * T::STAGES, q_empty = q_full + 8;

  const int R = S * gq, nH = nKV * gq;
  const int n_rt = (R + PF_BM - 1) / PF_BM;
  const int per_tile = nKV * B;
  // work item it: a 128-row query tile of one KV head and row b; a block
  // takes items blockIdx.x, + gridDim.x, ... (persistent), else one
  const int n_items = n_rt * per_tile;
  struct Item {
    int h, b, r0, keys, key_first, key_end, n_tiles;
    bool zero;  // every row at or past the length: written as 0, nothing read
  };
  auto item = [&](int it) {
    Item w;
    const int tile = n_rt - 1 - it / per_tile;  // heaviest first
    const int rest = it % per_tile;
    w.h = rest % nKV;
    w.b = rest / nKV;
    w.r0 = tile * PF_BM;
    w.keys = min(lens[w.b], S);
    w.zero = Pol::kZeroPast && w.r0 / gq >= w.keys;
    // the keys any row of the tile may see, [key_first, key_end]: those of its
    // first and last row (a row past the length takes the bounds of len - 1)
    w.key_first = pol.lo(min(w.r0 / gq, w.keys - 1));
    w.key_end = pol.hi(min((min(R, w.r0 + PF_BM) - 1) / gq, w.keys - 1), w.keys);
    w.n_tiles = !w.zero && w.key_end >= w.key_first ? (w.key_end - w.key_first) / BN + 1 : 0;
    return w;
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);                      // the producer's arrive + TMA bytes
      mbar_init(bars + 8 * (T::STAGES + st), 256);      // every consumer thread
    }
    if constexpr (Pol::kPersistent) {
      mbar_init(q_full, 1);
      mbar_init(q_empty, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == 0) {
      int g = 0, qn = 0;  // ring tiles and Q tiles issued so far
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const Item w = item(it);
        if (w.zero) continue;
        if constexpr (Pol::kPersistent) {
          // the item's Q once the consumers' last Q K^T of the previous one is done
          if (qn > 0) mbar_wait(q_empty, (qn - 1) & 1);
          mbar_arrive_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
          for (int cb = 0; cb < T::CB; ++cb)
            tma_load_4d(sQ + cb * (PF_BM * 128), &tmq, q_full, cb * 64, w.h, w.r0, w.b);
          ++qn;
        }
        for (int t = 0; t < w.n_tiles; ++t, ++g) {
          const int st = g % T::STAGES;
          if (g >= T::STAGES) mbar_wait(bars + 8 * (T::STAGES + st), (g / T::STAGES - 1) & 1);
          const uint32_t full = bars + 8 * st;
          mbar_arrive_expect_tx(full, 2 * T::TILE);
          const uint32_t sK = base + T::Q_BYTES + st * 2 * T::TILE, sV = sK + T::TILE;
          const int k0 = w.key_first + t * BN;
#pragma unroll
          for (int cb = 0; cb < T::CB; ++cb) {
            tma_load_4d(sK + cb * T::KV_BLOCK, &tmk, full, cb * 64, w.h, k0, w.b);
            tma_load_4d(sV + cb * T::KV_BLOCK, &tmv, full, cb * 64, w.h, k0, w.b);
          }
        }
        if constexpr (!Pol::kPersistent) break;
      }
    }
    return;
  }

  regs_inc<240>();
  const int ct = threadIdx.x - 128;
  const int cw = ct >> 7;  // consumer warpgroup: rows 64 cw .. 64 cw + 63 of the tile
  const int wt = ct & 127;
  const int warp = wt >> 5, lane = wt & 31, grp = lane >> 2, t4 = lane & 3;

  int g0 = 0, qn = 0;  // ring tiles and Q tiles consumed before this item
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item w = item(it);
    const int h = w.h, b = w.b, r0 = w.r0, keys = w.keys, key_first = w.key_first;
    const int n_tiles = w.n_tiles;
    if (w.zero) {  // this warpgroup's 64 rows as 0
      for (int i = wt; i < 64 * (DH / 8); i += 128) {
        const int rr = r0 + cw * 64 + i / (DH / 8), c = rr / gq, j = rr - c * gq;
        if (rr < R)
          *reinterpret_cast<uint4*>(out + ((size_t)(b * S + c) * nH + h * gq + j) * DH +
                                    (i % (DH / 8)) * 8) = make_uint4(0, 0, 0, 0);
      }
      continue;
    }
    // V's rows from v_end on are zeroed where a tile holds them
    const int v_end = Pol::kLow ? w.key_end + 1 : keys;

    if constexpr (Pol::kPersistent) {
      mbar_wait(q_full, qn & 1);  // the item's Q tile, by TMA (rows past S zero-filled)
      ++qn;
    } else {
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
              q + ((size_t)(b * S + cq) * nH + h * gq + j) * DH + c * 8));
        }
      }
#pragma unroll
      for (int u = 0; u < QN; ++u) {
        const int i = wt + u * 128, rl = i / (DH / 8), c = i - rl * (DH / 8);
        const int rb = cw * 64 + rl;
        *reinterpret_cast<uint4*>(sm + (c >> 3) * (PF_BM * 128) + rb * 128 +
                                  (((c & 7) ^ (rb & 7)) << 4)) = qv[u];
      }
      fence_proxy_async();
      named_bar(1 + cw, 128);
    }

    // this thread's two rows: grp and grp + 8 of its warp's 16 (a row past R
    // or past the length takes the bounds of len - 1)
    const int rr0 = r0 + cw * 64 + warp * 16 + grp, rr1 = rr0 + 8;
    const int c0 = min(rr0 / gq, keys - 1), c1 = min(rr1 / gq, keys - 1);
    const int bound0 = pol.hi(c0, keys), bound1 = pol.hi(c1, keys);
    const int low0 = pol.lo(c0), low1 = pol.lo(c1);
    // every row of the warpgroup sees the keys [wg_max_lo, wg_min]: tiles
    // within them need no mask
    const int wr = r0 + cw * 64;
    const int wg_min = pol.hi(min(wr / gq, keys - 1), keys);
    const int wg_max_lo = pol.lo(min((wr + 63) / gq, keys - 1));

    float o[DH / 2], s[BN / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
    uint32_t pa[BN / 16][4];  // P (bf16) as the A fragments of P V
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    // tile t of the item is ring tile g0 + t
    auto k_tile = [&](int t) {
      return base + T::Q_BYTES + ((g0 + t) % T::STAGES) * 2 * T::TILE;
    };

    // wait until tile t's K and V have landed
    auto wait_tile = [&](int t) {
      mbar_wait(bars + 8 * ((g0 + t) % T::STAGES), ((g0 + t) / T::STAGES) & 1);
    };
    // after the item's last Q K^T: the producer may load the next item's Q
    auto q_read = [&](int t) {
      if constexpr (Pol::kPersistent) {
        if (t == n_tiles - 1) mbar_arrive(q_empty);
      }
    };
    // S = Q K^T of tile t over dh in 16-wide steps (issued, not waited for)
    auto issue_s = [&](int t) {
      const uint32_t sK = k_tile(t);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // the k step inside a 128-byte row
        const uint64_t da = desc_sw128(sQ + (kk >> 2) * (PF_BM * 128) + cw * 64 * 128 + off, 16,
                                       1024);
        const uint64_t db = desc_sw128(sK + (kk >> 2) * T::KV_BLOCK + off, 16, 1024);
        wgmma_qk<DH>(s, da, db, kk > 0);
      }
    };

    // O += P V of tile t over its keys in 16-key steps, P from p (issued)
    auto issue_pv = [&](int t, uint32_t (&p)[BN / 16][4]) {
      const uint32_t sV = k_tile(t) + T::TILE;
#pragma unroll
      for (int kt = 0; kt < BN / 16; ++kt)
        wgmma_pv<DH>(o, p[kt], desc_sw128(sV + kt * 16 * 128, T::KV_BLOCK, 1024));
    };

    // the online softmax of tile t's scores: mask, running max, P into pn,
    // the denominator; O's factors al0 / al1, applied by the caller once the
    // products still reading O are done
    float al0 = 1.0f, al1 = 1.0f;
    auto softmax = [&](int t, uint32_t (&pn)[BN / 16][4]) {
      const int k0 = key_first + t * BN;
      // element i of s: key k0 + 8 (i / 4) + 2 t4 + (i & 1), row grp (+ 8 if i & 2)
      if constexpr (Pol::kLow) {
        if (k0 + BN - 1 > wg_min || k0 < wg_max_lo) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
            if (key > ((i & 2) ? bound1 : bound0) || key < ((i & 2) ? low1 : low0))
              s[i] = -INFINITY;
          }
        }
      } else if (k0 + BN - 1 > wg_min) {
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
      // the running max in the exp2 domain; a row with no visible key yet
      // (never here: each row's first key lies in the block's first tile)
      // would keep p = 0
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
        pn[u >> 2][u & 3] = pack_bf16(p0, p1);
      }
      l0 = al0 * l0 + ps0;  // this thread's share; the four shares add up at the end
      l1 = al1 * l1 + ps1;

      // keys at or past the length in this tile are real memory below S (and,
      // under Band, whose last tile need not end on a multiple of 128, keys
      // past the block's last key, which no row sees): zero V's rows there,
      // the two consumers sharing the 16-byte chunks, then one barrier of
      // both, so that neither's P V (async proxy) reads a row before every
      // zero is written (every consumer passes here for the same tile)
      if (k0 + BN > v_end && v_end < S) {
        const uint32_t sV = k_tile(t) + T::TILE;
        const int z0 = v_end - k0, z1 = min(BN, S - k0);
        for (int i = ct; i < (z1 - z0) * T::CB * 8; i += 256) {
          const int row = z0 + i / (T::CB * 8), rest8 = i % (T::CB * 8);
          *reinterpret_cast<uint4*>(sm + (sV - base) + (rest8 >> 3) * T::KV_BLOCK + row * 128 +
                                    ((rest8 & 7) << 4)) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_bar(3, 256);
      }
    };

    auto release = [&](int t) { mbar_arrive(bars + 8 * (T::STAGES + (g0 + t) % T::STAGES)); };
    auto scale_o = [&]() {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
    };
    // Q K^T of tile t, waited for, and its softmax into p
    auto scores = [&](int t, uint32_t (&p)[BN / 16][4]) {
      wait_tile(t);
      fence_regs(s);
      wgmma_fence();
      issue_s(t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      q_read(t);
      softmax(t, p);
    };
    // P V of tile t from p, waited for; the tile's stage is then free
    auto values = [&](int t, uint32_t (&p)[BN / 16][4]) {
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv(t, p);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(t);
    };

    if constexpr (DH == 256) {
      // O alone is 128 registers a thread: one tile at a time
      for (int t = 0; t < n_tiles; ++t) {
        scores(t, pa);
        scale_o();
        values(t, pa);
      }
    } else {
      // Tile t + 1's Q K^T is issued before tile t's P V, and its softmax runs
      // while P V is in flight (O takes the new factors after it). P of
      // consecutive tiles lives in pa and pb by turns, a pass of the loop
      // holding two tiles, so that no register a product still reads is
      // written before its wait (ptxas would serialize the products).
      uint32_t pb[BN / 16][4];
      auto step = [&](int t, uint32_t (&cur)[BN / 16][4], uint32_t (&nxt)[BN / 16][4]) {
        wait_tile(t + 1);
        fence_regs(s);
        wgmma_fence();
        issue_s(t + 1);
        wgmma_commit();
        fence_regs(s);
        fence_regs(o);
        fence_regs(cur);
        wgmma_fence();
        issue_pv(t, cur);
        wgmma_commit();
        fence_regs(o);
        wgmma_wait<1>();  // Q K^T of tile t + 1
        fence_regs(s);
        q_read(t + 1);
        softmax(t + 1, nxt);
        wgmma_wait<0>();  // P V of tile t
        fence_regs(o);
        fence_regs(cur);
        release(t);
        scale_o();
      };
      if (n_tiles > 0) scores(0, pa);
      int t = 0;
      for (; t + 2 < n_tiles; t += 2) {
        step(t, pa, pb);
        step(t + 1, pb, pa);
      }
      if (t + 1 < n_tiles) step(t++, pa, pb);
      // the last tile's P V: pa holds even tiles, pb odd ones
      if (n_tiles > 0) {
        if (t % 2 == 0)
          values(t, pa);
        else
          values(t, pb);
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
      const int c = rr / gq, j = rr - c * gq;
      // K12's rows at or past the length are 0 (selected: their Q rows are
      // real memory, read by the tile's TMA box)
      const bool zero = Pol::kZeroPast && c >= keys;
      const float inv = half ? inv1 : inv0;
      __nv_bfloat16* dst = out + ((size_t)(b * S + c) * nH + h * gq + j) * DH + t4 * 2;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
        *reinterpret_cast<uint32_t*>(dst + nt * 8) =
            zero ? 0u : pack_bf16(o[4 * nt + 2 * half] * inv, o[4 * nt + 2 * half + 1] * inv);
    }
    g0 += n_tiles;
    if constexpr (!Pol::kPersistent) break;
  }  // items
}

// The tensor map of a [B, S, nKV, dh] bf16 K or V (or K12's Q): boxes of 64
// dims x 1 head x bn keys x 1 row, 128-byte swizzle, zeros past S.
static bool kv_tensor_map(CUtensorMap* m, const void* p, int B, int S, int nKV, int dh, int bn) {
  return tensor_map<4>(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p,
                       {(uint64_t)dh, (uint64_t)nKV, (uint64_t)S, (uint64_t)B},
                       {(uint64_t)dh * 2, (uint64_t)nKV * dh * 2, (uint64_t)S * nKV * dh * 2},
                       {64, 1, (uint32_t)bn, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DH, class Pol>
static cudaError_t launch_prefill(const void* q, const void* k, const void* v, const int* lens,
                                  void* out, int B, int S, int nKV, int gq, float sm_scale,
                                  Pol pol, cudaStream_t stream) {
  using T = PrefillTile<DH>;
  CUtensorMap tmk, tmv, tmq;
  if (!kv_tensor_map(&tmk, k, B, S, nKV, DH, T::BN) ||
      !kv_tensor_map(&tmv, v, B, S, nKV, DH, T::BN))
    return cudaErrorInvalidValue;
  // the persistent body loads Q tiles by TMA (gq = 1: rows are positions)
  if (Pol::kPersistent ? gq != 1 || !kv_tensor_map(&tmq, q, B, S, nKV, DH, PF_BM) : false)
    return cudaErrorInvalidValue;
  if (!Pol::kPersistent) tmq = tmk;  // unused
  auto kern = prefill_flash_kernel<DH, Pol>;
  static bool attr_set = false;  // benign race: every setter writes the same value
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int n_items = (S * gq + PF_BM - 1) / PF_BM * nKV * B;
  int grid = n_items;
  if (Pol::kPersistent) {  // one block an SM
    static int n_sm = 0;  // benign race, as attr_set
    if (!n_sm) {
      int dev;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    grid = min(n_items, n_sm);
  }
  const float scale2 = sm_scale * 1.4426950408889634f;  // log2(e)
  kern<<<grid, PF_THREADS, T::SMEM, stream>>>(
      tmk, tmv, tmq, static_cast<const __nv_bfloat16*>(q), lens,
      static_cast<__nv_bfloat16*>(out), S, nKV, gq, B, scale2, pol);
  return cudaGetLastError();
}

}  // namespace ftcf
