// The decode attention body of K4, K9 and K11, one query token per row, over
// the dense KV cache (K4), the paged pool through a block table (K9), or the
// dense cache through the beam search's cache indirection (K11). One kernel
// body, templated on how a position is addressed, as the JAX package's
// _kernel is shared by K4 and K9. The entry points are in flash_decode.cu
// (K4), flash_decode_paged.cu (K9) and flash_decode_beam.cu (K11): one
// source per addressing policy, so that their instantiations (12 each: dh
// 64, 128 and 256 by the four format pairs) compile in parallel.
//
// Replaces fastertransformer4codefuse_tpu/ops/flash_decode.py
// flash_decode_stacked (K4), flash_decode_paged (K9) (_kernel) and
// flash_decode_beam_stacked (K11, _beam_kernel): online softmax over the
// positions, the causal bound col <= positions[b] inclusive, reads stop at
// positions[b], and g = nH / nKV query rows per KV head (GQA, MQA). The int8
// cache carries one bf16 scale per cached vector: scores = (q . k8) * k_s *
// sm_scale, and the value scale folds into the probability, (p * v_s)
// rounded to bf16, before the PV product; int8 -> bf16 is exact. A bf16
// cache has no scales and rounds p to bf16 alone. The denominator sums the
// unrounded fp32 p.
//
// Formats: the kernel is templated on the K and V formats apart (KVFmt):
// bf16, int8, or packed int4 (the "int4" and "int8k_int4v" caches), where
// positions 2i and 2i + 1 share pair row i (2i in the low nibble) and the
// scales stay per unpacked position. The addressing below gives the
// unpacked vector index u; the scale is read at u, the payload at pair row
// u / 2, nibble u % 2 (kv_vec_off), which needs an even S or page size.
//
// Addressing: K4 reads position s of (row b, KV head h) at cached vector
// (b * nKV + h) * S + s of the layer's [B, nKV, S, dh] slab. K9 reads it at
// (pt[b, s / ps] * nKV + h) * ps + s % ps of the layer's [P, nKV, ps, dh]
// page slab (any page size; the block loads its own page ids). K11 reads
// position s of beam row b (group b / bw) at (r * nKV + h) * S + s with r =
// b - b % bw + indir[b, s]: each row reads one vector per position, K4's
// bytes at B = BB plus 4 bytes of indir per position. Under K4 and K9 the
// two positions of a packed pair row always share it; under K11 they may
// come from two beam rows, so each position stages its own pair row and the
// PV product merges the two nibbles (one logic op).
//
// Bound: the cache bytes up to positions[b], read once per (row, KV head)
// (2 * pos * dh bytes per KV head for int8, half that packed, twice bf16).
// So the design keeps enough bytes in flight and spends few instructions a
// byte:
//  - split-S: the grid is (split, KV head x query group, row); a split is a
//    fixed number of positions per (dh, format) (128 or 256, chosen by
//    ops/flash_decode.py decode_split and passed in), so a
//    row's result depends on its own positions and bytes only (the same
//    alone or in any batch; K11 equals K4 over a gathered copy and K9 equals
//    K4 on the same bytes, bit for bit). A split past positions[b] exits at
//    once. Each split writes its partial (m, l, acc) in fp32 to a workspace
//    the wrapper allocates; a second kernel of the same C entry combines the
//    splits of a (row, KV head) in a fixed order (no atomics);
//  - a cp.async ring of NST stages of 64 positions: each position's vector
//    is resolved through the policy into shared memory before the loads,
//    and neighbouring lanes load neighbouring 16 bytes of a vector (8 lanes
//    a vector for int8 at dh 128, 16 for bf16); a pair row of packed int4 is
//    loaded once (K4, K9). TMA does not fit a per-position gather through a
//    block table or a beam indirection. Rows are padded so that the
//    fragment loads below are free of bank conflicts;
//  - tensor cores for both products: mma.sync m16n8k16 with 16 query rows
//    as M (g <= 16 pads to one tile; 16 < g <= 64 takes 2-4 tiles, one warp
//    group each, over the same K/V tile in shared memory, so the KV bytes
//    are read from device memory once per split; a larger g takes a block
//    for each group of 64 query rows, each reading the split's KV bytes). K
//    and V are converted to bf16 exactly in registers (ftcf_common.cuh);
//    q's dims are permuted so that a thread's four key bytes feed its B
//    fragments directly; the key scale multiplies the scores after the
//    product. P stays in registers as
//    the A operand of PV (the score fragments of two 8-position tiles are
//    the A fragment of a 16-deep step). Each warp takes 16, 32 or 64
//    positions of a tile and keeps its own running max, sum and output, so
//    no block barrier separates the products and the softmax; the warps of
//    a query tile merge through shared memory once, at the split's end.
// g = 1 wastes 15 of 16 rows of each product; the kernel is bound by memory.
#pragma once

#include <math.h>

#include "ftcf_common.cuh"
#include "ftcf_mma.cuh"

namespace ftcf {

constexpr int FD_THREADS = 128;
constexpr int FD_T = 64;       // positions a tile (one ring stage)
constexpr int FD_QROWS = 64;      // query rows a block: up to 4 tiles of 16
constexpr int FD_MAX_SPLIT = 256;  // positions a split may take (a multiple of FD_T)

// Warps a 16-row query tile takes (4 / that many positions of a tile each):
// 4 for g <= 16, 2 for g <= 32, 1 above.
__host__ __device__ constexpr int fd_warps_per_qtile(int g) {
  return g <= 16 ? 4 : g <= 32 ? 2 : 1;
}

// Shared-memory geometry of one instance. A slot holds one staged vector
// (bf16: 2 dh bytes; int8: dh; packed int4: the dh bytes of a pair row).
template <int DH, int KF, int VF, bool SHARE>
struct FdShape {
  static constexpr bool KPAIR = KF == KV_I4 && SHARE;  // one slot per position pair
  static constexpr bool VPAIR = VF == KV_I4 && SHARE;
  static constexpr int KSLOTS = KPAIR ? FD_T / 2 : FD_T;
  static constexpr int VSLOTS = VPAIR ? FD_T / 2 : FD_T;
  static constexpr int KROW = (KF == KV_BF16 ? 2 : 1) * DH;
  static constexpr int VROW = (VF == KV_BF16 ? 2 : 1) * DH;
  // pads: the score fragments read 8 (16 for bf16) bytes of 4 (2) slots at
  // once, the PV fragments 8 (16) bytes of slots 2t (pair rows t)
  static constexpr int KPITCH = KROW + (KF == KV_BF16 ? 64 : 32);
  static constexpr int VPITCH = VROW + (VPAIR ? 32 : 16);
  static constexpr int STAGE = KSLOTS * KPITCH + VSLOTS * VPITCH;
  // 4 stages of packed int4 (10 KB at dh 128), 2 of int8 or bf16: 4 blocks
  // of 128 threads fit an SM at dh <= 128 (the launch bound holds them to
  // 128 registers), 16 warps to hide the products' latency
  static constexpr int NST = STAGE <= 12288 ? 4 : 2;
  static constexpr int QPITCH = 2 * DH + 64;  // bytes of a staged q row
  static constexpr bool QUANT = KF != KV_BF16;
  // the ring, reused at the end of a split to merge the warps' partials:
  // 16 rows of DH outputs and (m, l) per warp
  static constexpr int MERGE = (FD_THREADS / 32) * 16 * (DH + 2) * 4;
  static constexpr int RING = NST * STAGE > MERGE ? NST * STAGE : MERGE;
  // dynamic shared memory for n_qt query tiles and splits of ``split`` positions
  static constexpr int smem(int n_qt, int split) {
    return RING + n_qt * 16 * QPITCH + split * 4 + (QUANT ? split * 4 : 0);
  }
};

// Where position s of (row b, KV head h) is cached: K4's dense slab.
struct DenseAddr {
  static constexpr bool kPairsShare = true;
  int S;
  __device__ int seq_len() const { return S; }
  __device__ uint32_t vec(int b, int h, int nKV, int s) const {
    return ((uint32_t)b * nKV + h) * S + s;
  }
};

// K9's page slab, through the block table pt [B, n_pg] (packed pages have
// an even size: a pair row never crosses a page).
struct PagedAddr {
  static constexpr bool kPairsShare = true;
  const int* pt;
  int n_pg, ps;
  __device__ int seq_len() const { return n_pg * ps; }
  __device__ uint32_t vec(int b, int h, int nKV, int s) const {
    const int page = pt[(size_t)b * n_pg + min(s / ps, n_pg - 1)];
    return ((uint32_t)page * nKV + h) * ps + s % ps;
  }
};

// K11's dense slab through the beam indirection indir [BB, S]: position s
// of row b = g * bw + j is cached in row g * bw + indir[b, s] of its beam
// group. The values are trusted (in [0, bw)), as the JAX package trusts them.
struct BeamAddr {
  static constexpr bool kPairsShare = false;
  const int* indir;
  int S, bw;
  __device__ int seq_len() const { return S; }
  __device__ uint32_t vec(int b, int h, int nKV, int s) const {
    const int row = b - b % bw + indir[(size_t)b * S + s];
    return ((uint32_t)row * nKV + h) * S + s;
  }
};

// One stage: the K and V vectors of the tile's positions [t0, t0 + 64) of
// the split (split-local), 16 bytes a copy; positions at or past len are
// zero-filled and never read from device memory.
template <class Sh, int KF, int VF, int DH>
__device__ __forceinline__ void fd_issue(uint8_t* stage, const void* kc, const void* vc,
                                         const uint32_t* vec_s, int t0, int len, int tid) {
  constexpr int KCPS = Sh::KROW / 16, VCPS = Sh::VROW / 16;  // copies a slot
#pragma unroll 4
  for (int c = tid; c < Sh::KSLOTS * KCPS; c += FD_THREADS) {
    const int slot = c / KCPS, part = c - slot * KCPS;
    const int p = t0 + (Sh::KPAIR ? 2 * slot : slot);
    const bool ok = p < len;
    const uint8_t* src = static_cast<const uint8_t*>(kc);
    if (ok) src += kv_vec_off<KF>(vec_s[p], DH) * (KF == KV_BF16 ? 2 : 1) + part * 16;
    cp_async16(stage + slot * Sh::KPITCH + part * 16, src, ok ? 16 : 0);
  }
  uint8_t* vst = stage + Sh::KSLOTS * Sh::KPITCH;
#pragma unroll 4
  for (int c = tid; c < Sh::VSLOTS * VCPS; c += FD_THREADS) {
    const int slot = c / VCPS, part = c - slot * VCPS;
    const int p = t0 + (Sh::VPAIR ? 2 * slot : slot);
    const bool ok = p < len;
    const uint8_t* src = static_cast<const uint8_t*>(vc);
    if (ok) src += kv_vec_off<VF>(vec_s[p], DH) * (VF == KV_BF16 ? 2 : 1) + part * 16;
    cp_async16(vst + slot * Sh::VPITCH + part * 16, src, ok ? 16 : 0);
  }
}

// The A fragments of q for the two k16 steps of 32-dim chunk c, from the
// staged rows r0 and r0 + 8: a thread's dims d0 = 32 c + 8 t .. d0 + 7 stand
// for k = 2t, 2t + 1, 2t + 8, 2t + 9 of step j as d0 + 4j + {0, 2, 1, 3}
// (the order in which fd_k_frags converts a key's bytes).
__device__ __forceinline__ void fd_q_frags(const uint8_t* qs, int qpitch, int r0, int c, int t,
                                           uint32_t (&a)[2][4]) {
  const uint4 u = *reinterpret_cast<const uint4*>(qs + r0 * qpitch + 64 * c + 16 * t);
  const uint4 w = *reinterpret_cast<const uint4*>(qs + (r0 + 8) * qpitch + 64 * c + 16 * t);
  a[0][0] = __byte_perm(u.x, u.y, 0x5410);
  a[0][2] = __byte_perm(u.x, u.y, 0x7632);
  a[1][0] = __byte_perm(u.z, u.w, 0x5410);
  a[1][2] = __byte_perm(u.z, u.w, 0x7632);
  a[0][1] = __byte_perm(w.x, w.y, 0x5410);
  a[0][3] = __byte_perm(w.x, w.y, 0x7632);
  a[1][1] = __byte_perm(w.z, w.w, 0x5410);
  a[1][3] = __byte_perm(w.z, w.w, 0x7632);
}

// The B fragments of the two k16 steps of chunk c for key n (tile-local),
// dims as fd_q_frags: b[j][0] = (d0 + 4j, d0 + 4j + 2), b[j][1] = (d0 + 4j
// + 1, d0 + 4j + 3), converted to bf16 exactly.
template <class Sh, int KF>
__device__ __forceinline__ void fd_k_frags(const uint8_t* kst, int n, int c, int t,
                                           uint32_t (&bk)[2][2]) {
  if constexpr (KF == KV_BF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(kst + n * Sh::KPITCH + 64 * c + 16 * t);
    bk[0][0] = __byte_perm(u.x, u.y, 0x5410);
    bk[0][1] = __byte_perm(u.x, u.y, 0x7632);
    bk[1][0] = __byte_perm(u.z, u.w, 0x5410);
    bk[1][1] = __byte_perm(u.z, u.w, 0x7632);
  } else {
    const int slot = Sh::KPAIR ? n >> 1 : n;
    uint2 w = *reinterpret_cast<const uint2*>(kst + slot * Sh::KPITCH + 32 * c + 8 * t);
    if constexpr (KF == KV_I8) {
      bk[0][0] = i8_rows_bf16x2(w.x);
      bk[0][1] = i8_rows_bf16x2(w.x >> 8);
      bk[1][0] = i8_rows_bf16x2(w.y);
      bk[1][1] = i8_rows_bf16x2(w.y >> 8);
    } else {
      if (n & 1) {  // the odd position's nibbles
        w.x >>= 4;
        w.y >>= 4;
      }
      bk[0][0] = i4_rows_bf16x2(w.x);
      bk[0][1] = i4_rows_bf16x2(w.x >> 8);
      bk[1][0] = i4_rows_bf16x2(w.y);
      bk[1][1] = i4_rows_bf16x2(w.y >> 8);
    }
  }
}

// The B fragments of one PV step (16 positions from tile-local r, a
// multiple of 16) for dim group G: n-tile nt takes dim 64 G + 8 g + nt at
// column g, rows (positions) 2t, 2t + 1 (bv[nt][0]) and 2t + 8, 2t + 9
// (bv[nt][1]).
template <class Sh, int VF>
__device__ __forceinline__ void fd_v_frags(const uint8_t* vst, int r, int G, int g, int t,
                                           uint32_t (&bv)[8][2]) {
  if constexpr (VF == KV_BF16) {
    const uint8_t* p = vst + (r + 2 * t) * Sh::VPITCH + 2 * (64 * G + 8 * g);
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + Sh::VPITCH);
    const uint4 c = *reinterpret_cast<const uint4*>(p + 8 * Sh::VPITCH);
    const uint4 d = *reinterpret_cast<const uint4*>(p + 9 * Sh::VPITCH);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
    const uint32_t cw[4] = {c.x, c.y, c.z, c.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t sel = nt & 1 ? 0x7632 : 0x5410;
      bv[nt][0] = __byte_perm(aw[nt >> 1], bw[nt >> 1], sel);
      bv[nt][1] = __byte_perm(cw[nt >> 1], dw[nt >> 1], sel);
    }
  } else if constexpr (VF == KV_I8) {
    const uint8_t* p = vst + (r + 2 * t) * Sh::VPITCH + 64 * G + 8 * g;
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const uint2 b = *reinterpret_cast<const uint2*>(p + Sh::VPITCH);
    const uint2 c = *reinterpret_cast<const uint2*>(p + 8 * Sh::VPITCH);
    const uint2 d = *reinterpret_cast<const uint2*>(p + 9 * Sh::VPITCH);
    bv[0][0] = i8_pair_bf16x2<0>(a.x, b.x);
    bv[1][0] = i8_pair_bf16x2<1>(a.x, b.x);
    bv[2][0] = i8_pair_bf16x2<2>(a.x, b.x);
    bv[3][0] = i8_pair_bf16x2<3>(a.x, b.x);
    bv[4][0] = i8_pair_bf16x2<0>(a.y, b.y);
    bv[5][0] = i8_pair_bf16x2<1>(a.y, b.y);
    bv[6][0] = i8_pair_bf16x2<2>(a.y, b.y);
    bv[7][0] = i8_pair_bf16x2<3>(a.y, b.y);
    bv[0][1] = i8_pair_bf16x2<0>(c.x, d.x);
    bv[1][1] = i8_pair_bf16x2<1>(c.x, d.x);
    bv[2][1] = i8_pair_bf16x2<2>(c.x, d.x);
    bv[3][1] = i8_pair_bf16x2<3>(c.x, d.x);
    bv[4][1] = i8_pair_bf16x2<0>(c.y, d.y);
    bv[5][1] = i8_pair_bf16x2<1>(c.y, d.y);
    bv[6][1] = i8_pair_bf16x2<2>(c.y, d.y);
    bv[7][1] = i8_pair_bf16x2<3>(c.y, d.y);
  } else {
    uint2 lo, hi;  // pair rows of positions (2t, 2t + 1) and (2t + 8, 2t + 9)
    if constexpr (Sh::VPAIR) {
      const uint8_t* p = vst + ((r >> 1) + t) * Sh::VPITCH + 64 * G + 8 * g;
      lo = *reinterpret_cast<const uint2*>(p);
      hi = *reinterpret_cast<const uint2*>(p + 4 * Sh::VPITCH);
    } else {  // each position's own pair row: the even one's low nibbles, the odd one's high
      const uint8_t* p = vst + (r + 2 * t) * Sh::VPITCH + 64 * G + 8 * g;
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      const uint2 b = *reinterpret_cast<const uint2*>(p + Sh::VPITCH);
      const uint2 c = *reinterpret_cast<const uint2*>(p + 8 * Sh::VPITCH);
      const uint2 d = *reinterpret_cast<const uint2*>(p + 9 * Sh::VPITCH);
      lo = make_uint2((a.x & 0x0F0F0F0Fu) | (b.x & 0xF0F0F0F0u),
                      (a.y & 0x0F0F0F0Fu) | (b.y & 0xF0F0F0F0u));
      hi = make_uint2((c.x & 0x0F0F0F0Fu) | (d.x & 0xF0F0F0F0u),
                      (c.y & 0x0F0F0F0Fu) | (d.y & 0xF0F0F0F0u));
    }
    bv[0][0] = i4_pair_bf16x2<0>(lo.x);
    bv[1][0] = i4_pair_bf16x2<1>(lo.x);
    bv[2][0] = i4_pair_bf16x2<2>(lo.x);
    bv[3][0] = i4_pair_bf16x2<3>(lo.x);
    bv[4][0] = i4_pair_bf16x2<0>(lo.y);
    bv[5][0] = i4_pair_bf16x2<1>(lo.y);
    bv[6][0] = i4_pair_bf16x2<2>(lo.y);
    bv[7][0] = i4_pair_bf16x2<3>(lo.y);
    bv[0][1] = i4_pair_bf16x2<0>(hi.x);
    bv[1][1] = i4_pair_bf16x2<1>(hi.x);
    bv[2][1] = i4_pair_bf16x2<2>(hi.x);
    bv[3][1] = i4_pair_bf16x2<3>(hi.x);
    bv[4][1] = i4_pair_bf16x2<0>(hi.y);
    bv[5][1] = i4_pair_bf16x2<1>(hi.y);
    bv[6][1] = i4_pair_bf16x2<2>(hi.y);
    bv[7][1] = i4_pair_bf16x2<3>(hi.y);
  }
}

// One split of one (row, KV head, group of up to 64 query rows): grid
// (split, KV head x query group, row). Writes the split's partial (acc[DH],
// m, l) of each of the group's query rows to ws, a record of DH + 4 floats
// at (((b nKV + h) n_split + split) g + row); m is in log2 units.
template <int DH, int KF, int VF, class Addr>
__global__ void __launch_bounds__(FD_THREADS, DH == 256 ? 1 : 4)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ ks, const void* __restrict__ vc,
                    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ positions,
                    float* __restrict__ ws, int nKV, int g, int n_split, int split_len,
                    Addr addr, float scale_log2) {
  using Sh = FdShape<DH, KF, VF, Addr::kPairsShare>;
  constexpr int NC = DH / 32;  // 32-dim chunks of the score product
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_qg = (g + FD_QROWS - 1) / FD_QROWS;
  const int split = blockIdx.x, h = blockIdx.y / n_qg, b = blockIdx.z;
  const int row0 = (blockIdx.y - h * n_qg) * FD_QROWS;  // the group's first query row
  const int gl = min(FD_QROWS, g - row0);               // its query rows
  const int n_valid = min(positions[b] + 1, addr.seq_len());
  const int base = split * split_len;
  if (base >= n_valid) return;
  const int len = min(split_len, n_valid - base);
  const int n_tiles = (len + FD_T - 1) / FD_T;
  const int n_qt = (gl + 15) >> 4, wpq = fd_warps_per_qtile(gl);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  uint8_t* ring = smem;
  uint8_t* qs = smem + Sh::RING;
  uint32_t* vec_s = reinterpret_cast<uint32_t*>(qs + n_qt * 16 * Sh::QPITCH);
  __nv_bfloat16* ks_s = reinterpret_cast<__nv_bfloat16*>(vec_s + split_len);
  __nv_bfloat16* vs_s = ks_s + split_len;

  for (int p = tid; p < len; p += FD_THREADS) vec_s[p] = addr.vec(b, h, nKV, base + p);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < Sh::NST - 1; ++t) {
    if (t < n_tiles) fd_issue<Sh, KF, VF, DH>(ring + t * Sh::STAGE, kc, vc, vec_s, t * FD_T, len, tid);
    cp_async_commit();
  }
  // q and the scales under the first tiles' copies (the loop's first
  // barrier publishes them)
  const __nv_bfloat16* qg = q + (((size_t)b * nKV + h) * g + row0) * DH;
  for (int i = tid; i < n_qt * 16 * (DH / 8); i += FD_THREADS) {
    const int r = i / (DH / 8), c = i - r * (DH / 8);
    const uint4 v = r < gl ? *reinterpret_cast<const uint4*>(qg + (size_t)r * DH + 8 * c)
                          : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(qs + r * Sh::QPITCH + 16 * c) = v;
  }
  if constexpr (Sh::QUANT) {
    for (int p = tid; p < len; p += FD_THREADS) {
      ks_s[p] = ks[vec_s[p]];
      vs_s[p] = vs[vec_s[p]];
    }
  }

  const int qt = warp / wpq, sub = warp - qt * wpq;
  const bool active = qt < n_qt;
  const int pw = FD_T / wpq;  // positions of a tile this warp takes
  const int r0 = qt * 16 + gq;  // staged q row of fragment rows gq (and gq + 8)
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<Sh::NST - 2>();
    __syncthreads();
    {
      const int t2 = it + Sh::NST - 1;
      if (t2 < n_tiles)
        fd_issue<Sh, KF, VF, DH>(ring + (t2 % Sh::NST) * Sh::STAGE, kc, vc, vec_s, t2 * FD_T,
                                 len, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const uint8_t* kst = ring + (it % Sh::NST) * Sh::STAGE;
    const uint8_t* vst = kst + Sh::KSLOTS * Sh::KPITCH;
    for (int ch = 0; ch < pw / 16; ++ch) {
      const int tp0 = sub * pw + 16 * ch;  // tile-local first position of the step
      const int p0 = it * FD_T + tp0;      // split-local
      if (p0 >= len) break;
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t a[2][4];
        fd_q_frags(qs, Sh::QPITCH, r0, c, tq, a);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bk[2][2];
          fd_k_frags<Sh, KF>(kst, tp0 + 8 * j + gq, c, tq, bk);
          mma_16816(s[j], a[0], bk[0]);
          mma_16816(s[j], a[1], bk[1]);
        }
      }
      // online softmax over the step's 16 positions, rows gq (e < 2) and gq + 8
      float x[2][4], mx[2] = {-INFINITY, -INFINITY}, ksc[2][2], vsc[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // the scales of positions 2t, 2t + 1: one word each
        const int p = p0 + 8 * j + 2 * tq;
        if constexpr (Sh::QUANT) {
          bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(ks_s + p), ksc[j]);
          bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(vs_s + p), vsc[j]);
        } else {
          ksc[j][0] = ksc[j][1] = vsc[j][0] = vsc[j][1] = 1.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 8 * j + 2 * tq + (e & 1);
          const float v = p < len ? s[j][e] * ksc[j][e & 1] * scale_log2 : -INFINITY;
          x[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);
        alpha[hr] = ex2(m[hr] - m_new);
        m[hr] = m_new;
        l[hr] *= alpha[hr];
      }
      float pw_[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 8 * j + 2 * tq + (e & 1);
          const float pe = ex2(x[j][e] - m[e >> 1]);
          l[e >> 1] += pe;
          pw_[j][e] = Sh::QUANT ? (p < len ? pe * vsc[j][e & 1] : 0.0f) : pe;
        }
      uint32_t pa[4];
      pa[0] = pack_bf16(pw_[0][0], pw_[0][1]);
      pa[1] = pack_bf16(pw_[0][2], pw_[0][3]);
      pa[2] = pack_bf16(pw_[1][0], pw_[1][1]);
      pa[3] = pack_bf16(pw_[1][2], pw_[1][3]);
      // once a row's max settles its alpha is 1: skip the identity rescale
      if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          o[i][0] *= alpha[0];
          o[i][1] *= alpha[0];
          o[i][2] *= alpha[1];
          o[i][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int G = 0; G < DH / 64; ++G) {
        uint32_t bv[8][2];
        fd_v_frags<Sh, VF>(vst, tp0, G, gq, tq, bv);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_16816(o[G * 8 + nt], pa, bv[nt]);
      }
    }
  }
  // merge the warps of each query tile (their own positions of the split):
  // each warp's (m, l) and unnormalized output go to the ring, then each
  // row's record is the fixed-order sum over its warps, scaled to their
  // largest m
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [warp][16 rows][DH]
  float* ml = red + (FD_THREADS / 32) * 16 * DH;  // [warp][16 rows][m, l]
  if (active) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      const int row = gq + 8 * hr;
      float* dst = red + (warp * 16 + row) * DH;
#pragma unroll
      for (int G = 0; G < DH / 64; ++G) {
        // dims 64 G + 16 t + i: i < 8 from column 2t of n-tile i, else 2t + 1
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int c = k4 >> 1, i0 = (k4 & 1) * 4;
          reinterpret_cast<float4*>(dst + 64 * G + 16 * tq)[k4] =
              make_float4(o[G * 8 + i0][2 * hr + c], o[G * 8 + i0 + 1][2 * hr + c],
                          o[G * 8 + i0 + 2][2 * hr + c], o[G * 8 + i0 + 3][2 * hr + c]);
        }
      }
      if (tq == 0) {
        ml[(warp * 16 + row) * 2] = m[hr];
        ml[(warp * 16 + row) * 2 + 1] = l[hr];
      }
    }
  }
  __syncthreads();
  float* rec0 = ws + ((((size_t)b * nKV + h) * n_split + split) * g + row0) * (DH + 4);
  for (int i = tid; i < gl * (DH / 4); i += FD_THREADS) {
    const int r = i / (DH / 4), d4 = i - r * (DH / 4);
    const int w0 = (r >> 4) * wpq, row = r & 15;
    float M = -INFINITY;
    for (int w = w0; w < w0 + wpq; ++w) M = fmaxf(M, ml[(w * 16 + row) * 2]);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float lsum = 0.0f;
    for (int w = w0; w < w0 + wpq; ++w) {
      const float f = ex2(ml[(w * 16 + row) * 2] - M);
      lsum += f * ml[(w * 16 + row) * 2 + 1];
      const float4 a = reinterpret_cast<const float4*>(red + (w * 16 + row) * DH)[d4];
      acc.x += f * a.x;
      acc.y += f * a.y;
      acc.z += f * a.z;
      acc.w += f * a.w;
    }
    float* rec = rec0 + (size_t)r * (DH + 4);
    reinterpret_cast<float4*>(rec)[d4] = acc;
    if (d4 == 0) {
      rec[DH] = M;
      rec[DH + 1] = lsum;
    }
  }
}

// The fixed-order combine of a (row, KV head)'s splits: grid B * nKV, a
// warp per query row. out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s
// over the splits up to positions[b], M the largest m_s.
template <int DH>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ positions,
                            __nv_bfloat16* __restrict__ out, int nKV, int g, int n_split,
                            int seq_len, int split_len) {
  const int bh = blockIdx.x, b = bh / nKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_valid = min(positions[b] + 1, seq_len);
  const int ns = n_valid > 0 ? (n_valid + split_len - 1) / split_len : 0;
  const size_t stride = (size_t)g * (DH + 4);  // floats from a row's split to the next
  const float* base = ws + (size_t)bh * n_split * stride;
  for (int r = warp; r < g; r += FD_THREADS / 32) {
    const float* rec0 = base + (size_t)r * (DH + 4);
    // lane e holds split e's (m, l) and, once M is known, its weight
    const float2 ml = lane < ns ? *reinterpret_cast<const float2*>(rec0 + lane * stride + DH)
                                : make_float2(-INFINITY, 0.0f);
    float M = ml.x;
    for (int e = lane + 32; e < ns; e += 32) M = fmaxf(M, rec0[e * stride + DH]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float w_lane = ex2(ml.x - M);
    float den = w_lane * ml.y;
    for (int e = lane + 32; e < ns; e += 32) {
      const float* rec = rec0 + e * stride;
      den += ex2(rec[DH] - M) * rec[DH + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    den = fmaxf(den, 1e-20f);
#pragma unroll
    for (int d0 = 0; d0 < DH / 4; d0 += 32) {  // every lane takes the shuffles
      const int d4 = d0 + lane;
      const bool on = d4 < DH / 4;
      float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int e = 0; e < ns; ++e) {
        const float* rec = rec0 + e * stride;
        const float w = e < 32 ? __shfl_sync(0xffffffffu, w_lane, e) : ex2(rec[DH] - M);
        const float4 a = on ? reinterpret_cast<const float4*>(rec)[d4]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        num.x += w * a.x;
        num.y += w * a.y;
        num.z += w * a.z;
        num.w += w * a.w;
      }
      if (on) {
        __nv_bfloat16* dst = out + ((size_t)bh * g + r) * DH + 4 * d4;
        reinterpret_cast<uint2*>(dst)[0] = make_uint2(pack_bf16(num.x / den, num.y / den),
                                                      pack_bf16(num.z / den, num.w / den));
      }
    }
  }
}

template <int DH, int KF, int VF, class Addr>
static cudaError_t launch_fd(const void* q, const void* k, const void* ks, const void* v,
                             const void* vs, const int* positions, void* out, void* ws,
                             long long ws_floats, int B, int nKV, int g, Addr addr, int seq_len,
                             int split_len, float sm_scale, cudaStream_t stream) {
  using Sh = FdShape<DH, KF, VF, Addr::kPairsShare>;
  auto kern = flash_decode_kernel<DH, KF, VF, Addr>;
  static bool attr_set = false;
  if (!attr_set) {  // the largest instance needs ~178 KB (dh 256 bf16, 64 query rows)
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Sh::smem(FD_QROWS / 16, FD_MAX_SPLIT));
    if (e == cudaSuccess)  // as many blocks an SM as registers allow
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  if (split_len < FD_T || split_len > FD_MAX_SPLIT || split_len % FD_T != 0)
    return cudaErrorInvalidValue;
  const int n_split = seq_len > 0 ? (seq_len + split_len - 1) / split_len : 1;
  if ((long long)B * nKV * n_split * g * (DH + 4) > ws_floats) return cudaErrorInvalidValue;
  const int n_qg = (g + FD_QROWS - 1) / FD_QROWS;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  kern<<<dim3(n_split, nKV * n_qg, B), FD_THREADS,
         Sh::smem(((g < FD_QROWS ? g : FD_QROWS) + 15) / 16, split_len), stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, static_cast<const __nv_bfloat16*>(ks), v,
      static_cast<const __nv_bfloat16*>(vs), positions, static_cast<float*>(ws), nKV, g,
      n_split, split_len, addr, scale_log2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_combine_kernel<DH><<<B * nKV, FD_THREADS, 0, stream>>>(
      static_cast<const float*>(ws), positions, static_cast<__nv_bfloat16*>(out), nKV, g,
      n_split, seq_len, split_len);
  return cudaGetLastError();
}

// The (K, V) formats served: bf16/bf16, int8/int8, int4/int4 and int8/int4
// (the "int8k_int4v" cache).
template <int DH, class Addr>
static cudaError_t launch_fd_fmt(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const int* positions, void* out, void* ws,
                                 long long ws_floats, int B, int nKV, int g, Addr addr,
                                 int seq_len, int split_len, int kfmt, int vfmt,
                                 float sm_scale, cudaStream_t st) {
  if (kfmt == KV_BF16 && vfmt == KV_BF16)
    return launch_fd<DH, KV_BF16, KV_BF16>(q, k, ks, v, vs, positions, out, ws, ws_floats, B,
                                           nKV, g, addr, seq_len, split_len, sm_scale, st);
  if (kfmt == KV_I8 && vfmt == KV_I8)
    return launch_fd<DH, KV_I8, KV_I8>(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV,
                                       g, addr, seq_len, split_len, sm_scale, st);
  if (kfmt == KV_I4 && vfmt == KV_I4)
    return launch_fd<DH, KV_I4, KV_I4>(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV,
                                       g, addr, seq_len, split_len, sm_scale, st);
  if (kfmt == KV_I8 && vfmt == KV_I4)
    return launch_fd<DH, KV_I8, KV_I4>(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV,
                                       g, addr, seq_len, split_len, sm_scale, st);
  return cudaErrorInvalidValue;
}

// dh in {64, 128, 256}, any g >= 1; splits of split_len positions (a
// multiple of 64 up to 256: ops/flash_decode.py decode_split).
template <class Addr>
static int dispatch_fd(const void* q, const void* k, const void* ks, const void* v,
                       const void* vs, const int* positions, void* out, void* ws,
                       long long ws_floats, int B, int nKV, int g, Addr addr, int seq_len,
                       int split_len, int dh, int kfmt, int vfmt, float sm_scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || B < 1 || nKV < 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch_fd_fmt<64>(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV, g,
                                  addr, seq_len, split_len, kfmt, vfmt, sm_scale, st);
  if (dh == 128)
    return (int)launch_fd_fmt<128>(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV, g,
                                   addr, seq_len, split_len, kfmt, vfmt, sm_scale, st);
  if (dh == 256)
    return (int)launch_fd_fmt<256>(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV, g,
                                   addr, seq_len, split_len, kfmt, vfmt, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftcf
