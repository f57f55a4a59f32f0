// K10: chunked-prefill attention over the paged KV pool, many queries a row.
//
// Row b brings C consecutive queries starting at logical position pos[b];
// query c with head j of KV group h attends keys 0 .. pos[b] + c. Replaces
// fastertransformer4codefuse_tpu/ops/flash_decode.py flash_chunk_paged
// (_kernel in chunk mode). (K5, the causal prefill over the prompt's own
// K/V, ran on this tile loop until it moved to wgmma + TMA in
// prefill_flash.cu.)
//
// Math: the C queries and the gq query heads of a KV head ride one row axis,
// r = c * gq + j, bounded at start + r / gq; scores = (q . k) * k_s *
// sm_scale, masked per row; online softmax in fp32; (p * v_s) rounded to
// bf16 before the PV product (int8 and int4 -> bf16 are exact; bf16 K/V
// round p alone); the denominator sums the unrounded fp32 p. A row whose
// bound lies before a key tile gets p = 0 there (the JAX kernel's re-mask
// hazard), and keys past the tile's last bound are never read (zeros in
// shared memory, so stale page bytes never reach PV). Pages are bf16, int8
// or packed int4 (K and V templated apart: "int8k_int4v" mixes them); a
// packed pair row holds positions 2i (low nibble) and 2i + 1, read at the
// unpacked index's u / 2 with the scale at u.
//
// Bound: at CodeFuse-13B with C = 128 queries over ~1000 keys a row is
// ~2.7 GFLOP a layer against ~10.5 MB of int8 K/V, near the card's
// 295 FLOP/byte balance. So the products run on the tensor cores:
// mma.sync m16n8k16 bf16 with fp32 accumulation (its fragment layouts are
// fixed by the PTX ISA, so the online-softmax rescale of each accumulator row
// happens in registers and P feeds the PV product from registers).
//
// Design: one block of 8 warps per (128-row query tile, KV head, row); each
// warp owns 16 query rows, and the 128 rows of a KV head share one block,
// so each K/V byte is read and converted once per (query tile, KV head). The
// block loops over 64-key tiles up to the tile's last bound. Each thread
// resolves its keys' vectors through the KV policy (the block table, the
// block loading its own page ids, no host round trip) and loads K, V and
// their scales with 16-byte loads into registers; at dh 128 the next tile's
// loads are issued before the current tile's products, so they stay in
// flight under them, and each warp keeps its Q fragments in registers. A
// tile is stored in shared memory as bf16 [key][dh] for K and V; each warp
// computes S = Q K^T (16 x 64), the K fragments read with ldmatrix, updates
// its rows' running max and denominator, and accumulates P V into 16 x dh
// fp32 registers, the V fragments read with ldmatrix.trans. PERF.md holds
// the measured effect of each of these choices.
#include <math.h>

#include "ftcf_common.cuh"
#include "ftcf_mma.cuh"

namespace ftcf {

constexpr int FC_WARPS = 8;
constexpr int FC_THREADS = FC_WARPS * 32;
constexpr int FC_BM = FC_WARPS * 16;  // query rows per block, 16 per warp
constexpr int FC_BN = 64;             // keys per tile

// The KV policy: where row b's queries start (start), how many of its keys
// exist (keys), and where key s of (row b, KV head h) is cached (vec, the
// unpacked vector index): the layer's [P, nKV, ps, dh] page slab through
// the block table pt [B, n_pg]; row b's C queries start at pos[b].
struct PagedKV {
  const int* pos;
  const int* pt;
  int n_pg, ps;
  __device__ int start(int b) const { return pos[b]; }
  __device__ int keys(int) const { return n_pg * ps; }
  __device__ uint32_t vec(int b, int h, int nKV, int s) const {
    const int page = pt[(size_t)b * n_pg + min(s / ps, n_pg - 1)];
    return ((uint32_t)page * nKV + h) * ps + s % ps;
  }
};

template <int DH>
struct ChunkSmem {
  static constexpr int LD = DH + 8;  // bf16 row pitch of Q, K and V (pad: no bank conflicts)
  static constexpr size_t bytes = (size_t)(FC_BM + 2 * FC_BN) * LD * 2 + FC_BN * 8;
};

// 16 cached values of one key, from one 16-byte load, stored as bf16 (int8
// and int4 -> bf16 are exact). A packed int4 load holds dims of two keys,
// the even one in the low nibbles: ``odd`` picks the key.
template <int FMT>
__device__ __forceinline__ void stage16(const uint4& u, bool odd, __nv_bfloat16* dst) {
  if constexpr (FMT == KV_BF16) {
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
    float f[16];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (FMT == KV_I8)
        i8x4_to_f32(w[i], f + 4 * i);
      else
        i4x4_nibble_to_f32(w[i], odd, f + 4 * i);
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
    d[1] = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]), pack_bf16(f[12], f[13]),
                      pack_bf16(f[14], f[15]));
  }
}

template <int DH, int KF, int VF, class KV>
__global__ void __launch_bounds__(FC_THREADS)
flash_chunk_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ ks, const void* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ vs, __nv_bfloat16* __restrict__ out, int C,
                   int nKV, int gq, KV kv, float sm_scale) {
  constexpr bool QUANT = KF != KV_BF16;  // int8 or int4 payloads carry scales
  static_assert((KF == KV_BF16) == (VF == KV_BF16), "bf16 K goes with bf16 V");
  constexpr int LD = ChunkSmem<DH>::LD;
  constexpr int W = QUANT ? 16 : 8;                 // cache values per 16-byte load
  constexpr int KCH = DH / W;                       // 16-byte loads per cached vector
  constexpr int NLD = FC_BN * KCH / FC_THREADS;     // of K (and of V) per thread per tile
  constexpr int NT = FC_BN / 8;                     // 8-key MMA tiles of a key tile
  constexpr int DT = DH / 8;                        // 8-dim MMA tiles of the output
  // the next tile's loads are issued before the current tile's products,
  // and the warp's Q fragments stay in registers, where the registers allow
  // it (dh 128)
  constexpr bool PREFETCH = DH == 128;
  constexpr bool QREG = DH == 128;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [FC_BM][LD]
  __nv_bfloat16* Ks = Qs + FC_BM * LD;                           // [FC_BN][LD]
  __nv_bfloat16* Vs = Ks + FC_BN * LD;                           // [FC_BN][LD]
  float* ks_s = reinterpret_cast<float*>(Vs + FC_BN * LD);       // [FC_BN]
  float* vs_s = ks_s + FC_BN;                                    // [FC_BN]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t4 = lane & 3;
  const int R = C * gq, nH = nKV * gq;
  const int r0 = tile * FC_BM;
  const int p0 = kv.start(b);
  // the last key any row of this tile may see (inclusive)
  const int key_end = min(p0 + (min(R, r0 + FC_BM) - 1) / gq, kv.keys(b) - 1);

  for (int i = tid; i < FC_BM * (DH / 8); i += FC_THREADS) {
    const int r = i / (DH / 8), c8 = (i - r * (DH / 8)) * 8, rr = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (rr < R) {
      const int c = rr / gq, j = rr - c * gq;
      val = *reinterpret_cast<const uint4*>(q + ((size_t)(b * C + c) * nH + h * gq + j) * DH + c8);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c8) = val;
  }

  // a tile's K, V (16-byte loads; consecutive threads, consecutive bytes of
  // a key) and scales, resolved through the block table
  auto load_one = [&](int i, int k0, uint4& uk, uint4& uv) {
    const int idx = tid + i * FC_THREADS, key = idx / KCH, c = idx - key * KCH;
    uk = uv = make_uint4(0, 0, 0, 0);
    if (k0 + key <= key_end) {
      const uint32_t u = kv.vec(b, h, nKV, k0 + key);
      const size_t ko = kv_vec_off<KF>(u, DH) + c * W, vo = kv_vec_off<VF>(u, DH) + c * W;
      if constexpr (QUANT) {
        uk = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(kc) + ko);
        uv = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(vc) + vo);
      } else {
        uk = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(kc) + ko);
        uv = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(vc) + vo);
      }
    }
  };
  // ... stored as bf16 [key][dh]. A key's vector index has the parity of
  // its position (even page size), and tiles start at even positions, so
  // key % 2 picks the nibble of a packed pair row.
  auto store_one = [&](int i, const uint4& uk, const uint4& uv) {
    const int idx = tid + i * FC_THREADS, key = idx / KCH, c = idx - key * KCH;
    stage16<KF>(uk, key & 1, Ks + key * LD + c * W);
    stage16<VF>(uv, key & 1, Vs + key * LD + c * W);
  };
  float ksr = 0.0f, vsr = 0.0f;
  auto load_scales = [&](int k0) {
    if (QUANT && tid < FC_BN) {
      ksr = vsr = 0.0f;
      if (k0 + tid <= key_end) {
        const uint32_t vv = kv.vec(b, h, nKV, k0 + tid);
        ksr = __bfloat162float(ks[vv]);
        vsr = __bfloat162float(vs[vv]);
      }
    }
  };
  auto store_scales = [&]() {
    if (QUANT && tid < FC_BN) {
      ks_s[tid] = ksr;
      vs_s[tid] = vsr;
    }
  };
  constexpr int NPF = PREFETCH ? NLD : 1;
  uint4 kr[NPF], vr[NPF];  // the next tile, in flight
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < (PREFETCH ? NLD : 0); ++i) load_one(i, k0, kr[i], vr[i]);
    load_scales(k0);
  };
  // stage tile k0 in shared memory: from the registers the previous
  // iteration filled, or (no prefetch) load by load, so that only one
  // load's registers are live beside the accumulators
  auto stage_tile = [&](int k0) {
    if constexpr (PREFETCH) {
#pragma unroll
      for (int i = 0; i < NPF; ++i) store_one(i, kr[i], vr[i]);
    } else {
#pragma unroll 2
      for (int i = 0; i < NLD; ++i) {
        uint4 uk, uv;
        load_one(i, k0, uk, uv);
        store_one(i, uk, uv);
      }
      load_scales(k0);
    }
    store_scales();
  };

  // this thread's two rows of the warp's 16: grp and grp + 8
  const int rr0 = r0 + warp * 16 + grp, rr1 = rr0 + 8;
  const int bound0 = rr0 < R ? min(p0 + rr0 / gq, key_end) : -1;
  const int bound1 = rr1 < R ? min(p0 + rr1 / gq, key_end) : -1;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;

  // A fragment of the warp's Q rows for dims kk .. kk + 15
  auto load_qa = [&](int kk, uint32_t* a) {
    const __nv_bfloat16* qa = Qs + (warp * 16 + grp) * LD + kk + t4 * 2;
    a[0] = *reinterpret_cast<const uint32_t*>(qa);
    a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
    a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
  };
  uint32_t qf[QREG ? DH / 16 : 1][4];
  if constexpr (QREG) {
    __syncthreads();  // Q is stored
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) load_qa(kk, qf[kk / 16]);
  }
  // ldmatrix row address of this lane for the K fragments: matrix j = lane / 8
  // covers keys 8 (j / 2) .. + 7 of a 16-key pair and dims 8 (j % 2) .. + 7
  const int krow = (lane >> 4) * 8 + (lane & 7), kcol = (lane >> 3 & 1) * 8;

  if constexpr (PREFETCH) load_tile(0);
  for (int k0 = 0; k0 <= key_end; k0 += FC_BN) {
    __syncthreads();  // the previous tile's readers are done (and Q is stored)
    stage_tile(k0);
    __syncthreads();
    if constexpr (PREFETCH) {
      if (k0 + FC_BN <= key_end) load_tile(k0 + FC_BN);
    }

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t a_ld[4];
      const uint32_t* a = a_ld;
      if constexpr (QREG)
        a = qf[kk / 16];
      else
        load_qa(kk, a_ld);
      // B fragments of two 8-key tiles per 4-matrix load
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Ks + (np * 16 + krow) * LD + kk + kcol);
        mma_16816(sc[2 * np], a, r);
        mma_16816(sc[2 * np + 1], a, r + 2);
      }
    }

    // scale, mask per row, running max over the 4 threads of a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + t4 * 2 + e, s = k0 + col;
        const float kscale = QUANT ? ks_s[col] : 1.0f;
        sc[nt][e] = s <= bound0 ? sc[nt][e] * kscale * sm_scale : -INFINITY;
        sc[nt][2 + e] = s <= bound1 ? sc[nt][2 + e] * kscale * sm_scale : -INFINITY;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][2 + e]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key yet keeps alpha 1 and p 0
    const float al0 = mn0 == -INFINITY ? 1.0f : expf(m0 - mn0);
    const float al1 = mn1 == -INFINITY ? 1.0f : expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P (times the value scales, rounded to bf16) as the A fragments of P V:
    // S tiles 2kt and 2kt + 1 are keys 16kt .. 16kt + 15
    uint32_t pa[FC_BN / 16][4];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4], w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mrow = e < 2 ? mn0 : mn1;
        p[e] = sc[nt][e] == -INFINITY ? 0.0f : expf(sc[nt][e] - mrow);
        w[e] = QUANT ? p[e] * vs_s[nt * 8 + t4 * 2 + (e & 1)] : p[e];
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(w[0], w[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(w[2], w[3]);
    }
    l0 = al0 * l0 + ps0;  // this thread's share; the 4 shares add up at the end
    l1 = al1 * l1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }
    // O += P V: B fragments of two 8-dim tiles per transposed 4-matrix load
    const int mkey = (lane >> 3 & 1) * 8 + (lane & 7), mdim = (lane >> 4) * 8;
#pragma unroll
    for (int kt = 0; kt < FC_BN / 16; ++kt) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Vs + (kt * 16 + mkey) * LD + dp * 16 + mdim);
        mma_16816(o[2 * dp], pa[kt], r);
        mma_16816(o[2 * dp + 1], pa[kt], r + 2);
      }
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
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
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(o[dt][half * 2] * inv, o[dt][half * 2 + 1] * inv);
  }
}

template <int DH, int KF, int VF, class KV>
static cudaError_t launch_fc(const void* q, const void* k, const void* ks, const void* v,
                             const void* vs, KV kv, void* out, int B, int C, int nKV, int gq,
                             float sm_scale, cudaStream_t stream) {
  auto kern = flash_chunk_kernel<DH, KF, VF, KV>;
  const size_t smem = ChunkSmem<DH>::bytes;
  // one flag per template instance; benign race: every setter writes the same value
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((C * gq + FC_BM - 1) / FC_BM, nKV, B);
  kern<<<grid, FC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, static_cast<const __nv_bfloat16*>(ks), v,
      static_cast<const __nv_bfloat16*>(vs), static_cast<__nv_bfloat16*>(out), C, nKV, gq, kv,
      sm_scale);
  return cudaGetLastError();
}

// The (K, V) page formats served: bf16/bf16, int8/int8, int4/int4, int8/int4.
template <int DH>
static cudaError_t launch_fc_fmt(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, PagedKV kv, void* out, int B, int C, int nKV,
                                 int gq, int kfmt, int vfmt, float sm_scale, cudaStream_t st) {
  if (kfmt == KV_BF16 && vfmt == KV_BF16)
    return launch_fc<DH, KV_BF16, KV_BF16>(q, k, ks, v, vs, kv, out, B, C, nKV, gq, sm_scale, st);
  if (kfmt == KV_I8 && vfmt == KV_I8)
    return launch_fc<DH, KV_I8, KV_I8>(q, k, ks, v, vs, kv, out, B, C, nKV, gq, sm_scale, st);
  if (kfmt == KV_I4 && vfmt == KV_I4)
    return launch_fc<DH, KV_I4, KV_I4>(q, k, ks, v, vs, kv, out, B, C, nKV, gq, sm_scale, st);
  if (kfmt == KV_I8 && vfmt == KV_I4)
    return launch_fc<DH, KV_I8, KV_I4>(q, k, ks, v, vs, kv, out, B, C, nKV, gq, sm_scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace ftcf

extern "C" {

// K10. q [B, C, nKV * gq, dh] bf16; k/v the layer's [P, nKV, ps, dh] page
// slabs in the formats kfmt / vfmt (KVFmt: bf16; int8; packed int4
// [P, nKV, ps/2, dh] with ps even), the quantized ones with ks/vs
// [P, nKV, ps] bf16 scales; pos [B] int32 chunk starts; pt [B, n_pg] int32
// block table; out like q. dh is 128 or 256.
int ftcf_flash_chunk_paged(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const int* pos, const int* pt, void* out, int B, int C,
                           int nKV, int gq, int n_pg, int ps, int dh, int kfmt, int vfmt,
                           float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ftcf::PagedKV kv{pos, pt, n_pg, ps};
  if (gq < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (dh == 128)
    return (int)ftcf::launch_fc_fmt<128>(q, k, ks, v, vs, kv, out, B, C, nKV, gq, kfmt, vfmt,
                                         sm_scale, st);
  if (dh == 256)
    return (int)ftcf::launch_fc_fmt<256>(q, k, ks, v, vs, kv, out, B, C, nKV, gq, kfmt, vfmt,
                                         sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
