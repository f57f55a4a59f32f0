// K12: banded sliding-window attention (Longformer's local attention).
//
// q, k, v, out [B, S, nH, dh] bf16, q already scaled by 1/sqrt(dh). Query i
// of row b sees key j iff |i - j| <= w (causal: i - w <= j <= i) and
// j < lens[b]; rows i >= lens[b] (the padding of a right-padded batch) are
// written as 0. Replaces fastertransformer4codefuse_tpu/ops/sliding_window.py
// sliding_window_attention (its Pallas body _kernel), whose grid visits only
// the KV chunks that meet each query chunk's band.
//
// Math: scores q . k in fp32; online softmax in fp32; p rounded to bf16
// before the PV product, the denominator summing the unrounded p (K5's
// arithmetic, so the plain version rounds the probabilities alike).
//
// Bound: at Longformer-base (12 heads x 64, w = 256) a 128-query tile reads
// 2w + 128 = 640 keys: ~10.5 MFLOP against ~180 KB of K/V from device
// memory per (tile, head), ~58 FLOP a byte, below the card's ~295 balance.
// But each K/V byte is read by ceil((2w + 128) / 128) = 5 overlapping query
// tiles, which L2 serves, so the floor is the bytes: q, k and v of the
// unpadded rows (no padded row is read) and the whole out, once each.
//
// Design: the mma.sync tile loop K5 and K10 ran before they moved to wgmma +
// TMA (prefill_flash.cu, flash_chunk.cu), with a band policy, kept
// in its own file so that the decode/prefill kernels' instances do not
// change. One block of 8 warps per (128-query tile, head, row); each warp
// owns 16 query rows and keeps their Q fragments in registers. The block
// walks 64-key tiles over [q0 - w, q_last + w] (causal: [q0 - w, q_last])
// cut to [0, len), q_last the tile's last unpadded row; a tile with no
// unpadded row writes zeros and reads nothing. A warp skips the products of
// a key tile that misses its 16 rows' band. The next tile's K/V loads are
// issued before the current tile's products (16-byte loads into registers),
// then staged in shared memory as bf16 [key][dh]; mma.sync m16n8k16 for
// S = Q K^T (K fragments by ldmatrix) and O += P V (V by ldmatrix.trans),
// with each element masked to its row's band. dh is 64 or 128; at dh 64 the
// launch bounds ask for two blocks an SM, whose syncs then overlap (PERF.md
// has the effect).
#include <math.h>

#include "ftcf_common.cuh"
#include "ftcf_mma.cuh"

namespace ftcf {

constexpr int SW_WARPS = 8;
constexpr int SW_THREADS = SW_WARPS * 32;
constexpr int SW_BM = SW_WARPS * 16;  // query rows per block, 16 per warp
constexpr int SW_BN = 64;             // keys per tile

template <int DH>
struct BandSmem {
  static constexpr int LD = DH + 8;  // bf16 row pitch (pad: no bank conflicts)
  static constexpr size_t bytes = (size_t)(SW_BM + 2 * SW_BN) * LD * 2;
};

// two blocks an SM at dh 64 (at most 128 registers a thread)
template <int DH>
__global__ void __launch_bounds__(SW_THREADS, DH == 64 ? 2 : 1)
sliding_window_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
                      __nv_bfloat16* __restrict__ out, int S, int nH, int w, int causal) {
  constexpr int LD = BandSmem<DH>::LD;
  constexpr int KCH = DH / 8;                    // 16-byte loads per key vector
  constexpr int NLD = SW_BN * KCH / SW_THREADS;  // of K (and of V) per thread per tile
  constexpr int NT = SW_BN / 8;                  // 8-key MMA tiles of a key tile
  constexpr int DT = DH / 8;                     // 8-dim MMA tiles of the output
  static_assert(NLD * SW_THREADS == SW_BN * KCH, "a key tile splits evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [SW_BM][LD]
  __nv_bfloat16* Ks = Qs + SW_BM * LD;                           // [SW_BN][LD]
  __nv_bfloat16* Vs = Ks + SW_BN * LD;                           // [SW_BN][LD]

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, t4 = lane & 3;
  const int q0 = tile * SW_BM;
  const int len = min(max(lens[b], 0), S);
  const size_t row_stride = (size_t)nH * DH;  // elements from one position to the next
  const __nv_bfloat16* qb = q + (size_t)b * S * row_stride + (size_t)h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * S * row_stride + (size_t)h * DH;
  const __nv_bfloat16* vb = v + (size_t)b * S * row_stride + (size_t)h * DH;
  __nv_bfloat16* ob = out + (size_t)b * S * row_stride + (size_t)h * DH;

  if (q0 >= len) {  // every row of the tile is padding: zeros, nothing read
    for (int i = tid; i < SW_BM * KCH; i += SW_THREADS) {
      const int r = i / KCH, c8 = (i - r * KCH) * 8;
      if (q0 + r < S)
        *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * row_stride + c8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int q_last = min(q0 + SW_BM, len) - 1;  // the tile's last unpadded row
  const int key_lo = max(q0 - w, 0);
  const int key_hi = causal ? q_last : min(q_last + w, len - 1);

  for (int i = tid; i < SW_BM * KCH; i += SW_THREADS) {
    const int r = i / KCH, c8 = (i - r * KCH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * row_stride + c8);
    *reinterpret_cast<uint4*>(Qs + r * LD + c8) = val;
  }

  // this thread's two rows of the warp's 16, grp and grp + 8, and the keys
  // each may see: [lo, hi] (empty for a padded row)
  const int rr0 = q0 + warp * 16 + grp, rr1 = rr0 + 8;
  auto band_lo = [&](int rr) { return rr < len ? rr - w : 1; };
  auto band_hi = [&](int rr) { return rr < len ? min(causal ? rr : rr + w, len - 1) : 0; };
  const int lo0 = band_lo(rr0), hi0 = band_hi(rr0), lo1 = band_lo(rr1), hi1 = band_hi(rr1);
  // the keys any row of the warp may see, for skipping whole key tiles
  const int wr0 = q0 + warp * 16, wr1 = min(wr0 + 15, q_last);
  const int warp_lo = wr0 - w, warp_hi = causal ? wr1 : wr1 + w;
  const bool warp_live = wr0 <= q_last;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;

  // the next tile's K and V, in flight in registers (16-byte loads;
  // consecutive threads, consecutive bytes of a key)
  uint4 kr[NLD], vr[NLD];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NLD; ++i) {
      const int idx = tid + i * SW_THREADS, key = idx / KCH, c = idx - key * KCH;
      kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
      if (k0 + key <= key_hi) {
        const size_t off = (size_t)(k0 + key) * row_stride + c * 8;
        kr[i] = *reinterpret_cast<const uint4*>(kb + off);
        vr[i] = *reinterpret_cast<const uint4*>(vb + off);
      }
    }
  };

  __syncthreads();  // Q is stored
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    const __nv_bfloat16* qa = Qs + (warp * 16 + grp) * LD + kk + t4 * 2;
    qf[kk / 16][0] = *reinterpret_cast<const uint32_t*>(qa);
    qf[kk / 16][1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
    qf[kk / 16][2] = *reinterpret_cast<const uint32_t*>(qa + 8);
    qf[kk / 16][3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
  }
  // ldmatrix row address of this lane for the K fragments: matrix j = lane / 8
  // covers keys 8 (j / 2) .. + 7 of a 16-key pair and dims 8 (j % 2) .. + 7
  const int krow = (lane >> 4) * 8 + (lane & 7), kcol = (lane >> 3 & 1) * 8;
  // and for the V fragments: keys 8 (j % 2) .. + 7, dims 8 (j / 2) .. + 7
  const int mkey = (lane >> 3 & 1) * 8 + (lane & 7), mdim = (lane >> 4) * 8;

  load_tile(key_lo);
  for (int k0 = key_lo; k0 <= key_hi; k0 += SW_BN) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < NLD; ++i) {
      const int idx = tid + i * SW_THREADS, key = idx / KCH, c = idx - key * KCH;
      *reinterpret_cast<uint4*>(Ks + key * LD + c * 8) = kr[i];
      *reinterpret_cast<uint4*>(Vs + key * LD + c * 8) = vr[i];
    }
    __syncthreads();
    if (k0 + SW_BN <= key_hi) load_tile(k0 + SW_BN);
    if (!warp_live || k0 > warp_hi || k0 + SW_BN - 1 < warp_lo) continue;  // off the band

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Ks + (np * 16 + krow) * LD + kk + kcol);
        mma_16816(sc[2 * np], qf[kk / 16], r);
        mma_16816(sc[2 * np + 1], qf[kk / 16], r + 2);
      }
    }

    // mask each element to its row's band, running max over the 4 threads of a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = k0 + nt * 8 + t4 * 2 + e;
        if (s < lo0 || s > hi0) sc[nt][e] = -INFINITY;
        if (s < lo1 || s > hi1) sc[nt][2 + e] = -INFINITY;
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

    // P rounded to bf16 as the A fragments of P V: S tiles 2kt and 2kt + 1
    // are keys 16kt .. 16kt + 15
    uint32_t pa[SW_BN / 16][4];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mrow = e < 2 ? mn0 : mn1;
        p[e] = sc[nt][e] == -INFINITY ? 0.0f : expf(sc[nt][e] - mrow);
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
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
#pragma unroll
    for (int kt = 0; kt < SW_BN / 16; ++kt) {
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
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = half ? rr1 : rr0;
    if (rr >= S) continue;
    // an unpadded row always sees its own key, so its denominator is > 0
    const float inv = rr < len ? 1.0f / fmaxf(half ? l1 : l0, 1e-20f) : 0.0f;
    __nv_bfloat16* dst = ob + (size_t)rr * row_stride + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(o[dt][half * 2] * inv, o[dt][half * 2 + 1] * inv);
  }
}

template <int DH>
static cudaError_t launch_sw(const void* q, const void* k, const void* v, const int* lens,
                             void* out, int B, int S, int nH, int w, int causal,
                             cudaStream_t stream) {
  auto kern = sliding_window_kernel<DH>;
  const size_t smem = BandSmem<DH>::bytes;
  // one flag per template instance; benign race: every setter writes the same value
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((S + SW_BM - 1) / SW_BM, nH, B);
  kern<<<grid, SW_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lens, static_cast<__nv_bfloat16*>(out), S, nH, w,
      causal);
  return cudaGetLastError();
}

}  // namespace ftcf

extern "C" {

// K12. q/k/v/out [B, S, nH, dh] bf16 (q already scaled); lens [B] int32
// valid lengths (right padding); w >= 0 the half window; causal 0 or 1.
// dh is 64 or 128.
int ftcf_sliding_window(const void* q, const void* k, const void* v, const int* lens, void* out,
                        int B, int S, int nH, int dh, int w, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || nH < 1 || w < 0) return (int)cudaErrorInvalidValue;
  if (w > S) w = S;  // a wider window sees the same keys
  if (dh == 64) return (int)ftcf::launch_sw<64>(q, k, v, lens, out, B, S, nH, w, causal != 0, st);
  if (dh == 128)
    return (int)ftcf::launch_sw<128>(q, k, v, lens, out, B, S, nH, w, causal != 0, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
