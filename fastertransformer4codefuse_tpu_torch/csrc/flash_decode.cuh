// The decode attention body of K4, K9 and K11, one query token per row, over
// the dense KV cache (K4), the paged pool through a block table (K9), or the
// dense cache through the beam search's cache indirection (K11). One kernel
// body, templated on how a position is addressed, as the JAX package's
// _kernel is shared by K4 and K9. The entry points are in flash_decode.cu
// (K4), flash_decode_paged.cu (K9) and flash_decode_beam.cu (K11): one
// source per addressing policy, so that their instantiations (16 each: the
// format pairs, dh and g) compile in parallel.
//
// Replaces fastertransformer4codefuse_tpu/ops/flash_decode.py
// flash_decode_stacked (K4), flash_decode_paged (K9) (_kernel) and
// flash_decode_beam_stacked (K11, _beam_kernel): online
// softmax over sequence chunks, the causal bound col <= positions[b]
// inclusive, reads stop at positions[b], and g = nH / nKV query rows per KV
// head (GQA). The int8 cache carries one bf16 scale per cached vector:
// scores = (q . k8) * k_s * sm_scale, and the value scale folds into the
// probability, (p * v_s) rounded to bf16, before the PV product; int8 ->
// float is exact. A bf16 cache has no scales and rounds p to bf16 alone. The
// denominator sums the unrounded fp32 p.
//
// Formats: the kernel is templated on the K and V formats apart (KVFmt):
// bf16, int8, or packed int4 (the "int4" and "int8k_int4v" caches), where
// positions 2i and 2i + 1 share pair row i (2i in the low nibble) and the
// scales stay per unpacked position. The addressing below gives the
// unpacked vector index u; the scale is read at u, the payload at pair row
// u / 2, nibble u % 2 (kv_vec_off), which needs an even S or page size. Each
// thread loads its own position's pair row and keeps its nibble; its
// neighbour's load of the same bytes comes from L1. int4 -> float is exact.
//
// Addressing: K4 reads position s of (row b, KV head h) at cached vector
// (b * nKV + h) * S + s of the layer's [B, nKV, S, dh] slab. K9 reads it at
// (pt[b, s / ps] * nKV + h) * ps + s % ps of the layer's [P, nKV, ps, dh]
// page slab: at the start of each 128-position chunk every thread resolves
// its position's vector through the block table (the block loads its own
// page ids; no host round trip) into shared memory, where both phases read
// it. Any page size is taken. K11 reads position s of beam row b (group
// b / bw) at (r * nKV + h) * S + s with r = b - b % bw + indir[b, s],
// resolved the same way at each chunk's start: each row reads one vector per
// position, so K11 moves K4's bytes at B = BB plus 4 bytes of indir per
// position. (The Pallas kernel streams a group's bw rows once and selects
// in registers, bw-fold FLOPs for the same bytes; a CUDA block per row needs
// no select.) Positions past positions[b] are never read.
//
// Bound: the cache bytes up to positions[b] (2 * pos * dh bytes per KV head
// for int8, half that packed), read once per (row, KV head): at CodeFuse-13B,
// 8 slots at ~1000 positions with int8 pages, ~84 MB a layer, ~25 us at
// 3.35 TB/s. With few
// blocks in flight (B * nKV) the kernel is bound by memory latency, so each
// phase keeps many independent loads in flight. Design: one block of 128
// threads per (row, KV head), looping over 128-position chunks up to
// positions[b], with the running max and denominator per query row in
// shared memory.
//  - scores: one thread per cached position; it reads the position's whole
//    key vector with 16-byte loads and dots it with every query row (q sits
//    in shared memory; all threads read the same q word, a broadcast);
//  - softmax: one warp per query row over the chunk;
//  - PV: thread t owns dh/32 contiguous output dims (one 4- to 16-byte load
//    per position) for the positions t/32, t/32 + 4, ...; the four position
//    groups' partial sums are added through shared memory at the end.
// Any S is taken; there is no minimum cache length. At B = 1 CodeFuse-13B
// fills 40 of the 132 SMs: splitting S across blocks (split-S with a combine
// pass) is later work.
#pragma once

#include <math.h>
#include <string.h>

#include "ftcf_common.cuh"

namespace ftcf {

constexpr int FD_THREADS = 128;
constexpr int FD_BS = FD_THREADS;  // positions per chunk: one per thread
constexpr int FD_PG = FD_THREADS / 32;  // position groups in the PV phase

// 16 consecutive cache values as floats: one 16-byte int8 or packed-int4
// load (``odd`` picks the nibble of a packed pair row), or two bf16 loads.
template <int FMT>
__device__ __forceinline__ void load16(const void* base, size_t off, bool odd, float* f) {
  if constexpr (FMT == KV_BF16) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = p[h];
      bf16x2_to_f32(u.x, f + 8 * h);
      bf16x2_to_f32(u.y, f + 8 * h + 2);
      bf16x2_to_f32(u.z, f + 8 * h + 4);
      bf16x2_to_f32(u.w, f + 8 * h + 6);
    }
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(base) + off);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (FMT == KV_I8)
        i8x4_to_f32(w[i], f + 4 * i);
      else
        i4x4_nibble_to_f32(w[i], odd, f + 4 * i);
    }
  }
}

// N = 4 or 8 consecutive cache values as floats.
template <int N, int FMT>
__device__ __forceinline__ void load_small(const void* base, size_t off, bool odd, float* f) {
  if constexpr (FMT == KV_BF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + off;
    if constexpr (N == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      bf16x2_to_f32(u.x, f);
      bf16x2_to_f32(u.y, f + 2);
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      bf16x2_to_f32(u.x, f);
      bf16x2_to_f32(u.y, f + 2);
      bf16x2_to_f32(u.z, f + 4);
      bf16x2_to_f32(u.w, f + 6);
    }
  } else {
    const int8_t* p = static_cast<const int8_t*>(base) + off;
    uint32_t w[2];
    if constexpr (N == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    }
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      if constexpr (FMT == KV_I8)
        i8x4_to_f32(w[i], f + 4 * i);
      else
        i4x4_nibble_to_f32(w[i], odd, f + 4 * i);
    }
  }
}

// Where position s of (row b, KV head h) is cached: K4's dense slab.
struct DenseAddr {
  int S;
  __device__ int seq_len() const { return S; }
  __device__ uint32_t vec(int b, int h, int nKV, int s) const {
    return ((uint32_t)b * nKV + h) * S + s;
  }
};

// K9's page slab, through the block table pt [B, n_pg].
struct PagedAddr {
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
  const int* indir;
  int S, bw;
  __device__ int seq_len() const { return S; }
  __device__ uint32_t vec(int b, int h, int nKV, int s) const {
    const int row = b - b % bw + indir[(size_t)b * S + s];
    return ((uint32_t)row * nKV + h) * S + s;
  }
};

template <int DH, int MAXG, int KF, int VF, class Addr>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ ks, const void* __restrict__ vc,
                    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ positions,
                    __nv_bfloat16* __restrict__ out, int nKV, int g, Addr addr, float sm_scale) {
  constexpr int VPT = DH / 32;  // output dims per thread in the PV phase
  constexpr int NW = FD_THREADS / 32;
  constexpr bool QUANT = KF != KV_BF16;  // int8 or int4 payloads carry scales
  static_assert((KF == KV_BF16) == (VF == KV_BF16), "bf16 K goes with bf16 V");
  __shared__ float q_s[MAXG][DH];
  __shared__ float p_s[MAXG][FD_BS];
  __shared__ float red[FD_PG][MAXG][DH];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];
  __shared__ uint32_t vec_s[FD_BS];  // the chunk's cached-vector indices

  const int b = blockIdx.x / nKV, h = blockIdx.x - b * nKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dg = lane, pg = warp;  // PV: dims dg * VPT.., positions pg, pg + 4, ...
  const int n_valid = min(positions[b] + 1, addr.seq_len());
  const size_t qrow0 = ((size_t)b * nKV + h) * g;  // query head h * g + r of row b

  for (int i = tid; i < g * DH; i += FD_THREADS) {
    const int r = i / DH, d = i - r * DH;
    q_s[r][d] = __bfloat162float(q[(qrow0 + r) * DH + d]);
  }
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[MAXG][VPT];
#pragma unroll
  for (int r = 0; r < MAXG; ++r)
#pragma unroll
    for (int i = 0; i < VPT; ++i) acc[r][i] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < n_valid; c0 += FD_BS) {
    const int cn = min(FD_BS, n_valid - c0);
    if (tid < cn) {
      const uint32_t row = addr.vec(b, h, nKV, c0 + tid);
      vec_s[tid] = row;
      const size_t koff = kv_vec_off<KF>(row, DH);
      float dot[MAXG];
#pragma unroll
      for (int r = 0; r < MAXG; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        float kf[16];
        load16<KF>(kc, koff + d0, row & 1, kf);
#pragma unroll
        for (int r = 0; r < MAXG; ++r) {
          if (r < g) {
#pragma unroll
            for (int i = 0; i < 16; ++i) dot[r] = fmaf(q_s[r][d0 + i], kf[i], dot[r]);
          }
        }
      }
      const float kscale = QUANT ? __bfloat162float(ks[row]) : 1.0f;
#pragma unroll
      for (int r = 0; r < MAXG; ++r)
        if (r < g) p_s[r][tid] = dot[r] * kscale * sm_scale;
    }
    __syncthreads();

    for (int r = warp; r < g; r += NW) {
      float mx = -INFINITY;
      for (int s = lane; s < cn; s += 32) mx = fmaxf(mx, p_s[r][s]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int s = lane; s < cn; s += 32) {
        const float p = expf(p_s[r][s] - m_new);
        sum += p;
        const float pw = QUANT ? p * __bfloat162float(vs[vec_s[s]]) : p;
        p_s[r][s] = round_bf16(pw);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAXG; ++r) {
      if (r < g) {
        const float a = alpha_s[r];
#pragma unroll
        for (int i = 0; i < VPT; ++i) acc[r][i] *= a;
      }
    }
#pragma unroll 8
    for (int s = pg; s < cn; s += FD_PG) {
      float vf[VPT];
      const uint32_t vv = vec_s[s];
      load_small<VPT, VF>(vc, kv_vec_off<VF>(vv, DH) + dg * VPT, vv & 1, vf);
#pragma unroll
      for (int r = 0; r < MAXG; ++r) {
        if (r < g) {
          const float p = p_s[r][s];
#pragma unroll
          for (int i = 0; i < VPT; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < MAXG; ++r)
    if (r < g)
#pragma unroll
      for (int i = 0; i < VPT; ++i) red[pg][r][dg * VPT + i] = acc[r][i];
  __syncthreads();
  for (int i = tid; i < g * DH; i += FD_THREADS) {
    const int r = i / DH, d = i - r * DH;
    float v = 0.0f;
#pragma unroll
    for (int p = 0; p < FD_PG; ++p) v += red[p][r][d];
    out[(qrow0 + r) * DH + d] = __float2bfloat16(v / fmaxf(l_s[r], 1e-20f));
  }
}

template <int DH, int MAXG, int KF, int VF, class Addr>
static cudaError_t launch_fd(const void* q, const void* k, const void* ks, const void* v,
                             const void* vs, const int* positions, void* out, int B, int nKV,
                             int g, Addr addr, float sm_scale, cudaStream_t stream) {
  flash_decode_kernel<DH, MAXG, KF, VF, Addr><<<B * nKV, FD_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, static_cast<const __nv_bfloat16*>(ks), v,
      static_cast<const __nv_bfloat16*>(vs), positions, static_cast<__nv_bfloat16*>(out), nKV,
      g, addr, sm_scale);
  return cudaGetLastError();
}

// The (K, V) formats served: bf16/bf16, int8/int8, int4/int4 and int8/int4
// (the "int8k_int4v" cache).
template <int DH, int MAXG, class Addr>
static cudaError_t launch_fd_fmt(const void* q, const void* k, const void* ks, const void* v,
                                 const void* vs, const int* positions, void* out, int B, int nKV,
                                 int g, Addr addr, int kfmt, int vfmt, float sm_scale,
                                 cudaStream_t st) {
  if (kfmt == KV_BF16 && vfmt == KV_BF16)
    return launch_fd<DH, MAXG, KV_BF16, KV_BF16>(q, k, ks, v, vs, positions, out, B, nKV, g,
                                                 addr, sm_scale, st);
  if (kfmt == KV_I8 && vfmt == KV_I8)
    return launch_fd<DH, MAXG, KV_I8, KV_I8>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                             sm_scale, st);
  if (kfmt == KV_I4 && vfmt == KV_I4)
    return launch_fd<DH, MAXG, KV_I4, KV_I4>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                             sm_scale, st);
  if (kfmt == KV_I8 && vfmt == KV_I4)
    return launch_fd<DH, MAXG, KV_I8, KV_I4>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                             sm_scale, st);
  return cudaErrorInvalidValue;
}

// dh in {128, 256}, g <= 8 (one query row, or up to 8 under GQA).
template <class Addr>
static int dispatch_fd(const void* q, const void* k, const void* ks, const void* v,
                       const void* vs, const int* positions, void* out, int B, int nKV, int g,
                       Addr addr, int dh, int kfmt, int vfmt, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g < 1 || g > 8) return (int)cudaErrorInvalidValue;
  if (dh == 128)
    return (int)(g == 1 ? launch_fd_fmt<128, 1>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                                kfmt, vfmt, sm_scale, st)
                        : launch_fd_fmt<128, 8>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                                kfmt, vfmt, sm_scale, st));
  if (dh == 256)
    return (int)(g == 1 ? launch_fd_fmt<256, 1>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                                kfmt, vfmt, sm_scale, st)
                        : launch_fd_fmt<256, 8>(q, k, ks, v, vs, positions, out, B, nKV, g, addr,
                                                kfmt, vfmt, sm_scale, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftcf

