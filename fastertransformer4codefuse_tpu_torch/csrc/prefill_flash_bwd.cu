// K5's backward in fp32: the C entry points of the dK/dV and dQ kernels, the
// two kernels of the library flash_attention's backward. Both recompute
// P = exp(scale * Q K^T - lse) under the causal / length mask from the
// forward's lse (prefill_flash_f32.cu) and take delta = rowsum(dO * O),
// computed outside; dS = P * (dO V^T - delta). Tiles, bound and design are
// in prefill_flash_f32.cuh.
#include "prefill_flash_f32.cuh"

namespace ftcf {
namespace f32attn {

// One score of a (key j, query i) pair, in place: s becomes the probability
// p = exp2(s * sl2 - lse2_i) where j <= min(i, len - 1) and i < S (else 0),
// and dp the score gradient ds = p * (dp - delta_i).
__device__ __forceinline__ void probs(float& s, float& dp, int key, int query, int len, int S,
                                      float sl2, float lse2, float delta) {
  const bool ok = query < S && key <= min(query, len - 1);
  const float p = ok ? exp2f(s * sl2 - lse2) : 0.f;
  s = p;
  dp = p * (dp - delta);
}

// dK/dV: one block a (key tile, KV head, row). It walks the g query heads of
// the KV head and, for each, the query tiles that can see the key tile (every
// query at or after its first key); dV += P^T dO, dK += scale * dS^T Q.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    prefill_f32_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int* __restrict__ lens, float* __restrict__ dk,
                               float* __restrict__ dv, int S, int nH, int gq, float sm_scale) {
  using TL = Tile<DH>;
  constexpr int T = TL::T, R = TL::R, C = TL::C, D = TL::D;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + T * TL::LD;
  float* sQ = sV + T * TL::LD;
  float* sO = sQ + T * TL::LD;  // dO
  float* sP = sO + T * TL::LD;
  float* sS = sP + T * TL::PLD;  // dS
  float* sL = sS + T * TL::PLD;  // lse * log2 e of the query tile
  float* sD = sL + T;            // delta of the query tile

  const int k0 = blockIdx.x * T;  // the first key tiles see the most queries: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nKV = nH / gq;
  const int len = lens[b];
  const long long qs = (long long)nH * DH, ks = (long long)nKV * DH;
  const int lane = threadIdx.x % 16, ra = threadIdx.x / 16 * R;  // ra: this thread's keys
  const float sl2 = sm_scale * LOG2E;

  float ak[R][D], av[R][D];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < D; ++e) ak[a][e] = av[a][e] = 0.f;

  if (k0 < len) {  // keys at or past the length are seen by no query
    load_rows<DH>(sK, k + ((long long)b * S * nKV + kvh) * DH, ks, k0, S);
    load_rows<DH>(sV, v + ((long long)b * S * nKV + kvh) * DH, ks, k0, S);
    for (int h = kvh * gq; h < (kvh + 1) * gq; ++h) {
      const float* qb = q + ((long long)b * S * nH + h) * DH;
      const float* ob = dout + ((long long)b * S * nH + h) * DH;
      const float* lb = lse + ((long long)b * nH + h) * S;
      const float* db = delta + ((long long)b * nH + h) * S;
      for (int q0 = k0; q0 < S; q0 += T) {
        __syncthreads();  // the previous tile's reads are done
        load_rows<DH>(sQ, qb, qs, q0, S);
        load_rows<DH>(sO, ob, qs, q0, S);
        for (int r = threadIdx.x; r < T; r += THREADS) {
          sL[r] = q0 + r < S ? lb[q0 + r] * LOG2E : 0.f;
          sD[r] = q0 + r < S ? db[q0 + r] : 0.f;
        }
        __syncthreads();
        float s[R][C], dp[R][C];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < C; ++c) s[a][c] = dp[a][c] = 0.f;
        dot_rows<DH>(s, sK, ra, sQ, lane);   // s[key][query]
        dot_rows<DH>(dp, sV, ra, sO, lane);  // dp[key][query]
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int iq = lane + 16 * c;
            probs(s[a][c], dp[a][c], k0 + ra + a, q0 + iq, len, S, sl2, sL[iq], sD[iq]);
            sP[(ra + a) * TL::PLD + iq] = s[a][c];
            sS[(ra + a) * TL::PLD + iq] = dp[a][c];
          }
        __syncthreads();
        scores_times_rows<DH>(av, sP, ra, sO, lane);
        scores_times_rows<DH>(ak, sS, ra, sQ, lane);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = k0 + ra + a;
    if (j >= S) continue;
    const long long off = (((long long)b * S + j) * nKV + kvh) * DH;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      dk[off + lane + 16 * e] = ak[a][e] * sm_scale;
      dv[off + lane + 16 * e] = av[a][e];
    }
  }
}

// dQ: one block a (query tile, head, row), walking the key tiles 0 .. the
// tile's last visible key; dQ += scale * dS K.
template <int DH>
__global__ void __launch_bounds__(THREADS)
    prefill_f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const int* __restrict__ lens, float* __restrict__ dq, int S, int nH,
                              int gq, float sm_scale) {
  using TL = Tile<DH>;
  constexpr int T = TL::T, R = TL::R, C = TL::C, D = TL::D;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + T * TL::LD;  // dO
  float* sK = sO + T * TL::LD;
  float* sV = sK + T * TL::LD;
  float* sS = sV + T * TL::LD;  // dS

  const int n_tiles = (S + T - 1) / T;
  const int q0 = (n_tiles - 1 - blockIdx.x) * T;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nKV = nH / gq;
  const int len = lens[b];
  const long long qs = (long long)nH * DH, ks = (long long)nKV * DH;
  const float* kb = k + ((long long)b * S * nKV + h / gq) * DH;
  const float* vb = v + ((long long)b * S * nKV + h / gq) * DH;
  const int lane = threadIdx.x % 16, ra = threadIdx.x / 16 * R;  // ra: this thread's queries
  const float sl2 = sm_scale * LOG2E;

  load_rows<DH>(sQ, q + ((long long)b * S * nH + h) * DH, qs, q0, S);
  load_rows<DH>(sO, dout + ((long long)b * S * nH + h) * DH, qs, q0, S);
  float l2[R], dl[R], acc[R][D];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ra + a;
    l2[a] = i < S ? lse[((long long)b * nH + h) * S + i] * LOG2E : 0.f;
    dl[a] = i < S ? delta[((long long)b * nH + h) * S + i] : 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[a][e] = 0.f;
  }
  const int last = min(q0 + T - 1, len - 1);
  for (int k0 = 0; k0 <= last; k0 += T) {
    __syncthreads();
    load_rows<DH>(sK, kb, ks, k0, S);
    load_rows<DH>(sV, vb, ks, k0, S);
    __syncthreads();
    float s[R][C], dp[R][C];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) s[a][c] = dp[a][c] = 0.f;
    dot_rows<DH>(s, sQ, ra, sK, lane);   // s[query][key]
    dot_rows<DH>(dp, sO, ra, sV, lane);  // dp[query][key]
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        probs(s[a][c], dp[a][c], k0 + lane + 16 * c, q0 + ra + a, len, S, sl2, l2[a], dl[a]);
        sS[(ra + a) * TL::PLD + lane + 16 * c] = dp[a][c];
      }
    __syncthreads();
    scores_times_rows<DH>(acc, sS, ra, sK, lane);
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ra + a;
    if (i >= S) continue;
    float* out = dq + (((long long)b * S + i) * nH + h) * DH;
#pragma unroll
    for (int e = 0; e < D; ++e) out[lane + 16 * e] = acc[a][e] * sm_scale;
  }
}

template <int DH>
static cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                              const float* lse, const float* delta, const int* lens, float* dk,
                              float* dv, int B, int S, int nKV, int gq, float sm_scale,
                              cudaStream_t st) {
  using TL = Tile<DH>;
  const size_t smem = 4 * TL::ROWS + 2 * TL::SCORES + 2 * TL::T * sizeof(float);
  auto kern = prefill_f32_bwd_dkv_kernel<DH>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + TL::T - 1) / TL::T, nKV, B);
  kern<<<grid, THREADS, smem, st>>>(q, k, v, dout, lse, delta, lens, dk, dv, S, nKV * gq, gq,
                                    sm_scale);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                             const float* lse, const float* delta, const int* lens, float* dq,
                             int B, int S, int nKV, int gq, float sm_scale, cudaStream_t st) {
  using TL = Tile<DH>;
  const size_t smem = 4 * TL::ROWS + TL::SCORES;
  auto kern = prefill_f32_bwd_dq_kernel<DH>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + TL::T - 1) / TL::T, nKV * gq, B);
  kern<<<grid, THREADS, smem, st>>>(q, k, v, dout, lse, delta, lens, dq, S, nKV * gq, gq,
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
