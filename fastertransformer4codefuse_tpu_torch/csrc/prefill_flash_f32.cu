// K5 in fp32: the C entry point of causal prefill attention over the prompt's
// own K/V that also writes each row's log-sum-exp, for the backward in
// prefill_flash_bwd.cu. Tiles, bound and design are in prefill_flash_f32.cuh.
#include "prefill_flash_f32.cuh"

namespace ftcf {
namespace f32attn {

// One block a (query tile, head, row): online softmax over the key tiles
// 0 .. the tile's last visible key; out = O / l, lse = m + log l (natural
// log of the scaled scores).
template <int DH>
__global__ void __launch_bounds__(THREADS)
    prefill_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ lens,
                           float* __restrict__ out, float* __restrict__ lse, int S, int nH, int gq,
                           float sm_scale) {
  using TL = Tile<DH>;
  constexpr int T = TL::T, R = TL::R, C = TL::C, D = TL::D;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + T * TL::LD;
  float* sV = sK + T * TL::LD;
  float* sP = sV + T * TL::LD;

  const int n_tiles = (S + T - 1) / T;
  const int q0 = (n_tiles - 1 - blockIdx.x) * T;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nKV = nH / gq;
  const int len = lens[b];
  const long long qs = (long long)nH * DH, ks = (long long)nKV * DH;
  const float* qb = q + ((long long)b * S * nH + h) * DH;
  const float* kb = k + ((long long)b * S * nKV + h / gq) * DH;
  const float* vb = v + ((long long)b * S * nKV + h / gq) * DH;
  const int lane = threadIdx.x % 16, ra = threadIdx.x / 16 * R;
  const float sl2 = sm_scale * LOG2E;

  load_rows<DH>(sQ, qb, qs, q0, S);
  float m[R], l[R], o[R][D];
  int hi[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    hi[a] = min(q0 + ra + a, len - 1);
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) o[a][e] = 0.f;
  }
  const int last = min(q0 + T - 1, len - 1);  // the tile's last visible key
  for (int k0 = 0; k0 <= last; k0 += T) {
    __syncthreads();  // the previous tile's reads of sK, sV and sP are done
    load_rows<DH>(sK, kb, ks, k0, S);
    load_rows<DH>(sV, vb, ks, k0, S);
    __syncthreads();
    float s[R][C];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) s[a][c] = 0.f;
    dot_rows<DH>(s, sQ, ra, sK, lane);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float mx = m[a];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[a][c] = k0 + lane + 16 * c <= hi[a] ? s[a][c] * sl2 : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      // finite: the first tile holds key 0, which every row sees
      mx = half_warp_max(mx);
      const float alpha = exp2f(m[a] - mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = exp2f(s[a][c] - mx);
        sP[(ra + a) * TL::PLD + lane + 16 * c] = p;
        rs += p;
      }
      l[a] = l[a] * alpha + half_warp_sum(rs);
      m[a] = mx;
#pragma unroll
      for (int e = 0; e < D; ++e) o[a][e] *= alpha;
    }
    __syncthreads();
    scores_times_rows<DH>(o, sP, ra, sV, lane);
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ra + a;
    if (i >= S) continue;
    float* ob = out + (((long long)b * S + i) * nH + h) * DH;
    const float inv = 1.f / l[a];
#pragma unroll
    for (int e = 0; e < D; ++e) ob[lane + 16 * e] = o[a][e] * inv;
    if (lane == 0) lse[((long long)b * nH + h) * S + i] = (m[a] + log2f(l[a])) / LOG2E;
  }
}

template <int DH>
static cudaError_t launch_fwd(const float* q, const float* k, const float* v, const int* lens,
                              float* out, float* lse, int B, int S, int nKV, int gq,
                              float sm_scale, cudaStream_t st) {
  using TL = Tile<DH>;
  const size_t smem = 3 * TL::ROWS + TL::SCORES;
  auto kern = prefill_f32_fwd_kernel<DH>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + TL::T - 1) / TL::T, nKV * gq, B);
  kern<<<grid, THREADS, smem, st>>>(q, k, v, lens, out, lse, S, nKV * gq, gq, sm_scale);
  return cudaGetLastError();
}

}  // namespace f32attn
}  // namespace ftcf

extern "C" {

// K5 fp32. q [B, S, nKV * gq, dh], k/v [B, S, nKV, dh] fp32 (16-byte
// aligned); lens [B] int32 prompt lengths (>= 1); out like q; lse [B, nKV *
// gq, S] fp32. Query i of row b attends keys 0 .. min(i, lens[b] - 1). dh is
// 64, 128 or 256.
int ftcf_prefill_flash_f32(const float* q, const float* k, const float* v, const int* lens,
                           float* out, float* lse, int B, int S, int nKV, int gq, int dh,
                           float sm_scale, void* stream) {
  using namespace ftcf::f32attn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gq < 1 || S < 1 || B < 1 || nKV < 1) return (int)cudaErrorInvalidValue;
  if (dh == 64) return (int)launch_fwd<64>(q, k, v, lens, out, lse, B, S, nKV, gq, sm_scale, st);
  if (dh == 128)
    return (int)launch_fwd<128>(q, k, v, lens, out, lse, B, S, nKV, gq, sm_scale, st);
  if (dh == 256)
    return (int)launch_fwd<256>(q, k, v, lens, out, lse, B, S, nKV, gq, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
