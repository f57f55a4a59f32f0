// K5: the C entry point of causal prefill attention over the prompt's own
// K/V (the CausalPrefix policy). The kernel body, its design and what it
// replaces are in prefill_flash.cuh.
#include "prefill_flash.cuh"

extern "C" {

// K5. Causal prefill attention: q [B, S, nKV * gq, dh], k/v [B, S, nKV, dh]
// bf16 (k and v 16-byte aligned); lens [B] int32 prompt lengths; out like q.
// Query i of row b attends keys 0 .. min(i, lens[b] - 1). dh is 64, 128 or 256.
int ftcf_prefill_flash(const void* q, const void* k, const void* v, const int* lens, void* out,
                       int B, int S, int nKV, int gq, int dh, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ftcf::CausalPrefix pol{};
  if (gq < 1 || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)ftcf::launch_prefill<64>(q, k, v, lens, out, B, S, nKV, gq, sm_scale, pol, st);
  if (dh == 128)
    return (int)ftcf::launch_prefill<128>(q, k, v, lens, out, B, S, nKV, gq, sm_scale, pol, st);
  if (dh == 256)
    return (int)ftcf::launch_prefill<256>(q, k, v, lens, out, B, S, nKV, gq, sm_scale, pol, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
