// K11: the C entry point of beam decode attention, the decode kernel of
// flash_decode.cuh addressed through the beam search's cache indirection
// (BeamAddr). Replaces fastertransformer4codefuse_tpu/ops/flash_decode.py
// flash_decode_beam_stacked; design and bound in flash_decode.cuh.
#include "flash_decode.cuh"

extern "C" {

// K11. As K4 over BB = B * bw beam-minor rows, with indir [BB, S] int32 the
// cache indirection: position s of row b reads row b - b % bw + indir[b, s].
int ftcf_flash_decode_beam(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const int* positions, const int* indir, void* out,
                           void* ws, long long ws_floats, int split, int BB, int nKV, int g,
                           int S, int bw, int dh, int kfmt, int vfmt, float sm_scale,
                           void* stream) {
  if (bw < 1 || BB % bw != 0) return (int)cudaErrorInvalidValue;
  return ftcf::dispatch_fd(q, k, ks, v, vs, positions, out, ws, ws_floats, BB, nKV, g,
                           ftcf::BeamAddr{indir, S, bw}, S, split, dh, kfmt, vfmt, sm_scale, stream);
}

}  // extern "C"
