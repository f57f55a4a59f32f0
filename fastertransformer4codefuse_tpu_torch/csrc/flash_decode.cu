// K4: the C entry point of the decode attention kernel over the dense KV
// cache. The kernel body, its design and what it replaces are in
// flash_decode.cuh.
#include "flash_decode.cuh"

extern "C" {

// K4. q [B, nKV * g, dh] bf16; k/v the layer's [B, nKV, S, dh] slabs in the
// formats kfmt / vfmt (KVFmt): bf16; int8; or packed int4 [B, nKV, S/2, dh]
// (S even). Quantized formats carry ks/vs [B, nKV, S] bf16 scales (unused for
// bf16). positions [B] int32; out [B, nKV * g, dh] bf16; ws an fp32 workspace
// of ws_floats (ops/flash_decode.py decode_workspace sizes it); split the
// positions a split takes (ops/flash_decode.py decode_split). Any g >= 1.
int ftcf_flash_decode(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                      const int* positions, void* out, void* ws, long long ws_floats, int split,
                      int B, int nKV, int g, int S, int dh, int kfmt, int vfmt, float sm_scale,
                      void* stream) {
  return ftcf::dispatch_fd(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV, g,
                           ftcf::DenseAddr{S}, S, split, dh, kfmt, vfmt, sm_scale, stream);
}

}  // extern "C"
