// K12: the C entry point of banded sliding-window attention (Longformer's
// local attention): K5's TMA + wgmma body (prefill_flash.cuh) under the Band
// policy, which replaces the mma.sync tile loop K12 had of its own.
//
// q, k, v, out [B, S, nH, dh] bf16, q already scaled by 1/sqrt(dh). Query i
// of row b sees key j iff |i - j| <= w (causal: i - w <= j <= i) and
// j < lens[b]; rows i >= lens[b] (the padding of a right-padded batch) are
// written as 0. Replaces fastertransformer4codefuse_tpu/ops/sliding_window.py
// sliding_window_attention (its Pallas body _kernel), whose grid visits only
// the KV chunks that meet each query chunk's band. Scores, softmax and the
// rounding of p are K5's, so the plain version rounds the probabilities
// alike.
//
// Bound: at Longformer-base (12 heads x 64, w = 256) a 128-query tile reads
// 2w + 128 = 640 keys: ~21 MFLOP against ~180 KB of Q, K and V a (tile,
// head), ~115 FLOP a byte, below the card's ~295 balance. Each K/V byte is
// read by ceil((2w + 128) / 128) = 5 overlapping query tiles, which L2
// serves, so the floor is the bytes: q, k and v of the unpadded rows and
// the whole out, once each (the kernel's boxes read at most a tile of
// padding past a length). The body walks a
// query tile's band in 128-key tiles from its first key (5 tiles at w =
// 256; the mask only in the tiles where some row's band edge falls), one
// persistent block an SM taking query tiles in turn, so a tile's fixed cost
// (Q, the ring's fill, the epilogue) overlaps the previous one's products;
// a query tile of padding is only written as zeros.
#include "prefill_flash.cuh"

extern "C" {

// K12. q/k/v/out [B, S, nH, dh] bf16 (q already scaled; k and v 16-byte
// aligned); lens [B] int32 valid lengths (right padding); w >= 0 the half
// window; causal 0 or 1. dh is 64 or 128.
int ftcf_sliding_window(const void* q, const void* k, const void* v, const int* lens, void* out,
                        int B, int S, int nH, int dh, int w, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || nH < 1 || w < 0) return (int)cudaErrorInvalidValue;
  const ftcf::Band pol{w > S ? S : w, causal != 0};  // a wider window sees the same keys
  if (dh == 64)
    return (int)ftcf::launch_prefill<64>(q, k, v, lens, out, B, S, nH, 1, 1.0f, pol, st);
  if (dh == 128)
    return (int)ftcf::launch_prefill<128>(q, k, v, lens, out, B, S, nH, 1, 1.0f, pol, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
