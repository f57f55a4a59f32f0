// K9: the C entry point of the decode attention kernel over the paged pool
// through a block table (PagedAddr). Replaces
// fastertransformer4codefuse_tpu/ops/flash_decode.py flash_decode_paged;
// design and bound in flash_decode.cuh.
#include "flash_decode.cuh"

extern "C" {

// K9. As K4, with k/v the layer's [P, nKV, ps, dh] page slabs ([P, nKV, ps/2,
// dh] packed, ps even; ks/vs [P, nKV, ps]) and pt [B, n_pg] int32 the block
// table: logical position s of row b is page pt[b, s / ps], offset s % ps.
int ftcf_flash_decode_paged(const void* q, const void* k, const void* ks, const void* v,
                            const void* vs, const int* positions, const int* pt, void* out,
                            void* ws, long long ws_floats, int split, int B, int nKV, int g,
                            int n_pg, int ps, int dh, int kfmt, int vfmt, float sm_scale,
                            void* stream) {
  return ftcf::dispatch_fd(q, k, ks, v, vs, positions, out, ws, ws_floats, B, nKV, g,
                           ftcf::PagedAddr{pt, n_pg, ps}, n_pg * ps, split, dh, kfmt, vfmt,
                           sm_scale, stream);
}

}  // extern "C"
