// The prefill-width GEMM (ftcf_gemm.cuh) at its 128 x 128 block tile (rows of x
// x output channels), over every weight format: one of the four tiles the
// tile cache chooses from (ftcf_gemm_plan.cuh), each built in a source of its
// own so that the four compile side by side.
#include "ftcf_gemm.cuh"

namespace ftcf {

FTCF_GEMM_TILE_DECL(128, 128) {
  return gemm_tile<128, 128>(fmt, s1, s2, G, out_f32, M, K, group_m, stages, stream);
}

}  // namespace ftcf
