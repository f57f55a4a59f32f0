// Host side of the port's TMA loads: tensor maps encoded by
// cuTensorMapEncodeTiled, one encoder for K5 (prefill_flash.cu), K10
// (flash_chunk.cu) and the prefill-width GEMM (ftcf_gemm.cuh). The encoder
// is resolved through the runtime's cudaGetDriverEntryPoint, since the
// kernel library is not linked against the driver library (-lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftcf {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;  // benign race: every setter writes the same value
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a rank-R tensor at ``p``: ``dims`` innermost first (in
// elements), ``strides`` the byte strides of dims 1 .. R-1, ``box`` the
// extent of one load per dim. Coordinates past the extents read as zeros.
// Swizzle 128B for operands that wgmma reads as they land (the box's inner
// extent then 128 bytes), none for payloads that threads convert first.
template <int R>
static bool tensor_map(CUtensorMap* m, CUtensorMapDataType type, const void* p,
                       const uint64_t (&dims)[R], const uint64_t (&strides)[R - 1],
                       const uint32_t (&box)[R], CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t d[R], s[R > 1 ? R - 1 : 1];
  cuuint32_t b[R], e[R];
  for (int i = 0; i < R; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < R) s[i] = strides[i];
  }
  return enc(m, type, R, const_cast<void*>(p), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ftcf
