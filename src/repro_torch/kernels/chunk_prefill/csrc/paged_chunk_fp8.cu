// The fp8 e4m3 instantiations of the paged chunk-prefill kernel
// (paged_chunk_kernel.cuh), a source of their own so that nvcc builds them
// beside the others.
#include "paged_chunk_kernel.cuh"

namespace paged_chunk {

cudaError_t launch_fp8(int scale_mode, int q_bf16, int h, const Args& a) {
  return by_scale<__nv_fp8_e4m3>(scale_mode, q_bf16, h, a);
}

}  // namespace paged_chunk
