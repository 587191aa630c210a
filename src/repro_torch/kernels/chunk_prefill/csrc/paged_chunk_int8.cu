// The int8 instantiations of the paged chunk-prefill kernel
// (paged_chunk_kernel.cuh), a source of their own so that nvcc builds them
// beside the others.
#include "paged_chunk_kernel.cuh"

namespace paged_chunk {

cudaError_t launch_int8(int scale_mode, int q_bf16, int h, const Args& a) {
  return by_scale<int8_t>(scale_mode, q_bf16, h, a);
}

}  // namespace paged_chunk
