// The paged chunk-prefill kernel as a template, and its dispatch over head
// dim, scale mode and q type, shared by the sources that instantiate it:
// one source per page storage type, so that nvcc builds them in parallel
// (paged_chunk_prefill.cu: f32 and bf16 pages and the C entry;
// paged_chunk_int8.cu; paged_chunk_fp8.cu). The body is chunk_tf32.cuh's
// (3xTF32 on the tensor cores), with a page as half of its 64-key block;
// bf16 q over bf16 pages takes chunk_mma.cuh's instead
// (paged_chunk_prefill.cu).
#pragma once

#include "chunk_tf32.cuh"

namespace paged_chunk {

using chunk_tf32::SCALE_HEAD;
using chunk_tf32::SCALE_NONE;
using chunk_tf32::SCALE_TOKEN;

constexpr int PAGE = chunk_tf32::HALF;   // rows a page: half a key block

template <typename TKV, int SC>
struct PagedSrc {
  const TKV* kp;               // KV head kh of page 0, row 0
  const TKV* vp;
  const int* pt;               // this slot's page-table row
  size_t page_stride;          // elements per page: PAGE * K * H
  const float* ks;             // scales (SC != SCALE_NONE)
  const float* vs;
  int K, kh;
  __device__ int page(int t0) const { return pt[t0 / PAGE]; }
  __device__ const TKV* k(int t0) const {
    return kp + (size_t)page(t0) * page_stride;
  }
  __device__ const TKV* v(int t0) const {
    return vp + (size_t)page(t0) * page_stride;
  }
  __device__ size_t scale_at(int t0, int r) const {
    return SC == SCALE_HEAD ? (size_t)page(t0) * K + kh
                            : ((size_t)page(t0) * PAGE + r) * K + kh;
  }
  __device__ float k_scale(int t0, int r) const { return ks[scale_at(t0, r)]; }
  __device__ float v_scale(int t0, int r) const { return vs[scale_at(t0, r)]; }
};

template <int H, typename TKV, int SC, typename T>
__global__ void __launch_bounds__(chunk_tf32::NT, 1) paged_chunk_kernel(
    const T* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ index, T* __restrict__ out, int S, int N, int K,
    int npg, int window) {
  const int n = blockIdx.x, b = blockIdx.y;
  const int kh = n / (N / K);
  const PagedSrc<TKV, SC> src{kp + (size_t)kh * H, vp + (size_t)kh * H,
                              page_table + (size_t)b * npg,
                              (size_t)PAGE * K * H, ks, vs, K, kh};
  chunk_tf32::chunk_rows<H, TKV, SC>(q, out, S, npg * PAGE, N,
                                     chunk_tf32::tile_row(), n, b, index[b],
                                     window, (size_t)K * H, src);
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *pt, *index;
  void* out;
  int B, S, N, K, npg, window;
  cudaStream_t stream;
};

template <int H, typename TKV, int SC, typename T>
cudaError_t go(const Args& a) {
  const auto kernel = paged_chunk_kernel<H, TKV, SC, T>;
  constexpr size_t bytes = chunk_tf32::Layout<H, TKV>::BYTES;
  static const cudaError_t setup = decode_tile::allow_smem(kernel, bytes);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(a.N, a.B, (a.S + chunk_tf32::BQ - 1) / chunk_tf32::BQ);
  kernel<<<grid, chunk_tf32::NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.index), static_cast<T*>(a.out), a.S, a.N,
      a.K, a.npg, a.window);
  return cudaGetLastError();
}

template <typename TKV, int SC, typename T>
cudaError_t by_h(int h, const Args& a) {
  switch (h) {
    case 16: return go<16, TKV, SC, T>(a);
    case 64: return go<64, TKV, SC, T>(a);
    case 128: return go<128, TKV, SC, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TKV, int SC>
cudaError_t by_q(int q_bf16, int h, const Args& a) {
  return q_bf16 ? by_h<TKV, SC, __nv_bfloat16>(h, a)
                : by_h<TKV, SC, float>(h, a);
}

template <typename TKV>
cudaError_t by_scale(int scale_mode, int q_bf16, int h, const Args& a) {
  switch (scale_mode) {
    case SCALE_HEAD: return by_q<TKV, SCALE_HEAD>(q_bf16, h, a);
    case SCALE_TOKEN: return by_q<TKV, SCALE_TOKEN>(q_bf16, h, a);
    default: return cudaErrorInvalidValue;
  }
}

// defined in paged_chunk_int8.cu and paged_chunk_fp8.cu
cudaError_t launch_int8(int scale_mode, int q_bf16, int h, const Args& a);
cudaError_t launch_fp8(int scale_mode, int q_bf16, int h, const Args& a);

}  // namespace paged_chunk
