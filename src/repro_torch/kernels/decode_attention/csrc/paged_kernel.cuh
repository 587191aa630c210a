// The paged decode kernel as a template, and its dispatch over head dim,
// group bound and q type, shared by the sources that instantiate it: one
// source per page storage type, so that nvcc builds them in parallel
// (paged_decode_attention.cu: f32 and bf16 pages and the C entry;
// paged_decode_int8.cu; paged_decode_fp8.cu).
#pragma once

#include "decode_tile.cuh"

namespace paged_decode {

using namespace decode_tile;

template <typename TKV, int SC>
struct PagedSrc {
  const TKV* kp;               // KV head kh of page 0, row 0
  const TKV* vp;
  const int* pt;               // this slot's page-table row
  size_t page_stride;          // elements per page: TK * K * H
  const float* ks;             // scales (SC != SCALE_NONE)
  const float* vs;
  int K, kh;
  __device__ int page(int t0) const { return pt[t0 / TK]; }
  __device__ const TKV* k(int t0) const {
    return kp + (size_t)page(t0) * page_stride;
  }
  __device__ const TKV* v(int t0) const {
    return vp + (size_t)page(t0) * page_stride;
  }
  __device__ size_t scale_at(int t0, int r) const {
    return SC == SCALE_HEAD ? (size_t)page(t0) * K + kh
                            : ((size_t)page(t0) * TK + r) * K + kh;
  }
  __device__ const float* k_scale(int t0, int r) const {
    return ks + scale_at(t0, r);
  }
  __device__ const float* v_scale(int t0, int r) const {
    return vs + scale_at(t0, r);
  }
};

template <int H, typename TKV, int SC, int GB, typename T>
__global__ void __launch_bounds__(DNT, 2) paged_kernel(
    const T* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ index, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int K, int len, int window) {
  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int2 fl = live_keys(index[b], len, window);
  const int npg = len / TK;
  const PagedSrc<TKV, SC> src{kp + (size_t)kh * H, vp + (size_t)kh * H,
                              page_table + (size_t)b * npg,
                              (size_t)TK * K * H, ks, vs, K, kh};
  decode_split<H, TKV, SC, GB, T>(q, part_acc, part_ml, b, kh, j, gridDim.x,
                                  N, K, fl.x, fl.y, src);
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *pt, *index;
  float* part;
  void* out;
  int B, N, K, npg, NS, window;
  cudaStream_t stream;
};

template <int H, typename TKV, int SC, int GB, typename T>
cudaError_t launch(const Args& a) {
  const auto kernel = paged_kernel<H, TKV, SC, GB, T>;
  static const cudaError_t setup =
      allow_smem(kernel, SplitLayout<H, TKV>::bytes(GB));
  if (setup != cudaSuccess) return setup;
  const int* index = static_cast<const int*>(a.index);
  return split_then_combine<H, T>(
      kernel, SplitLayout<H, TKV>::bytes(a.N / a.K), a.part, index, a.out,
      a.B, a.N, a.K, a.NS, a.npg * TK, a.window, a.stream,
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pt), index);
}

template <int H, typename TKV, int SC, typename T>
cudaError_t by_group(const Args& a) {
  return a.N / a.K <= GSMALL ? launch<H, TKV, SC, GSMALL, T>(a)
                             : launch<H, TKV, SC, GMAX, T>(a);
}

template <typename TKV, int SC, typename T>
cudaError_t by_h(int h, const Args& a) {
  switch (h) {
    case 16: return by_group<16, TKV, SC, T>(a);
    case 64: return by_group<64, TKV, SC, T>(a);
    case 128: return by_group<128, TKV, SC, T>(a);
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

// defined in paged_decode_int8.cu and paged_decode_fp8.cu
cudaError_t launch_int8(int scale_mode, int q_bf16, int h, const Args& a);
cudaError_t launch_fp8(int scale_mode, int q_bf16, int h, const Args& a);

}  // namespace paged_decode
