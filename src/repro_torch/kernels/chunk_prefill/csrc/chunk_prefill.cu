// Banded chunk-prefill attention over a dense KV cache view, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel chunk_prefill_attention_kernel
// (src/repro/kernels/chunk_prefill/chunk_prefill.py, body
// _chunk_prefill_body). S queries at absolute positions
// index[b] .. index[b]+S-1 attend to the cache view [B,L,K,h] under the
// causal mask kpos <= qpos (and qpos - kpos < window when a window is set);
// query head n reads KV head n / G.
//
// What bounds it on the H100: at the control step's shape (bf16 q and
// view, S = L = 640, h = 128, B = 4, N = 28) the causal work is
// 4*h*(S*(S+1)/2)*B*N = 11.8 GFLOP against 42 MB moved (q and out, the
// view once), ~280 operations per byte: at the card's bf16 ridge (~295),
// so bytes and operations bound it about equally (12 us), and only the
// tensor cores reach that rate. Both bodies are tensor-core bodies on
// 64-row query tiles held as mma.sync fragments and 64-key blocks of K
// and V through a 2-stage cp.async ring, the online softmax on the score
// fragments:
// - bf16 q over a bf16 view (chunk_mma.cuh): bf16 products, P V from P
//   rounded to bf16 in registers.
// - every other pairing (chunk_tf32.cuh): an f32 view (the serving
//   engine's caches, with an f32 or bf16 q), or a bf16 view with an f32
//   q. 3xTF32 products, as exact as f32: at the engines' admission prefill
//   (B = 1, S = 640) the causal work is 2.94 GFLOP, 0.044 ms on the f32
//   CUDA cores, 0.018 ms as three TF32 products a product at the tensor
//   cores' dense TF32 peak.
//
// Both bodies walk key blocks of 64 on the absolute partition from
// position 0, so a row's result does not depend on the chunking: the
// chunking-invariance contract of the TPU kernel holds bit for bit within
// each body.
#include "chunk_mma.cuh"
#include "chunk_tf32.cuh"

namespace {

constexpr int PREFILL_BAND = 32;   // the wrapper's bk: two halves a block

template <typename TKV>
struct DenseSrc {
  const TKV* kb;               // slot b, KV head kh, position 0
  const TKV* vb;
  size_t row_stride;
  __device__ const TKV* k(int t0) const { return kb + t0 * row_stride; }
  __device__ const TKV* v(int t0) const { return vb + t0 * row_stride; }
  __device__ float k_scale(int, int) const { return 1.f; }
  __device__ float v_scale(int, int) const { return 1.f; }
};

// every pairing but bf16 over bf16: the 3xTF32 body, tiles heaviest first
template <int H, typename TKV, typename T>
__global__ void __launch_bounds__(chunk_tf32::NT, 1) chunk_tf32_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ index,
    T* __restrict__ out, int S, int L, int N, int K, long long kv_bstride,
    int window) {
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t off = b * kv_bstride + (size_t)(n / (N / K)) * H;
  const DenseSrc<TKV> src{k + off, v + off, (size_t)K * H};
  chunk_tf32::chunk_rows<H, TKV, chunk_tf32::SCALE_NONE>(
      q, out, S, L, N, chunk_tf32::tile_row(), n, b, index[b], window,
      (size_t)K * H, src);
}

// bf16 q over a bf16 view: the tensor-core body, tiles heaviest first
template <int H>
__global__ void __launch_bounds__(chunk_mma::NT, 2) chunk_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ index,
    __nv_bfloat16* __restrict__ out, int S, int L, int N, int K,
    long long kv_bstride, int window) {
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t off = b * kv_bstride + (size_t)(n / (N / K)) * H;
  const DenseSrc<__nv_bfloat16> src{k + off, v + off, (size_t)K * H};
  chunk_mma::chunk_rows<H>(q, out, S, L, N, chunk_mma::tile_row(), n, b,
                           index[b], window, (size_t)K * H, src);
}

template <int H>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* index, void* out, int B, int S, int L,
                       int N, int K, long long kv_bstride, int window,
                       cudaStream_t stream) {
  using T = __nv_bfloat16;
  const auto kernel = chunk_mma_kernel<H>;
  constexpr size_t bytes = chunk_mma::Layout<H>::BYTES;
  static const cudaError_t setup = decode_tile::allow_smem(kernel, bytes);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(N, B, (S + chunk_mma::BQ - 1) / chunk_mma::BQ);
  kernel<<<grid, chunk_mma::NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(index),
      static_cast<T*>(out), S, L, N, K, kv_bstride, window);
  return cudaGetLastError();
}

cudaError_t launch_mma_h(int h, const void* q, const void* k, const void* v,
                         const void* index, void* out, int B, int S, int L,
                         int N, int K, long long kv_bstride, int window,
                         cudaStream_t stream) {
  switch (h) {
    case 16:
      return launch_mma<16>(q, k, v, index, out, B, S, L, N, K, kv_bstride,
                            window, stream);
    case 64:
      return launch_mma<64>(q, k, v, index, out, B, S, L, N, K, kv_bstride,
                            window, stream);
    case 128:
      return launch_mma<128>(q, k, v, index, out, B, S, L, N, K, kv_bstride,
                             window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int H, typename TKV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* index, void* out, int B, int S, int L, int N,
                   int K, long long kv_bstride, int window,
                   cudaStream_t stream) {
  const auto kernel = chunk_tf32_kernel<H, TKV, T>;
  constexpr size_t bytes = chunk_tf32::Layout<H, TKV>::BYTES;
  static const cudaError_t setup = decode_tile::allow_smem(kernel, bytes);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(N, B, (S + chunk_tf32::BQ - 1) / chunk_tf32::BQ);
  kernel<<<grid, chunk_tf32::NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(index),
      static_cast<T*>(out), S, L, N, K, kv_bstride, window);
  return cudaGetLastError();
}

template <typename TKV, typename T>
cudaError_t launch_h(int h, const void* q, const void* k, const void* v,
                     const void* index, void* out, int B, int S, int L, int N,
                     int K, long long kv_bstride, int window,
                     cudaStream_t stream) {
  switch (h) {
    case 16:
      return launch<16, TKV, T>(q, k, v, index, out, B, S, L, N, K,
                                kv_bstride, window, stream);
    case 64:
      return launch<64, TKV, T>(q, k, v, index, out, B, S, L, N, K,
                                kv_bstride, window, stream);
    case 128:
      return launch<128, TKV, T>(q, k, v, index, out, B, S, L, N, K,
                                 kv_bstride, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TKV>
cudaError_t launch_q(int q_bf16, int h, const void* q, const void* k,
                     const void* v, const void* index, void* out, int B,
                     int S, int L, int N, int K, long long kv_bstride,
                     int window, cudaStream_t stream) {
  if (q_bf16)
    return launch_h<TKV, __nv_bfloat16>(h, q, k, v, index, out, B, S, L, N,
                                        K, kv_bstride, window, stream);
  return launch_h<TKV, float>(h, q, k, v, index, out, B, S, L, N, K,
                              kv_bstride, window, stream);
}

}  // namespace

// q [B,S,N,h] (f32, or bf16 when q_bf16); k/v view [B,L,K,h] (f32 when
// kv_dtype is 0, bf16 when 1) whose rows are contiguous and whose slots are
// kv_bstride elements apart; index [B] int32 chunk start positions on the
// device; bk must be 32; out [B,S,N,h] in q's type. Returns the launch's
// cudaError_t.
extern "C" int chunk_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* index,
                                    void* out, int q_bf16, int kv_dtype,
                                    int B, int S, int L, int N, int K, int h,
                                    int bk, long long kv_bstride, int window,
                                    void* stream) {
  if (B <= 0 || S <= 0 || L <= 0 || K <= 0 || N % K != 0 ||
      bk != PREFILL_BAND || N > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch_q<float>(q_bf16, h, q, k, v, index, out, B, S, L, N,
                                  K, kv_bstride, window, st);
    case 1:
      if (q_bf16)
        return (int)launch_mma_h(h, q, k, v, index, out, B, S, L, N, K,
                                 kv_bstride, window, st);
      return (int)launch_h<__nv_bfloat16, float>(h, q, k, v, index, out, B,
                                                 S, L, N, K, kv_bstride,
                                                 window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
