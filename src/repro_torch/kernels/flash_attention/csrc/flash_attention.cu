// Causal / sliding-window GQA flash attention over fresh rows, for Hopper
// (sm_90a): the training forward and whole-buffer prefill.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/flash_attention.py, body _kernel).
// q [B,S,N,h] attends to k, v [B,Sk,K,h]; query head n reads KV head
// n / (N/K). Row s sits at position s and key t at position t; with
// `causal` a row sees keys t <= s, with a window (> 0) only keys with
// s - t < window. Scores are q.k times 1/sqrt(h) with an f32 softmax;
// l is clamped at 1e-30 before the division, as in the TPU kernel.
// Besides the output (q's type) it writes each row's natural log-sum-exp
// in f32, [B,N,S], which the backward reads.
//
// What bounds it on the H100: at smollm-135m's training shape (B=4,
// S=2048, N=9, K=3, h=64) the causal work is 4*B*N*h*S^2/2 = 19.3 GFLOP
// against 38 MB moved in f32 (q, k, v, out once): far past the ridge of
// either type, so operations bound it, and only the tensor cores come
// near that bound (bf16 0.0195 ms; 3xTF32 0.117 ms; 0.29 ms at the f32
// CUDA-core peak).
//
// Design: flash attention is chunk prefill with its queries starting at
// position 0 over fresh K and V (L = Sk keys, slots Sk*K*h elements
// apart), so it runs the chunk-prefill tensor-core bodies
// (../../chunk_prefill/csrc/): f32 q, k, v the 3xTF32 body
// (chunk_tf32.cuh, as exact as f32: the training type), bf16 the bf16
// mma.sync body (chunk_mma.cuh, which rounds P to bf16 for P V), each at
// h = 16, 64 and 128, causal or not. Their template flags add what flash
// needs beside chunk prefill: CAUSAL = false lets every key t < Sk live
// (a window still applies), LSE = true writes the log-sum-exp (the bodies
// run the softmax in base 2, so ln 2 * (m + log2 l)). The start position
// is the constant 0, so no index tensor is read or allocated. One block per
// (query head, slot, 64-row query tile), the tiles heaviest first.
#include "../../chunk_prefill/csrc/chunk_mma.cuh"
#include "../../chunk_prefill/csrc/chunk_tf32.cuh"

namespace {

// K or V rows of one (slot, KV head) from position 0, row_stride apart
template <typename T>
struct FreshSrc {
  const T* kb;
  const T* vb;
  size_t row_stride;
  __device__ const T* k(int t0) const { return kb + t0 * row_stride; }
  __device__ const T* v(int t0) const { return vb + t0 * row_stride; }
  __device__ float k_scale(int, int) const { return 1.f; }
  __device__ float v_scale(int, int) const { return 1.f; }
};

template <int H, typename T>
__device__ __forceinline__ FreshSrc<T> fresh_src(const T* k, const T* v,
                                                 int Sk, int N, int K) {
  const int n = blockIdx.x, b = blockIdx.y;
  const size_t off = (size_t)b * Sk * K * H + (size_t)(n / (N / K)) * H;
  return FreshSrc<T>{k + off, v + off, (size_t)K * H};
}

// f32: the 3xTF32 body
template <int H, bool CAUSAL>
__global__ void __launch_bounds__(chunk_tf32::NT, 1) flash_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int Sk, int N, int K, int window) {
  chunk_tf32::chunk_rows<H, float, chunk_tf32::SCALE_NONE, CAUSAL, true>(
      q, out, S, Sk, N, chunk_tf32::tile_row(), blockIdx.x, blockIdx.y, 0,
      window, (size_t)K * H, fresh_src<H>(k, v, Sk, N, K), lse);
}

// bf16: the bf16 mma.sync body
template <int H, bool CAUSAL>
__global__ void __launch_bounds__(chunk_mma::NT, 2) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int Sk, int N, int K, int window) {
  chunk_mma::chunk_rows<H, CAUSAL, true>(
      q, out, S, Sk, N, chunk_mma::tile_row(), blockIdx.x, blockIdx.y, 0,
      window, (size_t)K * H, fresh_src<H>(k, v, Sk, N, K), lse);
}

template <int H, bool CAUSAL, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int Sk, int N, int K, int window,
                   cudaStream_t stream) {
  using chunk_tf32::IsF32;
  constexpr size_t bytes = IsF32<T>::value
                               ? chunk_tf32::Layout<H, float>::BYTES
                               : chunk_mma::Layout<H>::BYTES;
  constexpr int nt = IsF32<T>::value ? chunk_tf32::NT : chunk_mma::NT;
  constexpr int bq = IsF32<T>::value ? chunk_tf32::BQ : chunk_mma::BQ;
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                 int, int);
  if constexpr (IsF32<T>::value)
    kernel = flash_tf32_kernel<H, CAUSAL>;
  else
    kernel = flash_mma_kernel<H, CAUSAL>;
  static const cudaError_t setup = decode_tile::allow_smem(kernel, bytes);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(N, B, (S + bq - 1) / bq);
  kernel<<<grid, nt, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, Sk, N, K, window);
  return cudaGetLastError();
}

template <int H, typename T>
cudaError_t launch_c(int causal, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int S, int Sk, int N, int K,
                     int window, cudaStream_t stream) {
  if (causal)
    return launch<H, true, T>(q, k, v, out, lse, B, S, Sk, N, K, window,
                              stream);
  return launch<H, false, T>(q, k, v, out, lse, B, S, Sk, N, K, window,
                             stream);
}

// every head dim of HEAD_DIMS (ops.py), for both types
template <typename T>
cudaError_t launch_h(int h, int causal, const void* q, const void* k,
                     const void* v, void* out, void* lse, int B, int S,
                     int Sk, int N, int K, int window, cudaStream_t stream) {
  switch (h) {
    case 16:
      return launch_c<16, T>(causal, q, k, v, out, lse, B, S, Sk, N, K,
                             window, stream);
    case 64:
      return launch_c<64, T>(causal, q, k, v, out, lse, B, S, Sk, N, K,
                             window, stream);
    case 128:
      return launch_c<128, T>(causal, q, k, v, out, lse, B, S, Sk, N, K,
                              window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,N,h], k/v [B,Sk,K,h], all contiguous, 16-byte aligned and of one
// type (f32, or bf16 when bf16 != 0); out [B,S,N,h] in that type; lse
// [B,N,S] f32. window <= 0 means none. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int bf16, int B, int S, int Sk, int N,
                                      int K, int h, int window, int causal,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || K <= 0 || N % K != 0 || N > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_h<__nv_bfloat16>(h, causal, q, k, v, out, lse, B, S,
                                        Sk, N, K, window, st);
  return (int)launch_h<float>(h, causal, q, k, v, out, lse, B, S, Sk, N, K,
                              window, st);
}
