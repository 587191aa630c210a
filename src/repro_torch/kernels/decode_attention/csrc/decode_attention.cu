// Single-token GQA flash decode over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/decode_attention.py, body
// _flash_decode_body). Computes, for every slot b and query head
// n = kh*G + g, softmax((q . k) / sqrt(h)) . v over the cache positions
// kpos <= index[b] (and index[b] - kpos < window when a window is set).
// The cache is f32 (the serving engine's) or bf16 (the control step's).
//
// What bounds it on the H100: bytes. Each launch reads the live part of
// the cache once, (index+1) * K * h * 2 (K and V) * 2 or 4 bytes per slot,
// and does about 4 * G * h operations per cached position: about G/2 = 3.5
// operations per byte for molmoact-7b in bf16, far below the card's ~295.
// Design answer: one block per (slot, KV head) so all G query heads of the
// group share every K/V tile (one cache read serves G heads, as on the
// TPU); the key axis is a loop inside the block with the next tile's
// 16-byte loads issued into registers before the current tile is computed;
// tiles past the position or older than the window are never read. With
// B*K blocks (16 at B=4) most SMs stay idle: splitting the key axis across
// blocks is the next step for this kernel. The tile body (decode_tile.cuh)
// is shared with the paged kernel.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

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

template <int H, typename TKV, typename T>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ index,
    T* __restrict__ out, int S, int N, int K, long long kv_bstride,
    int window) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int idx = index[b];
  const int last = min(idx, S - 1);
  const int first = window > 0 ? max(0, idx - window + 1) : 0;
  const size_t off = b * kv_bstride + (size_t)kh * H;
  const DenseSrc<TKV> src{k + off, v + off, (size_t)K * H};
  decode_group<H, TKV, SCALE_NONE, T>(q, out, b, kh, N, K, idx, first, last,
                                      src);
}

template <int H, typename TKV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* index, void* out, int B, int S, int N, int K,
                   long long kv_bstride, int window, cudaStream_t stream) {
  const auto kernel = decode_kernel<H, TKV, T>;
  static const cudaError_t setup =
      allow_smem(kernel, Layout<H, TKV>::bytes(GMAX));
  if (setup != cudaSuccess) return setup;
  kernel<<<dim3(K, B), NT, Layout<H, TKV>::bytes(N / K), stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(index),
      static_cast<T*>(out), S, N, K, kv_bstride, window);
  return cudaGetLastError();
}

template <typename TKV, typename T>
cudaError_t launch_h(int h, const void* q, const void* k, const void* v,
                     const void* index, void* out, int B, int S, int N, int K,
                     long long kv_bstride, int window, cudaStream_t stream) {
  switch (h) {
    case 16:
      return launch<16, TKV, T>(q, k, v, index, out, B, S, N, K, kv_bstride,
                                window, stream);
    case 64:
      return launch<64, TKV, T>(q, k, v, index, out, B, S, N, K, kv_bstride,
                                window, stream);
    case 128:
      return launch<128, TKV, T>(q, k, v, index, out, B, S, N, K, kv_bstride,
                                 window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TKV>
cudaError_t launch_q(int q_bf16, int h, const void* q, const void* k,
                     const void* v, const void* index, void* out, int B,
                     int S, int N, int K, long long kv_bstride, int window,
                     cudaStream_t stream) {
  if (q_bf16)
    return launch_h<TKV, __nv_bfloat16>(h, q, k, v, index, out, B, S, N, K,
                                        kv_bstride, window, stream);
  return launch_h<TKV, float>(h, q, k, v, index, out, B, S, N, K, kv_bstride,
                              window, stream);
}

}  // namespace

// q [B,N,h] (f32, or bf16 when q_bf16); k/v [B,S,K,h] (f32 when kv_dtype
// is 0, bf16 when 1) whose rows are contiguous and whose slots are
// kv_bstride elements apart; index [B] int32 on the device, each < S; out
// [B,N,h] in q's type. Returns the launch's cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* index,
                                       void* out, int q_bf16, int kv_dtype,
                                       int B, int S, int N, int K, int h,
                                       long long kv_bstride, int window,
                                       void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || N % K != 0 || N / K > GMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch_q<float>(q_bf16, h, q, k, v, index, out, B, S, N, K,
                                  kv_bstride, window, st);
    case 1:
      return (int)launch_q<__nv_bfloat16>(q_bf16, h, q, k, v, index, out, B,
                                          S, N, K, kv_bstride, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
