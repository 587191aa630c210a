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
// Design answer (decode_tile.cuh): a split-key ("flash-decoding") grid of
// (ceil(S / 128) splits, K, B) blocks, each reading its 128 keys of one
// (slot, KV head) for all G query heads through a cp.async ring that holds
// the whole split in flight, then a combine pass over the live splits. At
// the control step (B=4, S=833) that is 112 blocks on 132 SMs where one
// block per (slot, KV head) gave 16: at position 736, 0.0131 ms replayed
// from a CUDA graph with the cache cold in the L2 (SDPA 0.0148) where the
// one-block design took 0.1002 ms (NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py). The grid depends on S, never on the position, which
// stays on the device.
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
};

template <int H, typename TKV, int GB, typename T>
__global__ void __launch_bounds__(DNT, 2) decode_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ index,
    long long kv_bstride, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int K, int S, int window) {
  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int2 fl = live_keys(index[b], S, window);
  const size_t off = b * kv_bstride + (size_t)kh * H;
  const DenseSrc<TKV> src{k + off, v + off, (size_t)K * H};
  decode_split<H, TKV, SCALE_NONE, GB, T>(q, part_acc, part_ml, b, kh, j,
                                          gridDim.x, N, K, fl.x, fl.y, src);
}

struct Args {
  const void *q, *k, *v, *index;
  float* part;
  void* out;
  int B, S, N, K, NS, window;
  long long kv_bstride;
  cudaStream_t stream;
};

template <int H, typename TKV, int GB, typename T>
cudaError_t launch(const Args& a) {
  const auto kernel = decode_kernel<H, TKV, GB, T>;
  static const cudaError_t setup =
      allow_smem(kernel, SplitLayout<H, TKV>::bytes(GB));
  if (setup != cudaSuccess) return setup;
  const int* index = static_cast<const int*>(a.index);
  return split_then_combine<H, T>(
      kernel, SplitLayout<H, TKV>::bytes(a.N / a.K), a.part, index, a.out,
      a.B, a.N, a.K, a.NS, a.S, a.window, a.stream, static_cast<const T*>(a.q),
      static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v), index,
      a.kv_bstride);
}

template <int H, typename TKV, typename T>
cudaError_t by_group(const Args& a) {
  return a.N / a.K <= GSMALL ? launch<H, TKV, GSMALL, T>(a)
                             : launch<H, TKV, GMAX, T>(a);
}

template <typename TKV, typename T>
cudaError_t by_h(int h, const Args& a) {
  switch (h) {
    case 16: return by_group<16, TKV, T>(a);
    case 64: return by_group<64, TKV, T>(a);
    case 128: return by_group<128, TKV, T>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TKV>
cudaError_t by_q(int q_bf16, int h, const Args& a) {
  return q_bf16 ? by_h<TKV, __nv_bfloat16>(h, a) : by_h<TKV, float>(h, a);
}

}  // namespace

// q [B,N,h] (f32, or bf16 when q_bf16); k/v [B,S,K,h] (f32 when kv_dtype
// is 0, bf16 when 1) whose rows are contiguous and whose slots are
// kv_bstride elements apart; index [B] int32 on the device, each < S;
// scratch: f32 [B * N * splits * (h + 2)], splits = ceil(S / SPLIT); out
// [B,N,h] in q's type. Launches the split kernel and the combine on
// `stream`; returns the first launch's cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* index,
                                       void* scratch, void* out, int q_bf16,
                                       int kv_dtype, int B, int S, int N,
                                       int K, int h, long long kv_bstride,
                                       int window, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || N % K != 0 || N / K > GMAX ||
      B > 65535 || K > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, index, static_cast<float*>(scratch), out, B, S, N, K,
               (S + SPLIT - 1) / SPLIT, window, kv_bstride,
               static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case 0: return (int)by_q<float>(q_bf16, h, a);
    case 1: return (int)by_q<__nv_bfloat16>(q_bf16, h, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {

template <typename TKV>
int split_smem(int h, int G) {
  switch (h) {
    case 16: return (int)SplitLayout<16, TKV>::bytes(G);
    case 64: return (int)SplitLayout<64, TKV>::bytes(G);
    case 128: return (int)SplitLayout<128, TKV>::bytes(G);
    default: return -1;
  }
}

}  // namespace

// The dynamic shared memory (bytes) a split block asks for at head dim h,
// a cache of kv_bytes-wide elements and G query heads a KV head (dense and
// paged alike), or -1 for a shape the kernels do not take.
extern "C" int decode_split_smem(int h, int kv_bytes, int G) {
  switch (kv_bytes) {
    case 1: return split_smem<int8_t>(h, G);
    case 2: return split_smem<__nv_bfloat16>(h, G);
    case 4: return split_smem<float>(h, G);
    default: return -1;
  }
}
