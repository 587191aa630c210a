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
// What bounds it on the H100: at the main path's shape (S = L = 640,
// h = 128, B = 4, N = 28) the causal work is 4*h*(S*(S+1)/2)*B*N = 11.8
// GFLOP against 42 MB moved (q and out in bf16, the view once), ~280
// operations per byte: at the card's bf16 ridge (~295), so bytes and
// operations bound it about equally (12 us). This first version keeps the
// arithmetic on the f32 CUDA cores, not the tensor cores, so it runs far
// from that bound; tensor-core tiles are the next step for this kernel.
//
// Design: the TPU kernel keeps a whole chunk's [S,h] f32 accumulator per
// grid cell (320 KB at S=640, h=128), more than a block's 227 KB of shared
// memory, so the query axis is tiled: one block per (32-row query tile,
// query head, slot). Each row walks key blocks of exactly bk = 32 keys on
// the absolute partition from position 0, in ascending order, skipping
// blocks dead for every row of the tile. Every row's arithmetic (dot order,
// the lane-per-key butterfly reductions, the sequential P.V sum) is the same
// whatever tile or chunk the row sits in, and a block fully masked for a
// row is an exact no-op for it (-1e30 masking, p = exp(s - m) * mask), so a
// row's result does not depend on how the prompt was chunked: the
// chunking-invariance contract of the TPU kernel holds bit for bit.
//
// The view is f32 (the serving engine's admission cache) or bf16 (the
// control step's); an f32 tile pair needs ~53 KB of shared memory, past the
// 48 KB default, so the tiles are dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int BQ = 32;         // query rows per block
constexpr int BK = 32;         // keys per block (= prefill_band): one per lane
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// The elements of storage type T packed in one 32-bit word, widened to
// f32 in order (the K tile is read a word at a time).
template <typename T> struct Unpack;
template <> struct Unpack<float> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void run(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void run(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);            // exact, as __bfloat162float
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout of one block, in bytes: the V tile, the padded K
// tile (rows 4 bytes longer: lanes reading one column of their own rows hit
// distinct banks), then q [BQ][H], p [BQ][BK], m, l, corr [BQ] in f32.
template <int H, typename TKV>
struct Layout {
  static constexpr int KP = H + 4 / (int)sizeof(TKV);
  static constexpr int K_OFF = BK * H * (int)sizeof(TKV);
  static constexpr int F_OFF =
      K_OFF + (BK * KP * (int)sizeof(TKV) + 15) / 16 * 16;
  static constexpr size_t BYTES =
      (size_t)F_OFF + 4 * ((size_t)BQ * H + BQ * BK + 3 * BQ);
};

template <int H, typename TKV, typename T>
__global__ void __launch_bounds__(NT) chunk_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ index,
    T* __restrict__ out, int S, int L, int N, int K, long long kv_bstride,
    int window) {
  using Lay = Layout<H, TKV>;
  constexpr int KP = Lay::KP;
  constexpr int VEC = 16 / (int)sizeof(TKV);   // elements per 16-byte load
  constexpr int CPR = H / VEC;                 // 16-byte chunks per row
  constexpr int CHUNKS = BK * CPR;
  constexpr int RG = NT / H;             // row groups of the P.V stage
  constexpr int RPT = BQ / RG;           // rows per thread in the P.V stage

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* v_s = reinterpret_cast<TKV*>(smem);                   // [BK][H]
  TKV* k_s = reinterpret_cast<TKV*>(smem + Lay::K_OFF);      // [BK][KP]
  float* q_s = reinterpret_cast<float*>(smem + Lay::F_OFF);  // [BQ][H]
  float* p_s = q_s + BQ * H;                                 // [BQ][BK]
  float* m_s = p_s + BQ * BK;
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;

  const int s0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (N / K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int idx = index[b];
  const float scale = (float)(1.0 / sqrt((double)H));
  const int s_last = min(S, s0 + BQ) - 1;
  // keys live for some row of the tile: causal bound from the youngest
  // row, window bound from the oldest
  const int last = min(L - 1, idx + s_last);
  const int first = window > 0 ? max(0, idx + s0 - window + 1) : 0;

  for (int i = tid; i < BQ * H; i += NT) {
    const int r = i / H, s = s0 + r;
    q_s[r * H + i % H] =
        s < S ? to_f32<T>(q[(((size_t)b * S + s) * N + n) * H + i % H]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const TKV* kb = k + b * kv_bstride + (size_t)kh * H;
  const TKV* vb = v + b * kv_bstride + (size_t)kh * H;
  const size_t row_stride = (size_t)K * H;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const int d = tid % H, rg = tid / H;

  for (int k0 = first / BK * BK; k0 <= last; k0 += BK) {
    // stage the key block; lanes dead for every row of the tile are zero
    for (int c = tid; c < CHUNKS; c += NT) {
      const int row = c / CPR, col = (c % CPR) * VEC;
      const int kpos = k0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (kpos >= first && kpos <= last) {
        const size_t off = kpos * row_stride + col;
        kv4 = *reinterpret_cast<const uint4*>(kb + off);
        vv4 = *reinterpret_cast<const uint4*>(vb + off);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * KP + col);
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      *reinterpret_cast<uint4*>(v_s + row * H + col) = vv4;
    }
    __syncthreads();

    // scores and softmax statistics: a warp per query row, a lane per key
    const int kpos = k0 + lane;
    const uint32_t* krow = reinterpret_cast<const uint32_t*>(k_s + lane * KP);
    using U = Unpack<TKV>;
    for (int r = warp; r < BQ; r += NT / 32) {
      const int qpos = idx + s0 + r;
      const bool live = s0 + r < S && kpos < L && kpos <= qpos &&
                        (window <= 0 || qpos - kpos < window);
      const float* qr = q_s + r * H;
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < H / U::N; ++w) {
        float f[U::N];
        U::run(krow[w], f);
#pragma unroll
        for (int e = 0; e < U::N; ++e) dot += qr[w * U::N + e] * f[e];
      }
      const float s = live ? dot * scale : NEG_INF;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new) * (live ? 1.f : 0.f);
      const float corr = expf(m_old - m_new);
      const float psum = warp_sum(p);
      p_s[r * BK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc[r][d] = acc * corr + sum_t p[r][t] * v[t][d]
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      float pv = 0.f;
#pragma unroll
      for (int t = 0; t < BK; ++t)
        pv += p_s[r * BK + t] * to_f32<TKV>(v_s[t * H + d]);
      acc[i] = acc[i] * corr_s[r] + pv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i, s = s0 + r;
    if (s < S)
      out[(((size_t)b * S + s) * N + n) * H + d] =
          from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <int H, typename TKV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* index, void* out, int B, int S, int L, int N,
                   int K, long long kv_bstride, int window,
                   cudaStream_t stream) {
  const auto kernel = chunk_kernel<H, TKV, T>;
  constexpr size_t bytes = Layout<H, TKV>::BYTES;
  if (bytes > 48 * 1024) {
    static const cudaError_t setup = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (setup != cudaSuccess) return setup;
  }
  const dim3 grid((S + BQ - 1) / BQ, N, B);
  kernel<<<grid, NT, bytes, stream>>>(
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
  if (B <= 0 || S <= 0 || L <= 0 || K <= 0 || N % K != 0 || bk != BK ||
      N > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch_q<float>(q_bf16, h, q, k, v, index, out, B, S, L, N,
                                  K, kv_bstride, window, st);
    case 1:
      return (int)launch_q<__nv_bfloat16>(q_bf16, h, q, k, v, index, out, B,
                                          S, L, N, K, kv_bstride, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
