// Single-token GQA flash decode over a dense KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/decode_attention.py, body
// _flash_decode_body). Computes, for every slot b and query head
// n = kh*G + g, softmax((q . k) / sqrt(h)) . v over the cache positions
// kpos <= index[b] (and index[b] - kpos < window when a window is set).
//
// What bounds it on the H100: bytes. Each launch reads the live part of
// the cache once, (index+1) * K * h * 2 (K and V) * 2 bytes per slot, and
// does about 4 * G * h operations per cached position: about G/2 = 3.5
// operations per byte for molmoact-7b, far below the card's ~295 bf16
// operations per byte. Design answer: one block per (slot, KV head) so all
// G query heads of the group share every K/V tile (one cache read serves G
// heads, as on the TPU); the key axis is a loop inside the block with the
// next tile's 16-byte loads issued into registers before the current tile
// is computed; tiles past the position or older than the window are never
// read. With B*K blocks (16 at B=4) most SMs stay idle: splitting the key
// axis across blocks is the next step for this kernel.
//
// Numerics follow the TPU kernel: the online-softmax state (m, l, acc)
// stays in f32, the scale multiplies the f32 score after the dot, masked
// lanes carry -1e30 (not -inf) and p = exp(s - m_new) * mask, so a fully
// masked tile is an exact no-op; V (and K) are zero on dead lanes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int TK = 32;         // keys per tile: one key per lane
constexpr int GMAX = 32;       // most query heads per KV group
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

template <int H, typename T>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ index,
    T* __restrict__ out, int S, int N, int K, long long kv_bstride,
    int window) {
  constexpr int KP = H + 2;              // padded K row: lanes hit distinct banks
  constexpr int VEC = 8;                 // bf16 per 16-byte load
  constexpr int CPR = H / VEC;           // 16-byte chunks per cache row
  constexpr int CHUNKS = TK * CPR;       // chunks per tile of K (or of V)
  constexpr int LPT = (CHUNKS + NT - 1) / NT;
  constexpr int RG = NT / H;             // row groups of the PV stage
  constexpr int RPT = GMAX / RG;         // rows (query heads) per thread

  __shared__ float q_s[GMAX][H];
  __shared__ __align__(16) __nv_bfloat16 k_s[TK][KP];
  __shared__ __align__(16) __nv_bfloat16 v_s[TK][H];
  __shared__ float p_s[GMAX][TK];
  __shared__ float m_s[GMAX], l_s[GMAX], corr_s[GMAX];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = N / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int idx = index[b];
  const float scale = (float)(1.0 / sqrt((double)H));
  const int last = min(idx, S - 1);
  const int first = window > 0 ? max(0, idx - window + 1) : 0;
  const int t_begin = first / TK * TK;

  for (int i = tid; i < G * H; i += NT)
    q_s[i / H][i % H] = to_f32<T>(q[((size_t)b * N + kh * G) * H + i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const __nv_bfloat16* kb = k + b * kv_bstride + (size_t)kh * H;
  const __nv_bfloat16* vb = v + b * kv_bstride + (size_t)kh * H;
  const size_t row_stride = (size_t)K * H;
  uint4 kr[LPT], vr[LPT];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int c = tid + i * NT;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      const int kpos = t0 + c / CPR;
      if (c < CHUNKS && kpos >= first && kpos <= last) {
        const size_t off = kpos * row_stride + (c % CPR) * VEC;
        kr[i] = *reinterpret_cast<const uint4*>(kb + off);
        vr[i] = *reinterpret_cast<const uint4*>(vb + off);
      }
    }
  };

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const int d = tid % H, rg = tid / H;

  load_tile(t_begin);
  for (int t0 = t_begin; t0 <= last; t0 += TK) {
    // stage the tile (dead lanes were loaded as zeros)
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int c = tid + i * NT;
      if (c < CHUNKS) {
        const int row = c / CPR, col = (c % CPR) * VEC;
        uint32_t* kd = reinterpret_cast<uint32_t*>(&k_s[row][col]);
        kd[0] = kr[i].x; kd[1] = kr[i].y; kd[2] = kr[i].z; kd[3] = kr[i].w;
        *reinterpret_cast<uint4*>(&v_s[row][col]) = vr[i];
      }
    }
    __syncthreads();
    if (t0 + TK <= last) load_tile(t0 + TK);   // in flight during compute

    // scores and softmax statistics: a warp per query head, a lane per key
    const int kpos = t0 + lane;
    const bool live = kpos >= first && kpos <= last;
    const __nv_bfloat162* k2 =
        reinterpret_cast<const __nv_bfloat162*>(&k_s[lane][0]);
    for (int g = warp; g < G; g += NT / 32) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < H / 2; ++j) {
        const float2 kf = __bfloat1622float2(k2[j]);
        dot += q_s[g][2 * j] * kf.x;
        dot += q_s[g][2 * j + 1] * kf.y;
      }
      const float s = live ? dot * scale : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new) * (live ? 1.f : 0.f);
      const float corr = expf(m_old - m_new);
      const float psum = warp_sum(p);
      p_s[g][lane] = p;
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + psum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int g = rg + RG * i;
      if (g < G) {
        float pv = 0.f;
#pragma unroll
        for (int t = 0; t < TK; ++t)
          pv += p_s[g][t] * __bfloat162float(v_s[t][d]);
        acc[i] = acc[i] * corr_s[g] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int g = rg + RG * i;
    if (g < G)
      out[((size_t)b * N + kh * G + g) * H + d] =
          from_f32<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <int H, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* index, void* out, int B, int S, int N, int K,
                   long long kv_bstride, int window, cudaStream_t stream) {
  decode_kernel<H, T><<<dim3(K, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(index),
      static_cast<T*>(out), S, N, K, kv_bstride, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(int h, const void* q, const void* k, const void* v,
                     const void* index, void* out, int B, int S, int N, int K,
                     long long kv_bstride, int window, cudaStream_t stream) {
  switch (h) {
    case 16:
      return launch<16, T>(q, k, v, index, out, B, S, N, K, kv_bstride,
                           window, stream);
    case 64:
      return launch<64, T>(q, k, v, index, out, B, S, N, K, kv_bstride,
                           window, stream);
    case 128:
      return launch<128, T>(q, k, v, index, out, B, S, N, K, kv_bstride,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,N,h] (f32, or bf16 when q_bf16); k/v [B,S,K,h] bf16 whose rows are
// contiguous and whose slots are kv_bstride elements apart; index [B] int32
// on the device, each < S; out [B,N,h] in q's type. Returns the launch's
// cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* index,
                                       void* out, int q_bf16, int B, int S,
                                       int N, int K, int h,
                                       long long kv_bstride, int window,
                                       void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || N % K != 0 || N / K > GMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return (int)launch_h<__nv_bfloat16>(h, q, k, v, index, out, B, S, N, K,
                                        kv_bstride, window, st);
  return (int)launch_h<float>(h, q, k, v, index, out, B, S, N, K, kv_bstride,
                              window, st);
}
