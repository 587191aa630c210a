// The online-softmax body shared by the dense and the paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu), as the TPU kernels
// share _flash_decode_body (src/repro/kernels/decode_attention/
// decode_attention.py).
//
// One block serves one (slot b, KV head kh): all G query heads of the
// group share every K/V tile, so one cache read serves G heads. The key
// axis is a loop over tiles of TK = 32 rows, in ascending order, from the
// tile holding the window's first live position to the one holding the
// slot's position; a tile's rows are contiguous, K*H elements apart. The
// two kernels differ only in where a tile's rows start (a Src functor): a
// dense cache's rows t0.. of slot b, or page page_table[b, t0 / 32] of a
// pool whose pages hold exactly one tile. So at page_size 32 and the same
// storage type, a paged launch and a dense launch over the same rows run
// the same instructions on the same values, in the same order.
//
// Storage types: f32, bf16, int8 or fp8 e4m3 codes. Codes are widened to
// f32 and multiplied by their scale (one per (page, head), or one per row)
// in registers, as the TPU kernel dequantizes inside its VMEM tile; the
// softmax state stays f32. Masked lanes carry -1e30 (not -inf) and
// p = exp(s - m_new) * mask, so a fully masked tile is an exact no-op; K
// and V are zero on dead lanes (never loaded).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_tile {

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int TK = 32;         // keys per tile (= page size): one per lane
constexpr int GMAX = 32;       // most query heads per KV group
constexpr float NEG_INF = -1e30f;

enum ScaleMode { SCALE_NONE = 0, SCALE_HEAD = 1, SCALE_TOKEN = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return (float)x;
}
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(
    __nv_fp8_e4m3 x) {
  return (float)x;
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
template <> struct Unpack<int8_t> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void run(uint32_t w, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = (float)(int8_t)(w >> (8 * i));
  }
};
template <> struct Unpack<__nv_fp8_e4m3> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void run(uint32_t w, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_fp8_e4m3 x;
      x.__x = (__nv_fp8_storage_t)((w >> (8 * i)) & 0xffu);
      f[i] = (float)x;
    }
  }
};

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

// Shared-memory layout of one block, in bytes from a 16-byte aligned base:
// the V tile, the padded K tile (each row 4 bytes longer, so that lanes
// reading the same column of their own rows hit distinct banks), then the
// f32 arrays.
template <int H, typename TKV>
struct Layout {
  static constexpr int KP = H + 4 / (int)sizeof(TKV);  // padded K row
  static constexpr int V_OFF = 0;
  static constexpr int K_OFF = V_OFF + TK * H * (int)sizeof(TKV);
  static constexpr int F_OFF = K_OFF + ((TK * KP * (int)sizeof(TKV) + 15) /
                                        16 * 16);
  // f32 arrays: q [G][H], p [G][TK], m, l, corr [G], k/v row scales [TK]
  static constexpr size_t bytes(int G) {
    return (size_t)F_OFF + 4 * ((size_t)G * H + (size_t)G * TK + 3 * G +
                                2 * TK);
  }
};

// Src: where tile t0's rows of this (slot, KV head) start, and their
// scales. Row r of the tile is at k(t0) + r * K * H.
//   const TKV* k(int t0), v(int t0)
//   float k_scale(int t0, int r), v_scale(int t0, int r)
template <int H, typename TKV, int SC, typename T, typename Src>
__device__ __forceinline__ void decode_group(
    const T* __restrict__ q, T* __restrict__ out, int b, int kh, int N,
    int K, int idx, int first, int last, const Src& src) {
  using Lay = Layout<H, TKV>;
  constexpr int KP = Lay::KP;
  constexpr int VEC = 16 / (int)sizeof(TKV);   // elements per 16-byte load
  constexpr int CPR = H / VEC;                 // 16-byte chunks per row
  constexpr int CHUNKS = TK * CPR;             // chunks per tile of K (or V)
  constexpr int LPT = (CHUNKS + NT - 1) / NT;
  constexpr int RG = NT / H;                   // row groups of the PV stage
  constexpr int RPT = GMAX / RG;               // query heads per thread

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* v_s = reinterpret_cast<TKV*>(smem + Lay::V_OFF);      // [TK][H]
  TKV* k_s = reinterpret_cast<TKV*>(smem + Lay::K_OFF);      // [TK][KP]
  const int G = N / K;
  float* q_s = reinterpret_cast<float*>(smem + Lay::F_OFF);  // [G][H]
  float* p_s = q_s + G * H;                                  // [G][TK]
  float* m_s = p_s + G * TK;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  float* ks_s = corr_s + G;                                  // [TK]
  float* vs_s = ks_s + TK;                                   // [TK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale = (float)(1.0 / sqrt((double)H));
  const int t_begin = first / TK * TK;
  const size_t row_stride = (size_t)K * H;

  for (int i = tid; i < G * H; i += NT)
    q_s[i] = to_f32<T>(q[((size_t)b * N + kh * G) * H + i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  uint4 kr[LPT], vr[LPT];
  float sr = 0.f;                  // token scale row (threads < 2 TK)
  float ksc_next = 0.f, vsc_next = 0.f;
  auto load_tile = [&](int t0) {
    const TKV* kt = src.k(t0);
    const TKV* vt = src.v(t0);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int c = tid + i * NT;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      const int kpos = t0 + c / CPR;
      if (c < CHUNKS && kpos >= first && kpos <= last) {
        const size_t off = (c / CPR) * row_stride + (c % CPR) * VEC;
        kr[i] = *reinterpret_cast<const uint4*>(kt + off);
        vr[i] = *reinterpret_cast<const uint4*>(vt + off);
      }
    }
    if constexpr (SC == SCALE_HEAD) {
      ksc_next = src.k_scale(t0, 0);
      vsc_next = src.v_scale(t0, 0);
    } else if constexpr (SC == SCALE_TOKEN) {
      const int r = tid % TK, kpos = t0 + r;
      sr = 0.f;
      if (tid < 2 * TK && kpos >= first && kpos <= last)
        sr = tid < TK ? src.k_scale(t0, r) : src.v_scale(t0, r);
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
        uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * KP + col);
        kd[0] = kr[i].x; kd[1] = kr[i].y; kd[2] = kr[i].z; kd[3] = kr[i].w;
        *reinterpret_cast<uint4*>(v_s + row * H + col) = vr[i];
      }
    }
    const float ksc = ksc_next, vsc = vsc_next;
    if constexpr (SC == SCALE_TOKEN) {
      if (tid < 2 * TK) (tid < TK ? ks_s : vs_s)[tid % TK] = sr;
    }
    __syncthreads();
    if (t0 + TK <= last) load_tile(t0 + TK);   // in flight during compute

    // scores and softmax statistics: a warp per query head, a lane per key
    const int kpos = t0 + lane;
    const bool live = kpos >= first && kpos <= last;
    const uint32_t* krow = reinterpret_cast<const uint32_t*>(k_s + lane * KP);
    const float kscale = SC == SCALE_TOKEN ? ks_s[lane] : ksc;
    using U = Unpack<TKV>;
    for (int g = warp; g < G; g += NT / 32) {
      const float* qg = q_s + g * H;
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < H / U::N; ++w) {
        float f[U::N];
        U::run(krow[w], f);
#pragma unroll
        for (int e = 0; e < U::N; ++e) {
          float kf = f[e];
          if constexpr (SC != SCALE_NONE) kf = kf * kscale;
          dot += qg[w * U::N + e] * kf;
        }
      }
      const float s = live ? dot * scale : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new) * (live ? 1.f : 0.f);
      const float corr = expf(m_old - m_new);
      const float psum = warp_sum(p);
      p_s[g * TK + lane] = p;
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
        for (int t = 0; t < TK; ++t) {
          float vf = to_f32<TKV>(v_s[t * H + d]);
          if constexpr (SC == SCALE_HEAD) vf = vf * vsc;
          if constexpr (SC == SCALE_TOKEN) vf = vf * vs_s[t];
          pv += p_s[g * TK + t] * vf;
        }
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

// Let a kernel use more than the default 48 KB of dynamic shared memory
// (an f32 tile pair with G = 32 needs ~53 KB); done once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace decode_tile
