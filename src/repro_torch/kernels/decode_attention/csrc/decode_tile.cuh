// The split-key ("flash-decoding") body shared by the dense and the paged
// decode kernels (decode_attention.cu, paged_kernel.cuh), and the pass
// that combines its splits; also the conversions and warp reductions the
// other attention bodies (chunk_tf32.cuh, flash_attention.cu) take from
// here.
//
// What bounds decode on the H100: bytes. A call reads the live part of the
// cache once and does ~4 G h operations per cached position, ~3.5
// operations a byte in bf16 (14 for int8/fp8 codes): the f32 CUDA cores
// (~20 a byte of DRAM bandwidth) are enough, and the design's job is to
// keep every SM reading and enough bytes in flight. One block per (slot,
// KV head), walking the key axis in a loop as the TPU's sequential grid
// axis does, gave 16 blocks at B=4 for 132 SMs and one 32-key tile of
// prefetch each: 0.1002 ms for 3 MB (NVIDIA H100 80GB HBM3, 700 W).
//
// The design:
// - The key axis is cut into splits of SPLIT = 128 keys on absolute
//   positions [j*128, (j+1)*128): a block serves one (split j, KV head kh,
//   slot b), all G query heads of the group (one cache read serves G
//   heads). The partition depends on key positions only, never on the
//   cache's length S, the table's npg or B, so a paged launch and a dense
//   launch over the same rows run the same instructions on the same
//   values in the same order (bit-equal), whatever length either was
//   allocated with. The host sizes the grid from S or npg alone and never
//   reads the position; a split with no live key (past the position, or
//   wholly older than the window) returns before it loads anything.
// - A split is 4 tiles of TK = 32 keys (one page each), copied by
//   cp.async into a ring in shared memory: 5 stages for 1- and 2-byte
//   types, so the whole split is in flight at once, 3 stages for f32 (two
//   blocks share an SM). Dead rows are zero-filled without being read;
//   their scores are -1e30 and their p exactly 0, so they add nothing.
// - The tile body: 8 warps. Scores: a warp per query head (heads g, g+8,
//   ... for G > 8), a lane per key, the K row read as 16-byte vectors from
//   rows padded by 16 bytes (lanes on distinct banks), q read as 16-byte
//   broadcasts. P.V: a thread per output column d for G / (256 / h) heads,
//   the tile's V column held in registers across heads. Accumulators are
//   sized by a group bound GB (8 or 32) chosen at launch. Quantized codes
//   are scaled once per tile or per key, not per element: a head scale
//   multiplies a tile's scores and its P.V sum, a row scale each key's
//   score and p. Two __syncthreads a tile (p and corr double-buffered).
// - Each live split writes f32 partials (m, l, acc[h]) per (slot, query
//   head, split) into scratch; split_combine_kernel, launched next on the
//   same stream by the same C entry, reads the live splits in ascending
//   order and writes sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i,
//   1e-30) in q's type: no atomics, the same bits on every call, and one
//   live split gives exactly acc / l.
//
// Measured (chip_smoke.py, phase 6, NVIDIA H100 80GB HBM3 at 700 W; calls
// replayed from a CUDA graph, each finding its cache cold in the L2, as
// each layer's does on the main path): the control step's call (B=4,
// bf16, position 736) 0.0131 ms, SDPA 0.0148; the engines' f32 cache
// (B=8) 0.0213 ms; paged 0.0189-0.0224 ms by storage type; in the
// control step's decode, 10.6 us a split kernel (the profiler). Against
// a 0.0018 ms byte bound in bf16 the time now goes to the tile body at 8
// warps an SM: each head's warp re-reads the K tile and q from shared
// memory, and every tile waits on two barriers and a softmax of warp
// shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_tile {

constexpr int TK = 32;         // keys per tile (= page size): one per lane
constexpr int GMAX = 32;       // most query heads per KV group
constexpr float NEG_INF = -1e30f;

constexpr int DNT = 256;       // threads per block of a split: 8 warps
constexpr int DNW = DNT / 32;
constexpr int SPLIT_TILES = 4;
constexpr int SPLIT = SPLIT_TILES * TK;   // keys per split, on absolute
                                          // positions (ops.SPLIT)
constexpr int GSMALL = 8;      // group bound of the narrow instantiation

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

// cp.async: `bytes` from src to dst in shared memory without passing
// through registers, or that many zero bytes (src not read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The live keys [first, last] of a slot at position idx over `len` rows.
__device__ __forceinline__ int2 live_keys(int idx, int len, int window) {
  return make_int2(window > 0 ? max(0, idx - window + 1) : 0,
                   min(idx, len - 1));
}

// Shared-memory layout of a split block, in bytes: STAGES ring slots, each
// the K tile (rows padded by 16 bytes), the V tile and the tile's k/v
// scales [TK] in f32; then q [G][H], p [2][G][TK] and corr [2][G] in f32.
template <int H, typename TKV>
struct SplitLayout {
  static constexpr int STAGES = sizeof(TKV) == 4 ? 3 : SPLIT_TILES + 1;
  static constexpr int KP = H + 16 / (int)sizeof(TKV);   // padded K row
  static constexpr int K_BYTES = TK * KP * (int)sizeof(TKV);
  static constexpr int V_BYTES = TK * H * (int)sizeof(TKV);
  static constexpr int STAGE = K_BYTES + V_BYTES + 2 * TK * 4;
  static constexpr int F_OFF = STAGES * STAGE;
  static constexpr size_t bytes(int G) {
    return (size_t)F_OFF + 4 * ((size_t)G * H + 2 * (size_t)G * TK + 2 * G);
  }
};

// Src: where tile t0's rows of this (slot, KV head) start, and (scaled
// codes only) the addresses of their scales. Row r of the tile is at
// k(t0) + r * K * H.
//   const TKV* k(int t0), v(int t0)
//   const float* k_scale(int t0, int r), v_scale(int t0, int r)
//
// One block: split j of slot b, KV head kh, over the live keys [first,
// last]. Writes acc [H] and (m, l) of each of its G query heads to the
// partials at row ((b * N + n) * NS + j); a split with no live key writes
// nothing.
template <int H, typename TKV, int SC, int GB, typename T, typename Src>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int b, int kh, int j, int NS, int N, int K,
    int first, int last, const Src& src) {
  using Lay = SplitLayout<H, TKV>;
  using U = Unpack<TKV>;
  constexpr int ST = Lay::STAGES;
  constexpr int KP = Lay::KP;
  constexpr int EPC = 16 / (int)sizeof(TKV);   // elements per 16 bytes
  constexpr int CPR = H / EPC;                 // 16-byte chunks per row
  constexpr int CHUNKS = TK * CPR;             // chunks per tile of K or V
  constexpr int HPW = (GB + DNW - 1) / DNW;    // heads a warp scores
  constexpr int RG = DNT / H;                  // head groups of P.V
  constexpr int RPT = (GB + RG - 1) / RG;      // heads a thread sums

  const int lo = max(first, j * SPLIT);
  const int hi = min(last, j * SPLIT + SPLIT - 1);
  if (lo > hi) return;                         // no live key: no loads
  const int t_lo = lo / TK * TK;
  const int nt = (hi - t_lo) / TK + 1;         // tiles of this split

  extern __shared__ __align__(16) unsigned char smem[];
  const int G = N / K;
  float* q_s = reinterpret_cast<float*>(smem + Lay::F_OFF);  // [G][H]
  float* p_s = q_s + G * H;                                  // [2][G][TK]
  float* corr_s = p_s + 2 * G * TK;                          // [2][G]
  auto k_tile = [&](int s) {
    return reinterpret_cast<TKV*>(smem + s * Lay::STAGE);
  };
  auto v_tile = [&](int s) {
    return reinterpret_cast<TKV*>(smem + s * Lay::STAGE + Lay::K_BYTES);
  };
  auto scales = [&](int s) {   // k scales [TK], then v scales [TK]
    return reinterpret_cast<float*>(smem + s * Lay::STAGE + Lay::K_BYTES +
                                    Lay::V_BYTES);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row_stride = (size_t)K * H;

  // tile i of the split into ring slot i % ST (a group even when empty, so
  // that the groups count tiles)
  auto fetch = [&](int i) {
    if (i < nt) {
      const int t0 = t_lo + i * TK, s = i % ST;
      const TKV* kt = src.k(t0);
      const TKV* vt = src.v(t0);
      TKV* kd = k_tile(s);
      TKV* vd = v_tile(s);
#pragma unroll
      for (int u = 0; u < (CHUNKS + DNT - 1) / DNT; ++u) {
        const int c = tid + u * DNT;
        if (CHUNKS % DNT != 0 && c >= CHUNKS) break;
        const int r = c / CPR, col = (c % CPR) * EPC;
        const bool live = t0 + r >= lo && t0 + r <= hi;
        const size_t off = live ? r * row_stride + col : 0;
        cp_async16(kd + r * KP + col, kt + off, live);
        cp_async16(vd + r * H + col, vt + off, live);
      }
      if constexpr (SC == SCALE_HEAD) {
        if (tid < 2)
          cp_async4(scales(s) + tid * TK,
                    tid ? src.v_scale(t0, 0) : src.k_scale(t0, 0), true);
      } else if constexpr (SC == SCALE_TOKEN) {
        if (tid < 2 * TK) {
          const int r = tid % TK;
          const bool live = t0 + r >= lo && t0 + r <= hi;
          const int rr = live ? r : 0;
          cp_async4(scales(s) + tid,
                    tid < TK ? src.k_scale(t0, rr) : src.v_scale(t0, rr),
                    live);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) fetch(i);
  for (int i = tid; i < G * H; i += DNT)
    q_s[i] = to_f32<T>(q[((size_t)b * N + kh * G) * H + i]);

  const float scale = (float)(1.0 / sqrt((double)H));
  float m_r[HPW], l_r[HPW], acc[RPT];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const int d = tid % H, rg = tid / H;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();             // tile i landed; tile i-1 fully consumed
    fetch(i + ST - 1);           // into the slot tile i-1 left
    const int s = i % ST, buf = i & 1, t0 = t_lo + i * TK;
    const float* sc = scales(s);

    // scores and softmax statistics: a warp per query head, a lane per key
    if (warp < G) {
      const int kpos = t0 + lane;
      const bool live = kpos >= lo && kpos <= hi;
      const uint4* krow =
          reinterpret_cast<const uint4*>(k_tile(s) + lane * KP);
      float dot[HPW];
#pragma unroll
      for (int h = 0; h < HPW; ++h) dot[h] = 0.f;
#pragma unroll
      for (int c = 0; c < CPR; ++c) {
        const uint4 w = krow[c];
        float f[EPC];
        U::run(w.x, f);
        U::run(w.y, f + U::N);
        U::run(w.z, f + 2 * U::N);
        U::run(w.w, f + 3 * U::N);
#pragma unroll
        for (int h = 0; h < HPW; ++h) {
          const int g = warp + DNW * h;
          if (g < G) {
            const float4* qv =
                reinterpret_cast<const float4*>(q_s + g * H + c * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 x = qv[e];
              dot[h] += x.x * f[4 * e] + x.y * f[4 * e + 1] +
                        x.z * f[4 * e + 2] + x.w * f[4 * e + 3];
            }
          }
        }
      }
      float qk = scale;          // a head scale once a tile, a row's once
      if constexpr (SC == SCALE_HEAD) qk = scale * sc[0];
      if constexpr (SC == SCALE_TOKEN) qk = scale * sc[lane];
#pragma unroll
      for (int h = 0; h < HPW; ++h) {
        const int g = warp + DNW * h;
        if (g < G) {
          const float sv = live ? dot[h] * qk : NEG_INF;
          const float m_new = fmaxf(m_r[h], warp_max(sv));
          const float p = live ? expf(sv - m_new) : 0.f;
          const float corr = expf(m_r[h] - m_new);
          l_r[h] = l_r[h] * corr + warp_sum(p);
          m_r[h] = m_new;
          // a row's v scale rides on its p (l keeps the unscaled p)
          p_s[(buf * G + g) * TK + lane] =
              SC == SCALE_TOKEN ? p * sc[TK + lane] : p;
          if (lane == 0) corr_s[buf * G + g] = corr;
        }
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_t p[g][t] * v[t][d]
    float vcol[TK];
    const TKV* vt = v_tile(s);
#pragma unroll
    for (int t = 0; t < TK; ++t) vcol[t] = to_f32<TKV>(vt[t * H + d]);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int g = rg + RG * r;
      if (g < G) {
        const float4* pg =
            reinterpret_cast<const float4*>(p_s + (buf * G + g) * TK);
        float pv = 0.f;
#pragma unroll
        for (int t = 0; t < TK / 4; ++t) {
          const float4 p = pg[t];
          pv += p.x * vcol[4 * t] + p.y * vcol[4 * t + 1] +
                p.z * vcol[4 * t + 2] + p.w * vcol[4 * t + 3];
        }
        if constexpr (SC == SCALE_HEAD) pv = pv * sc[TK];
        acc[r] = acc[r] * corr_s[buf * G + g] + pv;
      }
    }
  }

  const size_t row0 = ((size_t)b * N + kh * G) * NS + j;  // head 0's row
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int g = rg + RG * r;
    if (g < G) part_acc[(row0 + (size_t)g * NS) * H + d] = acc[r];
  }
  if (lane == 0 && warp < G) {
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = warp + DNW * h;
      if (g < G) {
        part_ml[(row0 + (size_t)g * NS) * 2] = m_r[h];
        part_ml[(row0 + (size_t)g * NS) * 2 + 1] = l_r[h];
      }
    }
  }
}

// The second pass: one block per (query head n, slot b), a thread per
// column; the live splits of the slot in ascending order. Static: each
// source that launches it holds its own copy.
template <int H, typename T>
static __global__ void __launch_bounds__(H) split_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ index, T* __restrict__ out, int N, int NS,
    int len, int window) {
  const int n = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int2 fl = live_keys(index[b], len, window);
  const int j_lo = fl.x / SPLIT;
  const int j_hi = fl.x <= fl.y ? fl.y / SPLIT : j_lo - 1;
  const size_t row0 = ((size_t)b * N + n) * NS;
  float M = NEG_INF;
  for (int j = j_lo; j <= j_hi; ++j) M = fmaxf(M, part_ml[(row0 + j) * 2]);
  float num = 0.f, den = 0.f;
  for (int j = j_lo; j <= j_hi; ++j) {
    const float w = expf(part_ml[(row0 + j) * 2] - M);
    den += w * part_ml[(row0 + j) * 2 + 1];
    num += w * part_acc[(row0 + j) * H + d];
  }
  out[((size_t)b * N + n) * H + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

// Launch the split kernel over grid (NS, K, B), then the combine over
// (N, B) on the same stream; `part` holds the partials, acc [B*N*NS][H]
// then (m, l) [B*N*NS][2]. Returns the first launch error.
template <int H, typename T, typename Kernel, typename... Args>
cudaError_t split_then_combine(Kernel kernel, size_t smem, float* part,
                               const int* index, void* out, int B, int N,
                               int K, int NS, int len, int window,
                               cudaStream_t stream, Args... args) {
  float* part_ml = part + (size_t)B * N * NS * H;
  kernel<<<dim3(NS, K, B), DNT, smem, stream>>>(args..., part, part_ml, N,
                                                   K, len, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_combine_kernel<H, T><<<dim3(N, B), H, 0, stream>>>(
      part, part_ml, index, static_cast<T*>(out), N, NS, len, window);
  return cudaGetLastError();
}

// Let a kernel use more than the default 48 KB of dynamic shared memory;
// done once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace decode_tile
