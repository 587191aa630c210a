// The bf16 grouped expert products on the tensor cores, for Hopper
// (sm_90a): the tiles, the weight ring and the epilogues shared by the
// down-projection (gmm_down_tc.cu) and the gated up-projection
// (gmm_gated_tc.cu); the activations also serve the f32 kernel
// (moe_gmm.cu).
//
// Both products run with their operands swapped: out[e]^T = W[e]^T a[e]^T,
// a the activations (h for gmm_down, x for gmm_gated). A block owns 128
// weight columns a stage (wgmma's M, 64 a warpgroup; the A fragments come
// from W's rows, M-contiguous, through ldmatrix.trans) and every row of a
// of its pass (wgmma's N, one m64nNk16 per 16-deep step, B read from
// shared memory through a descriptor). The weights arrive by cp.async into
// a 4-stage ring of 64-deep tiles, unpadded, 16-byte chunks XOR-swizzled
// by row against ldmatrix bank conflicts; a in planes of 8 contraction
// columns, the core-matrix layout wgmma reads without swizzle. Rows past
// the pass and columns past the width are zeros in the tiles and never
// written, so every width need only be a multiple of 8.
#pragma once

#include <math.h>

#include "../../chunk_prefill/csrc/tc_util.cuh"
#include "../../chunk_prefill/csrc/wgmma_bf16.cuh"

namespace gmm_tc {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;          // threads: two warpgroups
constexpr int BM = 128;          // weight columns per stage: 64 a warpgroup
constexpr int BK = 64;           // contraction depth per stage
constexpr int NMAX = 256;        // rows of a per pass
constexpr int STAGES = 4;        // weight ring
constexpr size_t SMEM_MAX = 232448;          // a block's opt-in maximum
constexpr size_t W_TILE = (size_t)BK * BM;   // elements of a weight stage

// The activation codes of the C entries, and the epilogue on the f32 sums
// (h = x wi, g = x wg): silu(g) * h, gelu_tanh(g) * h, gelu_tanh(h)
// (gelu_plain, which reads no wg), or h as it is (gmm_down).
enum Epi { EPI_SILU = 0, EPI_GELU = 1, EPI_GELU_PLAIN = 2, EPI_NONE = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;          // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

template <int EPI>
__device__ __forceinline__ float epilogue(float h, float g) {
  if (EPI == EPI_SILU) return g / (1.f + expf(-g)) * h;
  if (EPI == EPI_GELU) return gelu_tanh(g) * h;
  if (EPI == EPI_GELU_PLAIN) return gelu_tanh(h);
  return h;
}

// a as planes of 8 contraction columns, [np + 1][8] each (the spare row
// puts the 8 planes a warp's 16-byte copies hit on distinct banks)
__host__ __device__ constexpr int plane(int np) { return (np + 1) * 8; }

// The weight tile rows k0 .. k0+63 of a [Kd, N] matrix: columns c0 ..
// c0+127 of w0, or (PAIR) columns c0 .. c0+63 of w0 then the same columns
// of w1, so that a warpgroup each sums one of the two products of the same
// output columns. 16-byte chunk c of row r sits at chunk c ^ (r % 8): the
// 8 rows an ldmatrix reads fall on distinct banks. Past Kd or N, zeros.
template <bool PAIR>
__device__ __forceinline__ void load_w(bf16* ws, const bf16* w0,
                                       const bf16* w1, int k0, int c0,
                                       int Kd, int N) {
  for (int c = threadIdx.x; c < BK * BM / 8; c += NT) {
    const int r = c / (BM / 8), ch = c % (BM / 8);
    const int col = c0 + (PAIR ? ch & 7 : ch) * 8;
    const bf16* w = PAIR && ch >= 8 ? w1 : w0;
    const bool ok = k0 + r < Kd && col < N;
    tc::cp_async16(ws + r * BM + (ch ^ (r & 7)) * 8,
                   ok ? w + (size_t)(k0 + r) * N + col : w, ok);
  }
}

// rows 0 .. np-1 of a ([rows, Kd] at ae), contraction columns k0 ..
// k0+63, into the 8 planes from ap; rows past `rows` and columns past Kd
// are zeros
template <int NP>
__device__ __forceinline__ void load_act(bf16* ap, const bf16* ae, int k0,
                                         int rows, int Kd) {
  for (int c = threadIdx.x; c < NP * (BK / 8); c += NT) {
    const int r = c >> 3, k8 = c & 7;
    const bool ok = r < rows && k0 + k8 * 8 < Kd;
    tc::cp_async16(ap + k8 * plane(NP) + r * 8,
                   ok ? ae + (size_t)r * Kd + k0 + k8 * 8 : ae, ok);
  }
}

// the weights as wgmma A fragments: warp wq of group wg takes columns
// wg * 64 + wq * 16 .. +15, for each 16-deep step of the stage
__device__ __forceinline__ void load_a(uint32_t (&a)[BK / 16][4],
                                       const bf16* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = warp * 2 + ((lane >> 3) & 1);   // (wg*64 + wq*16) / 8
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    tc::ldsm_x4_trans(a[ks], ws + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                      BM +
                                  (ch ^ (lane & 7)) * 8);
}

// the stage's products: acc += W^T (a) x a^T (the planes from ap)
template <int NP>
__device__ __forceinline__ void mma_stage(float* acc,
                                          const uint32_t (&a)[BK / 16][4],
                                          const bf16* ap) {
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    tc::Wgmma<NP>::run(acc, a[ks],
                       tc::wgmma_desc(ap + 2 * ks * plane(NP),
                                      plane(NP) * 2, 128));
  tc::wgmma_commit();
}

// a in wgmma's 128-byte-swizzled K-major layout: row r (0 .. np-1) is the
// stage's 64 contraction columns, 128 bytes, its 16-byte chunk k8 at chunk
// k8 ^ (r % 8); 8-row atoms of 1024 bytes, 1024-byte aligned. The tensor
// cores read it without bank conflicts (the planes above give them some).
template <int NP>
__device__ __forceinline__ void load_act_sw(bf16* ap, const bf16* ae, int k0,
                                            int rows, int Kd) {
  for (int c = threadIdx.x; c < NP * (BK / 8); c += NT) {
    const int r = c >> 3, k8 = c & 7;
    const bool ok = r < rows && k0 + k8 * 8 < Kd;
    tc::cp_async16(ap + r * BK + ((k8 ^ (r & 7)) << 3),
                   ok ? ae + (size_t)r * Kd + k0 + k8 * 8 : ae, ok);
  }
}

// the descriptor of 16 contraction columns (from column 16 ks) of the
// swizzled layout: start address, leading offset 1 (unused when swizzled),
// stride 1024 bytes between 8-row atoms, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(const bf16* ap, int ks) {
  return (uint64_t)(((tc::smem_addr(ap) + 32 * ks) & 0x3ffffu) >> 4) |
         ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// the stage's products on a swizzled a
template <int NP>
__device__ __forceinline__ void mma_stage_sw(float* acc,
                                             const uint32_t (&a)[BK / 16][4],
                                             const bf16* ap) {
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    tc::Wgmma<NP>::run(acc, a[ks], desc_sw128(ap, ks));
  tc::wgmma_commit();
}

// elements of one stage of the streaming ring: the weights, then a (as
// planes, or swizzled)
template <int NP, bool SW = false>
__host__ __device__ constexpr int stage_elems() {
  return (int)W_TILE + (SW ? NP * BK : 8 * plane(NP));
}
template <int NP, bool SW = false, int ST = STAGES>
__host__ __device__ constexpr size_t stream_bytes() {
  return ST * (size_t)stage_elems<NP, SW>() * sizeof(bf16);
}

// One block's sums in the streaming layout: acc = W^T a^T over the whole
// contraction Kd, for weight columns c0 .. (PAIR: 64 of w0 and the same 64
// of w1; else 128 of w0) of [Kd, N] matrices and `rows` rows of a ([rows,
// Kd] at ae), the weights and a stage by stage through the ST-stage ring at
// `ring` (a swizzled when SW: then `ring` is 1024-byte aligned). Every sum
// runs in this block in one fixed order. The ring is free when it returns.
template <int NP, bool PAIR, bool SW = false, int ST = STAGES>
__device__ __forceinline__ void stream_sum(float* acc, bf16* ring,
                                           const bf16* w0, const bf16* w1,
                                           const bf16* ae, int rows, int c0,
                                           int Kd, int N) {
  constexpr int SB = stage_elems<NP, SW>();
  const int nk = (Kd + BK - 1) / BK;
  auto load = [&](int kt) {
    bf16* ws = ring + (kt % ST) * SB;
    load_w<PAIR>(ws, w0, w1, kt * BK, c0, Kd, N);
    if constexpr (SW)
      load_act_sw<NP>(ws + W_TILE, ae, kt * BK, rows, Kd);
    else
      load_act<NP>(ws + W_TILE, ae, kt * BK, rows, Kd);
  };
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<ST - 2>();               // stage kt arrived
    tc::fence_proxy_async();                   // ... for wgmma's reads
    __syncthreads();                           // and stage kt-1 is free
    if (kt + ST - 1 < nk) load(kt + ST - 1);
    tc::cp_async_commit();
    const bf16* ws = ring + (kt % ST) * SB;
    uint32_t a[BK / 16][4];
    load_a(a, ws);
    if constexpr (SW)
      mma_stage_sw<NP>(acc, a, ws + W_TILE);
    else
      mma_stage<NP>(acc, a, ws + W_TILE);
    tc::wgmma_wait<0>();
  }
  tc::cp_async_wait<0>();
}

// the epilogue of a single product on one sum: the activation, or none
template <int EPI>
struct Single {
  __device__ __forceinline__ float operator()(float v) const {
    return epilogue<EPI>(v, v);
  }
};

// rows c0 .. c0+rows-1, columns d0 .. d0+127 of out ([., D]) from the
// sums, after `act`, zeroing them; through ys (64 x 128 elements of shared
// memory, no longer read), 64 rows at a time in bf16, then 16-byte rows of
// out. Every thread calls it.
template <int NP, typename Act = Single<EPI_NONE>>
__device__ __forceinline__ void store_y(float* acc, bf16* ys, bf16* y,
                                        int c0, int rows, int d0, int D,
                                        Act act = Act()) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp * 16 + (lane >> 2);       // column (and m + 8)
  const int c2 = (lane & 3) * 2;
  __syncthreads();
#pragma unroll
  for (int rd = 0; rd < (NP + 63) / 64; ++rd) {
#pragma unroll
    for (int b = 0; b < 8 && 8 * (8 * rd + b) < NP; ++b)   // 8-row blocks
#pragma unroll
      for (int q = 0; q < 4; ++q) {    // row + q % 2, column + 8 (q / 2)
        const int r = 8 * b + c2 + (q & 1), col = m + 8 * (q >> 1);
        float& v = acc[4 * (8 * rd + b) + q];
        ys[r * BM + (((col >> 3) ^ (r & 7)) << 3) + (col & 7)] =
            __float2bfloat16_rn(act(v));
        v = 0.f;
      }
    __syncthreads();
    for (int c = threadIdx.x; c < 64 * (BM / 8); c += NT) {
      const int r = c / (BM / 8), ch = c % (BM / 8);
      if (64 * rd + r < rows && d0 + ch * 8 < D)
        *reinterpret_cast<uint4*>(y + (size_t)(c0 + 64 * rd + r) * D + d0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(ys + r * BM +
                                            ((ch ^ (r & 7)) << 3));
    }
    __syncthreads();
  }
}

// The gated epilogue: warpgroup 0 holds h = x wi for output columns f0 ..
// f0+63, warpgroup 1 g = x wg for the same ones, element for element
// (thread t + 128 holds g where thread t holds h). Per 64 rows, warpgroup
// 1 leaves its sums in gs (32 x 128 f32, in fragment order: no bank
// conflicts), warpgroup 0 writes act(h, g), rounded once to bf16, into ys
// (64 x 64 elements, 16-byte chunks XOR-swizzled by row), then every
// thread copies ys out as 16-byte rows of out ([., F]): rows c0 ..
// c0+rows-1, columns f0 .. f0+63. gs and ys are shared memory no longer
// read. Every thread calls it.
template <int NP, int EPI>
__device__ __forceinline__ void store_gated(const float* acc, float* gs,
                                            bf16* ys, bf16* out, int c0,
                                            int rows, int f0, int F) {
  constexpr int BO = BM / 2;                   // output columns
  const int t = threadIdx.x & 127, group = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int m = (t >> 5) * 16 + (lane >> 2);   // column (and m + 8)
  const int c2 = (lane & 3) * 2;
  __syncthreads();
#pragma unroll
  for (int rd = 0; rd < (NP + 63) / 64; ++rd) {
    if (group == 1) {
#pragma unroll
      for (int b = 0; b < 8 && 8 * (8 * rd + b) < NP; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gs[(4 * b + q) * 128 + t] = acc[4 * (8 * rd + b) + q];
    }
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int b = 0; b < 8 && 8 * (8 * rd + b) < NP; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // row + q % 2, column + 8 (q / 2)
          const int r = 8 * b + c2 + (q & 1), col = m + 8 * (q >> 1);
          ys[r * BO + (((col >> 3) ^ (r & 7)) << 3) + (col & 7)] =
              __float2bfloat16_rn(epilogue<EPI>(
                  acc[4 * (8 * rd + b) + q], gs[(4 * b + q) * 128 + t]));
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 64 * (BO / 8); c += NT) {
      const int r = c / (BO / 8), ch = c % (BO / 8);
      if (64 * rd + r < rows && f0 + ch * 8 < F)
        *reinterpret_cast<uint4*>(out + (size_t)(c0 + 64 * rd + r) * F +
                                  f0 + ch * 8) =
            *reinterpret_cast<const uint4*>(ys + r * BO +
                                            ((ch ^ (r & 7)) << 3));
    }
    __syncthreads();
  }
}

}  // namespace gmm_tc
