// The banded chunk-prefill body shared by the dense and the paged chunk
// kernels (chunk_prefill.cu; paged_chunk_prefill.cu, paged_chunk_int8.cu,
// paged_chunk_fp8.cu), as the TPU kernels share _chunk_prefill_body
// (src/repro/kernels/chunk_prefill/chunk_prefill.py).
//
// S queries at absolute positions index[b] .. index[b]+S-1 attend to the
// key positions kpos <= qpos (and qpos - kpos < window when a window is
// set); query head n reads KV head n / G. The TPU kernel keeps a whole
// chunk's [S,h] f32 accumulator per grid cell (320 KB at S=640, h=128),
// more than a block's 227 KB of shared memory, so the query axis is tiled:
// one block per (32-row query tile, query head, slot). Each row walks key
// blocks of exactly BK = 32 keys on the absolute partition from position 0,
// in ascending order, skipping blocks dead for every row of the tile.
// Every row's arithmetic (dot order, the lane-per-key butterfly
// reductions, the sequential P.V sum) is the same whatever tile or chunk
// the row sits in, and a block fully masked for a row is an exact no-op
// for it (-1e30 masking, p = exp(s - m) * mask), so a row's result does
// not depend on how the prompt was chunked.
//
// The two kernels differ only in where key block t0's rows start (a Src
// functor): a dense view's rows t0.. of slot b, or page page_table[b, t0 /
// 32] of a pool whose pages hold exactly one block. So at page size 32 and
// the same storage type, a paged launch and a dense launch over the same
// rows run the same instructions on the same values in the same order, and
// are bit-equal. Storage types: f32, bf16, int8 or fp8 e4m3 codes; codes
// are widened to f32 and multiplied by their scale in registers (one per
// (page, head) held in a register per block, or one per row from a
// 32-entry shared array loaded beside the tile); K and V are zero on lanes
// dead for every row of the tile (never loaded).
#pragma once

#include "../../decode_attention/csrc/decode_tile.cuh"

namespace chunk_tile {

using decode_tile::from_f32;
using decode_tile::NEG_INF;
using decode_tile::NT;
using decode_tile::SCALE_HEAD;
using decode_tile::SCALE_NONE;
using decode_tile::SCALE_TOKEN;
using decode_tile::to_f32;
using decode_tile::Unpack;
using decode_tile::warp_max;
using decode_tile::warp_sum;

constexpr int BQ = 32;         // query rows per block
constexpr int BK = 32;         // keys per block (= prefill_band = page size)

// Shared-memory layout of one block, in bytes: the V tile, the padded K
// tile (rows 4 bytes longer: lanes reading one column of their own rows hit
// distinct banks), then q [BQ][H], p [BQ][BK], m, l, corr [BQ] and the
// k/v row scales [BK] in f32.
template <int H, typename TKV>
struct Layout {
  static constexpr int KP = H + 4 / (int)sizeof(TKV);
  static constexpr int K_OFF = BK * H * (int)sizeof(TKV);
  static constexpr int F_OFF =
      K_OFF + (BK * KP * (int)sizeof(TKV) + 15) / 16 * 16;
  static constexpr size_t BYTES =
      (size_t)F_OFF + 4 * ((size_t)BQ * H + BQ * BK + 3 * BQ + 2 * BK);
};

// Src: where key block t0's rows of this (slot, KV head) start, and their
// scales. Row r of the block is at k(t0) + r * K * H.
//   const TKV* k(int t0), v(int t0)
//   float k_scale(int t0, int r), v_scale(int t0, int r)
// L: the key positions the view holds (keys at L or past are dead).
template <int H, typename TKV, int SC, typename T, typename Src>
__device__ __forceinline__ void chunk_rows(const T* __restrict__ q,
                                           T* __restrict__ out, int S, int L,
                                           int N, int K, int idx, int window,
                                           const Src& src) {
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
  float* ks_s = corr_s + BQ;                                 // [BK]
  float* vs_s = ks_s + BK;                                   // [BK]

  const int s0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  const size_t row_stride = (size_t)K * H;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  const int d = tid % H, rg = tid / H;

  for (int k0 = first / BK * BK; k0 <= last; k0 += BK) {
    // stage the key block; lanes dead for every row of the tile are zero
    const TKV* kt = src.k(k0);
    const TKV* vt = src.v(k0);
    for (int c = tid; c < CHUNKS; c += NT) {
      const int row = c / CPR, col = (c % CPR) * VEC;
      const int kpos = k0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (kpos >= first && kpos <= last) {
        const size_t off = row * row_stride + col;
        kv4 = *reinterpret_cast<const uint4*>(kt + off);
        vv4 = *reinterpret_cast<const uint4*>(vt + off);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * KP + col);
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      *reinterpret_cast<uint4*>(v_s + row * H + col) = vv4;
    }
    float ksc = 0.f, vsc = 0.f;
    if constexpr (SC == SCALE_HEAD) {
      ksc = src.k_scale(k0, 0);
      vsc = src.v_scale(k0, 0);
    } else if constexpr (SC == SCALE_TOKEN) {
      if (tid < 2 * BK) {
        const int r = tid % BK, kpos = k0 + r;
        float sr = 0.f;
        if (kpos >= first && kpos <= last)
          sr = tid < BK ? src.k_scale(k0, r) : src.v_scale(k0, r);
        (tid < BK ? ks_s : vs_s)[r] = sr;
      }
    }
    __syncthreads();

    // scores and softmax statistics: a warp per query row, a lane per key
    const int kpos = k0 + lane;
    const uint32_t* krow = reinterpret_cast<const uint32_t*>(k_s + lane * KP);
    const float kscale = SC == SCALE_TOKEN ? ks_s[lane] : ksc;
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
        for (int e = 0; e < U::N; ++e) {
          float kf = f[e];
          if constexpr (SC != SCALE_NONE) kf = kf * kscale;
          dot += qr[w * U::N + e] * kf;
        }
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
      for (int t = 0; t < BK; ++t) {
        float vf = to_f32<TKV>(v_s[t * H + d]);
        if constexpr (SC == SCALE_HEAD) vf = vf * vsc;
        if constexpr (SC == SCALE_TOKEN) vf = vf * vs_s[t];
        pv += p_s[r * BK + t] * vf;
      }
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

}  // namespace chunk_tile
