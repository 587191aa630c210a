// The tensor-core chunk-prefill body for bf16 queries over bf16 keys and
// values, shared by the dense and the paged chunk kernels
// (chunk_prefill.cu; paged_chunk_kernel.cuh for bf16 pages), as the TPU
// kernels share _chunk_prefill_body
// (src/repro/kernels/chunk_prefill/chunk_prefill.py), and by the bf16
// flash-attention kernel (../../flash_attention/csrc/flash_attention.cu).
// Every other pairing of q and storage types takes the 3xTF32 body,
// chunk_tf32.cuh.
//
// The function is chunk_tf32.cuh's: S queries at absolute positions
// idx .. idx+S-1 attend to the key positions kpos <= qpos (and
// qpos - kpos < window when a window is set); query head n reads KV head
// n / G. Flash attention instantiates it with CAUSAL = false for its
// non-causal mode (every key t < L is live, a window still keeps only
// qpos - kpos < window) and LSE = true to write each row's natural
// log-sum-exp; chunk prefill takes the defaults (causal, no log-sum-exp),
// where both flags fold away. Design, for the H100's tensor cores:
// - One block of 4 warps per (64-row query tile, query head, slot); each
//   warp owns 16 query rows. The q tile is copied once and kept in
//   registers as mma A fragments. Tiles run heaviest first (the grid's
//   slowest axis walks the query tiles from the last), so the longest
//   causal bands do not trail the launch.
// - Key blocks of BK = 64 on the absolute partition from position 0, in
//   ascending order, from the block holding the tile's first live key
//   (the window bound of its oldest row) to the one holding its last (the
//   causal bound of its youngest). A block's K and V rows arrive by
//   cp.async into a 2-stage ring in shared memory, the next block in
//   flight while this one is computed; rows are padded by 16 bytes so
//   that the 8 rows an ldmatrix reads fall on distinct banks. A block is
//   two 32-row halves, each fetched through Src as chunk_tf32.cuh's
//   halves are, so a page of 32 rows is half a block and a paged launch
//   runs the same instructions on the same values as a dense one.
// - S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 sums); the online
//   softmax on the score fragments, in base 2 (the scale carries log2 e),
//   the row max and sum over a quad of lanes by shuffles, m in registers,
//   the row sum kept per lane and summed over the quad at the end.
// - P rounded to bf16 in registers is the A operand of P V (the score
//   fragment of 16 keys is the A fragment of a 16-deep product); V
//   arrives as B fragments through ldmatrix.trans. The sum l is taken
//   over the rounded weights, so the weights that multiply V are
//   normalised exactly. Rounding P to bf16 is the one rounding the Pallas
//   kernel (which keeps P in f32) does not make.
// Chunking invariance holds bit for bit: a row's arithmetic (the key
// partition, each lane's keys within a block, the order of every sum) does
// not depend on the tile or the chunk it sits in, and a block dead for a
// row is an exact no-op for it (scores -1e30, p = 0, corr = 1, the
// accumulator plus zero products). Keys dead for every row of the tile
// (before the window of its oldest row, past its youngest row or past L)
// are never read: zeros are copied in their place.
#pragma once

#include <math.h>

#include "tc_util.cuh"

namespace chunk_mma {

constexpr int NT = 128;        // threads per block: 4 warps
constexpr int BQ = 64;         // query rows per block (16 per warp)
constexpr int BK = 64;         // keys per block
constexpr int HALF = 32;       // rows per Src fetch (= page size)
constexpr float NEG_INF = -1e30f;
using bf16 = __nv_bfloat16;

template <int H>
struct Layout {
  static constexpr int RP = H + 8;          // padded row, elements
  static constexpr int TILE = BK * RP;      // one K or V block
  static constexpr int Q_ELEMS = BQ * RP;
  // q tile, then 2 stages of (K, V)
  static constexpr size_t BYTES = (size_t)(Q_ELEMS + 4 * TILE) * sizeof(bf16);
};

// the first row of this block's query tile: the grid's z axis walks the
// tiles from the last (the longest causal band) to the first
__device__ __forceinline__ int tile_row() {
  return (gridDim.z - 1 - blockIdx.z) * BQ;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Src: where a 32-row half of the key block starting at t0 begins, rows
// row_stride elements apart (chunk_tf32.cuh's Src, unscaled):
//   const bf16* k(int t0), v(int t0)
// q, out: [B,S,N,H]; this block's rows s0 .. s0+63 of head n of slot b;
// idx: the slot's chunk start; L: the key positions the view holds.
// lse (LSE only): [B,N,S] f32, ln of each row's sum of exp(score).
template <int H, bool CAUSAL = true, bool LSE = false, typename Src>
__device__ __forceinline__ void chunk_rows(const bf16* __restrict__ q,
                                           bf16* __restrict__ out, int S,
                                           int L, int N, int s0, int n, int b,
                                           int idx, int window,
                                           size_t row_stride,
                                           const Src& src,
                                           float* __restrict__ lse = nullptr) {
  using Lay = Layout<H>;
  constexpr int RP = Lay::RP;
  constexpr int CPR = H / 8;                 // 16-byte chunks per row
  constexpr int KT = H / 16;                 // k steps of Q K^T
  constexpr int NS = BK / 8;                 // score n tiles per warp
  constexpr int NO = H / 8;                  // output n tiles per warp

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + Lay::Q_ELEMS;           // stage st: K, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_last = min(S, s0 + BQ) - 1;
  const int last = CAUSAL ? min(L - 1, idx + s_last) : L - 1;
  const int first = window > 0 ? max(0, idx + s0 - window + 1) : 0;
  const int kb0 = first / BK;
  const int nb = last >= first ? last / BK - kb0 + 1 : 0;

  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * 8, s = s0 + r;
    const bool ok = s < S;
    tc::cp_async16(q_s + r * RP + col,
                   q + (((size_t)b * S + (ok ? s : s0)) * N + n) * H + col,
                   ok);
  }

  auto load_block = [&](int kb, int st) {
    bf16* ks = kv_s + 2 * st * Lay::TILE;
    bf16* vs = ks + Lay::TILE;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t0 = kb * BK + half * HALF;
      if (t0 > last) break;                  // block-uniform
      const bf16* kt = src.k(t0);
      const bf16* vt = src.v(t0);
      for (int c = tid; c < HALF * CPR; c += NT) {
        const int r = c / CPR, col = (c % CPR) * 8, kpos = t0 + r;
        const bool ok = kpos >= first && kpos <= last;
        const size_t off = ok ? r * row_stride + col : 0;
        const int at = (half * HALF + r) * RP + col;
        tc::cp_async16(ks + at, kt + off, ok);
        tc::cp_async16(vs + at, vt + off, ok);
      }
    }
    // a half past the tile's last key is never read: zero it
    if (kb * BK + HALF > last)
      for (int c = tid; c < HALF * CPR; c += NT) {
        const int at = (HALF + c / CPR) * RP + (c % CPR) * 8;
        *reinterpret_cast<uint4*>(ks + at) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + at) = make_uint4(0u, 0u, 0u, 0u);
      }
  };

  if (nb > 0) load_block(kb0, 0);
  tc::cp_async_commit();                     // q with the first block

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int qpos0 = idx + s0 + warp * 16 + g;   // rows g and g + 8
  const float sc = (float)(1.4426950408889634 / sqrt((double)H));
  uint32_t qf[KT][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < nb; ++i) {
    if (i + 1 < nb) load_block(kb0 + i + 1, (i + 1) & 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                  // block i (and q) arrived
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        tc::ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * RP + kk * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* ks = kv_s + 2 * (i & 1) * Lay::TILE;
    const bf16* vs = ks + Lay::TILE;
    const int k0 = (kb0 + i) * BK;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, ks + (j2 * 16 + (lane >> 4) * 8 + (lane & 7)) * RP +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }

    // live for every row of the tile: all keys at or before its oldest
    // row, inside the view, and inside the window of its youngest row
    const bool full = (!CAUSAL || k0 + BK - 1 <= idx + s0) && k0 + BK <= L &&
                      (window <= 0 || idx + s_last - k0 < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * sc;
        // the causal test keeps a statement of its own: folded into one
        // expression with !CAUSAL, it changes the chunk kernels' code
        if constexpr (CAUSAL) {
          if (!full) {
            const int kpos = k0 + j * 8 + c2 + (e & 1);
            const int qpos = qpos0 + (e >> 1) * 8;
            const bool live = kpos < L && kpos <= qpos &&
                              (window <= 0 || qpos - kpos < window);
            v = live ? v : NEG_INF;
          }
        } else if (!full) {      // every key before L, in the window
          const int kpos = k0 + j * 8 + c2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          v = kpos < L && (window <= 0 || qpos - kpos < window) ? v : NEG_INF;
        }
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // p = 2^(s - m) on live keys, 0 on dead ones; rounded to bf16 as the
    // A fragments of P V; l sums the rounded weights
    uint32_t pa[BK / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[j][e] - m[e >> 1]);
        if (s[j][e] == NEG_INF) p[e] = 0.f;
      }
      const uint32_t lo = tc::pack_bf16(p[0], p[1]);
      const uint32_t hi = tc::pack_bf16(p[2], p[3]);
      pa[j / 2][(j & 1) * 2] = lo;
      pa[j / 2][(j & 1) * 2 + 1] = hi;
      ls[0] += tc::lo_f32(lo) + tc::hi_f32(lo);
      ls[1] += tc::lo_f32(hi) + tc::hi_f32(hi);
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {
        uint32_t vf[4];
        tc::ldsm_x4_trans(vf, vs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * RP +
                                  j2 * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * j2], pa[kk], vf[0], vf[1]);
        tc::mma_bf16(o[2 * j2 + 1], pa[kk], vf[2], vf[3]);
      }
    __syncthreads();                         // stage i & 1 is free again
  }
  tc::cp_async_wait<0>();

  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};   // all lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + warp * 16 + g + 8 * r;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(lt[r], 1e-30f);
    if constexpr (LSE) {
      // scores are in base 2 (q carries log2 e): ln(sum) = ln 2 (m + log2 l)
      if (c2 == 0)
        lse[((size_t)b * N + n) * S + s] =
            0.6931471805599453f * (m[r] + log2f(fmaxf(lt[r], 1e-30f)));
    }
    bf16* orow = out + (((size_t)b * S + s) * N + n) * H + c2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

}  // namespace chunk_mma
