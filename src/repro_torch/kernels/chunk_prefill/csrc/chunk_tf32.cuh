// The tensor-core chunk-prefill body for every pairing of q and storage
// type that chunk_mma.cuh (bf16 q over bf16 keys and values) does not
// take: an f32 view or f32 pages with an f32 or bf16 q, a bf16 view or
// bf16 pages with an f32 q, int8 and fp8 e4m3 pages at head or token
// scales with either q. Shared by the dense and the paged chunk kernels
// (chunk_prefill.cu; paged_chunk_kernel.cuh), as the TPU kernels share
// _chunk_prefill_body (src/repro/kernels/chunk_prefill/chunk_prefill.py),
// and by the f32 flash-attention kernel
// (../../flash_attention/csrc/flash_attention.cu), which instantiates it
// with CAUSAL = false for its non-causal mode and LSE = true to write each
// row's natural log-sum-exp; chunk prefill takes the defaults (causal, no
// log-sum-exp), where both flags fold away.
//
// The function: S queries at absolute positions idx .. idx+S-1 attend to
// the key positions kpos <= qpos (and qpos - kpos < window when a window
// is set); query head n reads KV head n / G. The serving engines keep f32
// caches and their greedy streams are held equal card vs CPU, so the body
// is as exact as f32, on the tensor cores:
// - 3xTF32 products: mma.sync m16n8k8 with TF32 operands and f32 sums, each
//   f32 operand split into a TF32 high part and a TF32 remainder (the low
//   13 bits of each cleared), a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
//   (CUTLASS's "fast f32"), ~2^-21 relative per product where plain TF32
//   gives ~2^-11. Both Q K^T and P V take it; P stays f32 and is split,
//   unlike chunk_mma.cuh, which rounds P to bf16. The online softmax runs
//   in f32 on the score fragments, in base 2 (q carries scale * log2 e).
// - One block of 8 warps per (64-row query tile, query head, slot). Warps
//   w and w + 4 own the same 16 query rows, their q * scale in registers
//   as f32 in fragment order (64 registers a thread at h = 128; the split
//   of q is redone each key block, 3 instructions an element, as holding
//   both halves would take 128), and split each 64-key block: warp w
//   takes its keys 0-31, warp w + 4 keys 32-63, each with its own online
//   softmax state; the two states meet once, at the end, through shared
//   memory (m = max(m_a, m_b), every sum rescaled by 2^(m_x - m)). Tiles
//   run heaviest first.
// - Key blocks of BK = 64 on the absolute partition from position 0, in
//   ascending order, from the block of the tile's first live key (the
//   window bound of its oldest row) to the one of its last (the causal
//   bound of its youngest). A block is two 32-row halves, each fetched
//   through Src (a page of 32 rows is half a block), by cp.async: f32
//   straight into the K and V tiles of a 2-stage ring (64 KB of K and V a
//   stage at h = 128, unpadded), every other type into a 2-stage ring of
//   its raw bytes, widened to f32 (and multiplied by its head or row
//   scale: the values the plain version dequantizes to) into one f32 tile
//   pair as the block comes up. K rows are padded by 16 floats and V rows
//   by 4, so the K fragments' 16-byte reads and the V fragments' 4-byte
//   reads fall on distinct banks (the k axis of each 8-deep step is
//   permuted to make a K fragment one 16-byte read).
// Chunking invariance holds bit for bit: a row's arithmetic (the key
// partition, each lane's keys within a block, the order of every sum)
// does not depend on the tile or the chunk it sits in, and a block dead
// for a row is an exact no-op for it (scores -1e30, p = 0, corr = 1, the
// accumulator plus zero products). At page size 32 a paged launch runs the
// same instructions on the same values as a dense one: bit-equal. Keys
// dead for every row of the tile are never read: zeros take their place.
// Measured (chip_smoke.py, phase 6, NVIDIA H100 80GB HBM3 at 700 W, calls
// replayed from a CUDA graph, caches cold in the L2): the engines'
// admission prefill (B = 1, S = 640, h = 128, f32 view) 0.0706 ms against
// a 0.0178 ms 3xTF32 bound; the last 128-row chunk of a 640-row prompt
// over f32 / int8-head / fp8-token pages 0.0581 / 0.0670 / 0.0672 ms
// (its 56 blocks leave half the card idle); errors with an f32 q under
// 1e-5.
#pragma once

#include <math.h>

#include "../../decode_attention/csrc/decode_tile.cuh"
#include "tc_util.cuh"

namespace chunk_tf32 {

using decode_tile::SCALE_HEAD;
using decode_tile::SCALE_NONE;
using decode_tile::SCALE_TOKEN;

constexpr int NT = 256;        // threads per block: 8 warps
constexpr int BQ = 64;         // query rows per block (16 per warp pair)
constexpr int BK = 64;         // keys per block (32 per warp of a pair)
constexpr int HALF = 32;       // rows per Src fetch (= page size)
constexpr float NEG_INF = -1e30f;

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// Shared memory, in floats: the f32 K tile [BK][RPK], the V tile [BK][RPV]
// (two stages of both for f32 storage; one for the others, after two
// stages of raw K and V blocks [BK][H] of the storage type)
template <int H, typename TKV>
struct Layout {
  static constexpr int RPK = H + (H % 32 == 16 ? 32 : 16);   // = 16 mod 32
  static constexpr int RPV = H + (H % 32 == 16 ? 20 : 4);    // = 4 mod 32
  static constexpr int K_TILE = BK * RPK;
  static constexpr int F32_STAGE = K_TILE + BK * RPV;
  static constexpr bool RAW = !IsF32<TKV>::value;
  static constexpr int RAW_BLOCK = BK * H * (int)sizeof(TKV);   // bytes
  static constexpr size_t BYTES =
      RAW ? (size_t)F32_STAGE * 4 + 4 * (size_t)RAW_BLOCK
          : 2 * (size_t)F32_STAGE * 4;
  // the key halves' exchange (m, l and o of 4 row groups of 32 lanes) fits
  // in the f32 tiles
  static_assert((4 + 4 * (H / 8)) * 128 <= F32_STAGE, "exchange");
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

// x = hi + lo + (under 2^-21 |x|), hi and lo TF32 (low 13 bits clear)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a * b, TF32 in, f32 sums. A 16x8 row-major, lane l (g = l / 4, t =
// l % 4): a0 (g, k t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B 8x8: b0
// (k t, n g), b1 (t+4, g); C as mma.sync m16n8: (g, 2t), (g, 2t+1), (g+8,
// 2t), (g+8, 2t+1). Not volatile: independent products may interleave.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a * b from the split halves, the small terms first
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// four elements of q from p as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(tc::lo_f32(w.x), tc::hi_f32(w.x), tc::lo_f32(w.y),
                     tc::hi_f32(w.y));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Src: where a 32-row half of the key block starting at t0 begins, rows
// row_stride elements apart, and the scales of its rows:
//   const TKV* k(int t0), v(int t0)
//   float k_scale(int t0, int r), v_scale(int t0, int r)   (SC != NONE)
// q, out: [B,S,N,H] of T; this block's rows s0 .. s0+63 of head n of slot
// b; idx: the slot's chunk start; L: the key positions the view holds
// (keys at L or past are dead); without CAUSAL every key t < L is live
// (a window still keeps only qpos - kpos < window). lse (LSE only):
// [B,N,S] f32, ln of each row's sum of exp(score), taken after the two key
// halves' states meet.
template <int H, typename TKV, int SC, bool CAUSAL = true, bool LSE = false,
          typename T, typename Src>
__device__ __forceinline__ void chunk_rows(const T* __restrict__ q,
                                           T* __restrict__ out, int S, int L,
                                           int N, int s0, int n, int b,
                                           int idx, int window,
                                           size_t row_stride,
                                           const Src& src,
                                           float* __restrict__ lse = nullptr) {
  using Lay = Layout<H, TKV>;
  constexpr int RPK = Lay::RPK, RPV = Lay::RPV;
  constexpr bool RAW = Lay::RAW;
  constexpr int VEC = 16 / (int)sizeof(TKV);  // elements per 16-byte chunk
  constexpr int CPR = H / VEC;                // 16-byte chunks per row
  constexpr int KP = H / 16;                  // 16-deep steps of Q K^T
  constexpr int NS = BK / 16;                 // score n tiles per warp
  constexpr int NO = H / 8;                   // output n tiles per warp

  extern __shared__ __align__(16) unsigned char smem[];
  float* f32s = reinterpret_cast<float*>(smem);
  unsigned char* raw = smem + (RAW ? (size_t)Lay::F32_STAGE * 4 : 0);

  const int tid = threadIdx.x, lane = tid & 31;
  const int rw = (tid >> 5) & 3, kh = tid >> 7;  // row group, key half
  const int g = lane >> 2, t = lane & 3;
  const int s_last = min(S, s0 + BQ) - 1;
  const int last = CAUSAL ? min(L - 1, idx + s_last) : L - 1;
  const int first = window > 0 ? max(0, idx + s0 - window + 1) : 0;
  const int kb0 = first / BK;
  const int nb = last >= first ? last / BK - kb0 + 1 : 0;

  // block kb into stage st: rows dead for every row of the tile (and a
  // half past the tile's last key, which is never fetched) are zeros
  auto load_block = [&](int kb, int st) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t0 = kb * BK + half * HALF;
      if (t0 > last) break;                  // block-uniform
      const TKV* kt = src.k(t0);
      const TKV* vt = src.v(t0);
      for (int c = tid; c < HALF * CPR; c += NT) {
        const int r = c / CPR, col = (c % CPR) * VEC, kpos = t0 + r;
        const bool ok = kpos >= first && kpos <= last;
        const size_t off = ok ? r * row_stride + col : 0;
        const int row = half * HALF + r;
        if constexpr (RAW) {
          TKV* kr = reinterpret_cast<TKV*>(raw + 2 * st * Lay::RAW_BLOCK);
          TKV* vr = reinterpret_cast<TKV*>(raw + (2 * st + 1) * Lay::RAW_BLOCK);
          tc::cp_async16(kr + row * H + col, kt + off, ok);
          tc::cp_async16(vr + row * H + col, vt + off, ok);
        } else {
          float* ks = f32s + st * Lay::F32_STAGE;
          tc::cp_async16(ks + row * RPK + col, kt + off, ok);
          tc::cp_async16(ks + Lay::K_TILE + row * RPV + col, vt + off, ok);
        }
      }
    }
    if constexpr (!RAW) {
      if (kb * BK + HALF > last) {
        float* ks = f32s + st * Lay::F32_STAGE;
        for (int c = tid; c < HALF * (H / 4); c += NT) {
          const int row = HALF + c / (H / 4), col = (c % (H / 4)) * 4;
          *reinterpret_cast<float4*>(ks + row * RPK + col) =
              make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(ks + Lay::K_TILE + row * RPV + col) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  };

  // raw stage st of block kb widened to f32 (times its scale) into the f32
  // tiles; rows dead for every row of the tile are zeros (never read)
  auto widen = [&](int kb, int st) {
    const TKV* kr = reinterpret_cast<const TKV*>(raw + 2 * st * Lay::RAW_BLOCK);
    const TKV* vr =
        reinterpret_cast<const TKV*>(raw + (2 * st + 1) * Lay::RAW_BLOCK);
    float* ks = f32s;
    float* vs = f32s + Lay::K_TILE;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * VEC, kpos = kb * BK + r;
      const bool ok = kpos >= first && kpos <= last;
      float kf[VEC], vf[VEC];
      const uint4 kw = *reinterpret_cast<const uint4*>(kr + r * H + col);
      const uint4 vw = *reinterpret_cast<const uint4*>(vr + r * H + col);
      const uint32_t kws[4] = {kw.x, kw.y, kw.z, kw.w};
      const uint32_t vws[4] = {vw.x, vw.y, vw.z, vw.w};
      using U = decode_tile::Unpack<TKV>;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        U::run(kws[w], kf + w * U::N);
        U::run(vws[w], vf + w * U::N);
      }
      float ksc = 1.f, vsc = 1.f;
      if constexpr (SC != SCALE_NONE) {
        if (ok) {
          const int t0 = kb * BK + (r / HALF) * HALF;
          ksc = src.k_scale(t0, SC == SCALE_TOKEN ? r % HALF : 0);
          vsc = src.v_scale(t0, SC == SCALE_TOKEN ? r % HALF : 0);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if constexpr (SC != SCALE_NONE) {
          kf[e] = kf[e] * ksc;
          vf[e] = vf[e] * vsc;
        }
        kf[e] = ok ? kf[e] : 0.f;
        vf[e] = ok ? vf[e] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(ks + r * RPK + col + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(vs + r * RPV + col + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
  };

  // q * scale * log2 e in fragment order: qf[m][4 * r + j] is row g + 8 r,
  // column 16 m + 4 t + j; rows past S are zeros (never written out)
  const float sc = (float)(1.4426950408889634 / sqrt((double)H));
  float qf[KP][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + rw * 16 + g + 8 * r;
    const T* qrow = q + (((size_t)b * S + min(s, S - 1)) * N + n) * H + 4 * t;
#pragma unroll
    for (int m = 0; m < KP; ++m) {
      float4 v = load4(qrow + 16 * m);
      if (s >= S) v = make_float4(0.f, 0.f, 0.f, 0.f);
      qf[m][4 * r] = v.x * sc;
      qf[m][4 * r + 1] = v.y * sc;
      qf[m][4 * r + 2] = v.z * sc;
      qf[m][4 * r + 3] = v.w * sc;
    }
  }

  const int qpos0 = idx + s0 + rw * 16 + g;     // rows g and g + 8
  const int kw = kh * (BK / 2);                 // this warp's keys of a block
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (nb > 0) load_block(kb0, 0);
  tc::cp_async_commit();
  for (int i = 0; i < nb; ++i) {
    tc::cp_async_wait<0>();                  // block i arrived
    __syncthreads();                         // and block i-1 is consumed
    if (i + 1 < nb) load_block(kb0 + i + 1, (i + 1) & 1);
    tc::cp_async_commit();
    const float* ks = f32s;
    if constexpr (RAW) {
      widen(kb0 + i, i & 1);
      __syncthreads();
    } else {
      ks += (i & 1) * Lay::F32_STAGE;
    }
    const float* vs = ks + Lay::K_TILE;
    const int k0 = (kb0 + i) * BK;

    // S = Q K^T. Step 2m of the 16 columns 16m .. 16m+15 takes columns
    // 16m + 4t and +1 as its k = t and t + 4, step 2m + 1 columns +2 and
    // +3: a lane's K fragments of both steps are one 16-byte read.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int m = 0; m < KP; ++m) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        split(qf[m][2 * st], ah[st][0], al[st][0]);
        split(qf[m][4 + 2 * st], ah[st][1], al[st][1]);
        split(qf[m][2 * st + 1], ah[st][2], al[st][2]);
        split(qf[m][5 + 2 * st], ah[st][3], al[st][3]);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + (kw + 8 * j + g) * RPK + 16 * m + 4 * t);
        uint32_t bh[2][2], bl[2][2];
        split(kv.x, bh[0][0], bl[0][0]);
        split(kv.y, bh[0][1], bl[0][1]);
        split(kv.z, bh[1][0], bl[1][0]);
        split(kv.w, bh[1][1], bl[1][1]);
        mma_3x(s[j], ah[0], al[0], bh[0], bl[0]);
        mma_3x(s[j], ah[1], al[1], bh[1], bl[1]);
      }
    }

    // live for every row of the tile: all keys at or before its oldest
    // row, inside the view, and inside the window of its youngest row
    const bool full = (!CAUSAL || k0 + BK - 1 <= idx + s0) && k0 + BK <= L &&
                      (window <= 0 || idx + s_last - k0 < window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e];
        // the causal test keeps a statement of its own: folded into one
        // expression with !CAUSAL, it changes the chunk kernels' code
        if constexpr (CAUSAL) {
          if (!full) {
            const int kpos = k0 + kw + j * 8 + 2 * t + (e & 1);
            const int qpos = qpos0 + (e >> 1) * 8;
            const bool live = kpos < L && kpos <= qpos &&
                              (window <= 0 || qpos - kpos < window);
            v = live ? v : NEG_INF;
          }
        } else if (!full) {      // every key before L, in the window
          const int kpos = k0 + kw + j * 8 + 2 * t + (e & 1);
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
      corr[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    // p = 2^(s - m) on live keys, 0 on dead ones, in f32
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[j][e] == NEG_INF ? 0.f : exp2f(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        ls[e >> 1] += p;
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

    // O += P V. Step jk takes keys 8jk + 2t and +1 as its k = t and t + 4:
    // the score fragment of those keys is the A fragment as it stands.
#pragma unroll
    for (int jk = 0; jk < NS; ++jk) {
      uint32_t ph[4], pl[4];
      split(s[jk][0], ph[0], pl[0]);
      split(s[jk][2], ph[1], pl[1]);
      split(s[jk][1], ph[2], pl[2]);
      split(s[jk][3], ph[3], pl[3]);
      const float* vrow = vs + (kw + 8 * jk + 2 * t) * RPV + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        uint32_t bh[2], bl[2];
        split(vrow[8 * j], bh[0], bl[0]);
        split(vrow[RPV + 8 * j], bh[1], bl[1]);
        mma_3x(o[j], ph, pl, bh, bl);
      }
    }
  }
  tc::cp_async_wait<0>();

  // the key halves meet: warp w + 4 leaves m, its lanes' l and o in shared
  // memory (item i of lane l of row group rw at [i][rw][l]: no bank
  // conflicts), warp w takes them in and writes the rows
  float* xs = f32s;
  __syncthreads();                           // every tile is consumed
  if (kh == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[(r * 128) + rw * 32 + lane] = m_r[r];
      xs[((2 + r) * 128) + rw * 32 + lane] = l[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xs[(4 + 4 * j + e) * 128 + rw * 32 + lane] = o[j][e];
  }
  __syncthreads();
  if (kh == 1) return;
  float fa[2], fb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mb = xs[(r * 128) + rw * 32 + lane];
    const float m_all = fmaxf(m_r[r], mb);
    fa[r] = exp2f(m_r[r] - m_all);
    fb[r] = exp2f(mb - m_all);
    l[r] = l[r] * fa[r] + xs[((2 + r) * 128) + rw * 32 + lane] * fb[r];
    if constexpr (LSE) m_r[r] = m_all;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[j][e] = o[j][e] * fa[e >> 1] +
                xs[(4 + 4 * j + e) * 128 + rw * 32 + lane] * fb[e >> 1];

  const float lt[2] = {quad_sum(l[0]), quad_sum(l[1])};   // all lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + rw * 16 + g + 8 * r;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(lt[r], 1e-30f);
    if constexpr (LSE) {
      // scores are in base 2 (q carries log2 e): ln(sum) = ln 2 (m + log2 l)
      if (t == 0)
        lse[((size_t)b * N + n) * S + s] =
            0.6931471805599453f * (m_r[r] + log2f(fmaxf(lt[r], 1e-30f)));
    }
    T* orow = out + (((size_t)b * S + s) * N + n) * H + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      store2(orow + j * 8, o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

}  // namespace chunk_tf32
