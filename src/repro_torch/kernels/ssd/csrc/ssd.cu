// Mamba2 chunked SSD scan (state-space duality), for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_kernel (src/repro/kernels/ssd/ssd.py, body
// _kernel). Per (batch row b, head h), over chunks of Q rows with the
// state h [P,N] carried from chunk to chunk (zero before the first):
//   cum   = cumsum(dt * a) within the chunk, a = -exp(A_log[h]);
//   y     = ((C B^T) o L) (x dt) + (C o exp(cum)) h^T,
//           L[s,t] = exp(cum_s - cum_t) for s >= t, else 0;
//   h     = h exp(seg) + (x dt exp(seg - cum))^T B,   seg = cum[Q-1].
// x [B,S,H,P] and B, C [B,S,N] in bf16 or f32 (one type), dt [B,S,H] and
// A_log [H] in f32; y [B,S,H,P] in x's type, the final state [B,H,P,N] in
// f32. S is a multiple of Q (Q <= 128), N <= 128, any P.
//
// What bounds it on the H100: at mamba2-780m's width (H=48, P=64, N=128,
// Q=128) one 640-row prefill moves ~9.9 MB (x and y 3.9 MB each in bf16,
// the state 1.6 MB) against 2.5 GFLOP (10.5 MFLOP per head and chunk, half
// of it C B^T): bytes bound it (~3 us), and the operations reach that only
// on the tensor cores (2.5 us in bf16; 0.17 ms on the f32 CUDA cores).
//
// Design: the chunks of a head are independent but for the state that
// crosses them, and that state is a short linear recurrence over
// per-chunk terms, so one C entry enqueues two kernels, each with one
// block per (slot, head, chunk, 64 state rows of P): all chunks in
// parallel (240 blocks at B=1 S=640).
// 1. ssd_states_kernel: cum, seg and u = x dt exp(seg - cum) of its chunk,
//    and the chunk's own state term s_k = u^T B [P,N], written with seg_k
//    to a scratch the wrapper allocates (7.9 MB at B=1 S=640, which stays
//    in the L2 for the second kernel). C B^T depends on the chunk alone
//    (B and C are shared by every head), so its 16 x 16 tiles on and
//    below the diagonal (36 at Q = 128) are spread over the heads'
//    blocks, which write them to the scratch while one thread sums cum.
// 2. ssd_output_kernel: the state entering chunk k, h = h exp(seg_j) + s_j
//    over j < k in ascending order (the plain version's order; no atomics,
//    so a call gives the same bits every time), then y = exp(cum) (C h^T)
//    + (C B^T o L)(x dt), L applied as the A fragments of the last product
//    are read; the last chunk's block also writes the final state
//    h exp(seg_k) + s_k.
// Every product runs on the tensor cores as mma.sync m16n8k8 with TF32
// operands and f32 sums. An f32 operand is split into a TF32 high part and
// a TF32 remainder (chunk_tf32.cuh's 3xTF32: three products, as exact as
// f32); a bf16 value is exact in TF32, so a product with a bf16 operand
// (C B^T from bf16 C and B; u^T B and C h^T with bf16 B or C) takes one
// or two products and stays as exact. Rows past Q hold dt = 0, x = 0 and
// B = C = 0, and columns past N or P zeros: exact no-ops, so the inner
// loops have fixed trip counts. In the output kernel warp w owns the 16
// rows of tile w < 4 ? w : 11 - w, so the two warps of each scheduler
// share the causal work evenly. Shared memory: 107,520 bytes for the
// states kernel (two blocks an SM), 204,800 for the output kernel (one).
#include "../../chunk_prefill/csrc/chunk_tf32.cuh"

namespace {

using chunk_tf32::mma_3x;
using chunk_tf32::mma_tf32;
using chunk_tf32::split;

constexpr int NT = 256;          // threads: 8 warps
constexpr int QMAX = 128;        // rows of a chunk
constexpr int NMAX = 128;        // largest state size N
constexpr int PB = 64;           // state rows (of P) per block

// strides (floats) chosen so that each fragment's 32 reads fall on
// distinct banks: = 8 mod 32 where a lane reads (k t, n g), = 4 mod 32
// where it reads (row g, k t)
struct StatesSmem {
  static constexpr int RPU = PB + 8, RPB = NMAX + 8;
  float dt[QMAX];
  float cum[QMAX];
  float u[QMAX][RPU];            // x dt exp(seg - cum), rows t
  float b[QMAX][RPB];            // B, rows t
};

struct OutSmem {
  static constexpr int RPC = NMAX + 4, RPX = PB + 4;
  float dt[QMAX];
  float cum[QMAX];
  float c[QMAX][RPC];            // C, rows s
  float cb[QMAX][RPC];           // C B^T from pass 1, rows s
  float x[QMAX][RPX];            // x dt, rows t
  float h[PB][RPC];              // the state entering the chunk, rows p
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows [0, QMAX) x columns [0, COLS) of a tile as f32 into dst (row r at
// dst + r * rp), row r of the source at src + r * stride; rows at or past
// rows_ok and columns at or past cols_ok are zero. Four columns a thread
// at a time, one vector load when vec (cols_ok, stride and the source
// 4-element aligned); an f32 source then goes by cp.async, straight to
// shared memory (the caller commits and waits before its barrier).
template <int COLS, typename T>
__device__ __forceinline__ void stage(float* dst, int rp, const T* src,
                                      long long stride, int rows_ok,
                                      int cols_ok, bool vec) {
#pragma unroll 4
  for (int i = threadIdx.x; i < QMAX * COLS / 4; i += NT) {
    const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
    if constexpr (chunk_tf32::IsF32<T>::value) {
      if (vec) {
        const bool ok = r < rows_ok && c < cols_ok;
        tc::cp_async16(dst + r * rp + c, ok ? src + r * stride + c : src,
                       ok);
        continue;
      }
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_ok && c < cols_ok) {
      const T* p = src + r * stride + c;
      if (vec) {
        v = chunk_tf32::load4(p);
      } else {
        v.x = ld(p);
        if (c + 1 < cols_ok) v.y = ld(p + 1);
        if (c + 2 < cols_ok) v.z = ld(p + 2);
        if (c + 3 < cols_ok) v.w = ld(p + 3);
      }
    }
    *reinterpret_cast<float4*>(dst + r * rp + c) = v;
  }
}

// cum[t] = sum over t' <= t of dt[t'] a, in thread 0, in order, each
// product rounded before the sum: the plain version's cumsum of dt * a,
// bit for bit, so its decays exp(cum_s - cum_t) are too (another order
// rounds cum by up to an f32 ulp of |cum| a step, ~400 at a chunk's end,
// and the decays carry that into y).
// Rows past Q have dt = 0, so cum stays at seg there and seg =
// cum[QMAX - 1].
__device__ __forceinline__ void chunk_cumsum(const float* dt, float* cum,
                                             float a) {
  if (threadIdx.x != 0) return;
  float run = 0.f;
  for (int t = 0; t < QMAX; ++t) {
    run = __fadd_rn(run, __fmul_rn(dt[t], a));
    cum[t] = run;
  }
}

// C B^T's 16 x 16 tile u (of those on and below the diagonal, row by row)
// of a chunk of Q rows: (row tile, column tile)
__device__ __forceinline__ void cb_tile(int u, int& rt, int& ct) {
  rt = 0;
  while (u > rt) {
    u -= rt + 1;
    ++rt;
  }
  ct = u;
}

// Pass 1: the chunk's state term s_k[p][n] = sum_t u[t][p] B[t][n] (u f32,
// split; B exact when bf16) and seg_k into the scratch; warp w takes state
// rows 16 (w & 3) .. +15 of the block's 64 and columns 64 (w >> 2) .. +63.
// Besides, C B^T of the chunk, which every head shares (one group): its
// 16 x 16 tiles on and below the diagonal are spread over the heads'
// blocks (tile h, h + H, ... for head h), each half-tile of 8 columns
// to one of warps 1-7 while thread 0 sums cum; C comes straight from
// device memory as A fragments, B from the staged tile (exact products
// from bf16; 3xTF32 from f32).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      float* __restrict__ states, float* __restrict__ segs,
                      float* __restrict__ cbs, int S, int H, int P, int N,
                      int Q, int npb, bool vec_x, bool vec_n) {
  constexpr bool EXACT = !chunk_tf32::IsF32<T>::value;
  using Sm = StatesSmem;
  extern __shared__ __align__(16) unsigned char raw[];
  Sm& sm = *reinterpret_cast<Sm*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int k = blockIdx.x / npb, p0 = (blockIdx.x % npb) * PB;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / npb;
  const int pn = min(PB, P - p0);
  const long long row0 = (long long)b * S + (long long)k * Q;

  if (tid < QMAX) sm.dt[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
  stage<PB>(&sm.u[0][0], Sm::RPU, x + (row0 * H + h) * P + p0,
            (long long)H * P, Q, pn, vec_x);
  stage<NMAX>(&sm.b[0][0], Sm::RPB, bm + row0 * N, N, Q, N, vec_n);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  chunk_cumsum(sm.dt, sm.cum, -expf(a_log[h]));
  if (p0 == 0 && w > 0) {
    const int nt = (Q + 15) / 16;
    float* cb = cbs + (long long)(b * nc + k) * Q * Q;
    for (int i = w - 1, u = h + (i / 2) * H; u < nt * (nt + 1) / 2;
         i += NT / 32 - 1, u = h + (i / 2) * H) {
      int rt, ct;
      cb_tile(u, rt, ct);
      const int t = 16 * ct + 8 * (i & 1) + g;   // this lane's B row
      float cv[NMAX / 8][4];
#pragma unroll
      for (int kk = 0; kk < NMAX / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 16 * rt + g + 8 * (e & 1);
          const int n = 8 * kk + tq + 4 * (e >> 1);
          cv[kk][e] = s < Q && n < N ? ld(cm + (row0 + s) * N + n) : 0.f;
        }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NMAX / 8; ++kk) {
        const float* b0 = &sm.b[t][8 * kk + tq];
        uint32_t ch[4], cl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(cv[kk][e], ch[e], cl[e]);
        if constexpr (EXACT) {
          mma_tf32(acc, ch, __float_as_uint(b0[0]), __float_as_uint(b0[4]));
        } else {
          uint32_t bh[2], bl[2];
          split(b0[0], bh[0], bl[0]);
          split(b0[4], bh[1], bl[1]);
          mma_3x(acc, ch, cl, bh, bl);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 16 * rt + g + 8 * (e >> 1);
        const int col = 16 * ct + 8 * (i & 1) + 2 * tq + (e & 1);
        if (s < Q && col < Q) cb[(long long)s * Q + col] = acc[e];
      }
    }
  }
  __syncthreads();
  const float seg = sm.cum[QMAX - 1];
  for (int i = tid; i < QMAX * PB; i += NT) {
    const int t = i / PB, p = i % PB;
    sm.u[t][p] = sm.u[t][p] * sm.dt[t] * expf(seg - sm.cum[t]);
  }
  __syncthreads();
  const long long hk = ((long long)b * H + h) * nc + k;
  if (p0 == 0 && tid == 0) segs[hk] = seg;

  const int m0 = 16 * (w & 3), n0 = 64 * (w >> 2);
  if (m0 >= pn || n0 >= N) return;
  // every column tile of the warp: B is zero past N (an exact no-op)
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int nk = (Q + 7) / 8;
#pragma unroll 2
  for (int kk = 0; kk < nk; ++kk) {
    const float* u0 = &sm.u[8 * kk + tq][m0 + g];
    const float* u1 = u0 + 4 * Sm::RPU;
    uint32_t ah[4], al[4];
    split(u0[0], ah[0], al[0]);
    split(u0[8], ah[1], al[1]);
    split(u1[0], ah[2], al[2]);
    split(u1[8], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* b0 = &sm.b[8 * kk + tq][n0 + 8 * j + g];
      if constexpr (EXACT) {
        const uint32_t bh0 = __float_as_uint(b0[0]);
        const uint32_t bh1 = __float_as_uint(b0[4 * Sm::RPB]);
        mma_tf32(acc[j], al, bh0, bh1);
        mma_tf32(acc[j], ah, bh0, bh1);
      } else {
        uint32_t bh[2], bl[2];
        split(b0[0], bh[0], bl[0]);
        split(b0[4 * Sm::RPB], bh[1], bl[1]);
        mma_3x(acc[j], ah, al, bh, bl);
      }
    }
  }
  float* out = states + (hk * P + p0) * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = m0 + g + 8 * (e >> 1);
      const int n = n0 + 8 * j + 2 * tq + (e & 1);
      if (p < pn && n < N) out[(long long)p * N + n] = acc[j][e];
    }
}

// Pass 2: the state entering the chunk, then y; the last chunk's blocks
// write the final state.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
    ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_log, const T* __restrict__ cm,
                      const float* __restrict__ states,
                      const float* __restrict__ segs,
                      const float* __restrict__ cbs, T* __restrict__ y,
                      float* __restrict__ state, int S, int H, int P, int N,
                      int Q, int npb, bool vec_x, bool vec_n) {
  constexpr bool EXACT = !chunk_tf32::IsF32<T>::value;
  using Sm = OutSmem;
  constexpr int RPC = Sm::RPC, RPX = Sm::RPX;
  extern __shared__ __align__(16) unsigned char raw[];
  Sm& sm = *reinterpret_cast<Sm*>(raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int k = blockIdx.x / npb, p0 = (blockIdx.x % npb) * PB;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / npb;
  const int pn = min(PB, P - p0);
  const long long row0 = (long long)b * S + (long long)k * Q;

  if (tid < QMAX) sm.dt[tid] = tid < Q ? dt[(row0 + tid) * H + h] : 0.f;
  stage<NMAX>(&sm.c[0][0], RPC, cm + row0 * N, N, Q, N, vec_n);
  stage<QMAX>(&sm.cb[0][0], RPC, cbs + (long long)(b * nc + k) * Q * Q, Q,
              Q, Q, Q % 4 == 0);
  stage<PB>(&sm.x[0][0], RPX, x + (row0 * H + h) * P + p0, (long long)H * P,
            Q, pn, vec_x);

  // h = h exp(seg_j) + s_j over the chunks j < k, in order; thread tid
  // holds the 4-column groups tid + NT r of the block's [PB][NMAX] (zero
  // outside [pn][N])
  constexpr int R = PB * NMAX / 4 / NT;
  const long long hb = ((long long)b * H + h) * nc;   // chunk 0 of (b, h)
  auto ld4 = [&](const float* src, int r) {        // group r of a state
    const int i = tid + NT * r, p = i / (NMAX / 4), n = (i % (NMAX / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < pn && n < N) {
      const float* q = src + p * N + n;
      if (vec_n) {
        v = *reinterpret_cast<const float4*>(q);
      } else {
        v.x = q[0];
        if (n + 1 < N) v.y = q[1];
        if (n + 2 < N) v.z = q[2];
        if (n + 3 < N) v.w = q[3];
      }
    }
    return v;
  };
  float4 hv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) hv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int j = 0; j < k; ++j) {
    const float e = expf(segs[hb + j]);
    const float* sj = states + ((hb + j) * P + p0) * N;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = ld4(sj, r);
      hv[r] = make_float4(fmaf(hv[r].x, e, v.x), fmaf(hv[r].y, e, v.y),
                          fmaf(hv[r].z, e, v.z), fmaf(hv[r].w, e, v.w));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + NT * r;
    *reinterpret_cast<float4*>(&sm.h[i / (NMAX / 4)][(i % (NMAX / 4)) * 4]) =
        hv[r];
  }
  if (k == nc - 1) {
    const float e = expf(segs[hb + k]);
    const float* sk = states + ((hb + k) * P + p0) * N;
    float* fin = state + (((long long)b * H + h) * P + p0) * N;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + NT * r, p = i / (NMAX / 4), n = (i % (NMAX / 4)) * 4;
      const float4 v = ld4(sk, r);
      const float f[4] = {fmaf(hv[r].x, e, v.x), fmaf(hv[r].y, e, v.y),
                          fmaf(hv[r].z, e, v.z), fmaf(hv[r].w, e, v.w)};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (p < pn && n + c < N) fin[p * N + n + c] = f[c];
    }
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  // thread 0 sums cum while the warps take x dt and C h^T, which do not
  // read it
  chunk_cumsum(sm.dt, sm.cum, -expf(a_log[h]));
  for (int i = tid; i < QMAX * PB; i += NT) {
    const int t = i / PB, p = i % PB;
    sm.x[t][p] *= sm.dt[t];
  }

  const int g = lane >> 2, tq = lane & 3;
  const int mt = w < 4 ? w : 11 - w, s0 = 16 * mt;

  // the inter-chunk term C h^T (h split; C exact when bf16), every column
  // tile (h is zero past pn: an exact no-op), times exp(cum)
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int nk = (N + 7) / 8;
#pragma unroll 2
  for (int kk = 0; kk < nk; ++kk) {
    const float* c0 = &sm.c[s0 + g][8 * kk + tq];
    const float v[4] = {c0[0], c0[8 * RPC], c0[4], c0[8 * RPC + 4]};
    uint32_t ch[4], cl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (EXACT) {
        ch[e] = __float_as_uint(v[e]);
      } else {
        split(v[e], ch[e], cl[e]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* h0 = &sm.h[8 * j + g][8 * kk + tq];
      uint32_t hh[2], hl[2];
      split(h0[0], hh[0], hl[0]);
      split(h0[4], hh[1], hl[1]);
      if constexpr (EXACT) {
        mma_tf32(o[j], ch, hl[0], hl[1]);
        mma_tf32(o[j], ch, hh[0], hh[1]);
      } else {
        mma_3x(o[j], ch, cl, hh, hl);
      }
    }
  }
  __syncthreads();                     // cum and x dt are in place
  if (s0 >= Q) return;
  const float cr[2] = {sm.cum[s0 + g], sm.cum[s0 + g + 8]};
  const float ec[2] = {expf(cr[0]), expf(cr[1])};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= ec[e >> 1];

  // the intra-chunk term W (x dt), W = C B^T o L over the key tiles the
  // warp's rows reach. Step jk takes keys 8 jk + 2 tq and + 1 as its k =
  // tq and tq + 4, so a lane's A fragment is two float2 reads of C B^T,
  // each weighted by exp(cum_s - cum_t) for t <= s, else 0.
  const int nj = min(2 * mt + 2, (Q + 7) / 8);
  for (int jk = 0; jk < nj; ++jk) {
    const int t = 8 * jk + 2 * tq;
    const float2 c01 = *reinterpret_cast<const float2*>(&sm.cum[t]);
    float wv[4];                       // (g, t), (g + 8, t), (g, t+1), ...
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = s0 + g + 8 * r;
      const float2 raw2 = *reinterpret_cast<const float2*>(&sm.cb[s][t]);
      wv[r] = t <= s ? raw2.x * expf(cr[r] - c01.x) : 0.f;
      wv[r + 2] = t + 1 <= s ? raw2.y * expf(cr[r] - c01.y) : 0.f;
    }
    uint32_t wh[4], wl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(wv[e], wh[e], wl[e]);
    const float* xrow = &sm.x[t][g];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t xh[2], xl[2];
      split(xrow[8 * j], xh[0], xl[0]);
      split(xrow[RPX + 8 * j], xh[1], xl[1]);
      mma_3x(o[j], wh, wl, xh, xl);
    }
  }

  const bool pairs = P % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + g + 8 * r;
    if (s >= Q) continue;
    T* yr = y + ((row0 + s) * H + h) * P + p0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * tq;
      if (p >= pn) break;
      if (pairs && p + 1 < pn) {
        chunk_tf32::store2(yr + p, o[j][2 * r], o[j][2 * r + 1]);
      } else {
        st(yr + p, o[j][2 * r]);
        if (p + 1 < pn) st(yr + p + 1, o[j][2 * r + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, void* scratch, void* y,
                   void* state, int B, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  static const cudaError_t setup[2] = {
      cudaFuncSetAttribute(ssd_states_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(StatesSmem)),
      cudaFuncSetAttribute(ssd_output_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(OutSmem))};
  if (setup[0] != cudaSuccess) return setup[0];
  if (setup[1] != cudaSuccess) return setup[1];
  const int nc = S / Q, npb = (P + PB - 1) / PB;
  const dim3 grid(nc * npb, H, B);
  const bool vec_x = P % 4 == 0, vec_n = N % 4 == 0;
  const size_t n_states = (size_t)B * H * nc * P * N;
  float* states = static_cast<float*>(scratch);
  float* segs = states + n_states;
  float* cbs = states + ((n_states + (size_t)B * H * nc + 3) & ~(size_t)3);
  ssd_states_kernel<T><<<grid, NT, sizeof(StatesSmem), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), states, segs, cbs, S, H, P, N, Q, npb,
      vec_x, vec_n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_output_kernel<T><<<grid, NT, sizeof(OutSmem), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(cm), states,
      segs, cbs, static_cast<T*>(y), static_cast<float*>(state), S, H, P, N,
      Q, npb, vec_x, vec_n);
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P]; dt [B,S,H] f32; a_log [H] f32; b, c [B,S,N]; y [B,S,H,P];
// state [B,H,P,N] f32; all contiguous and 16-byte aligned; x, b, c and y
// f32 (bf16 when bf16 is set). scratch, f32, written here (nc = S/Q): the
// chunk states [B,H,nc,P,N], their seg [B,H,nc], then from the next
// multiple of 4 elements C B^T [B,nc,Q,Q] (on and below the diagonal's
// 16 x 16 tiles). 0 < Q <= 128 divides S; 0 < N <= 128. Enqueues two
// kernels; returns the first failed launch's cudaError_t.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, void* scratch,
                          void* y, void* state, int bf16, int B, int S, int H,
                          int P, int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      Q <= 0 || Q > QMAX || S % Q || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(x, dt, a_log, b, c, scratch, y, state,
                                      B, S, H, P, N, Q, st);
  return (int)launch<float>(x, dt, a_log, b, c, scratch, y, state, B, S, H,
                            P, N, Q, st);
}
