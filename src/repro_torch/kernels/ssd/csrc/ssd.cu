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
// f32. S is a multiple of Q (Q <= 128), N <= 128.
//
// What bounds it on the H100: at mamba2-780m's width (H=48, P=64, N=128,
// Q=128) one 640-row prefill moves ~9.9 MB (x and y 3.9 MB each in bf16,
// the state 1.6 MB) against 2.5 GFLOP (10.5 MFLOP per head and chunk, half
// of it C B^T), so bytes bound it at ~3 us with the tensor cores; on the
// f32 CUDA cores used here the operations bound it at ~38 us. Design
// answer, simple first: one block per (b, h, 32 of the P state rows), so
// a batch-1 prefill runs H * P / 32 = 96 blocks; row p of the state reads
// only column p of x, so the P split needs no communication, and each
// block recomputes C B^T for its chunk. A block walks its chunks in order,
// the state in shared memory; per chunk it stages dt and x (as x dt and x
// dt exp(seg - cum)), scans dt * a in one warp, then walks N in tiles of
// 32 columns of B and C (staged transposed, f32): C B^T accumulates in an
// 8 x 8 register tile per thread, C h^T for the inter-chunk term in a 4 x
// 4 tile, and the state's tile is updated once C h^T has read it. C B^T o
// L then goes to shared memory (128 x 132 f32) for the intra-chunk
// product. About 148 KB of shared memory, one block per SM; the masked
// upper triangle of C B^T is computed and dropped. Tensor cores (wgmma),
// TMA staging and a fused decode recurrence are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads: 8 warps
constexpr int QMAX = 128;        // rows of a chunk
constexpr int QP = QMAX + 4;     // padded row of the transposed tiles
constexpr int PB = 32;           // state rows (of P) per block
constexpr int NTILE = 32;        // state columns per staged tile of B, C
constexpr int NMAX = 128;        // largest state size N

struct __align__(16) Smem {
  float cum[QMAX];               // inclusive cumsum of dt * a
  float dt[QMAX];
  float ct[NTILE][QP];           // C tile, transposed: ct[n][s]
  float bt[NTILE][QP];           // B tile, transposed: bt[n][t]
  float xdt[QMAX][PB];           // x * dt
  float u[QMAX][PB];             // x * dt * exp(seg - cum)
  float ht[NMAX][PB];            // the carried state, transposed: ht[n][p]
  float w[QMAX][QP];             // (C B^T) o L
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a_log, const T* __restrict__ bm,
               const T* __restrict__ cm, T* __restrict__ y,
               float* __restrict__ state, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float a = -expf(a_log[h]);
  const int nc = S / Q;
  // C B^T tile of this thread: rows ty + 16 i, columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  // y tile: rows sg + 32 i, state rows 4 pg .. 4 pg + 3
  const int sg = tid / 8, pg = tid % 8;
  // state update: column kk of the N tile, state rows 4 pg .. 4 pg + 3
  const int kk = tid / 8;

  for (int i = tid; i < NMAX * PB; i += NT) (&sm.ht[0][0])[i] = 0.f;

  for (int ch = 0; ch < nc; ++ch) {
    __syncthreads();  // the previous chunk's readers are done
    const long long row0 = (long long)b * S + (long long)ch * Q;
    for (int t = tid; t < QMAX; t += NT)
      sm.dt[t] = t < Q ? dt[(row0 + t) * H + h] : 0.f;
    for (int i = tid; i < QMAX * PB; i += NT) {
      const int t = i / PB, p = i % PB;
      sm.xdt[t][p] = (t < Q && p0 + p < P)
                         ? ld(x + ((row0 + t) * H + h) * P + p0 + p)
                         : 0.f;
    }
    __syncthreads();
    if (tid < 32) {  // rows past Q add 0, so cum stays at seg there
      float v[QMAX / 32];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < QMAX / 32; ++e) {
        run += sm.dt[tid * (QMAX / 32) + e] * a;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < QMAX / 32; ++e)
        sm.cum[tid * (QMAX / 32) + e] = excl + v[e];
    }
    __syncthreads();
    const float seg = sm.cum[Q - 1];
    for (int i = tid; i < QMAX * PB; i += NT) {
      const int t = i / PB, p = i % PB;
      const float xd = sm.xdt[t][p] * sm.dt[t];
      sm.xdt[t][p] = xd;
      sm.u[t][p] = xd * expf(seg - sm.cum[t]);
    }

    float acc[8][8];   // C B^T
    float yo[4][4];    // C h^T, the inter-chunk term before exp(cum)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yo[i][j] = 0.f;

    for (int n0 = 0; n0 < N; n0 += NTILE) {
      for (int i = tid; i < QMAX * NTILE; i += NT) {
        const int t = i / NTILE, n = i % NTILE;
        const bool ok = t < Q && n0 + n < N;
        const long long off = (row0 + t) * N + n0 + n;
        sm.ct[n][t] = ok ? ld(cm + off) : 0.f;
        sm.bt[n][t] = ok ? ld(bm + off) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < NTILE; ++k) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = sm.ct[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sm.bt[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        const float4 hv =
            *reinterpret_cast<const float4*>(&sm.ht[n0 + k][4 * pg]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = sm.ct[k][sg + 32 * i];
          yo[i][0] = fmaf(c, hv.x, yo[i][0]);
          yo[i][1] = fmaf(c, hv.y, yo[i][1]);
          yo[i][2] = fmaf(c, hv.z, yo[i][2]);
          yo[i][3] = fmaf(c, hv.w, yo[i][3]);
        }
      }
      __syncthreads();  // every thread has read this tile of the state
      if (n0 + kk < N) {
        float4 hu = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t = 0; t < Q; ++t) {
          const float bv = sm.bt[kk][t];
          const float4 uv = *reinterpret_cast<const float4*>(&sm.u[t][4 * pg]);
          hu.x = fmaf(uv.x, bv, hu.x);
          hu.y = fmaf(uv.y, bv, hu.y);
          hu.z = fmaf(uv.z, bv, hu.z);
          hu.w = fmaf(uv.w, bv, hu.w);
        }
        const float e = expf(seg);
        float4& hr = *reinterpret_cast<float4*>(&sm.ht[n0 + kk][4 * pg]);
        hr.x = fmaf(hr.x, e, hu.x);
        hr.y = fmaf(hr.y, e, hu.y);
        hr.z = fmaf(hr.z, e, hu.z);
        hr.w = fmaf(hr.w, e, hu.w);
      }
      __syncthreads();  // before the next tile overwrites ct and bt
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = tx + 16 * j;
        sm.w[s][t] = (s >= t && s < Q)
                         ? acc[i][j] * expf(sm.cum[s] - sm.cum[t])
                         : 0.f;
      }
    }
    __syncthreads();
    float yi[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yi[i][j] = 0.f;
    for (int t = 0; t < Q; ++t) {
      const float4 xv = *reinterpret_cast<const float4*>(&sm.xdt[t][4 * pg]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wv = sm.w[sg + 32 * i][t];
        yi[i][0] = fmaf(wv, xv.x, yi[i][0]);
        yi[i][1] = fmaf(wv, xv.y, yi[i][1]);
        yi[i][2] = fmaf(wv, xv.z, yi[i][2]);
        yi[i][3] = fmaf(wv, xv.w, yi[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = sg + 32 * i;
      if (s >= Q) continue;
      const float e = expf(sm.cum[s]);
      T* out = y + ((row0 + s) * H + h) * P + p0 + 4 * pg;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + 4 * pg + j < P) st(out + j, fmaf(e, yo[i][j], yi[i][j]));
    }
  }
  __syncthreads();
  for (int i = tid; i < PB * N; i += NT) {
    const int p = i / N, n = i % N;
    if (p0 + p < P)
      state[(((long long)b * H + h) * P + p0 + p) * N + n] = sm.ht[n][p];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, void* y, void* state,
                   int B, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P]; dt [B,S,H] f32; a_log [H] f32; b, c [B,S,N]; y [B,S,H,P];
// state [B,H,P,N] f32; all contiguous; x, b, c and y f32 (bf16 when bf16
// is set). 0 < Q <= 128 divides S; 0 < N <= 128. Returns the launch's
// cudaError_t.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, void* y, void* state,
                          int bf16, int B, int S, int H, int P, int N, int Q,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > NMAX ||
      Q <= 0 || Q > QMAX || S % Q || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(x, dt, a_log, b, c, y, state, B, S, H,
                                      P, N, Q, st);
  return (int)launch<float>(x, dt, a_log, b, c, y, state, B, S, H, P, N, Q,
                            st);
}
