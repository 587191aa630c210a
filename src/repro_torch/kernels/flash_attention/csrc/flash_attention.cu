// Causal / sliding-window GQA flash attention over fresh rows, for Hopper
// (sm_90a): the training forward and whole-buffer prefill.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/flash_attention.py, body _kernel).
// q [B,S,N,h] attends to k, v [B,Sk,K,h]; query head n reads KV head
// n / (N/K). Row s sits at position s and key t at position t; with
// `causal` a row sees keys t <= s, with a window (> 0) only keys with
// s - t < window. Scores are q.k in f32 times 1/sqrt(h); the softmax
// state (m, l, acc) is f32; a masked lane carries -1e30 and contributes
// p = 0, and l is clamped at 1e-30 before the division, as in the TPU
// kernel. Besides the output (q's type) it writes each row's log-sum-exp
// m + log(l) in f32, [B,N,S], which the backward reads.
//
// What bounds it on the H100: at smollm-135m's training shape (B=4,
// S=2048, N=9, K=3, h=64) the causal work is 4*B*N*h*S^2/2 = 19.3 GFLOP
// against 38 MB moved in f32 (q, k, v, out once): far past the ridge of
// either type, so operations bound it (0.29 ms at the f32 CUDA-core peak
// of 67 TFLOP/s). This first version sums on the f32 CUDA cores for both
// input types; bf16 tensor-core tiles (mma / wgmma) are the next step.
//
// Design. One block of 256 threads serves one (64-row query tile, query
// head, slot) and walks 64-key blocks in ascending order over the blocks
// the causal or window band leaves live (the rest are skipped, as the TPU
// kernel skips them with pl.when). The query tile and each K/V block are
// staged in shared memory as f32 (rows padded by 4 floats, so the 16-byte
// reads of a quarter warp hit distinct banks). Scores: thread (ty, tx) of
// a 16 x 16 grid holds rows ty + 16i and keys tx + 16j (i, j < 4) in
// registers; a row's 64 keys lie on 16 neighbouring lanes, so its max and
// sum are shuffle reductions and m, l stay in registers. P goes through
// shared memory to the P.V stage, where each thread holds 4 output columns
// of h/16 rows.
#include "../../decode_attention/csrc/decode_tile.cuh"

namespace {

using decode_tile::from_f32;
using decode_tile::NEG_INF;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per block
constexpr int NT = 256;         // threads per block
constexpr int PP = BK + 16;     // padded P row: two rows of a warp land on
                                // opposite halves of the banks

template <int H>
struct Layout {
  static constexpr int RP = H + 4;              // padded q / k row
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * RP;
  static constexpr int V_OFF = K_OFF + BK * RP;
  static constexpr int P_OFF = V_OFF + BK * H;
  static constexpr int C_OFF = P_OFF + BQ * PP;  // corr [BQ]
  static constexpr int L_OFF = C_OFF + BQ;       // l [BQ]
  static constexpr size_t BYTES = 4 * (size_t)(L_OFF + BQ);
};

// Four consecutive elements of a row, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// rows [r0, r0 + R) of a [*, stride] tensor (row r at src + r * stride)
// into dst [R][dp] as f32; rows at or past `limit` are zero
template <int H, int R, typename T>
__device__ __forceinline__ void stage(float* dst, int dp, const T* src,
                                      size_t stride, int r0, int limit) {
  constexpr int C4 = H / 4;
  for (int i = threadIdx.x; i < R * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 x = r0 + r < limit ? load4(src + (size_t)(r0 + r) * stride + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * dp + c) = x;
  }
}

template <int H, typename T>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int S, int Sk, int N, int K, int window, int causal) {
  using Lay = Layout<H>;
  constexpr int RP = Lay::RP;
  constexpr int CG = H / 4;            // 4-column groups of a row
  constexpr int U = BQ * CG / NT;      // rows per thread in the P.V stage
  constexpr int RSTEP = NT / CG;       // ... RSTEP apart
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + Lay::Q_OFF;
  float* k_s = smem + Lay::K_OFF;
  float* v_s = smem + Lay::V_OFF;
  float* p_s = smem + Lay::P_OFF;
  float* corr_s = smem + Lay::C_OFF;
  float* l_s = smem + Lay::L_OFF;

  const int q0 = blockIdx.x * BQ, n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (N / K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float scale = (float)(1.0 / sqrt((double)H));
  const T* qb = q + ((size_t)b * S * N + n) * H;
  const T* kb = k + ((size_t)b * Sk * K + kh) * H;
  const T* vb = v + ((size_t)b * Sk * K + kh) * H;

  // the key blocks live for some row of the tile
  const int nkb = (Sk + BK - 1) / BK;
  int hi = nkb - 1;
  if (causal) hi = min(hi, (min(S, q0 + BQ) - 1) / BK);
  const int lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  stage<H, BQ>(q_s, RP, qb, (size_t)N * H, q0, S);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float4 acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int g = tid % CG, r_b = tid / CG;     // the P.V stage's columns/rows

  for (int kbi = lo; kbi <= hi; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();               // the previous block's P.V is done
    stage<H, BK>(k_s, RP, kb, (size_t)K * H, k0, Sk);
    stage<H, BK>(v_s, H, vb, (size_t)K * H, k0, Sk);
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < H; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * RP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * RP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qa[i].x * ka[j].x + qa[i].y * ka[j].y +
                     qa[i].z * ka[j].z + qa[i].w * ka[j].w;
    }

    // online softmax, a row's 64 keys on 16 neighbouring lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = qpos < S && kpos < Sk && (!causal || kpos <= qpos) &&
                  (window <= 0 || qpos - kpos < window);
        s[i][j] = live[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * PP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
      if (tx == 0) corr_s[r] = corr;
    }
    __syncthreads();

    // acc[r][4g..4g+3] = acc * corr[r] + sum_t p[r][t] * v[t][4g..4g+3]
    float4 pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) pv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = 0; t < BK; t += 4) {
      float4 vt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vt[e] = *reinterpret_cast<const float4*>(v_s + (t + e) * H + 4 * g);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            p_s + (r_b + RSTEP * u) * PP + t);
        const float pe[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[u].x += pe[e] * vt[e].x;
          pv[u].y += pe[e] * vt[e].y;
          pv[u].z += pe[e] * vt[e].z;
          pv[u].w += pe[e] * vt[e].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float c = corr_s[r_b + RSTEP * u];
      acc[u].x = acc[u].x * c + pv[u].x;
      acc[u].y = acc[u].y * c + pv[u].y;
      acc[u].z = acc[u].z * c + pv[u].z;
      acc[u].w = acc[u].w * c + pv[u].w;
    }
  }

  // l and the log-sum-exp of each row
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float lc = fmaxf(l[i], 1e-30f);
      l_s[r] = lc;
      if (q0 + r < S)
        lse[((size_t)b * N + n) * S + q0 + r] = m[i] + logf(lc);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r_b + RSTEP * u;
    if (q0 + r >= S) continue;
    const float inv = 1.f / l_s[r];
    T* o = out + (((size_t)b * S + q0 + r) * N + n) * H + 4 * g;
    o[0] = from_f32<T>(acc[u].x * inv);
    o[1] = from_f32<T>(acc[u].y * inv);
    o[2] = from_f32<T>(acc[u].z * inv);
    o[3] = from_f32<T>(acc[u].w * inv);
  }
}

template <int H, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int Sk, int N, int K, int window,
                   int causal, cudaStream_t stream) {
  const auto kernel = flash_kernel<H, T>;
  constexpr size_t bytes = Layout<H>::BYTES;
  static const cudaError_t setup = decode_tile::allow_smem(kernel, bytes);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((S + BQ - 1) / BQ, N, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, Sk, N, K, window, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(int h, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int S, int Sk, int N, int K,
                     int window, int causal, cudaStream_t stream) {
  switch (h) {
    case 16:
      return launch<16, T>(q, k, v, out, lse, B, S, Sk, N, K, window, causal,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, out, lse, B, S, Sk, N, K, window, causal,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, out, lse, B, S, Sk, N, K, window,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,N,h], k/v [B,Sk,K,h], all contiguous and of one type (f32, or
// bf16 when bf16 != 0); out [B,S,N,h] in that type; lse [B,N,S] f32.
// window <= 0 means none. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int bf16, int B, int S, int Sk, int N,
                                      int K, int h, int window, int causal,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || K <= 0 || N % K != 0 || N > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_h<__nv_bfloat16>(h, q, k, v, out, lse, B, S, Sk, N, K,
                                        window, causal, st);
  return (int)launch_h<float>(h, q, k, v, out, lse, B, S, Sk, N, K, window,
                              causal, st);
}
