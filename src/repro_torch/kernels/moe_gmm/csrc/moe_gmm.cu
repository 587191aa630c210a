// Grouped expert MLP of the MoE FFN, for Hopper (sm_90a).
//
// Replaces the TPU kernels gmm_gated and gmm_down
// (src/repro/kernels/moe_gmm/moe_gmm.py, bodies _gated_kernel and
// _down_kernel). Over the capacity layout of the dispatch, x [E,C,D]:
//   gmm_gated: h[e] = act(x[e] @ wi[e], x[e] @ wg[e]) -> [E,C,F], f32 sums,
//              the activation on them (silu(g)*h, gelu_tanh(g)*h, or
//              gelu_tanh(h) for gelu_plain, which reads no wg), rounded to
//              x's type;
//   gmm_down:  y[e] = h[e] @ wo[e] -> [E,C,D], f32 sums, in h's type.
// x and the weights share one type, f32 or bf16.
//
// What bounds it on the H100: bytes. Every expert's weights stream once
// per launch (the dispatch fills every expert's C slots, used or not):
// for granite-moe-3b-a800m (E=40, D=1536, F=512, bf16) gmm_gated reads
// 125.8 MB (0.038 ms at 3.35 TB/s) and gmm_down 62.9 MB (0.019 ms),
// against 2*C (gated: 4*C) operations per weight element: at the served
// C = 2, 32 and 160 that is at most ~320 operations per weight element
// (160 per byte), below the bf16 ridge (~295 per byte), and the weights
// (189 MB a layer) do not stay in the 50 MB L2 between launches.
//
// bf16 gmm_down runs on the tensor cores (gmm_down_tc.cu: each weight
// byte read once per launch for C <= 256, a 4-stage cp.async weight ring,
// wgmma); the rest (gmm_gated in both types, f32 gmm_down) take
// gmm_kernel below. Its design: one block per (expert, 64-column tile of the
// output, 32-row tile of C); it walks the contraction axis in 64-deep
// shared-memory tiles with f32 sums in registers, so a launch with C <= 32
// (decode at 8 slots: C = 2; a 128-row chunk: C = 32) reads every weight
// byte exactly once; C > 32 takes ceil(C / 32) passes over the weights
// (C = 160, an admission prefill of 640 rows: 5 passes). The grid is
// column tiles x experts x row tiles (gmm_gated at decode: 8 x 40 = 320
// blocks on 132 SMs). Loads are 16 bytes a thread, neighbouring threads on
// neighbouring columns of w; the next tile's loads are issued into
// registers before the current tile is computed. A ragged C (and any
// width that is a multiple of 8) is masked here: rows past C are zeros in
// shared memory and are never written. Each thread owns two columns and
// four rows (warp w holds rows w, w+8, w+16, w+24, so a warp whose rows
// all lie past C skips the arithmetic); the sums run on the f32 CUDA
// cores, which set a floor of ~0.30 ms per gmm_gated launch at C = 160
// (20.1 GFLOP at 67 TFLOP/s). For gmm_gated, tensor cores and a deeper
// weight pipeline are later work (gmm_down_tc.cu's tile is the model).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads: 8 warps
constexpr int BN = 64;              // output columns per block
constexpr int BC = 32;              // rows of C per block
constexpr int BK = 64;              // contraction depth per tile
constexpr int RG = NT / (BN / 2);   // row groups (one per warp): 8
constexpr int RPT = BC / RG;        // rows per thread: 4

enum Epi { EPI_SILU = 0, EPI_GELU = 1, EPI_GELU_PLAIN = 2, EPI_NONE = 3 };

template <typename T>
struct Chunk;                       // elements in 16 bytes
template <>
struct Chunk<float> {
  static constexpr int N = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one 16-byte chunk of x as f32 into shared memory
__device__ __forceinline__ void stash_x(float* dst, uint4 c, float) {
  *reinterpret_cast<uint4*>(dst) = c;
}
__device__ __forceinline__ void stash_x(float* dst, uint4 c, __nv_bfloat16) {
  // a 32-bit word holds two bf16: element 0 in the low half
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

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

// x [E,C,Kd]; w0 (and w1 when gated) [E,Kd,N]; out [E,C,N]
template <typename T, int EPI>
__global__ void __launch_bounds__(NT) gmm_kernel(const T* __restrict__ x,
                                                 const T* __restrict__ w0,
                                                 const T* __restrict__ w1,
                                                 T* __restrict__ out, int C,
                                                 int Kd, int N) {
  constexpr int V = Chunk<T>::N;
  constexpr int NW = (EPI == EPI_SILU || EPI == EPI_GELU) ? 2 : 1;
  constexpr int WCH = BK * BN / V / NT;   // weight chunks a thread loads
  constexpr int XCH = BC * BK / V / NT;   // x chunks a thread loads
  __shared__ __align__(16) float xs[BC][BK];
  __shared__ __align__(16) T ws[NW][BK][BN];

  const int e = blockIdx.y, n0 = blockIdx.x * BN, c0 = blockIdx.z * BC;
  const int t = threadIdx.x;
  const int rows = min(BC, C - c0);
  const T* xe = x + ((size_t)e * C + c0) * Kd;
  const T* we[2] = {w0 + (size_t)e * Kd * N, w1 + (size_t)e * Kd * N};

  uint4 wr[NW][WCH], xr[XCH];
  auto load = [&](int k0) {
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int i = 0; i < WCH; ++i) {
        const int j = t + i * NT;
        const int r = j / (BN / V), cc = (j % (BN / V)) * V;
        wr[m][i] = (k0 + r < Kd && n0 + cc < N)
                       ? __ldg(reinterpret_cast<const uint4*>(
                             we[m] + (size_t)(k0 + r) * N + n0 + cc))
                       : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int j = t + i * NT;
      const int r = j / (BK / V), cc = (j % (BK / V)) * V;
      xr[i] = (r < rows && k0 + cc < Kd)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        xe + (size_t)r * Kd + k0 + cc))
                  : make_uint4(0, 0, 0, 0);
    }
  };

  const int cp = t % (BN / 2);   // this thread's column pair
  const int rg = t / (BN / 2);   // its row group = its warp
  float acc[NW][RPT][2];
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[m][i][0] = acc[m][i][1] = 0.f;

  load(0);
  for (int k0 = 0; k0 < Kd; k0 += BK) {
    __syncthreads();   // the previous tile is consumed
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int i = 0; i < WCH; ++i) {
        const int j = t + i * NT;
        *reinterpret_cast<uint4*>(&ws[m][j / (BN / V)][(j % (BN / V)) * V]) =
            wr[m][i];
      }
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int j = t + i * NT;
      stash_x(&xs[j / (BK / V)][(j % (BK / V)) * V], xr[i], T());
    }
    __syncthreads();
    if (k0 + BK < Kd) load(k0 + BK);   // in flight while this tile runs
    if (rg < rows) {                   // warp-uniform
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        float xv[RPT][4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[rg + RG * i][kk]);
          xv[i][0] = v.x;
          xv[i][1] = v.y;
          xv[i][2] = v.z;
          xv[i][3] = v.w;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int m = 0; m < NW; ++m) {
            const float2 w = load_pair(&ws[m][kk + s][2 * cp]);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              acc[m][i][0] = fmaf(xv[i][s], w.x, acc[m][i][0]);
              acc[m][i][1] = fmaf(xv[i][s], w.y, acc[m][i][1]);
            }
          }
        }
      }
    }
  }

  const int col = n0 + 2 * cp;
  if (rg >= rows || col >= N) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r < rows) {
      const float a = epilogue<EPI>(acc[0][i][0], acc[NW - 1][i][0]);
      const float b = epilogue<EPI>(acc[0][i][1], acc[NW - 1][i][1]);
      store_pair(out + ((size_t)e * C + c0 + r) * N + col, a, b);
    }
  }
}

template <typename T, int EPI>
cudaError_t launch(const void* x, const void* w0, const void* w1, void* out,
                   int E, int C, int Kd, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, E, (C + BC - 1) / BC);
  gmm_kernel<T, EPI><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<T*>(out), C, Kd, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_epi(int epi, const void* x, const void* w0,
                       const void* w1, void* out, int E, int C, int Kd, int N,
                       cudaStream_t stream) {
  switch (epi) {
    case EPI_SILU:
      return launch<T, EPI_SILU>(x, w0, w1, out, E, C, Kd, N, stream);
    case EPI_GELU:
      return launch<T, EPI_GELU>(x, w0, w1, out, E, C, Kd, N, stream);
    case EPI_GELU_PLAIN:
      return launch<T, EPI_GELU_PLAIN>(x, w0, w0, out, E, C, Kd, N, stream);
    case EPI_NONE:
      return launch<T, EPI_NONE>(x, w0, w0, out, E, C, Kd, N, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int bf16, int epi, const void* x, const void* w0,
             const void* w1, void* out, int E, int C, int Kd, int N,
             void* stream) {
  if (E <= 0 || C <= 0 || Kd <= 0 || N <= 0 || Kd % 8 || N % 8 ||
      C > 65535 * BC || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_epi<__nv_bfloat16>(epi, x, w0, w1, out, E, C, Kd, N,
                                          st);
  return (int)launch_epi<float>(epi, x, w0, w1, out, E, C, Kd, N, st);
}

}  // namespace

// x [E,C,D]; wi, wg [E,D,F]; h [E,C,F]; all contiguous, 16-byte aligned,
// f32 (bf16 when bf16 is set); act 0 silu, 1 gelu, 2 gelu_plain (wg not
// read); D and F multiples of 8. Returns the launch's cudaError_t.
extern "C" int gmm_gated_launch(const void* x, const void* wi,
                                const void* wg, void* h, int bf16, int act,
                                int E, int C, int D, int F, void* stream) {
  if (act < EPI_SILU || act > EPI_GELU_PLAIN)
    return (int)cudaErrorInvalidValue;
  return dispatch(bf16, act, x, wi, wg, h, E, C, D, F, stream);
}

// defined in gmm_down_tc.cu
cudaError_t gmm_down_tc_launch(const void* h, const void* wo, void* y, int E,
                               int C, int F, int D, cudaStream_t stream);

// h [E,C,F]; wo [E,F,D]; y [E,C,D]; as above.
extern "C" int gmm_down_launch(const void* h, const void* wo, void* y,
                               int bf16, int E, int C, int F, int D,
                               void* stream) {
  if (bf16)
    return (int)gmm_down_tc_launch(h, wo, y, E, C, F, D,
                                   static_cast<cudaStream_t>(stream));
  return dispatch(bf16, EPI_NONE, h, wo, wo, y, E, C, F, D, stream);
}
