// Grouped expert MLP of the MoE FFN, for Hopper (sm_90a): the C entries
// of both kernels, and the f32 kernel.
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
// (160 per byte), below the bf16 ridge (~295), and the weights (189 MB a
// layer) do not stay in the 50 MB L2 between launches.
//
// bf16 runs on the tensor cores, each weight byte read once per launch
// for C <= 256 through a 4-stage cp.async weight ring (gmm_tc.cuh):
// gmm_gated in gmm_gated_tc.cu, gmm_down in gmm_down_tc.cu. f32 (the
// reduced models' type on the card) takes gmm_kernel below, on the f32
// CUDA cores, which keeps the f32 function exact. Its design: one block
// per (expert, 64-column tile of the output, 32-row tile of C); it walks
// the contraction axis in 64-deep shared-memory tiles with f32 sums in
// registers, so a launch with C <= 32 reads every weight byte exactly
// once; C > 32 takes ceil(C / 32) passes over the weights. Loads are 16
// bytes a thread, neighbouring threads on neighbouring columns of w; the
// next tile's loads are issued into registers before the current tile is
// computed. A ragged C (and any width that is a multiple of 8) is masked
// here: rows past C are zeros in shared memory and are never written.
// Each thread owns two columns and four rows (warp w holds rows w, w+8,
// w+16, w+24, so a warp whose rows all lie past C skips the arithmetic).
#include "gmm_tc.cuh"

namespace {

using gmm_tc::epilogue;
using gmm_tc::EPI_GELU;
using gmm_tc::EPI_GELU_PLAIN;
using gmm_tc::EPI_NONE;
using gmm_tc::EPI_SILU;

constexpr int NT = 256;             // threads: 8 warps
constexpr int BN = 64;              // output columns per block
constexpr int BC = 32;              // rows of C per block
constexpr int BK = 64;              // contraction depth per tile
constexpr int V = 4;                // f32 elements in 16 bytes
constexpr int RG = NT / (BN / 2);   // row groups (one per warp): 8
constexpr int RPT = BC / RG;        // rows per thread: 4

// x [E,C,Kd]; w0 (and w1 when gated) [E,Kd,N]; out [E,C,N]
template <int EPI>
__global__ void __launch_bounds__(NT) gmm_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ w1, float* __restrict__ out, int C, int Kd,
    int N) {
  constexpr int NW = (EPI == EPI_SILU || EPI == EPI_GELU) ? 2 : 1;
  constexpr int WCH = BK * BN / V / NT;   // weight chunks a thread loads
  constexpr int XCH = BC * BK / V / NT;   // x chunks a thread loads
  __shared__ __align__(16) float xs[BC][BK];
  __shared__ __align__(16) float ws[NW][BK][BN];

  const int e = blockIdx.y, n0 = blockIdx.x * BN, c0 = blockIdx.z * BC;
  const int t = threadIdx.x;
  const int rows = min(BC, C - c0);
  const float* xe = x + ((size_t)e * C + c0) * Kd;
  const float* we[2] = {w0 + (size_t)e * Kd * N, w1 + (size_t)e * Kd * N};

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
      *reinterpret_cast<uint4*>(&xs[j / (BK / V)][(j % (BK / V)) * V]) =
          xr[i];
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
            const float2 w =
                *reinterpret_cast<const float2*>(&ws[m][kk + s][2 * cp]);
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
      *reinterpret_cast<float2*>(out + ((size_t)e * C + c0 + r) * N + col) =
          make_float2(a, b);
    }
  }
}

template <int EPI>
cudaError_t launch(const void* x, const void* w0, const void* w1, void* out,
                   int E, int C, int Kd, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, E, (C + BC - 1) / BC);
  gmm_kernel<EPI><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<float*>(out), C, Kd, N);
  return cudaGetLastError();
}

// the f32 kernel for an epilogue
int dispatch_f32(int epi, const void* x, const void* w0, const void* w1,
                 void* out, int E, int C, int Kd, int N, void* stream) {
  if (E <= 0 || C <= 0 || Kd <= 0 || N <= 0 || Kd % 8 || N % 8 ||
      C > 65535 * BC || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case EPI_SILU:
      return (int)launch<EPI_SILU>(x, w0, w1, out, E, C, Kd, N, st);
    case EPI_GELU:
      return (int)launch<EPI_GELU>(x, w0, w1, out, E, C, Kd, N, st);
    case EPI_GELU_PLAIN:
      return (int)launch<EPI_GELU_PLAIN>(x, w0, w0, out, E, C, Kd, N, st);
    case EPI_NONE:
      return (int)launch<EPI_NONE>(x, w0, w0, out, E, C, Kd, N, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// defined in gmm_gated_tc.cu and gmm_down_tc.cu
cudaError_t gmm_gated_tc_launch(const void* x, const void* wi,
                                const void* wg, void* h, int act, int E,
                                int C, int D, int F, int rows,
                                cudaStream_t stream);
cudaError_t gmm_down_tc_launch(const void* h, const void* wo, void* y, int E,
                               int C, int F, int D, cudaStream_t stream);

// x [E,C,D]; wi, wg [E,D,F]; h [E,C,F]; all contiguous, 16-byte aligned,
// f32 (bf16 when bf16 is set); act 0 silu, 1 gelu, 2 gelu_plain (wg not
// read); D and F multiples of 8; rows: bf16's rows of C a block covers
// (ops.gated_rows; f32 does not read it). Returns the launch's
// cudaError_t.
extern "C" int gmm_gated_launch(const void* x, const void* wi,
                                const void* wg, void* h, int bf16, int act,
                                int E, int C, int D, int F, int rows,
                                void* stream) {
  if (act < EPI_SILU || act > EPI_GELU_PLAIN)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)gmm_gated_tc_launch(x, wi, wg, h, act, E, C, D, F, rows,
                                    static_cast<cudaStream_t>(stream));
  return dispatch_f32(act, x, wi, wg, h, E, C, D, F, stream);
}

// h [E,C,F]; wo [E,F,D]; y [E,C,D]; as above.
extern "C" int gmm_down_launch(const void* h, const void* wo, void* y,
                               int bf16, int E, int C, int F, int D,
                               void* stream) {
  if (bf16)
    return (int)gmm_down_tc_launch(h, wo, y, E, C, F, D,
                                   static_cast<cudaStream_t>(stream));
  return dispatch_f32(EPI_NONE, h, wo, wo, y, E, C, F, D, stream);
}
