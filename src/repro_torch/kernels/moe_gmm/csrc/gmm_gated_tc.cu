// The bf16 grouped expert up-projection with its activation on the tensor
// cores, for Hopper (sm_90a): gmm_gated_launch (moe_gmm.cu) hands every
// bf16 launch here; f32 gmm_gated keeps gmm_kernel.
//
// Replaces, for bf16, the TPU kernel gmm_gated
// (src/repro/kernels/moe_gmm/moe_gmm.py, body _gated_kernel):
// h[e] = act(x[e] @ wi[e], x[e] @ wg[e]) over the capacity layout, x
// [E,C,D], wi and wg [E,D,F], h [E,C,F]: f32 sums, the activation on them
// (silu(g) * h, gelu_tanh(g) * h, or gelu_tanh(h) for gelu_plain, which
// reads no wg), one rounding to bf16.
//
// What bounds it on the H100: bytes, and then the tensor cores. Every
// expert's weights stream once per launch: for granite-moe-3b-a800m
// (E=40, D=1536, F=512) 125.8 MB, 0.038 ms at 3.35 TB/s, against 4*C
// operations per weight pair: at C = 160 (the 640-row admission prefill)
// 20.1 GFLOP, 0.020 ms at the bf16 tensor-core peak (~300 us on the f32
// CUDA cores). Design answer, gmm_down_tc.cu's on the same tiles
// (gmm_tc.cuh):
// - Operands swapped: h[e]^T = wi[e]^T x[e]^T, wgmma's M over weight
//   columns and N over capacity rows. A stage of the weight ring is 64
//   deep and 128 columns wide: 64 columns of wi beside the same 64
//   columns of wg, so warpgroup 0 sums h and warpgroup 1 sums g for the
//   same outputs, each one m64nN accumulator (NP / 2 f32 registers a
//   thread: 128 at NP = 256, where one thread holding both would need
//   256). The two meet once, in the epilogue, through shared memory (16
//   KB a 64-row slab, written and read in fragment order). gelu_plain
//   has one product: both warpgroups take wi, 128 output columns a block.
// - One streaming kernel: one block per (output-column tile, expert, pass
//   of NP rows), x staged beside the weights through the cp.async ring (3
//   stages for NP <= 64, so that three blocks share an SM and a decode
//   launch's 320 blocks run in one wave; else 4), in wgmma's 128-byte-
//   swizzled K-major layout, which the tensor cores read without bank
//   conflicts. NP (32, 64, 128, 160 or 256: wgmma's N) is the smallest
//   that holds C, chosen by the wrapper (ops.gated_rows), so a launch
//   with C <= 256 reads each weight byte exactly once: decode at 8 slots
//   (C = 2), 128-row chunks (C = 32) and the admission prefill (C =
//   160). x is read once a column tile, through the L2 (a column tile's
//   blocks of one expert run side by side).
// - Every output's sum runs in one block, in one fixed order: no split of
//   D across blocks, no atomics, so a result is the same on every call.
//   Rows past C and columns past F are zeros in the tiles and never
//   written (D and F need only be multiples of 8).
// Measured (chip_smoke.py, phase 6, NVIDIA H100 80GB HBM3 at 700 W; three
// weight sets in turn, calls replayed from a CUDA graph): 0.0477 / 0.0483
// / 0.1038 ms at C = 2 / 32 / 160, 1.27 / 1.24 / 2.29x the byte bound; at
// C = 160 each of an expert's 8 column tiles reads x again.
#include "gmm_tc.cuh"

namespace {

using namespace gmm_tc;

// ring stages: 3 for C <= 64 (three blocks an SM at C <= 32, so the
// 320 blocks of a decode launch run in one wave), else 4
template <int NP>
__host__ __device__ constexpr int stages() {
  return NP <= 64 ? 3 : STAGES;
}

template <int EPI, int NP>
__global__ void __launch_bounds__(NT) gmm_gated_stream_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wi,
    const bf16* __restrict__ wg, bf16* __restrict__ h, int C, int D,
    int F) {
  constexpr bool PAIR = EPI != EPI_GELU_PLAIN;
  constexpr int BO = PAIR ? BM / 2 : BM;       // output columns a block
  constexpr int SB = stage_elems<NP, true>();
  static_assert(SB * sizeof(bf16) >= 128 * 32 * 4 && stages<NP>() >= 2 &&
                    SB * sizeof(bf16) % 1024 == 0,
                "the gated epilogue stages through two ring slots; the "
                "swizzled x tiles are 1024-byte aligned");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int f0 = blockIdx.x * BO, e = blockIdx.y, c0 = blockIdx.z * NP;
  const int rows = min(NP, C - c0);
  const size_t woff = (size_t)e * D * F;
  float acc[NP / 2];
  stream_sum<NP, PAIR, true, stages<NP>()>(
      acc, ring, wi + woff, wg + woff, x + ((size_t)e * C + c0) * D, rows,
      f0, D, F);
  bf16* he = h + (size_t)e * C * F;
  if constexpr (PAIR)
    store_gated<NP, EPI>(acc, reinterpret_cast<float*>(ring), ring + SB, he,
                         c0, rows, f0, F);
  else
    store_y<NP>(acc, ring, he, c0, rows, f0, F, Single<EPI>());
}

template <int EPI, int NP>
cudaError_t stream(const void* x, const void* wi, const void* wg, void* h,
                   int E, int C, int D, int F, cudaStream_t st) {
  constexpr int BO = EPI != EPI_GELU_PLAIN ? BM / 2 : BM;
  const auto kernel = gmm_gated_stream_kernel<EPI, NP>;
  constexpr size_t bytes = stream_bytes<NP, true, stages<NP>()>();
  static const cudaError_t setup = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (setup != cudaSuccess) return setup;
  const int passes = (C + NP - 1) / NP;
  if (passes > 65535) return cudaErrorInvalidValue;
  const dim3 grid((F + BO - 1) / BO, E, passes);
  kernel<<<grid, NT, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wi),
      static_cast<const bf16*>(wg), static_cast<bf16*>(h), C, D, F);
  return cudaGetLastError();
}

// rows per pass: the instantiations ops.GATED_ROWS lists
template <int EPI>
cudaError_t by_rows(int np, const void* x, const void* wi, const void* wg,
                    void* h, int E, int C, int D, int F, cudaStream_t st) {
  switch (np) {
    case 32: return stream<EPI, 32>(x, wi, wg, h, E, C, D, F, st);
    case 64: return stream<EPI, 64>(x, wi, wg, h, E, C, D, F, st);
    case 128: return stream<EPI, 128>(x, wi, wg, h, E, C, D, F, st);
    case 160: return stream<EPI, 160>(x, wi, wg, h, E, C, D, F, st);
    case 256: return stream<EPI, 256>(x, wi, wg, h, E, C, D, F, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [E,C,D]; wi, wg [E,D,F]; h [E,C,F]; bf16, contiguous, 16-byte
// aligned; D and F multiples of 8; act 0 silu, 1 gelu, 2 gelu_plain (wg
// not read); rows: the rows of C a block covers (32, 64, 128, 160 or 256),
// ceil(C / rows) passes over the weights. Returns the launch's
// cudaError_t.
cudaError_t gmm_gated_tc_launch(const void* x, const void* wi,
                                const void* wg, void* h, int act, int E,
                                int C, int D, int F, int rows,
                                cudaStream_t st) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 || E > 65535)
    return cudaErrorInvalidValue;
  switch (act) {
    case EPI_SILU:
      return by_rows<EPI_SILU>(rows, x, wi, wg, h, E, C, D, F, st);
    case EPI_GELU:
      return by_rows<EPI_GELU>(rows, x, wi, wg, h, E, C, D, F, st);
    case EPI_GELU_PLAIN:
      return by_rows<EPI_GELU_PLAIN>(rows, x, wi, wi, h, E, C, D, F, st);
    default:
      return cudaErrorInvalidValue;
  }
}
