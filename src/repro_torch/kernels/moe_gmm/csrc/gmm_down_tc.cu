// The bf16 grouped expert down-projection on the tensor cores, for Hopper
// (sm_90a): gmm_down_launch (moe_gmm.cu) hands every bf16 launch here;
// f32 gmm_down keeps gmm_kernel. The tiles, the ring and the epilogue are
// gmm_tc.cuh's, shared with the bf16 gmm_gated (gmm_gated_tc.cu).
//
// Replaces, for bf16, the TPU kernel gmm_down
// (src/repro/kernels/moe_gmm/moe_gmm.py, body _down_kernel):
// y[e] = h[e] @ wo[e] over the capacity layout, h [E,C,F], wo [E,F,D],
// y [E,C,D], f32 sums rounded to bf16.
//
// What bounds it on the H100: bytes. Every expert's weights stream once
// per launch: for granite-moe-3b-a800m (E=40, F=512, D=1536) 62.9 MB,
// 0.019 ms at 3.35 TB/s, against 2*C operations per weight element, C
// per byte: at the served C = 2, 32 and 160 at most 160, below the bf16
// ridge (~295), and the weights (189 MB a layer with gmm_gated's) do not
// stay in the 50 MB L2 between launches. At C = 160 the output (19.7 MB)
// and h (6.5 MB) add a third. Design answer:
// - Operands swapped: y[e]^T = wo[e]^T h[e]^T. A block owns 128 columns
//   of wo at a time (wgmma's M, 64 a warpgroup; the A fragments come from
//   wo's rows, M-contiguous, through ldmatrix.trans) and every capacity
//   row of its pass (wgmma's N, one m64nNk16 per 16-deep step, B read
//   from shared memory through a descriptor), so a launch with C <= 256
//   reads each weight byte exactly once (C = 160, the 640-row admission
//   prefill, in one pass where gmm_kernel took five).
// - The weights arrive by cp.async into a 4-stage ring of 64-deep tiles,
//   unpadded, 16-byte chunks XOR-swizzled by row against ldmatrix bank
//   conflicts; h in planes of 8 contraction columns, the core-matrix
//   layout wgmma reads without swizzle.
// - Two kernels. Streaming (C <= 64, and shapes whose h does not fit):
//   one block per (128-column tile, expert, pass), h staged beside the
//   weights (decode at 8 slots: C = 2, 480 blocks). Resident (64 < C <=
//   256 where h[e] fits beside the ring: granite's C = 160): one block per
//   (expert, run of column tiles), about one an SM; h[e] is copied once
//   and serves every tile of the run, so h is not read again through L2
//   for each of the expert's 12 column tiles; a stage's products stay in
//   flight while the next stage's are issued.
// - Every output's sum runs in one block, in one fixed order: no split
//   of F across blocks, no atomics, so a result is the same on every
//   call. The sums go out through a free ring slot, 64 rows at a time,
//   as 16-byte stores; rows past C and columns past D are zeros in the
//   tiles and never written (D and F need only be multiples of 8).
#include "gmm_tc.cuh"

namespace {

using namespace gmm_tc;

// Streaming: one block per (column tile, expert, pass of NP rows); the
// weights and h stage by stage through a 4-stage ring.
template <int NP>
__global__ void __launch_bounds__(NT) gmm_down_stream_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wo,
    bf16* __restrict__ y, int C, int F, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int d0 = blockIdx.x * BM, e = blockIdx.y, c0 = blockIdx.z * NP;
  const int rows = min(NP, C - c0);
  const bf16* we = wo + (size_t)e * F * D;
  float acc[NP / 2];
  stream_sum<NP, false>(acc, ring, we, we, h + ((size_t)e * C + c0) * F,
                        rows, d0, F, D);
  store_y<NP>(acc, ring, y + (size_t)e * C * D, c0, rows, d0, D);
}

// Resident h: one block per (expert, run of `tiles` column tiles); h[e]
// is copied once, beside the first tile's weight stages, and the weights
// stream through the ring two stages ahead. A step's products stay in
// flight while the next step's are issued, so the slot a step reads is
// reloaded two steps later and the A fragments alternate between two sets.
template <int NP>
constexpr size_t res_bytes(int nk) {
  return ((size_t)nk * 8 * plane(NP) + STAGES * W_TILE) * sizeof(bf16);
}

template <int NP>
__global__ void __launch_bounds__(NT) gmm_down_res_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wo,
    bf16* __restrict__ y, int C, int F, int D, int tiles) {
  static_assert(STAGES >= 4 && BK >= 64, "store_y stages through a slot");
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = blockIdx.y;
  const int nk = (F + BK - 1) / BK;
  const int ct0 = blockIdx.x * tiles;
  const int steps = (min((D + BM - 1) / BM, ct0 + tiles) - ct0) * nk;
  const bf16* he = h + (size_t)e * C * F;
  const bf16* we = wo + (size_t)e * F * D;
  bf16* hres = reinterpret_cast<bf16*>(smem);  // nk * 8 planes
  bf16* ring = hres + (size_t)nk * 8 * plane(NP);
  auto load = [&](int t) {
    const int k0 = (t % nk) * BK;
    load_w<false>(ring + (t % STAGES) * W_TILE, we, we, k0,
                  (ct0 + t / nk) * BM, F, D);
    if (t < nk)
      load_act<NP>(hres + (size_t)(k0 / 8) * plane(NP), he, k0, C, F);
  };

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < steps) load(s);
    tc::cp_async_commit();
  }
  auto step = [&](int t, uint32_t (&a)[BK / 16][4]) {
    tc::cp_async_wait<STAGES - 3>();           // step t's tiles arrived
    tc::fence_proxy_async();                   // ... for wgmma's reads
    __syncthreads();                           // step t-2's slot is free
    if (t + STAGES - 2 < steps) load(t + STAGES - 2);
    tc::cp_async_commit();
    const int kt = t % nk;
    bf16* ws = ring + (t % STAGES) * W_TILE;
    load_a(a, ws);
    mma_stage<NP>(acc, a, hres + (size_t)kt * 8 * plane(NP));
    if (kt != nk - 1) {
      tc::wgmma_wait<1>();                     // step t-1's are done
      return;
    }
    tc::wgmma_wait<0>();                       // the column tile is summed
    // out through the slot step t read: free until step t+2 reloads it
    store_y<NP>(acc, ws, y + (size_t)e * C * D, 0, C,
                (ct0 + t / nk) * BM, D);
  };
  uint32_t a0[BK / 16][4], a1[BK / 16][4];
  int t = 0;
  for (; t + 1 < steps; t += 2) {
    step(t, a0);
    step(t + 1, a1);
  }
  if (t < steps) step(t, a0);
  tc::wgmma_wait<0>();
  tc::cp_async_wait<0>();
}

int multiprocessors() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int NP>
cudaError_t stream(const void* h, const void* wo, void* y, int E, int C,
                   int F, int D, cudaStream_t st) {
  const auto kernel = gmm_down_stream_kernel<NP>;
  constexpr size_t bytes = stream_bytes<NP>();
  static const cudaError_t setup = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (setup != cudaSuccess) return setup;
  const int passes = (C + NP - 1) / NP;
  if (passes > 65535) return cudaErrorInvalidValue;
  const dim3 grid((D + BM - 1) / BM, E, passes);
  kernel<<<grid, NT, bytes, st>>>(static_cast<const bf16*>(h),
                                  static_cast<const bf16*>(wo),
                                  static_cast<bf16*>(y), C, F, D);
  return cudaGetLastError();
}

// about one block an SM: an expert's column tiles split into runs
template <int NP>
cudaError_t resident(const void* h, const void* wo, void* y, int E, int C,
                     int F, int D, cudaStream_t st) {
  const auto kernel = gmm_down_res_kernel<NP>;
  static const cudaError_t setup = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (setup != cudaSuccess) return setup;
  static const int sms = multiprocessors();
  const int ntd = (D + BM - 1) / BM;
  const int per_e = max(1, sms / E);           // blocks an expert
  const int tiles = (ntd + per_e - 1) / per_e;
  const dim3 grid((ntd + tiles - 1) / tiles, E, 1);
  kernel<<<grid, NT, res_bytes<NP>((F + BK - 1) / BK), st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wo),
      static_cast<bf16*>(y), C, F, D, tiles);
  return cudaGetLastError();
}

}  // namespace

// h [E,C,F]; wo [E,F,D]; y [E,C,D]; bf16, contiguous, 16-byte aligned; D
// and F multiples of 8. C <= 64 streams h with the weights (32 or 64
// rows); 64 < C <= 256 keeps h[e] resident when it fits beside the ring
// (granite's F = 512: C <= 160); otherwise passes of 256 rows stream.
// Returns the launch's cudaError_t.
cudaError_t gmm_down_tc_launch(const void* h, const void* wo, void* y, int E,
                               int C, int F, int D, cudaStream_t st) {
  if (E <= 0 || C <= 0 || F <= 0 || D <= 0 || F % 8 || D % 8 || E > 65535)
    return cudaErrorInvalidValue;
  if (C <= 32) return stream<32>(h, wo, y, E, C, F, D, st);
  if (C <= 64) return stream<64>(h, wo, y, E, C, F, D, st);
  const int nsl = (C + 31) / 32, nk = (F + BK - 1) / BK;
  if (C <= NMAX &&
      ((size_t)nk * 8 * plane(32 * nsl) + STAGES * W_TILE) * sizeof(bf16) <=
          SMEM_MAX) {
    switch (nsl) {
      case 3: return resident<96>(h, wo, y, E, C, F, D, st);
      case 4: return resident<128>(h, wo, y, E, C, F, D, st);
      case 5: return resident<160>(h, wo, y, E, C, F, D, st);
      case 6: return resident<192>(h, wo, y, E, C, F, D, st);
      case 7: return resident<224>(h, wo, y, E, C, F, D, st);
      default: return resident<256>(h, wo, y, E, C, F, D, st);
    }
  }
  return stream<NMAX>(h, wo, y, E, C, F, D, st);
}
