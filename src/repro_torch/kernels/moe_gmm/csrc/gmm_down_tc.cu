// The bf16 grouped expert down-projection on the tensor cores, for Hopper
// (sm_90a): gmm_down_launch (moe_gmm.cu) hands every bf16 launch here;
// f32 gmm_down and both types of gmm_gated keep gmm_kernel.
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
#include "../../chunk_prefill/csrc/tc_util.cuh"
#include "../../chunk_prefill/csrc/wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;          // threads: two warpgroups
constexpr int BM = 128;          // columns of wo per tile: 64 a warpgroup
constexpr int BK = 64;           // contraction depth per stage
constexpr int NMAX = 256;        // capacity rows per pass
constexpr int STAGES = 4;        // weight ring
constexpr size_t SMEM_MAX = 232448;          // a block's opt-in maximum
constexpr size_t W_TILE = (size_t)BK * BM;   // elements of a weight stage

// h as planes of 8 contraction columns, [np + 1][8] each (the spare row
// puts the 8 planes a warp's 16-byte copies hit on distinct banks)
__host__ __device__ constexpr int plane(int np) { return (np + 1) * 8; }

// the weight tile rows k0 .. k0+63, columns d0 .. d0+127, 16-byte chunk c
// of row r at chunk c ^ (r % 8): the 8 rows an ldmatrix reads fall on
// distinct banks; past F or D, zeros
__device__ __forceinline__ void load_w(bf16* ws, const bf16* we, int k0,
                                       int d0, int F, int D) {
  for (int c = threadIdx.x; c < BK * BM / 8; c += NT) {
    const int r = c / (BM / 8), ch = c % (BM / 8);
    const bool ok = k0 + r < F && d0 + ch * 8 < D;
    tc::cp_async16(ws + r * BM + (ch ^ (r & 7)) * 8,
                   ok ? we + (size_t)(k0 + r) * D + d0 + ch * 8 : we, ok);
  }
}

// h rows 0 .. np-1, contraction columns k0 .. k0+63, into the 8 planes
// from hp; rows past `rows` and columns past F are zeros
template <int NP>
__device__ __forceinline__ void load_h(bf16* hp, const bf16* he, int k0,
                                       int rows, int F) {
  for (int c = threadIdx.x; c < NP * (BK / 8); c += NT) {
    const int r = c >> 3, k8 = c & 7;
    const bool ok = r < rows && k0 + k8 * 8 < F;
    tc::cp_async16(hp + k8 * plane(NP) + r * 8,
                   ok ? he + (size_t)r * F + k0 + k8 * 8 : he, ok);
  }
}

// the weights as wgmma A fragments: warp wq of group wg takes columns
// wg * 64 + wq * 16 .. +15, for each 16-deep step of the stage
__device__ __forceinline__ void load_a(uint32_t (&a)[BK / 16][4],
                                       const bf16* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = warp * 2 + ((lane >> 3) & 1);   // (wg*64 + wq*16) / 8
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    tc::ldsm_x4_trans(a[ks], ws + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                      BM +
                                  (ch ^ (lane & 7)) * 8);
}

// the stage's products: acc += W^T (a) x h^T (the planes from hp)
template <int NP>
__device__ __forceinline__ void mma_stage(float* acc,
                                          const uint32_t (&a)[BK / 16][4],
                                          const bf16* hp) {
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    tc::Wgmma<NP>::run(acc, a[ks],
                       tc::wgmma_desc(hp + 2 * ks * plane(NP),
                                      plane(NP) * 2, 128));
  tc::wgmma_commit();
}

// y rows c0 .. c0+rows-1, columns d0 .. d0+127 from the sums, zeroing
// them; through ys (64 x 128 elements of shared memory, no longer read),
// 64 rows at a time in bf16, then 16-byte rows of y. Every thread calls it.
template <int NP>
__device__ __forceinline__ void store_y(float* acc, bf16* ys, bf16* y,
                                        int c0, int rows, int d0, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp * 16 + (lane >> 2);       // column (and m + 8)
  const int c2 = (lane & 3) * 2;
  __syncthreads();
#pragma unroll
  for (int rd = 0; rd < (NP + 63) / 64; ++rd) {
#pragma unroll
    for (int b = 0; b < 8 && 8 * (8 * rd + b) < NP; ++b)   // 8-row blocks
#pragma unroll
      for (int q = 0; q < 4; ++q) {    // row + q % 2, column + 8 (q / 2)
        const int r = 8 * b + c2 + (q & 1), col = m + 8 * (q >> 1);
        float& v = acc[4 * (8 * rd + b) + q];
        ys[r * BM + (((col >> 3) ^ (r & 7)) << 3) + (col & 7)] =
            __float2bfloat16_rn(v);
        v = 0.f;
      }
    __syncthreads();
    for (int c = threadIdx.x; c < 64 * (BM / 8); c += NT) {
      const int r = c / (BM / 8), ch = c % (BM / 8);
      if (64 * rd + r < rows && d0 + ch * 8 < D)
        *reinterpret_cast<uint4*>(y + (size_t)(c0 + 64 * rd + r) * D + d0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(ys + r * BM +
                                            ((ch ^ (r & 7)) << 3));
    }
    __syncthreads();
  }
}

// Streaming: one block per (column tile, expert, pass of NP rows); the
// weights and h stage by stage through a 4-stage ring.
template <int NP>
constexpr size_t stream_bytes() {
  return STAGES * (W_TILE + 8 * (size_t)plane(NP)) * sizeof(bf16);
}

template <int NP>
__global__ void __launch_bounds__(NT) gmm_down_stream_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wo,
    bf16* __restrict__ y, int C, int F, int D) {
  constexpr int SB = (int)W_TILE + 8 * plane(NP);   // elements per stage
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int d0 = blockIdx.x * BM, e = blockIdx.y, c0 = blockIdx.z * NP;
  const int rows = min(NP, C - c0);
  const bf16* he = h + ((size_t)e * C + c0) * F;
  const bf16* we = wo + (size_t)e * F * D;
  const int nk = (F + BK - 1) / BK;
  auto load = [&](int kt) {
    bf16* ws = ring + (kt % STAGES) * SB;
    load_w(ws, we, kt * BK, d0, F, D);
    load_h<NP>(ws + W_TILE, he, kt * BK, rows, F);
  };

  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<STAGES - 2>();           // stage kt arrived
    tc::fence_proxy_async();                   // ... for wgmma's reads
    __syncthreads();                           // and stage kt-1 is free
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    tc::cp_async_commit();
    const bf16* ws = ring + (kt % STAGES) * SB;
    uint32_t a[BK / 16][4];
    load_a(a, ws);
    mma_stage<NP>(acc, a, ws + W_TILE);
    tc::wgmma_wait<0>();
  }
  tc::cp_async_wait<0>();
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
    load_w(ring + (t % STAGES) * W_TILE, we, k0, (ct0 + t / nk) * BM, F, D);
    if (t < nk) load_h<NP>(hres + (size_t)(k0 / 8) * plane(NP), he, k0, C, F);
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
