// Banded chunk-prefill attention through a page table, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel paged_chunk_prefill_attention_kernel
// (src/repro/kernels/chunk_prefill/paged.py, bodies _paged_kernel,
// _paged_quant_kernel, _paged_quant_tok_kernel). One prefill chunk of S
// queries at positions index[b] .. index[b]+S-1, already written into a
// shared pool [num_pages, 32, K, h], attends to the slot's pages: logical
// positions [p*32, (p+1)*32) live in page page_table[b, p]. Pages hold f32
// or bf16 values, or int8 / fp8 e4m3 codes with f32 scales per (page, KV
// head) [num_pages, K] or per row [num_pages, 32, K].
//
// What bounds it on the H100: at the serving engine's last chunk of a
// 640-position prompt (S = 128 from 512, 20 live pages, N = 28, K = 4,
// h = 128, f32 pages) the causal work is 4*h*N*sum(pos+1) = 1.06 GFLOP
// against ~6.3 MB moved: the operations bound it, 16 us on the f32 CUDA
// cores, 6.4 us as 3xTF32 at the tensor cores' dense TF32 peak. Design
// answer: the dense chunk kernel's bodies with a page as half of their
// 64-key block (page_size must be 32, the prefill band), so a paged launch
// is bit-equal to a dense launch over the same rows and keeps the
// chunking-invariance contract; blocks past the live band or older than
// the window are never read. f32, int8 and fp8 pages (and bf16 pages with
// an f32 q) take the 3xTF32 body (chunk_tf32.cuh): codes are widened to
// f32 and multiplied by their scale as they are staged. bf16 q over bf16
// pages takes the bf16 body (chunk_mma.cuh).
#include "chunk_mma.cuh"
#include "paged_chunk_kernel.cuh"

using namespace paged_chunk;

namespace {

template <int H>
__global__ void __launch_bounds__(chunk_mma::NT, 2) paged_chunk_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ page_table,
    const int* __restrict__ index, __nv_bfloat16* __restrict__ out, int S,
    int N, int K, int npg, int window) {
  const int n = blockIdx.x, b = blockIdx.y;
  const int kh = n / (N / K);
  const PagedSrc<__nv_bfloat16, SCALE_NONE> src{
      kp + (size_t)kh * H, vp + (size_t)kh * H, page_table + (size_t)b * npg,
      (size_t)PAGE * K * H, nullptr, nullptr, K, kh};
  chunk_mma::chunk_rows<H>(q, out, S, npg * PAGE, N, chunk_mma::tile_row(), n,
                           b, index[b], window, (size_t)K * H, src);
}

template <int H>
cudaError_t go_mma(const Args& a) {
  using T = __nv_bfloat16;
  const auto kernel = paged_chunk_mma_kernel<H>;
  constexpr size_t bytes = chunk_mma::Layout<H>::BYTES;
  static const cudaError_t setup = decode_tile::allow_smem(kernel, bytes);
  if (setup != cudaSuccess) return setup;
  const dim3 grid(a.N, a.B, (a.S + chunk_mma::BQ - 1) / chunk_mma::BQ);
  kernel<<<grid, chunk_mma::NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<const int*>(a.pt),
      static_cast<const int*>(a.index), static_cast<T*>(a.out), a.S, a.N,
      a.K, a.npg, a.window);
  return cudaGetLastError();
}

cudaError_t by_h_mma(int h, const Args& a) {
  switch (h) {
    case 16: return go_mma<16>(a);
    case 64: return go_mma<64>(a);
    case 128: return go_mma<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,N,h] (f32, or bf16 when q_bf16); k/v pages [num_pages, 32, K, h],
// contiguous, of kv_dtype 0 f32, 1 bf16 (scale_mode 0, scales null), 2
// int8 or 3 fp8 e4m3 (scale_mode 1: f32 scales [num_pages, K]; 2:
// [num_pages, 32, K]); page_table [B, npg] int32; index [B] int32 chunk
// starts; out [B,S,N,h] in q's type. Returns the launch's cudaError_t.
extern "C" int paged_chunk_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* index, void* out, int q_bf16, int kv_dtype, int scale_mode,
    int B, int S, int N, int K, int h, int page_size, int npg, int window,
    void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || npg <= 0 || N % K != 0 ||
      page_size != PAGE || N > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k_pages, v_pages, k_scales, v_scales, page_table, index,
               out, B,      S,       N,        K,        npg,        window,
               static_cast<cudaStream_t>(stream)};
  const bool quant = kv_dtype >= 2;
  if (quant != (scale_mode != SCALE_NONE)) return (int)cudaErrorInvalidValue;
  switch (kv_dtype) {
    case 0: return (int)by_q<float, SCALE_NONE>(q_bf16, h, a);
    case 1:
      return q_bf16 ? (int)by_h_mma(h, a)
                    : (int)by_h<__nv_bfloat16, SCALE_NONE, float>(h, a);
    case 2: return (int)launch_int8(scale_mode, q_bf16, h, a);
    case 3: return (int)launch_fp8(scale_mode, q_bf16, h, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
