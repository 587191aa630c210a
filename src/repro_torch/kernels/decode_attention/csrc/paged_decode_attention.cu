// Single-token GQA flash decode through a page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_decode_attention_kernel
// (src/repro/kernels/decode_attention/paged.py, bodies _paged_kernel,
// _paged_quant_kernel, _paged_quant_tok_kernel). The KV cache is a shared
// pool [num_pages, page_size, K, h]; logical positions
// [p*page_size, (p+1)*page_size) of slot b live in page page_table[b, p].
// Pages hold f32 or bf16 values, or int8 / fp8 e4m3 codes with f32 scales
// per (page, KV head) [num_pages, K] or per row [num_pages, page_size, K].
// Page 0 is the pool's null page; table entries past a slot's length point
// at it and are never read.
//
// What bounds it on the H100: bytes, as for the dense kernel: each launch
// reads the live pages of every slot once (codes plus their scales) and
// does ~4*G*h operations per position. Design answer: the dense kernel's
// split-key body (decode_tile.cuh) with a tile of one page (page_size
// must be 32, the dense kernel's tile and the prefill band): a grid of
// (ceil(npg * 32 / 128) splits, K, B) blocks, each gathering its 4 pages
// of one (slot, KV head) through the table into a cp.async ring, then the
// combine pass. The split boundaries are absolute positions, so at
// page_size 32 a paged launch and a dense launch over the same rows give
// the same bits whatever S and npg are. Codes are widened to f32 in
// registers; a head scale multiplies a tile's scores and P.V sum, a row
// scale each key's score and p. Pages past the position or older than
// the window are never read. At the engines' B=8 that is 224 blocks on
// 132 SMs where one block per (slot, KV head) gave 32: at position 736,
// replayed from a CUDA graph with the pool cold in the L2, 0.0216 ms for
// f32 pages and 0.0189-0.0224 ms for int8/fp8 codes, where the one-block
// design took 0.1169-0.1643 ms (NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py).
#include "paged_kernel.cuh"

using namespace paged_decode;

// q [B,N,h] (f32, or bf16 when q_bf16); k/v pages [num_pages, 32, K, h],
// contiguous, of kv_dtype 0 f32, 1 bf16 (scale_mode 0, scales null), 2
// int8 or 3 fp8 e4m3 (scale_mode 1: f32 scales [num_pages, K]; 2:
// [num_pages, 32, K]); page_table [B, npg] int32; index [B] int32, each
// < npg * 32; scratch: f32 [B * N * splits * (h + 2)], splits =
// ceil(npg * 32 / SPLIT); out [B,N,h] in q's type. Launches the split
// kernel and the combine on `stream`; returns the first launch's
// cudaError_t.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* index, void* scratch, void* out, int q_bf16, int kv_dtype,
    int scale_mode, int B, int N, int K, int h, int page_size, int npg,
    int window, void* stream) {
  if (B <= 0 || K <= 0 || npg <= 0 || N % K != 0 || N / K > GMAX ||
      page_size != TK || B > 65535 || K > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, page_table, index,
               static_cast<float*>(scratch), out, B, N, K, npg,
               (npg * TK + SPLIT - 1) / SPLIT, window,
               static_cast<cudaStream_t>(stream)};
  const bool quant = kv_dtype >= 2;
  if (quant != (scale_mode != SCALE_NONE)) return (int)cudaErrorInvalidValue;
  switch (kv_dtype) {
    case 0: return (int)by_q<float, SCALE_NONE>(q_bf16, h, a);
    case 1: return (int)by_q<__nv_bfloat16, SCALE_NONE>(q_bf16, h, a);
    case 2: return (int)launch_int8(scale_mode, q_bf16, h, a);
    case 3: return (int)launch_fp8(scale_mode, q_bf16, h, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
