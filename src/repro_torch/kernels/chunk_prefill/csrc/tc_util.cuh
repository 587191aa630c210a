// Tensor-core and asynchronous-copy building blocks for Hopper (sm_90a),
// shared by the bf16 chunk-prefill body (chunk_mma.cuh) and the bf16
// grouped down-projection (../../moe_gmm/csrc/gmm_down_tc.cu; its wgmma
// products in wgmma_bf16.cuh).
//
// mma.sync m16n8k16 with bf16 operands and f32 sums; fragments as the PTX
// ISA lays them out for lane l (g = l / 4, c = 2 * (l % 4)):
//   A 16x16 (row-major), 4 regs of 2 bf16: (g, c..c+1), (g+8, c..c+1),
//     (g, c+8..c+9), (g+8, c+8..c+9);
//   B 16x8 (k by n), 2 regs: (k c..c+1, n g), (k c+8..c+9, n g);
//   C/D 16x8 f32, 4 regs: (g, c), (g, c+1), (g+8, c), (g+8, c+1).
// ldmatrix loads those fragments from shared memory, eight 16-byte rows
// per 8x8 matrix (.trans for an operand stored with its other axis
// contiguous); cp.async copies 16 bytes from device to shared memory
// without passing through registers, zero-filling when told to read none.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes (src not read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, bf16 in, f32 sums (no memory access: not volatile, so the
// compiler may interleave independent products)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warpgroup products (wgmma, sm_90a): four warps issue one asynchronous
// m64nNk16 product; A from registers (warp w of the group holds rows
// 16w .. 16w+15 as an mma.sync A fragment), B from shared memory through a
// descriptor, the sums in registers laid out as mma.sync C fragments
// along N. B here is K-major without swizzle: 8-row x 16-byte core
// matrices of 128 contiguous bytes, lbo bytes apart along K and sbo along
// N.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffffu) >> 4) |
         ((uint64_t)((lbo & 0x3ffffu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffffu) >> 4) << 32);
}

// order this thread's earlier shared-memory writes (cp.async included,
// once waited for) before later reads by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// two f32 rounded to bf16 in one register, lo in the low half (the lower
// k index of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 of a register back to f32 (exact)
__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

}  // namespace tc
