// Generic warp-level pieces of the bf16 tensor-core kernels for Hopper
// (sm_90a): asynchronous 16-byte copies into shared memory, ldmatrix, the
// mma.sync m16n8k16 product (bf16 in, fp32 accumulate) and the hi/lo bf16
// split of an fp32 pair. attention_mma.cuh and patch_embed_u8.cu build on it.
//
// Fragment layout of m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// tg = lane % 4): an A register holds two bf16 of one row (g or g + 8) at
// columns 2 tg + {0, 1} (+ 8); a B register two of one column (g) at rows
// 2 tg + {0, 1} (+ 8); the fp32 C fragment rows g and g + 8, columns
// 2 tg + {0, 1}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with valid false the 16 bytes are
// zero-filled and nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// (a, b) -> hi = bf16(a), bf16(b) and lo = bf16(a - hi_a), bf16(b - hi_b),
// packed with a in the low half: hi + lo keeps a and b to ~2^-17 relative
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Lane offsets into a staged bf16 tile (row stride in elements) for one
// ldmatrix_x4 that yields the A fragment of 16 rows x 16 columns at the
// tile's origin: rows lane % 16, column half lane / 16.
__device__ __forceinline__ int a_frag_offset(int lane, int stride) {
  return (lane & 15) * stride + ((lane >> 4) << 3);
}

// ... and the B fragments of two 8-column tiles (n, n + 1) x 16 k from a
// tile stored [n][k] (rows are B's columns): b[0], b[1] for columns 0-7,
// b[2], b[3] for columns 8-15.
__device__ __forceinline__ int b_frag_offset_nk(int lane, int stride) {
  return (((lane >> 4) << 3) + (lane & 7)) * stride + (((lane >> 3) & 1) << 3);
}

// ... and the same from a tile stored [k][n], with ldmatrix_x4_trans.
__device__ __forceinline__ int b_frag_offset_kn(int lane, int stride) {
  return ((((lane >> 3) & 1) << 3) + (lane & 7)) * stride + ((lane >> 4) << 3);
}

}  // namespace mma
