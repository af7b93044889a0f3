// Tensor-core helpers shared by the bf16 kernels (fused_volume_bwd.cu,
// ray_head.cu): bf16 packing, ldmatrix (plain and .trans) from shared
// memory, and mma.sync m16n8k16 with bf16 operands and f32 accumulation
// (sm_80 and later; Hopper runs them at a share of its wgmma rate).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tcore {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of row
// l % 8 of matrix l / 8); with .trans each lane gets a column pair instead.
__device__ __forceinline__ void ldsm4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (g = lane / 4, q = lane % 4): an accumulator of a 16x8 tile
// holds (row g, cols 2q, 2q+1) in c0, c1 and row g+8 in c2, c3; an A
// fragment of a 16x16 slice holds (g, 2q..) (g+8, 2q..) (g, 2q+8..)
// (g+8, 2q+8..); a B fragment (k rows 2q, 2q+1 | 2q+8, 2q+9 of column g).
// So two adjacent accumulator tiles, rounded, are one A fragment of the next
// product. ldmatrix x4 reads a 16x16 block at (r0, c0) of a row-major array;
// which quarter lane group l / 8 addresses depends on the operand:
// rows_first (A from [m][k], or B pairs of n-tiles from [k][n] with .trans):
// quarters (r0, c0), (r0+8, c0), (r0, c0+8), (r0+8, c0+8); otherwise (A
// from [k][m] with .trans, or B pairs from [n][k]): (r0, c0), (r0, c0+8),
// (r0+8, c0), (r0+8, c0+8). A B load gives n-tile c0 (or r0) in r[0], r[1]
// and the next n-tile in r[2], r[3].
__device__ __forceinline__ int frag_off(int ld, int lane, bool rows_first) {
  const int i = lane >> 3;
  const int rs = rows_first ? (i & 1) : (i >> 1), cs = rows_first ? (i >> 1) : (i & 1);
  return (rs * 8 + (lane & 7)) * ld + cs * 8;
}

// v summed over the 4 lanes of a quad (the columns an accumulator row
// spreads over)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace tcore
