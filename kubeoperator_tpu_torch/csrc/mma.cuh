// mma.sync tile helpers shared by the port's CUDA sources
// (flash_attention.cu, conv_bwd.cu): bf16 operand fragments of
// m16n8k16 products read from shared-memory tiles, f32 accumulation.
// Fragment layout (PTX ISA, "mma.m16n8k16"): lane = 4*g + tq holds A rows
// g and g+8 at columns 2tq, 2tq+1 (and +8), B columns g at rows 2tq, 2tq+1
// (and +8), and C rows g and g+8 at columns 2tq, 2tq+1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] . b[16x8]
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (rows r0..r0+15, cols c0..c0+15) of a row-major shared tile
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* m, int r0,
                                       int c0, int g, int tq) {
  a[0] = ld32(m + (r0 + g) * LD + c0 + 2 * tq);
  a[1] = ld32(m + (r0 + g + 8) * LD + c0 + 2 * tq);
  a[2] = ld32(m + (r0 + g) * LD + c0 + 2 * tq + 8);
  a[3] = ld32(m + (r0 + g + 8) * LD + c0 + 2 * tq + 8);
}

// B fragment with B[k][n] = M[n0 + n][k0 + k], M a row-major shared tile
// (the "x . M^T" operand, e.g. K in Q.K^T)
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* m, int n0, int k0, int g,
                                       int tq) {
  b0 = ld32(m + (n0 + g) * LD + k0 + 2 * tq);
  b1 = ld32(m + (n0 + g) * LD + k0 + 2 * tq + 8);
}

// B fragments of two n-tiles with B[k][n] = M[k0 + k][n0 + n] (the "x . M"
// operand, e.g. V in P.V): ldmatrix with transpose, 4 8x8 matrices
template <int LD>
__device__ __forceinline__ void load_bt2(uint32_t* b, const bf16* m, int k0,
                                         int n0, int lane) {
  const bf16* p = m + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// A fragment (rows m0..m0+15, cols k0..k0+15) with A[m][k] = M[k0 + k][m0 + m],
// M a row-major shared tile (the "M^T . x" operand, e.g. x in dW = x^T.g):
// ldmatrix with transpose, one 8x8 matrix per A register
template <int LD>
__device__ __forceinline__ void load_at(uint32_t* a, const bf16* m, int k0,
                                        int m0, int lane) {
  const int i = lane & 7, mat = lane >> 3;
  const bf16* p = m + (k0 + i + ((mat >> 1) << 3)) * LD + m0 + ((mat & 1) << 3);
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

}  // namespace
