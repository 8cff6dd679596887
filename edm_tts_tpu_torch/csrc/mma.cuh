// Register-level helpers of the attention kernels (attention.cu, K3;
// attention_bwd.cu, K4; attn_variants.cu, K6): mma.sync m16n8k16 bf16 with
// f32 accumulation, fragments by ldmatrix, the MUFU exponential and bf16
// packing.
//
// Fragment layout of m16n8k16 (g = lane / 4, tg = lane % 4):
//   A (16 x 16, row-major): a0 (row g, k 2tg..2tg+1), a1 (row g+8, same k),
//     a2 (row g, k 8+2tg..), a3 (row g+8, k 8+2tg..);
//   B (16 x 8, "col"): b0 (k 2tg..2tg+1, col g), b1 (k 8+2tg.., col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2tg, 2tg+1), c2, c3 (row g+8).
// So the accumulators of two neighbouring n-tiles, rounded to bf16 in
// pairs, are the A fragment of the next product over those 16 columns:
// a score tile becomes the left operand of P V without leaving registers.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace edm {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static __device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ float ex2_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i] in the A/B fragment layout.
static __device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: for a B operand stored k-major (rows of
// the shared tile are the product's k), e.g. V in P V.
static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The four A fragments of a 16 x 16 slice (k-step kk): an accumulator tile
// of 16 rows x 16 columns (n-tiles 2kk and 2kk + 1) rounded to bf16.
static __device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                                const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace edm
