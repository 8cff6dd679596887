// Register-level helpers of the attention kernels (attention.cu, K3;
// attention_bwd.cu, K4; attn_variants.cu, K6): mma.sync m16n8k16 bf16 with
// f32 accumulation, fragments by ldmatrix, the MUFU exponential and bf16
// packing; and for the f32 kernels (attention_bwd_f32.cu, qdense_f32.cu)
// mma.sync m16n8k8 TF32 and the split of an f32 value into two TF32 parts.
//
// Fragment layout of m16n8k16 (g = lane / 4, tg = lane % 4):
//   A (16 x 16, row-major): a0 (row g, k 2tg..2tg+1), a1 (row g+8, same k),
//     a2 (row g, k 8+2tg..), a3 (row g+8, k 8+2tg..);
//   B (16 x 8, "col"): b0 (k 2tg..2tg+1, col g), b1 (k 8+2tg.., col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2tg, 2tg+1), c2, c3 (row g+8).
// So the accumulators of two neighbouring n-tiles, rounded to bf16 in
// pairs, are the A fragment of the next product over those 16 columns:
// a score tile becomes the left operand of P V without leaving registers.
//
// Fragment layout of m16n8k8 TF32 (one 32-bit element a register):
//   A (16 x 8): a0 (row g, k tg), a1 (row g+8, k tg), a2 (row g, k tg+4),
//     a3 (row g+8, k tg+4);
//   B (8 x 8): b0 (k tg, col g), b1 (k tg+4, col g);
//   C as m16n8k16's: c0, c1 (row g, cols 2tg, 2tg+1), c2, c3 (row g+8).
// An accumulator holds columns 2tg and 2tg+1 where the A fragment wants tg
// and tg+4, so the bf16 trick does not carry over as it is; since a product
// sums over k in any order, the f32 kernels instead read the B rows in the
// accumulator's order (k tg <-> row 2tg, k tg+4 <-> row 2tg+1 of each 8),
// and (c0, c2, c1, c3) are the A fragment as they stand.
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

static __device__ __forceinline__ void mma1688(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from 0:
// what cvt.rna.tf32.f32 gives for a finite x, as two integer operations (a
// half unit of the 13 dropped bits added to the magnitude's bits, then
// those bits cleared); the cvt runs on a slow pipe on the H100, and with it
// the split cost K4-f32 ~70 % more time.
static __device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to within ~2^-22 |x|, both parts TF32: a product of two
// split values is hi*hi + hi*lo + lo*hi to within ~2^-21 of f32's (the
// dropped lo*lo is ~2^-22), and each of those TF32 products is exact.
static __device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
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
