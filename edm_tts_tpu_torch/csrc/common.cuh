// Device helpers shared by the codec kernels (resunit.cu, decoder_block.cu)
// and the attention kernel (attention.cu).
//
// cos_fast/snake are the device forms of edm_tts_tpu/ops/snake.py: the same
// Cody-Waite reduction of 2*pi and the same degree-12 even polynomial, so a
// kernel evaluates snake exactly as the Pallas kernels and the plain
// versions do (up to FMA contraction, ~1e-7).
//
// tile_conv is the matrix-product loop of K2's transposed conv
// (decoder_block.cu; K1 runs on warpgroup MMA instead): a
// (rows x C_in) bf16 tile that lives in shared memory, convolved with a
// (taps, C_in, N) bf16 weight streamed from device memory (L2-resident:
// at most 7 x 768 x 768 x 2 B = 8.3 MB), with f32 accumulation in WMMA
// fragments and a per-element epilogue that runs on the f32 result.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace edm {

using bf16 = __nv_bfloat16;

static __device__ __forceinline__ float cos_fast(float u) {
  const float k = rintf(u * 0.15915494309189535f);
  const float v = (u - k * 6.28125f) - k * 1.9353071795864792e-03f;
  const float v2 = v * v;
  float p = 1.7484986519e-09f;
  p = p * v2 + -2.7150122876e-07f;
  p = p * v2 + 2.4777785560e-05f;
  p = p * v2 + -1.3888208529e-03f;
  p = p * v2 + 4.1666583047e-02f;
  p = p * v2 + -4.9999997057e-01f;
  p = p * v2 + 1.0f;
  return p;
}

// x + sin^2(a x) / a, as (1 - cos(2 a x)) / (2 (a + 1e-9)); snake(0) == 0.
static __device__ __forceinline__ float snake(float x, float a) {
  return x + (1.0f - cos_fast(2.0f * a * x)) / (2.0f * (a + 1e-9f));
}

constexpr int kThreads = 256;            // 8 warps per codec block
constexpr int kWarps = kThreads / 32;
// below the H100's 227 KB (232,448 B) per-block opt-in limit, with room left
constexpr int kMaxSmem = 220 * 1024;

// out[r, :] = sum_k a_s[r + k*dil, :] @ w[k]   for r in [0, 16*RB)
// a_s: (rows, lda) bf16 in shared memory; w: (taps, cin, n) bf16 row-major.
// Each warp owns 16-column strips of the output; epi(row, col, value) gets
// every f32 result once. scratch: 256 floats of shared memory per warp.
template <int RB, class Epi>
static __device__ __forceinline__ void tile_conv(
    const bf16* __restrict__ a_s, int lda, const bf16* __restrict__ w,
    int taps, int dil, int cin, int n, float* __restrict__ scratch, Epi epi) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sw = scratch + warp * 256;
  for (int j = warp; j < n / 16; j += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int k = 0; k < taps; ++k) {
      for (int kk = 0; kk < cin; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, w + ((size_t)k * cin + kk) * n + j * 16, n);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, a_s + (size_t)(i * 16 + k * dil) * lda + kk, lda);
          wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      wmma::store_matrix_sync(sw, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(i * 16 + (e >> 4), j * 16 + (e & 15), sw[e]);
      __syncwarp();
    }
  }
}

// Round a byte count up to a 128-byte boundary (WMMA wants 32-byte aligned
// tile pointers; every shared-memory region starts on such a boundary).
static __host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

}  // namespace edm
