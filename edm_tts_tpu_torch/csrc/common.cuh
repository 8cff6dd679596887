// Device helpers shared by the codec kernels (conv_gemm.cuh: resunit.cu,
// decoder_block.cu) and the attention kernels (mma.cuh).
//
// cos_fast/snake are the device forms of edm_tts_tpu/ops/snake.py: the same
// Cody-Waite reduction of 2*pi and the same degree-12 even polynomial, so a
// kernel evaluates snake exactly as the Pallas kernels and the plain
// versions do (up to FMA contraction, ~1e-7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace edm
