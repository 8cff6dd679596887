// K5 at f32: weight-only int8 dense with f32 activations.
//
// Replaces edm_tts_tpu/ops/qdense.py::int8_dense (_qdense_kernel) at f32
// activations, where the Pallas kernel widens the int8 weight to the
// activation's dtype: out = (x @ widen(W)) * scale with x f32 (M, K), W
// int8 (K, N), scale f32 (N,), f32 accumulation and an f32 output. The bf16
// kernel (qdense.cu) rounds x to bf16 for wgmma; TF32 products alone would
// round x to 10 mantissa bits. Here every product is an f32 FMA (the int8
// weight is exact in f32).
//
// What bounds it on the H100: 2 * M * K * N FLOPs over the card's f32 FMA
// rate (67 TFLOP/s, no tensor cores) at the port's shapes (M in the hundreds
// to thousands, K and N 384-4096); the int8 weight is a quarter of an f32
// one's bytes.
//
// Design (SIMT, register tiles): a block of 256 threads computes a 64-row x
// 128-column tile of the output over K in 16-deep steps. Each step stages
// the x tile (64 x 16 f32, stored transposed so a thread reads 4 rows as
// one float4) and the weight tile (16 x 128 int8, widened to f32 as it is
// stored) in shared memory; each thread then keeps 4 rows x 8 columns of
// sums in registers (columns 4c..4c+3 and 64+4c..64+4c+3, so a warp's
// float4 reads of a weight row cover 512 contiguous bytes) and does 32 FMAs
// per three 16-byte shared loads. The next step's tiles are read from
// device memory into registers while this step's products run (two
// shared-memory buffers, one barrier a step). Rows past M read zeros and are
// not stored.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 128, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads) qdense_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float xs[2][kBK][kBM];
  __shared__ __align__(16) float ws[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // loaders: x as 64 rows x 4 float4s, w as 16 rows x 16 groups of 8 bytes
  const int xr = tid >> 2, xc = (tid & 3) * 4;
  const int wr = tid >> 4, wc = (tid & 15) * 8;
  const bool x_in = m0 + xr < M;
  const float* xp = x + (size_t)(x_in ? m0 + xr : 0) * K + xc;
  const int8_t* wp = w + (size_t)wr * N + n0 + wc;
  // compute: 4 rows at ty*4, columns tx*4 and 64 + tx*4
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 xv;
  int2 wv;
  auto fetch = [&](int k0) {
    xv = x_in ? *reinterpret_cast<const float4*>(xp + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
    wv = *reinterpret_cast<const int2*>(wp + (size_t)k0 * N);
  };
  auto stash = [&](int buf) {
    xs[buf][xc + 0][xr] = xv.x;
    xs[buf][xc + 1][xr] = xv.y;
    xs[buf][xc + 2][xr] = xv.z;
    xs[buf][xc + 3][xr] = xv.w;
    const int8_t* b = reinterpret_cast<const int8_t*>(&wv);
    float4 lo = make_float4(b[0], b[1], b[2], b[3]);
    float4 hi = make_float4(b[4], b[5], b[6], b[7]);
    *reinterpret_cast<float4*>(&ws[buf][wr][wc]) = lo;
    *reinterpret_cast<float4*>(&ws[buf][wr][wc + 4]) = hi;
  };

  const int nk = K / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[buf][kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(buf ^ 1);
    __syncthreads();
  }

  const float4 s0 = *reinterpret_cast<const float4*>(scale + n0 + tx * 4);
  const float4 s1 = *reinterpret_cast<const float4*>(scale + n0 + 64 + tx * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float* op = out + (size_t)m * N + n0;
    *reinterpret_cast<float4*>(op + tx * 4) = make_float4(
        acc[i][0] * s0.x, acc[i][1] * s0.y, acc[i][2] * s0.z, acc[i][3] * s0.w);
    *reinterpret_cast<float4*>(op + 64 + tx * 4) = make_float4(
        acc[i][4] * s1.x, acc[i][5] * s1.y, acc[i][6] * s1.z, acc[i][7] * s1.w);
  }
}

}  // namespace

// x: contiguous f32 (M, K); w: contiguous int8 (K, N); scale: f32 (N,); out:
// f32 (M, N); all 16-byte aligned, K % 16 == 0, N % 128 == 0.
extern "C" int edm_int8_dense_f32(const void* x, const void* w, const void* scale, void* out,
                                  int M, int K, int N, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (M < 1 || K < kBK || K % kBK || N < kBN || N % kBN || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  qdense_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
