// K5: weight-only int8 dense, out = bf16((x @ bf16(W_int8)) * scale[n]).
//
// Replaces edm_tts_tpu/ops/qdense.py::int8_dense (_qdense_kernel,
// implementation="pallas"): the int8 weight is converted to bf16 on chip
// (exact for |q| <= 127), the product accumulates in f32, and the per-output-
// column f32 scale multiplies the accumulator before the one rounding to
// bf16. Bias and activation are the caller's (QLinear adds the bias after).
//
// What bounds it on the H100: the serving shapes are M ~ 129-2648 rows, K and
// N 192-8192. At M=662, K=1024, N=4096 the product is 5.6 GFLOP against
// 7.6 MB of traffic: compute (~5.6 us at the bf16 peak). At d=384 (M=1382,
// K=384, N=1536) it is 1.6 GFLOP against 4.3 MB: the bytes (~1.3-1.8 us).
// Device memory sees the weight as int8 only: half the bytes of a bf16 weight.
//
// Design (simple first; wgmma/TMA is later work): one block of 4 warps per
// 64 x 64 output tile, a K loop in steps of 32. Each step loads the x tile
// (64 x 32 bf16) and the W tile (32 x 64 int8) with 16-byte loads into
// registers one step ahead, converts W to bf16 while storing it to shared
// memory, and runs WMMA bf16 -> f32 on the tile in shared memory (two
// buffers, one barrier per step). Rows are padded by 16 bytes in shared
// memory against bank conflicts. The epilogue stages the f32 tile in shared
// memory, scales column n by scale[n] and writes 8 bf16 (16 bytes) per
// store; rows >= M (the ragged last M tile) are neither loaded nor stored.
// K % 32 == 0 and N % 64 == 0 are required (the shape gate guarantees
// K % 32 and N % 128).
#include <cstdint>

#include "common.cuh"

namespace edm {

constexpr int kQBM = 64, kQBN = 64, kQBK = 32;
constexpr int kQThreads = 128;           // 4 warps, 2 x 2 over the tile
constexpr int kQLdx = kQBK + 8;          // bf16 row stride of the x tile
constexpr int kQLdw = kQBN + 8;          // bf16 row stride of the W tile
constexpr int kQLdc = kQBN + 4;          // f32 row stride of the out tile

struct QStage {
  bf16 x[kQBM * kQLdx];
  bf16 w[kQBK * kQLdw];
};

union QSmem {
  QStage stage[2];
  float c[kQBM * kQLdc];
};

__global__ void __launch_bounds__(kQThreads) int8_dense_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
    int N) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[sizeof(QSmem)];
  QSmem& sm = *reinterpret_cast<QSmem*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * kQBM, n0 = blockIdx.x * kQBN;

  // x tile: 64 rows x 4 chunks of 8 bf16; thread t takes chunks t and t+128
  // W tile: 32 rows x 4 chunks of 16 int8; thread t takes chunk t
  const int w_row = tid >> 2, w_col = (tid & 3) * 16;
  uint4 xr[2], wr;

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kQThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      xr[i] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        xr[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + col);
    }
    wr = *reinterpret_cast<const uint4*>(wq + (size_t)(k0 + w_row) * N + n0 + w_col);
  };
  auto store = [&](QStage& s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kQThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      *reinterpret_cast<uint4*>(&s.x[r * kQLdx + col]) = xr[i];
    }
    const int8_t* q = reinterpret_cast<const int8_t*>(&wr);
    __align__(16) bf16 wb[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) wb[e] = __float2bfloat16((float)q[e]);
    uint4* dst = reinterpret_cast<uint4*>(&s.w[w_row * kQLdw + w_col]);
    dst[0] = reinterpret_cast<const uint4*>(wb)[0];
    dst[1] = reinterpret_cast<const uint4*>(wb)[1];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = K / kQBK;
  load(0);
  store(sm.stage[0]);
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    if (kt + 1 < steps) load((kt + 1) * kQBK);  // in flight during the MMAs
    const QStage& s = sm.stage[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kQBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &s.x[(wm * 32 + i * 16) * kQLdx + kk], kQLdx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &s.w[kk * kQLdw + wn * 32 + j * 16], kQLdw);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step kt - 1, before the barrier
    if (kt + 1 < steps) store(sm.stage[(kt + 1) & 1]);
    __syncthreads();
  }

  // epilogue: the f32 tile through shared memory (the stages are dead now)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[(wm * 32 + i * 16) * kQLdc + wn * 32 + j * 16],
                              acc[i][j], kQLdc, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kQBM * (kQBN / 8); e += kQThreads) {
    const int r = e >> 3, c = (e & 7) * 8;
    if (m0 + r >= M) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      o[u] = __float2bfloat16(sm.c[r * kQLdc + c + u] * scale[n0 + c + u]);
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + c) =
        *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace edm

// x: (M, K) bf16; wq: (K, N) int8 [in][out]; scale: (N,) f32; out: (M, N)
// bf16. K % 32 == 0, N % 64 == 0, all pointers 16-byte aligned. Returns a
// cudaError_t.
extern "C" int edm_int8_dense(const void* x, const void* wq, const void* scale,
                              void* out, int M, int K, int N, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (M < 1 || K < kQBK || N < kQBN || K % kQBK || N % kQBN ||
      (M + kQBM - 1) / kQBM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(N / kQBN, (M + kQBM - 1) / kQBM);
  int8_dense_kernel<<<grid, kQThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int8_t*)wq, (const float*)scale, (bf16*)out, M, K, N);
  return (int)cudaGetLastError();
}
