// K5 at f32: weight-only int8 dense with f32 activations.
//
// Replaces edm_tts_tpu/ops/qdense.py::int8_dense (_qdense_kernel) at f32
// activations, where the Pallas kernel widens the int8 weight to the
// activation's dtype: out = (x @ widen(W)) * scale with x f32 (M, K), W
// int8 (K, N), scale f32 (N,), f32 accumulation and an f32 output.
//
// Arithmetic: split TF32 ("2xTF32") on the tensor cores. Every int8 value
// is exact in TF32 (11 significant bits), so only x is split, into x_hi =
// tf32(x) and x_lo = tf32(x - x_hi) (mma.cuh, split_tf32): out = (x_hi W +
// x_lo W) scale, two TF32 products summed in the same f32 accumulators,
// each product term within ~2^-22 of f32's (one TF32 product alone keeps
// ~2^-11).
//
// What bounds it on the H100: 2 * M * K * N FLOPs run as two TF32 products
// (the operations over 495 / 2 TFLOP/s) at the port's shapes (M 129-5528,
// K and N 192-8192); the int8 weight is a quarter of an f32 one's bytes.
//
// Design: warpgroup MMA (wgmma m64nNk8 TF32, both operands K-major, as TF32
// requires), x as the register operand A, the widened weight as operand B:
//   - a block of 256 threads (2 warpgroups) computes BM rows x 128 columns
//     (BM 128: each warpgroup 64 rows x 128 columns; BM 64: each 64 rows x
//     64 columns) over K in 32-deep steps. Thread 0 copies a step's x tile
//     (BM rows x 32 f32: 128-byte rows, 128-byte swizzle) and int8 weight
//     tile (32 rows x 128 bytes, unswizzled) by TMA into a ring of 4 stages
//     on mbarriers; the copy engine zero-fills rows past M;
//   - the 256 threads widen and transpose the weight tile into one of two
//     K-major f32 buffers (128 rows of 32 k values, the 128-byte swizzle
//     that the wgmma descriptor reads, sw128_desc): thread (warp w, lane l)
//     reads k rows 4w..4w+3 at columns 4l..4l+3 (32 different banks per
//     read) and writes each column's 4 values as one 16-byte store, lane
//     pairs starting at different columns so that each 8-lane phase of the
//     stores hits 8 different 16-byte chunks. A byte b becomes float
//     exactly as the bits 0x4B0000(b ^ 0x80) less 2^23 + 128. Each thread
//     reads its x fragments from the stage (plain 32-bit loads, 8 rows x 4
//     consecutive floats: conflict-free under the swizzle) and splits them;
//   - per step each warpgroup issues 8 products (x_hi, then x_lo, for each
//     of the 4 slices of 8) into a fresh set of accumulators; while they
//     run, every thread widens and splits the next step into the other
//     weight buffer and register set; then it waits for its products
//     (ptxas keeps products asynchronous only while no register they read
//     is written), adds the step's sums to the running ones in f32 (round
//     to nearest: the tensor cores' own accumulation drops the low bits of
//     each sum, an error that grows with the products chained into one
//     accumulator, 1.5e-5 relative over K 4096 against the 2^-16 limit),
//     fences its shared-memory writes to the async proxy
//     (fence.proxy.async) and meets the block at a barrier, after which
//     thread 0 refills the stage that step left;
//   - rows >= M are not stored; the per-column scale multiplies the f32
//     accumulator in the epilogue. A short output grid with many K steps
//     splits each tile's K steps over a cluster of 2-8 blocks that add up
//     their sums through distributed shared memory in rank order, as the
//     bf16 kernel (qdense.cu) does: deterministic, no atomics.
// The launch (tile, splits) is chosen per call by the wrapper
// (ops.qdense.int8_dense_f32_tile).
#include <cuda.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace edm {

constexpr int kF32QK = 32;                     // K per stage: one 128-byte f32 row of x
constexpr int kF32QBN = 128;                   // output columns per block
constexpr int kF32QStages = 4;
constexpr int kF32QWBytes = kF32QK * kF32QBN;  // an int8 weight tile
constexpr int kF32QWtBytes = kF32QBN * kF32QK * 4;  // the widened, K-major buffer

template <int BM>
struct QF32Cfg {
  static constexpr int kThreads = 256;
  static constexpr int kWgCols = BM == 128 ? 128 : 64;  // output columns per warpgroup
  static constexpr int kXBytes = BM * kF32QK * 4;
  static constexpr int kStageBytes = kXBytes + kF32QWBytes;
  static constexpr size_t kSmem =
      2 * kF32QWtBytes + (size_t)kF32QStages * kStageBytes + 8 * kF32QStages + 1024;
};

template <int BM>
__global__ void __launch_bounds__(256, 1) int8_dense_f32_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  using C = QF32Cfg<BM>;
  constexpr int S = kF32QStages, NW = C::kWgCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t wt0 = base;                       // 2 widened weight buffers
  const uint32_t xs0 = base + 2 * kF32QWtBytes;    // S x tiles
  const uint32_t ws0 = xs0 + S * C::kXBytes;       // S int8 weight tiles
  const uint32_t full0 = ws0 + S * kF32QWBytes;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kF32QBN;
  // split K: the gridDim.z blocks of a cluster take K steps [k0, k0 + nk)
  // each of the same output tile
  const int nk_all = K / kF32QK, splits = gridDim.z;
  const int k0 = blockIdx.z * nk_all / splits;
  const int nk = (blockIdx.z + 1) * nk_all / splits - k0;
  // thread 0 copies the block's K step i into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, C::kStageBytes);
    tma_load_2d(xs0 + s * C::kXBytes, &xmap, bar, (k0 + i) * kF32QK, m0);
    tma_load_2d(ws0 + s * kF32QWBytes, &wmap, bar, n0, (k0 + i) * kF32QK);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    for (int i = 0; i < S && i < nk; ++i) copy_in(i);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  // this thread's A rows xr and xr + 8 of the x tile, and its warpgroup's
  // first column of the block
  const int xr = (BM == 128 ? 64 * wg : 0) + 16 * (warp & 3) + g;
  const int wcol = BM == 128 ? 0 : 64 * wg;

  float acc[NW / 2], sum[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = 0.0f;

  // step i's weight tile, widened to f32 and transposed into buffer i % 2:
  // row n, k column c at byte n * 128 + ((c / 4) ^ (n & 7)) * 16 + (c % 4) * 4
  auto widen = [&](int i) {
    const unsigned char* src = smem + (ws0 - base) + (i % S) * kF32QWBytes;
    unsigned char* dst = smem + (wt0 - base) + (i & 1) * kF32QWtBytes;
    const unsigned char* row = src + 4 * warp * kF32QBN + 4 * lane;
    uint32_t v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = *reinterpret_cast<const uint32_t*>(row + r * kF32QBN) ^ 0x80808080u;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int c = (it + (lane >> 1)) & 3, n = 4 * lane + c;
      const uint32_t sel = c | 0x5440;  // byte c of v, then 0x00, 0x00, 0x4B
      float4 f;
      f.x = __uint_as_float(__byte_perm(v[0], 0x4B00u, sel)) - 8388736.0f;
      f.y = __uint_as_float(__byte_perm(v[1], 0x4B00u, sel)) - 8388736.0f;
      f.z = __uint_as_float(__byte_perm(v[2], 0x4B00u, sel)) - 8388736.0f;
      f.w = __uint_as_float(__byte_perm(v[3], 0x4B00u, sel)) - 8388736.0f;
      *reinterpret_cast<float4*>(dst + n * 128 + ((warp ^ (n & 7)) << 4)) = f;
    }
  };
  // step i's A fragments (4 slices of 8 k), split into TF32 hi and lo
  auto load_x = [&](int i, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) {
    const unsigned char* xt = smem + (xs0 - base) + (i % S) * C::kXBytes;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = xr + 8 * (q & 1), c = 8 * j + tg + 4 * (q >> 1);
        const float x = *reinterpret_cast<const float*>(
            xt + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
        split_tf32(x, hi[j][q], lo[j][q]);
      }
  };
  auto run_step = [&](int i, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4],
                      uint32_t(&next_hi)[4][4], uint32_t(&next_lo)[4][4]) {
    const uint64_t desc = sw128_desc(wt0 + (i & 1) * kF32QWtBytes + wcol * 128);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      WgmmaTF32<NW>::run(sum, hi[j], desc + 2 * j, j > 0);
      WgmmaTF32<NW>::run(sum, lo[j], desc + 2 * j, 1);
    }
    wgmma_commit();
    // every thread has read stage i % S (the barrier that ended the last step)
    if (threadIdx.x == 0 && i + S < nk) copy_in(i + S);
    if (i + 1 < nk) {
      mbar_wait(full0 + 8 * ((i + 1) % S), ((i + 1) / S) & 1);
      widen(i + 1);
      load_x(i + 1, next_hi, next_lo);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(sum);
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] += sum[e];
    // the next step's weight buffer written before any product reads it, and
    // this step's products done before the step after next overwrites theirs
    fence_proxy_async();
    __syncthreads();
  };
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
  if (nk > 0) {
    mbar_wait(full0, 0);
    widen(0);
    load_x(0, h0, l0);
  }
  fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < nk; i += 2) {
    run_step(i, h0, l0, h1, l1);
    if (i + 1 < nk) run_step(i + 1, h1, l1, h0, l0);
  }

  // epilogue: acc[4i + 2h + e] is x row xr + 8h, column wcol + 8i + 2tg + e
  if (splits > 1) {
    // Each block of the cluster puts its sums in its own shared memory (the
    // stages are done with); then block r adds up the columns 8i .. 8i + 7
    // for i = r, r + splits, ..., reading the blocks' sums in rank order (the
    // same bits on every run), and stores them.
    float* red = reinterpret_cast<float*>(smem + (xs0 - base));
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) red[e * C::kThreads + threadIdx.x] = acc[e];
    cluster_sync();
    for (int i = blockIdx.z; i < NW / 8; i += splits) {
      const int n = n0 + wcol + 8 * i + 2 * tg;
      const float sc0 = scale[n], sc1 = scale[n + 1];
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + xr + 8 * h;
        if (m >= M) continue;
        const uint32_t p0 = smem_u32(red + (4 * i + 2 * h) * C::kThreads + threadIdx.x);
        const uint32_t p1 = smem_u32(red + (4 * i + 2 * h + 1) * C::kThreads + threadIdx.x);
        float v0 = 0.0f, v1 = 0.0f;
        for (int r = 0; r < splits; ++r) {
          v0 += ld_cluster_f32(p0, r);
          v1 += ld_cluster_f32(p1, r);
        }
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(v0 * sc0, v1 * sc1);
      }
    }
    cluster_sync();  // a block's shared memory stays until the cluster has read it
    return;
  }
#pragma unroll
  for (int i = 0; i < NW / 8; ++i) {
    const int n = n0 + wcol + 8 * i + 2 * tg;
    const float sc0 = scale[n], sc1 = scale[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + xr + 8 * h;
      if (m >= M) continue;
      *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
          make_float2(acc[4 * i + 2 * h] * sc0, acc[4 * i + 2 * h + 1] * sc1);
    }
  }
}

template <int BM>
static cudaError_t launch_int8_dense_f32(const void* x, const void* wq, const void* scale,
                                         void* out, int M, int K, int N, int splits,
                                         cudaStream_t stream) {
  using C = QF32Cfg<BM>;
  static_assert(C::kWgCols / 2 * C::kThreads * 4 <= kF32QStages * C::kStageBytes,
                "the split sums fit in the stages");
  if ((M + BM - 1) / BM > 65535 || splits < 1 || splits > 8 || splits > K / kF32QK)
    return cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  cudaError_t err = matrix_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, kF32QK, BM);
  if (err == cudaSuccess)
    err = matrix_map(&wm, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kF32QBN, kF32QK,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  auto kernel = int8_dense_f32_kernel<BM>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kF32QBN, (M + BM - 1) / BM, splits);
  if (splits == 1) {
    kernel<<<grid, C::kThreads, C::kSmem, stream>>>(xm, wm, (const float*)scale, (float*)out,
                                                     M, K, N);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xm, wm, (const float*)scale, (float*)out, M, K, N);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace edm

// x: (M, K) f32; wq: (K, N) int8 [in][out]; scale: (N,) f32; out: (M, N)
// f32; all 16-byte aligned. K % 32 == 0, N % 128 == 0. tile indexes
// ops.qdense.INT8_F32_TILES, (output columns, x rows) per block: 0 (128,
// 128), 1 (128, 64); splits (1 .. min(8, K / 32)) blocks of a cluster share
// each output tile's K steps. Returns a cudaError_t.
extern "C" int edm_int8_dense_f32(const void* x, const void* wq, const void* scale, void* out,
                                  int M, int K, int N, int tile, int splits, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (M < 1 || K < kF32QK || K % kF32QK || N < kF32QBN || N % kF32QBN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return (int)launch_int8_dense_f32<128>(x, wq, scale, out, M, K, N, splits, s);
    case 1: return (int)launch_int8_dense_f32<64>(x, wq, scale, out, M, K, N, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
