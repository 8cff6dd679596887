// K5: weight-only int8 dense, out = bf16((x @ bf16(W_int8)) * scale[n]).
//
// Replaces edm_tts_tpu/ops/qdense.py::int8_dense (_qdense_kernel,
// implementation="pallas"): the int8 weight is widened to bf16 on chip
// (exact for |q| <= 127), the product accumulates in f32, and the per-output-
// column f32 scale multiplies the accumulator before the one rounding to
// bf16. Bias and activation are the caller's (QLinear adds the bias after).
// Device memory sees the weight as int8 only: half the bytes of a bf16 one.
//
// What bounds it on the H100: the served shapes are M 129-5528 rows, K and
// N 192-8192. The s2a products (K 1024-4096, N 1024-8192) are bound by the
// tensor cores (M2648 K1024 N4096: 22 GFLOP, 22 us at 989 TFLOP/s, against
// 17 MB, 5 us at 3.35 TB/s); the t2s products (K 192-1536, N 384-1536 at
// M 1382-5528) sit near the ridge, where the bf16 output is most of the
// bytes, and fill the card only with small tiles.
//
// Design: the transposed product out^T = W^T x^T on warpgroup MMA (wgmma),
// so the widened weight is the register operand A and x the shared-memory
// operand B, read by the tensor cores straight from the TMA tile:
//   - a block computes 128 output columns x BM x rows (BM 64, 128 or 256);
//     thread 0 copies, per 64-deep K step, the x tile (BM rows x 64 bf16,
//     one 128-byte swizzled row each) and the int8 weight tile (64 rows x
//     128 bytes, swizzled) by TMA into a ring of 4 stages on mbarriers: the
//     first 4 steps before the loop, then each stage again once both
//     warpgroups have released it. The copy engine zero-fills rows past M
//     and K (K % 64 == 32 ends in a half step), so no edge is padded by
//     hand. No warp only copies: with 8 warps a thread may hold the 128
//     accumulators of BM 256 without spilling (a ninth warp caps it at 168);
//   - 2 warpgroups split the 128 columns, 64 each (one m64 tile of A). Per
//     16-deep slice a thread loads its weight bytes with 16-bit shared
//     loads and widens them in registers, two values per prmt + 2 lop3 + 1
//     bf16x2 fma (widen_pair); a step's 4 products run asynchronously while
//     the next step is widened into the other register buffer. ptxas lets
//     products run on while registers are written only if every product
//     that read them is provably complete: each step's products are waited
//     for (wait_group 0) before the next step's are issued;
//   - the A rows are assigned to output columns so that one thread's 2 rows
//     are consecutive columns: its bytes are one shared load per k row, and
//     its outputs per x row are 2 consecutive bf16 (one 4-byte store); the
//     scale is read once per column into registers and multiplies the f32
//     accumulator before the one rounding to bf16; rows >= M are not stored.
// A stage is released (one arrival per warp) once the products that read
// it are complete. A short output grid with many K steps (M 129-1382 at K
// 768-4096) splits each tile's K steps over a cluster of 2-4 blocks: each
// puts its f32 sums in its shared memory, and block r adds up the tile's
// 8-row groups r, r + splits, ... through distributed shared memory in rank
// order (deterministic; no scratch in device memory, no atomics), scales
// once and rounds once. The launch (tile, splits) is chosen per call by
// the wrapper (ops.qdense.int8_dense_tile).
#include <cuda.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace edm {

constexpr int kQK = 64;          // K per stage: one 128-byte swizzled bf16 row of x
constexpr int kQBox = 128;       // weight columns per TMA box: one 128-byte row
constexpr int kQBoxBytes = kQK * kQBox;
constexpr int kQStages = 4;  // BM 64 and 128 keep two blocks on an SM

template <int BM>
struct QCfg {
  // 2 warpgroups and nothing else: 8 warps leave each SM sub-partition 2
  // warps, so a thread may hold up to 255 registers
  static constexpr int kThreads = 256;
  static constexpr int kXBytes = BM * kQK * 2;
  static constexpr int kStageBytes = kXBytes + kQBoxBytes;
  static constexpr size_t kSmem = (size_t)kQStages * kStageBytes + 16 * kQStages + 1024;
};

// Thread-block cluster: every thread of every block of the cluster arrives
// and waits; shared-memory writes before it are seen by the cluster after.
static __device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// f32 at shared address addr of the block of cluster rank r.
static __device__ __forceinline__ float ld_cluster_f32(uint32_t addr, uint32_t r) {
  uint32_t peer;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(addr), "r"(r));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(peer) : "memory");
  return v;
}

static __device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Byte B of lo and byte B of hi, read as int8, as a bf16 pair (lo in the
// low half), exactly: with b a byte, bf16 0x4300 | (b & 0x7f) is
// 128 + (b & 127) and 0x4300 | (b & 0x80) is 128, or 256 for a negative b;
// their difference is the signed value, exact in bf16 for any int8.
template <int B>
static __device__ __forceinline__ uint32_t widen_pair(uint32_t lo, uint32_t hi) {
  const uint32_t p = __byte_perm(lo, hi, B | ((4 + B) << 8));
  const uint32_t mag = (p & 0x007f007fu) | 0x43004300u;
  const uint32_t bias = (p & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(bias), "r"(0xbf80bf80u), "r"(mag));
  return r;
}

// A fragment of one 16-deep slice: w[q] holds the thread's bytes of k rows
// 2tg, 2tg+1, 2tg+8, 2tg+9 of the slice, its column h at byte h; A row
// g + 8h is column h.
static __device__ __forceinline__ void widen_slice(const uint32_t (&w)[4], uint32_t (&a)[4]) {
  a[0] = widen_pair<0>(w[0], w[1]);
  a[1] = widen_pair<1>(w[0], w[1]);
  a[2] = widen_pair<0>(w[2], w[3]);
  a[3] = widen_pair<1>(w[2], w[3]);
}

template <int BM>
__global__ void __launch_bounds__(256, 1) int8_dense_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int N) {
  using C = QCfg<BM>;
  constexpr int S = kQStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t xs0 = base;  // S x tiles, then S weight tiles
  const uint32_t ws0 = base + S * C::kXBytes;  // S weight tiles of 8 KB
  const uint32_t full0 = base + S * C::kStageBytes, empty0 = full0 + 8 * S;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kQBox;
  // split K: the gridDim.z blocks of a cluster take K steps [k0, k0 + nk)
  // each of the same output tile
  const int nk_all = (K + kQK - 1) / kQK, splits = gridDim.z;
  const int k0 = blockIdx.z * nk_all / splits;
  const int nk = (blockIdx.z + 1) * nk_all / splits - k0;
  // thread 0 copies the block's K step i into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, C::kStageBytes);
    tma_load_2d(xs0 + s * C::kXBytes, &xmap, bar, (k0 + i) * kQK, m0);
    tma_load_2d(ws0 + s * kQBoxBytes, &wmap, bar, n0, (k0 + i) * kQK);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init_fence();
    for (int i = 0; i < S && i < nk; ++i) copy_in(i);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tg = lane & 3;
  // the thread's 2 consecutive output columns within the block
  const int col = 64 * wg + 16 * warp + 2 * g;
  // byte offsets of its k rows 2tg, 2tg+1, 2tg+8, 2tg+9 within a 16-row
  // slice of the weight tile (row r's 16-byte chunk c sits at c ^ (r & 7))
  int off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 2 * tg + (q & 1) + 8 * (q >> 1);
    off[q] = r * kQBox + ((((col >> 4) ^ (r & 7))) << 4) + (col & 15);
  }

  float acc[BM / 2];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) acc[e] = 0.0f;

  // The K loop, one 64-deep stage a step (4 products of m64nBMk16). A
  // step's A fragments are widened while the previous step's products run,
  // into the other of two register buffers; the products of a step are
  // waited for before the next step's are issued, so no register a product
  // reads is written while it runs. Once both warpgroups have released a
  // stage, thread 0 refills it with the step S ahead, while its next
  // step's products run.
  constexpr int kSlices = kQK / 16;
  auto widen_step = [&](int i, uint32_t(&dst)[kSlices][4]) {
    mbar_wait(full0 + 8 * (i % S), (i / S) & 1);
    const unsigned char* wst = smem + (ws0 - base) + (i % S) * kQBoxBytes;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = *reinterpret_cast<const uint16_t*>(wst + j * 16 * kQBox + off[q]);
      widen_slice(w, dst[j]);
    }
  };
  auto run_step = [&](int i, uint32_t(&cur)[kSlices][4], uint32_t(&next)[kSlices][4]) {
    const uint64_t desc = sw128_desc(xs0 + (i % S) * C::kXBytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSlices; ++j) WgmmaRS<BM>::run(acc, cur[j], desc + 2 * j);
    wgmma_commit();
    // while they run: the stage of step i - 1 is free once the other
    // warpgroup is done with it too; then widen the next step
    if (threadIdx.x == 0 && i >= 1 && i - 1 + S < nk) {
      mbar_wait(empty0 + 8 * ((i - 1) % S), ((i - 1) / S) & 1);
      copy_in(i - 1 + S);
    }
    if (i + 1 < nk) widen_step(i + 1, next);
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % S));
  };
  uint32_t a0[kSlices][4], a1[kSlices][4];
  if (nk > 0) widen_step(0, a0);
  for (int i = 0; i < nk; i += 2) {
    run_step(i, a0, a1);
    if (i + 1 < nk) run_step(i + 1, a1, a0);
  }
  wgmma_fence_operands(acc);

  // epilogue: accumulator (row 16 warp + g + 8h, column m) is output
  // (m, n + h); acc[4i + 2h + e] is x row 8i + 2tg + e
  const int n = n0 + col;
  const float sc0 = scale[n], sc1 = scale[n + 1];
  if (splits > 1) {
    // Each block of the cluster puts its sums in its own shared memory (the
    // stages are done with); then block r adds up x rows 8i .. 8i + 7 for
    // i = r, r + splits, ..., reading the blocks' sums in rank order (the
    // same bits on every run), and stores them.
    __syncthreads();  // every product of the block has read its stages
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) red[e * C::kThreads + threadIdx.x] = acc[e];
    cluster_sync();
    for (int i = blockIdx.z; i < BM / 8; i += splits)
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * i + 2 * tg + e;
        if (m >= M) continue;
        const uint32_t p0 = smem_u32(red + (4 * i + e) * C::kThreads + threadIdx.x);
        const uint32_t p1 = smem_u32(red + (4 * i + 2 + e) * C::kThreads + threadIdx.x);
        float v0 = 0.0f, v1 = 0.0f;
        for (int r = 0; r < splits; ++r) {
          v0 += ld_cluster_f32(p0, r);
          v1 += ld_cluster_f32(p1, r);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) = pack_bf16(v0 * sc0, v1 * sc1);
      }
    cluster_sync();  // a block's shared memory stays until the cluster has read it
    return;
  }
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * tg + e;
      if (m >= M) continue;
      *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
          pack_bf16(acc[4 * i + e] * sc0, acc[4 * i + 2 + e] * sc1);
    }
}

// Tensor map of a row-major (rows, cols) matrix with a 16-byte aligned base
// and rows of a multiple of 16 bytes, in (box_cols, box_rows) boxes with
// 128-byte swizzle; zeros past the edges.
static cudaError_t matrix_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                              int elem_bytes, int rows, int cols, int box_cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM>
static cudaError_t launch_int8_dense(const void* x, const void* wq, const void* scale,
                                     void* out, int M, int K, int N, int splits,
                                     cudaStream_t stream) {
  using C = QCfg<BM>;
  static_assert(BM / 2 * C::kThreads * 4 <= kQStages * C::kStageBytes,
                "the split sums fit in the stages");
  if ((M + BM - 1) / BM > 65535 || splits < 1 || splits > 8 || splits > (K + kQK - 1) / kQK)
    return cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  cudaError_t err = matrix_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, kQK, BM);
  if (err == cudaSuccess)
    err = matrix_map(&wm, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kQBox, kQK);
  if (err != cudaSuccess) return err;
  auto kernel = int8_dense_kernel<BM>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kQBox, (M + BM - 1) / BM, splits);
  if (splits == 1) {
    kernel<<<grid, C::kThreads, C::kSmem, stream>>>(xm, wm, (const float*)scale, (bf16*)out,
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
  err = cudaLaunchKernelEx(&cfg, kernel, xm, wm, (const float*)scale, (bf16*)out, M, K, N);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace edm

// x: (M, K) bf16; wq: (K, N) int8 [in][out]; scale: (N,) f32; out: (M, N)
// bf16; all 16-byte aligned. K % 32 == 0, N % 128 == 0. tile indexes
// ops.qdense.INT8_TILES, (output columns, x rows) per block: 0 (128, 256),
// 1 (128, 128), 2 (128, 64); splits (1 .. min(8, ceil(K / 64))) blocks of a
// cluster share each output tile's K steps. Returns a cudaError_t.
extern "C" int edm_int8_dense(const void* x, const void* wq, const void* scale, void* out,
                              int M, int K, int N, int tile, int splits, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (M < 1 || K < 32 || K % 32 || N < 128 || N % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return (int)launch_int8_dense<256>(x, wq, scale, out, M, K, N, splits, s);
    case 1: return (int)launch_int8_dense<128>(x, wq, scale, out, M, K, N, splits, s);
    case 2: return (int)launch_int8_dense<64>(x, wq, scale, out, M, K, N, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
