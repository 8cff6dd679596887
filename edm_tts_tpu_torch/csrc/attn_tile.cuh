// Tile staging of the attention kernels K3 (attention.cu), K4
// (attention_bwd.cu, and at f32 attention_bwd_f32.cu) and K6
// (attn_variants.cu): TMA copies of 64-row tiles of a (B, T, H, D) bf16 or
// f32 tensor into swizzled shared memory, completed on mbarriers, and the
// scan of the key mask into 64-key tiles. K5 (qdense.cu, qdense_f32.cu) and
// the codec GEMM of K1 and K2 (conv_gemm.cuh) use its mbarrier, TMA,
// cluster and tensor-map helpers.
//
// A tile is 64 rows (time steps of one batch row and head) x DP bf16 (D
// padded to 32 or 64). The tensor map views the tensor as 4-D (D, H, T, B),
// innermost first, with a (DP, 1, 64, 1) box: the copy engine zero-fills
// the rows past T and the lanes past D, so no kernel pads by hand. Rows are
// DP * 2 = 64 or 128 bytes and land swizzled (CU_TENSOR_MAP_SWIZZLE_64B /
// _128B): the 16-byte chunk c of row r sits at chunk c ^ ((r >> 1) & 3) or
// c ^ (r & 7), so the eight row addresses of one ldmatrix hit eight
// different bank groups. tile_addr applies the same XOR; every tile starts
// on a 1024-byte boundary, where the pattern restarts.
//
// The encoder cuTensorMapEncodeTiled lives in libcuda; the runtime hands
// out its address (cudaGetDriverEntryPoint), so the library links nothing
// beyond the CUDA runtime.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace edm {

constexpr int kTileRows = 64;  // rows of a streamed key or query tile

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared address of (row, 16-byte chunk) in a swizzled tile of DP-wide rows.
template <int DP>
static __device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row, int chunk) {
  constexpr uint32_t kRowBytes = DP * 2;
  constexpr uint32_t kMask = kRowBytes / 16 - 1;  // 3 (64 B rows) or 7 (128 B rows)
  const uint32_t off = row * kRowBytes + chunk * 16;
  return base + (off ^ (((off >> 7) & kMask) << 4));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more from the copy engine.
static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

static __device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity. A wait
// that never ends (a copy that never started) traps after ~2^26 tries,
// seconds, so a fault shows as a launch error instead of a hung card.
static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory, counted on `bar`.
static __device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, int c2,
                                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-D tensor map at (c0, c1, c2); coordinates may lie
// outside the tensor (negative too): the copy engine fills those elements
// with zeros.
static __device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D tensor map at (c0, c1).
static __device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

static __device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses (generic proxy)
// before later ones of the async proxy: TMA copies into the same bytes, or
// wgmma reading operands the threads wrote.
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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

// A ring of S shared-memory stages that tiles 0, 1, 2, ... pass through in
// order: tile i lives in stage i % S. Thread 0 copies a tile in (`copy_in`,
// which arrives on full(i) with the bytes to expect and starts the copies);
// every warp waits for it, computes, and releases the stage (one arrival
// per warp on its empty barrier); thread 0 refills a stage once all warps
// have released it, so up to S - 1 copies run ahead of the products.
template <int S>
struct TileRing {
  uint32_t full0, empty0;  // S full and S empty mbarriers, 8 bytes each

  __device__ uint32_t full(int i) const { return full0 + 8 * (i % S); }

  // thread 0, before the block's first __syncthreads
  __device__ void init(int warps) const {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, warps);
    }
  }

  // thread 0: the first min(S, n) tiles
  template <class CopyIn>
  __device__ void prologue(int n, CopyIn copy_in) const {
    for (int i = 0; i < S && i < n; ++i) copy_in(i);
  }

  // every thread, before tile i of n: thread 0 refills the stage of tile
  // i - 1 with tile i - 1 + S; then all wait until tile i has arrived
  template <class CopyIn>
  __device__ void acquire(int i, int n, CopyIn copy_in) const {
    if (threadIdx.x == 0 && i > 0 && i - 1 + S < n) {
      mbar_wait(empty0 + 8 * ((i - 1) % S), ((i - 1) / S) & 1);
      copy_in(i - 1 + S);
    }
    mbar_wait(full(i), (i / S) & 1);
    __syncwarp();
  }

  // every thread, after its warp's last read of tile i
  __device__ void release(int i) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * (i % S));
  }
};

// The block's shared memory from the next 1024-byte boundary (the launch
// asks for 1024 bytes more than the layout needs).
static __device__ __forceinline__ unsigned char* smem_aligned(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The 64-key tiles of batch row b. kbits[j] bit i is set when key
// 64 j + i counts: it is < Tk and the mask (B, Tk) lets it through. A batch
// row with no valid key at all counts every key < Tk (*uniform is set; the
// caller then scales the scores by 0). live[0..n) lists the tiles with any
// key that counts, in order; n is returned. Fully masked tiles add exactly
// nothing to a forward or to dq, so they are neither copied nor computed.
// Every thread of the block calls it; kbits and live hold ceil(Tk / 64)
// entries and *count one int, all in shared memory.
template <int NW>
static __device__ int scan_key_tiles(const unsigned char* __restrict__ mask, int b, int Tk,
                                     uint64_t* kbits, int* live, int* count, bool* uniform) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  bool any = false;
  for (int j = warp; j < nkt; j += NW) {
    const int k0 = j * kTileRows + lane, k1 = k0 + 32;
    const bool v0 = k0 < Tk && (mask == nullptr || mask[(size_t)b * Tk + k0] != 0);
    const bool v1 = k1 < Tk && (mask == nullptr || mask[(size_t)b * Tk + k1] != 0);
    const uint32_t lo = __ballot_sync(0xffffffffu, v0), hi = __ballot_sync(0xffffffffu, v1);
    if (lane == 0) kbits[j] = lo | (uint64_t)hi << 32;
    any |= (lo | hi) != 0;
  }
  *uniform = !__syncthreads_or(any);
  if (*uniform) {
    for (int j = threadIdx.x; j < nkt; j += blockDim.x) {
      const int n = min(kTileRows, Tk - j * kTileRows);
      kbits[j] = n == 64 ? ~0ull : (1ull << n) - 1;
    }
    __syncthreads();
  }
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nkt; base += 32) {
      const int j = base + lane;
      const bool on = j < nkt && kbits[j] != 0;
      const uint32_t m = __ballot_sync(0xffffffffu, on);
      if (on) live[n + __popc(m & ((1u << lane) - 1))] = j;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// Shared bytes scan_key_tiles needs past the fixed layout: kbits, live and
// the count, for Tk keys.
static __host__ __forceinline__ size_t key_tile_bytes(int Tk) {
  const size_t nkt = (Tk + kTileRows - 1) / kTileRows;
  return nkt * 8 + nkt * 4 + 16;
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map of a (B, T, H, D) bf16 tensor with D % 8 == 0 and a 16-byte
// aligned base, in (DP, 1, 64, 1) boxes.
static cudaError_t rows_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                            int DP) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)DP, 1, (cuuint32_t)kTileRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      DP == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a (B, T, H, D) f32 tensor with D % 4 == 0 and a 16-byte
// aligned base, in (32, 1, 64, 1) boxes: 64 rows of 128 bytes, the 128-byte
// swizzle's span (a wider row takes one box per 32 columns; lanes past D
// are zero-filled).
static cudaError_t rows_map_f32(CUtensorMap* map, const void* ptr, int B, int T, int H, int D) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)T * H * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)kTileRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a row-major (rows, cols) matrix with a 16-byte aligned base
// and rows of a multiple of 16 bytes, in (box_cols, box_rows) boxes with the
// given swizzle (128-byte unless told); zeros past the edges.
static cudaError_t matrix_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                              int elem_bytes, int rows, int cols, int box_cols, int box_rows,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of n contiguous f32 values in boxes of 64 (zeros past n).
static cudaError_t vec_map(CUtensorMap* map, const void* ptr, size_t n) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t no_strides[1] = {0};  // rank 1 has none; the encoder reads 0 entries
  const cuuint32_t box[1] = {(cuuint32_t)kTileRows};
  const cuuint32_t unit[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr),
                            dims, no_strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace edm
