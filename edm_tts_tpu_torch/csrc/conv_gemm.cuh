// The implicit-GEMM convolution of the codec kernels K1 (resunit.cu: the
// residual unit's dilated k=7 conv and its k=1 conv) and K2 (decoder_block.cu:
// the transposed conv in its phase form), and the snake pass that feeds them.
//
// conv_gemm<BN, TAPS, EPI> computes, for one batch row b,
//   out[t, n] = epi(sum_{tap} sum_c a[t + (tap - TAPS / 2) * dil, c] * w[tap][c][n])
// for 128 time rows t x BN output columns n per block: M = T, N = the output
// columns, K = taps x C_in. Thread 0 copies, per 64-channel step, the A tile
// (128 rows of a from row t0 + (tap - TAPS / 2) * dil, one 128-byte swizzled
// row each) from a 3-D tensor map (C_in, T, B), and the weight tile (64 input
// channels x BN output columns of w[tap], as ceil(BN / 64) boxes of 64 x 64)
// from a 3-D map (N, C_in, taps) over the weight as the model holds it
// ([tap][in][out]), by TMA into a ring of stages on mbarriers. The copy
// engine's zero fill outside [0, T) is the conv's zero padding (snake(0) ==
// 0), and a batch row never reads its neighbour's frames; it also fills
// channels past C_in and columns past N, so neither needs padding to 64. Two
// warpgroups (64 rows each) run wgmma with both operands from shared memory
// (A K-major, the weight MN-major), four 16-deep products per step; while
// they run, thread 0 refills the stage the previous step released, and the
// step's products are waited for before its stage is released (on an H100,
// 7 % faster over run (a)'s K1 units than keeping one step's products in
// flight into the next step). Up to 128 columns two blocks share an SM, so
// one block's waits and epilogue overlap the other's products.
//
// The phase product (EPI kPhase, TAPS 3, dil 1) skips the taps that are zero
// for all of a block's columns: columns below `half` (the phases r < s/2)
// use taps 0 and 1 only, the others taps 1 and 2 (ops/decoder_block.py::
// phase_weights), so a block wholly on one side runs two taps and one that
// straddles `half` runs three.
//
// The epilogue stages the f32 accumulator tile in shared memory, then each
// thread takes 8 consecutive columns of a row at a time, so the residual's
// loads and the output's stores are 16 bytes a thread along the rows (on an
// H100, 18 % faster over run (a)'s K1 units than 4-byte stores from the
// accumulator layout). kConv7 adds the bias and applies snake(alpha); kConv1
// adds the bias and the residual; kPhase adds the (tiled) bias.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace edm {

constexpr int kConvBM = 128;  // time rows per block: two warpgroups of 64
constexpr int kConvBK = 64;   // channels per step: one 128-byte swizzled row
constexpr int kConvABytes = kConvBM * kConvBK * 2;
constexpr int kConvBoxBytes = 64 * kConvBK * 2;  // one 64 x 64 weight box

enum ConvEpilogue { kConv7 = 0, kConv1 = 1, kPhase = 2 };

template <int BN>
struct ConvCfg {
  static constexpr int kBoxes = (BN + 63) / 64;  // weight boxes per step
  static constexpr int kStageBytes = kConvABytes + kBoxes * kConvBoxBytes;
  // up to 128 columns two blocks share an SM (one's epilogue overlaps the
  // other's products), so each keeps under half its shared memory
  static constexpr int kMinBlocks = BN <= 128 ? 2 : 1;
  static constexpr int kStages = (kMinBlocks == 2 ? 110 : 220) * 1024 / kStageBytes;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

// y = bf16(snake(x, alpha)) over n8 groups of 8 channels of (rows, C)
static __global__ void __launch_bounds__(256) snake_kernel(const bf16* __restrict__ x,
                                                           const float* __restrict__ alpha,
                                                           bf16* __restrict__ y, size_t n8,
                                                           int C) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    const int c = (int)(i * 8 % C);
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[j]));
      r[j] = pack_bf16(snake(f.x, alpha[c + 2 * j]), snake(f.y, alpha[c + 2 * j + 1]));
    }
    reinterpret_cast<uint4*>(y)[i] = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// snake_kernel over (rows, C) bf16, C % 8 == 0, both 16-byte aligned
static cudaError_t launch_snake(const void* x, const void* alpha, void* y, size_t rows, int C,
                                cudaStream_t stream) {
  const size_t n8 = rows * C / 8;
  const int blocks = (int)(n8 < 256 * 4096 ? (n8 + 255) / 256 : 4096);
  snake_kernel<<<blocks, 256, 0, stream>>>((const bf16*)x, (const float*)alpha, (bf16*)y, n8, C);
  return cudaGetLastError();
}

// The block (blockIdx.x: BN output columns, .y: 128 time rows, .z: batch
// row) of the convolution above; `smem` is the block's dynamic shared
// memory from a 1024-byte boundary, ConvCfg<BN>::kSmem bytes with the
// slack. out (and res, for kConv1) are (B, T, N) bf16; bias (and alpha, for
// kConv7) are (N,) f32; N % 8 == 0.
template <int BN, int TAPS, int EPI>
static __device__ __forceinline__ void conv_gemm(
    unsigned char* smem, const CUtensorMap* amap, const CUtensorMap* wmap,
    const float* __restrict__ bias, const float* __restrict__ alpha,
    const bf16* __restrict__ res, bf16* __restrict__ out, int T, int Cin, int N, int dil,
    int half) {
  using Cf = ConvCfg<BN>;
  constexpr int S = Cf::kStages;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + S * Cf::kStageBytes, empty0 = full0 + 8 * S;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * kConvBM, b = blockIdx.z;
  const int kc = (Cin + kConvBK - 1) / kConvBK;  // 64-channel steps per tap
  // the taps this block runs: all, or the phase product's nonzero ones
  int tap0 = 0, ntaps = TAPS;
  if (EPI == kPhase) {
    tap0 = n0 >= half ? 1 : 0;
    ntaps = n0 >= half || min(n0 + BN, N) <= half ? TAPS - 1 : TAPS;
  }
  const int nk = ntaps * kc;
  // thread 0 copies step i (tap tap0 + i / kc, channels 64 (i % kc) ...)
  // into stage i % S: the A tile, then the weight boxes
  auto copy_in = [&](int i) {
    const int s = i % S, tap = tap0 + i / kc, c0 = (i % kc) * kConvBK;
    const uint32_t st = base + s * Cf::kStageBytes, bar = full0 + 8 * s;
    mbar_expect_tx(bar, Cf::kStageBytes);
    tma_load_3d(st, amap, bar, c0, t0 + (tap - TAPS / 2) * dil, b);
#pragma unroll
    for (int j = 0; j < Cf::kBoxes; ++j)
      tma_load_3d(st + kConvABytes + j * kConvBoxBytes, wmap, bar, n0 + 64 * j, c0, tap);
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
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % S;
    mbar_wait(full0 + 8 * s, (i / S) & 1);
    __syncwarp();  // wgmma is issued by whole warps
    const uint32_t st = base + s * Cf::kStageBytes;
    const uint64_t ad = sw128_desc(st + wg * (kConvABytes / 2));
    const uint64_t bd = sw128_mn_desc(st + kConvABytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kConvBK / 16; ++j) WgmmaSS<BN>::run(acc, ad + 2 * j, bd + 128 * j);
    wgmma_commit();
    // while they run: thread 0 refills the stage of step i - 1 with step
    // i - 1 + S once every warp has released it
    if (threadIdx.x == 0 && i >= 1 && i - 1 + S < nk) {
      mbar_wait(empty0 + 8 * ((i - 1) % S), ((i - 1) / S) & 1);
      copy_in(i - 1 + S);
    }
    wgmma_wait<0>();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * s);
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);

  // Epilogue: the f32 tile goes through shared memory (the stages are free
  // once every warp's products are complete), then each thread takes 8
  // consecutive columns of a row at a time.
  constexpr int kLd = BN + 8;  // f32 row stride: 8 banks of padding
  static_assert(kConvBM * kLd * 4 <= S * Cf::kStageBytes, "the tile fits in the stages");
  float* tile = reinterpret_cast<float*>(smem);
  __syncthreads();
  {
    // acc[4i + 2h + e] is (row 64 wg + 16 warp + g + 8h, column 8i + 2tg + e)
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = 64 * wg + 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (r + 8 * h) * kLd + 8 * i + c) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  __syncthreads();
  constexpr int kChunks = BN / 8;  // 8-column chunks of a row
  constexpr int kRowStep = 256 / kChunks;
  const int ch = threadIdx.x % kChunks, n = n0 + 8 * ch;
  // N % 8 == 0: a chunk that starts below N ends there too
  if (threadIdx.x >= kRowStep * kChunks || n >= N) return;
  float bi[8], al[8], inv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bi[j] = bias[n + j];
    if (EPI == kConv7) {
      // snake(v, a) = v + (1 - cos(2 a v)) / (2 (a + 1e-9)) (common.cuh)
      al[j] = alpha[n + j];
      inv[j] = 0.5f / (al[j] + 1e-9f);
    }
  }
  for (int r = threadIdx.x / kChunks; r < kConvBM && t0 + r < T; r += kRowStep) {
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * kLd + 8 * ch);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * kLd + 8 * ch + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t off = ((size_t)b * T + t0 + r) * N + n;
    uint32_t o[4];
    if (EPI == kConv7) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] += bi[j];
        v[j] += (1.0f - cos_fast(2.0f * al[j] * v[j])) * inv[j];
      }
    } else if (EPI == kConv1) {
      const uint4 x8 = *reinterpret_cast<const uint4*>(res + off);
      const uint32_t xs[4] = {x8.x, x8.y, x8.z, x8.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
        v[2 * j] += bi[2 * j] + x2.x;
        v[2 * j + 1] += bi[2 * j + 1] + x2.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += bi[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Tensor map of a 3-D bf16 tensor (d0 innermost, d0 % 8 == 0, 16-byte
// aligned base) in (64, box1, 1) boxes with 128-byte swizzle; zeros outside.
static cudaError_t map_3d(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
                          int box1) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch a __global__ wrapper of conv_gemm<BN, ...> over (B, T) rows and N
// columns: am over the A operand (C_in, T, B) in 128-row boxes, wm over the
// weight (N, C_in, taps) in 64-row boxes.
template <int BN, class Kernel>
static cudaError_t launch_conv_gemm(Kernel kernel, const CUtensorMap& am, const CUtensorMap& wm,
                                    const void* bias, const void* alpha, const void* res,
                                    void* out, int B, int T, int Cin, int N, int dil, int half,
                                    cudaStream_t stream) {
  using Cf = ConvCfg<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cf::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (T + kConvBM - 1) / kConvBM, B);
  kernel<<<grid, 256, Cf::kSmem, stream>>>(am, wm, (const float*)bias, (const float*)alpha,
                                           (const bf16*)res, (bf16*)out, T, Cin, N, dil, half);
  return cudaGetLastError();
}

}  // namespace edm
