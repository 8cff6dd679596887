// K1: the codec ResidualUnit as two products on warpgroup MMA.
//
// Replaces edm_tts_tpu/ops/pallas_resunit.py::fused_residual_unit
// (_fused_forward / _kernel): snake(a1) -> dilated k=7 conv -> snake(a2) ->
// k=1 conv -> + x, with weight norm folded into w7 and w1 by the caller.
//
// What bounds it on the H100: at C=768 the unit is 2*T*C*C*8 = 38 GFLOP per
// 4000 frames, so it wants the tensor cores at their Hopper rate (wgmma);
// its activations move 2*T*C*2 bytes, which at C=96 and T=160016 (61 MB,
// 18 us) come near the products' 24 us. The weights (7*C*C bf16, 8.3 MB at
// C=768) do not fit one block's shared memory, so they stream in tiles, and
// each staged tile must serve many time rows: a block that holds only a
// few rows (as the Pallas kernel's time tile does) reads the whole kernel
// from L2 for them.
//
// Design: the unit is three launches on one stream, all in this file.
//   1. snake_kernel: s1 = bf16(snake(x, a1)) into the output buffer.
//   2. Product 1, the dilated conv as an implicit GEMM: M = the time rows
//      of one batch row, N = C_out, K = 7 taps x C_in. A block computes 128
//      rows x BN output channels (BN 64, 128, 192 or 256, the wrapper's
//      choice, ops.resunit.resunit_tile). Thread 0 copies, per 64-channel
//      step, the A tile (128 rows of s1 from row t0 + (tap - 3) * dil, one
//      128-byte swizzled row each) from a 3-D tensor map (C, T, B), and the
//      weight tile (64 input channels x BN output channels of w7[tap], as
//      BN / 64 boxes of 64 x 64) from a 3-D map (C_out, C_in, taps) over the
//      kernel as the model holds it ([tap][in][out]), by TMA into a ring of
//      stages on mbarriers. The copy engine's zero fill outside [0, T) is
//      the conv's zero padding (snake(0) == 0), and a batch row never reads
//      its neighbour's frames; it also fills channels past C, so C % 64 !=
//      0 needs no padding. Two warpgroups (64 rows each) run wgmma with
//      both operands from shared memory (A K-major, the weight MN-major),
//      four 16-deep products per step; while they run, thread 0 refills the
//      stage the previous step released, and the step's products are
//      waited for before its stage is released (on an H100, 7 % faster
//      over run (a)'s units than keeping one step's products in flight
//      into the next step). Up to 128 columns two blocks share an SM, so
//      one block's waits and epilogue overlap the other's products. The
//      epilogue adds b7, applies snake(a2) and rounds to bf16 (the Pallas
//      kernel casts its intermediate there too), into a scratch s2.
//   3. Product 2, the k=1 conv: the same kernel with one tap over s2 and
//      w1; its epilogue adds b1 and the residual x and writes the output
//      (over s1, which product 1 is done with).
// The epilogues stage the f32 accumulator tile in shared memory, then read
// the residual and write their output 16 bytes a thread along the rows
// (on an H100, 18 % faster over run (a)'s units than 4-byte stores from
// the accumulator layout).
#include <cuda.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace edm {

constexpr int kRuBM = 128;  // time rows per block: two warpgroups of 64
constexpr int kRuBK = 64;   // channels per step: one 128-byte swizzled row
constexpr int kRuABytes = kRuBM * kRuBK * 2;
constexpr int kRuChunkBytes = 64 * kRuBK * 2;  // one 64 x 64 weight box

enum RuEpilogue { kConv7 = 0, kConv1 = 1 };

template <int BN>
struct RuCfg {
  static constexpr int kStageBytes = kRuABytes + BN / 64 * kRuChunkBytes;
  // up to 128 columns two blocks share an SM (one's epilogue overlaps the
  // other's products), so each keeps under half its shared memory
  static constexpr int kMinBlocks = BN <= 128 ? 2 : 1;
  static constexpr int kStages = (kMinBlocks == 2 ? 110 : 220) * 1024 / kStageBytes;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
};

// s1 = bf16(snake(x, alpha)) over n8 groups of 8 channels of (rows, C)
__global__ void __launch_bounds__(256) snake_kernel(const bf16* __restrict__ x,
                                                    const float* __restrict__ alpha,
                                                    bf16* __restrict__ y, size_t n8, int C) {
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

template <int BN, int TAPS, int EPI>
__global__ void __launch_bounds__(256, RuCfg<BN>::kMinBlocks) resunit_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ bias, const float* __restrict__ alpha,
    const bf16* __restrict__ res, bf16* __restrict__ out, int T, int C, int dil) {
  using Cf = RuCfg<BN>;
  constexpr int S = Cf::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + S * Cf::kStageBytes, empty0 = full0 + 8 * S;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * kRuBM, b = blockIdx.z;
  const int kc = (C + kRuBK - 1) / kRuBK;  // 64-channel steps per tap
  const int nk = TAPS * kc;
  // thread 0 copies step i (tap i / kc, channels 64 (i % kc) ...) into
  // stage i % S: the A tile, then the BN / 64 weight boxes
  auto copy_in = [&](int i) {
    const int s = i % S, tap = i / kc, c0 = (i - tap * kc) * kRuBK;
    const uint32_t st = base + s * Cf::kStageBytes, bar = full0 + 8 * s;
    mbar_expect_tx(bar, Cf::kStageBytes);
    tma_load_3d(st, &amap, bar, c0, t0 + (tap - TAPS / 2) * dil, b);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_3d(st + kRuABytes + j * kRuChunkBytes, &wmap, bar, n0 + 64 * j, c0, tap);
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
    const uint64_t ad = sw128_desc(st + wg * (kRuABytes / 2));
    const uint64_t bd = sw128_mn_desc(st + kRuABytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kRuBK / 16; ++j) WgmmaSS<BN>::run(acc, ad + 2 * j, bd + 128 * j);
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
  // consecutive columns of a row at a time, so the residual's loads and the
  // output's stores are 16 bytes a thread along the rows.
  constexpr int kLd = BN + 8;  // f32 row stride: 8 banks of padding
  static_assert(kRuBM * kLd * 4 <= S * Cf::kStageBytes, "the tile fits in the stages");
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
  // C % 16 == 0: a chunk that starts below C ends there too
  if (threadIdx.x >= kRowStep * kChunks || n >= C) return;
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
  for (int r = threadIdx.x / kChunks; r < kRuBM && t0 + r < T; r += kRowStep) {
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * kLd + 8 * ch);
    const float4 hi = *reinterpret_cast<const float4*>(tile + r * kLd + 8 * ch + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t off = ((size_t)b * T + t0 + r) * C + n;
    uint32_t o[4];
    if (EPI == kConv7) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] += bi[j];
        v[j] += (1.0f - cos_fast(2.0f * al[j] * v[j])) * inv[j];
      }
    } else {
      const uint4 x8 = *reinterpret_cast<const uint4*>(res + off);
      const uint32_t xs[4] = {x8.x, x8.y, x8.z, x8.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
        v[2 * j] += bi[2 * j] + x2.x;
        v[2 * j + 1] += bi[2 * j + 1] + x2.y;
      }
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

template <int BN, int TAPS, int EPI>
static cudaError_t launch_gemm(const CUtensorMap& am, const CUtensorMap& wm, const void* bias,
                               const void* alpha, const void* res, void* out, int B, int T,
                               int C, int dil, cudaStream_t stream) {
  using Cf = RuCfg<BN>;
  auto kernel = resunit_gemm_kernel<BN, TAPS, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cf::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + BN - 1) / BN, (T + kRuBM - 1) / kRuBM, B);
  kernel<<<grid, 256, Cf::kSmem, stream>>>(am, wm, (const float*)bias, (const float*)alpha,
                                           (const bf16*)res, (bf16*)out, T, C, dil);
  return cudaGetLastError();
}

template <int BN>
static cudaError_t launch_resunit(const void* x, const void* a1, const void* w7,
                                  const void* b7, const void* a2, const void* w1,
                                  const void* b1, void* out, void* s2, int B, int T, int C,
                                  int dil, cudaStream_t stream) {
  CUtensorMap s1m, s2m, w7m, w1m;
  cudaError_t err = map_3d(&s1m, out, C, T, B, kRuBM);
  if (err == cudaSuccess) err = map_3d(&s2m, s2, C, T, B, kRuBM);
  if (err == cudaSuccess) err = map_3d(&w7m, w7, C, C, 7, 64);
  if (err == cudaSuccess) err = map_3d(&w1m, w1, C, C, 1, 64);
  if (err != cudaSuccess) return err;
  const size_t n8 = (size_t)B * T * C / 8;
  const int blocks = (int)(n8 < 256 * 4096 ? (n8 + 255) / 256 : 4096);
  snake_kernel<<<blocks, 256, 0, stream>>>((const bf16*)x, (const float*)a1, (bf16*)out, n8, C);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_gemm<BN, 7, kConv7>(s1m, w7m, b7, a2, nullptr, s2, B, T, C, dil, stream);
  if (err == cudaSuccess)
    err = launch_gemm<BN, 1, kConv1>(s2m, w1m, b1, nullptr, x, out, B, T, C, 0, stream);
  return err;
}

}  // namespace edm

// x, out, s2: (B, T, C) bf16, 16-byte aligned (s2 is scratch); w7: (7, C, C)
// bf16 [tap][in][out]; w1: (C, C) bf16 [in][out]; a1, b7, a2, b1: (C,) f32.
// C % 16 == 0; bn (output channels per block) 64, 128, 192 or 256.
// Returns a cudaError_t.
extern "C" int edm_resunit(const void* x, const void* a1, const void* w7, const void* b7,
                           const void* a2, const void* w1, const void* b1, void* out,
                           void* s2, int B, int T, int C, int dil, int bn, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (C < 16 || C % 16 != 0 || dil < 1 || T < 1 || B < 1 || B > 65535 ||
      (T + kRuBM - 1) / kRuBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return (int)launch_resunit<64>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    case 128: return (int)launch_resunit<128>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    case 192: return (int)launch_resunit<192>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    case 256: return (int)launch_resunit<256>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
