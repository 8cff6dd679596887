// The staging the f32 attention kernels share, K3-f32 (attention_f32.cu,
// the forward) and K4-f32 (attention_bwd_f32.cu, the backward): f32 tiles
// copied by TMA, their swizzle, their split into TF32 hi and lo parts, and
// the store of a warp's output rows.
//
// A streamed tile is 64 rows of a (B, T, H, D) f32 tensor that came in by
// TMA (attn_tile.cuh, rows_map_f32) as DP / 32 boxes of 64 x 32 floats
// (DP: D padded to 32 or 64 by the copy engine's zero fill). Each box row is
// 128 bytes and lands under the 128-byte swizzle: the 16-byte chunk j of row
// r sits at chunk j ^ (r & 7), which puts the eight rows of an ldmatrix, and
// the transposed 32-bit reads of a warp, on 32 different banks, and is the
// layout a wgmma descriptor reads (wgmma.cuh, sw128_desc).
//
// Split TF32: an operand x is split once into hi = tf32(x) and lo = tf32(x
// - hi), rounded to nearest (mma.cuh, split_tf32), and a product is hi*hi +
// hi*lo + lo*hi ("3xTF32"), each to within ~2^-21 of an f32 one, where one
// TF32 product alone keeps ~2^-11. A streamed tile is split once for the
// whole block (split_stage) into hi and lo tiles of the same layout, so that
// no warp splits it again.
#pragma once

#include "attn_tile.cuh"
#include "mma.cuh"

namespace edm {

constexpr int kF32BoxBytes = kTileRows * 32 * 4;  // one box: 64 rows x 32 floats

// Byte offset of element (r, c) in a staged f32 tile of ROWS-row boxes (32
// floats a row, ROWS * 128 bytes a box) under the 128-byte swizzle.
template <int ROWS>
static __device__ __forceinline__ int f32_offset(int r, int c) {
  return (c >> 5) * (ROWS * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// Rows t0 .. t0 + 64 n - 1 of a (B, T, H, D) f32 tensor as n 64-row tiles of
// DP / 32 boxes each, counted on bar.
template <int DP>
static __device__ __forceinline__ void load_tiles(uint32_t dst, const CUtensorMap* map,
                                                  uint32_t bar, int h, int t0, int b, int n) {
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < DP / 32; ++j)
      tma_load_4d(dst + (i * DP / 32 + j) * kF32BoxBytes, map, bar, 32 * j, h,
                  t0 + i * kTileRows, b);
}

// Staged tiles split once for the whole block: hi over the copied values,
// lo into tiles of the same layout, so that the warps (or the warpgroup
// products) read split operands instead of splitting them again. The fence
// orders these writes before the copy engine refills the bytes and before
// a wgmma reads them.
static __device__ __forceinline__ void split_stage(unsigned char* hi, unsigned char* lo,
                                                   int bytes) {
  for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16) {
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
  fence_proxy_async();
}

// A warp's 16 x DP accumulators to rows [t0, t0 + 16) of a (B, T, H, D) f32
// tensor (rows g and g + 8 of each thread; columns past D not written).
template <int DP>
static __device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                                      const float acc[DP / 8][4], int b, int h,
                                                      int t0, int T, int H, int D, int g,
                                                      int tg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + g + 8 * r;
    if (t >= T) continue;
    float* row = dst + (((size_t)b * T + t) * H + h) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 + 2 * tg < D)
        *reinterpret_cast<float2*>(row + n * 8) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

}  // namespace edm
