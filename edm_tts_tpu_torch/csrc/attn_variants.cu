// K6: the attention-variant ablation (unmasked bidirectional attention,
// one kernel per variant).
//
// Replaces scripts/profile_attn_variants.py::attn (make_kernel, pallas_call
// at :66): over q, k, v (B, T, H, D) bf16, with s = Q K^T * D^-1/2 in f32,
//
//   full       p = exp(s - rowmax)                o = (p.bf16 @ V) / sum p
//   noexp      p = s - rowmax                     o = (p.bf16 @ V) / (sum p + 1e6)
//   nosoftmax  p = s                              o = s.bf16 @ V
//   bf16exp    p = exp((s - rowmax).bf16) in bf16 o = (p @ V) / sum p (f32 sum)
//
// What bounds it on the H100: at the ablation's shape (B32 T1408 H16 D24)
// the two products are 9.7e10 FLOP (0.099 ms at 989 TFLOP/s) and Q, K, V
// and O 0.14 GB (0.041 ms at 3.35 TB/s), but the 1.0e9 exponentials of
// `full` take ~0.26 ms on the special-function units (MUFU, ~3.9e12/s):
// `full` is bounded by the exponentials, `bf16exp` (two per MUFU op with
// ex2.approx.ftz.bf16x2) by half of that, `noexp` and `nosoftmax` by the
// products. So the scores and weights stay in registers: nothing but Q, K,
// V and O touches memory, and the softmax costs what its MUFU and FMA
// instructions cost.
//
// Design (simple first, not tuned): one block of BQ/16 warps per (batch *
// head, BQ-query tile); BQ (64 or 128) is the Hopper analog of the Pallas
// block_q. K and V stream through shared memory in 64-key tiles (V stored
// transposed, so every MMA fragment is one 32-bit shared load); each warp
// owns 16 query rows and keeps S (16 x 64), P and O in the registers of
// mma.sync m16n8k16 bf16 fragments (f32 accumulation). D is padded with
// zeros to DP (32 or 64). Keys past T get p = 0 and stay out of the row
// max. It does not copy the TPU's two passes over a resident K/V row:
//   full, bf16exp: one pass with an online softmax in the log2 domain
//     (running max, O and the sum rescaled by 2^(m_old - m_new)); full uses
//     ex2.approx.ftz.f32, bf16exp rounds (s - m) * log2(e) to bf16 and takes
//     ex2.approx.ftz.bf16x2, whose bf16 result is the MMA operand as it is;
//   noexp: one pass with p @ V = s @ V - m * colsum(V) and
//     sum p = sum s - T * m (s rounded to bf16 for the product, not s - m);
//   nosoftmax: one pass, s @ V.
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace edm {

enum AttnVariant { kFull = 0, kNoExp = 1, kNoSoftmax = 2, kBf16Exp = 3 };

constexpr int kVK = 64;  // keys per streamed tile

template <int DP>
struct VariantLd {
  static constexpr int qk = DP + 8;   // row stride (bf16) of Q and K tiles
  static constexpr int vt = kVK + 8;  // row stride (bf16) of the transposed V tile
};

static __device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

static __device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

template <int VARIANT, int DP, int BQ>
__global__ void __launch_bounds__(BQ * 2) attn_variant_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int T, int H, int D,
    float scale) {
  using Ld = VariantLd<DP>;
  constexpr int kThreadsV = BQ * 2;  // BQ / 16 warps
  constexpr int NT = kVK / 8;        // n-tiles of S
  constexpr int ND = DP / 8;         // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * Ld::qk;
  bf16* vt = ks + kVK * Ld::qk;
  float* vsum_s = reinterpret_cast<float*>(vt + DP * Ld::vt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;  // fragment row group, thread in group
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

  for (int e = threadIdx.x; e < BQ * DP; e += kThreadsV) {
    const int r = e / DP, d = e - r * DP, t = q0 + r;
    qs[r * Ld::qk + d] = (t < T && d < D) ? q[(((size_t)b * T + t) * H + h) * D + d]
                                          : __float2bfloat16(0.0f);
  }
  __syncthreads();
  uint32_t qa[DP / 16][4];  // this warp's 16 query rows as A fragments
  {
    const bf16* qw = qs + warp * 16 * Ld::qk;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      qa[kk][0] = lds32(qw + g * Ld::qk + kk * 16 + 2 * tg);
      qa[kk][1] = lds32(qw + (g + 8) * Ld::qk + kk * 16 + 2 * tg);
      qa[kk][2] = lds32(qw + g * Ld::qk + kk * 16 + 8 + 2 * tg);
      qa[kk][3] = lds32(qw + (g + 8) * Ld::qk + kk * 16 + 8 + 2 * tg);
    }
  }

  // per thread: rows g and g + 8 of the warp's 16 (index 0 and 1)
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain for full, bf16exp)
  float l[2] = {0.0f, 0.0f};            // running sum of p (of s for noexp)
  float vsum = 0.0f;                    // noexp: column sum of V, column threadIdx.x
  const float sc = (VARIANT == kFull || VARIANT == kBf16Exp) ? scale * kLog2e : scale;

  for (int kt = 0; kt < T; kt += kVK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int e = threadIdx.x; e < kVK * DP; e += kThreadsV) {
      const int r = e / DP, d = e - r * DP, t = kt + r;
      const bool in = t < T && d < D;
      const size_t i = (((size_t)b * T + t) * H + h) * D + d;
      ks[r * Ld::qk + d] = in ? k[i] : __float2bfloat16(0.0f);
      vt[d * Ld::vt + r] = in ? v[i] : __float2bfloat16(0.0f);
    }
    __syncthreads();
    if (VARIANT == kNoExp && threadIdx.x < DP) {
      for (int r = 0; r < kVK; ++r) vsum += __bfloat162float(vt[threadIdx.x * Ld::vt + r]);
    }

    // S = Q_w K^T for 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const bf16* kr = ks + (n * 8 + g) * Ld::qk + 2 * tg;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma16816(s[n], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }
    // scale; keys past T are -inf (out of the max, p = 0)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + n * 8 + 2 * tg + (e & 1);
        s[n][e] = key < T ? s[n][e] * sc : -INFINITY;
      }
    }

    uint32_t pa[NT / 2][4];  // P as A fragments of the 4 key slices of 16
    if (VARIANT == kNoSoftmax || VARIANT == kNoExp) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          if (VARIANT == kNoExp && x != -INFINITY) {
            m[e >> 1] = fmaxf(m[e >> 1], x);
            l[e >> 1] += x;
          }
          s[n][e] = x == -INFINITY ? 0.0f : x;
        }
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
    } else {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // every tile holds at least one key < T, so mx is finite
      const float alpha[2] = {ex2_f32(m[0] - mx[0]), ex2_f32(m[1] - mx[1])};
      m[0] = mx[0];
      m[1] = mx[1];
      float rs[2] = {0.0f, 0.0f};
      if (VARIANT == kFull) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = ex2_f32(s[n][e] - m[e >> 1]);
            rs[e >> 1] += s[n][e];
          }
        }
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
          pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
          pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
          pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
        }
      } else {  // bf16exp: two exponentials per MUFU op, p stays bf16
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int n = 2 * j + (f >> 1), r = f & 1;
            const uint32_t p2 = ex2_bf16x2(
                pack_bf16(s[n][2 * r] - m[r], s[n][2 * r + 1] - m[r]));
            const float2 pf = unpack_bf16(p2);
            rs[r] += pf.x + pf.y;
            pa[j][f] = p2;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
    }

    // O_w += P V: (16 x 64 keys) x (64 keys x DP)
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const bf16* vr = vt + (n * 8 + g) * Ld::vt + 2 * tg;
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        mma16816(oacc[n], pa[j], lds32(vr + j * 16), lds32(vr + j * 16 + 8));
    }
  }

  float num_shift[2] = {0.0f, 0.0f}, inv[2] = {1.0f, 1.0f};
  if (VARIANT == kNoExp) {
    __syncthreads();
    if (threadIdx.x < DP) vsum_s[threadIdx.x] = vsum;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      num_shift[r] = m[r];
      inv[r] = 1.0f / (l[r] - (float)T * m[r] + 1e6f);
    }
  } else if (VARIANT != kNoSoftmax) {
    inv[0] = 1.0f / l[0];
    inv[1] = 1.0f / l[1];
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, d = n * 8 + 2 * tg + (e & 1);
      const int t = q0 + warp * 16 + g + 8 * r;
      if (t < T && d < D) {
        float x = oacc[n][e];
        if (VARIANT == kNoExp) x -= num_shift[r] * vsum_s[d];
        o[(((size_t)b * T + t) * H + h) * D + d] = __float2bfloat16(x * inv[r]);
      }
    }
  }
}

template <int VARIANT, int DP, int BQ>
static cudaError_t launch_variant(const void* q, const void* k, const void* v, void* o,
                                  int B, int T, int H, int D, cudaStream_t stream) {
  using Ld = VariantLd<DP>;
  const size_t smem = (size_t)(BQ + kVK) * Ld::qk * 2 + (size_t)DP * Ld::vt * 2 + DP * 4;
  auto kernel = attn_variant_kernel<VARIANT, DP, BQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ * 2, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                         (bf16*)o, T, H, D, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int VARIANT>
static cudaError_t dispatch_variant(const void* q, const void* k, const void* v, void* o,
                                    int B, int T, int H, int D, int block_q,
                                    cudaStream_t s) {
  if (D <= 32) {
    if (block_q == 64) return launch_variant<VARIANT, 32, 64>(q, k, v, o, B, T, H, D, s);
    return launch_variant<VARIANT, 32, 128>(q, k, v, o, B, T, H, D, s);
  }
  if (block_q == 64) return launch_variant<VARIANT, 64, 64>(q, k, v, o, B, T, H, D, s);
  return launch_variant<VARIANT, 64, 128>(q, k, v, o, B, T, H, D, s);
}

}  // namespace edm

// q, k, v, o: (B, T, H, D) bf16, 1 <= D <= 64; variant 0 full, 1 noexp,
// 2 nosoftmax, 3 bf16exp; block_q 64 or 128 query rows per block.
extern "C" int edm_attn_variant(const void* q, const void* k, const void* v, void* o,
                                int B, int T, int H, int D, int variant, int block_q,
                                void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 1 || D > 64 || T < 1 || B < 1 || H < 1 || variant < 0 || variant > 3 ||
      (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFull: return (int)dispatch_variant<kFull>(q, k, v, o, B, T, H, D, block_q, s);
    case kNoExp: return (int)dispatch_variant<kNoExp>(q, k, v, o, B, T, H, D, block_q, s);
    case kNoSoftmax:
      return (int)dispatch_variant<kNoSoftmax>(q, k, v, o, B, T, H, D, block_q, s);
    default: return (int)dispatch_variant<kBf16Exp>(q, k, v, o, B, T, H, D, block_q, s);
  }
}
