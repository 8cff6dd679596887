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
// Design: K3's staging (attn_tile.cuh) without the mask. One block of
// BQ / 16 warps per (batch * head, BQ-query tile), BQ 64 or 128 (the
// Hopper analog of the Pallas block_q). Q comes in once and the 64-key K
// and V tiles stream through a ring of kVarStages shared-memory stages, all
// by TMA from a 4-D tensor map (D, H, T, B) on mbarriers: thread 0 refills
// a stage once every warp has released it, so the next tiles' copies
// overlap this tile's products and no barrier of the block sits in the key
// loop. Tiles land swizzled; K's fragments come by ldmatrix, V's by
// ldmatrix.trans (no transposed store). Each warp owns 16 query rows and
// keeps S (16 x 64), P and O in mma.sync m16n8k16 fragments (bf16
// operands, f32 accumulation); S's accumulators, rounded to bf16 in pairs,
// are P's A operand. D (a multiple of 8, the wrapper zero-pads others) is
// padded to DP 32 or 64 by the copy engine's zero fill; the scale is the
// true depth's. Keys past T (the last tile only) get p = 0 and stay out of
// the row max and sum. It does not copy the TPU's two passes over a
// resident K/V row:
//   full, bf16exp: one pass with an online softmax in the log2 domain
//     (running max, O and the sum rescaled by 2^(m_old - m_new)), the scale
//     folded into the exponent's FMA; full takes ex2.approx.ftz.f32 and
//     sums p in f32, bf16exp rounds (s - m) * log2(e) to bf16 and takes
//     ex2.approx.ftz.bf16x2, whose bf16 result is the MMA operand as it is,
//     and sums it in f32 by one more product with a ones operand;
//   noexp: one pass with p @ V = s @ V - m * colsum(V) and sum p = sum s -
//     T * m (s rounded to bf16 for the product, not s - m); colsum(V) is a
//     product of a ones operand with the V fragments P V already loaded;
//   nosoftmax: one pass, s @ V.
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "mma.cuh"

namespace edm {

enum AttnVariant { kFull = 0, kNoExp = 1, kNoSoftmax = 2, kBf16Exp = 3 };

constexpr int kVarStages = 3;
constexpr uint32_t kOnes = 0x3F803F80u;  // the bf16 pair (1, 1)

template <int DP, int BQ>
struct VarSmem {
  static constexpr uint32_t kTile = kTileRows * DP * 2;  // bytes of one 64-row tile
  static constexpr uint32_t q = 0;                       // BQ x DP
  static constexpr uint32_t k = q + BQ * DP * 2;         // kVarStages K tiles
  static constexpr uint32_t v = k + kVarStages * kTile;
  static constexpr uint32_t bars = v + kVarStages * kTile;  // full[S], empty[S], q
  static constexpr size_t total = 1024 + bars + (2 * kVarStages + 1) * 8;
};

static __device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

template <int VARIANT, int DP, int BQ>
__global__ void __launch_bounds__(BQ * 2) attn_variant_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int T, int H, int D,
    float scale) {
  constexpr int NW = BQ / 16;        // warps
  constexpr int NT = kTileRows / 8;  // n-tiles of S
  constexpr int ND = DP / 8;         // n-tiles of O
  constexpr int KS = DP / 16;        // k-steps of Q K^T
  constexpr int S = kVarStages;
  constexpr bool kSoftmax = VARIANT == kFull || VARIANT == kBf16Exp;
  using L = VarSmem<DP, BQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + L::bars, sbase + L::bars + 8 * S};
  const uint32_t qbar = sbase + L::bars + 16 * S;
  const int nkt = (T + kTileRows - 1) / kTileRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

  // key tile i into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile);
    tma_load_4d(sbase + L::k + s * L::kTile, &kmap, bar, 0, h, i * kTileRows, b);
    tma_load_4d(sbase + L::v + s * L::kTile, &vmap, bar, 0, h, i * kTileRows, b);
  };
  if (threadIdx.x == 0) {
    ring.init(NW);
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, BQ * DP * 2);
    for (int r = 0; r < BQ; r += kTileRows)
      tma_load_4d(sbase + L::q + r * DP * 2, &qmap, qbar, 0, h, q0 + r, b);
    ring.prologue(nkt, copy_in);
  }

  mbar_wait(qbar, 0);
  __syncwarp();
  uint32_t qa[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qa[kk], tile_addr<DP>(sbase + L::q, warp * 16 + (lane & 7) + (lane & 8),
                                      2 * kk + (lane >> 4)));
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};

  // per thread: rows g and g + 8 of the warp's 16 (index 0 and 1)
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.0f;
  // noexp: colsum(V) in every row of an accumulator tile like O's
  float vacc[VARIANT == kNoExp ? ND : 1][4];
#pragma unroll
  for (int n = 0; n < (VARIANT == kNoExp ? ND : 1); ++n)
    vacc[n][0] = vacc[n][1] = vacc[n][2] = vacc[n][3] = 0.0f;
  // bf16exp: the row sums of p as a product with a ones operand (c0 row g,
  // c2 row g + 8, each over all 64 keys of a tile)
  float lacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // full, bf16exp: the running row max of s * scale * log2(e); noexp: of s
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the running sum of p (of s for noexp)
  const float sc = kSoftmax ? scale * kLog2e : scale;

  for (int i = 0; i < nkt; ++i) {
    const int s = i % S;
    ring.acquire(i, nkt, copy_in);
    const uint32_t ks = sbase + L::k + s * L::kTile, vs = sbase + L::v + s * L::kTile;

    // S = Q_w K^T: 16 rows x 64 keys, unscaled
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, tile_addr<DP>(ks, np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                      2 * kk + ((lane >> 3) & 1)));
        mma16816(sacc[2 * np], qa[kk], kb[0], kb[1]);
        mma16816(sacc[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // keys past T (zero rows of the copy engine's fill) in the last tile:
    // -inf, out of the max and p = 0; noexp and nosoftmax take them as 0
    // below and keep them out of the max and the sum
    const int keys = T - i * kTileRows;
    if (keys < kTileRows) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + 2 * tg + (e & 1) >= keys) sacc[n][e] = -INFINITY;
    }

    uint32_t pa[NT / 2][4];  // P as A fragments of the 4 key slices of 16
    if (!kSoftmax) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sacc[n][e] * sc;
          if (VARIANT == kNoExp && x != -INFINITY) {
            m[e >> 1] = fmaxf(m[e >> 1], x);
            l[e >> 1] += x;
          }
          sacc[n][e] = x == -INFINITY ? 0.0f : x;
        }
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) acc_to_a(pa[j], sacc[2 * j], sacc[2 * j + 1]);
    } else {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[n][0], sacc[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[n][2], sacc[n][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every tile holds a key < T, so mx is finite; sc > 0
        const float m_new = fmaxf(m[r], mx[r] * sc);
        alpha[r] = ex2_f32(m[r] - m_new);
        m[r] = m_new;
      }
      if (VARIANT == kFull) {
        float rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[n][e] = ex2_f32(fmaf(sacc[n][e], sc, -m[e >> 1]));
            rs[e >> 1] += sacc[n][e];
          }
        }
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) acc_to_a(pa[j], sacc[2 * j], sacc[2 * j + 1]);
      } else {  // bf16exp: two exponentials per MUFU op, p stays bf16
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int n = 2 * j + (f >> 1), r = f & 1;
            pa[j][f] = ex2_bf16x2(pack_bf16(fmaf(sacc[n][2 * r], sc, -m[r]),
                                            fmaf(sacc[n][2 * r + 1], sc, -m[r])));
          }
        }
        lacc[0] *= alpha[0];
        lacc[1] *= alpha[0];
        lacc[2] *= alpha[1];
        lacc[3] *= alpha[1];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) mma16816(lacc, pa[j], kOnes, kOnes);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
    }

    // O_w += P V: (16 x 64 keys) x (64 keys x DP), V's fragments transposed
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tile_addr<DP>(vs, j * 16 + (lane & 7) + (lane & 8),
                                            2 * np + (lane >> 4)));
        mma16816(oacc[2 * np], pa[j], vb[0], vb[1]);
        mma16816(oacc[2 * np + 1], pa[j], vb[2], vb[3]);
        if (VARIANT == kNoExp) {
          mma16816(vacc[2 * np], ones, vb[0], vb[1]);
          mma16816(vacc[2 * np + 1], ones, vb[2], vb[3]);
        }
      }
    }
    ring.release(i);
  }

  float inv[2] = {1.0f, 1.0f};
  if (VARIANT == kFull || VARIANT == kNoExp) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (VARIANT == kNoExp) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        inv[r] = 1.0f / (l[r] - (float)T * m[r] + 1e6f);
      } else {
        inv[r] = 1.0f / l[r];
      }
    }
  } else if (VARIANT == kBf16Exp) {
    inv[0] = 1.0f / lacc[0];
    inv[1] = 1.0f / lacc[2];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= T) continue;
    bf16* orow = o + (((size_t)b * T + t) * H + h) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float x0 = oacc[n][2 * r], x1 = oacc[n][2 * r + 1];
      if (VARIANT == kNoExp) {
        x0 -= m[r] * vacc[n][2 * r];
        x1 -= m[r] * vacc[n][2 * r + 1];
      }
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(x0 * inv[r], x1 * inv[r]);
    }
  }
}

template <int VARIANT, int DP, int BQ>
static cudaError_t launch_variant(const void* q, const void* k, const void* v, void* o,
                                  int B, int T, int H, int D, int depth, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = rows_map(&qm, q, B, T, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&km, k, B, T, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&vm, v, B, T, H, D, DP);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = VarSmem<DP, BQ>::total;
  auto kernel = attn_variant_kernel<VARIANT, DP, BQ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ * 2, smem, stream>>>(qm, km, vm, (bf16*)o, T, H, D,
                                         1.0f / sqrtf((float)depth));
  return cudaGetLastError();
}

template <int VARIANT>
static cudaError_t dispatch_variant(const void* q, const void* k, const void* v, void* o,
                                    int B, int T, int H, int D, int depth, int block_q,
                                    cudaStream_t s) {
  if (D <= 32) {
    if (block_q == 64) return launch_variant<VARIANT, 32, 64>(q, k, v, o, B, T, H, D, depth, s);
    return launch_variant<VARIANT, 32, 128>(q, k, v, o, B, T, H, D, depth, s);
  }
  if (block_q == 64) return launch_variant<VARIANT, 64, 64>(q, k, v, o, B, T, H, D, depth, s);
  return launch_variant<VARIANT, 64, 128>(q, k, v, o, B, T, H, D, depth, s);
}

}  // namespace edm

// q, k, v, o: (B, T, H, D) bf16 with 16-byte aligned bases, D % 8 == 0,
// 8 <= D <= 64; the scores are scaled by depth^-1/2 (depth <= D: the head
// depth before the wrapper padded it); variant 0 full, 1 noexp, 2
// nosoftmax, 3 bf16exp; block_q 64 or 128 query rows per block.
extern "C" int edm_attn_variant(const void* q, const void* k, const void* v, void* o,
                                int B, int T, int H, int D, int depth, int variant,
                                int block_q, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 8 || D > 64 || D % 8 || depth < 1 || depth > D || T < 1 || B < 1 || H < 1 ||
      variant < 0 || variant > 3 || (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFull: return (int)dispatch_variant<kFull>(q, k, v, o, B, T, H, D, depth, block_q, s);
    case kNoExp: return (int)dispatch_variant<kNoExp>(q, k, v, o, B, T, H, D, depth, block_q, s);
    case kNoSoftmax:
      return (int)dispatch_variant<kNoSoftmax>(q, k, v, o, B, T, H, D, depth, block_q, s);
    default:
      return (int)dispatch_variant<kBf16Exp>(q, k, v, o, B, T, H, D, depth, block_q, s);
  }
}
