// K3: bidirectional multi-head attention with a key-padding mask.
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha (_attn_kernel):
// softmax(Q K^T * d^-1/2 + key mask) V over (B, T, H, D) bf16, f32
// statistics and accumulation, and optionally each query row's
// log-sum-exp of the scaled, masked scores (f32 (B*H, Tq), natural log),
// the statistic K4 (attention_bwd.cu) takes to rebuild the probabilities.
//
// What bounds it on the H100: at the port's shapes (T 100-1400, D 24 or 64)
// the scores are 4*T^2 bytes per head, far more than Q, K and V together,
// so scores and probabilities must never reach device memory; with them in
// registers the bound is the two products (D 64) or the exponentials on the
// special-function units (D 24). The Pallas kernel keeps the whole K/V row
// of a head resident; here K and V stream through in 64-key tiles with an
// online softmax, so the result matches to a tolerance, not bit for bit.
//
// Design: one block of BQ / 16 warps per (batch*head, BQ-query tile), BQ
// 64 or 128 (the wrapper picks it from the grid size). Each warp owns 16
// query rows and keeps S (16 x 64 keys), P and O in mma.sync m16n8k16
// fragments (bf16 operands, f32 accumulation): S's accumulators, rounded to
// bf16 in pairs, are P's A operand for P V, so P never leaves the thread.
// The online softmax runs in the log2 domain (ex2.approx.ftz.f32 on scores
// pre-multiplied by d^-1/2 log2 e); the row sum stays per thread and is
// reduced across the row's four threads once, at the end. Q comes in once
// and K and V tiles stream through a ring of kFwdStages shared-memory
// stages, all by TMA (attn_tile.cuh) on mbarriers: thread 0 refills a
// stage as soon as every warp has released it, so the next tiles' copies
// overlap this tile's products and no __syncthreads sits in the loop.
// Fragments come by ldmatrix from the swizzled tiles, V's with .trans.
// D (a multiple of 8, at most 64) is padded to DP 32 or 64 by the copy
// engine's zero fill; the padded lanes add nothing and are not written.
//
// The mask: a block first scans its batch row's mask into per-tile key
// bits (scan_key_tiles); tiles with no key that counts are neither copied
// nor computed (ragged batches' padding is mostly such tiles), and in the
// others a masked key's score is -inf, so it never enters the running max
// and gets p = 0. A batch row whose mask holds no valid key at all attends
// uniformly to every key (scale 0: the mean of V), as the Pallas kernel's
// -1e30 bias and the plain version give; its LSE is log(Tk).
#include <math.h>

#include "attn_tile.cuh"
#include "mma.cuh"

namespace edm {

constexpr int kFwdStages = 3;

template <int DP, int BQ>
struct FwdSmem {
  static constexpr int kTile = kTileRows * DP * 2;  // bytes of one 64-row tile
  static constexpr size_t q = 0;                    // BQ x DP
  static constexpr size_t k = q + BQ * DP * 2;      // kFwdStages K tiles
  static constexpr size_t v = k + kFwdStages * kTile;
  static constexpr size_t bars = v + kFwdStages * kTile;  // full[S], empty[S], q
  static constexpr size_t keys = bars + (2 * kFwdStages + 1) * 8;
  static size_t total(int Tk) { return 1024 + keys + key_tile_bytes(Tk); }
};

template <int DP, int BQ>
__global__ void __launch_bounds__(BQ * 2) attn_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const unsigned char* __restrict__ mask,
    bf16* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int H, int D,
    float scale) {
  constexpr int NW = BQ / 16;        // warps
  constexpr int NT = kTileRows / 8;  // n-tiles of S
  constexpr int ND = DP / 8;         // n-tiles of O
  constexpr int KS = DP / 16;        // k-steps of Q K^T
  constexpr int S = kFwdStages;
  using L = FwdSmem<DP, BQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + L::bars, sbase + L::bars + 8 * S};
  const uint32_t qbar = sbase + L::bars + 16 * S;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(smem + L::keys);
  int* live = reinterpret_cast<int*>(kbits + nkt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

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
  }
  bool uniform;
  const int nlive = scan_key_tiles<NW>(mask, b, Tk, kbits, live, live + nkt, &uniform);
  const float sc = uniform ? 0.0f : scale * kLog2e;

  // key tile live[i] into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile);
    tma_load_4d(sbase + L::k + s * L::kTile, &kmap, bar, 0, h, live[i] * kTileRows, b);
    tma_load_4d(sbase + L::v + s * L::kTile, &vmap, bar, 0, h, live[i] * kTileRows, b);
  };
  if (threadIdx.x == 0) ring.prologue(nlive, copy_in);

  mbar_wait(qbar, 0);
  __syncwarp();
  uint32_t qa[KS][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qa[kk], tile_addr<DP>(sbase + L::q, warp * 16 + (lane & 7) + (lane & 8),
                                      2 * kk + (lane >> 4)));

  // per thread: rows g and g + 8 of the warp's 16 (index 0 and 1)
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
  float l[2] = {0.0f, 0.0f};            // this thread's share of the running sum

  for (int i = 0; i < nlive; ++i) {
    const int s = i % S;
    ring.acquire(i, nlive, copy_in);
    const uint32_t ks = sbase + L::k + s * L::kTile, vs = sbase + L::v + s * L::kTile;
    const uint64_t bits = kbits[live[i]];

    // S = Q_w K^T: 16 rows x 64 keys
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
    // scale; a masked key is -inf: out of the max, p = 0
    const bool all_keys = bits == ~0ull;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tg + (e & 1);
        sacc[n][e] = (all_keys || ((bits >> key) & 1)) ? sacc[n][e] * sc : -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[n][0], sacc[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[n][2], sacc[n][3]));
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has met no valid key yet keeps max -inf: subtract 0, not
      // -inf (-inf - -inf would be NaN); its o and l are still 0
      msub[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
      alpha[r] = ex2_f32(m[r] - msub[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = ex2_f32(sacc[n][e] - msub[e >> 1]);
        rs[e >> 1] += sacc[n][e];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    uint32_t pa[NT / 2][4];  // P as A fragments of the 4 key slices of 16
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) acc_to_a(pa[j], sacc[2 * j], sacc[2 * j + 1]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
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
      }
    }
    ring.release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // every row saw at least one key that counts, so l > 0
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= Tq) continue;
    bf16* orow = o + (((size_t)b * Tq + t) * H + h) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(oacc[n][2 * r] * inv[r], oacc[n][2 * r + 1] * inv[r]);
    }
    if (lse != nullptr && tg == 0) lse[(size_t)bh * Tq + t] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int DP, int BQ>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* o, void* lse, int B, int Tq, int Tk, int H, int D,
                              int depth, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = rows_map(&qm, q, B, Tq, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&km, k, B, Tk, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&vm, v, B, Tk, H, D, DP);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<DP, BQ>::total(Tk);
  auto kernel = attn_fwd_kernel<DP, BQ>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, BQ * 2, smem, stream>>>(qm, km, vm, (const unsigned char*)mask, (bf16*)o,
                                         (float*)lse, Tq, Tk, H, D,
                                         1.0f / sqrtf((float)depth));
  return cudaGetLastError();
}

}  // namespace edm

// q: (B, Tq, H, D), k and v: (B, Tk, H, D), o: (B, Tq, H, D), all bf16 with
// 16-byte aligned bases; mask: (B, Tk) bool (1 = attend) or null; lse: f32
// (B*H, Tq) or null. D % 8 == 0, 8 <= D <= 64; the scores are scaled by
// depth^-1/2 (depth <= D: the head depth before the wrapper padded it);
// block_q 64 or 128 query rows per block.
extern "C" int edm_attention(const void* q, const void* k, const void* v, const void* mask,
                             void* o, void* lse, int B, int Tq, int Tk, int H, int D,
                             int depth, int block_q, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 8 || D > 64 || D % 8 || depth < 1 || depth > D || Tq < 1 || Tk < 1 || B < 1 ||
      H < 1 || (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) {
    if (block_q == 64)
      return (int)launch_fwd<32, 64>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, depth, s);
    return (int)launch_fwd<32, 128>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, depth, s);
  }
  if (block_q == 64)
    return (int)launch_fwd<64, 64>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, depth, s);
  return (int)launch_fwd<64, 128>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, depth, s);
}
