// K4: the backward of K3 (bidirectional multi-head attention, key mask).
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha_bwd (_dq_kernel,
// _dkv_kernel). Given q, k, v, dO (B, T, H, D) bf16, the key mask, the
// per-row log-sum-exp that K3 wrote and delta = rowsum(dO * O) in f32
// (computed by the wrapper, as the JAX package computes it in XLA):
//
//   p  = exp(s * d^-1/2 - lse)       masked keys exactly 0
//   dv = p^T dO
//   ds = p * (dO V^T - delta) * d^-1/2
//   dq = ds K,   dk = ds^T Q
//
// bf16 operands, f32 accumulation; p is rounded to bf16 before p^T dO and
// ds before its two products, as the Pallas kernels round them.
//
// What bounds it on the H100: five (T x T x D) products per (batch, head),
// ~48 GFLOP at the s2a training micro-batch (B8 T768 H16 D64), while the
// bytes (q, k, v, dO, dq, dk, dv, lse, delta) are a few tens of MB:
// operations, if the (T, T) score, probability and gradient tiles never
// reach device memory. Here they never leave registers.
//
// Design: FlashAttention-2's two deterministic kernels, each a block of 4
// warps on mma.sync m16n8k16 (bf16, f32 accumulation) with the staging of
// K3 (attn_tile.cuh): tiles by TMA into swizzled shared memory, fragments
// by ldmatrix, a ring of kBwdStages stages on mbarriers that thread 0
// refills as soon as every warp has released a stage.
//   dkv_kernel: one block per (batch*head, 64-key tile). Each warp holds
//     its 16 keys' K and V as A fragments and its dk and dv rows as
//     accumulators for the whole loop over the query tiles, which arrive
//     with their lse and delta columns. Per query tile, in registers:
//     S^T = K_w Q^T, P^T = 2^(S^T d^-1/2 log2 e - lse log2 e) (masked keys
//     and queries past Tq exactly 0), dP^T = V_w dO^T, dS^T = P^T (dP^T -
//     delta) d^-1/2; P^T and dS^T, rounded to bf16, are the A operands of
//     dv += P^T dO and dk += dS^T Q (dO's and Q's fragments by
//     ldmatrix.trans). A tile whose keys are all masked writes zeros.
//   dq_kernel: one block per (batch*head, 64-query tile). Each warp holds
//     its 16 rows of Q and dO as A fragments, their lse and delta, and dq
//     as accumulators; it loops over the key tiles that hold a valid key
//     (fully masked tiles add nothing): S = Q_w K^T, dP = dO_w V^T, dS as
//     above, dq += dS K (K's fragments transposed).
// Seven T x T x D products instead of five, but no atomics: dq, dk and dv
// are the same to the bit from run to run. A batch row with no valid key
// uses K3's choice: every key counts with score 0 (scale 0), so p = 1/Tk,
// dv is the uniform share of dO and dq = dk = 0, which is what autograd
// through the plain version gives.
#include <math.h>

#include "attn_tile.cuh"
#include "mma.cuh"

namespace edm {

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdStages = 2;

// The row stride of lse and delta as K4 takes them: Tq rounded up to a
// multiple of 4 floats, so that every 64-query box of a row starts on 16
// bytes, as the copy engine needs (the wrapper pads them).
static __host__ __device__ __forceinline__ int lse_stride(int Tq) { return (Tq + 3) / 4 * 4; }

template <int DP>
struct BwdSmem {
  static constexpr int kTile = kTileRows * DP * 2;
  static constexpr size_t a = 0;                            // own tile (K or Q)
  static constexpr size_t b = a + kTile;                    // own tile (V or dO)
  static constexpr size_t c = b + kTile;                    // stages of the streamed Q or K
  static constexpr size_t d = c + kBwdStages * kTile;       // stages of the streamed dO or V
  static constexpr size_t rows = d + kBwdStages * kTile;    // stages of lse, delta (64 f32 each)
  static constexpr size_t bars = rows + kBwdStages * 512;   // full[S], empty[S], own
  static constexpr size_t keys = bars + (2 * kBwdStages + 1) * 8;
  static size_t total(int Tk) { return 1024 + keys + key_tile_bytes(Tk); }
};

// The 16 rows of this warp in a swizzled 64-row tile as A fragments.
template <int DP>
static __device__ __forceinline__ void load_a(uint32_t frag[DP / 16][4], uint32_t tile,
                                              int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldmatrix_x4(frag[kk], tile_addr<DP>(tile, warp * 16 + (lane & 7) + (lane & 8),
                                        2 * kk + (lane >> 4)));
}

// acc (16 x 64) = A (16 x DP fragments) x B^T, B a swizzled 64-row tile
// (its rows are the 64 output columns).
template <int DP>
static __device__ __forceinline__ void mm_abt(float acc[8][4], uint32_t a[DP / 16][4],
                                              uint32_t tile, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t fb[4];
      ldmatrix_x4(fb, tile_addr<DP>(tile, np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
      mma16816(acc[2 * np], a[kk], fb[0], fb[1]);
      mma16816(acc[2 * np + 1], a[kk], fb[2], fb[3]);
    }
  }
}

// acc (16 x DP) += A (16 x 64, as 4 k-step fragments) x B, B a swizzled
// 64-row tile (its rows are the product's k), fragments transposed.
template <int DP>
static __device__ __forceinline__ void mm_acc(float acc[DP / 8][4], uint32_t a[4][4],
                                              uint32_t tile, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, tile_addr<DP>(tile, j * 16 + (lane & 7) + (lane & 8),
                                          2 * np + (lane >> 4)));
      mma16816(acc[2 * np], a[j], fb[0], fb[1]);
      mma16816(acc[2 * np + 1], a[j], fb[2], fb[3]);
    }
  }
}

// A warp's 16 x DP accumulators to rows [t0, t0 + 16) of a (B, T, H, D)
// bf16 tensor (rows g and g + 8 of each thread; lanes past D not written).
template <int DP>
static __device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                                  float acc[DP / 8][4], int b, int h,
                                                  int t0, int T, int H, int D, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + g + 8 * r;
    if (t >= T) continue;
    bf16* row = dst + (((size_t)b * T + t) * H + h) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (n * 8 < D)
        *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads) dkv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap lsemap, const __grid_constant__ CUtensorMap deltamap,
    const unsigned char* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int Tq, int Tk, int H, int D, float scale) {
  constexpr int ND = DP / 8, KS = DP / 16, S = kBwdStages;
  using L = BwdSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + L::bars, sbase + L::bars + 8 * S};
  const uint32_t own = sbase + L::bars + 16 * S;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(smem + L::keys);
  int* live = reinterpret_cast<int*>(kbits + nkt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kTileRows;

  if (threadIdx.x == 0) {
    ring.init(kBwdWarps);
    mbar_init(own, 1);
    mbar_init_fence();
  }
  bool uniform;
  scan_key_tiles<kBwdWarps>(mask, b, Tk, kbits, live, live + nkt, &uniform);
  const uint64_t bits = kbits[blockIdx.x];
  if (bits == 0) {  // every key of the tile is masked: exactly zero dk and dv
    const uint32_t zero = 0;
    for (int e = threadIdx.x; e < kTileRows * (D / 2); e += kBwdThreads) {
      const int r = e / (D / 2), t = k0 + r;
      const size_t i = (((size_t)b * Tk + t) * H + h) * D + 2 * (e - r * (D / 2));
      if (t < Tk) {
        *reinterpret_cast<uint32_t*>(dk + i) = zero;
        *reinterpret_cast<uint32_t*>(dv + i) = zero;
      }
    }
    return;
  }
  const float sc = uniform ? 0.0f : scale * kLog2e;  // scores to the log2 domain
  const float scd = uniform ? 0.0f : scale;          // ds's factor
  const int nqt = (Tq + kTileRows - 1) / kTileRows;
  const int ld = lse_stride(Tq);

  // query tile i (with its lse and delta columns) into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile + 2 * kTileRows * 4);
    tma_load_4d(sbase + L::c + s * L::kTile, &qmap, bar, 0, h, i * kTileRows, b);
    tma_load_4d(sbase + L::d + s * L::kTile, &domap, bar, 0, h, i * kTileRows, b);
    // flat (B*H*ld): a box past this row's Tq reads its padding and the next
    // row (or zeros past the last), and those queries are masked below
    tma_load_1d(sbase + L::rows + s * 512, &lsemap, bar, bh * ld + i * kTileRows);
    tma_load_1d(sbase + L::rows + s * 512 + 256, &deltamap, bar, bh * ld + i * kTileRows);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * L::kTile);
    tma_load_4d(sbase + L::a, &kmap, own, 0, h, k0, b);
    tma_load_4d(sbase + L::b, &vmap, own, 0, h, k0, b);
    ring.prologue(nqt, copy_in);
  }

  // the keys of this thread's rows g and g + 8 that count
  const bool kv0 = (bits >> (warp * 16 + g)) & 1, kv1 = (bits >> (warp * 16 + g + 8)) & 1;
  mbar_wait(own, 0);
  __syncwarp();
  uint32_t ka[KS][4], va[KS][4];
  load_a<DP>(ka, sbase + L::a, warp, lane);
  load_a<DP>(va, sbase + L::b, warp, lane);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.0f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.0f;
  }

  for (int i = 0; i < nqt; ++i) {
    const int s = i % S;
    ring.acquire(i, nqt, copy_in);
    const uint32_t qs = sbase + L::c + s * L::kTile, dos = sbase + L::d + s * L::kTile;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::rows + s * 512);
    const float* delta_s = lse_s + kTileRows;
    const int qrem = Tq - i * kTileRows;  // queries of this tile that exist

    float st[8][4], dpt[8][4];
    mm_abt<DP>(st, ka, qs, lane);    // S^T: this warp's 16 keys x 64 queries
    mm_abt<DP>(dpt, va, dos, lane);  // dP^T = V_w dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 lz = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * tg);
      const float2 dz = *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tg + (e & 1);
        const bool on = ((e >> 1) ? kv1 : kv0) && col < qrem;
        const float lse2 = ((e & 1) ? lz.y : lz.x) * kLog2e;
        const float del = (e & 1) ? dz.y : dz.x;
        const float p = on ? ex2_f32(st[n][e] * sc - lse2) : 0.0f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - del) * scd;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_to_a(pa[j], st[2 * j], st[2 * j + 1]);
      acc_to_a(dsa[j], dpt[2 * j], dpt[2 * j + 1]);
    }
    mm_acc<DP>(dva, pa, dos, lane);  // dv += P^T dO
    mm_acc<DP>(dka, dsa, qs, lane);  // dk += dS^T Q
    ring.release(i);
  }

  store_rows<DP>(dk, dka, b, h, k0 + warp * 16, Tk, H, D, lane);
  store_rows<DP>(dv, dva, b, h, k0 + warp * 16, Tk, H, D, lane);
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads) dq_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const unsigned char* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Tq, int Tk, int H, int D,
    float scale) {
  constexpr int ND = DP / 8, KS = DP / 16, S = kBwdStages;
  using L = BwdSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + L::bars, sbase + L::bars + 8 * S};
  const uint32_t own = sbase + L::bars + 16 * S;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(smem + L::keys);
  int* live = reinterpret_cast<int*>(kbits + nkt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kTileRows;

  if (threadIdx.x == 0) {
    ring.init(kBwdWarps);
    mbar_init(own, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * L::kTile);
    tma_load_4d(sbase + L::a, &qmap, own, 0, h, q0, b);
    tma_load_4d(sbase + L::b, &domap, own, 0, h, q0, b);
  }
  bool uniform;
  const int nlive = scan_key_tiles<kBwdWarps>(mask, b, Tk, kbits, live, live + nkt, &uniform);
  const float sc = uniform ? 0.0f : scale * kLog2e;
  const float scd = uniform ? 0.0f : scale;

  // key tile live[i] into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile);
    tma_load_4d(sbase + L::c + s * L::kTile, &kmap, bar, 0, h, live[i] * kTileRows, b);
    tma_load_4d(sbase + L::d + s * L::kTile, &vmap, bar, 0, h, live[i] * kTileRows, b);
  };
  if (threadIdx.x == 0) ring.prologue(nlive, copy_in);

  // lse (log2 domain) and delta of this thread's rows g and g + 8; rows past
  // Tq have zero Q and dO, so their ds is 0 whatever these are
  float lse2[2], dl[2];
  const int ld = lse_stride(Tq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    lse2[r] = t < Tq ? lse[(size_t)bh * ld + t] * kLog2e : 0.0f;
    dl[r] = t < Tq ? delta[(size_t)bh * ld + t] : 0.0f;
  }
  mbar_wait(own, 0);
  __syncwarp();
  uint32_t qa[KS][4], doa[KS][4];
  load_a<DP>(qa, sbase + L::a, warp, lane);
  load_a<DP>(doa, sbase + L::b, warp, lane);
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;

  for (int i = 0; i < nlive; ++i) {
    const int s = i % S;
    ring.acquire(i, nlive, copy_in);
    const uint32_t ks = sbase + L::c + s * L::kTile, vs = sbase + L::d + s * L::kTile;
    const uint64_t bits = kbits[live[i]];
    const bool all_keys = bits == ~0ull;

    float sa[8][4], dp[8][4];
    mm_abt<DP>(sa, qa, ks, lane);   // S: this warp's 16 queries x 64 keys
    mm_abt<DP>(dp, doa, vs, lane);  // dP = dO_w V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tg + (e & 1);
        const bool on = all_keys || ((bits >> key) & 1);
        const float p = on ? ex2_f32(sa[n][e] * sc - lse2[e >> 1]) : 0.0f;
        sa[n][e] = p * (dp[n][e] - dl[e >> 1]) * scd;
      }
    }
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_to_a(dsa[j], sa[2 * j], sa[2 * j + 1]);
    mm_acc<DP>(dqa, dsa, ks, lane);  // dq += dS K
    ring.release(i);
  }

  store_rows<DP>(dq, dqa, b, h, q0 + warp * 16, Tq, H, D, lane);
}

template <int DP>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* mask, const void* lse, const void* delta, void* dq,
                              void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
                              int depth, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom, lm, dlm;
  cudaError_t err = rows_map(&qm, q, B, Tq, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&km, k, B, Tk, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&vm, v, B, Tk, H, D, DP);
  if (err == cudaSuccess) err = rows_map(&dom, dout, B, Tq, H, D, DP);
  if (err == cudaSuccess) err = vec_map(&lm, lse, (size_t)B * H * lse_stride(Tq));
  if (err == cudaSuccess) err = vec_map(&dlm, delta, (size_t)B * H * lse_stride(Tq));
  if (err != cudaSuccess) return err;
  const size_t smem = BwdSmem<DP>::total(Tk);
  const float scale = 1.0f / sqrtf((float)depth);
  err = cudaFuncSetAttribute(dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<DP><<<dim3((Tk + kTileRows - 1) / kTileRows, B * H), kBwdThreads, smem, stream>>>(
      qm, km, vm, dom, lm, dlm, (const unsigned char*)mask, (bf16*)dk, (bf16*)dv, Tq, Tk, H,
      D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DP><<<dim3((Tq + kTileRows - 1) / kTileRows, B * H), kBwdThreads, smem, stream>>>(
      qm, km, vm, dom, (const unsigned char*)mask, (const float*)lse, (const float*)delta,
      (bf16*)dq, Tq, Tk, H, D, scale);
  return cudaGetLastError();
}

}  // namespace edm

// q, dout, dq: (B, Tq, H, D); k, v, dk, dv: (B, Tk, H, D), all bf16 with
// 16-byte aligned bases; mask: (B, Tk) bool (1 = attend) or null; lse and
// delta: f32 (B*H, ld), 16-byte aligned, ld = Tq rounded up to a multiple
// of 4 (the columns past Tq are not read as values). D % 8 == 0, 8 <= D <= 64; the
// scores are scaled by depth^-1/2 (depth <= D, the head depth before the
// wrapper padded it).
extern "C" int edm_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv, int B,
                                 int Tq, int Tk, int H, int D, int depth, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 8 || D > 64 || D % 8 || depth < 1 || depth > D || Tq < 1 || Tk < 1 || B < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return (int)launch_bwd<32>(q, k, v, dout, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, D,
                               depth, s);
  return (int)launch_bwd<64>(q, k, v, dout, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, D,
                             depth, s);
}
