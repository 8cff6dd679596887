// K3 at f32: bidirectional multi-head attention with a key-padding mask,
// q, k, v and the output in f32.
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha (_attn_kernel) at
// f32 inputs, where the Pallas kernel keeps the input dtype: softmax(Q K^T *
// scale + key mask) V over (B, T, H, D) f32, optionally each query row's
// log-sum-exp of the scaled, masked scores (f32 (B*H, Tq), natural log), the
// statistic K4-f32 (attention_bwd_f32.cu) takes to rebuild the
// probabilities. The bf16 kernel (attention.cu) rounds Q, K, V and P to
// bf16, and one TF32 product keeps ~2^-11 relative error: neither is an f32
// result.
//
// Arithmetic: split TF32 ("3xTF32") on the tensor cores, staged as K4-f32
// stages it (attn_f32.cuh): every operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and each product is hi*hi + hi*lo + lo*hi with f32
// accumulators, each to within ~2^-21 of an f32 product. The softmax stays
// in f32.
//
// What bounds it on the H100: the two products, 4 * Tq * Tk * D FLOPs per
// head, run as three TF32 products each: the operations over 495 / 3
// TFLOP/s; the (T, T) scores never reach device memory.
//
// Design: a flash forward on warpgroup MMA (wgmma m64nNk8 TF32, both
// operands K-major, as TF32 requires; wgmma.cuh, WgmmaTF32), which reads
// each B tile from shared memory once per 64 query rows where mma.sync
// reads it once per 16.
//   - One block of NWG warpgroups (1 or 2: block_q = 64 NWG query rows,
//     picked by the wrapper from the grid's size) per (batch*head, query
//     tile); each warpgroup owns 64 query rows. Q comes in once by TMA and
//     is split once in place into hi and a lo tile, which stay in shared
//     memory for the whole key loop as S's A operands (a loop-invariant
//     register A operand is what ptxas mishandled: P's split was given Q's
//     lo registers, ~1e-4 off on the H100).
//   - K and V stream in 64-key tiles by TMA (attn_tile.cuh, rows_map_f32:
//     DP / 32 boxes of 64 x 32 floats, 128-byte swizzle; the copy engine
//     zero-fills D up to DP 32 or 64 and the rows past Tk) through a ring of
//     kF32FwdStages stages on mbarriers that thread 0 refills. scan_key_tiles
//     lists the tiles that hold a key that counts; the others are neither
//     copied nor computed.
//   - Each arriving stage is split once for the block: K in place into hi
//     and into a lo tile (split_stage), both K-major B operands of S = Q K^T
//     as they stand; V split and transposed (split_vt) into hi and lo tiles
//     of V^T (DP rows of 64 keys, 128-byte swizzle), the K-major B operand
//     of P V. Then a block barrier.
//   - S = Q_wg K^T: per 8-deep slice of DP three products, both operands
//     from shared memory, into one set of accumulators (Q's lanes past D are
//     zeros), scaled by scale * log2 e; a
//     key that does not count is -inf. An online softmax in the log2 domain
//     (ex2.approx.ftz): the row max is joined across the row's four threads
//     each tile, the row sum stays per thread until the end.
//   - O_w += P V: S's accumulators, split in registers, are the A fragments
//     in place: they hold columns (2tg, 2tg + 1) of each 8 keys where the A
//     fragment wants k (tg, tg + 4), so split_vt stores each 8-key group of
//     V^T in that order (keys 0, 2, 4, 6, 1, 3, 5, 7). Each tile's P V goes
//     into fresh accumulators that are added to O in f32 (the tensor cores
//     truncate as they accumulate; a chain over every tile drifts to ~1e-5).
// No atomics: the output and the LSE are the same to the bit from run to
// run. A batch row whose mask holds no valid key at all attends uniformly to
// every key (scale 0: the mean of V), as the Pallas kernel's -1e30 bias and
// the plain version give; its LSE is log(Tk).
#include <math.h>

#include "attn_f32.cuh"
#include "wgmma.cuh"

namespace edm {

constexpr int kF32FwdStages = 2;

template <int DP, int NWG>
struct FwdF32Smem {
  static constexpr int kTile = kTileRows * DP * 4;  // 64 rows (keys or V^T's DP rows x 64)
  static constexpr int kStage = 5 * kTile;          // K (then K hi), V, K lo, V^T hi, V^T lo
  static constexpr size_t qhi = kF32FwdStages * kStage;  // Q (then Q hi): NWG tiles
  static constexpr size_t qlo = qhi + NWG * kTile;
  static constexpr size_t bars = qlo + NWG * kTile;  // full[S], empty[S], q
  static constexpr size_t keys = bars + (2 * kF32FwdStages + 1) * 8;
  static size_t total(int Tk) { return 1024 + keys + key_tile_bytes(Tk); }
};

// A V tile (64 keys x DP, as TMA staged it) split once for the block and
// transposed into the hi and lo tiles of V^T: row d holds the 64 keys in two
// 128-byte boxes (keys 0-31, 32-63; DP * 128 bytes apart), each 8-key group
// in P's accumulator column order (keys 0, 2, 4, 6, 1, 3, 5, 7), the 16-byte
// chunk j of row d at j ^ (d & 7). A warp reads 32 consecutive keys of one
// 4-column chunk (conflict-free under the TMA swizzle) and writes each
// column's 32 keys into one 128-byte row (32 different banks). The fence
// orders the writes before the products read them.
template <int DP>
static __device__ __forceinline__ void split_vt(const unsigned char* v, unsigned char* hi,
                                                unsigned char* lo) {
  for (int e = threadIdx.x; e < kTileRows * DP / 4; e += blockDim.x) {
    const int r = e & (kTileRows - 1), c = (e >> 6) * 4;  // key, first of 4 columns
    const float4 x = *reinterpret_cast<const float4*>(v + f32_offset<kTileRows>(r, c));
    const int p = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);  // key r's column in V^T
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = f32_offset<DP>(c + i, p);
      uint32_t h, l;
      split_tf32(xs[i], h, l);
      *reinterpret_cast<uint32_t*>(hi + o) = h;
      *reinterpret_cast<uint32_t*>(lo + o) = l;
    }
  }
  fence_proxy_async();
}

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128) attn_f32_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const unsigned char* __restrict__ mask,
    float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int H, int D,
    float scale) {
  constexpr int ND = DP / 8, S = kF32FwdStages;
  using L = FwdF32Smem<DP, NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + (uint32_t)L::bars, sbase + (uint32_t)L::bars + 8 * S};
  const uint32_t qbar = sbase + (uint32_t)L::bars + 16 * S;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(smem + L::keys);
  int* live = reinterpret_cast<int*>(kbits + nkt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * 64 * NWG;

  if (threadIdx.x == 0) {
    ring.init(4 * NWG);
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, NWG * L::kTile);
    load_tiles<DP>(sbase + L::qhi, &qmap, qbar, h, q0, b, NWG);
  }
  bool uniform;
  const int nlive = scan_key_tiles<4 * NWG>(mask, b, Tk, kbits, live, live + nkt, &uniform);
  const float sc = uniform ? 0.0f : scale * kLog2e;  // scores to the log2 domain

  // key tile live[i] into stage i % S: K and V
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile);
    load_tiles<DP>(sbase + s * L::kStage, &kmap, bar, h, live[i] * kTileRows, b, 1);
    load_tiles<DP>(sbase + s * L::kStage + L::kTile, &vmap, bar, h, live[i] * kTileRows, b, 1);
  };
  if (threadIdx.x == 0) ring.prologue(nlive, copy_in);

  // Q split once for the block (the first tile's barrier orders it before
  // the products); the warpgroup's 64 rows are tile warp / 4
  mbar_wait(qbar, 0);
  split_stage(smem + L::qhi, smem + L::qlo, NWG * L::kTile);
  const uint32_t qhs = sbase + L::qhi + (warp >> 2) * L::kTile;
  const uint32_t qls = sbase + L::qlo + (warp >> 2) * L::kTile;

  // per thread: rows g and g + 8 of the warp's 16; sa[4n + 2r + e] and
  // oacc[n][2r + e] are (row g + 8r, column 8n + 2tg + e)
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
  float l[2] = {0.0f, 0.0f};            // this thread's share of the running sum

  for (int i = 0; i < nlive; ++i) {
    const int s = i % S;
    ring.acquire(i, nlive, copy_in);
    unsigned char* st = smem + s * L::kStage;  // K (hi), V, K lo, V^T hi, V^T lo
    split_stage(st, st + 2 * L::kTile, L::kTile);
    split_vt<DP>(st + L::kTile, st + 3 * L::kTile, st + 4 * L::kTile);
    __syncthreads();
    const uint32_t ks = sbase + s * L::kStage;
    const uint64_t bits = kbits[live[i]];
    const bool all_keys = bits == ~0ull;

    // S = Q_wg K^T: 64 rows x 64 keys a warpgroup, slice kk of Q and K at
    // box kk / 4, +32 bytes per slice of 8 (every slice: a branch between
    // products would make ptxas serialize them, and Q's lanes past D are
    // zeros)
    float sa[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const uint32_t off = (kk >> 2) * kF32BoxBytes + (kk & 3) * 32;
      const uint64_t qhi = sw128_desc(qhs + off), qlo = sw128_desc(qls + off);
      const uint64_t khi = sw128_desc(ks + off), klo = sw128_desc(ks + 2 * L::kTile + off);
      WgmmaTF32SS64::run(sa, qhi, khi, kk > 0);
      WgmmaTF32SS64::run(sa, qhi, klo, 1);
      WgmmaTF32SS64::run(sa, qlo, khi, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(sa);

    // scale; a key that does not count is -inf: out of the max, p = 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tg + (e & 1);
        float& x = sa[4 * n + e];
        x = (all_keys || ((bits >> key) & 1)) ? x * sc : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // a live tile holds a key that counts, so the max is finite from the
    // first tile on, where alpha = 2^-inf = 0 (o and l are still 0)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2_f32(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sa[e] = ex2_f32(sa[e] - m[(e >> 1) & 1]);
      rs[(e >> 1) & 1] += sa[e];
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];

    // O_w += P V: P's accumulators as the A fragments of the 8 slices of 8
    // keys (k tg is key 2tg, k tg + 4 key 2tg + 1, the order of V^T's
    // columns), V^T's slice j at box j / 4, +32 bytes per slice
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(sa[4 * j], ph[j][0], pl[j][0]);
      split_tf32(sa[4 * j + 2], ph[j][1], pl[j][1]);
      split_tf32(sa[4 * j + 1], ph[j][2], pl[j][2]);
      split_tf32(sa[4 * j + 3], ph[j][3], pl[j][3]);
    }
    float pv[DP / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = (j >> 2) * (DP * 128) + (j & 3) * 32;
      const uint64_t vhi = sw128_desc(ks + 3 * L::kTile + off);
      const uint64_t vlo = sw128_desc(ks + 4 * L::kTile + off);
      WgmmaTF32<DP>::run(pv, ph[j], vhi, j > 0);
      WgmmaTF32<DP>::run(pv, ph[j], vlo, 1);
      WgmmaTF32<DP>::run(pv, pl[j], vhi, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(pv);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] = oacc[n][0] * alpha[0] + pv[4 * n];
      oacc[n][1] = oacc[n][1] * alpha[0] + pv[4 * n + 1];
      oacc[n][2] = oacc[n][2] * alpha[1] + pv[4 * n + 2];
      oacc[n][3] = oacc[n][3] * alpha[1] + pv[4 * n + 3];
    }
    ring.release(i);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // every row met a key that counts, so l >= 1
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    oacc[n][0] *= inv[0];
    oacc[n][1] *= inv[0];
    oacc[n][2] *= inv[1];
    oacc[n][3] *= inv[1];
  }
  const int t0 = q0 + 16 * warp;
  store_rows_f32<DP>(o, oacc, b, h, t0, Tq, H, D, g, tg);
  if (lse != nullptr && tg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + g + 8 * r;
      if (t < Tq) lse[(size_t)bh * Tq + t] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int DP, int NWG>
static cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                                  const void* mask, void* o, void* lse, int B, int Tq, int Tk,
                                  int H, int D, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = rows_map_f32(&qm, q, B, Tq, H, D);
  if (err == cudaSuccess) err = rows_map_f32(&km, k, B, Tk, H, D);
  if (err == cudaSuccess) err = rows_map_f32(&vm, v, B, Tk, H, D);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdF32Smem<DP, NWG>::total(Tk);
  auto kernel = attn_f32_kernel<DP, NWG>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + 64 * NWG - 1) / (64 * NWG), B * H);
  kernel<<<grid, NWG * 128, smem, stream>>>(qm, km, vm, (const unsigned char*)mask, (float*)o,
                                            (float*)lse, Tq, Tk, H, D, scale);
  return cudaGetLastError();
}

}  // namespace edm

// q, k, v, o: contiguous f32 (B, T, H, D), D % 4 == 0 and 4 <= D <= 64, 16-byte
// aligned bases; mask: bool (B, Tk) or null; lse: f32 (B*H, Tq) or null;
// block_q: query rows per block, 64 or 128; scale: the score scale (d^-1/2 of
// the true depth).
extern "C" int edm_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                                 void* o, void* lse, int B, int Tq, int Tk, int H, int D,
                                 int block_q, float scale, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 4 || D > 64 || D % 4 || Tq < 1 || Tk < 1 || B < 1 || H < 1 || B * H > 65535 ||
      (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return (int)(block_q == 64
                     ? launch_fwd_f32<32, 1>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, scale, s)
                     : launch_fwd_f32<32, 2>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, scale, s));
  return (int)(block_q == 64
                   ? launch_fwd_f32<64, 1>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, scale, s)
                   : launch_fwd_f32<64, 2>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, scale, s));
}
