// K4 at f32: the backward of K3's f32 kernel (bidirectional multi-head
// attention, key-padding mask), q, k, v, dO and the gradients in f32.
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha_bwd (_dq_kernel,
// _dkv_kernel) at f32 inputs, where the Pallas kernels keep the input dtype.
// Given q, k, v, dO (B, T, H, D) f32, the key mask, the per-row log-sum-exp
// that attention_f32.cu wrote (natural log) and delta = rowsum(dO * O) in
// f32 (computed by the wrapper, as the JAX package computes it in XLA):
//
//   p  = exp(s * scale - lse)        keys that do not count exactly 0
//   dv = p^T dO
//   ds = p * (dO V^T - delta) * scale
//   dq = ds K,   dk = ds^T Q
//
// Arithmetic: split TF32 ("3xTF32") on the tensor cores, on the staging it
// shares with K3-f32 (attn_f32.cuh). Every operand is split once into hi =
// tf32(x) and lo = tf32(x - hi), rounded to nearest (mma.cuh, split_tf32),
// and every product is the three m16n8k8 TF32 products hi*hi + hi*lo +
// lo*hi into f32 accumulators: each product to within ~2^-21 of an f32 one,
// where one TF32 product alone keeps ~2^-11. p and ds stay f32 before their
// split (no bf16 rounding).
//
// What bounds it on the H100: five (T x T x D) products per (batch, head),
// 10 * Tq * Tk * D FLOPs, run as three TF32 products each: the operations
// over 495 / 3 TFLOP/s; the (T, T) score, probability and gradient tiles
// never reach device memory. Besides the products, each fragment costs its
// split (five integer and f32 operations an element), which sets the issue
// rate when every warp splits what it loads.
//
// Design: the bf16 K4's (attention_bwd.cu) two deterministic kernels, with
// S, P, dP and dS in registers:
//   - a block holds 16 own rows (keys or queries) per warp, 8 warps at D
//     > 32 and 4 at D <= 32 (BwdF32Warps), and streams the other side's
//     64-row tiles, which come in by TMA (attn_tile.cuh, rows_map_f32) as
//     DP / 32 boxes of 64 x 32 floats (128-byte rows, 128-byte swizzle: the
//     16-byte chunk j of row r at j ^ (r & 7)) through a ring of
//     kF32BwdStages stages on mbarriers that thread 0 refills; the copy
//     engine zero-fills rows past T and lanes past D (D % 4 == 0, padded to
//     DP 32 or 64, and the k-steps and columns wholly past D are skipped);
//   - each streamed tile is split once for the block (split_stage: hi over
//     the copied values, lo into a second buffer of the same layout, then a
//     block barrier), so that its fragments are loaded split instead of
//     split again by every warp; the own rows are split as they are loaded;
//   - fragments: ldmatrix.x4 for the non-transposed reads (8 rows x 4
//     consecutive floats), plain 32-bit loads for the transposed ones (4
//     row pairs x 8 columns); the swizzle puts each on 32 different banks;
//   - dkv_f32_kernel: one block per (batch*head, own key rows). Per query
//     tile: S^T = K_w Q^T, P^T = 2^(S^T scale log2 e - lse log2 e) (keys
//     that do not count and queries past Tq exactly 0), dv += P^T dO, dP^T =
//     V_w dO^T, dS^T = P^T (dP^T - delta) scale, dk += dS^T Q. A block
//     whose keys all do not count writes zeros.
//   - dq_f32_kernel: one block per (batch*head, own query rows), looping
//     over the key tiles that hold a key that counts: S = Q_w K^T, dP = dO_w
//     V^T, dS as above, dq += dS K.
//   - P^T and dS^T become A operands in place: their accumulators hold
//     columns (2tg, 2tg+1) where m16n8k8's A fragment wants (tg, tg+4), so
//     the products over queries (keys in dq) read the B rows in that
//     order, 2tg for k tg and 2tg+1 for k tg+4 (mm_pt): no shuffle;
//   - each tile's contribution to dv, dk and dq is summed apart and added
//     in f32 (mm_pt): the tensor cores' accumulation truncates, and a chain
//     of hundreds of products into one accumulator drifted to 1e-5.
// Seven T x T x D products instead of five, but no atomics: dq, dk and dv
// are the same to the bit from run to run. A batch row with no valid key
// uses K3's choice: every key counts with score 0 (scale 0), so p = 1/Tk,
// dv is the uniform share of dO and dq = dk = 0, which is what autograd
// through the plain version gives.
#include <math.h>

#include "attn_f32.cuh"

namespace edm {

// Warps of a block at each padded depth: each holds 16 own rows (keys or
// queries), and the block splits each streamed tile once for all of them.
// 8 at DP 64 (one block of 195 KB a multiprocessor), 4 at DP 32 (two of 98
// KB): measured at the s2a micro-batch and the ragged t2s batch, 8 warps
// at DP 64 took 1.40 ms where 4 took 2.24, and 4 at DP 32 0.148 ms where 8
// took 0.222 (H100 80GB HBM3, 700 W).
template <int DP>
struct BwdF32Warps {
  static constexpr int kWarps = DP == 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kOwnRows = 16 * kWarps;
  static constexpr int kOwnTiles = kOwnRows / 64;
};
constexpr int kF32BwdStages = 2;

// The row stride of lse and delta as the kernels take them: Tq rounded up
// to a multiple of 4 floats, so that every 64-query box of a row starts on
// 16 bytes, as the copy engine needs (the wrapper pads them).
static __host__ __device__ __forceinline__ int f32_lse_stride(int Tq) { return (Tq + 3) / 4 * 4; }

template <int DP>
struct BwdF32Smem {
  static constexpr int kTile = kTileRows * DP * 4;            // 64 rows: DP / 32 boxes
  static constexpr int kOwn = BwdF32Warps<DP>::kOwnTiles * kTile;
  static constexpr size_t a = 0;                              // own rows of K or Q
  static constexpr size_t b = a + kOwn;                       // own rows of V or dO
  static constexpr size_t st = b + kOwn;                      // stages: (Q, dO) or (K, V), hi
  static constexpr size_t lo = st + kF32BwdStages * 2 * kTile;  // their lo parts
  static constexpr size_t rows = lo + kF32BwdStages * 2 * kTile;  // stages of lse, delta
  static constexpr size_t bars = rows + kF32BwdStages * 512;  // full[S], empty[S], own
  static constexpr size_t keys = bars + (2 * kF32BwdStages + 1) * 8;
  static size_t total(int Tk) { return 1024 + keys + key_tile_bytes(Tk); }
};

// Element (r, c) of a staged 64-row tile.
static __device__ __forceinline__ float tile_f32(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + f32_offset<kTileRows>(r, c));
}

// c[n] += A B[n] from split fragments for the n < n_use tiles: hi*hi, hi*lo
// and lo*hi (lo*lo left out), each term over every tile before the next,
// so that no product waits for the one just before it on its accumulator.
template <int N>
static __device__ __forceinline__ void mma3(float (*c)[4], const uint32_t ah[4],
                                            const uint32_t al[4], const uint32_t (*bh)[2],
                                            const uint32_t (*bl)[2], int n_use) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_use) mma1688(c[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_use) mma1688(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (n < n_use) mma1688(c[n], al, bh[n][0], bh[n][1]);
}

// Four 8-row x 4-float matrices of a staged tile by ldmatrix (a 16-bit
// instruction, but its lane t gets 32-bit word t % 4 of row t / 4 of each
// matrix: the TF32 fragment layout): the lane gives (row, col), col % 4 ==
// 0, of a row of its matrix (lanes 8i .. 8i + 7, matrix i).
static __device__ __forceinline__ void ldsm_f32(uint32_t r[4], uint32_t tile, int row, int col) {
  ldmatrix_x4(r, tile + f32_offset<kTileRows>(row, col));
}

// acc (16 x 64) = A B^T: A the warp's 16 rows of the own 64-row tile `own`
// from row orow (rows orow + g and orow + g + 8 per thread), split here; B
// the 64 rows of a streamed tile, split already (hi, lo); both over the D
// columns.
template <int DP>
static __device__ __forceinline__ void mm_abt(float acc[8][4], uint32_t own, int orow,
                                              uint32_t hi, uint32_t lo, int lane, int D) {
  const int m = lane >> 3, row = lane & 7;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    if (8 * kk >= D) break;
    uint32_t a[4], ah[4], al[4], bh[8][2], bl[8][2];
    ldsm_f32(a, own, orow + row + 8 * (m & 1), 8 * kk + 4 * (m >> 1));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t h[4], l[4];
      ldsm_f32(h, hi, 8 * n + row + 8 * (m >> 1), 8 * kk + 4 * (m & 1));
      ldsm_f32(l, lo, 8 * n + row + 8 * (m >> 1), 8 * kk + 4 * (m & 1));
      bh[n][0] = h[0], bh[n][1] = h[1], bh[n + 1][0] = h[2], bh[n + 1][1] = h[3];
      bl[n][0] = l[0], bl[n][1] = l[1], bl[n + 1][0] = l[2], bl[n + 1][1] = l[3];
    }
    mma3<8>(acc, ah, al, bh, bl, 8);
  }
}

// acc (16 x DP) += P B: P (16 x 64) the accumulators of an mm_abt, as A
// fragments in place (k tg of step j is column 8j + 2tg, k tg + 4 is 8j +
// 2tg + 1), B a streamed tile split already (hi, lo; its 64 rows are the
// product's k) read in that order; the columns past D are not computed.
// The tile's sum is formed apart and added to acc in f32 (round to
// nearest): the tensor cores' own accumulation drops the low bits of each
// sum, an error that grows with the number of products chained into one
// accumulator (~1e-5 relative after the ~500 of a 1382-query loop, against
// the 2^-16 limit), so no chain is longer than one tile's 24.
template <int DP>
static __device__ __forceinline__ void mm_pt(float acc[DP / 8][4], const float p[8][4],
                                             const unsigned char* hi, const unsigned char* lo,
                                             int D, int g, int tg) {
  const int n_use = (D + 7) / 8;
  float sum[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) sum[n][0] = sum[n][1] = sum[n][2] = sum[n][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ah[4], al[4], bh[DP / 8][2], bl[DP / 8][2];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      if (n >= n_use) break;
      bh[n][0] = __float_as_uint(tile_f32(hi, 8 * j + 2 * tg, 8 * n + g));
      bh[n][1] = __float_as_uint(tile_f32(hi, 8 * j + 2 * tg + 1, 8 * n + g));
      bl[n][0] = __float_as_uint(tile_f32(lo, 8 * j + 2 * tg, 8 * n + g));
      bl[n][1] = __float_as_uint(tile_f32(lo, 8 * j + 2 * tg + 1, 8 * n + g));
    }
    mma3<DP / 8>(sum, ah, al, bh, bl, n_use);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += sum[n][e];
}

template <int DP>
__global__ void __launch_bounds__(BwdF32Warps<DP>::kThreads) dkv_f32_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap lsemap, const __grid_constant__ CUtensorMap deltamap,
    const unsigned char* __restrict__ mask, float* __restrict__ dk, float* __restrict__ dv,
    int Tq, int Tk, int H, int D, float scale) {
  constexpr int ND = DP / 8, S = kF32BwdStages;
  using L = BwdF32Smem<DP>;
  using W = BwdF32Warps<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + (uint32_t)L::bars, sbase + (uint32_t)L::bars + 8 * S};
  const uint32_t own = sbase + (uint32_t)L::bars + 16 * S;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(smem + L::keys);
  int* live = reinterpret_cast<int*>(kbits + nkt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * W::kOwnRows;

  if (threadIdx.x == 0) {
    ring.init(W::kWarps);
    mbar_init(own, 1);
    mbar_init_fence();
  }
  bool uniform;
  scan_key_tiles<W::kWarps>(mask, b, Tk, kbits, live, live + nkt, &uniform);
  // this warp's 16 keys lie in 64-key tile kt, from bit 16 (warp % 4)
  const int kt = k0 / kTileRows + (warp >> 2);
  const uint64_t bits = kt < nkt ? kbits[kt] : 0;
  uint64_t block_bits = 0;
  for (int j = k0 / kTileRows; j < k0 / kTileRows + W::kOwnTiles && j < nkt; ++j)
    block_bits |= kbits[j];
  if (block_bits == 0) {  // no key of the block counts: exactly zero dk and dv
    for (int e = threadIdx.x; e < W::kOwnRows * (D / 2); e += W::kThreads) {
      const int r = e / (D / 2), t = k0 + r;
      const size_t i = (((size_t)b * Tk + t) * H + h) * D + 2 * (e - r * (D / 2));
      if (t < Tk) {
        *reinterpret_cast<float2*>(dk + i) = make_float2(0.0f, 0.0f);
        *reinterpret_cast<float2*>(dv + i) = make_float2(0.0f, 0.0f);
      }
    }
    return;
  }
  const float sc = uniform ? 0.0f : scale * kLog2e;  // scores to the log2 domain
  const float scd = uniform ? 0.0f : scale;          // ds's factor
  const int nqt = (Tq + kTileRows - 1) / kTileRows;
  const int ld = f32_lse_stride(Tq);

  // query tile i (with its lse and delta columns) into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile + 2 * kTileRows * 4);
    load_tiles<DP>(sbase + L::st + s * 2 * L::kTile, &qmap, bar, h, i * kTileRows, b, 1);
    load_tiles<DP>(sbase + L::st + (2 * s + 1) * L::kTile, &domap, bar, h, i * kTileRows, b, 1);
    // flat (B*H*ld): a box past this row's Tq reads its padding and the next
    // row (or zeros past the last), and those queries are masked below
    tma_load_1d(sbase + L::rows + s * 512, &lsemap, bar, bh * ld + i * kTileRows);
    tma_load_1d(sbase + L::rows + s * 512 + 256, &deltamap, bar, bh * ld + i * kTileRows);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * L::kOwn);
    load_tiles<DP>(sbase + L::a, &kmap, own, h, k0, b, W::kOwnTiles);
    load_tiles<DP>(sbase + L::b, &vmap, own, h, k0, b, W::kOwnTiles);
    ring.prologue(nqt, copy_in);
  }

  // the keys of this thread's rows r0 and r0 + 8 of its 64-key tile that count
  const int r0 = 16 * (warp & 3) + g;
  const bool kv0 = (bits >> r0) & 1, kv1 = (bits >> (r0 + 8)) & 1;
  // the warp's own 64-row tile of K and of V
  const uint32_t ks = sbase + L::a + (warp >> 2) * L::kTile;
  const uint32_t vs = sbase + L::b + (warp >> 2) * L::kTile;
  mbar_wait(own, 0);
  __syncwarp();
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.0f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.0f;
  }

  for (int i = 0; i < nqt; ++i) {
    const int s = i % S;
    ring.acquire(i, nqt, copy_in);
    split_stage(smem + L::st + s * 2 * L::kTile, smem + L::lo + s * 2 * L::kTile,
                2 * L::kTile);
    __syncthreads();
    const uint32_t qs = sbase + L::st + s * 2 * L::kTile, dos = qs + L::kTile;
    const uint32_t qlo = sbase + L::lo + s * 2 * L::kTile, dolo = qlo + L::kTile;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::rows + s * 512);
    const float* delta_s = lse_s + kTileRows;
    const int qrem = Tq - i * kTileRows;  // queries of this tile that exist

    float pt[8][4];
    mm_abt<DP>(pt, ks, 16 * (warp & 3), qs, qlo, lane, D);  // S^T: 16 keys x 64 queries
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 lz = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tg + (e & 1);
        const bool on = ((e >> 1) ? kv1 : kv0) && col < qrem;
        const float lse2 = ((e & 1) ? lz.y : lz.x) * kLog2e;
        pt[n][e] = on ? exp2f(fmaf(pt[n][e], sc, -lse2)) : 0.0f;
      }
    }
    mm_pt<DP>(dva, pt, smem + (dos - sbase), smem + (dolo - sbase), D, g, tg);  // dv += P^T dO
    float dst[8][4];
    mm_abt<DP>(dst, vs, 16 * (warp & 3), dos, dolo, lane, D);  // dP^T = V_w dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dz = *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[n][e] = pt[n][e] * (dst[n][e] - ((e & 1) ? dz.y : dz.x)) * scd;
    }
    mm_pt<DP>(dka, dst, smem + (qs - sbase), smem + (qlo - sbase), D, g, tg);  // dk += dS^T Q
    ring.release(i);
  }

  store_rows_f32<DP>(dk, dka, b, h, k0 + warp * 16, Tk, H, D, g, tg);
  store_rows_f32<DP>(dv, dva, b, h, k0 + warp * 16, Tk, H, D, g, tg);
}

template <int DP>
__global__ void __launch_bounds__(BwdF32Warps<DP>::kThreads) dq_f32_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const unsigned char* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk, int H, int D,
    float scale) {
  constexpr int ND = DP / 8, S = kF32BwdStages;
  using L = BwdF32Smem<DP>;
  using W = BwdF32Warps<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  const TileRing<S> ring{sbase + (uint32_t)L::bars, sbase + (uint32_t)L::bars + 8 * S};
  const uint32_t own = sbase + (uint32_t)L::bars + 16 * S;
  const int nkt = (Tk + kTileRows - 1) / kTileRows;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(smem + L::keys);
  int* live = reinterpret_cast<int*>(kbits + nkt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * W::kOwnRows;

  if (threadIdx.x == 0) {
    ring.init(W::kWarps);
    mbar_init(own, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * L::kOwn);
    load_tiles<DP>(sbase + L::a, &qmap, own, h, q0, b, W::kOwnTiles);
    load_tiles<DP>(sbase + L::b, &domap, own, h, q0, b, W::kOwnTiles);
  }
  bool uniform;
  const int nlive = scan_key_tiles<W::kWarps>(mask, b, Tk, kbits, live, live + nkt, &uniform);
  const float sc = uniform ? 0.0f : scale * kLog2e;
  const float scd = uniform ? 0.0f : scale;

  // key tile live[i] into stage i % S
  auto copy_in = [&](int i) {
    const int s = i % S;
    const uint32_t bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::kTile);
    load_tiles<DP>(sbase + L::st + s * 2 * L::kTile, &kmap, bar, h, live[i] * kTileRows, b, 1);
    load_tiles<DP>(sbase + L::st + (2 * s + 1) * L::kTile, &vmap, bar, h,
                   live[i] * kTileRows, b, 1);
  };
  if (threadIdx.x == 0) ring.prologue(nlive, copy_in);

  // lse (log2 domain) and delta of this thread's rows; rows past Tq have
  // zero Q and dO, so their ds is 0 whatever these are
  float lse2[2], dl[2];
  const int ld = f32_lse_stride(Tq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + g + 8 * r;
    lse2[r] = t < Tq ? lse[(size_t)bh * ld + t] * kLog2e : 0.0f;
    dl[r] = t < Tq ? delta[(size_t)bh * ld + t] : 0.0f;
  }
  // the warp's own 64-row tile of Q and of dO
  const uint32_t qs = sbase + L::a + (warp >> 2) * L::kTile;
  const uint32_t dos = sbase + L::b + (warp >> 2) * L::kTile;
  mbar_wait(own, 0);
  __syncwarp();
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.0f;

  for (int i = 0; i < nlive; ++i) {
    const int s = i % S;
    ring.acquire(i, nlive, copy_in);
    split_stage(smem + L::st + s * 2 * L::kTile, smem + L::lo + s * 2 * L::kTile,
                2 * L::kTile);
    __syncthreads();
    const uint32_t ks = sbase + L::st + s * 2 * L::kTile, vs = ks + L::kTile;
    const uint32_t klo = sbase + L::lo + s * 2 * L::kTile, vlo = klo + L::kTile;
    const uint64_t bits = kbits[live[i]];
    const bool all_keys = bits == ~0ull;

    float sa[8][4], dp[8][4];
    mm_abt<DP>(sa, qs, 16 * (warp & 3), ks, klo, lane, D);   // S: 16 queries x 64 keys
    mm_abt<DP>(dp, dos, 16 * (warp & 3), vs, vlo, lane, D);  // dP = dO_w V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tg + (e & 1);
        const bool on = all_keys || ((bits >> key) & 1);
        const float p = on ? exp2f(fmaf(sa[n][e], sc, -lse2[e >> 1])) : 0.0f;
        sa[n][e] = p * (dp[n][e] - dl[e >> 1]) * scd;
      }
    }
    mm_pt<DP>(dqa, sa, smem + (ks - sbase), smem + (klo - sbase), D, g, tg);  // dq += dS K
    ring.release(i);
  }

  store_rows_f32<DP>(dq, dqa, b, h, q0 + warp * 16, Tq, H, D, g, tg);
}

template <int DP>
static cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* dout, const void* mask, const void* lse,
                                  const void* delta, void* dq, void* dk, void* dv, int B, int Tq,
                                  int Tk, int H, int D, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom, lm, dlm;
  cudaError_t err = rows_map_f32(&qm, q, B, Tq, H, D);
  if (err == cudaSuccess) err = rows_map_f32(&km, k, B, Tk, H, D);
  if (err == cudaSuccess) err = rows_map_f32(&vm, v, B, Tk, H, D);
  if (err == cudaSuccess) err = rows_map_f32(&dom, dout, B, Tq, H, D);
  if (err == cudaSuccess) err = vec_map(&lm, lse, (size_t)B * H * f32_lse_stride(Tq));
  if (err == cudaSuccess) err = vec_map(&dlm, delta, (size_t)B * H * f32_lse_stride(Tq));
  if (err != cudaSuccess) return err;
  const size_t smem = BwdF32Smem<DP>::total(Tk);
  err = cudaFuncSetAttribute(dkv_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  using W = BwdF32Warps<DP>;
  dkv_f32_kernel<DP><<<dim3((Tk + W::kOwnRows - 1) / W::kOwnRows, B * H), W::kThreads, smem,
                       stream>>>(qm, km, vm, dom, lm, dlm, (const unsigned char*)mask,
                                 (float*)dk, (float*)dv, Tq, Tk, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_f32_kernel<DP><<<dim3((Tq + W::kOwnRows - 1) / W::kOwnRows, B * H), W::kThreads, smem,
                      stream>>>(qm, km, vm, dom, (const unsigned char*)mask, (const float*)lse,
                                (const float*)delta, (float*)dq, Tq, Tk, H, D, scale);
  return cudaGetLastError();
}

}  // namespace edm

// q, k, v, g (dO), dq, dk, dv: contiguous f32 (B, T, H, D), D % 4 == 0 and
// 4 <= D <= 64, 16-byte aligned bases; mask: bool (B, Tk) or null; lse and
// delta: f32 (B*H, ld), 16-byte aligned, ld = Tq rounded up to a multiple of
// 4 (the columns past Tq are not read as values); scale: the score scale
// (d^-1/2 of the true depth).
extern "C" int edm_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                     const void* mask, const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H,
                                     int D, float scale, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 4 || D > 64 || D % 4 || Tq < 1 || Tk < 1 || B < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return (int)launch_bwd_f32<32>(q, k, v, g, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, D,
                                   scale, s);
  return (int)launch_bwd_f32<64>(q, k, v, g, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, D,
                                 scale, s);
}
