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
// ~10 TFLOP at the s2a training micro-batch (B8 T768 H16 D64), while the
// bytes (q, k, v, o, dO, dq, dk, dv) are a few tens of MB: operations, if
// the (T, T) score and probability tiles never reach device memory. They
// live in shared memory only.
//
// Design (simple first, not tuned): two kernels, each a block of 4 warps
// with WMMA bf16 16x16x16 as in K3, 64-row tiles, D padded with zeros to
// DP (32 or 64), no wgmma, TMA or cp.async.
//   dkv_kernel: one block per (batch*head, 64-key tile); loops over the
//     query tiles; each warp owns 16 keys and keeps its dk and dv rows in
//     WMMA accumulators across the loop. Per query tile it forms s^T, p^T
//     and dp^T = V dO^T for its keys in shared memory.
//   dq_kernel: one block per (batch*head, 64-query tile); loops over the key
//     tiles; each warp owns 16 queries and accumulates dq.
// Both rebuild p from the LSE, so they need no reduction across blocks.
// Keys past Tk and padded query rows get p = 0 explicitly. A batch row
// with no valid key uses K3's choice: every key counts with score 0 (scale
// 0), so p = 1/Tk, dv is the uniform share of dO and dq = dk = 0, which is
// what autograd through the plain version gives.
#include <math.h>

#include "common.cuh"

namespace edm {

constexpr int kBT = 64;  // rows of a query or key tile
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;

template <int DP>
struct BwdSmem {
  static constexpr size_t a = 0;                              // own tile (K or Q), bf16
  static constexpr size_t b = a + kBT * DP * 2;               // own tile (V or dO), bf16
  static constexpr size_t c = b + kBT * DP * 2;               // streamed tile (Q or K)
  static constexpr size_t d = c + kBT * DP * 2;               // streamed tile (dO or V)
  static constexpr size_t rowf0 = d + kBT * DP * 2;           // lse (64 f32)
  static constexpr size_t rowf1 = rowf0 + kBT * 4;            // delta (64 f32)
  static constexpr size_t valid = rowf1 + kBT * 4;            // 64 int
  static constexpr size_t s = valid + kBT * 4;                // f32 16 x 64 per warp
  static constexpr size_t dp = s + kBwdWarps * 16 * kBT * 4;  // f32 16 x 64 per warp
  static constexpr size_t p = dp + kBwdWarps * 16 * kBT * 4;  // bf16 16 x 64 per warp
  static constexpr size_t ds = p + kBwdWarps * 16 * kBT * 2;  // bf16 16 x 64 per warp
  static constexpr size_t total = ds + kBwdWarps * 16 * kBT * 2;
};

// Rows [t0, t0 + 64) of a (B, T, H, D) tensor for batch b, head h into a
// (64, DP) bf16 tile, zeros past T and past D.
template <int DP>
static __device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                                 const bf16* __restrict__ src, int b,
                                                 int h, int t0, int T, int H, int D) {
  for (int e = threadIdx.x; e < kBT * DP; e += kBwdThreads) {
    const int r = e / DP, dd = e - r * DP, t = t0 + r;
    dst[e] = (t < T && dd < D) ? src[(((size_t)b * T + t) * H + h) * D + dd]
                               : __float2bfloat16(0.0f);
  }
}

// out (16 x 64, f32, ld 64) = A (16 x DP, row-major, ld DP) x B^T where B is
// a (64, DP) row-major tile: each 16-row strip of B read as col-major.
template <int DP>
static __device__ __forceinline__ void mm_abt(float* __restrict__ out,
                                              const bf16* __restrict__ a,
                                              const bf16* __restrict__ b) {
  using namespace nvcuda;
#pragma unroll
  for (int n0 = 0; n0 < kBT; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < DP; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(af, a + k0, DP);
      wmma::load_matrix_sync(bfr, b + n0 * DP + k0, DP);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(out + n0, acc, kBT, wmma::mem_row_major);
  }
}

// acc[DP/16] (16 x DP) += A (16 x 64 bf16, ld 64) x B (64 x DP row-major).
template <int DP>
static __device__ __forceinline__ void mm_acc(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>* acc,
    const bf16* __restrict__ a, const bf16* __restrict__ b) {
  using namespace nvcuda;
#pragma unroll
  for (int k0 = 0; k0 < kBT; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + k0, kBT);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b + k0 * DP + j * 16, DP);
      wmma::mma_sync(acc[j], af, bfr, acc[j]);
    }
  }
}

// Write a warp's 16 x DP accumulators to rows [t0, t0 + 16) of a (B, T, H, D)
// bf16 tensor, through the warp's f32 scratch (16 x 64 floats >= 16 x DP).
template <int DP>
static __device__ __forceinline__ void store_rows(
    bf16* __restrict__ dst,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>* acc,
    float* __restrict__ scratch, int b, int h, int t0, int T, int H, int D) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    wmma::store_matrix_sync(scratch + j * 16, acc[j], DP, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, dd = e - r * D, t = t0 + r;
    if (t < T) dst[(((size_t)b * T + t) * H + h) * D + dd] = __float2bfloat16(scratch[r * DP + dd]);
  }
  __syncwarp();
}

// Whether batch row b has no valid key (then every key counts, scale 0).
static __device__ __forceinline__ bool no_valid_key(const unsigned char* __restrict__ mask,
                                                    int b, int Tk) {
  bool any_valid = mask == nullptr;
  for (int t = threadIdx.x; !any_valid && t < Tk; t += kBwdThreads)
    any_valid = mask[(size_t)b * Tk + t] != 0;
  return !__syncthreads_or(any_valid);
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads) dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const unsigned char* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H, int D,
    float scale) {
  using namespace nvcuda;
  using L = BwdSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::a);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::b);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::c);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::d);
  float* lse_s = reinterpret_cast<float*>(smem + L::rowf0);
  float* delta_s = reinterpret_cast<float*>(smem + L::rowf1);
  int* valid = reinterpret_cast<int*>(smem + L::valid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = reinterpret_cast<float*>(smem + L::s) + warp * 16 * kBT;
  float* dpw = reinterpret_cast<float*>(smem + L::dp) + warp * 16 * kBT;
  bf16* pw = reinterpret_cast<bf16*>(smem + L::p) + warp * 16 * kBT;
  bf16* dsw = reinterpret_cast<bf16*>(smem + L::ds) + warp * 16 * kBT;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBT;
  const bool uniform = no_valid_key(mask, b, Tk);
  const float sc = uniform ? 0.0f : scale;

  load_tile<DP>(ks, k, b, h, k0, Tk, H, D);
  load_tile<DP>(vs, v, b, h, k0, Tk, H, D);
  for (int j = threadIdx.x; j < kBT; j += kBwdThreads) {
    const int t = k0 + j;
    valid[j] = t < Tk && (mask == nullptr || uniform || mask[(size_t)b * Tk + t] != 0);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[DP / 16], dv_acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }
  const bf16* kw = ks + warp * 16 * DP;
  const bf16* vw = vs + warp * 16 * DP;

  for (int q0 = 0; q0 < Tq; q0 += kBT) {
    __syncthreads();  // the previous query tile is no longer read
    load_tile<DP>(qs, q, b, h, q0, Tq, H, D);
    load_tile<DP>(dos, dout, b, h, q0, Tq, H, D);
    for (int j = threadIdx.x; j < kBT; j += kBwdThreads) {
      const int t = q0 + j;
      lse_s[j] = t < Tq ? lse[(size_t)bh * Tq + t] : 0.0f;
      delta_s[j] = t < Tq ? delta[(size_t)bh * Tq + t] : 0.0f;
    }
    __syncthreads();

    mm_abt<DP>(sw, kw, qs);    // s^T: this warp's 16 keys x 64 queries
    mm_abt<DP>(dpw, vw, dos);  // dp^T = V dO^T
    __syncwarp();
    for (int e = lane; e < 16 * kBT; e += 32) {
      const int r = e / kBT, c = e - r * kBT;
      const bool live = valid[warp * 16 + r] && q0 + c < Tq;
      const float p = live ? expf(sw[e] * sc - lse_s[c]) : 0.0f;
      pw[e] = __float2bfloat16(p);
      dsw[e] = __float2bfloat16(p * (dpw[e] - delta_s[c]) * sc);
    }
    __syncwarp();
    mm_acc<DP>(dv_acc, pw, dos);  // dv += p^T dO
    mm_acc<DP>(dk_acc, dsw, qs);  // dk += ds^T Q
  }

  store_rows<DP>(dk, dk_acc, sw, b, h, k0 + warp * 16, Tk, H, D);
  store_rows<DP>(dv, dv_acc, sw, b, h, k0 + warp * 16, Tk, H, D);
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const unsigned char* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Tq, int Tk, int H, int D, float scale) {
  using namespace nvcuda;
  using L = BwdSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::a);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::b);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::c);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::d);
  float* lse_s = reinterpret_cast<float*>(smem + L::rowf0);
  float* delta_s = reinterpret_cast<float*>(smem + L::rowf1);
  int* valid = reinterpret_cast<int*>(smem + L::valid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = reinterpret_cast<float*>(smem + L::s) + warp * 16 * kBT;
  float* dpw = reinterpret_cast<float*>(smem + L::dp) + warp * 16 * kBT;
  bf16* dsw = reinterpret_cast<bf16*>(smem + L::ds) + warp * 16 * kBT;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBT;
  const bool uniform = no_valid_key(mask, b, Tk);
  const float sc = uniform ? 0.0f : scale;

  load_tile<DP>(qs, q, b, h, q0, Tq, H, D);
  load_tile<DP>(dos, dout, b, h, q0, Tq, H, D);
  for (int j = threadIdx.x; j < kBT; j += kBwdThreads) {
    const int t = q0 + j;
    lse_s[j] = t < Tq ? lse[(size_t)bh * Tq + t] : 0.0f;
    delta_s[j] = t < Tq ? delta[(size_t)bh * Tq + t] : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[DP / 16];
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);
  const bf16* qw = qs + warp * 16 * DP;
  const bf16* dow = dos + warp * 16 * DP;

  for (int kt = 0; kt < Tk; kt += kBT) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<DP>(ks, k, b, h, kt, Tk, H, D);
    load_tile<DP>(vs, v, b, h, kt, Tk, H, D);
    for (int j = threadIdx.x; j < kBT; j += kBwdThreads) {
      const int t = kt + j;
      valid[j] = t < Tk && (mask == nullptr || uniform || mask[(size_t)b * Tk + t] != 0);
    }
    __syncthreads();

    mm_abt<DP>(sw, qw, ks);    // s: this warp's 16 queries x 64 keys
    mm_abt<DP>(dpw, dow, vs);  // dp = dO V^T
    __syncwarp();
    for (int e = lane; e < 16 * kBT; e += 32) {
      const int r = e / kBT, c = e - r * kBT;
      const bool live = valid[c] && q0 + warp * 16 + r < Tq;
      const float p = live ? expf(sw[e] * sc - lse_s[warp * 16 + r]) : 0.0f;
      dsw[e] = __float2bfloat16(p * (dpw[e] - delta_s[warp * 16 + r]) * sc);
    }
    __syncwarp();
    mm_acc<DP>(dq_acc, dsw, ks);  // dq += ds K
  }

  store_rows<DP>(dq, dq_acc, sw, b, h, q0 + warp * 16, Tq, H, D);
}

template <int DP>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* mask, const void* lse, const void* delta, void* dq,
                              void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
                              cudaStream_t stream) {
  const size_t smem = BwdSmem<DP>::total;
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<DP><<<dim3((Tk + kBT - 1) / kBT, B * H), kBwdThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const unsigned char*)mask, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, Tq, Tk, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DP><<<dim3((Tq + kBT - 1) / kBT, B * H), kBwdThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const unsigned char*)mask, (const float*)lse, (const float*)delta, (bf16*)dq, Tq, Tk,
      H, D, scale);
  return cudaGetLastError();
}

}  // namespace edm

// q, dout, dq: (B, Tq, H, D); k, v, dk, dv: (B, Tk, H, D), all bf16;
// mask: (B, Tk) bool (1 = attend) or null; lse and delta: f32 (B*H, Tq).
// 1 <= D <= 64.
extern "C" int edm_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* mask, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv, int B,
                                 int Tq, int Tk, int H, int D, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 1 || D > 64 || Tq < 1 || Tk < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return (int)launch_bwd<32>(q, k, v, dout, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, D, s);
  return (int)launch_bwd<64>(q, k, v, dout, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, D, s);
}
