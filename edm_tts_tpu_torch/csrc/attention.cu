// K3: bidirectional multi-head attention with a key-padding mask.
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha (_attn_kernel):
// softmax(Q K^T * D^-1/2 + key mask) V over (B, T, H, D) bf16, f32
// statistics and accumulation.
//
// What bounds it on the H100: at the slice's shapes (T 600-650, D 24 or 64)
// the score matrix is 4*T^2 bytes per head, far more than Q, K and V
// together, so the one thing to get right is that scores and probabilities
// never reach device memory. The Pallas kernel keeps the whole K/V row of a
// head resident; here K+V at T=650, D=64 would take ~166 KB of the 227 KB
// of shared memory, so K/V stream through in 64-key tiles with an online
// softmax (the result then matches to a tolerance, not bit for bit).
//
// Design: one block of 4 warps per (batch*head, 64-query tile); each warp
// owns 16 query rows. Per KV tile: S = Q K^T with WMMA bf16 -> f32 into
// shared memory, a running max / sum per row in f32, P = exp(S - m) rounded
// to bf16 (as the Pallas kernel rounds p before its P V product), and O is
// rescaled and accumulated in f32 shared memory. Masked keys get p = 0
// explicitly and never enter the running max, so a row whose first tiles
// are all masked is still right. A batch row whose mask holds no valid key
// at all attends uniformly to every key (the mean of V), as the Pallas
// kernel's -1e30 bias and the plain version give. D is padded with zeros to DP (32 or 64),
// the MMA depth; the padded lanes add nothing and are not written back.
//
// With a non-null ``lse`` it also writes each query row's log-sum-exp of
// the scaled, masked scores, m + log(l) in f32 (B*H, Tq), as the Pallas
// kernel's ``return_lse`` does: the statistic K4 (attention_bwd.cu) takes
// to rebuild the probabilities. A row with no valid key has all scores 0
// over all Tk keys, so its LSE is log(Tk).
#include <math.h>

#include "common.cuh"

namespace edm {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kAttnWarps = 4;

template <int DP>
struct AttnSmem {
  static constexpr size_t q = 0;
  static constexpr size_t k = q + kBQ * DP * 2;
  static constexpr size_t v = k + kBK * DP * 2;
  static constexpr size_t valid = v + kBK * DP * 2;
  static constexpr size_t s = valid + kBK * 4;               // f32 16 x BK per warp
  static constexpr size_t p = s + kAttnWarps * 16 * kBK * 4;  // bf16 16 x BK per warp
  static constexpr size_t o = p + kAttnWarps * 16 * kBK * 2;  // f32 16 x DP per warp
  static constexpr size_t stats = o + kAttnWarps * 16 * DP * 4;  // m, l, alpha
  static constexpr size_t total = stats + kAttnWarps * 16 * 3 * 4;
};

template <int DP>
__global__ void __launch_bounds__(kAttnWarps * 32) attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    bf16* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int H, int D,
    float scale) {
  using namespace nvcuda;
  using L = AttnSmem<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::v);
  int* valid = reinterpret_cast<int*>(smem + L::valid);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = reinterpret_cast<float*>(smem + L::s) + warp * 16 * kBK;
  bf16* pw = reinterpret_cast<bf16*>(smem + L::p) + warp * 16 * kBK;
  float* ow = reinterpret_cast<float*>(smem + L::o) + warp * 16 * DP;
  float* mw = reinterpret_cast<float*>(smem + L::stats) + warp * 48;
  float* lw = mw + 16;
  float* aw = mw + 32;

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int nthreads = kAttnWarps * 32;

  for (int e = threadIdx.x; e < kBQ * DP; e += nthreads) {
    const int r = e / DP, d = e - r * DP, t = q0 + r;
    qs[e] = (t < Tq && d < D) ? q[(((size_t)b * Tq + t) * H + h) * D + d]
                              : __float2bfloat16(0.0f);
  }
  for (int e = lane; e < 16 * DP; e += 32) ow[e] = 0.0f;
  if (lane < 16) {
    mw[lane] = -INFINITY;
    lw[lane] = 0.0f;
  }

  // no valid key in this batch row: every score counts as 0 over all keys
  bool any_valid = mask == nullptr;
  for (int t = threadIdx.x; !any_valid && t < Tk; t += nthreads)
    any_valid = mask[(size_t)b * Tk + t] != 0;
  const bool uniform = !__syncthreads_or(any_valid);
  const float sc = uniform ? 0.0f : scale;

  const int row = lane >> 1;         // each row is shared by two lanes,
  const int c0 = (lane & 1) * 32;    // each taking 32 of the tile's keys

  for (int kt = 0; kt < Tk; kt += kBK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int e = threadIdx.x; e < kBK * DP; e += nthreads) {
      const int r = e / DP, d = e - r * DP, t = kt + r;
      const bool in = t < Tk && d < D;
      const size_t i = (((size_t)b * Tk + t) * H + h) * D + d;
      ks[e] = in ? k[i] : __float2bfloat16(0.0f);
      vs[e] = in ? v[i] : __float2bfloat16(0.0f);
    }
    for (int j = threadIdx.x; j < kBK; j += nthreads) {
      const int t = kt + j;
      valid[j] = t < Tk && (mask == nullptr || uniform || mask[(size_t)b * Tk + t] != 0);
    }
    __syncthreads();

    // S = Q_w K^T: (16 x DP) x (DP x BK)
#pragma unroll
    for (int n0 = 0; n0 < kBK; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < DP; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(af, qs + warp * 16 * DP + k0, DP);
        wmma::load_matrix_sync(bfr, ks + n0 * DP + k0, DP);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(sw + n0, acc, kBK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, masked keys excluded
    float mx = -INFINITY;
    for (int c = c0; c < c0 + 32; ++c)
      if (valid[c]) mx = fmaxf(mx, sw[row * kBK + c] * sc);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = mw[row];
    const float m_new = fmaxf(m_old, mx);
    const float alpha = (m_new == -INFINITY) ? 1.0f : expf(m_old - m_new);
    float sum = 0.0f;
    for (int c = c0; c < c0 + 32; ++c) {
      const float p = valid[c] ? expf(sw[row * kBK + c] * sc - m_new) : 0.0f;
      pw[row * kBK + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();
    if ((lane & 1) == 0) {
      lw[row] = lw[row] * alpha + sum;
      mw[row] = m_new;
      aw[row] = alpha;
    }
    __syncwarp();
    for (int e = lane; e < 16 * DP; e += 32) ow[e] *= aw[e / DP];
    __syncwarp();

    // O_w += P_w V: (16 x BK) x (BK x DP)
#pragma unroll
    for (int n0 = 0; n0 < DP; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, ow + n0, DP, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(af, pw + k0, kBK);
        wmma::load_matrix_sync(bfr, vs + k0 * DP + n0, DP);
        wmma::mma_sync(acc, af, bfr, acc);
      }
      wmma::store_matrix_sync(ow + n0, acc, DP, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // every row saw at least one valid key, so l > 0
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, d = e - r * D, t = q0 + warp * 16 + r;
    if (t < Tq) {
      o[(((size_t)b * Tq + t) * H + h) * D + d] = __float2bfloat16(ow[r * DP + d] / lw[r]);
    }
  }
  if (lse != nullptr && lane < 16) {
    const int t = q0 + warp * 16 + lane;
    if (t < Tq) lse[(size_t)bh * Tq + t] = mw[lane] + logf(lw[lane]);
  }
}

template <int DP>
static cudaError_t launch_attn(const void* q, const void* k, const void* v,
                               const void* mask, void* o, void* lse, int B, int Tq,
                               int Tk, int H, int D, cudaStream_t stream) {
  const size_t smem = AttnSmem<DP>::total;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  attn_kernel<DP><<<grid, kAttnWarps * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const unsigned char*)mask, (bf16*)o, (float*)lse, Tq, Tk, H, D,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace edm

// q: (B, Tq, H, D), k and v: (B, Tk, H, D), o: (B, Tq, H, D), all bf16;
// mask: (B, Tk) bool (1 = attend) or null; lse: f32 (B*H, Tq) or null.
// 1 <= D <= 64.
extern "C" int edm_attention(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse, int B, int Tq,
                             int Tk, int H, int D, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 1 || D > 64 || Tq < 1 || Tk < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return (int)launch_attn<32>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, s);
  return (int)launch_attn<64>(q, k, v, mask, o, lse, B, Tq, Tk, H, D, s);
}
