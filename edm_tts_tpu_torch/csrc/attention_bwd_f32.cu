// K4 at f32: the backward of K3's f32 kernel (bidirectional multi-head
// attention, key-padding mask), q, k, v, dO and the gradients in f32.
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha_bwd (_dq_kernel,
// _dkv_kernel) at f32 inputs, where the Pallas kernels keep the input dtype.
// Given q, k, v, dO (B, T, H, D) f32, the key mask, the per-row log-sum-exp
// that attention_f32.cu wrote (f32 (B*H, Tq), natural log) and delta =
// rowsum(dO * O) in f32 (computed by the wrapper, as the JAX package
// computes it in XLA):
//
//   p  = exp(s * scale - lse)        keys that do not count exactly 0
//   dv = p^T dO
//   ds = p * (dO V^T - delta) * scale
//   dq = ds K,   dk = ds^T Q
//
// Every product and sum in f32 on the FMA units, no rounding of p or ds:
// TF32 tensor-core products would keep ~1e-3 relative error (the bf16
// kernel's problem again), as attention_f32.cu sets out for the forward.
//
// What bounds it on the H100: five (T x T x D) products per (batch, head),
// 10 * Tq * Tk * D FLOPs, over the card's f32 FMA rate (67 TFLOP/s, no
// tensor cores); the (T, T) score, probability and gradient tiles never
// reach device memory.
//
// Design (SIMT, FlashAttention-2's two deterministic passes, no atomics, so
// dq, dk and dv are the same to the bit from run to run; the thread layout
// of attention_f32.cu): blocks of 128 threads, four neighbouring threads
// sharing one row, each keeping the row's float4 chunks c = s, s + 4, ... in
// registers, so a dot product is 4 partial sums joined by two xor shuffles.
//   dkv_kernel: one block per (batch*head, 32-key tile). Each row's K
//     (pre-multiplied by scale * log2 e) and V, and its dk and dv
//     accumulators, stay in registers for the whole loop over the query
//     tiles, which stream through shared memory 64 rows at a time with
//     their lse (times log2 e) and delta. Per query: s = K_j . Q_i, p =
//     2^(s - lse_i log2 e) (0 for a key that does not count), dp = V_j .
//     dO_i, ds = p (dp - delta_i) scale; dv_j += p dO_i, dk_j += ds Q_i. A
//     block whose 32 keys all do not count writes zeros.
//   dq_kernel: one block per (batch*head, 32-query tile). Each row's Q (pre-
//     scaled as K above), dO, lse and delta and its dq accumulator stay in
//     registers; the key tiles that hold a key that counts stream through
//     shared memory 64 rows at a time (a tile with none adds nothing): s, p,
//     dp and ds as above, dq_i += ds K_j.
// A batch row whose mask holds no valid key uses K3's choice: every key
// counts with score 0 (scale 0), so p = 1/Tk, dv is the uniform share of dO
// and dq = dk = 0, which is what autograd through the plain version gives.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;     // own rows (keys or queries) per block
constexpr int kThreads = 128; // 4 threads a row
constexpr int kTile = 64;     // streamed rows per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float4 scale4(float4 a, float x) {
  return make_float4(a.x * x, a.y * x, a.z * x, a.w * x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// the sum of one row's dot product over its four threads
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  return part + __shfl_xor_sync(0xffffffffu, part, 2);
}

// 1 if batch row b's mask holds a valid key (or there is no mask); every
// thread of the block calls it
__device__ __forceinline__ int has_valid_key(const unsigned char* mask, int b, int Tk) {
  if (mask == nullptr) return 1;
  int found = 0;
  for (int j = threadIdx.x; j < Tk; j += kThreads) found |= mask[(size_t)b * Tk + j];
  return __syncthreads_or(found);
}

// DC: float4 chunks of a row (D / 4); each thread holds ceil(DC / 4)
template <int DC>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const unsigned char* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int Tq, int Tk, int H, float scale) {
  constexpr int CT = (DC + 3) / 4;
  __shared__ float4 qs[kTile][DC];
  __shared__ float4 gs[kTile][DC];
  __shared__ float ls[kTile], dl[kTile];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int row = threadIdx.x >> 2, s = threadIdx.x & 3;
  const int kj = blockIdx.x * kRows + row;
  const bool live = kj < Tk;
  const size_t rstride = (size_t)H * DC;  // float4s between consecutive t

  const bool uniform = !has_valid_key(mask, b, Tk);
  const float sc = uniform ? 0.0f : scale;
  const bool counts = live && (mask == nullptr || uniform || mask[(size_t)b * Tk + kj]);
  const bool any_counts = __syncthreads_or(counts);

  const size_t own = ((size_t)b * Tk + (live ? kj : 0)) * rstride + (size_t)h * DC;
  float4 kr[CT], vr[CT], dka[CT], dva[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int c = s + 4 * i;
    const bool in = c < DC && counts;
    kr[i] = in ? scale4(reinterpret_cast<const float4*>(k)[own + c], sc * kLog2e) : zero4();
    vr[i] = in ? reinterpret_cast<const float4*>(v)[own + c] : zero4();
    dka[i] = zero4();
    dva[i] = zero4();
  }

  const float4* qb = reinterpret_cast<const float4*>(q) + (size_t)b * Tq * rstride + (size_t)h * DC;
  const float4* gb = reinterpret_cast<const float4*>(g) + (size_t)b * Tq * rstride + (size_t)h * DC;
  for (int t0 = 0; any_counts && t0 < Tq; t0 += kTile) {
    const int n = min(kTile, Tq - t0);
    for (int e = threadIdx.x; e < kTile * DC; e += kThreads) {
      const int i = e / DC, c = e - i * DC;
      const bool in = i < n;
      qs[i][c] = in ? qb[(size_t)(t0 + i) * rstride + c] : zero4();
      gs[i][c] = in ? gb[(size_t)(t0 + i) * rstride + c] : zero4();
    }
    if (threadIdx.x < kTile) {
      const int i = threadIdx.x;
      ls[i] = i < n ? lse[(size_t)bh * Tq + t0 + i] * kLog2e : 0.0f;
      dl[i] = i < n ? delta[(size_t)bh * Tq + t0 + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      float ps = 0.0f, pd = 0.0f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = s + 4 * j;
        if (c < DC) {
          ps = dot4(kr[j], qs[i][c], ps);
          pd = dot4(vr[j], gs[i][c], pd);
        }
      }
      const float st = row_sum(ps), dp = row_sum(pd);
      const float p = counts ? exp2f(st - ls[i]) : 0.0f;
      const float ds = p * (dp - dl[i]) * sc;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = s + 4 * j;
        if (c < DC) {
          axpy4(dva[j], p, gs[i][c]);
          axpy4(dka[j], ds, qs[i][c]);
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int c = s + 4 * i;
    if (c < DC) {
      reinterpret_cast<float4*>(dk)[own + c] = dka[i];
      reinterpret_cast<float4*>(dv)[own + c] = dva[i];
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ g, const unsigned char* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int Tq, int Tk, int H, float scale) {
  constexpr int CT = (DC + 3) / 4;
  __shared__ float4 ks[kTile][DC];
  __shared__ float4 vs[kTile][DC];
  __shared__ unsigned char valid[kTile];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int row = threadIdx.x >> 2, s = threadIdx.x & 3;
  const int qi = blockIdx.x * kRows + row;
  const bool live = qi < Tq;
  const size_t rstride = (size_t)H * DC;

  const bool uniform = !has_valid_key(mask, b, Tk);
  const unsigned char* mrow = (mask != nullptr && !uniform) ? mask + (size_t)b * Tk : nullptr;
  const float sc = uniform ? 0.0f : scale;

  const size_t own = ((size_t)b * Tq + (live ? qi : 0)) * rstride + (size_t)h * DC;
  float4 qr[CT], gr[CT], dqa[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int c = s + 4 * i;
    const bool in = c < DC && live;
    qr[i] = in ? scale4(reinterpret_cast<const float4*>(q)[own + c], sc * kLog2e) : zero4();
    gr[i] = in ? reinterpret_cast<const float4*>(g)[own + c] : zero4();
    dqa[i] = zero4();
  }
  const float l = live ? lse[(size_t)bh * Tq + qi] * kLog2e : 0.0f;
  const float del = live ? delta[(size_t)bh * Tq + qi] : 0.0f;

  const float4* kb = reinterpret_cast<const float4*>(k) + (size_t)b * Tk * rstride + (size_t)h * DC;
  const float4* vb = reinterpret_cast<const float4*>(v) + (size_t)b * Tk * rstride + (size_t)h * DC;
  for (int t0 = 0; t0 < Tk; t0 += kTile) {
    const int n = min(kTile, Tk - t0);
    if (threadIdx.x < kTile) {
      const int j = threadIdx.x;
      valid[j] = j < n && (mrow == nullptr || mrow[t0 + j]);
    }
    // a tile with no key that counts adds nothing (uniform across the block)
    if (!__syncthreads_or(threadIdx.x < kTile && valid[threadIdx.x])) continue;
    for (int e = threadIdx.x; e < kTile * DC; e += kThreads) {
      const int j = e / DC, c = e - j * DC;
      const bool in = j < n;
      ks[j][c] = in ? kb[(size_t)(t0 + j) * rstride + c] : zero4();
      vs[j][c] = in ? vb[(size_t)(t0 + j) * rstride + c] : zero4();
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      float ps = 0.0f, pd = 0.0f;
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        const int c = s + 4 * i;
        if (c < DC) {
          ps = dot4(qr[i], ks[j][c], ps);
          pd = dot4(gr[i], vs[j][c], pd);
        }
      }
      const float st = row_sum(ps), dp = row_sum(pd);
      const float p = valid[j] ? exp2f(st - l) : 0.0f;
      const float ds = p * (dp - del) * sc;
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        const int c = s + 4 * i;
        if (c < DC) axpy4(dqa[i], ds, ks[j][c]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int c = s + 4 * i;
    if (c < DC) reinterpret_cast<float4*>(dq)[own + c] = dqa[i];
  }
}

template <int DC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const void* mask,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
                   int Tq, int Tk, int H, float scale, cudaStream_t st) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  dkv_f32_kernel<DC><<<dim3((Tk + kRows - 1) / kRows, B * H), kThreads, 0, st>>>(
      qf, kf, vf, gf, m, lf, df, static_cast<float*>(dk), static_cast<float*>(dv), Tq, Tk, H,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_f32_kernel<DC><<<dim3((Tq + kRows - 1) / kRows, B * H), kThreads, 0, st>>>(
      qf, kf, vf, gf, m, lf, df, static_cast<float*>(dq), Tq, Tk, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g (dO), dq, dk, dv: contiguous f32 (B, T, H, D), D % 4 == 0 and
// 4 <= D <= 64, 16-byte aligned; mask: bool (B, Tk) or null; lse, delta: f32
// (B*H, Tq); scale: the score scale (d^-1/2 of the true depth).
extern "C" int edm_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                     const void* mask, const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int B, int Tq, int Tk, int H,
                                     int D, float scale, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 4 || D > 64 || D % 4 || Tq < 1 || Tk < 1 || B < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / 4) {
#define EDM_CASE(DC) \
  case DC:           \
    return (int)launch<DC>(q, k, v, g, mask, lse, delta, dq, dk, dv, B, Tq, Tk, H, scale, st);
    EDM_CASE(1) EDM_CASE(2) EDM_CASE(3) EDM_CASE(4) EDM_CASE(5) EDM_CASE(6) EDM_CASE(7)
    EDM_CASE(8) EDM_CASE(9) EDM_CASE(10) EDM_CASE(11) EDM_CASE(12) EDM_CASE(13)
    EDM_CASE(14) EDM_CASE(15) EDM_CASE(16)
#undef EDM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
