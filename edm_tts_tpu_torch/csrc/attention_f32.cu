// K3 at f32: bidirectional multi-head attention with a key-padding mask,
// q, k, v and the output in f32.
//
// Replaces edm_tts_tpu/ops/pallas_attention.py::flash_mha (_attn_kernel) at
// f32 inputs, where the Pallas kernel keeps the input dtype: softmax(Q K^T *
// scale + key mask) V over (B, T, H, D) f32, optionally each query row's
// log-sum-exp of the scaled, masked scores (f32 (B*H, Tq), natural log).
// The bf16 kernel (attention.cu) rounds Q, K, V and P to bf16 for mma.sync;
// TF32 tensor-core products would keep ~1e-3 relative error, bf16's problem
// again. This kernel keeps every product in f32 on the FMA units.
//
// What bounds it on the H100: the two products, 4 * Tq * Tk * D FLOPs per
// head, over the card's f32 FMA rate (67 TFLOP/s, no tensor cores); the
// scores never reach device memory.
//
// Design (SIMT, an online softmax): one block of 128 threads per (batch*head,
// 32-query tile). Four neighbouring threads share one query row: each keeps
// the row's float4 chunks c = s, s + 4, ... of Q and of the output
// accumulator in registers, so a score is 4 partial dot products joined by
// two xor shuffles. K and V stream through shared memory in 64-key tiles
// (float4 rows; the four threads of a row read four neighbouring chunks, and
// the eight rows of a warp read the same ones: broadcast, no bank
// conflict). Scores are formed for 16 keys at a time, pre-multiplied by
// scale * log2 e, and the running max, sum and output are rescaled once per
// 16 keys (exp2f, full precision).
//
// The mask: a key tile with no key that counts is skipped; a masked key's
// score is -inf, so it gets p = 0. A batch row whose mask holds no valid key
// at all attends uniformly to every key (scale 0: the mean of V), as the
// Pallas kernel's -1e30 bias and the plain version give; its LSE is log(Tk).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;     // query rows per block
constexpr int kThreads = 128; // 4 threads a row
constexpr int kKeys = 64;     // keys per shared-memory tile
constexpr int kGroup = 16;    // keys per softmax rescale
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DC: float4 chunks of a row (D / 4); each thread holds ceil(DC / 4)
template <int DC>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ o, float* __restrict__ lse,
    int Tq, int Tk, int H, float scale) {
  constexpr int CT = (DC + 3) / 4;  // chunks per thread
  __shared__ float4 ks[kKeys][DC];
  __shared__ float4 vs[kKeys][DC];
  __shared__ unsigned char valid[kKeys];

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int row = threadIdx.x >> 2, s = threadIdx.x & 3;
  const int qi = blockIdx.x * kRows + row;
  const bool live_row = qi < Tq;
  const size_t rstride = (size_t)H * DC;  // float4s between consecutive t

  // a batch row whose mask holds no valid key attends uniformly
  int any = 1;
  if (mask != nullptr) {
    int found = 0;
    for (int j = threadIdx.x; j < Tk; j += kThreads) found |= mask[(size_t)b * Tk + j];
    any = __syncthreads_or(found);
  }
  const bool uniform = !any;
  const unsigned char* mrow = (mask != nullptr && !uniform) ? mask + (size_t)b * Tk : nullptr;
  const float sc = uniform ? 0.0f : scale * kLog2e;

  float4 qr[CT], acc[CT];
  const float4* qp = reinterpret_cast<const float4*>(q) + ((size_t)b * Tq + (live_row ? qi : 0)) * rstride + (size_t)h * DC;
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int c = s + 4 * i;
    qr[i] = (c < DC && live_row) ? qp[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[i].x *= sc; qr[i].y *= sc; qr[i].z *= sc; qr[i].w *= sc;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.0f;

  const float4* kb = reinterpret_cast<const float4*>(k) + (size_t)b * Tk * rstride + (size_t)h * DC;
  const float4* vb = reinterpret_cast<const float4*>(v) + (size_t)b * Tk * rstride + (size_t)h * DC;
  for (int t0 = 0; t0 < Tk; t0 += kKeys) {
    const int n = min(kKeys, Tk - t0);
    int tile_any = 1;
    if (threadIdx.x < kKeys) {
      const int j = threadIdx.x;
      valid[j] = j < n && (mrow == nullptr || mrow[t0 + j]);
    }
    if (mrow != nullptr) {
      tile_any = __syncthreads_or(threadIdx.x < kKeys && valid[threadIdx.x]);
    }
    if (!tile_any) continue;  // uniform across the block
    for (int e = threadIdx.x; e < kKeys * DC; e += kThreads) {
      const int j = e / DC, c = e - j * DC;
      const bool in = j < n;
      ks[j][c] = in ? kb[(size_t)(t0 + j) * rstride + c] : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[j][c] = in ? vb[(size_t)(t0 + j) * rstride + c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      float sv[kGroup];
      float gmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = g0 + jj;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = s + 4 * i;
          if (c < DC) {
            const float4 kv = ks[j][c];
            part = fmaf(qr[i].x, kv.x, part);
            part = fmaf(qr[i].y, kv.y, part);
            part = fmaf(qr[i].z, kv.z, part);
            part = fmaf(qr[i].w, kv.w, part);
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        sv[jj] = (j < n && valid[j]) ? part : -INFINITY;
        gmax = fmaxf(gmax, sv[jj]);
      }
      const float m_new = fmaxf(m, gmax);
      if (m_new == -INFINITY) continue;  // every key so far masked
      const float alpha = exp2f(m - m_new);  // exp2(-inf) = 0 on the first group
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const float p = exp2f(sv[jj] - m);  // 0 for a masked key
        l += p;
        const int j = g0 + jj;
#pragma unroll
        for (int i = 0; i < CT; ++i) {
          const int c = s + 4 * i;
          if (c < DC) {
            const float4 vv = vs[j][c];
            acc[i].x = fmaf(p, vv.x, acc[i].x);
            acc[i].y = fmaf(p, vv.y, acc[i].y);
            acc[i].z = fmaf(p, vv.z, acc[i].z);
            acc[i].w = fmaf(p, vv.w, acc[i].w);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!live_row) return;
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  float4* op = reinterpret_cast<float4*>(o) + ((size_t)b * Tq + qi) * rstride + (size_t)h * DC;
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    const int c = s + 4 * i;
    if (c < DC)
      op[c] = make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
  }
  if (lse != nullptr && s == 0) lse[(size_t)bh * Tq + qi] = (m + log2f(l)) * kLn2;
}

template <int DC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, int B, int Tq, int Tk, int H, float scale, cudaStream_t s) {
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  attn_f32_kernel<DC><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(mask), static_cast<float*>(o),
      static_cast<float*>(lse), Tq, Tk, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous f32 (B, T, H, D), D % 4 == 0 and 4 <= D <= 64, 16-byte
// aligned; mask: bool (B, Tk) or null; lse: f32 (B*H, Tq) or null; scale:
// the score scale (d^-1/2 of the true depth).
extern "C" int edm_attention_f32(const void* q, const void* k, const void* v, const void* mask,
                                 void* o, void* lse, int B, int Tq, int Tk, int H, int D,
                                 float scale, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (D < 4 || D > 64 || D % 4 || Tq < 1 || Tk < 1 || B < 1 || H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D / 4) {
#define EDM_CASE(DC) \
  case DC:           \
    return (int)launch<DC>(q, k, v, mask, o, lse, B, Tq, Tk, H, scale, s);
    EDM_CASE(1) EDM_CASE(2) EDM_CASE(3) EDM_CASE(4) EDM_CASE(5) EDM_CASE(6) EDM_CASE(7)
    EDM_CASE(8) EDM_CASE(9) EDM_CASE(10) EDM_CASE(11) EDM_CASE(12) EDM_CASE(13)
    EDM_CASE(14) EDM_CASE(15) EDM_CASE(16)
#undef EDM_CASE
  }
  return (int)cudaErrorInvalidValue;
}
