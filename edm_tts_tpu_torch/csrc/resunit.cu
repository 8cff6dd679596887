// K1: the codec ResidualUnit in one pass per time tile.
//
// Replaces edm_tts_tpu/ops/pallas_resunit.py::fused_residual_unit
// (_fused_forward / _kernel): snake(a1) -> dilated k=7 conv -> snake(a2) ->
// k=1 conv -> + x, with weight norm folded into w7 and w1 by the caller.
//
// What bounds it on the H100: at C=768 the unit is 2*T*C*C*8 = 38 GFLOP per
// 4000 frames, so it wants the tensor cores; its activations move only
// 2*T*C*2 bytes. The weights (7*C*C bf16, 8.3 MB at C=768) cannot be
// resident in one block's 227 KB of shared memory, so each block streams
// them from L2 (they fit the 50 MB L2 and every block reads the same bytes).
//
// Design: one block per (batch row, 16*RB-row time tile). The block holds
// the snake'd input window (tile + 3*dil rows of halo each side) in shared
// memory as bf16, runs the seven shifted products with WMMA bf16 -> f32,
// applies bias + the second snake in the epilogue and keeps the result as
// the bf16 operand of the k=1 product (the Pallas kernel also casts it to
// bf16 there), so no intermediate goes to device memory. The second product
// adds bias and the residual and writes the tile once. RB is the largest of
// 4, 2, 1 whose window fits shared memory (C=768, dil=9 takes RB=2).
#include "common.cuh"

namespace edm {

template <int RB>
__global__ void __launch_bounds__(kThreads) resunit_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a1,
    const bf16* __restrict__ w7, const float* __restrict__ b7,
    const float* __restrict__ a2, const bf16* __restrict__ w1,
    const float* __restrict__ b1, bf16* __restrict__ out, int T, int C,
    int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BT = RB * 16;
  const int halo = 3 * dil;
  const int W = BT + 2 * halo;
  bf16* win = reinterpret_cast<bf16*>(smem);
  bf16* s2 = reinterpret_cast<bf16*>(smem + align128((size_t)W * C * 2));
  float* scratch = reinterpret_cast<float*>(
      smem + align128((size_t)W * C * 2) + align128((size_t)BT * C * 2));

  const int t0 = blockIdx.x * BT;
  const bf16* xb = x + (size_t)blockIdx.y * T * C;
  bf16* ob = out + (size_t)blockIdx.y * T * C;

  // snake(a1) on the window; rows outside [0, T) are the conv's zero padding
  for (int e = threadIdx.x; e < W * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    const int t = t0 - halo + r;
    float v = 0.0f;
    if (t >= 0 && t < T) v = snake(__bfloat162float(xb[(size_t)t * C + c]), a1[c]);
    win[e] = __float2bfloat16(v);
  }
  __syncthreads();

  tile_conv<RB>(win, C, w7, 7, dil, C, C, scratch, [&](int r, int c, float v) {
    s2[r * C + c] = __float2bfloat16(snake(v + b7[c], a2[c]));
  });
  __syncthreads();

  tile_conv<RB>(s2, C, w1, 1, 0, C, C, scratch, [&](int r, int c, float v) {
    const int t = t0 + r;
    if (t < T) {
      const size_t i = (size_t)t * C + c;
      ob[i] = __float2bfloat16(__bfloat162float(xb[i]) + v + b1[c]);
    }
  });
}

static size_t resunit_smem(int rb, int C, int dil) {
  const int bt = rb * 16;
  const int w = bt + 6 * dil;
  return align128((size_t)w * C * 2) + align128((size_t)bt * C * 2) + kWarps * 256 * 4;
}

template <int RB>
static cudaError_t launch_resunit(const void* x, const void* a1, const void* w7,
                                  const void* b7, const void* a2, const void* w1,
                                  const void* b1, void* out, int B, int T, int C,
                                  int dil, cudaStream_t stream) {
  const size_t smem = resunit_smem(RB, C, dil);
  cudaError_t err = cudaFuncSetAttribute(
      resunit_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + RB * 16 - 1) / (RB * 16), B);
  resunit_kernel<RB><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)a1, (const bf16*)w7, (const float*)b7,
      (const float*)a2, (const bf16*)w1, (const float*)b1, (bf16*)out, T, C, dil);
  return cudaGetLastError();
}

}  // namespace edm

// x, out: (B, T, C) bf16; w7: (7, C, C) bf16 [tap][in][out]; w1: (C, C) bf16
// [in][out]; a1, b7, a2, b1: (C,) f32. C % 16 == 0. Returns a cudaError_t.
extern "C" int edm_resunit(const void* x, const void* a1, const void* w7,
                           const void* b7, const void* a2, const void* w1,
                           const void* b1, void* out, int B, int T, int C,
                           int dil, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (C % 16 != 0 || dil < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (resunit_smem(4, C, dil) <= (size_t)kMaxSmem)
    return (int)launch_resunit<4>(x, a1, w7, b7, a2, w1, b1, out, B, T, C, dil, s);
  if (resunit_smem(2, C, dil) <= (size_t)kMaxSmem)
    return (int)launch_resunit<2>(x, a1, w7, b7, a2, w1, b1, out, B, T, C, dil, s);
  if (resunit_smem(1, C, dil) <= (size_t)kMaxSmem)
    return (int)launch_resunit<1>(x, a1, w7, b7, a2, w1, b1, out, B, T, C, dil, s);
  return (int)cudaErrorInvalidValue;
}
