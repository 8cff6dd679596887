// K1: the codec ResidualUnit as two products on warpgroup MMA.
//
// Replaces edm_tts_tpu/ops/pallas_resunit.py::fused_residual_unit
// (_fused_forward / _kernel): snake(a1) -> dilated k=7 conv -> snake(a2) ->
// k=1 conv -> + x, with weight norm folded into w7 and w1 by the caller.
//
// What bounds it on the H100: at C=768 the unit is 2*T*C*C*8 = 38 GFLOP per
// 4000 frames, so it wants the tensor cores at their Hopper rate (wgmma);
// its activations move 2*T*C*2 bytes, which at C=96 and T=160016 (61 MB,
// 18 us) come near the products' 24 us. The weights (7*C*C bf16, 8.3 MB at
// C=768) do not fit one block's shared memory, so they stream in tiles, and
// each staged tile must serve many time rows: a block that holds only a
// few rows (as the Pallas kernel's time tile does) reads the whole kernel
// from L2 for them.
//
// Design: the unit is three launches on one stream.
//   1. snake_kernel (conv_gemm.cuh): s1 = bf16(snake(x, a1)) into the output
//      buffer.
//   2. Product 1, the dilated conv as an implicit GEMM (conv_gemm.cuh):
//      M = the time rows of one batch row, N = C_out, K = 7 taps x C_in, the
//      A tiles from s1 at row offsets (tap - 3) * dil, the weight read
//      MN-major from w7 as the model holds it ([tap][in][out]). A block
//      computes 128 rows x BN output channels (BN 64, 128, 192 or 256, the
//      wrapper's choice, ops.resunit.resunit_tile). The epilogue adds b7,
//      applies snake(a2) and rounds to bf16 (the Pallas kernel casts its
//      intermediate there too), into a scratch s2.
//   3. Product 2, the k=1 conv: the same GEMM with one tap over s2 and w1;
//      its epilogue adds b1 and the residual x and writes the output (over
//      s1, which product 1 is done with).
#include "conv_gemm.cuh"

namespace edm {

template <int BN, int TAPS, int EPI>
__global__ void __launch_bounds__(256, ConvCfg<BN>::kMinBlocks) resunit_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ bias, const float* __restrict__ alpha,
    const bf16* __restrict__ res, bf16* __restrict__ out, int T, int Cin, int N, int dil,
    int half) {
  extern __shared__ unsigned char smem_raw[];
  conv_gemm<BN, TAPS, EPI>(smem_aligned(smem_raw), &amap, &wmap, bias, alpha, res, out, T, Cin,
                           N, dil, half);
}

template <int BN>
static cudaError_t launch_resunit(const void* x, const void* a1, const void* w7,
                                  const void* b7, const void* a2, const void* w1,
                                  const void* b1, void* out, void* s2, int B, int T, int C,
                                  int dil, cudaStream_t stream) {
  CUtensorMap s1m, s2m, w7m, w1m;
  cudaError_t err = map_3d(&s1m, out, C, T, B, kConvBM);
  if (err == cudaSuccess) err = map_3d(&s2m, s2, C, T, B, kConvBM);
  if (err == cudaSuccess) err = map_3d(&w7m, w7, C, C, 7, 64);
  if (err == cudaSuccess) err = map_3d(&w1m, w1, C, C, 1, 64);
  if (err == cudaSuccess) err = launch_snake(x, a1, out, (size_t)B * T, C, stream);
  if (err == cudaSuccess)
    err = launch_conv_gemm<BN>(resunit_gemm_kernel<BN, 7, kConv7>, s1m, w7m, b7, a2, nullptr,
                               s2, B, T, C, C, dil, 0, stream);
  if (err == cudaSuccess)
    err = launch_conv_gemm<BN>(resunit_gemm_kernel<BN, 1, kConv1>, s2m, w1m, b1, nullptr, x,
                               out, B, T, C, C, 0, 0, stream);
  return err;
}

}  // namespace edm

// x, out, s2: (B, T, C) bf16, 16-byte aligned (s2 is scratch); w7: (7, C, C)
// bf16 [tap][in][out]; w1: (C, C) bf16 [in][out]; a1, b7, a2, b1: (C,) f32.
// C % 16 == 0; bn (output channels per block) 64, 128, 192 or 256.
// Returns a cudaError_t.
extern "C" int edm_resunit(const void* x, const void* a1, const void* w7, const void* b7,
                           const void* a2, const void* w1, const void* b1, void* out,
                           void* s2, int B, int T, int C, int dil, int bn, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (C < 16 || C % 16 != 0 || dil < 1 || T < 1 || B < 1 || B > 65535 ||
      (T + kConvBM - 1) / kConvBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return (int)launch_resunit<64>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    case 128: return (int)launch_resunit<128>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    case 192: return (int)launch_resunit<192>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    case 256: return (int)launch_resunit<256>(x, a1, w7, b7, a2, w1, b1, out, s2, B, T, C, dil, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
