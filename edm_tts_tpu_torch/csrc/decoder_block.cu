// K2, first stage: snake + the phase-decomposed transposed conv of a codec
// DecoderBlock (k = 2s, stride s, padding s/2, even s).
//
// Replaces the front of edm_tts_tpu/ops/pallas_decoder_block.py::
// fused_decoder_block (_kernel steps 1-3, _phase_weights). The Python
// wrapper (ops/decoder_block.py) follows this launch with the block's three
// residual units as K1 launches (resunit.cu): each K1 launch zero-pads
// outside [0, T*s) exactly as the Pallas kernel re-zeroes those rows between
// stages, so the split computes the same block. Fusing all four stages into
// one pass per tile is later work.
//
// What bounds it on the H100: out[q*s + r, c] = fr[q, r*C_out + c] with
// fr[q] = sum_m snake(x)[q + m - 1] @ w3[m] + bias3, a (T, s*C_out) product
// of 3 taps over C_in. One of each phase's three taps is zero
// (phase_weights: the phases r < s/2 use taps 0 and 1, the others taps 1
// and 2), so the real work is 2 taps: 2*T*2*C_in*s*C_out FLOP, 23.6 GFLOP
// for s=4, 384->192 at T=20002 (24 us at the tensor cores' 989 TFLOP/s),
// over T*(C_in + s*C_out)*2 bytes of activations (47 MB, 14 us). At s=2,
// 192->96, T=80008 the bytes (61 MB, 18 us) bound it, not the products
// (11.8 GFLOP, 12 us).
//
// Design: two launches on one stream.
//   1. snake_kernel (conv_gemm.cuh): s1 = bf16(snake(x, alpha0)) into a
//      scratch.
//   2. tconv_gemm_kernel: the phase product as an implicit GEMM on wgmma
//      (conv_gemm.cuh): M = the T frames of a batch row, N = s*C_out, K =
//      taps x C_in. The A tile of tap m comes from row t0 + m - 1 of s1
//      through a 3-D tensor map (C_in, T, B), whose zero fill outside
//      [0, T) is the conv's edge; w3 (3, C_in, N) comes MN-major through a
//      map (N, C_in, 3). A block of BN columns wholly below half = (s/2)*C_out
//      runs taps 0 and 1 only, one wholly above taps 1 and 2, one across
//      both all three. The epilogue adds bias3 and stores bf16 16 bytes a
//      thread along the rows. The (T, s*C_out) product written row-major
//      IS the interleaved (T*s, C_out) output: the phase interleave costs
//      nothing.
#include "conv_gemm.cuh"

namespace edm {

template <int BN>
__global__ void __launch_bounds__(256, ConvCfg<BN>::kMinBlocks) tconv_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ bias, const float* __restrict__ alpha,
    const bf16* __restrict__ res, bf16* __restrict__ out, int T, int Cin, int N, int dil,
    int half) {
  extern __shared__ unsigned char smem_raw[];
  conv_gemm<BN, 3, kPhase>(smem_aligned(smem_raw), &amap, &wmap, bias, alpha, res, out, T, Cin,
                           N, dil, half);
}

template <int BN>
static cudaError_t launch_tconv(const void* x, const void* a0, const void* w3,
                                const void* bias3, void* s1, void* out, int B, int T, int Cin,
                                int N, int half, cudaStream_t stream) {
  CUtensorMap s1m, w3m;
  cudaError_t err = map_3d(&s1m, s1, Cin, T, B, kConvBM);
  if (err == cudaSuccess) err = map_3d(&w3m, w3, N, Cin, 3, 64);
  if (err == cudaSuccess) err = launch_snake(x, a0, s1, (size_t)B * T, Cin, stream);
  if (err == cudaSuccess)
    err = launch_conv_gemm<BN>(tconv_gemm_kernel<BN>, s1m, w3m, bias3, nullptr, nullptr, out, B,
                               T, Cin, N, 1, half, stream);
  return err;
}

}  // namespace edm

// x, s1: (B, T, Cin) bf16 (s1 is scratch); a0: (Cin,) f32; w3: (3, Cin, N)
// bf16 phase weights with N = stride*Cout; bias3: (N,) f32 (the bias tiled
// stride times); out: (B, T, N) bf16 == (B, T*stride, Cout). x, s1, w3 and
// out 16-byte aligned; Cin % 16 == 0, Cout % 16 == 0, even stride; bn
// (output columns per block) 64, 96, 128, 192 or 256. Returns a cudaError_t.
extern "C" int edm_tconv_phase(const void* x, const void* a0, const void* w3,
                               const void* bias3, void* s1, void* out, int B, int T, int Cin,
                               int N, int stride, int bn, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (Cin < 16 || Cin % 16 != 0 || stride < 2 || stride % 2 != 0 || N % stride != 0 ||
      (N / stride) % 16 != 0 || T < 1 || B < 1 || B > 65535 ||
      (T + kConvBM - 1) / kConvBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int half = stride / 2 * (N / stride);
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return (int)launch_tconv<64>(x, a0, w3, bias3, s1, out, B, T, Cin, N, half, s);
    case 96: return (int)launch_tconv<96>(x, a0, w3, bias3, s1, out, B, T, Cin, N, half, s);
    case 128: return (int)launch_tconv<128>(x, a0, w3, bias3, s1, out, B, T, Cin, N, half, s);
    case 192: return (int)launch_tconv<192>(x, a0, w3, bias3, s1, out, B, T, Cin, N, half, s);
    case 256: return (int)launch_tconv<256>(x, a0, w3, bias3, s1, out, B, T, Cin, N, half, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
