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
// What bounds it on the H100: the transposed conv is a k=3 product
// (C_in -> s*C_out) of 2*T*3*C_in*s*C_out FLOP (59 GFLOP for s=4, 384->192
// at T=20002) over T*(C_in + s*C_out)*2 bytes of activations, so it is
// compute-bound and runs on the tensor cores.
//
// Design: out[q*s + r, c] = fr[q, r*C_out + c] with fr[q] = sum_m
// snake(x)[q + m - 1] @ w3[m], so the (T, s*C_out) product written row-major
// IS the interleaved (T*s, C_out) output: the phase interleave costs
// nothing. One block per (batch row, 16*RB-frame tile) holds the snake'd
// window (tile + 1 frame each side) in shared memory and streams w3 from L2.
#include "common.cuh"

namespace edm {

template <int RB>
__global__ void __launch_bounds__(kThreads) tconv_phase_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a0,
    const bf16* __restrict__ w3, const float* __restrict__ bias3,
    bf16* __restrict__ out, int T, int Cin, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BT = RB * 16;
  constexpr int W = BT + 2;
  bf16* win = reinterpret_cast<bf16*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + align128((size_t)W * Cin * 2));

  const int t0 = blockIdx.x * BT;
  const bf16* xb = x + (size_t)blockIdx.y * T * Cin;
  bf16* ob = out + (size_t)blockIdx.y * T * N;

  // window row r holds frame t0 - 1 + r; frames outside [0, T) read zero
  for (int e = threadIdx.x; e < W * Cin; e += kThreads) {
    const int r = e / Cin, c = e - r * Cin;
    const int t = t0 - 1 + r;
    float v = 0.0f;
    if (t >= 0 && t < T) v = snake(__bfloat162float(xb[(size_t)t * Cin + c]), a0[c]);
    win[e] = __float2bfloat16(v);
  }
  __syncthreads();

  tile_conv<RB>(win, Cin, w3, 3, 1, Cin, N, scratch, [&](int r, int c, float v) {
    const int t = t0 + r;
    if (t < T) ob[(size_t)t * N + c] = __float2bfloat16(v + bias3[c]);
  });
}

static size_t tconv_smem(int rb, int Cin) {
  return align128((size_t)(rb * 16 + 2) * Cin * 2) + kWarps * 256 * 4;
}

template <int RB>
static cudaError_t launch_tconv(const void* x, const void* a0, const void* w3,
                                const void* bias3, void* out, int B, int T,
                                int Cin, int N, cudaStream_t stream) {
  const size_t smem = tconv_smem(RB, Cin);
  cudaError_t err = cudaFuncSetAttribute(
      tconv_phase_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + RB * 16 - 1) / (RB * 16), B);
  tconv_phase_kernel<RB><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, (const float*)a0, (const bf16*)w3, (const float*)bias3,
      (bf16*)out, T, Cin, N);
  return cudaGetLastError();
}

}  // namespace edm

// x: (B, T, Cin) bf16; a0: (Cin,) f32; w3: (3, Cin, N) bf16 phase weights
// with N = s*Cout; bias3: (N,) f32 (the bias tiled s times);
// out: (B, T, N) bf16 == (B, T*s, Cout). Cin % 16 == N % 16 == 0.
extern "C" int edm_tconv_phase(const void* x, const void* a0, const void* w3,
                               const void* bias3, void* out, int B, int T,
                               int Cin, int N, void* stream) {
  using namespace edm;
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (Cin % 16 != 0 || N % 16 != 0 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tconv_smem(4, Cin) <= (size_t)kMaxSmem)
    return (int)launch_tconv<4>(x, a0, w3, bias3, out, B, T, Cin, N, s);
  if (tconv_smem(1, Cin) <= (size_t)kMaxSmem)
    return (int)launch_tconv<1>(x, a0, w3, bias3, out, B, T, Cin, N, s);
  return (int)cudaErrorInvalidValue;
}
