// Quantized DiP matmul for Hopper (sm_90a): the passes of
// kernels/dip_matmul_q.py that run ahead of the mainloops of dip_matmul.cu.
//
// Replaces, with dip_matmul.cu, repro/kernels/dip_matmul_q.py::
// dip_matmul_q_pallas.  Two kernels, each bound by the bytes of x it reads
// and of what it writes:
//
//   quantize_int8_kernel, the int8 (W8A8-dynamic) route's quantizing pass:
//     one block a row of x, y = cast((x * inv_rms[m]) * gain[k]) to x's
//     dtype where the rmsnorm prologue is on (else y = x), then amax =
//     max|y| in f32, scale = max(amax, 1e-8) / 127 and q = clamp(rint(y /
//     scale), -127, 127): IEEE division and round half to even, as the
//     reference's quantize_acts_int8, so the codes are byte-identical to it.
//     Both maxima propagate a NaN, as jnp.max and torch.amax do (fmaxf drops
//     it): a row holding a NaN gets a NaN scale, so its output row is NaN
//     and a fault screen downstream sees it, instead of codes of -127.
//     It writes the codes (M, K) and x_scale (M,); the int8 mainloops of
//     dip_matmul.cu (dip_matmul_int8q_launch) multiply them.  It reads x
//     twice (the second read, which forms the codes once amax is known,
//     mostly from L2).  The pass is not fused into the product's load
//     stage: a row's amax spans all of K, which a K-split block sees only
//     part of.
//   cast_bf16_kernel, the fp8 (e4m3, weight-only) route's pass for f32 x:
//     bf16(x) rounded to nearest, or bf16((x * inv_rms[m]) * gain[k]) with
//     the rmsnorm prologue, in f32 (the reference's fp8_compute_dtype on a
//     GPU is bf16, so x is multiplied at that width); the e4m3 mainloops of
//     dip_matmul.cu (dip_matmul_fp8_launch with an f32 output) multiply it.
//     It is not fused into their load stage: the decode tile's ring keeps
//     five 8 KB stages so that two blocks fit an SM, and an f32 x tile
//     riding it would double the x bytes of every stage, where the pass
//     moves about 6 bytes an element of an (M, K) that is 1/14 to 1/3500 of
//     the weight bytes at the served shapes.

#include <algorithm>

#include "dip_common.cuh"

namespace {

using namespace dip;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------- int8 quantizing pass ---
constexpr int Q_THREADS = 256;

// Eight elements of row x at k (16-byte aligned) as f32, after the prologue
// (cast back to T, as pro.kernel_load does) where gain is not null.
__device__ __forceinline__ void load8(const float* x, int k, float inv, const float* gain, float (&y)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(x + k), hi = *reinterpret_cast<const float4*>(x + k + 4);
  y[0] = lo.x, y[1] = lo.y, y[2] = lo.z, y[3] = lo.w, y[4] = hi.x, y[5] = hi.y, y[6] = hi.z, y[7] = hi.w;
  if (gain != nullptr)
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = (y[i] * inv) * gain[k + i];
}
__device__ __forceinline__ void load8(const bf16* x, int k, float inv, const float* gain, float (&y)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(x + k);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = __bfloat162float(e[i]);
    if (gain != nullptr) y[i] = __bfloat162float(__float2bfloat16_rn((y[i] * inv) * gain[k + i]));
  }
}

// max(a, b) that returns a NaN operand (fmaxf returns the other one).
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// One block a row: amax over the row, then the codes from a second read of
// the same row (the same arithmetic, so the same y).
template <typename T>
__global__ void __launch_bounds__(Q_THREADS) quantize_int8_kernel(const T* __restrict__ x, const float* inv_rms,
                                                                  const float* gain, int8_t* __restrict__ codes,
                                                                  float* __restrict__ x_scale, int K) {
  __shared__ float warp_max[Q_THREADS / 32];
  const int m = blockIdx.x;
  const T* row = x + (size_t)m * K;
  const float inv = gain != nullptr ? inv_rms[m] : 0.0f;
  float amax = 0.0f;
  for (int k = 8 * threadIdx.x; k < K; k += 8 * Q_THREADS) {
    float y[8];
    load8(row, k, inv, gain, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = max_nan(amax, fabsf(y[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < Q_THREADS / 32; ++w) amax = max_nan(amax, warp_max[w]);
  const float scale = __fdiv_rn(max_nan(amax, 1e-8f), 127.0f);
  if (threadIdx.x == 0) x_scale[m] = scale;
  int8_t* out = codes + (size_t)m * K;
  for (int k = 8 * threadIdx.x; k < K; k += 8 * Q_THREADS) {
    float y[8];
    load8(row, k, inv, gain, y);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qv = fminf(fmaxf(rintf(__fdiv_rn(y[i], scale)), -127.0f), 127.0f);
      w[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)qv << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(out + k) = make_uint2(w[0], w[1]);
  }
}

// ------------------------------------------------ fp8 route: f32 x -> bf16 ---
constexpr int C_THREADS = 256;

// Eight elements a thread, grid-stride over the (M, K) array (K a multiple of
// 8): the same load8 as the quantizing pass, then one rounding to bf16.
__global__ void __launch_bounds__(C_THREADS) cast_bf16_kernel(const float* __restrict__ x, const float* inv_rms,
                                                              const float* gain, bf16* __restrict__ out, int M,
                                                              int K) {
  const size_t chunks = (size_t)M * (K / 8);
  for (size_t c = (size_t)blockIdx.x * C_THREADS + threadIdx.x; c < chunks; c += (size_t)gridDim.x * C_THREADS) {
    const int m = (int)(c / (K / 8)), k = (int)(c % (K / 8)) * 8;
    float y[8];
    load8(x + (size_t)m * K, k, gain != nullptr ? inv_rms[m] : 0.0f, gain, y);
    uint4 packed;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + (size_t)m * K + k) = packed;
  }
}

}  // namespace

// The int8 route's quantizing pass: dtype 0 = float32, 1 = bfloat16 x (M,
// K), K a multiple of 8; inv_rms (M,) and gain (K,) for the rmsnorm
// prologue, both null without it; writes codes (M, K) int8 and x_scale (M,)
// f32.  Returns a cudaError_t.
extern "C" int dip_quantize_int8_launch(int dtype, const void* x, const float* inv_rms, const float* gain,
                                        void* codes, float* x_scale, int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 || (inv_rms == nullptr) != (gain == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c = static_cast<int8_t*>(codes);
  if (dtype == 0)
    quantize_int8_kernel<float><<<M, Q_THREADS, 0, s>>>(static_cast<const float*>(x), inv_rms, gain, c, x_scale, K);
  else if (dtype == 1)
    quantize_int8_kernel<bf16><<<M, Q_THREADS, 0, s>>>(static_cast<const bf16*>(x), inv_rms, gain, c, x_scale, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The fp8 route's pass for f32 x (M, K), K a multiple of 8: writes out (M,
// K) bf16 = bf16((x * inv_rms[m]) * gain[k]) with the rmsnorm prologue
// (inv_rms (M,) and gain (K,), both null without it: bf16(x)), rounded to
// nearest.  Returns a cudaError_t.
extern "C" int dip_cast_bf16_launch(const float* x, const float* inv_rms, const float* gain, void* out, int M, int K,
                                    void* stream) {
  if (M <= 0 || K <= 0 || K % 8 || (inv_rms == nullptr) != (gain == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t chunks = (size_t)M * (K / 8);
  const unsigned blocks = (unsigned)std::min<size_t>((chunks + C_THREADS - 1) / C_THREADS, 65535);
  cast_bf16_kernel<<<blocks, C_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, inv_rms, gain,
                                                                                 static_cast<bf16*>(out), M, K);
  return (int)cudaGetLastError();
}
