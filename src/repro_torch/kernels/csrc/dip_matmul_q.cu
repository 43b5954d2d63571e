// Quantized DiP matmul for Hopper (sm_90a): the kernels of
// kernels/dip_matmul_q.py that are not mainloops of dip_matmul.cu.
//
// Replaces, with dip_matmul.cu, repro/kernels/dip_matmul_q.py::
// dip_matmul_q_pallas.  Two kernels:
//
//   quantize_int8_kernel, the int8 (W8A8-dynamic) route's quantizing pass:
//     one block a row of x, y = cast((x * inv_rms[m]) * gain[k]) to x's
//     dtype where the rmsnorm prologue is on (else y = x), then amax =
//     max|y| in f32, scale = max(amax, 1e-8) / 127 and q = clamp(rint(y /
//     scale), -127, 127): IEEE division and round half to even, as the
//     reference's quantize_acts_int8, so the codes are byte-identical to it.
//     It writes the codes (M, K) and x_scale (M,); the int8 mainloops of
//     dip_matmul.cu (dip_matmul_int8q_launch) multiply them.  It is bound by
//     the bytes of x read twice (the second read, which forms the codes once
//     amax is known, mostly from L2) and the codes written.  The pass is not
//     fused into the product's load stage: a row's amax spans all of K,
//     which a K-split block sees only part of.
//   dip_matmul_q_kernel, fp8 (e4m3, weight-only) with f32 x, the first
//     design (bf16 x, the served fp8 route, runs dip_matmul.cu's
//     mainloops): one block per 64x64 output tile loops over K in 64-deep
//     tiles and de-shears each weight tile on its way into shared memory
//     (dip_common.cuh); each weight element is upcast to bf16 on load
//     (exact: e4m3's 3 mantissa bits and its exponent range fit bf16) and x
//     is cast to bf16 on load (the device's compute width, the reference's
//     fp8_compute_dtype on a GPU); bf16 x bf16 accumulates in f32 on the
//     tensor cores, and the flush computes z = acc * w_scale[n].  swiglu
//     streams the up weight with its own scales over the same x tile.  Its
//     bound at decode is the weight bytes, at prefill the tensor-core
//     operations; this first design does nothing about either (no
//     pipelining, one 64x64 tile per block).

#include <algorithm>

#include <cuda_fp8.h>

#include "dip_common.cuh"

namespace {

using namespace dip;
using bf16 = __nv_bfloat16;

struct QArgs {
  const float* x;           // (M, K) f32
  const uint8_t* q;         // (K, N) permutated e4m3 codes
  const uint8_t* q_up;      // (K, N) second weight for swiglu, else null
  const float* w_scale;     // (N,) per-output-channel scales
  const float* w_scale_up;  // (N,) the up weight's scales, swiglu only
  const float* bias;        // (N,) f32, bias epilogues only
  const float* residual;    // (M, N), residual epilogue only
  float* out;               // (M, N)
  int M, N, K;
  int epilogue;
};

// f32 x tile as bf16: 8 elements per step, converted and stored as 16 bytes.
__device__ __forceinline__ void load_x_tile_as_bf16(bf16* xs, const float* x, int M, int K, int m0, int k0) {
  constexpr int STRIDE = Tile<bf16>::STRIDE;
  for (int v = threadIdx.x; v < TILE * 8; v += THREADS) {
    const int r = v / 8, c = (v % 8) * 8, gm = m0 + r;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (gm < M) {
      const float* src = x + (size_t)gm * K + k0 + c;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      bf16* e = reinterpret_cast<bf16*>(&packed);
      e[0] = __float2bfloat16_rn(lo.x); e[1] = __float2bfloat16_rn(lo.y);
      e[2] = __float2bfloat16_rn(lo.z); e[3] = __float2bfloat16_rn(lo.w);
      e[4] = __float2bfloat16_rn(hi.x); e[5] = __float2bfloat16_rn(hi.y);
      e[6] = __float2bfloat16_rn(hi.z); e[7] = __float2bfloat16_rn(hi.w);
    }
    *reinterpret_cast<uint4*>(xs + r * STRIDE + c) = packed;
  }
}

// e4m3 weight tile: 16 codes per 16-byte load, upcast to bf16 and stored
// de-sheared.
__device__ __forceinline__ void load_w_tile_fp8(bf16* ws, const uint8_t* q, int N, int k0, int n0) {
  constexpr int STRIDE = Tile<bf16>::STRIDE;
  for (int v = threadIdx.x; v < TILE * 4; v += THREADS) {
    const int s = v / 4, c = (v % 4) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)(k0 + s) * N + n0 + c);
    const uint8_t* e = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      __nv_fp8_e4m3 f;
      f.__x = e[i];
      ws[((s + c + i) & (TILE - 1)) * STRIDE + c + i] = __float2bfloat16_rn(static_cast<float>(f));
    }
  }
}

template <bool DUAL>
__global__ void __launch_bounds__(THREADS) dip_matmul_q_kernel(const QArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int warp = threadIdx.x / 32, wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  FragF32 acc[2][2], accu[2][2];
  zero_frags<FragF32, float>(acc, accu);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + Tile<bf16>::ELEMS;
  bf16* wu = ws + Tile<bf16>::ELEMS;
  // each 64-deep step's products start from zero and are added to the
  // total in IEEE f32: the tensor cores round their f32 sums toward zero,
  // which over a whole K of 14336 drifts past the f32 tolerance
  FragF32 step[2][2], stepu[2][2];
  for (int k0 = 0; k0 < a.K; k0 += TILE) {
    __syncthreads();  // the previous step's tiles are consumed
    load_x_tile_as_bf16(xs, a.x, a.M, a.K, m0, k0);
    load_w_tile_fp8(ws, a.q, a.N, k0, n0);
    if (DUAL) load_w_tile_fp8(wu, a.q_up, a.N, k0, n0);
    __syncthreads();
    zero_frags<FragF32, float>(step, stepu);
    mma_tile_bf16<DUAL>(xs, ws, wu, step, stepu, wr, wc);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < step[i][j].num_elements; ++e) {
          acc[i][j].x[e] += step[i][j].x[e];
          if (DUAL) accu[i][j].x[e] += stepu[i][j].x[e];
        }
  }
  __syncthreads();  // the staging buffers below alias the operand tiles
  float* cs = reinterpret_cast<float*>(smem);
  const float* cu = cs + TILE * CSTRIDE;
  stage_acc<FragF32, float, DUAL>(cs, acc, accu, wr, wc);
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE, gm = m0 + r, gn = n0 + c;
    if (gm >= a.M) continue;
    const float z = cs[r * CSTRIDE + c] * a.w_scale[gn];
    const float zu = DUAL ? cu[r * CSTRIDE + c] * a.w_scale_up[gn] : 0.0f;
    a.out[(size_t)gm * a.N + gn] = apply_epilogue(a.epilogue, z, zu, a.bias, a.residual, a.N, gm, gn);
  }
}

template <bool DUAL>
cudaError_t launch(const QArgs& a, cudaStream_t stream) {
  const size_t bytes = std::max<size_t>((DUAL ? 3 : 2) * Tile<bf16>::ELEMS * sizeof(bf16),
                                        (DUAL ? 2 : 1) * TILE * CSTRIDE * 4);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(dip_matmul_q_kernel<DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.N / TILE, (a.M + TILE - 1) / TILE);
  dip_matmul_q_kernel<DUAL><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------- int8 quantizing pass ---
constexpr int Q_THREADS = 256;

// Eight elements of row x at k (16-byte aligned) as f32, after the prologue
// (cast back to T, as pro.kernel_load does) where inv != 0.
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
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(y[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < Q_THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
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

}  // namespace

// fp8 e4m3 weights with f32 x (bf16 x runs dip_matmul_fp8_launch): out =
// epilogue((x @ deshear(upcast(q))) * w_scale[n]), all f32.  Returns a
// cudaError_t (0 on success).
extern "C" int dip_matmul_q_launch(const void* x, const void* q, const void* q_up, const float* w_scale,
                                   const float* w_scale_up, const float* bias, const void* residual, void* out,
                                   int M, int N, int K, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE || epilogue > EPI_RESIDUAL ||
      w_scale == nullptr || (epilogue == EPI_SWIGLU && w_scale_up == nullptr))
    return (int)cudaErrorInvalidValue;
  const QArgs a{static_cast<const float*>(x), static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(q_up),
                w_scale, w_scale_up, bias, static_cast<const float*>(residual), static_cast<float*>(out),
                M, N, K, epilogue};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(epilogue == EPI_SWIGLU ? launch<true>(a, s) : launch<false>(a, s));
}

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
