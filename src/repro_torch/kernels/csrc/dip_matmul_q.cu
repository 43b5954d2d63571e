// Quantized DiP matmul for Hopper (sm_90a): reduced-precision permutated
// weights with per-output-channel scales.
//
// Replaces repro/kernels/dip_matmul_q.py::dip_matmul_q_pallas for the
// routes not on the served path; bf16 x with e4m3 weights, the fp8 serving
// route, runs on the tensor-core mainloops of dip_matmul.cu
// (dip_matmul_fp8_launch).  The block structure here is dip_matmul.cu's
// first design: one block per 64x64 output tile loops over K in 64-deep
// tiles and de-shears each weight tile on its way into shared memory
// (dip_common.cuh).  Two paths:
//
//   int8 (W8A8-dynamic): x arrives already quantized per row by the wrapper
//     (q8 and x_scale, after any rmsnorm prologue, as the reference does
//     outside its kernel).  The block multiplies int8 x int8 into an exact
//     int32 accumulator on the tensor cores (WMMA s8) and at the flush
//     computes z = float(acc) * x_scale[m] * w_scale[n] in that order, then
//     the f32 epilogue, then one cast.
//   fp8 (e4m3, weight-only) with f32 x: each weight element is upcast to
//     bf16 on load (exact: e4m3's 3 mantissa bits and its exponent range fit
//     bf16) and x is cast to bf16 on load (the device's compute width, the
//     reference's fp8_compute_dtype on a GPU); bf16 x bf16 accumulates in
//     f32 on the tensor cores, and the flush computes z = acc * w_scale[n].
//
// swiglu streams the up weight with its own scales over the same x tile (for
// int8, the same quantized x) into a second accumulator.
//
// Bound on the card: at decode (M = slots) by the weight bytes, one byte per
// weight; at prefill (M = 256) by tensor-core operations.  This first design
// does nothing about either yet: no TMA, no wgmma, no pipelining, one 64x64
// tile per block.
#include <algorithm>

#include <cuda_fp8.h>

#include "dip_common.cuh"

namespace {

using namespace dip;
using bf16 = __nv_bfloat16;

struct QArgs {
  const void* x;            // (M, K): int8 codes (int8 path) or T (fp8 path)
  const void* q;            // (K, N) permutated storage, int8 or e4m3
  const void* q_up;         // (K, N) second weight for swiglu, else null
  const float* w_scale;     // (N,) per-output-channel scales
  const float* w_scale_up;  // (N,) the up weight's scales, swiglu only
  const float* x_scale;     // (M,) per-row activation scales, int8 path only
  const float* bias;        // (N,) f32, bias epilogues only
  const void* residual;     // (M, N) T, residual epilogue only
  void* out;                // (M, N) T
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

// T: x (fp8 path), residual and output type; S8: the int8 path.
template <typename T, bool S8, bool DUAL>
__global__ void __launch_bounds__(THREADS) dip_matmul_q_kernel(const QArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int warp = threadIdx.x / 32, wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  using A = typename std::conditional<S8, int, float>::type;  // accumulator type
  using Frag = typename std::conditional<S8, FragS32, FragF32>::type;
  Frag acc[2][2], accu[2][2];
  zero_frags<Frag, A>(acc, accu);

  if constexpr (S8) {
    int8_t* xs = reinterpret_cast<int8_t*>(smem);
    int8_t* ws = xs + S8_TILE;
    int8_t* wu = ws + S8_TILE;
    const int8_t* x = static_cast<const int8_t*>(a.x);
    const int8_t* q = static_cast<const int8_t*>(a.q);
    const int8_t* qu = static_cast<const int8_t*>(a.q_up);
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();  // the previous step's tiles are consumed
      load_x_tile_s8(xs, x, nullptr, nullptr, a.M, a.K, m0, k0);
      load_w_tile_s8(ws, q, a.N, k0, n0, 1);
      if (DUAL) load_w_tile_s8(wu, qu, a.N, k0, n0, 1);
      __syncthreads();
      mma_tile_s8<DUAL>(xs, ws, wu, acc, accu, wr, wc);
    }
  } else {
    static_assert(std::is_same<T, float>::value, "bf16 x with e4m3 weights runs dip_matmul.cu");
    bf16* xs = reinterpret_cast<bf16*>(smem);
    bf16* ws = xs + Tile<bf16>::ELEMS;
    bf16* wu = ws + Tile<bf16>::ELEMS;
    const T* x = static_cast<const T*>(a.x);
    const uint8_t* q = static_cast<const uint8_t*>(a.q);
    const uint8_t* qu = static_cast<const uint8_t*>(a.q_up);
    // each 64-deep step's products start from zero and are added to the
    // total in IEEE f32: the tensor cores round their f32 sums toward zero,
    // which over a whole K of 14336 drifts past the f32 tolerance
    Frag step[2][2], stepu[2][2];
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();
      load_x_tile_as_bf16(xs, x, a.M, a.K, m0, k0);
      load_w_tile_fp8(ws, q, a.N, k0, n0);
      if (DUAL) load_w_tile_fp8(wu, qu, a.N, k0, n0);
      __syncthreads();
      zero_frags<Frag, A>(step, stepu);
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
  }
  __syncthreads();  // the staging buffers below alias the operand tiles
  A* cs = reinterpret_cast<A*>(smem);
  const A* cu = cs + TILE * CSTRIDE;
  stage_acc<Frag, A, DUAL>(cs, acc, accu, wr, wc);
  __syncthreads();
  const T* res = static_cast<const T*>(a.residual);
  T* out = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE, gm = m0 + r, gn = n0 + c;
    if (gm >= a.M) continue;
    float z = (float)cs[r * CSTRIDE + c], zu = 0.0f;
    if (DUAL) zu = (float)cu[r * CSTRIDE + c];
    if (S8) {
      const float xsc = a.x_scale[gm];
      z = z * xsc * a.w_scale[gn];
      if (DUAL) zu = zu * xsc * a.w_scale_up[gn];
    } else {
      z = z * a.w_scale[gn];
      if (DUAL) zu = zu * a.w_scale_up[gn];
    }
    out[(size_t)gm * a.N + gn] = from_f32<T>(apply_epilogue(a.epilogue, z, zu, a.bias, res, a.N, gm, gn));
  }
}

template <bool S8, bool DUAL>
size_t smem_bytes() {
  const size_t operands = (DUAL ? 3 : 2) * (S8 ? S8_TILE : Tile<bf16>::ELEMS * sizeof(bf16));
  const size_t staging = (DUAL ? 2 : 1) * TILE * CSTRIDE * 4;
  return std::max(operands, staging);
}

template <typename T, bool S8, bool DUAL>
cudaError_t launch(const QArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<S8, DUAL>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dip_matmul_q_kernel<T, S8, DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.N / TILE, (a.M + TILE - 1) / TILE);
  dip_matmul_q_kernel<T, S8, DUAL><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_path(int path, const QArgs& a, cudaStream_t s) {
  const bool dual = a.epilogue == EPI_SWIGLU;
  if (path == 0) return dual ? launch<T, true, true>(a, s) : launch<T, true, false>(a, s);
  if constexpr (std::is_same<T, float>::value)
    return dual ? launch<T, false, true>(a, s) : launch<T, false, false>(a, s);
  return cudaErrorInvalidValue;  // bf16 x with e4m3 weights: dip_matmul_fp8_launch
}

}  // namespace

// path: 0 = int8 (x holds the int8 codes), 1 = fp8 e4m3 (x holds f32).
// dtype: the output (and fp8-path x, and residual) type, 0 = float32,
// 1 = bfloat16 (int8 path only).  Returns a cudaError_t (0 on success).
extern "C" int dip_matmul_q_launch(int path, int dtype, const void* x, const void* q, const void* q_up,
                                   const float* w_scale, const float* w_scale_up, const float* x_scale,
                                   const float* bias, const void* residual, void* out, int M, int N,
                                   int K, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE ||
      epilogue > EPI_RESIDUAL || (path != 0 && path != 1) || (path == 0 && x_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const QArgs a{x, q, q_up, w_scale, w_scale_up, x_scale, bias, residual, out, M, N, K, epilogue};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_path<float>(path, a, s);
  if (dtype == 1) return (int)launch_path<bf16>(path, a, s);
  return (int)cudaErrorInvalidValue;
}
