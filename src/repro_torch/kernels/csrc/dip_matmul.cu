// DiP matmul for Hopper (sm_90a): epilogue(prologue(x) @ deshear(P)).
//
// Replaces repro/kernels/dip_matmul.py::dip_matmul_pallas (and, with
// deshear = 0, ws_matmul_pallas).  P is the DiP-permutated weight storage:
// inside every 64x64 tile, W[r][c] = P[(r - c) mod 64][c] (paper Fig. 3,
// repro/kernels/common.py).  The TPU kernel walks K on a sequential grid
// axis and carries the sum in VMEM scratch; here one block owns one 64x64
// output tile and loops over K itself, since blocks run in no order.
//
// Per K step the block
//   * loads the 64x64 x tile with the rmsnorm prologue applied on load,
//     x * inv_rms[m] * gain[k] in f32, cast back to the x dtype before the
//     product (repro/kernels/prologue.py::kernel_load);
//   * reads the 64x64 tile of P row by row (coalesced 16-byte loads) and
//     writes it to shared memory already de-sheared: P[s][c] lands at
//     W[(s + c) & 63][c], so the de-shear costs nothing beyond the copy;
//   * accumulates in f32: bf16 through the tensor cores (WMMA, i.e.
//     mma.sync), f32 with IEEE FMAs on the CUDA cores (no TF32).
// After the K loop it applies the epilogue to the f32 accumulator and
// writes the output once.  swiglu streams the gate and up tiles over the
// same x tile into two accumulators.
//
// Bound on the card: at decode (M = slots) by the weight bytes; at prefill
// (M = 256) by tensor-core FLOPs.  This first design does nothing about
// either yet: no TMA, no wgmma, no pipelining, and one 64x64 tile per block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int TILE = 64;      // output tile edge, K step and DiP permutation tile
constexpr int THREADS = 128;  // four warps

// must match repro_torch/kernels/epilogue.py::EPILOGUES
enum Epilogue { EPI_NONE = 0, EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_SILU, EPI_SWIGLU, EPI_RESIDUAL };

struct Args {
  const void* x;         // (M, K) row-major, T
  const void* p;         // (K, N) row-major, T (permutated unless deshear == 0)
  const void* p_up;      // (K, N) second weight for swiglu, else null
  const float* inv_rms;  // (M,) f32 inverse RMS, null without prologue
  const float* gain;     // (K,) f32 norm gain, null without prologue
  const float* bias;     // (N,) f32, bias epilogues only
  const void* residual;  // (M, N) T, residual epilogue only
  void* out;             // (M, N) T
  int M, N, K;
  int epilogue;
  int deshear;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> struct Tile {
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte access
  static constexpr int STRIDE = TILE + VEC;         // padded shared row (bank spread)
  static constexpr int ELEMS = TILE * STRIDE;
};
constexpr int CSTRIDE = TILE + 4;                   // f32 accumulator staging row

template <typename T>
__device__ __forceinline__ void load_x_tile(T* xs, const T* x, const float* inv,
                                            const float* gain, int M, int K, int m0, int k0) {
  constexpr int VEC = Tile<T>::VEC, PER_ROW = TILE / VEC;
  for (int v = threadIdx.x; v < TILE * PER_ROW; v += THREADS) {
    const int r = v / PER_ROW, c = (v % PER_ROW) * VEC, gm = m0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (gm < M) {
      raw = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + c);
      if (inv != nullptr) {
        T* e = reinterpret_cast<T*>(&raw);
        const float iv = inv[gm];
#pragma unroll
        for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>((to_f32(e[i]) * iv) * gain[k0 + c + i]);
      }
    }
    *reinterpret_cast<uint4*>(xs + r * Tile<T>::STRIDE + c) = raw;
  }
}

template <typename T>
__device__ __forceinline__ void load_w_tile(T* ws, const T* p, int N, int k0, int n0, int deshear) {
  constexpr int VEC = Tile<T>::VEC, PER_ROW = TILE / VEC, STRIDE = Tile<T>::STRIDE;
  for (int v = threadIdx.x; v < TILE * PER_ROW; v += THREADS) {
    const int s = v / PER_ROW, c = (v % PER_ROW) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(p + (size_t)(k0 + s) * N + n0 + c);
    if (deshear) {
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ws[((s + c + i) & (TILE - 1)) * STRIDE + c + i] = e[i];
    } else {
      *reinterpret_cast<uint4*>(ws + s * STRIDE + c) = raw;
    }
  }
}

template <typename T>
__device__ __forceinline__ float apply_epilogue(const Args& a, float z, float zu, int gm, int gn) {
  switch (a.epilogue) {
    case EPI_BIAS:
      return z + a.bias[gn];
    case EPI_BIAS_GELU: {
      const float t = z + a.bias[gn];
      return t * (0.5f * (1.0f + tanhf(0.7978845608028654f * (t + 0.044715f * t * t * t))));
    }
    case EPI_BIAS_SILU: {
      const float t = z + a.bias[gn];
      return t * (1.0f / (1.0f + expf(-t)));
    }
    case EPI_SWIGLU:
      return z * (1.0f / (1.0f + expf(-z))) * zu;
    case EPI_RESIDUAL:
      return z + to_f32(static_cast<const T*>(a.residual)[(size_t)gm * a.N + gn]);
    default:
      return z;
  }
}

// bf16: each warp owns a 32x32 quarter of the output tile as 2x2 WMMA fragments.
template <bool DUAL>
__device__ __forceinline__ void mma_tile(
    const __nv_bfloat16* xs, const __nv_bfloat16* ws, const __nv_bfloat16* wu,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[2][2],
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&accu)[2][2],
    int wr, int wc) {
  using namespace nvcuda;
  constexpr int STRIDE = Tile<__nv_bfloat16>::STRIDE;
#pragma unroll
  for (int kk = 0; kk < TILE; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], xs + (wr + 16 * i) * STRIDE + kk, STRIDE);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, ws + kk * STRIDE + wc + 16 * j, STRIDE);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      if (DUAL) {
        wmma::load_matrix_sync(fb, wu + kk * STRIDE + wc + 16 * j, STRIDE);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(accu[i][j], fa[i], fb, accu[i][j]);
      }
    }
  }
}

// f32: thread (ty, tx) of an 8x16 grid owns rows ty + 8i and columns tx + 16j.
template <bool DUAL>
__device__ __forceinline__ void fma_tile(const float* xs, const float* ws, const float* wu,
                                         float (&acc)[8][4], float (&accu)[8][4], int ty, int tx) {
  constexpr int STRIDE = Tile<float>::STRIDE;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float fa[8], fb[4], fu[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) fa[i] = xs[(ty + 8 * i) * STRIDE + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fb[j] = ws[k * STRIDE + tx + 16 * j];
      if (DUAL) fu[j] = wu[k * STRIDE + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
        if (DUAL) accu[i][j] = fmaf(fa[i], fu[j], accu[i][j]);
      }
  }
}

template <typename T, bool DUAL>
__global__ void __launch_bounds__(THREADS) dip_matmul_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + Tile<T>::ELEMS;
  T* wu = ws + Tile<T>::ELEMS;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const T* x = static_cast<const T*>(a.x);
  const T* p = static_cast<const T*>(a.p);
  const T* pu = static_cast<const T*>(a.p_up);
  T* out = static_cast<T*>(a.out);

  if constexpr (std::is_same<T, float>::value) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[8][4] = {}, accu[8][4] = {};
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();  // the previous step's tiles are consumed
      load_x_tile<T>(xs, x, a.inv_rms, a.gain, a.M, a.K, m0, k0);
      load_w_tile<T>(ws, p, a.N, k0, n0, a.deshear);
      if (DUAL) load_w_tile<T>(wu, pu, a.N, k0, n0, a.deshear);
      __syncthreads();
      fma_tile<DUAL>(xs, ws, wu, acc, accu, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + ty + 8 * i;
      if (gm >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        out[(size_t)gm * a.N + gn] = from_f32<T>(apply_epilogue<T>(a, acc[i][j], accu[i][j], gm, gn));
      }
    }
  } else {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wr = (warp / 2) * 32, wc = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], accu[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fill_fragment(acc[i][j], 0.0f);
        wmma::fill_fragment(accu[i][j], 0.0f);
      }
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();
      load_x_tile<T>(xs, x, a.inv_rms, a.gain, a.M, a.K, m0, k0);
      load_w_tile<T>(ws, p, a.N, k0, n0, a.deshear);
      if (DUAL) load_w_tile<T>(wu, pu, a.N, k0, n0, a.deshear);
      __syncthreads();
      mma_tile<DUAL>(xs, ws, wu, acc, accu, wr, wc);
    }
    __syncthreads();  // the staging buffers below alias the operand tiles
    float* cs = reinterpret_cast<float*>(smem);
    float* cu = cs + TILE * CSTRIDE;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* dst = cs + (wr + 16 * i) * CSTRIDE + wc + 16 * j;
        wmma::store_matrix_sync(dst, acc[i][j], CSTRIDE, wmma::mem_row_major);
        if (DUAL) wmma::store_matrix_sync(dst + TILE * CSTRIDE, accu[i][j], CSTRIDE, wmma::mem_row_major);
      }
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE, gm = m0 + r, gn = n0 + c;
      if (gm >= a.M) continue;
      const float zu = DUAL ? cu[r * CSTRIDE + c] : 0.0f;
      out[(size_t)gm * a.N + gn] = from_f32<T>(apply_epilogue<T>(a, cs[r * CSTRIDE + c], zu, gm, gn));
    }
  }
}

template <typename T, bool DUAL>
size_t smem_bytes() {
  const size_t operands = (DUAL ? 3 : 2) * Tile<T>::ELEMS * sizeof(T);
  const size_t staging = std::is_same<T, float>::value ? 0 : (DUAL ? 2 : 1) * TILE * CSTRIDE * sizeof(float);
  return operands > staging ? operands : staging;
}

template <typename T, bool DUAL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, DUAL>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dip_matmul_kernel<T, DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.N / TILE, (a.M + TILE - 1) / TILE);
  dip_matmul_kernel<T, DUAL><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int dip_matmul_launch(int dtype, const void* x, const void* p, const void* p_up,
                                 const float* inv_rms, const float* gain, const float* bias,
                                 const void* residual, void* out, int M, int N, int K,
                                 int epilogue, int deshear, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE ||
      epilogue > EPI_RESIDUAL)
    return (int)cudaErrorInvalidValue;
  const Args a{x, p, p_up, inv_rms, gain, bias, residual, out, M, N, K, epilogue, deshear};
  const bool dual = epilogue == EPI_SWIGLU;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dual ? launch<float, true>(a, s) : launch<float, false>(a, s);
  else if (dtype == 1)
    err = dual ? launch<__nv_bfloat16, true>(a, s) : launch<__nv_bfloat16, false>(a, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
