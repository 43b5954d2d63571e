// Device code shared by the DiP matmul kernels (dip_matmul.cu,
// dip_matmul_q.cu, dip_systolic.cu): element conversions, the fused
// epilogues applied at the accumulator flush, and the 64x64 operand tiles
// in shared memory with their tensor-core products.
//
// The permutated weight storage P holds, inside every 64x64 tile,
// W[r][c] = P[(r - c) mod 64][c] (paper Fig. 3, repro/kernels/common.py).
// The tile loaders de-shear it on the way into shared memory: P[s][c] lands
// at W[(s + c) & 63][c], so the de-shear costs nothing beyond the copy.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace dip {

constexpr int TILE = 64;      // output tile edge, K step and DiP permutation tile
constexpr int THREADS = 128;  // four warps
constexpr int CSTRIDE = TILE + 4;  // 32-bit accumulator staging row (bank spread)

// must match repro_torch/kernels/epilogue.py::EPILOGUES
enum Epilogue { EPI_NONE = 0, EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_SILU, EPI_SWIGLU, EPI_RESIDUAL };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// float -> int8 truncates toward zero, as torch's and XLA's casts do
template <> __device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return (int8_t)__float2int_rz(v);
}

// The f32 epilogue on one accumulator element (repro_torch/kernels/epilogue.py).
// zu is the up projection's pre-activation for swiglu; R is the residual's type.
template <typename R>
__device__ __forceinline__ float apply_epilogue(int code, float z, float zu, const float* bias,
                                                const R* residual, int N, int gm, int gn) {
  switch (code) {
    case EPI_BIAS:
      return z + bias[gn];
    case EPI_BIAS_GELU: {
      const float t = z + bias[gn];
      return t * (0.5f * (1.0f + tanhf(0.7978845608028654f * (t + 0.044715f * t * t * t))));
    }
    case EPI_BIAS_SILU: {
      const float t = z + bias[gn];
      return t * (1.0f / (1.0f + expf(-t)));
    }
    case EPI_SWIGLU:
      return z * (1.0f / (1.0f + expf(-z))) * zu;
    case EPI_RESIDUAL:
      return z + to_f32(residual[(size_t)gm * N + gn]);
    default:
      return z;
  }
}

// ---------------------------------------------------------- f32 / bf16 ---
template <typename T> struct Tile {
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte access
  static constexpr int STRIDE = TILE + VEC;         // padded shared row (bank spread)
  static constexpr int ELEMS = TILE * STRIDE;
};

// The 64x64 x tile at (m0, k0), rows past M zero; with inv != null the
// rmsnorm prologue x * inv_rms[m] * gain[k] in f32, cast back to T before
// the product (repro/kernels/prologue.py::kernel_load).
template <typename T>
__device__ __forceinline__ void load_x_tile(T* xs, const T* x, const float* inv, const float* gain,
                                            int M, int K, int m0, int k0) {
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

// The 64x64 weight tile at (k0, n0), read row by row in 16-byte loads and
// stored de-sheared (deshear != 0) or as it is.
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

using FragF32 = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// bf16 x bf16 -> f32 on the tensor cores: each warp owns a 32x32 quarter of
// the output tile as 2x2 WMMA fragments at (wr, wc).
template <bool DUAL>
__device__ __forceinline__ void mma_tile_bf16(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                              const __nv_bfloat16* wu, FragF32 (&acc)[2][2],
                                              FragF32 (&accu)[2][2], int wr, int wc) {
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

// ---------------------------------------------------------------- int8 ---
// An int8 operand tile is stored as four 16-column chunks: chunk c holds
// rows 0..63 of columns 16c..16c+15, 16 bytes per row.  Every 16x16 WMMA
// fragment then starts 256-bit aligned with a leading dimension of 16, and
// a warp's fragment load reads 256 contiguous bytes.
constexpr int S8_CHUNK = TILE * 16;   // bytes per chunk
constexpr int S8_TILE = 4 * S8_CHUNK; // bytes per tile

__device__ __forceinline__ void load_x_tile_s8(int8_t* xs, const int8_t* x, const float* inv,
                                               const float* gain, int M, int K, int m0, int k0) {
  for (int v = threadIdx.x; v < TILE * 4; v += THREADS) {
    const int r = v / 4, ch = v % 4, gm = m0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (gm < M) {
      raw = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + k0 + 16 * ch);
      if (inv != nullptr) {
        int8_t* e = reinterpret_cast<int8_t*>(&raw);
        const float iv = inv[gm];
#pragma unroll
        for (int i = 0; i < 16; ++i) e[i] = from_f32<int8_t>((to_f32(e[i]) * iv) * gain[k0 + 16 * ch + i]);
      }
    }
    *reinterpret_cast<uint4*>(xs + ch * S8_CHUNK + r * 16) = raw;
  }
}

__device__ __forceinline__ void load_w_tile_s8(int8_t* ws, const int8_t* p, int N, int k0, int n0,
                                               int deshear) {
  for (int v = threadIdx.x; v < TILE * 4; v += THREADS) {
    const int s = v / 4, ch = v % 4, c = 16 * ch;
    const uint4 raw = *reinterpret_cast<const uint4*>(p + (size_t)(k0 + s) * N + n0 + c);
    int8_t* chunk = ws + ch * S8_CHUNK;
    if (deshear) {
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 16; ++i) chunk[((s + c + i) & (TILE - 1)) * 16 + i] = e[i];
    } else {
      *reinterpret_cast<uint4*>(chunk + s * 16) = raw;
    }
  }
}

using FragS32 = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int>;

// int8 x int8 -> exact int32 on the tensor cores (WMMA s8, sm_72+), the
// same warp layout as mma_tile_bf16.
template <bool DUAL>
__device__ __forceinline__ void mma_tile_s8(const int8_t* xs, const int8_t* ws, const int8_t* wu,
                                            FragS32 (&acc)[2][2], FragS32 (&accu)[2][2], int wr, int wc) {
  using namespace nvcuda;
  const signed char* xa = reinterpret_cast<const signed char*>(xs);
  const signed char* wb = reinterpret_cast<const signed char*>(ws);
  const signed char* ub = reinterpret_cast<const signed char*>(wu);
#pragma unroll
  for (int kk = 0; kk < TILE; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], xa + (kk / 16) * S8_CHUNK + (wr + 16 * i) * 16, 16);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
      const int off = (wc / 16 + j) * S8_CHUNK + kk * 16;
      wmma::load_matrix_sync(fb, wb + off, 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      if (DUAL) {
        wmma::load_matrix_sync(fb, ub + off, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(accu[i][j], fa[i], fb, accu[i][j]);
      }
    }
  }
}

// Stage a warp's 2x2 accumulator fragments into the block's (64, CSTRIDE)
// staging buffer(s) so the flush can walk the tile element by element.
template <typename Frag, typename A, bool DUAL>
__device__ __forceinline__ void stage_acc(A* cs, Frag (&acc)[2][2], Frag (&accu)[2][2], int wr, int wc) {
  using namespace nvcuda;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      A* dst = cs + (wr + 16 * i) * CSTRIDE + wc + 16 * j;
      wmma::store_matrix_sync(dst, acc[i][j], CSTRIDE, wmma::mem_row_major);
      if (DUAL) wmma::store_matrix_sync(dst + TILE * CSTRIDE, accu[i][j], CSTRIDE, wmma::mem_row_major);
    }
}

template <typename Frag, typename V>
__device__ __forceinline__ void zero_frags(Frag (&acc)[2][2], Frag (&accu)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      nvcuda::wmma::fill_fragment(acc[i][j], V(0));
      nvcuda::wmma::fill_fragment(accu[i][j], V(0));
    }
}

}  // namespace dip
