// DiP matmul for Hopper (sm_90a): epilogue(prologue(x) @ deshear(P)).
//
// Replaces repro/kernels/dip_matmul.py::dip_matmul_pallas (and, with
// deshear = 0, ws_matmul_pallas).  P is the DiP-permutated weight storage
// (dip_common.cuh).  The TPU kernel walks K on a sequential grid axis and
// carries the sum in VMEM scratch; here one block owns one 64x64 output tile
// and loops over K itself, since blocks run in no order.
//
// Per K step the block
//   * loads the 64x64 x tile with the rmsnorm prologue applied on load,
//     x * inv_rms[m] * gain[k] in f32, cast back to the x dtype before the
//     product (repro/kernels/prologue.py::kernel_load);
//   * reads the 64x64 tile of P row by row (coalesced 16-byte loads) and
//     writes it to shared memory already de-sheared;
//   * accumulates: bf16 in f32 and int8 in exact int32 through the tensor
//     cores (WMMA, i.e. mma.sync), f32 with IEEE FMAs on the CUDA cores (no
//     TF32).
// After the K loop it applies the epilogue to the f32 (int8: the int32
// widened to f32) accumulator and writes the output once; int8 with no
// epilogue writes the int32 accumulator itself, as the reference returns
// it.  swiglu streams the gate and up tiles over the same x tile into two
// accumulators.
//
// Bound on the card: at decode (M = slots) by the weight bytes; at prefill
// (M = 256) by tensor-core operations.  This first design does nothing about
// either yet: no TMA, no wgmma, no pipelining, and one 64x64 tile per block.
#include <algorithm>

#include "dip_common.cuh"

namespace {

using namespace dip;

struct Args {
  const void* x;         // (M, K) row-major, T
  const void* p;         // (K, N) row-major, T (permutated unless deshear == 0)
  const void* p_up;      // (K, N) second weight for swiglu, else null
  const float* inv_rms;  // (M,) f32 inverse RMS, null without prologue
  const float* gain;     // (K,) f32 norm gain, null without prologue
  const float* bias;     // (N,) f32, bias epilogues only
  const void* residual;  // (M, N) T, residual epilogue only
  void* out;             // (M, N) O
  int M, N, K;
  int epilogue;
  int deshear;
};

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

// T: x, P and residual type (float, bf16, int8); O: output type (T for the
// float types; int for int8 without an epilogue, float with one).
template <typename T, typename O, bool DUAL>
__global__ void __launch_bounds__(THREADS) dip_matmul_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const T* x = static_cast<const T*>(a.x);
  const T* p = static_cast<const T*>(a.p);
  const T* pu = static_cast<const T*>(a.p_up);
  const T* res = static_cast<const T*>(a.residual);
  O* out = static_cast<O*>(a.out);

  if constexpr (std::is_same<T, float>::value) {
    float* xs = reinterpret_cast<float*>(smem);
    float* ws = xs + Tile<float>::ELEMS;
    float* wu = ws + Tile<float>::ELEMS;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    float acc[8][4] = {}, accu[8][4] = {};
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();  // the previous step's tiles are consumed
      load_x_tile<float>(xs, x, a.inv_rms, a.gain, a.M, a.K, m0, k0);
      load_w_tile<float>(ws, p, a.N, k0, n0, a.deshear);
      if (DUAL) load_w_tile<float>(wu, pu, a.N, k0, n0, a.deshear);
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
        out[(size_t)gm * a.N + gn] =
            apply_epilogue(a.epilogue, acc[i][j], accu[i][j], a.bias, res, a.N, gm, gn);
      }
    }
  } else {
    const int warp = threadIdx.x / 32, wr = (warp / 2) * 32, wc = (warp % 2) * 32;
    constexpr bool S8 = std::is_same<T, int8_t>::value;
    using A = typename std::conditional<S8, int, float>::type;  // accumulator type
    using Frag = typename std::conditional<S8, FragS32, FragF32>::type;
    Frag acc[2][2], accu[2][2];
    zero_frags<Frag, A>(acc, accu);
    T* xs = reinterpret_cast<T*>(smem);
    constexpr int ELEMS = S8 ? S8_TILE : Tile<T>::ELEMS;
    T* ws = xs + ELEMS;
    T* wu = ws + ELEMS;
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();
      if constexpr (S8) {
        load_x_tile_s8(xs, x, a.inv_rms, a.gain, a.M, a.K, m0, k0);
        load_w_tile_s8(ws, p, a.N, k0, n0, a.deshear);
        if (DUAL) load_w_tile_s8(wu, pu, a.N, k0, n0, a.deshear);
        __syncthreads();
        mma_tile_s8<DUAL>(xs, ws, wu, acc, accu, wr, wc);
      } else {
        load_x_tile<T>(xs, x, a.inv_rms, a.gain, a.M, a.K, m0, k0);
        load_w_tile<T>(ws, p, a.N, k0, n0, a.deshear);
        if (DUAL) load_w_tile<T>(wu, pu, a.N, k0, n0, a.deshear);
        __syncthreads();
        mma_tile_bf16<DUAL>(xs, ws, wu, acc, accu, wr, wc);
      }
    }
    __syncthreads();  // the staging buffers below alias the operand tiles
    A* cs = reinterpret_cast<A*>(smem);
    const A* cu = cs + TILE * CSTRIDE;
    stage_acc<Frag, A, DUAL>(cs, acc, accu, wr, wc);
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, c = e % TILE, gm = m0 + r, gn = n0 + c;
      if (gm >= a.M) continue;
      if constexpr (std::is_same<O, int>::value) {
        out[(size_t)gm * a.N + gn] = cs[r * CSTRIDE + c];  // int8, no epilogue: the exact sum
      } else {
        const float zu = DUAL ? (float)cu[r * CSTRIDE + c] : 0.0f;
        out[(size_t)gm * a.N + gn] = from_f32<O>(
            apply_epilogue(a.epilogue, (float)cs[r * CSTRIDE + c], zu, a.bias, res, a.N, gm, gn));
      }
    }
  }
}

template <typename T, bool DUAL>
size_t smem_bytes() {
  if (std::is_same<T, int8_t>::value)
    return std::max<size_t>((DUAL ? 3 : 2) * S8_TILE, (DUAL ? 2 : 1) * TILE * CSTRIDE * sizeof(int));
  const size_t operands = (DUAL ? 3 : 2) * Tile<T>::ELEMS * sizeof(T);
  const size_t staging = std::is_same<T, float>::value ? 0 : (DUAL ? 2 : 1) * TILE * CSTRIDE * sizeof(float);
  return operands > staging ? operands : staging;
}

template <typename T, typename O, bool DUAL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, DUAL>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dip_matmul_kernel<T, O, DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.N / TILE, (a.M + TILE - 1) / TILE);
  dip_matmul_kernel<T, O, DUAL><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_any(const Args& a, cudaStream_t s) {
  return a.epilogue == EPI_SWIGLU ? launch<T, O, true>(a, s) : launch<T, O, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (out: int32 without an
// epilogue, float32 with one).  Returns a cudaError_t (0 on success).
extern "C" int dip_matmul_launch(int dtype, const void* x, const void* p, const void* p_up,
                                 const float* inv_rms, const float* gain, const float* bias,
                                 const void* residual, void* out, int M, int N, int K,
                                 int epilogue, int deshear, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE ||
      epilogue > EPI_RESIDUAL)
    return (int)cudaErrorInvalidValue;
  const Args a{x, p, p_up, inv_rms, gain, bias, residual, out, M, N, K, epilogue, deshear};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_any<float, float>(a, s);
  if (dtype == 1) return (int)launch_any<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (dtype == 2)
    return (int)(epilogue == EPI_NONE ? launch<int8_t, int, false>(a, s) : launch_any<int8_t, float>(a, s));
  return (int)cudaErrorInvalidValue;
}
