// DiP wavefront kernel for Hopper (sm_90a): the array's dataflow, literally.
//
// Replaces repro/kernels/dip_systolic.py::dip_systolic_pallas.  PE row r
// holds permutated weight row P[r, :]; the input row arrives rotated left by
// r (diagonal movement, paper Fig. 2a); each step is one rolled multiply-add
// over the 64 columns of the array:
//
//     acc[m, i] += x[m, (i + r) % 64] * P[r, i]        r = 0..63
//
// per 64-deep K tile.  Since P[r][i] = W[(r + i) % 64][i], the sweep sums
// x[m, k] * W[k, i] over every k of the tile: the weight is consumed in its
// permutated storage, never de-sheared.  It runs on the CUDA cores by design
// (as the TPU kernel runs on the vector unit, not the matrix unit): it exists
// to validate the dataflow on real tensors, not to be fast.
//
// One block owns BM rows x one 64-column array block and loops over K.
// Thread t owns column i = t % 64 and rows (t / 64) + 2j.  Per K tile the
// block loads the x tile (rmsnorm prologue applied on load, cast back to the
// x dtype, then widened) and the raw 64x64 P tile, both widened to the
// accumulator type: f32 for f32 and bf16 inputs (the reference widens both
// operands), int32 for int8.  A warp reads x[m, (i + r) % 64] and P[r, i]
// at 32 consecutive words, so shared memory serves both without conflicts.
// The epilogue is applied at the flush, as in dip_matmul.cu.
//
// Bound on the card: the f32 CUDA-core rate (67 TFLOP/s on an H100 SXM),
// which is where the design puts it.
#include "dip_common.cuh"

namespace {

using namespace dip;

struct Args {
  const void* x;         // (M, K) row-major, T
  const void* p;         // (K, N) row-major, T, permutated
  const void* p_up;      // (K, N) second weight for swiglu, else null
  const float* inv_rms;  // (M,) f32 inverse RMS, null without prologue
  const float* gain;     // (K,) f32 norm gain, null without prologue
  const float* bias;     // (N,) f32, bias epilogues only
  const void* residual;  // (M, N) T, residual epilogue only
  void* out;             // (M, N) O
  int M, N, K;
  int epilogue;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen(int8_t v) { return (int)v; }

// T: x, P and residual type; A: accumulator (float, or int for int8);
// O: output type; BM: rows per block.
template <typename T, typename A, typename O, int BM, bool DUAL>
__global__ void __launch_bounds__(THREADS) dip_systolic_kernel(const Args a) {
  constexpr int ROWS = BM / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  A* xs = reinterpret_cast<A*>(smem);  // (BM, 64)
  A* ps = xs + BM * TILE;              // (64, 64) permutated
  A* pu = ps + TILE * TILE;
  const T* x = static_cast<const T*>(a.x);
  const T* p = static_cast<const T*>(a.p);
  const T* pup = static_cast<const T*>(a.p_up);
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * BM;
  const int i = threadIdx.x % TILE, g = threadIdx.x / TILE;
  A acc[ROWS], accu[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) acc[j] = accu[j] = A(0);

  for (int k0 = 0; k0 < a.K; k0 += TILE) {
    __syncthreads();  // the previous tile's sweep is done
    for (int v = threadIdx.x; v < BM * TILE; v += THREADS) {
      const int r = v / TILE, c = v % TILE, gm = m0 + r;
      T e{};
      if (gm < a.M) {
        e = x[(size_t)gm * a.K + k0 + c];
        if (a.inv_rms != nullptr) e = from_f32<T>((to_f32(e) * a.inv_rms[gm]) * a.gain[k0 + c]);
      }
      xs[v] = widen(e);
    }
    for (int v = threadIdx.x; v < TILE * TILE; v += THREADS) {
      const size_t src = (size_t)(k0 + v / TILE) * a.N + n0 + v % TILE;
      ps[v] = widen(p[src]);
      if (DUAL) pu[v] = widen(pup[src]);
    }
    __syncthreads();
    // the wavefront: step r multiplies PE row r's stationary weights with
    // the input rotated left by r
#pragma unroll 4
    for (int r = 0; r < TILE; ++r) {
      const A w = ps[r * TILE + i];
      const A wu = DUAL ? pu[r * TILE + i] : A(0);
      const int col = (i + r) & (TILE - 1);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const A xv = xs[(g + 2 * j) * TILE + col];
        acc[j] += xv * w;
        if (DUAL) accu[j] += xv * wu;
      }
    }
  }
  const T* res = static_cast<const T*>(a.residual);
  O* out = static_cast<O*>(a.out);
  const int gn = n0 + i;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int gm = m0 + g + 2 * j;
    if (gm >= a.M) continue;
    if constexpr (std::is_same<O, int>::value) {
      out[(size_t)gm * a.N + gn] = acc[j];  // int8, no epilogue: the exact sum
    } else {
      out[(size_t)gm * a.N + gn] =
          from_f32<O>(apply_epilogue(a.epilogue, (float)acc[j], (float)accu[j], a.bias, res, a.N, gm, gn));
    }
  }
}

template <typename T, typename A, typename O, int BM, bool DUAL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = (BM * TILE + (DUAL ? 2 : 1) * TILE * TILE) * sizeof(A);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dip_systolic_kernel<T, A, O, BM, DUAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.N / TILE, (a.M + BM - 1) / BM);
  dip_systolic_kernel<T, A, O, BM, DUAL><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// 16-row blocks for a decode step's few rows, 64-row blocks otherwise
template <typename T, typename A, typename O>
cudaError_t launch_any(const Args& a, cudaStream_t s) {
  const bool dual = a.epilogue == EPI_SWIGLU;
  if (a.M <= 16) return dual ? launch<T, A, O, 16, true>(a, s) : launch<T, A, O, 16, false>(a, s);
  return dual ? launch<T, A, O, 64, true>(a, s) : launch<T, A, O, 64, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (out: int32 without an
// epilogue, float32 with one).  Returns a cudaError_t (0 on success).
extern "C" int dip_systolic_launch(int dtype, const void* x, const void* p, const void* p_up,
                                   const float* inv_rms, const float* gain, const float* bias,
                                   const void* residual, void* out, int M, int N, int K, int epilogue,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE ||
      epilogue > EPI_RESIDUAL)
    return (int)cudaErrorInvalidValue;
  const Args a{x, p, p_up, inv_rms, gain, bias, residual, out, M, N, K, epilogue};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_any<float, float, float>(a, s);
  if (dtype == 1) return (int)launch_any<__nv_bfloat16, float, __nv_bfloat16>(a, s);
  if (dtype == 2)
    return (int)(epilogue == EPI_NONE ? launch_any<int8_t, int, int>(a, s) : launch_any<int8_t, int, float>(a, s));
  return (int)cudaErrorInvalidValue;
}
