// DiP wavefront kernel for Hopper (sm_90a): the array's dataflow, literally,
// register-blocked on the CUDA cores.
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
// (as the TPU kernel runs on the vector unit, not the matrix unit), so its
// bound on the card is the f32 CUDA-core rate, 67 TFLOP/s on an H100 SXM
// (int8 accumulates exactly in int32, on the integer multiply-add at half
// that rate); at decode the weight bytes over 3.35 TB/s.
//
// What the design does about that bound.  The first design gave each thread
// one column and did one shared-memory load per multiply-add.  Here a thread
// owns TM rows x TN adjacent columns i0 .. i0 + TN - 1 (of each weight for
// swiglu).  At step r it needs x[m, (i0 + c + r) % 64] for c < TN: a window
// of TN consecutive values per row that slides by one each step.  The 64
// steps are unrolled, so the window lives in registers and sliding is
// renaming: a step loads one new x value per row (one vector of four every
// four steps) and one vector of P[r, i0 .. i0 + TN - 1], against TM x TN
// multiply-adds (8 x 8, or 8 x 4 per weight for swiglu: four per value
// loaded, against one before) -- the paper's Fig. 2a in registers, the
// input moving diagonally and the weights staying.  Each output's sum runs
// over r in ascending order, tiles in ascending K.
//
// Block: four warps; warp w owns rows TM w .. TM w + TM - 1 of the block and
// lane l the TN columns of lane l % (64 / TN) in 64-column tile
// l / (64 / TN), so the 32 lanes read one row's x window at 64 / TN
// distinct offsets (broadcast to the other tiles) and one P row
// contiguously.  x and P tiles land raw in a ring of 2 or 3 stages by
// 16-byte cp.async copies.  Each thread then passes over the x chunks it
// copied itself, before the barrier that hands the stage on: the rmsnorm
// prologue (x * inv_rms[m]) * gain[k] in f32, cast back to the x dtype, and
// for bf16 and int8 the widening into an f32 (int32) x buffer of two slots,
// so that the inner loop reads x ready to multiply; P is widened on the
// read into registers (bf16 by a shift, int8 by a sign extension).  The
// epilogue is applied at the flush.
//
// Tiles and K splits come from kernels/dip_systolic.py::systolic_plan:
// prefill (M > 16) 32-row blocks (TM = 8), 256 columns (128 per weight for
// swiglu), K split where that fills the last wave of blocks better; decode
// (M <= 16) 16-row blocks (TM = 4, a warp whose rows lie past M only
// copies) of 128 columns, with K split until at least 2 x SMs blocks stream
// weights.  A split writes its partial sums (f32, or int32 for int8,
// which keeps them exact) to a workspace, and systolic_reduce_kernel adds
// them in split order before the epilogue.
#include "cp_async.cuh"
#include "dip_common.cuh"

namespace {

using namespace dip;
using bf16 = __nv_bfloat16;

struct Args {
  const void* x;         // (M, K) row-major, T
  const void* p;         // (K, N) row-major, T, permutated
  const void* p_up;      // (K, N) second weight for swiglu, else null
  const float* inv_rms;  // (M,) f32 inverse RMS, null without prologue
  const float* gain;     // (K,) f32 norm gain, null without prologue
  const float* bias;     // (N,) f32, bias epilogues only
  const void* residual;  // (M, N) T, residual epilogue only
  void* out;             // (M, N) T; int8: int32 without an epilogue, f32 with one
  int M, N, K;
  int epilogue;
};

// Four raw elements at a 4-element-aligned shared address, widened to the
// accumulator type (element 0 in the low bits).
__device__ __forceinline__ void widen4(const float* s, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void widen4(const bf16* s, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(s);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}
__device__ __forceinline__ void widen4(const int8_t* s, int (&v)[4]) {
  const int q = *reinterpret_cast<const int*>(s);
  v[0] = (q << 24) >> 24, v[1] = (q << 16) >> 24, v[2] = (q << 8) >> 24, v[3] = q >> 24;
}
__device__ __forceinline__ void widen4(const int* s, int (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(s);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ float widen1(float v) { return v; }
__device__ __forceinline__ float widen1(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen1(int8_t v) { return v; }

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mad(int a, int b, int c) { return a * b + c; }

// One output: for int8 the exact int32 sum without an epilogue, else the
// f32 epilogue in f32; for f32 and bf16 the epilogue cast to T.  (The int8
// output type is chosen here, at run time, so that one mainloop serves both.)
template <typename T, typename A>
__device__ __forceinline__ void store_out(const Args& a, size_t o, int gm, int gn, A z, A zu) {
  const T* res = static_cast<const T*>(a.residual);
  if constexpr (std::is_same<T, int8_t>::value) {
    if (a.epilogue == EPI_NONE)
      static_cast<int*>(a.out)[o] = z;
    else
      static_cast<float*>(a.out)[o] = apply_epilogue(a.epilogue, (float)z, (float)zu, a.bias, res, a.N, gm, gn);
  } else {
    static_cast<T*>(a.out)[o] = from_f32<T>(apply_epilogue(a.epilogue, z, zu, a.bias, res, a.N, gm, gn));
  }
}

// T: x, P and residual type; A: accumulator; TM x TN: a thread's rows and
// columns (per weight); NW: 2 for swiglu.
template <typename T, typename A, int TM, int TN, int NW>
struct SysCfg {
  static constexpr int BM = 4 * TM;      // block rows, TM per warp
  static constexpr int BN = 32 * TN;     // block columns per weight, TN per lane
  static constexpr int LPT = TILE / TN;  // lanes per 64-column tile
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte copy
  static constexpr bool WIDE = !std::is_same<T, A>::value;  // x widened into a buffer of its own
  // decode streams weights, prefill multiplies: three stages keep the
  // decode's copies in flight, two cover the prefill's (and two blocks an SM)
  static constexpr int STAGES = TM == 4 && sizeof(T) < 4 ? 3 : 2;
  static constexpr int X_BYTES = BM * TILE * (int)sizeof(T);
  static constexpr int P_BYTES = TILE * BN * (int)sizeof(T);  // one weight's tile
  static constexpr int STAGE = X_BYTES + NW * P_BYTES;
  static constexpr int XW_BYTES = WIDE ? BM * TILE * 4 : 0;  // one widened x tile
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * XW_BYTES;
  static constexpr int X_CHUNKS = X_BYTES / 16;                // per stage
  static constexpr int P_CHUNKS = P_BYTES / 16 / THREADS;  // per thread and weight
  static_assert(P_BYTES % (16 * THREADS) == 0 && TN % 4 == 0, "tile shape");
};

// One block: rows m0 = blockIdx.x * BM.., columns n0 = blockIdx.y * BN.. (of
// each weight), K tiles [kt0, kt0 + nk) with kt0 = blockIdx.z * kps.  part
// != null: write the sums of this split to part[(split * NW + w) * M * N +
// m * N + n].
template <typename T, typename A, int TM, int TN, int NW>
__global__ void __launch_bounds__(THREADS) dip_systolic_kernel(const Args a, const int kps, A* __restrict__ part) {
  using C = SysCfg<T, A, TM, TN, NW>;
  constexpr int S = C::STAGES, BN = C::BN, VEC = C::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kps, nk = min(a.K / TILE - kt0, kps);
  const int M = a.M, N = a.N, K = a.K;
  const T* x = static_cast<const T*>(a.x);
  const T* w_src[2] = {static_cast<const T*>(a.p), static_cast<const T*>(a.p_up)};
  const bool prologue = a.inv_rms != nullptr;
  const int tile = lane / C::LPT, i0 = (lane % C::LPT) * TN, row0 = warp * TM;
  const bool rows_live = m0 + row0 < M;  // warp-uniform
  auto x_slot = [&](int t) { return reinterpret_cast<T*>(smem + (t % S) * C::STAGE); };
  auto w_slot = [&](int t, int w) {
    return reinterpret_cast<T*>(smem + (t % S) * C::STAGE + C::X_BYTES + w * C::P_BYTES);
  };
  // the x tile the wavefront reads: the widened buffer t & 1, or for f32 the
  // ring slot itself
  auto x_op = [&](int t) {
    return C::WIDE ? reinterpret_cast<A*>(smem + S * C::STAGE + (t & 1) * C::XW_BYTES)
                   : reinterpret_cast<A*>(x_slot(t));
  };

  // x chunk v of a stage is row v / (64 / VEC), elements (v % (64 / VEC)) *
  // VEC; thread tid copies chunks tid, tid + 128, ...; weight chunk v is row
  // v / (BN / VEC) of the P tile
  constexpr int XPR = TILE / VEC, XJ = (C::X_CHUNKS + THREADS - 1) / THREADS;
  auto issue = [&](int t) {
    const int k0 = (kt0 + t) * TILE;
    T* xs = x_slot(t);
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const int v = tid + THREADS * j, r = v / XPR, c = (v % XPR) * VEC, gm = m0 + r;
      if (C::X_CHUNKS % THREADS == 0 || v < C::X_CHUNKS)
        sm90::cp_async16(xs + r * TILE + c, x + (size_t)min(gm, M - 1) * K + k0 + c, gm < M);
    }
    constexpr int PPR = BN / VEC;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int j = 0; j < C::P_CHUNKS; ++j) {
        const int v = tid + THREADS * j, s = v / PPR, c = (v % PPR) * VEC, gn = n0 + c;
        sm90::cp_async16(w_slot(t, w) + s * BN + c, w_src[w] + (size_t)(k0 + s) * N + min(gn, N - VEC), gn < N);
      }
  };

  // this thread's own x chunks of stage t: the rmsnorm prologue, then the
  // widening into x_op(t) (f32: the prologue in place)
  auto prepare = [&](int t) {
    const T* xs = x_slot(t);
    A* xw = x_op(t);
    const int k0 = (kt0 + t) * TILE;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const int v = tid + THREADS * j, r = v / XPR, c = (v % XPR) * VEC, gm = m0 + r;
      if (!(C::X_CHUNKS % THREADS == 0 || v < C::X_CHUNKS) || (!prologue && !C::WIDE)) continue;
      const T* e = xs + r * TILE + c;
      A* d = xw + r * TILE + c;
      const float iv = prologue && gm < M ? a.inv_rms[gm] : 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const T y = prologue && gm < M ? from_f32<T>((to_f32(e[i]) * iv) * a.gain[k0 + c + i]) : e[i];
        d[i] = widen1(y);
      }
    }
  };

  A acc[NW][TM][TN];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[w][j][c] = A(0);

  // The wavefront over stage t.  xv[j][g] holds x[row0 + j, (i0 + 4 g + e)
  // mod 64], e < 4: group g enters the window at step 4 g - TN (one step
  // ahead of its first use) and leaves it at step 4 g + 3; every index is a
  // compile-time constant, so the array lives in registers and only the
  // live groups take them.
  auto wavefront = [&](int t) {
    const A* xs = x_op(t) + row0 * TILE;
    const T* ps[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) ps[w] = w_slot(t, w) + tile * TILE + i0;
    A xv[TM][(TILE + TN) / 4][4];
    auto load_group = [&](int g) {
      const int c = (i0 + 4 * g) & (TILE - 1);
#pragma unroll
      for (int j = 0; j < TM; ++j) widen4(xs + j * TILE + c, xv[j][g]);
    };
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) load_group(g);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      if (r % 4 == 0) load_group(TN / 4 + r / 4);
      A pw[NW][TN / 4][4];  // PE row r's stationary weights of this thread's columns
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int c4 = 0; c4 < TN / 4; ++c4) widen4(ps[w] + r * BN + 4 * c4, pw[w][c4]);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < TM; ++j)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[w][j][c] = mad(xv[j][(r + c) / 4][(r + c) % 4], pw[w][c / 4][c % 4], acc[w][j][c]);
    }
  };

  // the ring: stages 0 .. S-2 in flight before the loop; step t issues stage
  // t + S - 1 into the slot stage t - 1 left, runs the wavefront over stage
  // t, then waits for its own copies of stage t + 1 and prepares them
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<S - 2>();
  if (nk > 0) prepare(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    if (t + S - 1 < nk) issue(t + S - 1);
    sm90::cp_async_commit();
    if (rows_live) wavefront(t);
    if (t + 1 < nk) {
      sm90::cp_async_wait<S - 2>();
      prepare(t + 1);
    }
    __syncthreads();
  }
  sm90::cp_async_wait<0>();

  const size_t mn = (size_t)M * N;
  const int gn0 = n0 + tile * TILE + i0;
  if (gn0 >= N) return;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int gm = m0 + row0 + j;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const size_t o = (size_t)gm * N + gn0 + c;
      if (part != nullptr) {
#pragma unroll
        for (int w = 0; w < NW; ++w) part[(blockIdx.z * NW + w) * mn + o] = acc[w][j][c];
      } else {
        store_out<T, A>(a, o, gm, gn0 + c, acc[0][j][c], acc[NW - 1][j][c]);
      }
    }
  }
}

// The split-K second pass: the splits' partial sums added in split order
// (int32 for int8: exact), then the epilogue on the whole sum and one cast.
template <typename T, typename A, int NW>
__global__ void systolic_reduce_kernel(const Args a, const A* __restrict__ part, int splits) {
  const size_t mn = (size_t)a.M * a.N;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  A z = A(0), zu = A(0);
  for (int s = 0; s < splits; ++s) {
    z += part[(size_t)s * NW * mn + e];
    if (NW == 2) zu += part[((size_t)s * NW + 1) * mn + e];
  }
  store_out<T, A>(a, e, (int)(e / a.N), (int)(e % a.N), z, zu);
}

template <typename T, typename A, int TM, int TN, int NW>
cudaError_t launch(const Args& a, int splits, int kps, void* work, cudaStream_t stream) {
  using C = SysCfg<T, A, TM, TN, NW>;
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(dip_systolic_kernel<T, A, TM, TN, NW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  A* part = splits > 1 ? static_cast<A*>(work) : nullptr;
  const dim3 grid((a.M + C::BM - 1) / C::BM, (a.N + C::BN - 1) / C::BN, splits);
  dip_systolic_kernel<T, A, TM, TN, NW><<<grid, THREADS, C::SMEM, stream>>>(a, kps, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)a.M * a.N;
  systolic_reduce_kernel<T, A, NW><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(a, part, splits);
  return cudaGetLastError();
}

// The plan's (bm, bn) picks the tile: bm = 16 the decode tile (TM = 4, 128
// columns a weight), bm = 32 the prefill tile (TM = 8; 256 columns, or 128
// a weight for swiglu).
template <typename T, typename A>
cudaError_t launch_plan(const Args& a, int bm, int bn, int splits, int kps, void* work, cudaStream_t s) {
  const int k_tiles = a.K / TILE;
  if (splits < 1 || kps < 1 || (long long)splits * kps < k_tiles || (long long)(splits - 1) * kps >= k_tiles ||
      (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const bool dual = a.epilogue == EPI_SWIGLU;
  if (bm == 16 && bn == 128)
    return dual ? launch<T, A, 4, 4, 2>(a, splits, kps, work, s) : launch<T, A, 4, 4, 1>(a, splits, kps, work, s);
  if (bm == 32 && bn == (dual ? 128 : 256))
    return dual ? launch<T, A, 8, 4, 2>(a, splits, kps, work, s) : launch<T, A, 8, 8, 1>(a, splits, kps, work, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (out: int32 without an
// epilogue, float32 with one).  bm, bn, splits, kps (K tiles per split) and
// workspace (splits x (2 for swiglu, else 1) x M x N of f32, int32 for int8;
// used when splits > 1) are the plan (kernels/dip_systolic.py::
// systolic_plan).  Returns a cudaError_t (0 on success).
extern "C" int dip_systolic_launch(int dtype, const void* x, const void* p, const void* p_up,
                                   const float* inv_rms, const float* gain, const float* bias,
                                   const void* residual, void* out, int M, int N, int K, int epilogue,
                                   int bm, int bn, int splits, int kps, void* workspace, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE || epilogue > EPI_RESIDUAL)
    return (int)cudaErrorInvalidValue;
  const Args a{x, p, p_up, inv_rms, gain, bias, residual, out, M, N, K, epilogue};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_plan<float, float>(a, bm, bn, splits, kps, workspace, s);
  if (dtype == 1) return (int)launch_plan<bf16, float>(a, bm, bn, splits, kps, workspace, s);
  if (dtype == 2) return (int)launch_plan<int8_t, int>(a, bm, bn, splits, kps, workspace, s);
  return (int)cudaErrorInvalidValue;
}
