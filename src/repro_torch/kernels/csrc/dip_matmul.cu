// DiP matmul for Hopper (sm_90a): epilogue(prologue(x) @ deshear(P)).
//
// Replaces repro/kernels/dip_matmul.py::dip_matmul_pallas (and, with
// deshear = 0, ws_matmul_pallas), and for bf16 x with e4m3 weights the fp8
// route of repro/kernels/dip_matmul_q.py::dip_matmul_q_pallas, whose int8
// route runs the s8 mainloops at the end of this file.  P is the
// DiP-permutated weight storage (dip_common.cuh).  The TPU kernel walks K on
// a sequential grid axis and carries the sum in VMEM scratch; here a block
// loops over K itself, since blocks run in no order, and a K range split
// across blocks is summed by a second pass.
//
// bf16 x runs one of two mainloops, chosen by the plan the wrapper computes
// (kernels/dip_matmul.py::matmul_plan), on bf16 weights or on e4m3 codes
// (one byte a weight, upcast exactly to bf16 in the conversion pass, with
// z = acc * w_scale[n] before the epilogue; the same products after it):
//
//   * prefill and training (M > 32; M = 256 a chunk, 4096 a training batch)
//     are bound by the tensor-core operations.  dip_wgmma_kernel: 128 x 128
//     block tiles (64 columns per weight for swiglu, so that one
//     m64n128k16 product serves both weights), two warpgroups of 64 rows,
//     wgmma with both operands in shared memory, K-major with the 128-byte
//     swizzle.  A ring of 4 stages is filled by cp.async 16-byte copies:
//     x lands swizzled, ready for wgmma, and P lands raw.  While a step's
//     products run, the block turns the next stage's P into the K-major
//     operand (one of three buffers), de-shearing it on the way: for bf16
//     each thread gathers two 16-byte operand chunks, of columns n and
//     n + 1, from nine 32-bit words; for e4m3 four chunks, of columns
//     n .. n + 3, from eleven words, upcasting each byte pair; either way
//     the 32 lanes' words fall on 32 banks.
//     The rmsnorm prologue x * inv_rms[m] * gain[k] (f32, cast back to
//     bf16) is applied on the same pass, in place in the x stage, its gain
//     carried through the ring.  One step's products stay in flight across
//     the barrier, so the tensor cores do not drain between steps.  Where
//     the tiles fill fewer SMs than the card has, K is split.
//   * decode (M <= 32, the serving slots) is bound by the weight bytes
//     (4.5 ms of bf16 weights per llama3-8b forward at 3.35 TB/s, half that
//     in e4m3).  dip_mma_kernel: 32 x 64 tiles (two blocks an SM), eight
//     warps in a 2 x 4 grid, mma.sync m16n8k16 fed by ldmatrix, a ring of
//     3-4 cp.async stages (for e4m3: 32 x 128 tiles of a single weight, so
//     that a block still reads 128 bytes of each weight row, and 5 stages).
//     A projection of N/64 tiles would leave most SMs idle, so the plan
//     splits K until at least 2 x SMs blocks stream weights.  For bf16
//     each thread de-shears the chunks it copied itself (no barrier of its
//     own), in an element order rotated by lane so that its 2-byte scatter
//     is free of bank conflicts, interleaved with the products of the step
//     before; for e4m3 the block gathers the transposed operand from every
//     thread's copies (stage t + 1 made visible by the barrier ending step
//     t - 1), eleven words and four 16-byte stores a thread.
//
// With a K split each split writes f32 partial sums to a workspace the
// wrapper allocates, and splitk_reduce_kernel adds them in split order (no
// atomics) and only then applies the scales and the epilogue; without one
// they are applied straight from the accumulator registers, with one cast.
// The output is bf16, or for e4m3 weights also f32 (the fp8 route with f32
// x, fed bf16 x by dip_matmul_q.cu's cast pass), whose sums are carried in
// IEEE f32 across K (FLUSH below); the residual has the output's type.
//
// f32 keeps IEEE FMAs on the CUDA cores (no TF32) and int8 exact int32 WMMA
// s8 (dip_matmul_kernel): one block per 64x64 output tile, the tile
// de-sheared on its way into shared memory, the prologue applied on load.
// int8 with no epilogue writes the int32 accumulator itself, as the
// reference returns it.
//
// The int8 route of dip_matmul_q (dip_matmul_int8q_launch: x's codes from
// dip_matmul_q.cu's quantizing pass, int8 weights, exact int32 sums) keeps
// the e4m3 tiles' plan and is bound as they are, by the weight bytes at
// decode (one a weight) and by the operations at prefill (int8 at twice
// the bf16 rate).  8-bit products take both operands K-major, so its
// conversion pass transposes the raw weight rows as it de-shears them, and
// its prefill operands take the 64-byte swizzle (a 64-deep tile of int8 is
// a 64-byte row); split-K partials stay int32, so the sum is exact.
#include <algorithm>

#include "dip_common.cuh"
#include "sm90_mma.cuh"

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
  const float* w_scale;     // (N,) f32 per-output-channel scales of e4m3 weights, else null
  const float* w_scale_up;  // (N,) the up weight's scales, e4m3 swiglu only
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

// T: x, P and residual type (float, int8); O: output type (float; for int8
// int without an epilogue, float with one).
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
    static_assert(std::is_same<T, int8_t>::value, "bf16 runs dip_mma_kernel / dip_wgmma_kernel");
    const int warp = threadIdx.x / 32, wr = (warp / 2) * 32, wc = (warp % 2) * 32;
    using A = int;  // the exact int32 accumulator
    using Frag = FragS32;
    Frag acc[2][2], accu[2][2];
    zero_frags<Frag, A>(acc, accu);
    T* xs = reinterpret_cast<T*>(smem);
    T* ws = xs + S8_TILE;
    T* wu = ws + S8_TILE;
    for (int k0 = 0; k0 < a.K; k0 += TILE) {
      __syncthreads();
      load_x_tile_s8(xs, x, a.inv_rms, a.gain, a.M, a.K, m0, k0);
      load_w_tile_s8(ws, p, a.N, k0, n0, a.deshear);
      if (DUAL) load_w_tile_s8(wu, pu, a.N, k0, n0, a.deshear);
      __syncthreads();
      mma_tile_s8<DUAL>(xs, ws, wu, acc, accu, wr, wc);
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
  return (DUAL ? 3 : 2) * Tile<T>::ELEMS * sizeof(T);
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

// ----------------------------- bf16 and fp8 weights: tensor-core mainloops ---
using bf16 = __nv_bfloat16;
using fp8 = uint8_t;  // an e4m3 code (float8_e4m3fn storage)
constexpr int MMA_THREADS = 256;     // eight warps, 2 (rows) x 4 (columns)
constexpr int WARPS_N = 4;
constexpr int XS = TILE + 8;         // x stage / operand row stride (elements)

// two adjacent outputs, f32 or bf16
template <typename O>
__device__ __forceinline__ void store2(O* p, float a, float b) {
  if constexpr (std::is_same<O, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The f32 output (the fp8 route with f32 x) keeps its sums IEEE f32 across
// K: mma.sync and wgmma round their f32 sums toward zero, a bias that over
// K = 14336 grows past the f32 tolerance, so each K tile's products (the
// decode tile) or each FLUSH K tiles' (the wgmma tile) start from zero and
// are added to a running total in IEEE f32, as a split's partials are.
// The bf16 output is rounded to 2^-8 and keeps one accumulator.
constexpr int FLUSH = 4;

// Two e4m3 codes, in bits 8..15 and 24..31 of v (the other bits are
// ignored), to two bf16 (the first in the low half), exactly: the code's
// magnitude bits land in the bf16 exponent and mantissa fields, so the bf16
// reads 2^-120 times the code's value (a bf16 subnormal for an e4m3
// subnormal), and one packed product by 2^120 restores it.  e4m3fn's NaN
// codes never occur: the quantizer saturates at 448.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t v) {
  const uint32_t bits = ((v >> 4) & 0x07F007F0u) | (v & 0x80008000u);
  const uint32_t two120 = 0x7B807B80u;  // bf16 2^120, twice
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                   *reinterpret_cast<const __nv_bfloat162*>(&two120));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The decode tile's layout for a weight element type WT: the raw ring slot
// holds the x tile (bf16, padded rows) then the weight tile(s) as they were
// copied (bf16: one padded row-major tile per weight, so the undisturbed
// tile can be the operand; e4m3: one tile of 128-byte rows, 128 columns or
// for swiglu the gate's 64 then the up weight's 64, so every block reads
// whole 128-byte row segments as the bf16 tile does), and the converted
// operand slot the x tile and the de-sheared bf16 weight tile(s): row-major
// [k][n] for bf16, transposed [n][k] for e4m3, whose gather writes whole
// 16-byte chunks of k.
template <typename WT, bool DUAL>
struct Cfg {
  static constexpr bool FP8 = sizeof(WT) == 1;
  static constexpr int MI = 1, NI = FP8 && !DUAL ? 4 : 2;  // m16 and n8 tiles per warp
  static constexpr int BM = 2 * 16 * MI;             // block rows
  static constexpr int BN = WARPS_N * 8 * NI;        // block columns per weight
  static constexpr int WS = FP8 ? TILE + 8 : BN + 8;  // weight operand row stride (elements; e4m3: of k)
  static constexpr int NW = DUAL ? 2 : 1;
  // bf16: the swiglu tile keeps two blocks on an SM with three stages;
  // e4m3 stages hold 8 KB of weights either way, and five keep two blocks
  static constexpr int STAGES = FP8 ? 5 : (DUAL ? 3 : 4);
  static constexpr int X_ELEMS = BM * XS;
  static constexpr int W_ELEMS = (FP8 ? BN : TILE) * WS;
  static constexpr int RAW_W = FP8 ? TILE * BN : W_ELEMS * 2;  // bytes of one raw weight tile
  static constexpr int RW = NW * BN;                           // e4m3: bytes of one raw row (both weights)
  static constexpr int RAW = X_ELEMS * 2 + NW * RAW_W;         // bytes of one ring slot
  static constexpr int OP = (X_ELEMS + NW * W_ELEMS) * 2;      // bytes of one operand slot
  static constexpr size_t SMEM = (size_t)STAGES * RAW + 2 * OP;
  static constexpr int X_CHUNKS = BM * TILE / 8 / MMA_THREADS;  // 16-byte chunks per thread
  static constexpr int CPR = (FP8 ? RW : BN * 2) / 16;         // 16-byte weight chunks per raw row
  static constexpr int W_CHUNKS = TILE * CPR / MMA_THREADS;     // per thread (bf16: per weight)
  static_assert(!FP8 || NW * BN == 128, "e4m3: one 128-byte raw row, four columns a lane");
};

// Rotate the eight bf16 of a chunk left by 2 * rot elements (rot in 0..3)
// with selects, so every element index below stays a compile-time constant.
__device__ __forceinline__ uint4 rotate_chunk(uint4 v, int rot) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = rot == 0 ? w[i] : rot == 1 ? w[(i + 1) & 3] : rot == 2 ? w[(i + 2) & 3] : w[(i + 3) & 3];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// One block: rows m0.., columns n0.. (of each weight), K tiles
// [kt0, kt0 + nk) with kt0 = blockIdx.z * kps.  part != null: write the f32
// sums of this split to part[(split * NW + w) * M * N + m * N + n].  O: the
// output and residual type, bf16 or (e4m3 weights only) f32.
template <typename WT, typename O, bool DUAL>
__global__ void __launch_bounds__(MMA_THREADS) dip_mma_kernel(const Args a, const int kps,
                                                              float* __restrict__ part) {
  using C = Cfg<WT, DUAL>;
  constexpr bool IEEE = std::is_same<O, float>::value;
  constexpr bool FP8 = C::FP8;
  constexpr int MI = C::MI, NI = C::NI;
  constexpr int S = C::STAGES, NW = C::NW, BN = C::BN, WS = C::WS, CPR = C::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* raw = smem;                                        // [S][RAW]: x tile, then the weight tile(s)
  bf16* op = reinterpret_cast<bf16*>(smem + S * C::RAW);            // [2][OP]: converted operands
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int kt0 = blockIdx.z * kps, nk = min(a.K / TILE - kt0, kps);
  const int M = a.M, N = a.N, K = a.K;
  const bf16* x = static_cast<const bf16*>(a.x);
  const unsigned char* w_src[2] = {static_cast<const unsigned char*>(a.p),
                                   static_cast<const unsigned char*>(a.p_up)};
  const bool prologue = a.inv_rms != nullptr, deshear = a.deshear != 0;
  // bf16: a chunk's eight elements rotate by 2 (lane / 8 % 4), the order
  // that spreads the 32 lanes' scattered stores over the 32 banks
  const int rot = (lane >> 3) & 3;
  auto x_slot = [&](int t) { return reinterpret_cast<bf16*>(raw + (t % S) * C::RAW); };
  auto w_slot = [&](int t, int w) { return raw + (t % S) * C::RAW + C::X_ELEMS * 2 + w * C::RAW_W; };

  // every thread copies, and later converts, the same chunks of each stage:
  // x chunk j is row (tid + 256 j) / 8, columns 8 * ((tid + 256 j) % 8);
  // weight chunk j is raw row (tid + 256 j) / CPR, its 16-byte chunk
  // (tid + 256 j) % CPR
  auto issue = [&](int t) {
    bf16* xs = x_slot(t);
    const int k0 = (kt0 + t) * TILE;
#pragma unroll
    for (int j = 0; j < C::X_CHUNKS; ++j) {
      const int v = tid + MMA_THREADS * j, r = v >> 3, c = (v & 7) * 8, gm = m0 + r;
      sm90::cp_async16(xs + r * XS + c, x + (size_t)min(gm, M - 1) * K + k0 + c, gm < M);
    }
    if constexpr (FP8) {
      // chunk j: raw row s, bytes cb .. cb + 15 (swiglu: the gate's columns
      // below byte 64, the up weight's from there)
#pragma unroll
      for (int j = 0; j < C::W_CHUNKS; ++j) {
        const int v = tid + MMA_THREADS * j, s = v / CPR, cb = (v % CPR) * 16, gn = n0 + cb % BN;
        sm90::cp_async16(w_slot(t, 0) + s * C::RW + cb, w_src[cb / BN] + (size_t)(k0 + s) * N + min(gn, N - 16),
                         gn < N);
      }
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < C::W_CHUNKS; ++j) {
          const int v = tid + MMA_THREADS * j, s = v / CPR, c = (v % CPR) * 8, gn = n0 + c;
          sm90::cp_async16(w_slot(t, w) + (s * WS + c) * 2, w_src[w] + ((size_t)(k0 + s) * N + min(gn, N - 8)) * 2,
                           gn < N);
        }
    }
  };

  // stage t -> operand buffer t & 1: the prologue on x, the de-shear (and for
  // e4m3 the upcast) on the weights.  Piece q of 4 takes the chunks whose
  // index is q mod 4, so that the pass interleaves with the four 16-deep
  // products of the step before.
  auto convert = [&](int t, int q) {
    const bf16* slot = x_slot(t);
    bf16* dst = op + (t & 1) * (C::OP / 2);
    const int k0 = (kt0 + t) * TILE;
    if (prologue) {
#pragma unroll
      for (int j = q; j < C::X_CHUNKS; j += 4) {
        const int v = tid + MMA_THREADS * j, r = v >> 3, c = (v & 7) * 8, gm = m0 + r;
        uint4 chunk = *reinterpret_cast<const uint4*>(slot + r * XS + c);
        if (gm < M) {
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&chunk);
          const float iv = a.inv_rms[gm];
          const float4 g0 = *reinterpret_cast<const float4*>(a.gain + k0 + c);
          const float4 g1 = *reinterpret_cast<const float4*>(a.gain + k0 + c + 4);
          const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(e[i]);
            e[i] = __floats2bfloat162_rn((f.x * iv) * gs[2 * i], (f.y * iv) * gs[2 * i + 1]);
          }
        }
        *reinterpret_cast<uint4*>(dst + r * XS + c) = chunk;
      }
    }
    if constexpr (FP8) {
      // the transposed gather (piece 0): thread (lane, warp) builds the
      // 16-byte chunks k = 8 warp .. + 7 of operand columns n .. n + 3 (n =
      // 4 lane of the raw row's 128) from 32-bit words of the raw rows,
      // each holding those 4 columns: with deshear, W[k][nl + j] is byte j
      // of the word of row k - nl - j, so eleven words give all four
      // chunks, each byte pair upcast on the way (the 32 lanes' words fall
      // on 32 banks)
      if (q == 0) {
        const int n = 4 * lane, nl = n % BN, kc = warp;
        const uint32_t* col = reinterpret_cast<const uint32_t*>(w_slot(t, 0)) + lane;
        uint32_t wd[11];
#pragma unroll
        for (int i = 0; i < 11; ++i) wd[i] = col[((8 * kc + i - 3 - (deshear ? nl : 0)) & (TILE - 1)) * (C::RW / 4)];
        bf16* wd_out = dst + C::X_ELEMS + (n / BN) * C::W_ELEMS;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sh = deshear ? 3 - j : 3;  // element e of column j: byte j of word e + sh
          uint32_t o[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
            o[p] = e4m3x2_to_bf16x2(__byte_perm(wd[2 * p + sh], wd[2 * p + 1 + sh], ((4 + j) << 12) | (j << 4)));
          *reinterpret_cast<uint4*>(wd_out + (nl + j) * WS + 8 * kc) = make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    } else if (deshear) {
#pragma unroll
      for (int wj = q; wj < NW * C::W_CHUNKS; wj += 4) {
        const int w = wj / C::W_CHUNKS, j = wj % C::W_CHUNKS;
        const int v = tid + MMA_THREADS * j, s = v / CPR, c = (v % CPR) * 8;
        const uint4 chunk = rotate_chunk(*reinterpret_cast<const uint4*>(w_slot(t, w) + (s * WS + c) * 2), rot);
        const bf16* e = reinterpret_cast<const bf16*>(&chunk);
        bf16* wd = dst + C::X_ELEMS + w * C::W_ELEMS;
        // P[s][c + i] lands at W[(s + c + i) mod 64][c + i]; element i of
        // the rotated chunk is element (i + 2 rot) mod 8 of the stored one
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ci = c + ((i + 2 * rot) & 7);
          wd[((s + ci) & (TILE - 1)) * WS + ci] = e[i];
        }
      }
    }
  };

  float acc[NW][MI][NI][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.0f;
  float tot[IEEE ? NW : 1][MI][NI][4] = {};  // IEEE: the running total of the K tiles' sums
  const int wr = (warp / WARPS_N) * 16 * MI, wc = (warp % WARPS_N) * 8 * NI;

  // Step t: the products of stage t, with the fragments of the next 16-deep
  // slice loaded before this slice's products are issued, and stage t + 1
  // converted in four pieces between them.
  auto compute = [&](int t) {
    const bf16* slot = x_slot(t);
    const bf16* cvt = op + (t & 1) * (C::OP / 2);
    const bf16* xs = prologue ? cvt : slot;
    const bf16* ws = (FP8 || deshear ? cvt : slot) + C::X_ELEMS;
    const bool next = t + 1 < nk;
    if (!FP8 && next) sm90::cp_async_wait<S - 2>();  // this thread's copies of stage t + 1 have landed
    uint32_t af[2][MI][4], bfr[2][NW][NI / 2][4];
    auto load_frags = [&](int buf, int kk) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
        sm90::ldmatrix_x4(af[buf][i], xs + (wr + 16 * i + (lane & 15)) * XS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          if constexpr (FP8)  // [n][k]: the fragments' own layout
            sm90::ldmatrix_x4(bfr[buf][w][j], ws + w * C::W_ELEMS + (wc + 16 * j + (lane & 7) + (lane >> 4) * 8) * WS +
                                                  kk + ((lane >> 3) & 1) * 8);
          else
            sm90::ldmatrix_x4_trans(bfr[buf][w][j], ws + w * C::W_ELEMS +
                                                        (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + wc +
                                                        16 * j + (lane >> 4) * 8);
        }
    };
    load_frags(0, 0);
#pragma unroll
    for (int q = 0; q < TILE / 16; ++q) {
      if (q + 1 < TILE / 16) load_frags((q + 1) & 1, 16 * (q + 1));
      if (next) convert(t + 1, q);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NI / 2; ++j)
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            sm90::mma_bf16(acc[w][i][2 * j], af[q & 1][i], bfr[q & 1][w][j][0], bfr[q & 1][w][j][1]);
            sm90::mma_bf16(acc[w][i][2 * j + 1], af[q & 1][i], bfr[q & 1][w][j][2], bfr[q & 1][w][j][3]);
          }
    }
  };

  // the ring: stages 0 .. S-2 in flight before the loop; step t issues stage
  // t + S - 1 into the slot stage t - 1 left, converts stage t + 1 and
  // multiplies stage t.  bf16: each thread converts the chunks it copied
  // itself, so it waits for its own copies of stage t + 1 within step t;
  // e4m3: the gather reads every thread's chunks, so each thread waits for
  // its copies of stage t + 2 before the barrier ending step t
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    sm90::cp_async_commit();
  }
  if constexpr (FP8) {
    sm90::cp_async_wait<S - 3>();  // stages 0 and 1
    __syncthreads();
  } else {
    sm90::cp_async_wait<S - 2>();
  }
  if (nk > 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) convert(0, q);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    if (t + S - 1 < nk) issue(t + S - 1);
    sm90::cp_async_commit();
    compute(t);
    if constexpr (IEEE) {  // this K tile's products into the total, then a fresh sum
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[w][i][j][e] += acc[w][i][j][e];
              acc[w][i][j][e] = 0.0f;
            }
    }
    if constexpr (FP8) sm90::cp_async_wait<S - 3>();
    __syncthreads();
  }
  sm90::cp_async_wait<0>();
  if constexpr (IEEE) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[w][i][j][e] = tot[w][i][j][e];
  }

  const O* res = static_cast<const O*>(a.residual);
  O* out = static_cast<O*>(a.out);
  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wr + 16 * i + (lane >> 2) + 8 * h, gn = n0 + wc + 8 * j + 2 * (lane & 3);
        if (gm >= M || gn >= N) continue;
        const size_t o = (size_t)gm * N + gn;
        if (part != nullptr) {
#pragma unroll
          for (int w = 0; w < NW; ++w)
            *reinterpret_cast<float2*>(part + (blockIdx.z * NW + w) * mn + o) =
                make_float2(acc[w][i][j][2 * h], acc[w][i][j][2 * h + 1]);
        } else {
          float z0 = acc[0][i][j][2 * h], z1 = acc[0][i][j][2 * h + 1];
          float u0 = DUAL ? acc[NW - 1][i][j][2 * h] : 0.0f, u1 = DUAL ? acc[NW - 1][i][j][2 * h + 1] : 0.0f;
          if (FP8) {  // (x @ W) * w_scale[n], each weight its own scales
            z0 *= a.w_scale[gn], z1 *= a.w_scale[gn + 1];
            if (DUAL) u0 *= a.w_scale_up[gn], u1 *= a.w_scale_up[gn + 1];
          }
          store2(out + o, apply_epilogue(a.epilogue, z0, u0, a.bias, res, N, gm, gn),
                 apply_epilogue(a.epilogue, z1, u1, a.bias, res, N, gm, gn + 1));
        }
      }
}

// The split-K second pass: the splits' partial sums added in split order,
// then the per-channel scales (e4m3 weights), the epilogue on the whole sum
// and one cast to O.
template <typename O, bool DUAL>
__global__ void splitk_reduce_kernel(const Args a, const float* __restrict__ part, int splits) {
  constexpr int NW = DUAL ? 2 : 1;
  const size_t mn = (size_t)a.M * a.N;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float z = 0.0f, zu = 0.0f;
  for (int s = 0; s < splits; ++s) {
    z += part[(size_t)s * NW * mn + e];
    if (DUAL) zu += part[((size_t)s * NW + 1) * mn + e];
  }
  const int gm = (int)(e / a.N), gn = (int)(e % a.N);
  if (a.w_scale != nullptr) {
    z *= a.w_scale[gn];
    if (DUAL) zu *= a.w_scale_up[gn];
  }
  static_cast<O*>(a.out)[e] =
      from_f32<O>(apply_epilogue(a.epilogue, z, zu, a.bias, static_cast<const O*>(a.residual), a.N, gm, gn));
}

template <typename O, bool DUAL>
cudaError_t launch_reduce(const Args& a, int splits, float* part, cudaStream_t stream) {
  const size_t mn = (size_t)a.M * a.N;
  splitk_reduce_kernel<O, DUAL><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(a, part, splits);
  return cudaGetLastError();
}

template <typename WT, typename O, bool DUAL>
cudaError_t launch_mma(const Args& a, int splits, int kps, float* part, cudaStream_t stream) {
  using C = Cfg<WT, DUAL>;
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(dip_mma_kernel<WT, O, DUAL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((a.N + C::BN - 1) / C::BN, (a.M + C::BM - 1) / C::BM, splits);
  dip_mma_kernel<WT, O, DUAL><<<grid, MMA_THREADS, C::SMEM, stream>>>(a, kps, splits > 1 ? part : nullptr);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess || splits == 1 ? err : launch_reduce<O, DUAL>(a, splits, part, stream);
}

// -------------------------------------------- prefill: wgmma mainloop -------
// Two warpgroups, each owning 64 rows of the block's 128 and all of its 128
// columns (swiglu: 64 gate columns then the 64 up columns of the same
// output columns, so one m64n128k16 product serves both weights).
constexpr int WG_ROWS = 64, WG_COLS = 128;
constexpr int RASTER = 8;  // row tiles per rasterization group

template <typename WT, bool DUAL>
struct WgCfg {
  static constexpr bool FP8 = sizeof(WT) == 1;
  static constexpr int THREADS = 256;
  static constexpr int BM = 2 * WG_ROWS;
  static constexpr int BN = DUAL ? WG_COLS / 2 : WG_COLS;  // output columns (per weight)
  // raw P row stride (elements).  bf16: a multiple of 32 past BN keeps the
  // gather conflict-free.  e4m3: one 128-byte row holds all 128 operand
  // columns (swiglu: the gate's 64 then the up weight's 64), so the 32 lanes'
  // 4-column words fall on 32 banks with no padding
  static constexpr int RS = FP8 ? WG_COLS : BN + 32;
  static constexpr int STAGES = 4;    // ring slots of raw x and P
  static constexpr int B_BUFS = 3;    // de-sheared operand buffers: one being read while two are filled
  static constexpr int X_BYTES = BM * TILE * 2;                                     // x tile, K-major, 128B swizzle
  static constexpr int P_BYTES = FP8 ? TILE * RS : (DUAL ? 2 : 1) * TILE * RS * 2;  // raw P tile(s), row-major
  static constexpr int RAW = X_BYTES + P_BYTES;                                     // one ring slot
  static constexpr int OP = WG_COLS * TILE * 2;                                     // B, K-major, 128B swizzle
  // + the gain ring (64 f32 a stage) + alignment slack
  static constexpr size_t SMEM = (size_t)STAGES * RAW + B_BUFS * OP + STAGES * TILE * 4 + 1024;
  static constexpr int X_CHUNKS = WG_ROWS * TILE / 8 / 128;      // 4, of the thread's own warpgroup's rows
  static constexpr int P_CHUNKS = TILE * WG_COLS * (int)sizeof(WT) / 16 / THREADS;  // 16-byte raw P chunks per thread
  static constexpr int B_CHUNKS = WG_COLS * TILE / 8 / THREADS;
  static_assert(RAW % 1024 == 0 && OP % 1024 == 0, "wgmma tiles must stay 1024-byte aligned");
};

template <typename WT, typename O, bool DUAL>
__global__ void __launch_bounds__(WgCfg<WT, DUAL>::THREADS) dip_wgmma_kernel(const Args a, const int kps,
                                                                             float* __restrict__ part) {
  using C = WgCfg<WT, DUAL>;
  constexpr bool FP8 = C::FP8, IEEE = std::is_same<O, float>::value;
  constexpr int S = C::STAGES, T = C::THREADS, BN = C::BN, RS = C::RS;
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* raw = smem;                                         // [S][RAW]: x (swizzled), then P
  unsigned char* op = raw + S * C::RAW;                              // [B_BUFS][OP]: B
  float* gain_ring = reinterpret_cast<float*>(op + C::B_BUFS * C::OP);  // [S][64]: gain of each stage
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3, wt = tid & 127;
  const int M = a.M, N = a.N, K = a.K;
  // blockIdx.x walks groups of RASTER row tiles column tile by column tile,
  // so the blocks in flight share their x and weight tiles through L2
  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + C::BM - 1) / C::BM;
  const int group = blockIdx.x / (RASTER * n_tiles), first_m = group * RASTER;
  const int in_group = blockIdx.x % (RASTER * n_tiles), rows = min(m_tiles - first_m, RASTER);
  const int n0 = (in_group / rows) * BN, m0 = (first_m + in_group % rows) * C::BM;
  const int kt0 = blockIdx.z * kps, nk = min(K / TILE - kt0, kps);
  const bf16* x = static_cast<const bf16*>(a.x);
  const unsigned char* w_src[2] = {static_cast<const unsigned char*>(a.p),
                                   static_cast<const unsigned char*>(a.p_up)};
  const bool prologue = a.inv_rms != nullptr, deshear = a.deshear != 0;

  // x chunk j of this thread: row 64 wg + (wt + 128 j) / 8 (a warpgroup
  // copies only the rows its own products read), K chunk wt % 8
  const int xkc = wt & 7;
  float inv[C::X_CHUNKS];
#pragma unroll
  for (int j = 0; j < C::X_CHUNKS; ++j) {
    const int gm = m0 + wg * WG_ROWS + ((wt + 128 * j) >> 3);
    inv[j] = prologue && gm < M ? a.inv_rms[gm] : 0.0f;
  }

  auto issue = [&](int t) {
    unsigned char* slot = raw + (t % S) * C::RAW;
    const int k0 = (kt0 + t) * TILE;
#pragma unroll
    for (int j = 0; j < C::X_CHUNKS; ++j) {
      const int r = wg * WG_ROWS + ((wt + 128 * j) >> 3), gm = m0 + r;
      sm90::cp_async16(slot + sm90::sw128_offset(r, 8 * xkc), x + (size_t)min(gm, M - 1) * K + k0 + 8 * xkc,
                       gm < M);
    }
    if (prologue && tid < TILE / 4) sm90::cp_async16(gain_ring + (t % S) * TILE + 4 * tid, a.gain + k0 + 4 * tid, true);
#pragma unroll
    for (int j = 0; j < C::P_CHUNKS; ++j) {
      if constexpr (FP8) {
        // chunk j: row s, bytes cb .. cb + 15 of its 128 (swiglu: the gate's
        // columns below byte 64, the up weight's from there)
        const int v = tid + T * j, s = v >> 3, cb = (v & 7) * 16;
        const int w = DUAL ? cb / BN : 0, gn = n0 + (DUAL ? cb % BN : cb);
        sm90::cp_async16(slot + C::X_BYTES + s * RS + cb, w_src[w] + (size_t)(k0 + s) * N + min(gn, N - 16),
                         gn < N);
      } else {
        // chunk j: weight j / (P_CHUNKS / NW), row s, columns c .. c + 7
        constexpr int PER_W = DUAL ? C::P_CHUNKS / 2 : C::P_CHUNKS, CPR = BN / 8;
        const int w = j / PER_W, v = tid + T * (j % PER_W), s = v / CPR, c = (v % CPR) * 8, gn = n0 + c;
        sm90::cp_async16(slot + C::X_BYTES + (w * TILE * RS + s * RS + c) * 2,
                         w_src[w] + ((size_t)(k0 + s) * N + min(gn, N - 8)) * 2, gn < N);
      }
    }
  };

  // Stage t: the rmsnorm prologue on this thread's x chunks, in place in
  // the stage (gain from the stage's slice of the gain ring); P -> B buffer
  // t % B_BUFS: row n (weight w = n / BN, column nl = n % BN), depth k holds
  // P[(k - nl) mod 64][nl] (ws: P[k][nl]), upcast for e4m3.  Each thread
  // gathers whole 16-byte chunks of B.
  auto convert = [&](int t) {
    unsigned char* slot = raw + (t % S) * C::RAW;
    if (prologue) {
      const float4 g0 = *reinterpret_cast<const float4*>(gain_ring + (t % S) * TILE + 8 * xkc);
      const float4 g1 = *reinterpret_cast<const float4*>(gain_ring + (t % S) * TILE + 8 * xkc + 4);
      const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int j = 0; j < C::X_CHUNKS; ++j) {
        uint4* chunk = reinterpret_cast<uint4*>(slot + sm90::sw128_offset(wg * WG_ROWS + ((wt + 128 * j) >> 3), 8 * xkc));
        uint4 v = *chunk;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(e[i]);
          e[i] = __floats2bfloat162_rn((f.x * inv[j]) * gs[2 * i], (f.y * inv[j]) * gs[2 * i + 1]);
        }
        *chunk = v;
      }
    }
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(slot + C::X_BYTES);
    unsigned char* dst = op + (t % C::B_BUFS) * C::OP;
    if constexpr (FP8) {
      // B rows n .. n + 3 (n = 4 lane), depth chunk kc = warp, from 32-bit
      // words of P, each holding columns n .. n + 3 of one row: with
      // deshear, B[n + j][8 kc + e] is byte j of row 8 kc + e - nl - j, so
      // eleven words give all four 16-byte chunks (the 32 lanes' words
      // fall on 32 banks); each byte pair is upcast on the way
      const int n = 4 * (tid & 31), kc = tid >> 5, nl = n % BN;
      const uint32_t* col = pw + n / 4;
      uint32_t wd[11];
      if (deshear) {
#pragma unroll
        for (int i = 0; i < 11; ++i) wd[i] = col[((8 * kc + i - 3 - nl) & (TILE - 1)) * (RS / 4)];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) wd[i + 3] = col[(8 * kc + i) * (RS / 4)];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t o[4];
        const int sh = deshear ? 3 - j : 3;  // element e of column j is in word e + sh
#pragma unroll
        for (int p = 0; p < 4; ++p)
          o[p] = e4m3x2_to_bf16x2(__byte_perm(wd[2 * p + sh], wd[2 * p + 1 + sh], ((4 + j) << 12) | (j << 4)));
        *reinterpret_cast<uint4*>(dst + sm90::sw128_offset(n + j, 8 * kc)) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      // B rows n and n + 1 (n even) from 32-bit words of P, each holding
      // columns nl and nl + 1 of one row: with deshear, B[n][k] is the low
      // half of row k - nl and B[n + 1][k] the high half of row k - nl - 1, so
      // nine words give both 16-byte chunks (RS a multiple of 32 keeps the
      // 32 lanes' words on 32 banks)
#pragma unroll
      for (int j = 0; j < C::B_CHUNKS / 2; ++j) {
        const int u = tid + T * j, n = ((u >> 8) * 32 + (u & 31)) * 2, kc = (u >> 5) & 7;
        const int w = DUAL ? n / BN : 0, nl = DUAL ? n % BN : n;
        const uint32_t* col = pw + (w * TILE * RS + nl) / 2;
        uint32_t lo[4], hi[4];
        if (deshear) {
          uint32_t wd[9];
#pragma unroll
          for (int e = 0; e < 9; ++e) wd[e] = col[((8 * kc + e - 1 - nl) & (TILE - 1)) * (RS / 2)];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = __byte_perm(wd[2 * i + 1], wd[2 * i + 2], 0x5410);
            hi[i] = __byte_perm(wd[2 * i], wd[2 * i + 1], 0x7632);
          }
        } else {
          uint32_t wd[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) wd[e] = col[(8 * kc + e) * (RS / 2)];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = __byte_perm(wd[2 * i], wd[2 * i + 1], 0x5410);
            hi[i] = __byte_perm(wd[2 * i], wd[2 * i + 1], 0x7632);
          }
        }
        *reinterpret_cast<uint4*>(dst + sm90::sw128_offset(n, 8 * kc)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(dst + sm90::sw128_offset(n + 1, 8 * kc)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  };

  float acc[64], tot[IEEE ? 64 : 1] = {};  // IEEE: the running total of every FLUSH K tiles' sums
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // The ring: stages 0 .. 2 in flight before the loop, stage 0 converted.
  // Step t starts the products of stage t and, while they run, converts
  // stage t + 1 (every thread's copies of it landed before the last
  // barrier); it then waits for its warpgroup's products of step t - 1,
  // issues stage t + 3 into the slot stage t - 1 left (the x rows a
  // warpgroup overwrites are its own), and waits for its own copies of
  // stage t + 2 before the barrier.  The products of step t stay in flight
  // across the barrier, so the tensor cores do not drain between steps.
  // (ptxas of CUDA 12.8 crashes on this kernel if the copies are issued
  // between the commit and the wait, or if the step body is duplicated;
  // keep this order.)
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<S - 3>();  // stages 0 and 1
  sm90::fence_proxy_async();
  __syncthreads();
  if (nk > 0) convert(0);
  sm90::fence_proxy_async();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const unsigned char* xa = raw + (t % S) * C::RAW + wg * WG_ROWS * 128;
    const uint64_t da = sm90::sw128_desc(xa);
    const uint64_t db = sm90::sw128_desc(op + (t % C::B_BUFS) * C::OP);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) sm90::wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    sm90::wgmma_commit();
    if (t + 1 < nk) convert(t + 1);
    if constexpr (IEEE) {
      if (t % FLUSH == FLUSH - 1) {  // the products of steps t - 3 .. t into the total, then a fresh sum
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          tot[i] += acc[i];
          acc[i] = 0.0f;
        }
      } else {
        sm90::wgmma_wait<1>();
      }
    } else {
      sm90::wgmma_wait<1>();  // this warpgroup's products of step t - 1
    }
    sm90::fence_regs(acc);
    if (t + S - 1 < nk) issue(t + S - 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // this thread's copies of stage t + 2
    sm90::fence_proxy_async();
    __syncthreads();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::cp_async_wait<0>();
  if constexpr (IEEE) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] + acc[i];
  }

  // accumulator 4 j + e: row 16 warp + lane / 4 (+ 8 for e >= 2), column
  // 8 j + 2 (lane % 4) + (e & 1) of the warpgroup's 64 x 128
  const O* res = static_cast<const O*>(a.residual);
  O* out = static_cast<O*>(a.out);
  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wg * WG_ROWS + 16 * warp + (lane >> 2) + 8 * h, gn = n0 + 8 * j + 2 * (lane & 3);
      if (gm >= M || gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      float z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
      float u0 = DUAL ? acc[4 * (j + BN / 8) + 2 * h] : 0.0f;
      float u1 = DUAL ? acc[4 * (j + BN / 8) + 2 * h + 1] : 0.0f;
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + blockIdx.z * (DUAL ? 2 : 1) * mn + o) = make_float2(z0, z1);
        if (DUAL) *reinterpret_cast<float2*>(part + (blockIdx.z * 2 + 1) * mn + o) = make_float2(u0, u1);
      } else {
        if (FP8) {  // (x @ W) * w_scale[n], each weight its own scales
          z0 *= a.w_scale[gn], z1 *= a.w_scale[gn + 1];
          if (DUAL) u0 *= a.w_scale_up[gn], u1 *= a.w_scale_up[gn + 1];
        }
        store2(out + o, apply_epilogue(a.epilogue, z0, u0, a.bias, res, N, gm, gn),
               apply_epilogue(a.epilogue, z1, u1, a.bias, res, N, gm, gn + 1));
      }
    }
}

template <typename WT, typename O, bool DUAL>
cudaError_t launch_wgmma(const Args& a, int splits, int kps, float* part, cudaStream_t stream) {
  using C = WgCfg<WT, DUAL>;
  static bool attr_set = false;  // the shared-memory opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(dip_wgmma_kernel<WT, O, DUAL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(((a.N + C::BN - 1) / C::BN) * ((a.M + C::BM - 1) / C::BM), 1, splits);
  dip_wgmma_kernel<WT, O, DUAL><<<grid, C::THREADS, C::SMEM, stream>>>(a, kps, splits > 1 ? part : nullptr);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess || splits == 1 ? err : launch_reduce<O, DUAL>(a, splits, part, stream);
}

// The plan's (bm, bn) picks the kernel: bm = 32 the mma.sync decode tile
// (bn = 64; 128 for a single e4m3 weight), bm = 128 the wgmma tile of two
// warpgroups (bn = 128, or 64 per weight for swiglu).  WT: the weight
// element, bf16 or an e4m3 code; O: the output, bf16 or (e4m3) f32.
template <typename WT, typename O>
cudaError_t launch_tc(const Args& a, int bm, int bn, int splits, int kps, float* part, cudaStream_t s) {
  const int k_tiles = a.K / TILE;
  if (splits < 1 || kps < 1 || (long long)splits * kps < k_tiles || (long long)(splits - 1) * kps >= k_tiles ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const bool dual = a.epilogue == EPI_SWIGLU;
  if (bn != (bm == 32 ? (sizeof(WT) == 1 && !dual ? 128 : 64) : (dual ? 64 : 128))) return cudaErrorInvalidValue;
  if (bm == 32)
    return dual ? launch_mma<WT, O, true>(a, splits, kps, part, s) : launch_mma<WT, O, false>(a, splits, kps, part, s);
  if (bm == 128)
    return dual ? launch_wgmma<WT, O, true>(a, splits, kps, part, s)
                : launch_wgmma<WT, O, false>(a, splits, kps, part, s);
  return cudaErrorInvalidValue;
}

// ------------------------------ int8 x int8: the int8 route of dip_matmul_q ---
// The codes of x (one int8 per element, row-major, from dip_matmul_q.cu's
// quantizing pass) times the int8 permutated weight(s), exact int32 sums,
// then z = float(acc) * x_scale[m] * w_scale[n] (in that order), the f32
// epilogue and one cast to O (x's dtype, f32 or bf16).  Both mainloops keep
// the e4m3 tiles' plan and byte layout (a raw weight row of 128 bytes: 128
// columns, or the gate's 64 then the up weight's 64), but 8-bit products
// take both operands K-major, so the conversion pass transposes the raw
// tile as it de-shears it: thread (lane, warp) builds the 16-byte chunk kc =
// warp % 4 (k = 16 kc .. 16 kc + 15) of operand columns n, n + 1 (n = 4 lane
// + 2 (warp / 4)) from 17 32-bit words of the raw rows, each word holding
// columns 4 lane .. 4 lane + 3 of one row: W[k][nl + j] is byte j of the
// word of row (k - nl - j) mod 64, and three byte permutes put four such
// bytes into one word of the chunk (the 32 lanes' words fall on 32 banks).

struct S8Args {
  const int8_t* x;          // (M, K) activation codes
  const int8_t* q;          // (K, N) permutated int8 weight
  const int8_t* q_up;       // (K, N) second weight for swiglu, else null
  const float* x_scale;     // (M,) per-row activation scales
  const float* w_scale;     // (N,) per-output-channel scales
  const float* w_scale_up;  // (N,) the up weight's, swiglu only
  const float* bias;        // (N,) f32, bias epilogues only
  const void* residual;     // (M, N) O, residual epilogue only
  void* out;                // (M, N) O
  int M, N, K;
  int epilogue;
};

// the two operand chunks of columns cb, cb + 1 (cb = 4 lane + 2 half) at k
// = 16 kc .. 16 kc + 15, from the raw 128-byte rows at `rows`; store(c, v)
// writes chunk v of column cb + c
template <typename Store>
__device__ __forceinline__ void gather_s8(const unsigned char* rows, int lane, int kc, int half, Store store) {
  const uint32_t* col = reinterpret_cast<const uint32_t*>(rows) + lane;
  const int j0 = 2 * half, nl = (4 * lane + j0) & (TILE - 1);  // the first column's rotation
  uint32_t wd[17];  // wd[i]: the word of row 16 kc - nl - 1 + i
#pragma unroll
  for (int i = 0; i < 17; ++i) wd[i] = col[((16 * kc - nl - 1 + i) & (TILE - 1)) * 32];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const uint32_t b = j0 + d;  // byte of the column in its word
    const uint32_t pair = b | ((b + 4) << 4);
    uint32_t o[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // k = 16 kc + 4 p + e is byte b of wd[4 p + e + 1 - d]
      const uint32_t lo = __byte_perm(wd[4 * p + 1 - d], wd[4 * p + 2 - d], pair);
      const uint32_t hi = __byte_perm(wd[4 * p + 3 - d], wd[4 * p + 4 - d], pair);
      o[p] = __byte_perm(lo, hi, 0x5410);
    }
    store(d, make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// z = float(acc) * x_scale[m] * w_scale[n] for both weights, the epilogue,
// and two outputs at (gm, gn), (gm, gn + 1)
template <typename O, bool DUAL>
__device__ __forceinline__ void s8_flush2(const S8Args& a, int gm, int gn, int z0, int z1, int u0, int u1) {
  const float xs = a.x_scale[gm];
  const float f0 = (float)z0 * xs * a.w_scale[gn], f1 = (float)z1 * xs * a.w_scale[gn + 1];
  const float g0 = DUAL ? (float)u0 * xs * a.w_scale_up[gn] : 0.0f;
  const float g1 = DUAL ? (float)u1 * xs * a.w_scale_up[gn + 1] : 0.0f;
  const O* res = static_cast<const O*>(a.residual);
  store2(static_cast<O*>(a.out) + (size_t)gm * a.N + gn, apply_epilogue(a.epilogue, f0, g0, a.bias, res, a.N, gm, gn),
         apply_epilogue(a.epilogue, f1, g1, a.bias, res, a.N, gm, gn + 1));
}

// Decode (M <= 32): the e4m3 decode tile's shape (32 x 128 for one weight,
// 32 x 64 a weight for swiglu; eight warps in 2 x 4), mma.sync m16n8k32 fed
// by ldmatrix, x straight from its ring slot (64-byte rows padded to 80,
// which spreads ldmatrix's eight rows over the banks), the weight through
// the gather into a K-major operand of 80-byte rows (two buffers).
constexpr int S8_ROW = TILE + 16;  // bytes of an x row / operand column in shared memory

template <bool DUAL>
struct S8MmaCfg {
  static constexpr int NW = DUAL ? 2 : 1, NI = DUAL ? 2 : 4;  // n8 tiles per warp and weight
  static constexpr int BM = 32, BN = WARPS_N * 8 * NI;         // block rows; columns per weight
  static constexpr int STAGES = 5;
  static constexpr int X_BYTES = BM * S8_ROW;
  static constexpr int RAW = X_BYTES + TILE * 128;  // one ring slot: x, then 64 raw weight rows of 128 bytes
  static constexpr int OP = 128 * S8_ROW;           // one operand buffer: 128 columns, K-major
  static constexpr size_t SMEM = (size_t)STAGES * RAW + 2 * OP;
  static_assert(NW * BN == 128, "one 128-byte raw row");
};

template <typename O, bool DUAL>
__global__ void __launch_bounds__(MMA_THREADS) dip_mma_s8_kernel(const S8Args a, const int kps,
                                                                 int* __restrict__ part) {
  using C = S8MmaCfg<DUAL>;
  constexpr int S = C::STAGES, NW = C::NW, NI = C::NI, BN = C::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* raw = smem;                 // [S][RAW]
  unsigned char* op = smem + S * C::RAW;     // [2][OP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::BM;
  const int kt0 = blockIdx.z * kps, nk = min(a.K / TILE - kt0, kps);
  const int M = a.M, N = a.N, K = a.K;
  const int8_t* w_src[2] = {a.q, a.q_up};
  auto x_slot = [&](int t) { return raw + (t % S) * C::RAW; };
  auto w_slot = [&](int t) { return raw + (t % S) * C::RAW + C::X_BYTES; };

  // x: thread tid < 128 copies row tid / 4, bytes 16 (tid % 4) ..; the raw
  // weight rows: chunk v = tid + 256 j is row v / 8, bytes 16 (v % 8) ..
  // (for swiglu the gate's columns below byte 64, the up weight's from there)
  auto issue = [&](int t) {
    const int k0 = (kt0 + t) * TILE;
    if (tid < C::BM * 4) {
      const int r = tid >> 2, c = (tid & 3) * 16, gm = m0 + r;
      sm90::cp_async16(x_slot(t) + r * S8_ROW + c, a.x + (size_t)min(gm, M - 1) * K + k0 + c, gm < M);
    }
#pragma unroll
    for (int j = 0; j < TILE * 8 / MMA_THREADS; ++j) {
      const int v = tid + MMA_THREADS * j, s = v >> 3, cb = (v & 7) * 16, gn = n0 + cb % BN;
      sm90::cp_async16(w_slot(t) + s * 128 + cb, w_src[cb / BN] + (size_t)(k0 + s) * N + min(gn, N - 16), gn < N);
    }
  };
  auto convert = [&](int t) {
    unsigned char* dst = op + (t & 1) * C::OP;
    gather_s8(w_slot(t), lane, warp & 3, warp >> 2, [&](int d, uint4 v) {
      *reinterpret_cast<uint4*>(dst + (4 * lane + 2 * (warp >> 2) + d) * S8_ROW + 16 * (warp & 3)) = v;
    });
  };

  int acc[NW][NI][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[w][j][e] = 0;
  const int wr = (warp / WARPS_N) * 16, wc = (warp % WARPS_N) * 8 * NI;

  // step t: the products of stage t (two 32-deep slices), with stage t + 1
  // gathered between them
  auto compute = [&](int t) {
    const unsigned char* xs = x_slot(t);
    const unsigned char* ws = op + (t & 1) * C::OP;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4], bfr[NW][NI / 2][4];
      sm90::ldmatrix_x4(af, xs + (wr + (lane & 15)) * S8_ROW + 32 * kk + (lane >> 4) * 16);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NI / 2; ++j)
          sm90::ldmatrix_x4(bfr[w][j], ws + (w * BN + wc + 16 * j + (lane & 7) + (lane >> 4) * 8) * S8_ROW + 32 * kk +
                                           ((lane >> 3) & 1) * 16);
      if (kk == 0 && t + 1 < nk) convert(t + 1);
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          sm90::mma_s8(acc[w][2 * j], af, bfr[w][j][0], bfr[w][j][1]);
          sm90::mma_s8(acc[w][2 * j + 1], af, bfr[w][j][2], bfr[w][j][3]);
        }
    }
  };

  // the ring, as the e4m3 decode tile runs it: the gather reads every
  // thread's copies, so each thread waits for its copies of stage t + 2
  // before the barrier ending step t
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<S - 3>();  // stages 0 and 1
  __syncthreads();
  if (nk > 0) convert(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    if (t + S - 1 < nk) issue(t + S - 1);
    sm90::cp_async_commit();
    compute(t);
    sm90::cp_async_wait<S - 3>();
    __syncthreads();
  }
  sm90::cp_async_wait<0>();

  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wr + (lane >> 2) + 8 * h, gn = n0 + wc + 8 * j + 2 * (lane & 3);
      if (gm >= M || gn >= N) continue;
      if (part != nullptr) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
          *reinterpret_cast<int2*>(part + (blockIdx.z * NW + w) * mn + (size_t)gm * N + gn) =
              make_int2(acc[w][j][2 * h], acc[w][j][2 * h + 1]);
      } else {
        s8_flush2<O, DUAL>(a, gm, gn, acc[0][j][2 * h], acc[0][j][2 * h + 1], acc[NW - 1][j][2 * h],
                           acc[NW - 1][j][2 * h + 1]);
      }
    }
}

// Prefill (M > 32): the wgmma tile of the bf16 and e4m3 routes (128 x 128,
// two warpgroups of 64 rows; swiglu 64 columns a weight), m64n128k32 s8
// from K-major shared memory with the 64-byte swizzle: x's codes land
// swizzled by their cp.async copies, ready for wgmma, and the gather builds
// the weight operand (three buffers, one step's products in flight across
// the barrier, the loop order of dip_wgmma_kernel).
template <bool DUAL>
struct S8WgCfg {
  static constexpr int THREADS = 256;
  static constexpr int BM = 2 * WG_ROWS;
  static constexpr int BN = DUAL ? WG_COLS / 2 : WG_COLS;  // output columns (per weight)
  static constexpr int STAGES = 4;
  static constexpr int B_BUFS = 3;
  static constexpr int X_BYTES = BM * TILE;    // codes, K-major, 64-byte swizzle
  static constexpr int RAW = X_BYTES + TILE * 128;
  static constexpr int OP = WG_COLS * TILE;    // B, K-major, 64-byte swizzle
  static constexpr size_t SMEM = (size_t)STAGES * RAW + B_BUFS * OP + 1024;
  static_assert(RAW % 1024 == 0 && OP % 1024 == 0, "wgmma tiles must stay 1024-byte aligned");
};

template <typename O, bool DUAL>
__global__ void __launch_bounds__(S8WgCfg<DUAL>::THREADS) dip_wgmma_s8_kernel(const S8Args a, const int kps,
                                                                              int* __restrict__ part) {
  using C = S8WgCfg<DUAL>;
  constexpr int S = C::STAGES, T = C::THREADS, BN = C::BN;
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* raw = smem;                 // [S][RAW]: x (swizzled), then the raw weight rows
  unsigned char* op = raw + S * C::RAW;      // [B_BUFS][OP]: B
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3, wt = tid & 127;
  const int M = a.M, N = a.N, K = a.K;
  const int n_tiles = (N + BN - 1) / BN, m_tiles = (M + C::BM - 1) / C::BM;
  const int group = blockIdx.x / (RASTER * n_tiles), first_m = group * RASTER;
  const int in_group = blockIdx.x % (RASTER * n_tiles), rows = min(m_tiles - first_m, RASTER);
  const int n0 = (in_group / rows) * BN, m0 = (first_m + in_group % rows) * C::BM;
  const int kt0 = blockIdx.z * kps, nk = min(K / TILE - kt0, kps);
  const int8_t* w_src[2] = {a.q, a.q_up};

  // x chunk j of this thread: row 64 wg + (wt + 128 j) / 4 (a warpgroup
  // copies only the rows its own products read), bytes 16 (wt % 4) ..
  auto issue = [&](int t) {
    unsigned char* slot = raw + (t % S) * C::RAW;
    const int k0 = (kt0 + t) * TILE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = wg * WG_ROWS + ((wt + 128 * j) >> 2), gm = m0 + r, kb = (wt & 3) * 16;
      sm90::cp_async16(slot + sm90::sw64_offset(r, kb), a.x + (size_t)min(gm, M - 1) * K + k0 + kb, gm < M);
    }
#pragma unroll
    for (int j = 0; j < TILE * 8 / T; ++j) {
      const int v = tid + T * j, s = v >> 3, cb = (v & 7) * 16;
      const int w = DUAL ? cb / BN : 0, gn = n0 + (DUAL ? cb % BN : cb);
      sm90::cp_async16(slot + C::X_BYTES + s * 128 + cb, w_src[w] + (size_t)(k0 + s) * N + min(gn, N - 16), gn < N);
    }
  };
  auto convert = [&](int t) {
    unsigned char* dst = op + (t % C::B_BUFS) * C::OP;
    const int kc = (tid >> 5) & 3, half = tid >> 7;
    gather_s8(raw + (t % S) * C::RAW + C::X_BYTES, lane, kc, half, [&](int d, uint4 v) {
      *reinterpret_cast<uint4*>(dst + sm90::sw64_offset(4 * lane + 2 * half + d, 16 * kc)) = v;
    });
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  // (ptxas of CUDA 12.8 crashes on dip_wgmma_kernel if the copies are issued
  // between the commit and the wait, or if the step body is duplicated;
  // this loop keeps its order)
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<S - 3>();  // stages 0 and 1
  sm90::fence_proxy_async();
  __syncthreads();
  if (nk > 0) convert(0);
  sm90::fence_proxy_async();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const uint64_t da = sm90::sw64_desc(raw + (t % S) * C::RAW + wg * WG_ROWS * TILE);
    const uint64_t db = sm90::sw64_desc(op + (t % C::B_BUFS) * C::OP);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 32; ++kk) sm90::wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
    sm90::wgmma_commit();
    if (t + 1 < nk) convert(t + 1);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    if (t + S - 1 < nk) issue(t + S - 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    sm90::fence_proxy_async();
    __syncthreads();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::cp_async_wait<0>();

  const size_t mn = (size_t)M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wg * WG_ROWS + 16 * warp + (lane >> 2) + 8 * h, gn = n0 + 8 * j + 2 * (lane & 3);
      if (gm >= M || gn >= N) continue;
      const int z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
      const int u0 = DUAL ? acc[4 * (j + BN / 8) + 2 * h] : 0, u1 = DUAL ? acc[4 * (j + BN / 8) + 2 * h + 1] : 0;
      if (part != nullptr) {
        const size_t o = (size_t)gm * N + gn;
        *reinterpret_cast<int2*>(part + blockIdx.z * (DUAL ? 2 : 1) * mn + o) = make_int2(z0, z1);
        if (DUAL) *reinterpret_cast<int2*>(part + (blockIdx.z * 2 + 1) * mn + o) = make_int2(u0, u1);
      } else {
        s8_flush2<O, DUAL>(a, gm, gn, z0, z1, u0, u1);
      }
    }
}

// The int8 split-K second pass: the splits' int32 partial sums added in
// split order (exact), then the scales, the epilogue and one cast.
template <typename O, bool DUAL>
__global__ void splitk_reduce_s8_kernel(const S8Args a, const int* __restrict__ part, int splits) {
  constexpr int NW = DUAL ? 2 : 1;
  const size_t mn = (size_t)a.M * a.N;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  int z = 0, zu = 0;
  for (int s = 0; s < splits; ++s) {
    z += part[(size_t)s * NW * mn + e];
    if (DUAL) zu += part[((size_t)s * NW + 1) * mn + e];
  }
  const int gm = (int)(e / a.N), gn = (int)(e % a.N);
  const float xs = a.x_scale[gm];
  const float f = (float)z * xs * a.w_scale[gn], g = DUAL ? (float)zu * xs * a.w_scale_up[gn] : 0.0f;
  static_cast<O*>(a.out)[e] =
      from_f32<O>(apply_epilogue(a.epilogue, f, g, a.bias, static_cast<const O*>(a.residual), a.N, gm, gn));
}

template <typename O, bool DUAL>
cudaError_t launch_s8(const S8Args& a, int bm, int splits, int kps, int* part, cudaStream_t stream) {
  static bool attr_set[2] = {false, false};  // the shared-memory opt-in, once per kernel
  const bool prefill = bm == 128;
  const void* kernel = prefill ? (const void*)dip_wgmma_s8_kernel<O, DUAL> : (const void*)dip_mma_s8_kernel<O, DUAL>;
  const size_t smem = prefill ? S8WgCfg<DUAL>::SMEM : S8MmaCfg<DUAL>::SMEM;
  if (!attr_set[prefill]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set[prefill] = true;
  }
  int* p = splits > 1 ? part : nullptr;
  if (prefill) {
    using C = S8WgCfg<DUAL>;
    const dim3 grid(((a.N + C::BN - 1) / C::BN) * ((a.M + C::BM - 1) / C::BM), 1, splits);
    dip_wgmma_s8_kernel<O, DUAL><<<grid, C::THREADS, smem, stream>>>(a, kps, p);
  } else {
    using C = S8MmaCfg<DUAL>;
    const dim3 grid((a.N + C::BN - 1) / C::BN, (a.M + C::BM - 1) / C::BM, splits);
    dip_mma_s8_kernel<O, DUAL><<<grid, MMA_THREADS, smem, stream>>>(a, kps, p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)a.M * a.N;
  splitk_reduce_s8_kernel<O, DUAL><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(a, part, splits);
  return cudaGetLastError();
}

// The plan's (bm, bn) as for e4m3 weights: bm = 32 the decode tile (bn =
// 128, 64 a weight for swiglu), bm = 128 the wgmma tile (bn = 128, 64 a
// weight for swiglu).
template <typename O>
cudaError_t launch_int8q(const S8Args& a, int bm, int bn, int splits, int kps, int* part, cudaStream_t s) {
  const int k_tiles = a.K / TILE;
  if (splits < 1 || kps < 1 || (long long)splits * kps < k_tiles || (long long)(splits - 1) * kps >= k_tiles ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const bool dual = a.epilogue == EPI_SWIGLU;
  if ((bm != 32 && bm != 128) || bn != (dual ? 64 : 128)) return cudaErrorInvalidValue;
  return dual ? launch_s8<O, true>(a, bm, splits, kps, part, s) : launch_s8<O, false>(a, bm, splits, kps, part, s);
}

bool bad_shape(int M, int N, int K, int epilogue) {
  return M <= 0 || N <= 0 || K <= 0 || N % TILE || K % TILE || epilogue < EPI_NONE || epilogue > EPI_RESIDUAL;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (out: int32 without an
// epilogue, float32 with one), 3 = bfloat16 with a float32 out (the f32
// sums unrounded: kernels/dip_matmul_sharded.py's row-parallel partials).  bm, bn, splits, kps (K tiles per split) and
// workspace (f32, splits x (2 for swiglu, else 1) x M x N, used when splits
// > 1) are the bf16 plan (kernels/dip_matmul.py::matmul_plan); the other
// dtypes ignore them.  Returns a cudaError_t (0 on success).
extern "C" int dip_matmul_launch(int dtype, const void* x, const void* p, const void* p_up,
                                 const float* inv_rms, const float* gain, const float* bias,
                                 const void* residual, void* out, int M, int N, int K,
                                 int epilogue, int deshear, int bm, int bn, int splits, int kps,
                                 void* workspace, void* stream) {
  if (bad_shape(M, N, K, epilogue)) return (int)cudaErrorInvalidValue;
  const Args a{x, p, p_up, inv_rms, gain, bias, residual, out, M, N, K, epilogue, deshear, nullptr, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_any<float, float>(a, s);
  if (dtype == 1) return (int)launch_tc<bf16, bf16>(a, bm, bn, splits, kps, static_cast<float*>(workspace), s);
  if (dtype == 3) return (int)launch_tc<bf16, float>(a, bm, bn, splits, kps, static_cast<float*>(workspace), s);
  if (dtype == 2)
    return (int)(epilogue == EPI_NONE ? launch<int8_t, int, false>(a, s) : launch_any<int8_t, float>(a, s));
  return (int)cudaErrorInvalidValue;
}

// The fp8 route of kernels/dip_matmul_q.py: bf16 x (for f32 x, dip_matmul_q.cu's
// cast pass writes it), e4m3 permutated weights q (and q_up for swiglu) with
// f32 per-output-channel scales; out_dtype 0 = float32, 1 = bfloat16 (also
// the residual's); epilogue((prologue(x) @ deshear(upcast(q))) * w_scale[n])
// on the bf16 mainloops above, with the same plan arguments.  Returns a
// cudaError_t.
extern "C" int dip_matmul_fp8_launch(int out_dtype, const void* x, const void* q, const void* q_up,
                                     const float* w_scale, const float* w_scale_up, const float* inv_rms,
                                     const float* gain, const float* bias, const void* residual, void* out, int M,
                                     int N, int K, int epilogue, int bm, int bn, int splits, int kps,
                                     void* workspace, void* stream) {
  if (bad_shape(M, N, K, epilogue) || w_scale == nullptr || (epilogue == EPI_SWIGLU && w_scale_up == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, q, q_up, inv_rms, gain, bias, residual, out, M, N, K, epilogue, 1, w_scale, w_scale_up};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(workspace);
  if (out_dtype == 0) return (int)launch_tc<fp8, float>(a, bm, bn, splits, kps, part, s);
  if (out_dtype == 1) return (int)launch_tc<fp8, bf16>(a, bm, bn, splits, kps, part, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 route of kernels/dip_matmul_q.py: x's int8 codes and per-row
// scales (dip_matmul_q.cu's quantizing pass), int8 permutated weights q (and
// q_up for swiglu) with f32 per-output-channel scales; out_dtype 0 = float32,
// 1 = bfloat16 (x's dtype, also the residual's); epilogue(float(codes @
// deshear(q)) * x_scale[m] * w_scale[n]) under the plan
// (kernels/dip_matmul.py::matmul_plan with weight_bytes = 1); workspace:
// int32, splits x (2 for swiglu, else 1) x M x N, used when splits > 1.
// Returns a cudaError_t.
extern "C" int dip_matmul_int8q_launch(int out_dtype, const void* codes, const void* q, const void* q_up,
                                       const float* x_scale, const float* w_scale, const float* w_scale_up,
                                       const float* bias, const void* residual, void* out, int M, int N, int K,
                                       int epilogue, int bm, int bn, int splits, int kps, void* workspace,
                                       void* stream) {
  if (bad_shape(M, N, K, epilogue) || x_scale == nullptr || w_scale == nullptr ||
      (epilogue == EPI_SWIGLU && w_scale_up == nullptr))
    return (int)cudaErrorInvalidValue;
  const S8Args a{static_cast<const int8_t*>(codes), static_cast<const int8_t*>(q), static_cast<const int8_t*>(q_up),
                 x_scale, w_scale, w_scale_up, bias, residual, out, M, N, K, epilogue};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* part = static_cast<int*>(workspace);
  if (out_dtype == 0) return (int)launch_int8q<float>(a, bm, bn, splits, kps, part, s);
  if (out_dtype == 1) return (int)launch_int8q<bf16>(a, bm, bn, splits, kps, part, s);
  return (int)cudaErrorInvalidValue;
}
