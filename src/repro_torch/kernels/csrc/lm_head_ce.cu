// Fused lm_head + cross-entropy statistics for Hopper (sm_90a).
//
// Replaces repro/kernels/lm_head_ce.py::lm_head_ce_pallas.  Per token t
//   logz[t] = logsumexp_v z[t, v]      lab[t] = z[t, labels[t]]
// with z = x @ W, columns v >= vocab masked to -1e30, and the (T, V) logits
// never written to device memory.
//
// The TPU kernel carries (m, l, label) across a sequential vocab grid axis.
// Blocks on the card run in no order, so the vocab is split: block
// (i, s) owns 128 tokens and the vocab tiles of split s, walks them in order
// with the same online logsumexp, and writes its partial (m, l, label) per
// token.  A second small kernel merges the splits, which is associative:
//   m = max_s m_s,  l = sum_s l_s exp(m_s - m),  lab = sum_s lab_s.
// A split that lies wholly in the vocab padding has m_s = -1e30; its lanes
// are masked out of the exponential sum (p = 0, not exp(z - m) = 1), so its
// l_s is 0 and it adds nothing to the merge.
//
// Per vocab tile the block computes the 128x128 tile of z in f32 over the
// whole of D, stages it in shared memory, and one warp per 16 rows folds it
// into the running statistics, which lanes 0..15 keep in registers.
//   * f32 W (the training case: x in the compute dtype, W the f32 natural
//     head): x is converted to f32 on load and every product is an IEEE
//     FMA on the CUDA cores (no TF32), as jnp.dot promotes to f32;
//   * bf16 x and bf16 W: WMMA (mma.sync) with an f32 accumulator.
// Rows past T are masked (zero x, nothing written); a label of -100 never
// equals a column.  Offsets into W and x are 64-bit: the (4096, 129024) f32
// head of llama3-8b is 2.1 GB.
//
// Bound on the card: by the operations (2 T D V; in f32 on the CUDA cores
// 67 TFLOP/s, in bf16 on the tensor cores 989 TFLOP/s).  This first design
// has no pipelining, TMA or wgmma.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BT = 128;           // tokens per block
constexpr int BV = 128;           // vocab columns per tile
constexpr int BK = 32;            // contraction step
constexpr int THREADS = 256;      // eight warps
constexpr int ZSTRIDE = BV + 4;   // staged f32 logit row
constexpr int FSTRIDE = BT + 4;   // f32 operand rows (x transposed, and W)
constexpr int XBSTRIDE = BK + 8;  // bf16 x rows
constexpr int WBSTRIDE = BV + 8;  // bf16 W rows
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;       // (T, D) row-major
  const void* w;       // (D, V) row-major
  const int* labels;   // (T,)
  float* part;         // (3, splits, T): m, l, label logit of each split
  int T, D, V, vocab, tiles_per_split, splits;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Fold the staged tile zs (columns c0 .. c0+BV) into the running statistics
// of the warp's 16 rows; lane r < 16 holds (m, l, a) of row warp*16 + r.
__device__ __forceinline__ void fold_tile(const float* zs, int c0, int vocab, int lab_lane,
                                          float& m, float& l, float& a) {
  const int lane = threadIdx.x % 32, row0 = (threadIdx.x / 32) * 16;
  for (int rr = 0; rr < 16; ++rr) {
    const float* zr = zs + (row0 + rr) * ZSTRIDE;
    const int lab = __shfl_sync(FULL, lab_lane, rr);
    float z[BV / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BV / 32; ++j) {
      const int col = c0 + lane + 32 * j;
      z[j] = col < vocab ? zr[lane + 32 * j] : NEG_INF;
      mx = fmaxf(mx, z[j]);
    }
    mx = warp_max(mx);
    const float m_old = __shfl_sync(FULL, m, rr);
    const float m_new = fmaxf(m_old, mx);
    float ps = 0.0f, hit = 0.0f;
#pragma unroll
    for (int j = 0; j < BV / 32; ++j) {
      const int col = c0 + lane + 32 * j;
      if (col < vocab) ps += expf(z[j] - m_new);  // masked lanes add 0, never exp(0)
      if (col == lab) hit += z[j];
    }
    ps = warp_sum(ps);
    hit = warp_sum(hit);
    if (lane == rr) {
      l = l * expf(m_old - m_new) + ps;
      m = m_new;
      a += hit;
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// f32 FMA path.  xs holds the x tile transposed (xs[k][t]), ws the W tile
// (ws[k][v]); thread (ty, tx) of a 16x16 grid owns rows {4ty+i, 64+4ty+i}
// and columns {4tx+j, 64+4tx+j}.
template <typename TX>
__device__ __forceinline__ void fma_logit_tile(const Args& a, float* xs, float* ws, float* zs,
                                               int t0, int c0) {
  const TX* x = static_cast<const TX*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < a.D; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
    {  // x: row r = tid % 128, 16 consecutive k from kh
      const int r = tid % BT, kh = (tid / BT) * 16, gt = t0 + r;
      float v[16];
      if (gt < a.T) {
        const TX* src = x + (size_t)gt * a.D + k0 + kh;
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = to_f32(src[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) xs[(kh + i) * FSTRIDE + r] = v[i];
    }
    {  // W: row k = tid / 8, 16 consecutive columns
      const int k = tid / 8, c = (tid % 8) * 16;
      const float4* src = reinterpret_cast<const float4*>(w + (size_t)(k0 + k) * a.V + c0 + c);
      float4* dst = reinterpret_cast<float4*>(ws + k * FSTRIDE + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = src[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * FSTRIDE + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * FSTRIDE + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + k * FSTRIDE + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + k * FSTRIDE + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + 4 * ty + (i % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) zs[r * ZSTRIDE + (j < 4 ? 0 : 64) + 4 * tx + (j % 4)] = acc[i][j];
  }
}

// bf16 x bf16 path: warp w owns rows 32*(w/2) .. +32 and columns 64*(w%2) .. +64
// as 2x4 WMMA fragments.
__device__ __forceinline__ void mma_logit_tile(const Args& a, __nv_bfloat16* xs, __nv_bfloat16* ws,
                                               float* zs, int t0, int c0) {
  using namespace nvcuda;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int tid = threadIdx.x, warp = tid / 32, wr = (warp / 2) * 32, wc = (warp % 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < a.D; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // x: 128 rows x 4 chunks of 8
      const int v = tid + THREADS * q, r = v / 4, c = (v % 4) * 8, gt = t0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (gt < a.T) raw = *reinterpret_cast<const uint4*>(x + (size_t)gt * a.D + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * XBSTRIDE + c) = raw;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // W: 32 rows x 16 chunks of 8
      const int v = tid + THREADS * q, k = v / 16, c = (v % 16) * 8;
      *reinterpret_cast<uint4*>(ws + k * WBSTRIDE + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)(k0 + k) * a.V + c0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], xs + (wr + 16 * i) * XBSTRIDE + kk, XBSTRIDE);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ws + kk * WBSTRIDE + wc + 16 * j, WBSTRIDE);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(zs + (wr + 16 * i) * ZSTRIDE + wc + 16 * j, acc[i][j], ZSTRIDE,
                              wmma::mem_row_major);
}

// MMA = false: f32 W with x of type TX (FMA path); MMA = true: bf16 x bf16.
template <typename TX, bool MMA>
__global__ void __launch_bounds__(THREADS) lm_head_ce_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);
  unsigned char* operands = smem + BT * ZSTRIDE * sizeof(float);
  const int t0 = blockIdx.x * BT, s = blockIdx.y;
  const int lane = threadIdx.x % 32, row = t0 + (threadIdx.x / 32) * 16 + lane;
  const int n_tiles = a.V / BV;
  const int v_begin = s * a.tiles_per_split;
  const int v_end = min(v_begin + a.tiles_per_split, n_tiles);
  // lane r < 16 carries row warp*16 + r; -1 (never a column) past T
  const int lab_lane = (lane < 16 && row < a.T) ? a.labels[row] : -1;
  float m = NEG_INF, l = 0.0f, acc_lab = 0.0f;

  for (int vt = v_begin; vt < v_end; ++vt) {
    const int c0 = vt * BV;
    if constexpr (MMA) {
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(operands);
      mma_logit_tile(a, xs, xs + BT * XBSTRIDE, zs, t0, c0);
    } else {
      float* xs = reinterpret_cast<float*>(operands);
      fma_logit_tile<TX>(a, xs, xs + BK * FSTRIDE, zs, t0, c0);
    }
    __syncthreads();  // zs complete
    fold_tile(zs, c0, a.vocab, lab_lane, m, l, acc_lab);
    __syncthreads();  // zs consumed before the next tile overwrites it
  }
  if (lane < 16 && row < a.T) {
    const size_t plane = (size_t)a.splits * a.T, at = (size_t)s * a.T + row;
    a.part[at] = m;
    a.part[plane + at] = l;
    a.part[2 * plane + at] = acc_lab;
  }
}

__global__ void merge_splits_kernel(const float* part, float* logz, float* lab, int T, int splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const size_t plane = (size_t)splits * T;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[(size_t)s * T + t]);
  float l = 0.0f, a = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = (size_t)s * T + t;
    l += part[plane + at] * expf(part[at] - m);  // an all-padding split has l_s = 0
    a += part[2 * plane + at];
  }
  logz[t] = m + logf(l);
  lab[t] = a;
}

template <typename TX, bool MMA>
cudaError_t launch(const Args& a, float* logz, float* lab, cudaStream_t stream) {
  const size_t operands = MMA ? (BT * XBSTRIDE + BK * WBSTRIDE) * sizeof(__nv_bfloat16)
                              : 2 * BK * FSTRIDE * sizeof(float);
  const size_t bytes = BT * ZSTRIDE * sizeof(float) + operands;
  cudaError_t err = cudaFuncSetAttribute(lm_head_ce_kernel<TX, MMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + BT - 1) / BT, a.splits);
  lm_head_ce_kernel<TX, MMA><<<grid, THREADS, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<(a.T + 255) / 256, 256, 0, stream>>>(a.part, logz, lab, a.T, a.splits);
  return cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; the pairs taken are
// (f32, f32), (bf16, f32) and (bf16, bf16).  part is (3, splits, T) f32
// scratch; logz and lab are (T,) f32.  Returns a cudaError_t (0 on success).
extern "C" int lm_head_ce_launch(int x_dtype, int w_dtype, const void* x, const void* w,
                                 const int* labels, float* part, float* logz, float* lab, int T,
                                 int D, int V, int vocab, int tiles_per_split, int splits,
                                 void* stream) {
  if (T <= 0 || D <= 0 || D % BK || V <= 0 || V % BV || vocab < 1 || vocab > V ||
      tiles_per_split < 1 || splits < 1 || splits > 65535 ||
      (long long)tiles_per_split * splits < V / BV)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, labels, part, T, D, V, vocab, tiles_per_split, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return (int)launch<float, false>(a, logz, lab, s);
  if (x_dtype == 1 && w_dtype == 0) return (int)launch<__nv_bfloat16, false>(a, logz, lab, s);
  if (x_dtype == 1 && w_dtype == 1) return (int)launch<__nv_bfloat16, true>(a, logz, lab, s);
  return (int)cudaErrorInvalidValue;
}
