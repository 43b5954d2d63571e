// Prefill flash attention for Hopper (sm_90a), forward only.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas.  The
// TPU kernel walks KV blocks on a sequential grid axis with the running
// max / denominator / accumulator in VMEM scratch; here one block owns one
// (bh, 64-query tile) and walks the KV tiles itself with an online softmax.
// Both routes below share these semantics:
//
//   * q_offset[bh] and kv_len[bh] are read on the device (int32), so one
//     build serves every prefill chunk with no host sync;
//   * causal masking uses absolute positions, q_offset + i >= k_pos, and
//     keys at or beyond kv_len (or Sk) are masked;
//   * the KV loop stops at the last tile a row of this query tile can see,
//     which skips every tile above the diagonal or past kv_len;
//   * a fully masked row gives exactly 0: masked lanes get p = 0 and the
//     flush divides by max(l, 1e-30);
//   * any Sq and Sk: the ragged edges are masked here instead of padded.
//
// Bound on the card: at the prefill chunk (BH = 32, Sq = 256 against up to
// 1024 keys, D = 128) by the operations, which the tensor cores have to
// run.  The wrapper picks the route (kernels/flash_attention.py::flash_route):
//
//   * bf16 with D = Dv in {64, 128}, the served shapes: flash_tc_kernel,
//     FlashAttention-2 style.  Q K^T and P V are mma.sync m16n8k16 products
//     (bf16 in, f32 sums); the Q tile stays resident in registers; the next
//     K and V tiles are copied by cp.async while this one is multiplied
//     (double buffered); the online softmax stays in f32 registers.  BQ =
//     64 gives 128 blocks at the prefill chunk on 132 SMs, so KV is not
//     split across blocks.
//   * f32, Dv != D, or another D up to 256: flash_attention_kernel, the
//     products as f32 FMAs on the CUDA cores.  Each of its 8 warps owns 8
//     query rows; lane j holds the score of key k0 + j for each of them, so
//     the row max and sum are warp shuffles and the probabilities reach the
//     P @ V product by shuffle too.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "sm90_mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile: one per lane
constexpr int THREADS = 256;  // eight warps
constexpr int ROWS = BQ / (THREADS / 32);
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NJ = ceil(Dv / 32): output columns lane + 32 j per thread.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    const int* __restrict__ q_offset, const int* __restrict__ kv_len, int Sq, int Sk, int D, int Dv,
    float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;  // odd row stride: lane-indexed K rows hit distinct banks
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qo = q_offset[bh], kvl = kv_len[bh];
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * Dv;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e - r * D, gq = q0 + r;
    qs[r * DP + d] = gq < Sq ? to_f32(qb[(size_t)gq * D + d]) * scale : 0.0f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][NJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // keys at or past kv_end are masked for every row of this tile
  int kv_end = min(Sk, kvl);
  if (causal) kv_end = min(kv_end, qo + q0 + BQ);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // q tile written / previous K, V tiles consumed
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, d = e - r * D, gk = k0 + r;
      ks[r * DP + d] = gk < Sk ? to_f32(kb[(size_t)gk * D + d]) : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * Dv; e += THREADS) {
      const int r = e / Dv, d = e - r * Dv, gk = k0 + r;
      vs[r * Dv + d] = gk < Sk ? to_f32(vb[(size_t)gk * Dv + d]) : 0.0f;
    }
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.0f;
    const float* krow = ks + lane * DP;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) s[i] = fmaf(qs[(warp + 8 * i) * DP + d], kd, s[i]);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = qo + q0 + warp + 8 * i;
      const bool live = kpos < Sk && kpos < kvl && (!causal || qpos >= kpos);
      const float sv = live ? s[i] : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float p = sv <= 0.5f * NEG_INF ? 0.0f : expf(sv - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      s[i] = p;
    }

    for (int kk = 0; kk < BK; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < Dv ? vs[kk * Dv + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pk = __shfl_sync(0xffffffffu, s[i], kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pk, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gq = q0 + warp + 8 * i;
    if (gq >= Sq) continue;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * Sq + gq) * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < Dv) orow[c] = from_f32<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, const int* q_offset,
                   const int* kv_len, int BH, int Sq, int Sk, int D, int Dv, float scale,
                   int causal, cudaStream_t stream) {
  const size_t bytes = (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * Dv) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, NJ><<<grid, THREADS, bytes, stream>>>(
      q, k, v, out, q_offset, kv_len, Sq, Sk, D, Dv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, const int* q_offset,
                     const int* kv_len, int BH, int Sq, int Sk, int D, int Dv, float scale,
                     int causal, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (Dv <= 32) return launch<T, 1>(qt, kt, vt, ot, q_offset, kv_len, BH, Sq, Sk, D, Dv, scale, causal, s);
  if (Dv <= 64) return launch<T, 2>(qt, kt, vt, ot, q_offset, kv_len, BH, Sq, Sk, D, Dv, scale, causal, s);
  if (Dv <= 128) return launch<T, 4>(qt, kt, vt, ot, q_offset, kv_len, BH, Sq, Sk, D, Dv, scale, causal, s);
  return launch<T, 8>(qt, kt, vt, ot, q_offset, kv_len, BH, Sq, Sk, D, Dv, scale, causal, s);
}

// ------------------------------------------- bf16: tensor-core route ------
// D = Dv in {64, 128}.  Four warps, each owning 16 of the block's 64 query
// rows; S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in, f32
// accumulators); the Q tile stays resident (its fragments in registers) and
// the K and V tiles of the next KV step are copied by cp.async while this
// one is multiplied.  P is rounded to bf16 for the P V product; the row
// sums l are taken over the f32 probabilities.
constexpr int TC_BQ = 64, TC_BKV = 64, TC_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(TC_THREADS) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, const int* __restrict__ q_offset,
    const int* __restrict__ kv_len, int Sq, int Sk, float scale, int causal) {
  using bf16 = __nv_bfloat16;
  constexpr int STR = D + 8, TILE_E = 64 * STR, CPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + TILE_E;       // [2][TILE_E]
  bf16* vs = ks + 2 * TILE_E;   // [2][TILE_E]
  const int bh = blockIdx.x, q0 = blockIdx.y * TC_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qo = q_offset[bh], kv_lim = min(Sk, kv_len[bh]);
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  // keys at or past kv_end are masked for every row of this tile
  const int kv_end = causal ? min(kv_lim, qo + q0 + TC_BQ) : kv_lim;
  const int nt = kv_end > 0 ? (kv_end + TC_BKV - 1) / TC_BKV : 0;

  // 64 rows from row0 of a (rows, D) array; rows at or past limit zero-filled
  auto load = [&](bf16* dst, const bf16* src, int row0, int limit) {
#pragma unroll
    for (int e = tid; e < 64 * CPR; e += TC_THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8, g = row0 + r;
      sm90::cp_async16(dst + r * STR + c, src + (size_t)max(min(g, limit - 1), 0) * D + c, g < limit);
    }
  };

  float o[D / 8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  uint32_t qf[D / 16][4];
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp(x) = exp2(x log2 e)

  if (nt > 0) {
    load(qs, qb, q0, Sq);
    load(ks, kb, 0, Sk);
    load(vs, vb, 0, Sk);
  }
  sm90::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      load(ks + ((t + 1) & 1) * TILE_E, kb, (t + 1) * TC_BKV, Sk);
      load(vs + ((t + 1) & 1) * TILE_E, vb, (t + 1) * TC_BKV, Sk);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // every group but the one just committed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * STR + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + (t & 1) * TILE_E;
    const bf16* vt = vs + (t & 1) * TILE_E;
    float s[TC_BKV / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; j += 2) {
        uint32_t b[4];  // K rows are the key columns of Q K^T: no transpose
        sm90::ldmatrix_x4(b, kt + (8 * j + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 + ((lane >> 3) & 1) * 8);
        sm90::mma_bf16(s[j], qf[kk], b[0], b[1]);
        sm90::mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
      }

    // online softmax: this thread holds rows lane/4 and lane/4 + 8 of the
    // warp's 16, keys 8 j + 2 (lane % 4) + {0, 1}; a row's four lanes are a quad
    const int k0 = t * TC_BKV;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = qo + q0 + warp * 16 + (lane >> 2) + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * (lane & 3) + e;
          const bool live = key < kv_lim && (!causal || qpos >= key);
          const float val = live ? s[j][2 * h + e] * sl2 : -INFINITY;
          s[j][2 * h + e] = val;
          mx = fmaxf(mx, val);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // a row with no live key so far: p = 0
      const float alpha = exp2f(m_run[h] - m_use);
      m_run[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * h + e] - m_use);
          s[j][2 * h + e] = p;
          sum += p;
        }
      l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A fragment
#pragma unroll
    for (int kk = 0; kk < TC_BKV / 16; ++kk) {
      const uint32_t pa[4] = {sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]), sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        sm90::ldmatrix_x4_trans(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + 8 * j + (lane >> 4) * 8);
        sm90::mma_bf16(o[j], pa, b[0], b[1]);
        sm90::mma_bf16(o[j + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this step's K and V buffers are free for step t + 2
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);  // a fully masked row: l = 0, o = 0
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= Sq) continue;
    bf16* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, const int* q_offset,
                      const int* kv_len, int BH, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = (size_t)5 * 64 * (D + 8) * sizeof(__nv_bfloat16);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(BH, (Sq + TC_BQ - 1) / TC_BQ);
  flash_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), q_offset, kv_len, Sq, Sk, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* out, const int* q_offset, const int* kv_len, int BH,
                                      int Sq, int Sk, int D, int Dv, float scale, int causal,
                                      void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk < 0 || D <= 0 || D > 256 || Dv <= 0 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, q_offset, kv_len, BH, Sq, Sk, D, Dv, scale, causal, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, q_offset, kv_len, BH, Sq, Sk, D, Dv, scale, causal, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// The tensor-core route (kernels/flash_attention.py::flash_route): bf16
// with D = Dv in {64, 128}.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         const int* q_offset, const int* kv_len, int BH, int Sq, int Sk,
                                         int D, float scale, int causal, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_tc<64>(q, k, v, out, q_offset, kv_len, BH, Sq, Sk, scale, causal, s);
  if (D == 128) return (int)launch_tc<128>(q, k, v, out, q_offset, kv_len, BH, Sq, Sk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
