// Prefill flash attention for Hopper (sm_90a), forward only, in f32.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas.  The
// TPU kernel walks KV blocks on a sequential grid axis with the running
// max / denominator / accumulator in VMEM scratch; here one block owns one
// (bh, 64-query tile) and walks the KV tiles itself with an online softmax.
//
//   * q_offset[bh] and kv_len[bh] are read on the device (int32), so one
//     build serves every prefill chunk with no host sync;
//   * causal masking uses absolute positions, q_offset + i >= k_pos, and
//     keys at or beyond kv_len (or Sk) are masked;
//   * the KV loop stops at the last tile a row of this query tile can see,
//     which skips every tile above the diagonal or past kv_len;
//   * a fully masked row gives exactly 0: masked lanes get p = 0 (the
//     exp(0) guard) and the flush divides by max(l, 1e-30);
//   * D and Dv (<= 256 each, Dv may differ from D) and any Sq, Sk: the
//     ragged edges are masked here instead of padded to (8, 128).
//
// Each of the 8 warps owns 8 query rows; lane j holds the score of key
// k0 + j for each of them, so the row max and sum are warp shuffles and the
// probabilities reach the P @ V product by shuffle too.  Bound on the card:
// at the prefill chunk (Sq = 256 against <= 1024 keys, D = 128) by the
// operations; this first design runs them as f32 FMAs on the CUDA cores
// (the reference computes in f32) and does nothing about that yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
