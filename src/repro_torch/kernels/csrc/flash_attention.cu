// Prefill flash attention for Hopper (sm_90a), forward only.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas.  The
// TPU kernel walks KV blocks on a sequential grid axis with the running
// max / denominator / accumulator in VMEM scratch; here a block owns one
// (bh, query tile) and walks the KV tiles itself with an online softmax.
// Every route below shares these semantics:
//
//   * q_offset and kv_len are per-row values (PerRow below): an int32 or
//     int64 tensor read on the device, one element or one a row, or a plain
//     integer the wrapper passes by value; so one build serves every prefill
//     chunk with no host sync, and neither costs a launch of its own;
//   * causal masking uses absolute positions, q_offset + i >= k_pos, and
//     keys at or beyond kv_len (or Sk) are masked;
//   * the KV loop stops at the last tile a row of this query tile can see,
//     which skips every tile above the diagonal or past kv_len;
//   * a fully masked row gives exactly 0: masked lanes get p = 0 and the
//     flush divides by max(l, 1e-30);
//   * any Sq and Sk: the ragged edges are masked here instead of padded.
//
// Bound on the card: a prefill chunk (BH = 32, Sq = 256 against up to 1024
// keys) by the operations, which the tensor cores have to run; a short
// query (Sq = 1, a token of Zamba2's single-token prefill tail) by the
// bytes of K and V.  The wrapper picks the route
// (kernels/flash_attention.py::flash_plan):
//
//   * bf16 or f32 with (D, Dv) a tensor-core pair, D = Dv in {32, 48, 64,
//     80, 96, 112, 128} (32 and 48: the reduced models), (48, 32) (the
//     reduced MLA model) or (192, 128) (DeepSeek-V2-Lite's MLA prefill: q
//     and k carry nope + rope = 128 + 64 columns, v 128): flash_tc_kernel,
//     FlashAttention-2 style.  Q K^T and P V are mma.sync m16n8k16 products
//     (bf16 in, f32 sums; f32 operands as the six exact products of their
//     bf16 parts); the next K and V tiles are copied by cp.async while this
//     one is multiplied (double buffered); the online softmax stays in f32
//     registers.  BQ = 64 gives 128 blocks at the prefill chunk on 132 SMs,
//     so KV is not split across blocks.
//   * the same pairs with a short query: flash_split_kernel.  A 16-row
//     query tile (one m16 fragment) and the keys split across blocks, so
//     that a single-token call fills the card and reads K and V once with
//     16-byte copies.  Each block's four warps take 16 keys each of every
//     64-key tile and merge in shared memory; each split's f32 partial (m,
//     l, unnormalised O) goes to a workspace, and the last block of each
//     (bh, query tile), picked by an atomic ticket that it resets to 0,
//     merges the splits in split order: one launch, bit-identical from call
//     to call, no host sync and no per-call memset.
//   * any other (D, Dv) up to 256 (D not a multiple of 16, or a pair above
//     128 other than (192, 128), or another Dv != D pair):
//     flash_attention_kernel, the products as f32 FMAs on the CUDA cores.
//     Each of its 8 warps owns 8 query rows; lane j holds the score of key
//     k0 + j for each of them, so the row max and sum are warp shuffles and
//     the probabilities reach the P @ V product by shuffle too.
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

// A per-row value: element step * bh of an int32 (wide = 0) or int64 (wide
// = 1) array at ptr (step 0: one element for every row), or value where ptr
// is null.  Positions fit in 32 bits; an int64 array is read as it is, so a
// caller's position tensor needs no conversion launch.
struct PerRow {
  const void* ptr;
  int step, value, wide;
  __device__ __forceinline__ int at(int bh) const {
    if (!ptr) return value;
    return wide ? (int)static_cast<const long long*>(ptr)[step * bh] : static_cast<const int*>(ptr)[step * bh];
  }
};

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
    PerRow q_offset, PerRow kv_len, int Sq, int Sk, int D, int Dv, float scale, int causal) {
  extern __shared__ float smem[];
  const int DP = D + 1;  // odd row stride: lane-indexed K rows hit distinct banks
  float* qs = smem;
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qo = q_offset.at(bh), kvl = kv_len.at(bh);
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
cudaError_t launch(const T* q, const T* k, const T* v, T* out, PerRow q_offset, PerRow kv_len, int BH, int Sq,
                   int Sk, int D, int Dv, float scale,
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
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, PerRow q_offset, PerRow kv_len,
                     int BH, int Sq, int Sk, int D, int Dv, float scale,
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

// ------------------------------------------------ tensor-core routes ------
// (D, Dv): D = Dv in {32, 48, 64, 80, 96, 112, 128}, (48, 32) or (192, 128),
// in bf16 and in f32.  Four warps, each owning 16 of the block's 64 query
// rows (f32: eight, two a 16-row slice, each on one half of every KV tile,
// merged at the end); S = Q K^T (D / 16 steps) and O += P V (Dv / 8 output
// fragments) run as mma.sync m16n8k16 (bf16 in, f32 accumulators); the K
// and V tiles of the next KV step are copied by cp.async while this one is
// multiplied.
//
//   * bf16: the Q tile stays resident (its fragments in registers); P is
//     rounded to bf16 for the P V product; the row sums l are taken over the
//     f32 probabilities.  At (192, 128) a block holds Q 25.6 KB + 2 x K
//     25.6 KB + 2 x V 17.4 KB = 111.6 KB of shared memory, so two blocks
//     fit an SM; its registers hold 48 words of Q fragments, 64 of O and 32
//     of S: ptxas -v (CUDA 12.8) gives 225 registers a thread and no spills
//     (two blocks of 128 threads fit the SM's 65,536), the split kernel at
//     (192, 128) 168.
//   * f32: Q, K and V stay f32 in shared memory (cp.async copies them as
//     they are) and every fragment is split into three bf16 parts as it is
//     read (sm90::split_bf16x3: exact), so each product of S and of P V is
//     the six part products i + j <= 2 of sm90::mma_bf16_parts, 6x the bf16
//     route's tensor-core work, with no operand rounded (no TF32).  Q is
//     read again from shared memory at every KV step: three resident parts
//     of D = 192 would not fit the registers.  The five smaller products and
//     hi x hi run in two accumulators added in IEEE f32 once per KV step,
//     and each KV step's P V is summed from zero and added to O in IEEE f32
//     (the tensor cores round their f32 sums toward zero: a chain over the
//     whole of Sk would lose f32 accuracy).  ldmatrix takes no f32, so Q and
//     K fragments are 64-bit shared loads (rows of D + 8 floats: a half
//     warp's four rows on distinct 8-bank groups) and V fragments 32-bit
//     ones down a column (rows of Dv + 4 floats: a warp's 32 lanes on 32
//     distinct banks).  At (192, 128) a block holds Q 51.2 KB + 2 x K 51.2
//     KB + 2 x V 33.8 KB = 221.2 KB: one block an SM, so the second warp of
//     each slice is what hides the split's latency.  ptxas -v (CUDA 12.8):
//     127-175 registers, no spills (the 16-deep steps of S are not unrolled:
//     unrolled, ptxas hoisted every step's K loads and spilled at D = 112).
constexpr int TC_BQ = 64, TC_BKV = 64, TC_THREADS = 128;

// Shared rows of a bf16 tile: D + 8 elements, 16 (D / 8 + 1) bytes.  With
// D a multiple of 16 that is an odd number of 16-byte chunks, so the eight
// rows of one ldmatrix phase start on eight distinct 4-bank groups (D = 80:
// a 176-byte stride, rows at banks 0, 12, 24, 4, 16, 28, 8, 20) and every
// row starts 16-byte aligned for cp.async.  The same D gives the f32 rows
// above their conflict-free strides (D + 8 = 8 or 24 words mod 32, Dv + 4 =
// 4 mod 16).
template <int D>
__host__ __device__ constexpr bool conflict_free_rows() {
  return D % 16 == 0 && (D / 8 + 1) % 2 == 1;
}

template <typename T> struct Rows;  // padding of a Q / K row and of a V row, in elements
template <> struct Rows<__nv_bfloat16> { static constexpr int QK = 8, V = 8; };
template <> struct Rows<float> { static constexpr int QK = 8, V = 4; };

// ROWS rows from row0 of a (rows, W) array into shared rows of STR
// elements, one 16-byte cp.async a chunk over NT threads; rows at or past
// limit are zero-filled.
template <typename T, int W, int STR, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int limit, int tid) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = W / EPC;
#pragma unroll
  for (int e = tid; e < ROWS * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * EPC, g = row0 + r;
    sm90::cp_async16(dst + r * STR + c, src + (size_t)max(min(g, limit - 1), 0) * W + c, g < limit);
  }
}

// f32 fragments of one m16n8k16 step read from shared rows and split into
// bf16 parts; g = lane / 4, c = lane % 4, t the fragment's first element.
// A (16 x 16, row r, column k): registers (g, 2c..), (g + 8, 2c..),
// (g, 2c + 8..), (g + 8, 2c + 8..).
template <int STR>
__device__ __forceinline__ void a_parts(uint32_t (&a)[3][4], const float* t) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = *reinterpret_cast<const float2*>(t + (g + 8 * (i & 1)) * STR + 2 * c + 8 * (i >> 1));
    uint32_t p[3];
    sm90::split_bf16x3(x.x, x.y, p);
    a[0][i] = p[0], a[1][i] = p[1], a[2][i] = p[2];
  }
}

// B (16 x 8) whose column n is shared row g (K for Q K^T): k = 2c.. and 2c + 8..
template <int STR>
__device__ __forceinline__ void b_parts_rows(uint32_t (&b)[3][2], const float* t) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 x = *reinterpret_cast<const float2*>(t + g * STR + 2 * c + 8 * h);
    uint32_t p[3];
    sm90::split_bf16x3(x.x, x.y, p);
    b[0][h] = p[0], b[1][h] = p[1], b[2][h] = p[2];
  }
}

// B (16 x 8) whose row k is shared row k (V for P V): column g of rows
// 2c, 2c + 1 and 2c + 8, 2c + 9
template <int STR>
__device__ __forceinline__ void b_parts_cols(uint32_t (&b)[3][2], const float* t) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t p[3];
    sm90::split_bf16x3(t[(2 * c + 8 * h) * STR + g], t[(2 * c + 8 * h + 1) * STR + g], p);
    b[0][h] = p[0], b[1][h] = p[1], b[2][h] = p[2];
  }
}

// P V's A fragment of one 16-key step from the S accumulators of its two
// 8-key groups (the C layout of s0, s1 is the A layout), split into parts
__device__ __forceinline__ void p_parts(uint32_t (&a)[3][4], const float (&s0)[4], const float (&s1)[4]) {
  const float v[4][2] = {{s0[0], s0[1]}, {s0[2], s0[3]}, {s1[0], s1[1]}, {s1[2], s1[3]}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p[3];
    sm90::split_bf16x3(v[i][0], v[i][1], p);
    a[0][i] = p[0], a[1][i] = p[1], a[2][i] = p[2];
  }
}

// S (16 rows at q, NJ groups of 8 keys at k) of f32 Q and K: the six part
// products of every 16-deep step, hi x hi chained apart, added once
template <int D, int STR, int NJ>
__device__ __forceinline__ void scores_f32(float (&s)[NJ][4], const float* q, const float* k) {
  float hi[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) hi[j][0] = hi[j][1] = hi[j][2] = hi[j][3] = 0.0f;
#pragma unroll 1  // one 16-deep step at a time (see the f32 route above)
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[3][4];
    a_parts<STR>(qa, q + kk * 16);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t kb[3][2];
      b_parts_rows<STR>(kb, k + 8 * j * STR + kk * 16);
      sm90::mma_bf16_parts(hi[j], s[j], qa, kb);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += hi[j][e];
}

// O += P V for NK 16-key steps of f32 probabilities s and the f32 V rows
// at v: each 8-column fragment's six part products from zero, then added
// to O in IEEE f32
template <int DV, int STR, int NK>
__device__ __forceinline__ void pv_f32(float (&o)[DV / 8][4], const float (&s)[2 * NK][4], const float* v) {
  uint32_t pa[NK][3][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) p_parts(pa[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f}, lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t vb[3][2];
      b_parts_cols<STR>(vb, v + kk * 16 * STR + 8 * j);
      sm90::mma_bf16_parts(hi, lo, pa[kk], vb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] += lo[e] + hi[e];
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One KV step of the online softmax on a warp's S fragments.  s[j] holds
// the scores of rows row0 + lane / 4 and row0 + lane / 4 + 8 against keys
// key0 + 8 j + 2 (lane % 4) + {0, 1}; a row's four lanes are a quad.
// Masked scores give p = 0; m_run (in log2 units: exp(x) = exp2(x log2 e),
// sl2 = scale log2 e), l_run (this lane's share of the row sum) and o are
// rescaled, and s returns the f32 probabilities.
template <int NF, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NF][4], float (&m_run)[2], float (&l_run)[2],
                                               float (&o)[NO][4], int row0, int key0, int kv_lim, int causal,
                                               float sl2) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row0 + (lane >> 2) + 8 * h;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * (lane & 3) + e;
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
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(s[j][2 * h + e] - m_use);
        s[j][2 * h + e] = p;
        sum += p;
      }
    l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * h] *= alpha;
      o[j][2 * h + 1] *= alpha;
    }
  }
}

// threads of a tensor-core block: f32 takes two warps a 16-row slice, each
// on one half of every KV tile's keys (merged at the end), so that eight
// warps, not four, hide the latency of its longer chains
template <typename T>
__host__ __device__ constexpr int tc_threads() {
  return sizeof(T) == 4 ? 2 * TC_THREADS : TC_THREADS;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(tc_threads<T>()) flash_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out, PerRow q_offset,
    PerRow kv_len, int Sq, int Sk, float scale, int causal) {
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(conflict_free_rows<D>() && conflict_free_rows<DV>(), "head dims must be multiples of 16");
  constexpr int KSTR = D + Rows<T>::QK, VSTR = DV + Rows<T>::V, K_TILE = 64 * KSTR, V_TILE = 64 * VSTR;
  constexpr int NT = tc_threads<T>(), KEYS = F32 ? TC_BKV / 2 : TC_BKV;  // KEYS: a warp's keys of a tile
  extern __shared__ __align__(128) unsigned char smem_tc[];
  T* qs = reinterpret_cast<T*>(smem_tc);  // [64][KSTR]
  T* ks = qs + K_TILE;                    // [2][K_TILE]
  T* vs = ks + 2 * K_TILE;                // [2][V_TILE]
  const int bh = blockIdx.x, q0 = blockIdx.y * TC_BQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, half = tid >> 7;  // rows 16 warp..; keys KEYS half.. of each tile (f32)
  const int qo = q_offset.at(bh), kv_lim = min(Sk, kv_len.at(bh));
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * DV;
  // keys at or past kv_end are masked for every row of this tile
  const int kv_end = causal ? min(kv_lim, qo + q0 + TC_BQ) : kv_lim;
  const int nt = kv_end > 0 ? (kv_end + TC_BKV - 1) / TC_BKV : 0;

  float o[DV / 8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  uint32_t qf[F32 ? 1 : D / 16][4];  // bf16: the warp's Q fragments, resident
  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units: exp(x) = exp2(x log2 e)

  if (nt > 0) {
    load_rows<T, D, KSTR, TC_BQ, NT>(qs, qb, q0, Sq, tid);
    load_rows<T, D, KSTR, TC_BKV, NT>(ks, kb, 0, Sk, tid);
    load_rows<T, DV, VSTR, TC_BKV, NT>(vs, vb, 0, Sk, tid);
  }
  sm90::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      load_rows<T, D, KSTR, TC_BKV, NT>(ks + ((t + 1) & 1) * K_TILE, kb, (t + 1) * TC_BKV, Sk, tid);
      load_rows<T, DV, VSTR, TC_BKV, NT>(vs + ((t + 1) & 1) * V_TILE, vb, (t + 1) * TC_BKV, Sk, tid);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();  // every group but the one just committed
    __syncthreads();
    const T* kt = ks + (t & 1) * K_TILE + half * KEYS * KSTR;
    const T* vt = vs + (t & 1) * V_TILE + half * KEYS * VSTR;
    float s[KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    if constexpr (F32) {
      scores_f32<D, KSTR>(s, qs + warp * 16 * KSTR, kt);
    } else {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * KSTR + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < TC_BKV / 8; j += 2) {
          uint32_t b[4];  // K rows are the key columns of Q K^T: no transpose
          sm90::ldmatrix_x4(b, kt + (8 * j + (lane & 7) + (lane >> 4) * 8) * KSTR + kk * 16 + ((lane >> 3) & 1) * 8);
          sm90::mma_bf16(s[j], qf[kk], b[0], b[1]);
          sm90::mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
        }
    }

    online_softmax(s, m_run, l_run, o, qo + q0 + warp * 16, t * TC_BKV + half * KEYS, kv_lim, causal, sl2);

    if constexpr (F32) {
      pv_f32<DV, VSTR, KEYS / 16>(o, s, vt);
    } else {
      // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A fragment
#pragma unroll
      for (int kk = 0; kk < TC_BKV / 16; ++kk) {
        const uint32_t pa[4] = {sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DV / 8; j += 2) {
          uint32_t b[4];
          sm90::ldmatrix_x4_trans(
              b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VSTR + 8 * j + (lane >> 4) * 8);
          sm90::mma_bf16(o[j], pa, b[0], b[1]);
          sm90::mma_bf16(o[j + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this step's K and V buffers are free for step t + 2
  }
  sm90::cp_async_wait<0>();

  if constexpr (F32) {  // the key halves' (m, l, O) of each slice: lane for lane, the same rows and columns
    constexpr int EX = DV / 2 + 4;  // a lane's O, m and l
    static_assert(4 * EX * 32 <= 2 * K_TILE, "the exchange fits the K buffers");
    float* ex = reinterpret_cast<float*>(ks) + warp * EX * 32 + lane;  // [4][EX][32]
    __syncthreads();  // every warp is done with K and V
    if (half) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ex[(4 * j + e) * 32] = o[j][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ex[(DV / 2 + h) * 32] = m_run[h];
        ex[(DV / 2 + 2 + h) * 32] = l_run[h];
      }
    }
    __syncthreads();
    if (half) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mb = ex[(DV / 2 + h) * 32], m_new = fmaxf(m_run[h], mb);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // neither half saw a live key: both weights 0
      const float wa = exp2f(m_run[h] - m_use), wb = exp2f(mb - m_use);
      l_run[h] = l_run[h] * wa + ex[(DV / 2 + 2 + h) * 32] * wb;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) o[j][2 * h + e] = o[j][2 * h + e] * wa + ex[(4 * j + 2 * h + e) * 32] * wb;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);  // a fully masked row: l = 0, o = 0
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= Sq) continue;
    T* orow = out + ((size_t)bh * Sq + row) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) store2(orow + 8 * j + 2 * (lane & 3), o[j][2 * h] * inv_l, o[j][2 * h + 1] * inv_l);
  }
}

template <typename T, int D, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, PerRow q_offset, PerRow kv_len,
                      int BH, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = (size_t)(3 * 64 * (D + Rows<T>::QK) + 2 * 64 * (DV + Rows<T>::V)) * sizeof(T);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tc_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(BH, (Sq + TC_BQ - 1) / TC_BQ);
  flash_tc_kernel<T, D, DV><<<grid, tc_threads<T>(), bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), q_offset,
      kv_len, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------ split over the keys ------
// The tensor-core (D, Dv) pairs with a short query (flash_plan's "split_kv").
// Grid (BH, query tiles of 16 rows, splits): split s walks the 64-key tiles
// [s tps, (s + 1) tps), and each of the block's four warps takes 16 keys of
// every tile against the whole 16-row query tile (one m16 fragment, so a
// single-token call wastes 15 of 16 rows of one warp's products, where the
// 64-row tile wasted 63 of 64 of four).  K and V are read once, by 16-byte
// cp.async copies, double buffered; f32 is split into bf16 parts as the
// tensor-core kernel does.  The four warps' (m, l, O) merge in shared
// memory; then a split's f32 partial goes to the workspace
//   ws = [BH][splits][Sq][Dv] unnormalised O, then [BH][splits][Sq][2] (m, l),
// only for the tile's rows below Sq, and O only where m > -inf.  A split
// that lies wholly past its rows' last visible key, min(kv_len, q_offset +
// q0 + 16), reads no K or V and writes the empty partial (m = -inf, l = 0).
// Each block then takes a ticket of its (bh, query tile); the last one
// merges the splits in split order (the same sums whichever block is last,
// so the output is bit-identical from call to call) and resets the ticket
// to 0, so the buffer is zeroed once, when the wrapper allocates it.  With
// one split the block writes the output itself.
constexpr int SP_BQ = 16, SP_THREADS = 128, MAX_SPLITS = 256;

__device__ __forceinline__ void store4(float* p, float4 a, float s) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a, float s) {
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p);
  dst[0] = __floats2bfloat162_rn(a.x * s, a.y * s);
  dst[1] = __floats2bfloat162_rn(a.z * s, a.w * s);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(SP_THREADS) flash_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out, PerRow q_offset,
    PerRow kv_len, float* __restrict__ ws, int* __restrict__ tickets, int Sq, int Sk, int splits, int tps,
    float scale, int causal) {
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(conflict_free_rows<D>() && conflict_free_rows<DV>(), "head dims must be multiples of 16");
  constexpr int KSTR = D + Rows<T>::QK, VSTR = DV + Rows<T>::V, K_TILE = 64 * KSTR, V_TILE = 64 * VSTR;
  extern __shared__ __align__(128) unsigned char smem_sp[];
  T* qs = reinterpret_cast<T*>(smem_sp);      // [16][KSTR]
  T* ks = qs + SP_BQ * KSTR;                  // [2][K_TILE]
  T* vs = ks + 2 * K_TILE;                    // [2][V_TILE]
  float* red = reinterpret_cast<float*>(ks);  // both merges, once K and V are consumed
  __shared__ int last;
  const int bh = blockIdx.x, qt = blockIdx.y, split = blockIdx.z, q0 = qt * SP_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qo = q_offset.at(bh), kv_lim = min(Sk, kv_len.at(bh));
  const int kv_end = causal ? min(kv_lim, qo + q0 + SP_BQ) : kv_lim;
  const int t0 = split * tps;
  const int nt = kv_end > 0 ? max(0, min(tps, (kv_end + TC_BKV - 1) / TC_BKV - t0)) : 0;
  const int rows = min(SP_BQ, Sq - q0);  // the tile's rows below Sq
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * DV;

  float o[DV / 8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  uint32_t qf[F32 ? 1 : D / 16][4];
  const float sl2 = scale * 1.4426950408889634f;

  if (nt > 0) {
    load_rows<T, D, KSTR, SP_BQ, SP_THREADS>(qs, qb, q0, Sq, tid);
    load_rows<T, D, KSTR, TC_BKV, SP_THREADS>(ks, kb, t0 * TC_BKV, Sk, tid);
    load_rows<T, DV, VSTR, TC_BKV, SP_THREADS>(vs, vb, t0 * TC_BKV, Sk, tid);
  }
  sm90::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      load_rows<T, D, KSTR, TC_BKV, SP_THREADS>(ks + ((t + 1) & 1) * K_TILE, kb, (t0 + t + 1) * TC_BKV, Sk, tid);
      load_rows<T, DV, VSTR, TC_BKV, SP_THREADS>(vs + ((t + 1) & 1) * V_TILE, vb, (t0 + t + 1) * TC_BKV, Sk, tid);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const T* kt = ks + (t & 1) * K_TILE + 16 * warp * KSTR;  // this warp's 16 keys
    const T* vt = vs + (t & 1) * V_TILE + 16 * warp * VSTR;
    float s[2][4] = {};
    if constexpr (F32) {
      scores_f32<D, KSTR>(s, qs, kt);
    } else {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::ldmatrix_x4(qf[kk], qs + (lane & 15) * KSTR + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        sm90::ldmatrix_x4(b, kt + ((lane & 7) + (lane >> 4) * 8) * KSTR + kk * 16 + ((lane >> 3) & 1) * 8);
        sm90::mma_bf16(s[0], qf[kk], b[0], b[1]);
        sm90::mma_bf16(s[1], qf[kk], b[2], b[3]);
      }
    }
    online_softmax(s, m_run, l_run, o, qo + q0, (t0 + t) * TC_BKV + 16 * warp, kv_lim, causal, sl2);
    if constexpr (F32) {
      pv_f32<DV, VSTR, 1>(o, s, vt);
    } else {
      const uint32_t pa[4] = {sm90::pack_bf16(s[0][0], s[0][1]), sm90::pack_bf16(s[0][2], s[0][3]),
                              sm90::pack_bf16(s[1][0], s[1][1]), sm90::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < DV / 8; j += 2) {
        uint32_t b[4];
        sm90::ldmatrix_x4_trans(b, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * VSTR + 8 * j + (lane >> 4) * 8);
        sm90::mma_bf16(o[j], pa, b[0], b[1]);
        sm90::mma_bf16(o[j + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this step's K and V buffers are free for step t + 2
  }
  sm90::cp_async_wait<0>();
  __syncthreads();

  // the four warps' (m, l, O) of the tile's 16 rows, merged in warp order
  float* mw = red;               // [4][16]
  float* lw = mw + 4 * SP_BQ;    // [4][16]
  float* ow = lw + 4 * SP_BQ;    // [4][16][DV]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = warp * SP_BQ + (lane >> 2) + 8 * h;
    if ((lane & 3) == 0) {
      mw[r] = m_run[h];
      lw[r] = l;
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(ow + r * DV + 8 * j + 2 * (lane & 3)) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
  }
  __syncthreads();
  // from here on a thread owns 4 adjacent columns of a row (one float4)
  constexpr int C4 = DV / 4;
  float4* ws_o = reinterpret_cast<float4*>(ws);                               // [BH][splits][Sq][DV / 4]
  float2* ws_ml = reinterpret_cast<float2*>(ws + (size_t)gridDim.x * splits * Sq * DV);  // [BH][splits][Sq]
  const size_t base = (size_t)bh * splits * Sq + q0;  // row q0 of split 0 of this bh
  for (int e = tid; e < rows * C4; e += SP_THREADS) {
    const int r = e / C4, c4 = e - r * C4;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, mw[w * SP_BQ + r]);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mr = mw[w * SP_BQ + r];
      if (mr == -INFINITY) continue;  // no live key of this warp: nothing to add
      const float a = exp2f(mr - mx);
      const float4 ov = reinterpret_cast<const float4*>(ow + (w * SP_BQ + r) * DV)[c4];
      acc = make_float4(acc.x + a * ov.x, acc.y + a * ov.y, acc.z + a * ov.z, acc.w + a * ov.w);
      l += a * lw[w * SP_BQ + r];
    }
    if (splits == 1) {
      store4(out + ((size_t)bh * Sq + q0 + r) * DV + 4 * c4, acc, 1.0f / fmaxf(l, 1e-30f));
      continue;
    }
    const size_t row = base + (size_t)split * Sq + r;
    if (mx != -INFINITY) ws_o[row * C4 + c4] = acc;
    if (c4 == 0) ws_ml[row] = make_float2(mx, l);
  }
  if (splits == 1) return;

  __threadfence();  // this split's partial is visible to every block before its ticket
  __syncthreads();
  int* ticket = tickets + (size_t)bh * gridDim.y + qt;
  if (tid == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: M = max of the splits' m, weights w_s = exp2(m_s - M)
  // (0 for an empty partial), L = sum w_s l_s and O = sum w_s O_s in split
  // order.  The partials are read from L2 (__ldcg), where the other blocks
  // wrote them: every (m, l) at once into shared memory, O as float4s eight
  // splits at a time, so that the loads overlap instead of queueing
  float* wgt = red;                         // [splits][16]: m_s, then w_s
  float* lsp = wgt + MAX_SPLITS * SP_BQ;    // [splits][16]: l_s
  float* l_tot = lsp + MAX_SPLITS * SP_BQ;  // [16]
  for (int e = tid; e < splits * SP_BQ; e += SP_THREADS) {
    const int sp = e / SP_BQ, r = e % SP_BQ;
    const float2 ml = r < rows ? __ldcg(ws_ml + base + (size_t)sp * Sq + r) : make_float2(-INFINITY, 0.0f);
    wgt[e] = ml.x;
    lsp[e] = ml.y;
  }
  __syncthreads();
  if (tid < rows) {
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, wgt[sp * SP_BQ + tid]);
    float l = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float m = wgt[sp * SP_BQ + tid];
      const float w = m == -INFINITY ? 0.0f : exp2f(m - mx);
      wgt[sp * SP_BQ + tid] = w;
      if (w != 0.0f) l += w * lsp[sp * SP_BQ + tid];
    }
    l_tot[tid] = l;
  }
  __syncthreads();
  for (int e = tid; e < rows * C4; e += SP_THREADS) {
    const int r = e / C4, c4 = e - r * C4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      float4 part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sp = sp0 + i;
        part[i] = sp < splits && wgt[sp * SP_BQ + r] != 0.0f ? __ldcg(ws_o + (base + (size_t)sp * Sq + r) * C4 + c4)
                                                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sp = sp0 + i;
        const float w = sp < splits ? wgt[sp * SP_BQ + r] : 0.0f;
        if (w != 0.0f)
          acc = make_float4(acc.x + w * part[i].x, acc.y + w * part[i].y, acc.z + w * part[i].z,
                            acc.w + w * part[i].w);
      }
    }
    store4(out + ((size_t)bh * Sq + q0 + r) * DV + 4 * c4, acc, 1.0f / fmaxf(l_tot[r], 1e-30f));
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

template <typename T, int D, int DV>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* out, PerRow q_offset,
                         PerRow kv_len, float* ws, int* tickets, int BH, int Sq, int Sk, int splits, int tps,
                         float scale, int causal, cudaStream_t stream) {
  // K and V tiles, and in their place the two merges (the warps' partials,
  // then every split's (m, l) and weight)
  constexpr size_t kv_bytes = (size_t)2 * TC_BKV * (D + Rows<T>::QK + DV + Rows<T>::V) * sizeof(T);
  constexpr size_t warps_bytes = (size_t)(8 * SP_BQ + 4 * SP_BQ * DV) * sizeof(float);
  constexpr size_t splits_bytes = (size_t)(2 * MAX_SPLITS + 1) * SP_BQ * sizeof(float);
  constexpr size_t red_bytes = kv_bytes > warps_bytes ? (kv_bytes > splits_bytes ? kv_bytes : splits_bytes)
                                                      : (warps_bytes > splits_bytes ? warps_bytes : splits_bytes);
  constexpr size_t bytes = (size_t)SP_BQ * (D + Rows<T>::QK) * sizeof(T) + red_bytes;
  static bool attr_set = false;
  if (bytes > 48 * 1024 && !attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_split_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(BH, (Sq + SP_BQ - 1) / SP_BQ, splits);
  flash_split_kernel<T, D, DV><<<grid, SP_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), q_offset,
      kv_len, ws, tickets, Sq, Sk, splits, tps, scale, causal);
  return cudaGetLastError();
}

// the (D, Dv) pairs of both tensor-core routes (kernels/flash_attention.py::TC_PAIRS)
#define FLASH_TC_PAIRS(X) \
  X(32, 32) X(48, 48) X(48, 32) X(64, 64) X(80, 80) X(96, 96) X(112, 112) X(128, 128) X(192, 128)

template <typename T>
cudaError_t tc_dispatch(const void* q, const void* k, const void* v, void* out, PerRow q_offset, PerRow kv_len,
                        int BH, int Sq, int Sk, int D, int Dv, float scale, int causal, cudaStream_t s) {
#define TC_CASE(d, dv) \
  if (D == d && Dv == dv) return launch_tc<T, d, dv>(q, k, v, out, q_offset, kv_len, BH, Sq, Sk, scale, causal, s);
  FLASH_TC_PAIRS(TC_CASE)
#undef TC_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t split_dispatch(const void* q, const void* k, const void* v, void* out, PerRow q_offset, PerRow kv_len,
                           float* ws, int* tickets, int BH, int Sq, int Sk, int D, int Dv, int splits, int tps,
                           float scale, int causal, cudaStream_t s) {
#define SPLIT_CASE(d, dv)                                                                                   \
  if (D == d && Dv == dv)                                                                                  \
    return launch_split<T, d, dv>(q, k, v, out, q_offset, kv_len, ws, tickets, BH, Sq, Sk, splits, tps, scale, \
                                  causal, s);
  FLASH_TC_PAIRS(SPLIT_CASE)
#undef SPLIT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Every entry point takes q_offset and kv_len as (ptr, step, value, wide):
// an int32 or int64 device array read at element step * bh, or value where
// ptr is null (PerRow).
#define PER_ROW_ARGS \
  const void *q_offset, int qo_step, int qo_value, int qo_wide, const void *kv_len, int kvl_step, int kvl_value, \
      int kvl_wide
#define PER_ROW PerRow{q_offset, qo_step, qo_value, qo_wide}, PerRow{kv_len, kvl_step, kvl_value, kvl_wide}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* out, PER_ROW_ARGS,
                                      int BH, int Sq, int Sk, int D, int Dv, float scale, int causal, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk < 0 || D <= 0 || D > 256 || Dv <= 0 || Dv > 256 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, PER_ROW, BH, Sq, Sk, D, Dv, scale, causal, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, PER_ROW, BH, Sq, Sk, D, Dv, scale, causal, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// The tensor-core route (kernels/flash_attention.py::flash_plan), dtype 0 =
// float32, 1 = bfloat16, (D, Dv) one of FLASH_TC_PAIRS.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_tc_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                                         PER_ROW_ARGS, int BH, int Sq, int Sk, int D, int Dv, float scale, int causal,
                                         void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk < 0 || (Sq + TC_BQ - 1) / TC_BQ > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)tc_dispatch<float>(q, k, v, out, PER_ROW, BH, Sq, Sk, D, Dv, scale, causal, s);
  if (dtype == 1) return (int)tc_dispatch<__nv_bfloat16>(q, k, v, out, PER_ROW, BH, Sq, Sk, D, Dv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The split route (flash_plan's "split_kv"): the same dtypes and (D, Dv)
// pairs, `splits` ranges of `tiles_per_split` 64-key tiles.  With splits >
// 1, ws holds BH x splits x Sq x (Dv + 2) floats and tickets BH x ceil(Sq /
// 16) ints, zero before the first call (the kernel leaves them zero).
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_split_launch(int dtype, const void* q, const void* k, const void* v, void* out,
                                            PER_ROW_ARGS, float* ws, int* tickets, int BH, int Sq, int Sk, int D,
                                            int Dv, int splits, int tiles_per_split, float scale, int causal,
                                            void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk < 0 || (Sq + SP_BQ - 1) / SP_BQ > 65535 || splits < 1 || splits > MAX_SPLITS ||
      tiles_per_split < 1 || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tps = tiles_per_split;
  if (dtype == 0)
    return (int)split_dispatch<float>(q, k, v, out, PER_ROW, ws, tickets, BH, Sq, Sk, D, Dv, splits, tps, scale,
                                      causal, s);
  if (dtype == 1)
    return (int)split_dispatch<__nv_bfloat16>(q, k, v, out, PER_ROW, ws, tickets, BH, Sq, Sk, D, Dv, splits, tps,
                                              scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
