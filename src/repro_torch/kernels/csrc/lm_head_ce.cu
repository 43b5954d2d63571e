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
// A split that lies wholly in the vocab padding computes nothing and writes
// m_s = -1e30, l_s = 0, so it adds nothing to the merge; masked lanes of a
// live tile add p = 0 to the sum, never exp(z - m) = 1.
//
// Bound on the card: by the operations, 2 T D V.  Two mainloops:
//
//   * bf16 x (the training pair, bf16 x with the f32 natural head, and bf16
//     x bf16): lm_head_tc_kernel puts the products on the tensor cores.
//     Each f32 W element is split in the conversion pass into bf16 parts,
//     hi = w truncated to bf16, mid = (w - hi) truncated, lo = w - hi - mid
//     (exact: hi + mid + lo == w for normal f32), and x . w is taken as
//     x.lo + x.mid + x.hi: every part product of the exactly-bf16 x is exact
//     in f32, so the sum is f32-accurate with no operand rounded to TF32.
//     Three parts triple the products, 3 * 2 T D V at 989 TFLOP/s, against
//     2 T D V at the 67 TFLOP/s of f32 on the CUDA cores.  A bf16 head is
//     its own single part.  Block: 128 tokens (two warpgroups of 64 rows)
//     by 128 vocab columns, wgmma m64n128k16 with x and the parts both
//     K-major in shared memory (128-byte swizzle).  x (3 slots) and the raw
//     W tile (2 slots) ride cp.async rings; while a step's products run the
//     block converts the next step's W into the parts, transposing it to
//     K-major (each thread gathers 16-byte operand chunks of one column from
//     eight rows).  Each step's products start from zero and are added to
//     an f32 register total once they land (the tensor cores round their
//     f32 sums toward zero; re-accumulating in IEEE adds every 64-deep step
//     keeps that error to 12 products).  After a vocab tile's last step
//     the total is folded into the running (m, l, label) straight from the
//     registers: each quad of lanes holds two token rows, reduced with
//     shuffles as flash attention does.  Consecutive blocks are the token
//     blocks of one split, so blocks in flight share W tiles through L2 (x,
//     33.5 MB at the training shape, stays there too).
//   * f32 x f32 (on no main path; the f32 first step of training uses it)
//     keeps IEEE FMAs on the CUDA cores (lm_head_ce_f32_kernel): per vocab
//     tile the 128x128 tile of z over the whole of D, staged in shared
//     memory and folded by one warp per 16 rows.
//
// Rows past T are masked (zero x, nothing written); a label of -100 never
// equals a column.  Offsets into W and x are 64-bit: the (4096, 129024) f32
// head of llama3-8b is 2.1 GB.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int BT = 128;           // tokens per block
constexpr int BV = 128;           // vocab columns per tile
constexpr int THREADS = 256;      // eight warps
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* x;       // (T, D) row-major
  const void* w;       // (D, V) row-major
  const int* labels;   // (T,)
  float* part;         // (3, splits, T): m, l, label logit of each split
  int T, D, V, vocab, tiles_per_split, splits;
};

// The vocab tiles [begin, end) of split s; tiles wholly past the vocab are
// skipped (they add nothing).
__device__ __forceinline__ void split_range(const Args& a, int s, int& begin, int& end) {
  const int real = (a.vocab + BV - 1) / BV;
  begin = s * a.tiles_per_split;
  end = min(min(begin + a.tiles_per_split, a.V / BV), real);
}

__device__ __forceinline__ void write_partial(const Args& a, int s, int row, float m, float l, float lab) {
  const size_t plane = (size_t)a.splits * a.T, at = (size_t)s * a.T + row;
  a.part[at] = m;
  a.part[plane + at] = l;
  a.part[2 * plane + at] = lab;
}

// ---------------------------------------- bf16 x: tensor-core mainloop ---
constexpr int BK = 64;            // contraction step: one 128-byte swizzle row of bf16
constexpr int X_SLOTS = 3, W_SLOTS = 2;

template <typename TW>
struct TcCfg {
  static constexpr int PARTS = sizeof(TW) == 4 ? 3 : 1;        // bf16 parts of a W element: hi, mid, lo
  static constexpr int X_BYTES = BT * BK * 2;                  // x tile, K-major, 128B swizzle
  static constexpr int W_ROW = BV * (int)sizeof(TW);           // raw W tile row (bytes)
  static constexpr int W_BYTES = BK * W_ROW;                   // raw W tile, row-major [k][v]
  static constexpr int B_BYTES = BV * BK * 2;                  // one part, K-major [v][k], 128B swizzle
  static constexpr int B_BUF = PARTS * B_BYTES;
  static constexpr size_t SMEM = (size_t)X_SLOTS * X_BYTES + W_SLOTS * W_BYTES + 2 * B_BUF + 1024;
  static constexpr int X_CHUNKS = 64 * BK / 8 / 128;           // 4, of the thread's own warpgroup's rows
  static constexpr int W_CHUNKS = W_BYTES / 16 / THREADS;      // 8 (f32) or 4 (bf16)
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "1024-byte aligned tiles");
};

// W element as the bits of an f32 (a bf16 widens exactly)
__device__ __forceinline__ uint32_t w_bits(const float* row, int v) { return __float_as_uint(row[v]); }
__device__ __forceinline__ uint32_t w_bits(const __nv_bfloat16* row, int v) {
  return (uint32_t)reinterpret_cast<const unsigned short*>(row)[v] << 16;
}

template <typename TW>
__global__ void __launch_bounds__(THREADS) lm_head_tc_kernel(const Args a) {
  using C = TcCfg<TW>;
  constexpr int PARTS = C::PARTS;
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* xring = smem;                               // [X_SLOTS][X_BYTES]
  unsigned char* wring = xring + X_SLOTS * C::X_BYTES;       // [W_SLOTS][W_BYTES]
  unsigned char* bbuf = wring + W_SLOTS * C::W_BYTES;        // [2][PARTS][B_BYTES]: part 0 hi, 1 mid, 2 lo
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3, wt = tid & 127;
  const int t0 = blockIdx.x * BT, s = blockIdx.y;
  const int T = a.T, D = a.D, V = a.V;
  int v_begin, v_end;
  split_range(a, s, v_begin, v_end);
  const int kt_n = D / BK, n = max(0, v_end - v_begin) * kt_n;  // steps: (vocab tile, 64-deep K slice)
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const unsigned char* w = static_cast<const unsigned char*>(a.w);

  // this thread's two token rows of the accumulator layout, and their labels
  int row[2], lab[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, hit[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = t0 + wg * 64 + 16 * warp + (lane >> 2) + 8 * h;
    lab[h] = row[h] < T ? a.labels[row[h]] : -1;  // -1 (and -100) never equal a column
  }

  // step i's copies: this warpgroup's 64 x rows (chunk wt % 8 of rows
  // (wt + 128 j) / 8) and 1/256 of the raw W tile
  const int xkc = wt & 7;
  auto issue = [&](int i) {
    const int k0 = (i % kt_n) * BK, c0 = (v_begin + i / kt_n) * BV;
    unsigned char* xs = xring + (i % X_SLOTS) * C::X_BYTES;
#pragma unroll
    for (int j = 0; j < C::X_CHUNKS; ++j) {
      const int r = wg * 64 + ((wt + 128 * j) >> 3), gt = t0 + r;
      sm90::cp_async16(xs + sm90::sw128_offset(r, 8 * xkc), x + (size_t)min(gt, T - 1) * D + k0 + 8 * xkc, gt < T);
    }
    unsigned char* ws = wring + (i % W_SLOTS) * C::W_BYTES;
#pragma unroll
    for (int j = 0; j < C::W_CHUNKS; ++j) {
      const int v = tid + THREADS * j, kr = v / (C::W_ROW / 16), cb = (v % (C::W_ROW / 16)) * 16;
      sm90::cp_async16(ws + kr * C::W_ROW + cb, w + ((size_t)(k0 + kr) * V + c0) * sizeof(TW) + cb, true);
    }
  };

  // step i's raw W -> its parts in buffer i & 1: thread (lane, warp) builds
  // the 16-byte chunk k = 8 warp .. + 7 of columns lane + 32 q of every
  // part; the 32 lanes read 32 neighbouring columns of one row, and each
  // quarter warp's chunks land on eight distinct swizzle positions
  auto convert = [&](int i) {
    const TW* ws = reinterpret_cast<const TW*>(wring + (i % W_SLOTS) * C::W_BYTES);
    unsigned char* dst = bbuf + (i & 1) * C::B_BUF;
    const int kc = tid >> 5;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = lane + 32 * q;
      uint32_t p[PARTS][8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t b = w_bits(ws + (8 * kc + e) * BV, v);
        p[0][e] = b & 0xFFFF0000u;
        if constexpr (PARTS == 3) {
          const float r1 = __uint_as_float(b) - __uint_as_float(p[0][e]);
          p[1][e] = __float_as_uint(r1) & 0xFFFF0000u;
          p[2][e] = __float_as_uint(r1 - __uint_as_float(p[1][e])) & 0xFFFF0000u;
        }
      }
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt) {
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __byte_perm(p[pt][2 * e], p[pt][2 * e + 1], 0x7632);
        *reinterpret_cast<uint4*>(dst + pt * C::B_BYTES + sm90::sw128_offset(v, 8 * kc)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  };

  // accumulator 4 j + e: token row 16 warp + lane / 4 (+ 8 for e >= 2),
  // vocab column 8 j + 2 (lane % 4) + (e & 1) of the warpgroup's 64 x 128
  float acc[64], tot[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = tot[e] = 0.0f;

  auto fold = [&](int vt) {
    const int c0 = vt * BV + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * j + e < a.vocab) mx = fmaxf(mx, tot[4 * j + 2 * h + e]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float ps = 0.0f, at = 0.0f;
#pragma unroll
      for (int j = 0; j < BV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + e;
          const float z = tot[4 * j + 2 * h + e];
          if (col < a.vocab) ps += expf(z - m_new);  // masked lanes add 0, never exp(0)
          if (col == lab[h]) at += z;
        }
      ps += __shfl_xor_sync(FULL, ps, 1);
      ps += __shfl_xor_sync(FULL, ps, 2);
      at += __shfl_xor_sync(FULL, at, 1);
      at += __shfl_xor_sync(FULL, at, 2);
      l[h] = l[h] * expf(m[h] - m_new) + ps;
      m[h] = m_new;
      hit[h] += at;
    }
  };

  // Step i: the products of stage i (from zero) while stage i + 1's W is
  // converted and stage i + 2 is copied; then the products land and are
  // added to the total (folded at a vocab tile's last step).  Every slot a
  // step refills was last read by a product that landed before the barrier
  // ending the step before.
  if (n > 0) issue(0);
  sm90::cp_async_commit();
  if (n > 1) issue(1);
  sm90::cp_async_commit();
  sm90::cp_async_wait<1>();  // stage 0
  __syncthreads();
  if (n > 0) convert(0);
  sm90::fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const uint64_t da = sm90::sw128_desc(xring + (i % X_SLOTS) * C::X_BYTES + wg * 64 * 128);
    const unsigned char* bp = bbuf + (i & 1) * C::B_BUF;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int pt = PARTS - 1; pt >= 0; --pt)  // smallest part first
        sm90::wgmma_m64n128k16(acc, da + 2 * kk, sm90::sw128_desc(bp + pt * C::B_BYTES) + 2 * kk,
                               kk > 0 || pt < PARTS - 1);
    sm90::wgmma_commit();
    if (i + 1 < n) {
      sm90::cp_async_wait<0>();  // this thread's copies of stage i + 1
      __syncthreads();           // everyone's
      if (i + 2 < n) issue(i + 2);
      sm90::cp_async_commit();
      convert(i + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] += acc[e];
    if (i % kt_n == kt_n - 1) {
      fold(v_begin + i / kt_n);
#pragma unroll
      for (int e = 0; e < 64; ++e) tot[e] = 0.0f;
    }
    sm90::fence_proxy_async();
    __syncthreads();
  }
  sm90::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if ((lane & 3) == 0 && row[h] < T) write_partial(a, s, row[h], m[h], l[h], hit[h]);
}

// -------------------------------------- f32 x f32: CUDA-core mainloop ---
constexpr int FBK = 32;           // contraction step
constexpr int ZSTRIDE = BV + 4;   // staged f32 logit row
constexpr int FSTRIDE = BT + 4;   // f32 operand rows (x transposed, and W)

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

// xs holds the x tile transposed (xs[k][t]), ws the W tile (ws[k][v]);
// thread (ty, tx) of a 16x16 grid owns rows {4ty+i, 64+4ty+i} and columns
// {4tx+j, 64+4tx+j}.
__device__ __forceinline__ void fma_logit_tile(const Args& a, float* xs, float* ws, float* zs, int t0, int c0) {
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < a.D; k0 += FBK) {
    __syncthreads();  // the previous step's tiles are consumed
    {  // x: row r = tid % 128, 16 consecutive k from kh
      const int r = tid % BT, kh = (tid / BT) * 16, gt = t0 + r;
      float v[16];
      if (gt < a.T) {
        const float* src = x + (size_t)gt * a.D + k0 + kh;
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = src[i];
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
    for (int k = 0; k < FBK; ++k) {
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

__global__ void __launch_bounds__(THREADS) lm_head_ce_f32_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);
  float* xs = zs + BT * ZSTRIDE;
  const int t0 = blockIdx.x * BT, s = blockIdx.y;
  const int lane = threadIdx.x % 32, row = t0 + (threadIdx.x / 32) * 16 + lane;
  int v_begin, v_end;
  split_range(a, s, v_begin, v_end);
  // lane r < 16 carries row warp*16 + r; -1 (never a column) past T
  const int lab_lane = (lane < 16 && row < a.T) ? a.labels[row] : -1;
  float m = NEG_INF, l = 0.0f, acc_lab = 0.0f;

  for (int vt = v_begin; vt < v_end; ++vt) {
    const int c0 = vt * BV;
    fma_logit_tile(a, xs, xs + FBK * FSTRIDE, zs, t0, c0);
    __syncthreads();  // zs complete
    fold_tile(zs, c0, a.vocab, lab_lane, m, l, acc_lab);
    __syncthreads();  // zs consumed before the next tile overwrites it
  }
  if (lane < 16 && row < a.T) write_partial(a, s, row, m, l, acc_lab);
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

template <typename K>
cudaError_t launch_main(K kernel, size_t bytes, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.T + BT - 1) / BT, a.splits), THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  return launch_main(lm_head_tc_kernel<TW>, TcCfg<TW>::SMEM, a, stream);
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; the pairs taken are
// (f32, f32) on the CUDA cores, and (bf16, f32) with three bf16 parts of
// each W element and (bf16, bf16) with one on the tensor cores.  part is
// (3, splits, T) f32 scratch; logz and lab are (T,) f32.  Returns a
// cudaError_t (0 on success).
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
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_main(lm_head_ce_f32_kernel, (size_t)(BT * ZSTRIDE + 2 * FBK * FSTRIDE) * sizeof(float), a, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_tc<float>(a, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch_tc<__nv_bfloat16>(a, s);
  if (err != cudaSuccess) return (int)err;
  merge_splits_kernel<<<(a.T + 255) / 256, 256, 0, s>>>(a.part, logz, lab, a.T, a.splits);
  return (int)cudaGetLastError();
}
