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
// Bound on the card: by the operations, 2 T D V.  Two mainloops, both on
// the tensor cores (no operand is rounded to TF32):
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
//   * f32 x f32 (the first training step in f32 compute):
//     lm_head_f32_kernel splits x as well, and x . w is the six part
//     products x_i w_j with i + j <= 2 (the dropped ones are about 2^-24 of
//     the product; kernels/_bf16_parts.py::split_matmul is this arithmetic
//     in torch), 6 * 2 T D V at 989 TFLOP/s against 2 T D V at the 67 of
//     f32 FMAs.  The same block and fold as above; a 32-deep step, x split
//     in wgmma's A registers and W in shared memory (see the mainloop).  Grid
//     order: blockIdx.x, the fastest, runs over the token blocks, so a wave
//     of 132 blocks is ~4 vocab splits x all 32 token blocks of the
//     training batch (T = 4092): a W tile is read by the split's 32 token
//     blocks at about the same time, and a step's x tile by the ~4 splits
//     in flight; the f32 x (67 MB) does not stay in the 50 MB L2 from one
//     vocab tile to the next.
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

// Fold a vocab tile's logits into the running (m, l, label) of this
// thread's two token rows.  tot is the warpgroup's 64 x 128 accumulator
// layout: element 4 j + 2 h + e is token row 16 warp + lane / 4 + 8 h and
// vocab column c_tile + 8 j + 2 (lane % 4) + e; each quad of lanes holds
// two token rows, reduced with shuffles as flash attention does.
__device__ __forceinline__ void fold(const float (&tot)[64], int c_tile, int vocab, const int (&lab)[2],
                                     float (&m)[2], float (&l)[2], float (&hit)[2]) {
  const int lane = threadIdx.x & 31, c0 = c_tile + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c0 + 8 * j + e < vocab) mx = fmaxf(mx, tot[4 * j + 2 * h + e]);
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
        if (col < vocab) ps += expf(z - m_new);  // masked lanes add 0, never exp(0)
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

// this thread's two token rows of the accumulator layout, and their labels
// (-1, like -100, never equals a column)
__device__ __forceinline__ void token_rows(const Args& a, int t0, int (&row)[2], int (&lab)[2]) {
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = t0 + wg * 64 + 16 * warp + (lane >> 2) + 8 * h;
    lab[h] = row[h] < a.T ? a.labels[row[h]] : -1;
  }
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
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, wt = tid & 127;
  const int t0 = blockIdx.x * BT, s = blockIdx.y;
  const int T = a.T, D = a.D, V = a.V;
  int v_begin, v_end;
  split_range(a, s, v_begin, v_end);
  const int kt_n = D / BK, n = max(0, v_end - v_begin) * kt_n;  // steps: (vocab tile, 64-deep K slice)
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const unsigned char* w = static_cast<const unsigned char*>(a.w);

  int row[2], lab[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, hit[2] = {0.0f, 0.0f};
  token_rows(a, t0, row, lab);

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
      fold(tot, (v_begin + i / kt_n) * BV, a.vocab, lab, m, l, hit);
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

// ------------------------------------ f32 x f32: tensor-core mainloop ---
// Both operands are f32 and both are split into three bf16 parts
// (sm90::split_bf16x3: exact).  A step is 32 deep: per stage the raw f32 x
// tile (128 rows of 32, rows padded to 160 bytes so that the 64-bit
// fragment reads of a half warp fall on distinct banks) and raw W tile (32
// rows of 128) ride a 3-slot cp.async ring.  Each warp reads its 16 x rows
// of the step straight into wgmma's A registers and splits them there (x
// parts never reach shared memory, and wgmma reads only W from it); while a
// step's products run the block splits the next step's W into its parts,
// transposed to K-major with the 64-byte swizzle as the bf16-x route does.
// Shared memory: 3 x (20 + 16) KB of raw tiles + 2 x 24 KB of W parts = 156
// KB.  A step is the six part products x_i w_j, i + j <= 2, smallest first
// (12 wgmma m64n128k16 per warpgroup, as many as the bf16-x route's step of
// 64 with three W parts), started from zero and added to the f32 register
// total in IEEE adds.
constexpr int FK = 32, RAW_SLOTS = 3;

struct F32Cfg {
  static constexpr int X_ROW = (FK + 8) * 4;                   // raw x row (bytes), padded
  static constexpr int X_RAW = BT * X_ROW;                     // raw x tile, row-major [t][k]
  static constexpr int W_ROW = BV * 4;                         // raw W row (bytes)
  static constexpr int W_RAW = FK * W_ROW;                     // raw W tile, row-major [k][v]
  static constexpr int B_BYTES = BV * FK * 2;                  // one W part, K-major [v][k], 64B swizzle
  static constexpr int BUF = 3 * B_BYTES;                      // W parts 0..2
  static constexpr size_t SMEM = (size_t)RAW_SLOTS * (X_RAW + W_RAW) + 2 * BUF + 1024;
  static_assert((RAW_SLOTS * (X_RAW + W_RAW)) % 1024 == 0 && B_BYTES % 1024 == 0, "1024-byte aligned parts");
};

__global__ void __launch_bounds__(THREADS) lm_head_f32_kernel(const Args a) {
  using C = F32Cfg;
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* xraw = smem;                                // [RAW_SLOTS][X_RAW]
  unsigned char* wraw = xraw + RAW_SLOTS * C::X_RAW;         // [RAW_SLOTS][W_RAW]
  unsigned char* pbuf = wraw + RAW_SLOTS * C::W_RAW;         // [2][BUF]
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int t0 = blockIdx.x * BT, s = blockIdx.y;
  const int T = a.T, D = a.D, V = a.V;
  int v_begin, v_end;
  split_range(a, s, v_begin, v_end);
  const int kt_n = D / FK, n = max(0, v_end - v_begin) * kt_n;  // steps: (vocab tile, 32-deep K slice)
  const float* x = static_cast<const float*>(a.x);
  const unsigned char* w = static_cast<const unsigned char*>(a.w);

  int row[2], lab[2];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, hit[2] = {0.0f, 0.0f};
  token_rows(a, t0, row, lab);

  // step i's copies: 4 of the 1024 16-byte chunks of each raw tile
  auto issue = [&](int i) {
    const int k0 = (i % kt_n) * FK, c0 = (v_begin + i / kt_n) * BV;
    unsigned char* xs = xraw + (i % RAW_SLOTS) * C::X_RAW;
    unsigned char* ws = wraw + (i % RAW_SLOTS) * C::W_RAW;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + THREADS * j, r = e >> 3, cc = e & 7, gt = t0 + r;
      sm90::cp_async16(xs + r * C::X_ROW + 16 * cc, x + (size_t)min(gt, T - 1) * D + k0 + 4 * cc, gt < T);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + THREADS * j, kr = e >> 5, cb = (e & 31) * 16;
      sm90::cp_async16(ws + kr * C::W_ROW + cb, w + ((size_t)(k0 + kr) * V + c0) * 4 + cb, true);
    }
  };

  // step i's raw W -> its parts in buffer i & 1: 8-deep chunk (tid / 32) % 4
  // of columns lane + 32 (tid / 128) and + 64; eight rows read by 32
  // neighbouring lanes, three 16-byte chunks written (each quarter warp's
  // chunks on eight distinct swizzle positions)
  auto convert = [&](int i) {
    const float* ws = reinterpret_cast<const float*>(wraw + (i % RAW_SLOTS) * C::W_RAW);
    unsigned char* dst = pbuf + (i & 1) * C::BUF;
    const int kc = (tid >> 5) & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * (wg + 2 * q);
      uint32_t p[3][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t pr[3];
        sm90::split_bf16x3(ws[(8 * kc + 2 * u) * BV + c], ws[(8 * kc + 2 * u + 1) * BV + c], pr);
        p[0][u] = pr[0], p[1][u] = pr[1], p[2][u] = pr[2];
      }
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
        *reinterpret_cast<uint4*>(dst + pt * C::B_BYTES + sm90::sw64_offset(c, 16 * kc)) =
            make_uint4(p[pt][0], p[pt][1], p[pt][2], p[pt][3]);
    }
  };

  // step i's A registers: this warp's 16 x rows of the two 16-deep halves,
  // in mma.sync's m16n8k16 A layout, split into parts: xa[kk][part][reg]
  uint32_t xa[FK / 16][3][4];
  auto load_a = [&](int i) {
    const float* xs = reinterpret_cast<const float*>(xraw + (i % RAW_SLOTS) * C::X_RAW) +
                      (wg * 64 + 16 * warp + (lane >> 2)) * (C::X_ROW / 4) + 2 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(xs + 8 * (r & 1) * (C::X_ROW / 4) + 16 * kk + 8 * (r >> 1));
        uint32_t pr[3];
        sm90::split_bf16x3(v.x, v.y, pr);
        xa[kk][0][r] = pr[0], xa[kk][1][r] = pr[1], xa[kk][2][r] = pr[2];
      }
  };

  float acc[64], tot[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = tot[e] = 0.0f;

  // Step i: stage i's x into registers, then its products (from zero) while
  // stage i + 1's W is split and stage i + 3 is copied into the raw slots of
  // stage i (its W was split in the step before, its x read this step, both
  // before the barrier that precedes the copy); then the products land and
  // are added to the total (folded at a vocab tile's last step).  Buffer
  // (i + 1) & 1 was last read by a product that landed before the barrier
  // ending the step before.
#pragma unroll
  for (int j = 0; j < RAW_SLOTS; ++j) {
    if (j < n) issue(j);
    sm90::cp_async_commit();
  }
  sm90::cp_async_wait<RAW_SLOTS - 1>();  // stage 0
  __syncthreads();
  if (n > 0) convert(0);
  sm90::fence_proxy_async();
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const unsigned char* bp = pbuf + (i & 1) * C::BUF;
    load_a(i);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    // x_i w_j: (0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)
    constexpr int PX[6] = {0, 1, 2, 0, 1, 0}, PW[6] = {2, 1, 0, 1, 0, 0};
#pragma unroll
    for (int pr = 0; pr < 6; ++pr)
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        sm90::wgmma_m64n128k16_rs(acc, xa[kk][PX[pr]], sm90::sw64_desc(bp + PW[pr] * C::B_BYTES) + 2 * kk,
                                  pr > 0 || kk > 0);
    sm90::wgmma_commit();
    if (i + 1 < n) {
      sm90::cp_async_wait<RAW_SLOTS - 2>();  // this thread's copies of stage i + 1
      __syncthreads();                        // everyone's; every warp has read stage i's x
      if (i + RAW_SLOTS < n) issue(i + RAW_SLOTS);
      sm90::cp_async_commit();
      convert(i + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk)
#pragma unroll
      for (int pt = 0; pt < 3; ++pt) sm90::fence_regs(xa[kk][pt]);  // read by the products until here
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e] += acc[e];
    if (i % kt_n == kt_n - 1) {
      fold(tot, (v_begin + i / kt_n) * BV, a.vocab, lab, m, l, hit);
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

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; the pairs taken, all on
// the tensor cores, are (f32, f32) with three bf16 parts of each operand
// and six part products, (bf16, f32) with three bf16 parts of each W
// element and (bf16, bf16) with one.  part is (3, splits, T) f32 scratch;
// logz and lab are (T,) f32.  Returns a cudaError_t (0 on success).
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
    err = launch_main(lm_head_f32_kernel, F32Cfg::SMEM, a, s);
  else if (x_dtype == 1 && w_dtype == 0)
    err = launch_tc<float>(a, s);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch_tc<__nv_bfloat16>(a, s);
  if (err != cudaSuccess) return (int)err;
  merge_splits_kernel<<<(a.T + 255) / 256, 256, 0, s>>>(a.part, logz, lab, a.T, a.splits);
  return (int)cudaGetLastError();
}
