// Tensor-core and asynchronous-copy building blocks shared by the bf16
// mainloops of dip_matmul.cu, flash_attention.cu and lm_head_ce.cu (sm_90a):
//
//   * the cp.async copies of cp_async.cuh;
//   * ldmatrix x4 (plain and transposed) from padded shared rows into the
//     register fragments of mma.sync;
//   * mma.sync m16n8k16, bf16 x bf16 -> f32, and m16n8k32, s8 x s8 -> s32
//     (the int8 route of dip_matmul_q);
//   * wgmma from K-major shared memory with the 128-byte swizzle (bf16) and
//     the 64-byte swizzle (s8, whose 64-deep tile is a 64-byte row).
//
// Operand tiles live in shared memory as padded row-major arrays whose row
// stride is 16 bytes past a multiple of 128: the eight 16-byte rows one
// ldmatrix phase reads then fall on eight distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace sm90 {

// Four 8x8 b16 matrices; lane l gives the address of row (l % 8) of matrix
// l / 8, and register i receives this lane's pair of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row-major fragment) * b (32x8, column-major fragment), int8
// x int8 into exact int32 sums; the fragments hold the same bytes as the
// bf16 m16n8k16 ones (four int8 a register where bf16 has two), so the same
// ldmatrix addressing loads them from K-major rows
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------- f32 as exact bf16 parts ---
// An f32 operand on the tensor cores: each element split into three bf16
// parts by truncation, hi = x, mid = x - hi, lo = x - hi - mid (each cut
// to its top 16 bits; the subtractions are exact, and hi + mid + lo == x
// for normal f32: kernels/lm_head_ce.py::bf16_parts).  p[i] holds part i of
// x0 (low half) and x1 (high half), one register of an mma operand.
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t (&p)[3]) {
  const uint32_t a0 = __float_as_uint(x0), a1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(a0 & 0xFFFF0000u), r1 = x1 - __uint_as_float(a1 & 0xFFFF0000u);
  const uint32_t b0 = __float_as_uint(r0), b1 = __float_as_uint(r1);
  const float t0 = r0 - __uint_as_float(b0 & 0xFFFF0000u), t1 = r1 - __uint_as_float(b1 & 0xFFFF0000u);
  p[0] = __byte_perm(a0, a1, 0x7632);  // the high halves: truncation
  p[1] = __byte_perm(b0, b1, 0x7632);
  p[2] = __byte_perm(__float_as_uint(t0), __float_as_uint(t1), 0x7632);
}

// The f32 product a b of one m16n8k16 step as the six part products a_i
// b_j with i + j <= 2 (the dropped ones, i + j >= 3, are about 2^-24 of
// it): each bf16 x bf16 product is exact in f32.  The five smaller ones
// are summed into lo, smallest first, and hi_a hi_b into hi; the caller
// adds lo to hi in IEEE f32 (the tensor cores round their f32 sums toward
// zero, so keeping the large term's chain short keeps that error small).
// a[i]: part i of the A fragment, b[j]: part j of the B fragment.
__device__ __forceinline__ void mma_bf16_parts(float (&hi)[4], float (&lo)[4], const uint32_t (&a)[3][4],
                                               const uint32_t (&b)[3][2]) {
  mma_bf16(lo, a[0], b[2][0], b[2][1]);
  mma_bf16(lo, a[1], b[1][0], b[1][1]);
  mma_bf16(lo, a[2], b[0][0], b[0][1]);
  mma_bf16(lo, a[0], b[1][0], b[1][1]);
  mma_bf16(lo, a[1], b[0][0], b[0][1]);
  mma_bf16(hi, a[0], b[0][0], b[0][1]);
}

// ------------------------------------------------------------- wgmma ---
// Operands for wgmma live in shared memory K-major with the 128-byte
// swizzle: row r (an M or N index) of a 64-deep K slice is 128 bytes at r *
// 128, its 16-byte chunk j (k = 8 j .. 8 j + 7) stored at chunk j ^ (r % 8).
// Eight rows make a 1024-byte atom, so each tile starts 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128_offset(int r, int k) {  // bytes
  return (uint32_t)(r * 128 + ((((k >> 3) ^ r) & 7) << 4) + (k & 7) * 2);
}

// Matrix descriptor of such a tile: start >> 4, leading offset 16 bytes
// (unused by the swizzled K-major layout), stride 1024 bytes between 8-row
// atoms, layout 1 = 128-byte swizzle.  A 16-deep K step adds 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keeps the compiler from moving accumulator accesses across the
// asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, f32, the warpgroup's accumulator layout) += A (64 x 16) B (16 x 128),
// both K-major from shared memory; with accumulate == 0, d = A B
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same product with A from registers (4 per thread: the warp's 16 rows
// of the warpgroup's 64 in mma.sync's m16n8k16 A layout, rows 16 w + lane /
// 4 (+ 8), columns 2 (lane % 4) (+ 8)).  The registers are read after the
// issue: keep them unchanged, and alive (fence_regs), until the wait.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The int8 operands: a 64-deep K slice of a row (an M or N index) is 64
// bytes at r * 64, its 16-byte chunk j (k = 16 j .. 16 j + 15) stored at
// chunk j ^ ((r / 2) % 4): the 64-byte swizzle, whose eight-row atom is 512
// bytes (tiles start 1024-byte aligned).
__device__ __forceinline__ uint32_t sw64_offset(int r, int kb) {  // bytes; kb: byte of the row
  return (uint32_t)(r * 64 + ((((kb >> 4) ^ (r >> 1)) & 3) << 4) + (kb & 15));
}

// Matrix descriptor of such a tile: start >> 4, leading offset 16 bytes
// (unused by the swizzled K-major layout), stride 512 bytes between 8-row
// atoms, layout 2 = 64-byte swizzle.  A 32-deep K step adds 32 bytes.
__device__ __forceinline__ uint64_t sw64_desc(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// d (64 x 128, s32, the warpgroup's accumulator layout) += A (64 x 32) B (32 x
// 128), int8, both K-major from shared memory (8-bit wgmma has no transpose)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


}  // namespace sm90
