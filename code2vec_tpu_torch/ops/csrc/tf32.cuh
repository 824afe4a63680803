// fp32 products as three TF32 terms on the tensor cores (sm_90a), shared
// by the fp32 routes of ce.cu, encode.cu and ragged_bwd.cu: the card's
// counterpart of the TPU's Precision.HIGHEST.
//
// Each fp32 operand x is split as hi = tf32(x), lo = tf32(x - hi) (both by
// cvt.rna: to nearest, ties away from zero; x - hi is exact in fp32), and
// a . b runs as lo_a hi_b + hi_a lo_b + hi_a hi_b on
// mma.sync.m16n8k8.tf32 with fp32 accumulation (lo_a lo_b, ~2^-22 of the
// product, is dropped). The tensor cores have been measured, on earlier
// parts, to truncate as they accumulate, so the kernels sum 32 of K at a
// time in a fresh accumulator and add those sums with FADD.
//
// Fragments (m16n8k8, g = lane / 4, t = lane % 4): A a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k = t, n = g), b1
// (k = t + 4, n = g); C c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, ...). A
// K-major operand in shared memory gives them by ldmatrix (ldsm_x4, 8 x 4
// fp32 matrices as b16 8 x 8); an MN-major one by 32-bit loads, free of
// bank conflicts when its row stride is 8 modulo 32 words.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace t32 {

constexpr int kK = 32;               // K of one chunk summed in a fresh acc
constexpr int kPad = 4;              // floats of padding a K-major row
constexpr int kLd = kK + kPad;       // K-major row stride of a 32-wide slice

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_frag(const uint32_t (&raw)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(raw[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b over one k8 step in three TF32 terms, the small ones first
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// four 8 x 4 fp32 matrices (b16 8 x 8) from shared memory: lane l gives
// row l % 8 of matrix l / 8 (16-byte aligned); register j gets word
// lane % 4 of row lane / 4 of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// the A fragment at (m0, k0) of a K-major tile (row stride ld floats):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
__device__ __forceinline__ void load_a_kmajor(uint32_t (&a)[4],
                                              const float* base, int ld,
                                              int m0, int k0) {
  const int j = (threadIdx.x & 31) >> 3;
  const int i = threadIdx.x & 7;
  ldsm_x4(a, base + (m0 + i + 8 * (j & 1)) * ld + k0 + 4 * (j >> 1));
}

// the B fragments of two n8 tiles, rows n0 .. n0 + 15 of a K-major (n, k)
// tile, at k0: b[0], b[1] (k = t, t + 4) of tile n0, b[2], b[3] of n0 + 8
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[4],
                                              const float* base, int ld,
                                              int n0, int k0) {
  const int j = (threadIdx.x & 31) >> 3;
  const int i = threadIdx.x & 7;
  ldsm_x4(b, base + (n0 + i + 8 * (j >> 1)) * ld + k0 + 4 * (j & 1));
}

// the A fragment at (m0, k0) of an MN-major tile (k rows of ld floats, m
// contiguous), by 32-bit loads
__device__ __forceinline__ void load_a_mnmajor(uint32_t (&a)[4],
                                               const float* base, int ld,
                                               int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* p = base + (k0 + t) * ld + m0 + g;
  a[0] = __float_as_uint(p[0]);
  a[1] = __float_as_uint(p[8]);
  a[2] = __float_as_uint(p[4 * ld]);
  a[3] = __float_as_uint(p[4 * ld + 8]);
}

// the B fragment of one n8 tile at (n0, k0) of an MN-major tile (k rows of
// ld floats, n contiguous), by 32-bit loads
__device__ __forceinline__ void load_b_mnmajor(uint32_t& b0, uint32_t& b1,
                                               const float* base, int ld,
                                               int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* p = base + (k0 + t) * ld + n0 + g;
  b0 = __float_as_uint(p[0]);
  b1 = __float_as_uint(p[4 * ld]);
}

// rows [row0, row0 + rows) x columns [col0, col0 + cols) of a row-major
// fp32 matrix (row stride ld_src floats, 16-byte aligned rows) into
// shared rows of ld_dst floats, 16 bytes a cp.async by the CTA's THREADS
// threads; rows at or past n_rows read as zero. Started, not waited for.
// Row: int where the row count fits (the CE kernels), long long for the
// streams of any length.
template <int THREADS, typename Row>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          long long ld_src, Row n_rows,
                                          Row row0, int rows, int col0,
                                          int cols, float* dst, int ld_dst) {
  const int c4 = cols >> 2;
  for (int q = threadIdx.x; q < rows * c4; q += THREADS) {
    const int r = q / c4;
    const int c = 4 * (q - r * c4);
    const bool in = row0 + r < n_rows;
    c2v::cp_async16(dst + r * ld_dst + c,
                    src + (in ? row0 + r : 0) * ld_src + col0 + c, in);
  }
}

// cp.async reads an fp32 operand 16 bytes at a time
__host__ __forceinline__ bool misaligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace t32
