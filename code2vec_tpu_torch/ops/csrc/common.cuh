// Device helpers shared by the hand-written Hopper kernels (sm_90a):
//
// - the fused gather of packed context rows [tok[src]; path[pth]; tok[tgt]]
//   into shared memory, reading fp32 or bf16 table rows and rounding each
//   element to the compute type on load, with the dropout keep mask applied
//   (kept elements divided by the keep rate, dropped ones zero);
// - Tile<T, BM, BN, WM>: a BM x BN fp32 accumulator spread over the 256
//   threads of a CTA, and the product C += A . B^T on operands staged in
//   shared memory. bf16 runs on the tensor cores (mma.sync m16n8k16, bf16
//   in, fp32 accumulation; the eight warps laid out WM x 8/WM); fp32 runs
//   on the CUDA cores (exact fp32 FMAs; the tensor cores have no exact
//   fp32 product), thread (ty, tx) of 16 x 16 owning rows ty + 16 i and
//   columns tx + 16 j.
//
// Operand layouts: A is (BM x K) with K contiguous (row stride lda). B is
// (BN x K) with K contiguous (KN = false), or (K x BN) with BN contiguous
// (KN = true), row stride ldb. Shared rows are padded (Pad<T>) so the
// fragment loads are free of bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace c2v {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // threads of every CTA of the train kernels
constexpr float kNeg = -1e30f;     // finite -inf stand-in, as in the TPU kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
struct Conv;
template <>
struct Conv<float> {
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <>
struct Conv<bf16> {
  static __device__ __forceinline__ bf16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  return Conv<T>::from(x);
}

// x rounded to T and back: the value a T tensor would hold
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// padding of a shared-memory row, in elements: an odd fp32 stride spreads
// the FMA loads over the banks; bf16 rows stay 16-byte aligned and put the
// eight mma row groups on distinct banks
template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int value = 1;
};
template <>
struct Pad<bf16> {
  static constexpr int value = 8;
};

__device__ __forceinline__ long long clamp_row(int idx, long long rows) {
  // indices come from the vocabulary lookup; the clamp keeps a bad index
  // from reading outside the table
  long long r = idx < 0 ? 0 : static_cast<long long>(idx);
  return r < rows ? r : rows - 1;
}

// The (src, pth, tgt) indices of packed slots [base, base + nt) and their
// validity (any part not PAD) into shared memory; rows nt..TILE-1 get the
// PAD triple and validity 0.
template <int TILE>
__device__ __forceinline__ void stage_triples(const int* __restrict__ ctx,
                                              int base, int nt,
                                              int token_pad, int path_pad,
                                              int* idx_s, int* valid_s) {
  const int j = threadIdx.x;
  if (j < TILE) {
    int s = token_pad, p = path_pad, g = token_pad, valid = 0;
    if (j < nt) {
      const int* c = ctx + 3LL * (base + j);
      s = c[0];
      p = c[1];
      g = c[2];
      valid = (s != token_pad) | (g != token_pad) | (p != path_pad);
    }
    idx_s[3 * j] = s;
    idx_s[3 * j + 1] = p;
    idx_s[3 * j + 2] = g;
    valid_s[j] = valid;
  }
}

// four consecutive elements of a table row, as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// four values into a shared row: bf16 as one 8-byte store (rows and
// columns are multiples of 4 elements), fp32 one by one (odd strides)
__device__ __forceinline__ void store4(float* p, float4 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The rounding of one gathered element: the table value rounded to T; with
// a keep mask, kept values divided by the keep rate (rounded to T, as a T
// tensor divided by the rate rounds) and dropped ones zero.
template <typename T>
__device__ __forceinline__ float4 round_keep(float4 v, const uint8_t* keep,
                                             float rate_t) {
  v.x = round_to<T>(v.x);
  v.y = round_to<T>(v.y);
  v.z = round_to<T>(v.z);
  v.w = round_to<T>(v.w);
  if (keep != nullptr) {
    const uchar4 k = *reinterpret_cast<const uchar4*>(keep);
    v.x = k.x ? round_to<T>(v.x / rate_t) : 0.f;
    v.y = k.y ? round_to<T>(v.y / rate_t) : 0.f;
    v.z = k.z ? round_to<T>(v.z / rate_t) : 0.f;
    v.w = k.w ? round_to<T>(v.w / rate_t) : 0.f;
  }
  return v;
}

// Fused gather of `rows` context rows into e_s (row stride ld): row t is
// slot `slot0 + t` of the packed stream with triple idx_s[3t..3t+2], rows
// t >= nt are zero. keep, when not null, is the (N, K) keep mask of the
// whole stream (K = 2 dt + dp). Consecutive threads take consecutive
// 4-element chunks; each keeps eight loads in flight before it stores.
template <typename TT, typename T>
__device__ __forceinline__ void gather_rows(
    const TT* __restrict__ tok, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_rows, int dt, int dp,
    const int* idx_s, int rows, int nt, long long slot0,
    const uint8_t* __restrict__ keep, float keep_rate, T* e_s, int ld) {
  const int K = 2 * dt + dp;
  const int k4 = K / 4;                      // chunks per row
  const int total = rows * k4;
  const float rate_t = round_to<T>(keep_rate);
  for (int q0 = threadIdx.x; q0 < total; q0 += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + i * blockDim.x;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < total) {
        const int t = q / k4;
        const int k = 4 * (q - t * k4);
        if (t < nt) {
          if (k < dt) {
            v[i] = load4(tok + clamp_row(idx_s[3 * t], tok_rows) * dt + k);
          } else if (k < dt + dp) {
            v[i] = load4(path_tab
                         + clamp_row(idx_s[3 * t + 1], path_rows) * dp
                         + (k - dt));
          } else {
            v[i] = load4(tok + clamp_row(idx_s[3 * t + 2], tok_rows) * dt
                         + (k - dt - dp));
          }
          v[i] = round_keep<T>(
              v[i], keep == nullptr ? nullptr : keep + (slot0 + t) * K + k,
              rate_t);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + i * blockDim.x;
      if (q < total) {
        const int t = q / k4;
        store4(e_s + t * ld + 4 * (q - t * k4), v[i]);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // 16 bytes global -> shared without a register round trip; 0 source
  // bytes zero-fill the destination
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` committed groups of this thread are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Copy a (rows x cols) block of a row-major global array (row stride
// src_ld, cols % 4 == 0) into shared memory (row stride ld), rounding to T;
// rows at or past valid_rows are zero. Staging is latency-bound unless many
// loads are in flight: a same-type bf16 block on 16-byte boundaries goes by
// cp.async (every chunk in flight at once, no registers; the caller commits
// and waits, so the copy can overlap other work), anything else with eight
// loads in flight per thread before it stores (complete on return).
template <typename TS, typename T>
__device__ __forceinline__ void stage_rows_async(const TS* __restrict__ src,
                                                 long long src_ld, int rows,
                                                 int cols, int valid_rows,
                                                 T* dst, int ld) {
  if (sizeof(TS) == 2 && sizeof(T) == 2 && ld % 8 == 0 && src_ld % 8 == 0
      && cols % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0
      && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int c8 = cols / 8;
    for (int q = threadIdx.x; q < rows * c8; q += blockDim.x) {
      const int r = q / c8;
      const int c = 8 * (q - r * c8);
      const bool in = r < valid_rows;
      cp_async16(dst + r * ld + c, src + (in ? r : 0) * src_ld + c, in);
    }
    return;
  }
  const int c4 = cols / 4;
  const int total = rows * c4;
  for (int q0 = threadIdx.x; q0 < total; q0 += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + i * blockDim.x;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < total) {
        const int r = q / c4;
        if (r < valid_rows) v[i] = load4(src + r * src_ld + 4 * (q - r * c4));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + i * blockDim.x;
      if (q < total) {
        const int r = q / c4;
        store4(dst + r * ld + 4 * (q - r * c4), v[i]);
      }
    }
  }
}

// stage_rows_async, complete on return
template <typename TS, typename T>
__device__ __forceinline__ void stage_rows(const TS* __restrict__ src,
                                           long long src_ld, int rows,
                                           int cols, int valid_rows, T* dst,
                                           int ld) {
  stage_rows_async<TS, T>(src, src_ld, rows, cols, valid_rows, dst, ld);
  cp_async_commit();
  cp_async_wait<0>();
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per size:
// later launches (also those captured into a CUDA graph) make no call.
template <typename Kernel>
inline void allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes > allowed) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    allowed = bytes;
  }
}

// ------------------------------------------------------------ tile product
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory into mma fragments; lane l
// gives the address of row l % 8 of matrix l / 8 (16-byte aligned rows)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename T, int BM, int BN, int WM>
struct Tile;

template <int BM, int BN, int WM>
struct Tile<bf16, BM, BN, WM> {
  static constexpr int WN = 8 / WM;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static_assert(WM * WN == 8 && MT * 16 * WM == BM && NT * 8 * WN == BN
                    && NT % 2 == 0,
                "tile shape");
  float c[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
  }

  // C += A . B^T over K (a multiple of 16). Fragments come in by
  // ldmatrix: one x4 load is a whole 16 x 16 A fragment, or the two k
  // halves of two n8 B fragments (transposed when B is stored k-major).
  // Rows must be 16-byte aligned: lda, ldb multiples of 8.
  template <bool KN>
  __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B,
                                      int ldb, int K) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int m0 = (warp / WN) * MT * 16;
    const int n0 = (warp % WN) * NT * 8;
    // this lane's row address within each x4 load
    const int a_row = lane & 15;
    const int a_col = (lane >> 4) * 8;
    const int b_n = KN ? (lane >> 4) * 8 : (lane >> 4) * 8 + (lane & 7);
    const int b_k = KN ? (lane & 15) : ((lane >> 3) & 1) * 8;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldmatrix_x4(a[mt], A + (m0 + mt * 16 + a_row) * lda + k0 + a_col);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];          // b0, b1 of n-tile 2np, then of 2np + 1
        const int n = n0 + np * 16 + b_n;
        if (KN) {
          ldmatrix_x4_trans(b, B + (k0 + b_k) * ldb + n);
        } else {
          ldmatrix_x4(b, B + n * ldb + k0 + b_k);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(c[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16_16816(c[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // f(row, col, value) for every accumulator element of this thread
  template <typename F>
  __device__ __forceinline__ void each(F f) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int m0 = (warp / WN) * MT * 16;
    const int n0 = (warp % WN) * NT * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(m0 + mt * 16 + g + (e >> 1) * 8, n0 + nt * 8 + 2 * tq + (e & 1),
            c[mt][nt][e]);
  }
};

template <int BM, int BN, int WM>
struct Tile<float, BM, BN, WM> {
  static constexpr int TM = BM / 16;
  static constexpr int TN = BN / 16;
  static_assert(TM * 16 == BM && TN * 16 == BN, "tile shape");
  float c[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
  }

  template <bool KN>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B,
                                      int ldb, int K) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    for (int k = 0; k < K; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = KN ? B[k * ldb + tx + 16 * j] : B[(tx + 16 * j) * ldb + k];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(F f) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) f(ty + 16 * i, tx + 16 * j, c[i][j]);
  }
};

}  // namespace c2v
