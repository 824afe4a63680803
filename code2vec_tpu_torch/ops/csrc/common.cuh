// Device helpers shared by the hand-written Hopper kernels (sm_90a):
//
// - the fused gather of packed context rows [tok[src]; path[pth]; tok[tgt]]
//   into shared memory or a stream, reading fp32 or bf16 table rows and
//   rounding each element to the compute type on load, with the dropout
//   keep mask applied (kept elements divided by the keep rate, dropped ones
//   zero);
// - cp.async copies of 16 bytes and their groups;
// - the raise of a kernel's dynamic shared-memory limit.
// The fp32 products' helpers are tf32.cuh's; the wgmma, TMA and cluster
// primitives hopper.cuh's.
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

}  // namespace c2v
