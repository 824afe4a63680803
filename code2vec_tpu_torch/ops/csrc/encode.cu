// Fused context transform over dense context rows, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel code2vec_tpu/ops/pallas_encode.py::_kernel
// (launched by fused_context_transform): for N context rows,
//   x      = tanh(src_e W_src + path_e W_path + tgt_e W_tgt)   (N, D) fp32
//   scores = x . attention                                     (N,)   fp32
// where W_src, W_path, W_tgt are the row slices of TRANSFORM (K x D,
// K = 2 dt + dp), so the (N, K) concatenation never reaches device memory.
// The plane wire computes every slot of every example, padding included:
// the softmax and the weighted sum after it (outside this kernel, as in the
// reference) give padding slots weight ~e^-69, and an example with no valid
// context the mean of its PAD-slot x, so no row is skipped here.
//
// Design. The TPU kernel keeps all of W in VMEM and walks 512-row blocks in
// order. W in bf16 is 295 KB and does not fit in shared memory, so a CTA
// owns a tile of rows and all D output columns, and streams K in chunks:
// each chunk is BK columns of one of the three inputs (BK divides dt and dp)
// with the matching BK rows of W, staged into shared memory and double
// buffered (chunk c + 1 is in flight while chunk c is multiplied). The tail
// tile's missing rows are staged as zeros and never written: no padded copy
// of the inputs, unlike the TPU's 512-row padding.
//   bf16: 64-row tiles on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//         accumulation, fragments by ldmatrix), chunks by cp.async;
//   fp32: 32-row tiles on the CUDA cores (exact fp32 FMAs: the tensor cores
//         have no exact-fp32 product).
// The epilogue applies tanhf (not tanh.approx, ~2^-11 relative error) in
// registers and writes x as fp32; each row's score is summed from fixed
// per-thread partials in a fixed order: no atomics, the same result every
// run. x stays fp32 for the score, as in the TPU kernel.
//
// Bound at the plane wire's shape (N = 1024 x 200 = 204,800 rows, dt = dp =
// 128, D = 384), on an H100 SXM: bytes 204,800 x (384 x 2 B in + 384 x 4 B
// out) ~ 473 MB in bf16 -> ~0.14 ms at 3.35 TB/s; operations 2 x 204,800 x
// 384 x 384 ~ 60 GFLOP -> ~0.06 ms at 989 TFLOP/s. So bf16 is bound by the
// bytes, two thirds of them the fp32 x. fp32 (~0.63 GB, ~0.9 ms at 67
// TFLOP/s) is bound by the operations. This kernel re-reads W from L2 once
// per 64-row tile (3,200 tiles x 295 KB) and mma.sync reaches a fraction of
// the wgmma rate: wgmma with TMA-fed tiles is the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using c2v::bf16;
using c2v::kThreads;

constexpr int kWarpRows = 2;       // bf16: warps along the rows (4 along D)

// rows per CTA and K columns per staged chunk, by compute type
template <typename T>
struct Shape;
template <>
struct Shape<bf16> {
  static constexpr int rows = 64;
  static constexpr int bk = 32;
};
template <>
struct Shape<float> {
  static constexpr int rows = 32;
  static constexpr int bk = 16;
};

// Shared memory of one CTA: two stages of (A chunk: rows x BK, W chunk:
// BK x D), then attention (D floats) and the score partials (4 x rows).
// Every stage offset is a multiple of 16 bytes (cp.async, ldmatrix).
template <typename T, int D>
struct Layout {
  static constexpr int kRows = Shape<T>::rows;
  static constexpr int kBk = Shape<T>::bk;
  static constexpr int kLda = kBk + c2v::Pad<T>::value;
  static constexpr int kLdb = D + c2v::Pad<T>::value;
  static constexpr int kA = kRows * kLda;
  static constexpr int kStage = kA + kBk * kLdb;
  static_assert((kA * sizeof(T)) % 16 == 0 && (kStage * sizeof(T)) % 16 == 0,
                "stage alignment");
  static size_t bytes() {
    return 2 * kStage * sizeof(T) + sizeof(float) * (D + 4 * kRows);
  }
};

// Score of each row of the tile: the tanh'd accumulators times attention,
// summed over this thread's columns, then across the threads sharing the
// row (shuffles within a warp, then a fixed-order sum over the four column
// warps through shared memory).
template <int D>
__device__ __forceinline__ void row_scores(
    c2v::Tile<bf16, Shape<bf16>::rows, D, kWarpRows>& tile,
    const float* attn_s, float* red, int rows, long long row0,
    float* __restrict__ scores) {
  using TileT = c2v::Tile<bf16, Shape<bf16>::rows, D, kWarpRows>;
  constexpr int kRows = Shape<bf16>::rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wn = warp % TileT::WN;
  const int m0 = (warp / TileT::WN) * TileT::MT * 16;
  const int n0 = wn * TileT::NT * 8;
#pragma unroll
  for (int mt = 0; mt < TileT::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p = 0.f;
#pragma unroll
      for (int nt = 0; nt < TileT::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p = fmaf(tile.c[mt][nt][2 * h + e],
                   attn_s[n0 + nt * 8 + 2 * tq + e], p);
        }
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (tq == 0) red[wn * kRows + m0 + mt * 16 + h * 8 + g] = p;
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    float s = 0.f;
    for (int i = 0; i < TileT::WN; ++i) s += red[i * kRows + r];
    scores[row0 + r] = s;
  }
}

// fp32 tile: thread (ty, tx) of 16 x 16 owns rows ty + 16 i and columns
// tx + 16 j, so a row's threads are the 16 lanes of one half-warp
template <int D>
__device__ __forceinline__ void row_scores(
    c2v::Tile<float, Shape<float>::rows, D, kWarpRows>& tile,
    const float* attn_s, float* red, int rows, long long row0,
    float* __restrict__ scores) {
  using TileT = c2v::Tile<float, Shape<float>::rows, D, kWarpRows>;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TileT::TM; ++i) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < TileT::TN; ++j) {
      p = fmaf(tile.c[i][j], attn_s[tx + 16 * j], p);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, off);
    }
    if (tx == 0) red[ty + 16 * i] = p;
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) scores[row0 + r] = red[r];
}

// One CTA per tile of kRows rows; all inputs and weights of type T. One
// CTA per SM in the launch bounds: the 96 bf16 (48 fp32) accumulators of
// a thread at D = 384 spill under the 128-register cap of two.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) encode_kernel(
    const T* __restrict__ src, const T* __restrict__ pth,
    const T* __restrict__ tgt,
    const T* __restrict__ w,       // (K, D) row-major
    const T* __restrict__ attn,    // (D,)
    long long n, int dt, int dp, float* __restrict__ x,
    float* __restrict__ scores) {
  using L = Layout<T, D>;
  constexpr int kRows = L::kRows;
  constexpr int kBk = L::kBk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* attn_s = reinterpret_cast<float*>(stages + 2 * L::kStage);
  float* red = attn_s + D;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      n - row0 < kRows ? n - row0 : static_cast<long long>(kRows));
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    attn_s[j] = c2v::to_f32(attn[j]);
  }

  // chunk c: K columns [c BK, (c + 1) BK), inside one of src | pth | tgt
  const int n_chunks = (2 * dt + dp) / kBk;
  auto stage_chunk = [&](int c) {
    T* buf = stages + (c & 1) * L::kStage;
    const int k0 = c * kBk;
    const T* in = src;
    int ld = dt;
    int kk = k0;
    if (k0 >= dt + dp) {
      in = tgt;
      kk = k0 - dt - dp;
    } else if (k0 >= dt) {
      in = pth;
      ld = dp;
      kk = k0 - dt;
    }
    c2v::stage_rows_async<T, T>(in + row0 * ld + kk, ld, kRows, kBk, rows,
                                buf, L::kLda);
    c2v::stage_rows_async<T, T>(w + static_cast<long long>(k0) * D, D, kBk,
                                D, kBk, buf + L::kA, L::kLdb);
    c2v::cp_async_commit();
  };

  c2v::Tile<T, kRows, D, kWarpRows> tile;
  tile.zero();
  stage_chunk(0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage_chunk(c + 1);          // its buffer was freed by the last sync
      c2v::cp_async_wait<1>();
    } else {
      c2v::cp_async_wait<0>();
    }
    __syncthreads();
    const T* buf = stages + (c & 1) * L::kStage;
    tile.template mma<true>(buf, L::kLda, buf + L::kA, L::kLdb, kBk);
    __syncthreads();
  }

  tile.each([&](int r, int col, float& v) {
    v = tanhf(v);
    if (r < rows) x[(row0 + r) * D + col] = v;
  });
  row_scores<D>(tile, attn_s, red, rows, row0, scores);
}

template <typename T, int D>
cudaError_t launch(const void* src, const void* pth, const void* tgt,
                   const void* w, const void* attn, long long n, int dt,
                   int dp, float* x, float* scores, cudaStream_t s) {
  using L = Layout<T, D>;
  static size_t allowed = 48 * 1024;
  const size_t smem = L::bytes();
  c2v::allow_smem(encode_kernel<T, D>, smem, allowed);
  const long long blocks = (n + L::kRows - 1) / L::kRows;
  encode_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(src), static_cast<const T*>(pth),
      static_cast<const T*>(tgt), static_cast<const T*>(w),
      static_cast<const T*>(attn), n, dt, dp, x, scores);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d_code, const void* src, const void* pth,
                     const void* tgt, const void* w, const void* attn,
                     long long n, int dt, int dp, float* x, float* scores,
                     cudaStream_t s) {
  switch (d_code) {
    case 128:
      return launch<T, 128>(src, pth, tgt, w, attn, n, dt, dp, x, scores, s);
    case 256:
      return launch<T, 256>(src, pth, tgt, w, attn, n, dt, dp, x, scores, s);
    case 384:
      return launch<T, 384>(src, pth, tgt, w, attn, n, dt, dp, x, scores, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype_code 0: float32 inputs and weights; 1: bfloat16. src, tgt (n, dt),
// pth (n, dp), w (2 dt + dp, d_code), attn (d_code,), all contiguous; x
// (n, d_code) and scores (n,) float32. The caller checks the shapes (dt,
// dp multiples of 32; d_code 128, 256 or 384). Returns cudaGetLastError()
// after the launch (0 = launched).
int encode_fwd(int dtype_code, const void* src, const void* pth,
               const void* tgt, const void* w, const void* attn, long long n,
               int dt, int dp, int d_code, float* x, float* scores,
               void* stream) {
  if (n <= 0) return 0;
  if (dt % 32 || dp % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (dtype_code == 0) {
    launched = launch_d<float>(d_code, src, pth, tgt, w, attn, n, dt, dp, x,
                               scores, s);
  } else if (dtype_code == 1) {
    launched = launch_d<bf16>(d_code, src, pth, tgt, w, attn, n, dt, dp, x,
                              scores, s);
  } else {
    launched = cudaErrorInvalidValue;
  }
  return static_cast<int>(launched);
}

const char* encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
