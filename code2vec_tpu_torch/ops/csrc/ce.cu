// Streamed softmax cross-entropy over the target vocabulary, forward and
// backward, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels code2vec_tpu/ops/pallas_ce.py::_fwd_kernel
// (launched by _forward) and ::_bwd_kernel (launched by _backward). With
// logits l = code W^T (code (B, D), W (V, D) in the compute type, fp32
// accumulation) and columns >= num_valid masked:
//   forward:  lse_i = log sum_v exp(l_iv),  picked_i = l_i,label_i (0 when
//             the label is not a valid column)
//   backward: dl_iv = dlse_i softmax_iv + dpicked_i [v == label_i, valid],
//             rounded to the compute type before both products;
//             dW = dl^T code (V, D), dcode = dl W (B, D), both fp32.
// The (B, V) logits never reach device memory in either direction.
//
// Design. The TPU kernels walk the vocabulary in order on one core, with
// the whole batch's running (max, sumexp, pick) or dcode in VMEM. At
// B = 1024 that is only 16 tiles of 64 rows, far too few for 132 SMs, so
// the vocabulary is split across CTAs too:
//   ce_fwd:   CTA (row tile, vocab split) keeps online (m, s, picked) for
//             its 64 rows over its range of 64-column blocks and writes a
//             partial; ce_merge folds the splits with the rescale
//             (s = sum s_i e^(m_i - m)), like ragged_merge_kernel.
//   ce_bwd:   pass 1 (dW): CTA per 64-row block of W walks every row tile,
//             recomputes the logits block, forms dl and accumulates its
//             own dW rows: no reduction across CTAs. Pass 2 (dcode): CTA
//             (row tile, vocab split) recomputes the logits of its range
//             and accumulates a dcode partial; ce_reduce sums the splits in
//             a fixed order. The logits are recomputed twice (4 products
//             in all, against the TPU kernel's 3), the price of having no
//             cross-CTA reduction of dW.
// Each logits block is a 64 x 64 x D product on operands staged in shared
// memory: bf16 on the tensor cores (mma.sync m16n8k16), fp32 on the CUDA
// cores (the tensor cores have no exact fp32 product). Blocks are staged by
// cp.async (bf16) with every chunk in flight at once: staging them with
// one load at a time left every CTA waiting on L2 latency. A second buffer
// to overlap the next block's copy with the products measured no faster
// (the fragment loads from shared memory that feed mma.sync bound it), so
// each kernel keeps one, and starts the next copy as soon as the block is
// no longer read.
//
// Bound at the training shape (B = 1024, V = 262,144, D = 384), on an
// H100 SXM: the forward is 2 B V D ~ 206 GFLOP -> ~0.21 ms at 989 TFLOP/s
// bf16 (its W read, 201 MB, is ~0.06 ms); the backward's least work is 3
// such products (~0.62 ms), this kernel does 4. Operations bound both;
// mma.sync from shared memory, with W and code re-read from L2 per tile,
// reaches a fraction of the wgmma rate: wgmma with TMA-fed tiles is the
// later work.
//
// Shapes: D a multiple of 128 and at most 384; V a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using c2v::bf16;
using c2v::from_f32;
using c2v::kNeg;
using c2v::kThreads;
using c2v::Tile;

constexpr int kRows = 64;      // batch rows per tile
constexpr int kVocab = 64;     // vocabulary rows of W per block
constexpr int kGroups = 3;     // 128-column accumulator groups: D <= 384

template <typename T>
struct CeLayout {
  int ld, ldd;
  __host__ __device__ explicit CeLayout(int D) {
    const int pad = c2v::Pad<T>::value;
    ld = D + pad;              // code tiles and W blocks (64 x D)
    ldd = kRows + pad;         // dl tile (64 x 64), either orientation
  }
  // bytes of the dl tile (backward), which the forward's fp32 logits tile
  // (kRows x kVocab + 1) shares
  __host__ __device__ size_t tile_bytes() const {
    const size_t dl = sizeof(T) * static_cast<size_t>(kVocab) * ldd;
    const size_t logits = sizeof(float) * static_cast<size_t>(kRows)
                          * (kVocab + 1);
    return dl > logits ? dl : logits;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(T) * static_cast<size_t>(kRows) * ld * 2 + tile_bytes()
           + (sizeof(float) * 3 + sizeof(int)) * kRows;
  }
};

struct RowParams {
  float* lse;
  float* dlse;
  float* dpicked;
  int* label;
};

// The shared-memory carve-up common to the three kernels: the operand
// staged once (`fixed`), the streamed one (W blocks, or code tiles for
// dW), the dl tile Ds (whose room the forward's logits tile Ls shares),
// and the per-row inputs of the current code tile.
template <typename T>
struct CeSmem {
  T* fixed;
  T* stream;
  T* Ds;
  float* Ls;
  RowParams rows;
  __device__ CeSmem(unsigned char* raw, const CeLayout<T>& L) {
    fixed = reinterpret_cast<T*>(raw);
    stream = fixed + kRows * L.ld;
    Ds = stream + kRows * L.ld;
    Ls = reinterpret_cast<float*>(Ds);
    rows.lse = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ds)
                                        + L.tile_bytes());
    rows.dlse = rows.lse + kRows;
    rows.dpicked = rows.dlse + kRows;
    rows.label = reinterpret_cast<int*>(rows.dpicked + kRows);
  }
};

// the per-row inputs of rows [r0, r0 + 64); lse null: labels only
__device__ __forceinline__ void stage_row_params(
    const int* __restrict__ label, const float* __restrict__ lse,
    const float* __restrict__ dlse, const float* __restrict__ dpicked,
    int r0, int B, const RowParams& rows) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const bool in = r0 + r < B;
    rows.label[r] = in ? label[r0 + r] : -1;
    if (lse != nullptr) {
      rows.lse[r] = in ? lse[r0 + r] : 0.f;
      rows.dlse[r] = in ? dlse[r0 + r] : 0.f;
      rows.dpicked[r] = in ? dpicked[r0 + r] : 0.f;
    }
  }
}

// code rows [r0, r0 + 64) into dst, started (bf16: by cp.async, waited
// for at the top of the iteration that uses it)
template <typename T>
__device__ __forceinline__ void load_code_tile(const T* __restrict__ code,
                                                int r0, int B, int D, T* dst,
                                                int ld) {
  c2v::stage_rows_async<T, T>(code + static_cast<long long>(r0) * D, D,
                              kRows, D, min(kRows, B - r0), dst, ld);
}

// W rows [v0, v0 + 64) into dst, started
template <typename T>
__device__ __forceinline__ void load_w_block(const T* __restrict__ w,
                                              int v0, int D, T* dst, int ld) {
  c2v::stage_rows_async<T, T>(w + static_cast<long long>(v0) * D, D, kVocab,
                              D, kVocab, dst, ld);
}

// Waits for the block of this iteration (started as soon as the previous
// one was no longer read).
__device__ __forceinline__ void wait_block() {
  c2v::cp_async_wait<0>();
  __syncthreads();
}

// The logits block (64 rows x 64 vocab) of a staged code tile and W block.
template <typename T>
__device__ __forceinline__ Tile<T, kRows, kVocab, 4> logits_block(
    const T* code_tile, const T* w_block, int ld, int D) {
  Tile<T, kRows, kVocab, 4> acc;
  acc.zero();
  acc.template mma<false>(code_tile, ld, w_block, ld, D);
  return acc;
}

// dl of one logits block into Ds, rounded to T: as dl[r][v] (TRANSPOSED
// false) or dl^T[v][r] (true).
template <typename T, bool TRANSPOSED>
__device__ __forceinline__ void dl_block(Tile<T, kRows, kVocab, 4>& acc,
                                         const RowParams& rows, T* Ds,
                                         int ldd, int r0, int v0, int B,
                                         int nv) {
  acc.each([&](int r, int c, float& l) {
    const int col = v0 + c;
    const bool valid = col < nv && r0 + r < B;
    const float p = valid ? expf(l - rows.lse[r]) : 0.f;
    const float onehot = (valid && col == rows.label[r]) ? 1.f : 0.f;
    const T dl = from_f32<T>(rows.dlse[r] * p + rows.dpicked[r] * onehot);
    if (TRANSPOSED) {
      Ds[c * ldd + r] = dl;
    } else {
      Ds[r * ldd + c] = dl;
    }
  });
}

// ---------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(
    const T* __restrict__ code, const T* __restrict__ w,
    const int* __restrict__ label, int B, int V, int D, int nv,
    int blocks_per_split, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_p) {
  const CeLayout<T> L(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CeSmem<T> sm(smem_raw, L);
  const int r0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int vb0 = split * blocks_per_split;
  const int n = max(0, min(V / kVocab, vb0 + blocks_per_split) - vb0);
  load_code_tile<T>(code, r0, B, D, sm.fixed, L.ld);
  stage_row_params(label, nullptr, nullptr, nullptr, r0, B, sm.rows);
  if (n > 0) load_w_block<T>(w, vb0 * kVocab, D, sm.stream, L.ld);
  c2v::cp_async_commit();
  // four threads per row, 16 columns each
  const int row = threadIdx.x >> 2;
  const int quarter = threadIdx.x & 3;
  float m = kNeg, s = 0.f, picked = 0.f;
  for (int i = 0; i < n; ++i) {
    wait_block();
    const int v0 = (vb0 + i) * kVocab;
    Tile<T, kRows, kVocab, 4> acc =
        logits_block<T>(sm.fixed, sm.stream, L.ld, D);
    acc.each([&](int r, int c, float& l) { sm.Ls[r * (kVocab + 1) + c] = l; });
    __syncthreads();
    if (i + 1 < n) {       // the block is free: the next copy overlaps the stats
      load_w_block<T>(w, v0 + kVocab, D, sm.stream, L.ld);
      c2v::cp_async_commit();
    }
    const int lab = sm.rows.label[row];
    float l[16];
    float bm = kNeg;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = quarter * 16 + k;
      const int col = v0 + c;
      l[k] = col < nv ? sm.Ls[row * (kVocab + 1) + c] : kNeg;
      bm = fmaxf(bm, l[k]);
      if (col == lab && col < nv) picked += l[k];
    }
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
    const float m_new = fmaxf(m, bm);
    float bs = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) bs += expf(l[k] - m_new);
    bs += __shfl_xor_sync(0xffffffffu, bs, 1);
    bs += __shfl_xor_sync(0xffffffffu, bs, 2);
    s = s * expf(m - m_new) + bs;
    m = m_new;
  }
  picked += __shfl_xor_sync(0xffffffffu, picked, 1);
  picked += __shfl_xor_sync(0xffffffffu, picked, 2);
  if (quarter == 0 && r0 + row < B) {
    const long long o = static_cast<long long>(split) * B + r0 + row;
    part_m[o] = m;
    part_s[o] = s;
    part_p[o] = picked;
  }
}

// Folds the vocabulary splits of each row: lse = m + log(sum s_i e^(m_i - m)).
__global__ void ce_merge_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_s,
                                const float* __restrict__ part_p, int B,
                                int n_splits, float* __restrict__ lse,
                                float* __restrict__ picked) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float m = kNeg;
  for (int k = 0; k < n_splits; ++k) {
    m = fmaxf(m, part_m[static_cast<long long>(k) * B + i]);
  }
  float s = 0.f, p = 0.f;
  for (int k = 0; k < n_splits; ++k) {
    const long long o = static_cast<long long>(k) * B + i;
    s += part_s[o] * expf(part_m[o] - m);
    p += part_p[o];
  }
  lse[i] = m + logf(s);
  picked[i] = p;
}

// --------------------------------------------------------------- backward
// Pass 1: dW rows of vocabulary block blockIdx.x, over every row tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_dw_kernel(
    const T* __restrict__ code, const T* __restrict__ w,
    const int* __restrict__ label, const float* __restrict__ lse,
    const float* __restrict__ dlse, const float* __restrict__ dpicked, int B,
    int D, int nv, float* __restrict__ dw) {
  const CeLayout<T> L(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CeSmem<T> sm(smem_raw, L);
  const int v0 = blockIdx.x * kVocab;
  const int groups = D / 128;
  const int n = (B + kRows - 1) / kRows;
  load_w_block<T>(w, v0, D, sm.fixed, L.ld);
  load_code_tile<T>(code, 0, B, D, sm.stream, L.ld);
  stage_row_params(label, lse, dlse, dpicked, 0, B, sm.rows);
  c2v::cp_async_commit();
  Tile<T, kVocab, 128, 2> acc[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) acc[q].zero();
  for (int i = 0; i < n; ++i) {
    const int r0 = i * kRows;
    wait_block();
    Tile<T, kRows, kVocab, 4> lg =
        logits_block<T>(sm.stream, sm.fixed, L.ld, D);
    dl_block<T, true>(lg, sm.rows, sm.Ds, L.ldd, r0, v0, B, nv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (q < groups) {
        acc[q].template mma<true>(sm.Ds, L.ldd, sm.stream + q * 128, L.ld,
                                  kRows);
      }
    }
    __syncthreads();
    if (i + 1 < n) {
      load_code_tile<T>(code, r0 + kRows, B, D, sm.stream, L.ld);
      stage_row_params(label, lse, dlse, dpicked, r0 + kRows, B, sm.rows);
      c2v::cp_async_commit();
    }
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q < groups) {
      acc[q].each([&](int r, int c, float& v) {
        dw[static_cast<long long>(v0 + r) * D + q * 128 + c] = v;
      });
    }
  }
}

// Pass 2: dcode partial of row tile blockIdx.x over vocabulary split
// blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_dcode_kernel(
    const T* __restrict__ code, const T* __restrict__ w,
    const int* __restrict__ label, const float* __restrict__ lse,
    const float* __restrict__ dlse, const float* __restrict__ dpicked, int B,
    int V, int D, int nv, int blocks_per_split,
    float* __restrict__ part_dcode) {
  const CeLayout<T> L(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CeSmem<T> sm(smem_raw, L);
  const int r0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int vb0 = split * blocks_per_split;
  const int n = max(0, min(V / kVocab, vb0 + blocks_per_split) - vb0);
  const int groups = D / 128;
  load_code_tile<T>(code, r0, B, D, sm.fixed, L.ld);
  stage_row_params(label, lse, dlse, dpicked, r0, B, sm.rows);
  if (n > 0) load_w_block<T>(w, vb0 * kVocab, D, sm.stream, L.ld);
  c2v::cp_async_commit();
  Tile<T, kRows, 128, 2> acc[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) acc[q].zero();
  for (int i = 0; i < n; ++i) {
    const int v0 = (vb0 + i) * kVocab;
    wait_block();
    Tile<T, kRows, kVocab, 4> lg =
        logits_block<T>(sm.fixed, sm.stream, L.ld, D);
    dl_block<T, false>(lg, sm.rows, sm.Ds, L.ldd, r0, v0, B, nv);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (q < groups) {
        acc[q].template mma<true>(sm.Ds, L.ldd, sm.stream + q * 128, L.ld,
                                  kVocab);
      }
    }
    __syncthreads();
    if (i + 1 < n) {
      load_w_block<T>(w, v0 + kVocab, D, sm.stream, L.ld);
      c2v::cp_async_commit();
    }
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q < groups) {
      acc[q].each([&](int r, int c, float& v) {
        if (r0 + r < B) {
          part_dcode[(static_cast<long long>(split) * B + r0 + r) * D
                     + q * 128 + c] = v;
        }
      });
    }
  }
}

// dcode = sum of the splits' partials, in a fixed order.
__global__ void ce_reduce_kernel(const float* __restrict__ part, long long n,
                                 int n_splits, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_splits; ++k) s += part[k * n + i];
  out[i] = s;
}

template <typename T>
cudaError_t fwd(const void* code, const void* w, const int* label, int B,
                int V, int D, int nv, int n_splits, float* part_m,
                float* part_s, float* part_p, float* lse, float* picked,
                cudaStream_t s) {
  const CeLayout<T> L(D);
  const size_t smem = L.bytes();
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ce_fwd_kernel<T>, smem, allowed);
  const int n_blocks = V / kVocab;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const dim3 grid((B + kRows - 1) / kRows, n_splits);
  ce_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(code), static_cast<const T*>(w), label, B, V, D,
      nv, per_split, part_m, part_s, part_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_merge_kernel<<<(B + 255) / 256, 256, 0, s>>>(part_m, part_s, part_p, B,
                                                  n_splits, lse, picked);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* code, const void* w, const int* label,
                const float* lse, const float* dlse, const float* dpicked,
                int B, int V, int D, int nv, int n_splits, float* dw,
                float* part_dcode, float* dcode, cudaStream_t s) {
  const CeLayout<T> L(D);
  const size_t smem = L.bytes();
  static size_t allowed_dw = 48 * 1024;
  static size_t allowed_dcode = 48 * 1024;
  c2v::allow_smem(ce_bwd_dw_kernel<T>, smem, allowed_dw);
  c2v::allow_smem(ce_bwd_dcode_kernel<T>, smem, allowed_dcode);
  const int n_blocks = V / kVocab;
  ce_bwd_dw_kernel<T><<<n_blocks, kThreads, smem, s>>>(
      static_cast<const T*>(code), static_cast<const T*>(w), label, lse, dlse,
      dpicked, B, D, nv, dw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const dim3 grid((B + kRows - 1) / kRows, n_splits);
  ce_bwd_dcode_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(code), static_cast<const T*>(w), label, lse, dlse,
      dpicked, B, V, D, nv, per_split, part_dcode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * D;
  ce_reduce_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, s>>>(
      part_dcode, n, n_splits, dcode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Vocabulary rows per block: V must be a multiple of it.
int ce_vocab_block() { return kVocab; }

// dtype_code 0: float32 code and W; 1: bfloat16. lse, picked (B,) f32 out;
// part_* (n_splits, B) scratch. The caller checks the shapes (D a multiple
// of 128, at most 384; V a multiple of 64). Returns cudaGetLastError()
// after the launches (0 = launched).
int ce_fwd(int dtype_code, const void* code, const void* w, const int* label,
           int B, int V, int D, int nv, int n_splits, float* part_m,
           float* part_s, float* part_p, float* lse, float* picked,
           void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = fwd<float>(code, w, label, B, V, D, nv, n_splits, part_m, part_s,
                     part_p, lse, picked, s);
  } else if (dtype_code == 1) {
    err = fwd<bf16>(code, w, label, B, V, D, nv, n_splits, part_m, part_s,
                    part_p, lse, picked, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dw (V, D) and dcode (B, D) f32 out; part_dcode (n_splits, B, D) scratch.
int ce_bwd(int dtype_code, const void* code, const void* w, const int* label,
           const float* lse, const float* dlse, const float* dpicked, int B,
           int V, int D, int nv, int n_splits, float* dw, float* part_dcode,
           float* dcode, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = bwd<float>(code, w, label, lse, dlse, dpicked, B, V, D, nv,
                     n_splits, dw, part_dcode, dcode, s);
  } else if (dtype_code == 1) {
    err = bwd<bf16>(code, w, label, lse, dlse, dpicked, B, V, D, nv,
                    n_splits, dw, part_dcode, dcode, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
