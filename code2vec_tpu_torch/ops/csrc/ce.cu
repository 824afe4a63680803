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
//             its rows over its range of vocabulary blocks and writes a
//             partial; ce_merge folds the splits with the rescale
//             (s = sum s_i e^(m_i - m)), like ragged_merge_kernel.
//   ce_bwd:   pass 1 (dW): a unit is a 64-row block of W; it walks every
//             row tile, recomputes the logits block, forms dl and
//             accumulates its own dW rows: no reduction across CTAs. Pass 2
//             (dcode): a unit is (row tile, vocab split); it recomputes the
//             logits of its range and accumulates a dcode partial;
//             ce_reduce sums the splits in a fixed order. The logits are
//             recomputed twice (4 products in all, against the TPU kernel's
//             3), the price of having no cross-CTA reduction of dW (402 MB
//             of fp32) and no read-modify-write of dcode per vocab block.
//
// bf16 backward (the training path), on Hopper's own hardware. Both passes
// are one kernel, ce_bwd_wgmma_kernel<D, DW>: a unit holds a "fixed" 64 x D
// tile (pass 1: the W block; pass 2: the code tile) and streams 64 x D
// blocks of the other operand (pass 1: code tiles; pass 2: W blocks). One
// persistent CTA per SM walks its units; each CTA is three warpgroups:
//   - a producer (one thread) loads the fixed tile and the streamed blocks
//     by TMA (128-byte swizzle, 64-column boxes) into a ring of kStages
//     stages, one full and one empty mbarrier per stage, and the next
//     unit's fixed tile as soon as the last logits of this one are done;
//   - two consumer warpgroups split the work of each block: warpgroup c
//     computes the logits of streamed rows [32c, 32c + 32) (wgmma m64n32,
//     K = D, A = fixed tile, B = streamed block, both K-major), turns them
//     into dl in registers (fp32, the exponent on the SFU, rounded to
//     bf16) and writes its half of the 64 x 64 dl tile into shared memory,
//     swizzled as the next wgmma's K-major A operand; after a named
//     barrier each accumulates its half of
//     the D output columns, acc (64 x D/2 fp32, 96 registers at D = 384)
//     += dl . block (wgmma m64n{D/2}, B MN-major through the descriptor's
//     transpose: no transpose pass). dl goes through shared memory, in
//     three buffers, since each warpgroup needs all 64 of a block's dl
//     columns. dl of block k + 1 is formed while the product of block k
//     runs.
// bf16 forward (the training path), ce_fwd_wgmma_kernel<D>: a unit is 128
// code rows x one vocabulary split; the row tiles of a split are
// neighbours in launch order, so each 128-row block of W comes from device
// memory about once and from L2 for the other row tiles. Three warpgroups:
//   - a producer thread loads the unit's code rows once by TMA and streams
//     W blocks (128 rows) as 64-column slices through a ring of kFwdStages
//     stages, one full and one empty mbarrier per stage;
//   - two consumer warpgroups, 64 code rows each, share every W slice:
//     logits = code . W^T at m64n128 (K = D, both operands K-major, 64
//     accumulator registers); the statistics never leave the registers:
//     each thread keeps a running (m, s) over its own columns of its two
//     rows (the exponent on the SFU, 2^(l log2 e - m log2 e)), takes
//     picked from the fragment that holds the label's column, and the
//     quad's four running sums are merged with the rescale at the end.
//     While one consumer folds its block, the other's product runs.
// Every sum runs in a fixed order (K order inside wgmma, blocks in order,
// splits in order): no atomics, the same bits on every run.
// fp32 stays on the CUDA cores (the tensor cores have no exact fp32
// product; TF32 is off): operands staged by cp.async, 64 x 64 blocks.
//
// Bound at the training shape (B = 1024, V = 262,144, D = 384), on an
// H100 SXM: the forward is 2 B V D ~ 206 GFLOP -> ~0.21 ms at 989 TFLOP/s
// bf16 (its W read, 201 MB, is ~0.06 ms); the backward's least work is 3
// such products (~0.62 ms), this kernel does 4. Operations bound both.
// The forward's W is read by 8 row tiles of 128 (1.6 GB from L2 at B =
// 1024).
//
// Shapes: D a multiple of 128 and at most 384; V a multiple of 64. bf16:
// code and W 16-byte aligned (TMA).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
  static_assert(sizeof(T) == 4, "bf16 runs ce_fwd_wgmma_kernel");
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

// ------------------------------------------------------- backward, fp32
// (CUDA cores; T is float) Pass 1: dW rows of vocabulary block blockIdx.x,
// over every row tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_dw_kernel(
    const T* __restrict__ code, const T* __restrict__ w,
    const int* __restrict__ label, const float* __restrict__ lse,
    const float* __restrict__ dlse, const float* __restrict__ dpicked, int B,
    int D, int nv, float* __restrict__ dw) {
  static_assert(sizeof(T) == 4, "bf16 runs ce_bwd_wgmma_kernel");
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
  static_assert(sizeof(T) == 4, "bf16 runs ce_bwd_wgmma_kernel");
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

// ------------------------------------------------- backward, bf16 (wgmma)
constexpr int kBlk = 64;            // rows of a fixed tile and of a block
constexpr int kStages = 3;          // streamed blocks in flight
constexpr int kBwdThreads = 384;    // producer + two consumer warpgroups
constexpr int kBox = kBlk * 64;     // bf16 elements of one 64 x 64 box
constexpr int kDlBufs = 3;          // dl tiles: written two blocks ahead
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, subnormal results flushed to 0),
// where the accurate expf takes ~8 instructions; dl is rounded to bf16
// after it
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of ce_bwd_wgmma_kernel: every box 1024-byte aligned.
template <int D>
struct BwdSmem {
  static constexpr int kBoxes = D / 64;
  bf16 fixed[kBoxes][kBox];
  bf16 stream[kStages][kBoxes][kBox];
  bf16 dl[kDlBufs][kBox];           // dl (fixed rows x block rows), K-major
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t fixed_full;
  uint64_t fixed_empty;
};

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(BwdSmem<D>) + 1024;     // room to align the base to 1024
}

// The unit's fixed tile (its first row) and its streamed blocks [b0, b1).
struct BwdUnit {
  int fixed_row;
  int b0, b1;
  int split;
};

template <bool DW>
__device__ __forceinline__ BwdUnit bwd_unit(int u, int row_tiles,
                                            int n_blocks, int per_split) {
  BwdUnit out;
  if (DW) {                         // W block u over every row tile
    out.fixed_row = u * kBlk;
    out.b0 = 0;
    out.b1 = row_tiles;
    out.split = 0;
  } else {                          // row tile u % row_tiles, split u / ...
    out.split = u / row_tiles;
    out.fixed_row = (u - out.split * row_tiles) * kBlk;
    out.b0 = min(n_blocks, out.split * per_split);
    out.b1 = min(n_blocks, out.b0 + per_split);
  }
  return out;
}

// Pass 1 (DW): fixed = W rows [v0, v0 + 64), blocks = code row tiles; dl is
// indexed (vocab r, batch row c) and its row parameters follow the column.
// Pass 2 (!DW): fixed = code rows [r0, r0 + 64), blocks = W blocks of the
// unit's split; dl is (batch row r, vocab c). out: dW (V, D), or the
// partials (n_splits, B, D).
template <int D, bool DW>
__global__ void __launch_bounds__(kBwdThreads, 1) ce_bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap code_map,
    const __grid_constant__ CUtensorMap w_map, const int* __restrict__ label,
    const float* __restrict__ lse, const float* __restrict__ dlse,
    const float* __restrict__ dpicked, int B, int nv, int n_blocks,
    int per_split, int n_units, float* __restrict__ out) {
  constexpr int kHalf = D / 2;                  // output columns per consumer
  constexpr int kBoxBytes = kBox * 2;
  constexpr uint32_t kTileBytes = D * kBlk * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<D>& sm = *reinterpret_cast<BwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int row_tiles = (B + kBlk - 1) / kBlk;
  const CUtensorMap* fixed_map = DW ? &w_map : &code_map;
  const CUtensorMap* block_map = DW ? &code_map : &w_map;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], 2);
    }
    hop::mbar_init(&sm.fixed_full, 1);
    hop::mbar_init(&sm.fixed_empty, 2);
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hop::set_max_regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_tmap(&code_map);
      hop::prefetch_tmap(&w_map);
      int g = 0;                      // streamed blocks issued so far
      int uc = 0;                     // units begun so far
      for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++uc) {
        const BwdUnit unit = bwd_unit<DW>(u, row_tiles, n_blocks, per_split);
        hop::mbar_wait(&sm.fixed_empty, (uc & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.fixed_full, kTileBytes);
#pragma unroll
        for (int b = 0; b < D / 64; ++b) {
          hop::tma_load_2d(sm.fixed[b], fixed_map, &sm.fixed_full, 64 * b,
                           unit.fixed_row);
        }
        for (int i = unit.b0; i < unit.b1; ++i, ++g) {
          const int st = g % kStages;
          hop::mbar_wait(&sm.empty[st], ((g / kStages) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&sm.full[st], kTileBytes);
#pragma unroll
          for (int b = 0; b < D / 64; ++b) {
            hop::tma_load_2d(sm.stream[st][b], block_map, &sm.full[st],
                             64 * b, i * kBlk);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hop::set_max_regs_inc<232>();
    const int cw = wg - 1;                      // consumer 0 or 1
    const int t = threadIdx.x & 127;
    const bool leader = t == 0;
    const int row0 = 16 * (t >> 5) + ((t & 31) >> 2);   // and row0 + 8
    float acc[kHalf / 2];
#pragma unroll
    for (int j = 0; j < kHalf / 2; ++j) acc[j] = 0.f;
    float lg[16];
    // dl's row parameters: pass 1 per block row (this thread's eight
    // columns), pass 2 per fixed row (its two rows); lse times log2 e
    float q_lse2[8], q_dlse[8], q_dp[8];
    int q_lab[8];
    auto issue_logits = [&](int st) {   // lg = fixed . block rows (32 cw..)
#pragma unroll
      for (int j = 0; j < 16; ++j) lg[j] = 0.f;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int b = kk / 4;
        const int k_bytes = (kk % 4) * 32;
        const uint64_t da = hop::desc_sw128(
            reinterpret_cast<const unsigned char*>(sm.fixed[b]) + k_bytes,
            16, 1024);
        const uint64_t db = hop::desc_sw128(
            reinterpret_cast<const unsigned char*>(sm.stream[st][b])
                + cw * 32 * 128 + k_bytes,
            16, 1024);
        hop::wgmma<32, 0>(lg, da, db);
      }
      hop::wgmma_commit();
    };
    auto load_block_params = [&](int i) {     // pass 1: block i's rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = i * kBlk + 32 * cw + 8 * (j >> 1) + 2 * (t & 3)
                      + (j & 1);
        const bool in = r < B;
        q_lse2[j] = in ? lse[r] * kLog2e : 0.f;
        q_dlse[j] = in ? dlse[r] : 0.f;
        q_dp[j] = in ? dpicked[r] : 0.f;
        q_lab[j] = in ? label[r] : -1;
      }
    };
    auto write_dl = [&](int fixed_row, int i, unsigned char* tile) {
      // dl of block i from lg, rounded to bf16, into the swizzled K-major
      // tile (columns [32 cw, 32 cw + 32): this warpgroup's half)
#pragma unroll
      for (int j = 0; j < 4; ++j) {            // n8 groups
#pragma unroll
        for (int h = 0; h < 2; ++h) {          // rows row0, row0 + 8
          const int r = row0 + 8 * h;
          const int c = 8 * j + 2 * (t & 3);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = DW ? 2 * j + e : h;
            const int vocab = DW ? fixed_row + r : i * kBlk + 32 * cw + c + e;
            const int brow = DW ? i * kBlk + 32 * cw + c + e : fixed_row + r;
            const bool valid = vocab < nv && brow < B;
            const float p =
                valid ? exp2_approx(fmaf(lg[4 * j + 2 * h + e], kLog2e,
                                         -q_lse2[k]))
                      : 0.f;
            const float onehot = (valid && vocab == q_lab[k]) ? 1.f : 0.f;
            v[e] = q_dlse[k] * p + q_dp[k] * onehot;
          }
          *reinterpret_cast<__nv_bfloat162*>(
              tile + hop::sw128_offset(r, 32 * cw + c)) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
      hop::fence_proxy_async();
      hop::named_sync(1, 256);       // both halves of dl written
    };
    auto issue_acc = [&](int st, const unsigned char* tile) {
      // acc += dl (fixed rows x 64 block rows) . block[:, half cw]
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlk / 16; ++kk) {
        const uint64_t da = hop::desc_sw128(tile + kk * 32, 16, 1024);
        const uint64_t db = hop::desc_sw128(
            reinterpret_cast<const unsigned char*>(
                sm.stream[st][cw * (kHalf / 64)])
                + kk * 2048,
            kBoxBytes, 1024);
        hop::wgmma<kHalf, 1>(acc, da, db);
      }
      hop::wgmma_commit();
    };
    auto dl_tile = [&](int gi) {
      return reinterpret_cast<unsigned char*>(sm.dl[gi % kDlBufs]);
    };

    // Per block k of a unit: the logits of block k + 1 are issued and
    // waited for, then the product of block k is issued and left in
    // flight while dl of block k + 1 is formed on the CUDA cores (nothing
    // but wgmma touches acc while it is in flight).
    // g counts the blocks this CTA has streamed (ring stage, phase and dl
    // buffer follow it across units).
    int g = 0;
    int uc = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++uc) {
      const BwdUnit unit = bwd_unit<DW>(u, row_tiles, n_blocks, per_split);
      const int n = unit.b1 - unit.b0;
      if (!DW) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = unit.fixed_row + row0 + 8 * h;
          const bool in = r < B;
          q_lse2[h] = in ? lse[r] * kLog2e : 0.f;
          q_dlse[h] = in ? dlse[r] : 0.f;
          q_dp[h] = in ? dpicked[r] : 0.f;
          q_lab[h] = in ? label[r] : -1;
        }
      }
      hop::mbar_wait(&sm.fixed_full, uc & 1);
      if (n == 0) {
        if (leader) hop::mbar_arrive(&sm.fixed_empty);
      } else {
        int st = g % kStages;
        hop::mbar_wait(&sm.full[st], (g / kStages) & 1);
        issue_logits(st);
        if (DW) load_block_params(unit.b0);
        hop::wgmma_wait<0>();
        hop::fence_regs(lg);
        if (n == 1 && leader) hop::mbar_arrive(&sm.fixed_empty);
        write_dl(unit.fixed_row, unit.b0, dl_tile(g));
        for (int k = 0; k < n; ++k) {
          const int gk = g + k;
          const bool more = k + 1 < n;
          if (more) {
            const int sn = (gk + 1) % kStages;
            hop::mbar_wait(&sm.full[sn], ((gk + 1) / kStages) & 1);
            issue_logits(sn);
            if (DW) load_block_params(unit.b0 + k + 1);
          }
          hop::wgmma_wait<0>();         // logits k + 1, product k - 1
          hop::fence_regs(lg);
          hop::fence_regs(acc);
          if (leader) {
            if (k > 0) hop::mbar_arrive(&sm.empty[(gk - 1) % kStages]);
            if (k + 2 == n) hop::mbar_arrive(&sm.fixed_empty);
          }
          issue_acc(gk % kStages, dl_tile(gk));
          if (more) {
            write_dl(unit.fixed_row, unit.b0 + k + 1, dl_tile(gk + 1));
          }
        }
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
        if (leader) hop::mbar_arrive(&sm.empty[(g + n - 1) % kStages]);
        g += n;
      }
      // epilogue: this warpgroup's columns of the unit's 64 output rows
      float* dst = out;
      int rows = kBlk;
      if (DW) {
        dst += static_cast<long long>(unit.fixed_row) * D;
      } else {
        dst += (static_cast<long long>(unit.split) * B + unit.fixed_row) * D;
        rows = min(kBlk, B - unit.fixed_row);
      }
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          if (r < rows) {
            *reinterpret_cast<float2*>(
                dst + static_cast<long long>(r) * D + cw * kHalf + 8 * j
                + 2 * (t & 3)) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
          acc[4 * j + 2 * h] = 0.f;
          acc[4 * j + 2 * h + 1] = 0.f;
        }
      }
    }
  }
}

// ------------------------------------------------- forward, bf16 (wgmma)
constexpr int kFwdRows = 128;       // batch rows per unit: 64 per consumer
constexpr int kFwdBlock = 128;      // vocabulary rows per block (wgmma N)
constexpr int kFwdStages = 6;       // W slices (128 rows x 64 of D) in flight

// Shared memory of ce_fwd_wgmma_kernel: every box 1024-byte aligned.
template <int D>
struct FwdSmem {
  bf16 code[D / 64][kFwdRows * 64];     // the unit's code rows, 64 of D a box
  bf16 w[kFwdStages][kFwdBlock * 64];   // 128 vocabulary rows x 64 of D
  uint64_t code_full;
  uint64_t full[kFwdStages], empty[kFwdStages];
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 1024;
}

// Unit blockIdx.x: row tile u % row_tiles (128 rows), vocabulary split
// u / row_tiles (blocks [split per_split, + per_split) of 128 W rows), so
// the row tiles of one split are neighbours in launch order and W's block
// is read from device memory about once. Per block, consumer c computes
// the logits of its 64 rows (wgmma m64n128, K = D, both operands K-major)
// and folds them into its running (m, s, picked) in registers; each thread
// keeps its own columns' running sums and the quad merges them at the end.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1) ce_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap code_map,
    const __grid_constant__ CUtensorMap w_map, const int* __restrict__ label,
    int B, int nv, int n_blocks, int per_split, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int row_tiles = (B + kFwdRows - 1) / kFwdRows;
  const int split = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - split * row_tiles) * kFwdRows;
  const int b0 = min(n_blocks, split * per_split);
  const int b1 = min(n_blocks, b0 + per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], 2);
    }
    hop::mbar_init(&sm.code_full, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hop::set_max_regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_tmap(&code_map);
      hop::prefetch_tmap(&w_map);
      hop::mbar_arrive_expect_tx(&sm.code_full, D * kFwdRows * 2);
#pragma unroll
      for (int b = 0; b < D / 64; ++b) {
        hop::tma_load_2d(sm.code[b], &code_map, &sm.code_full, 64 * b, r0);
      }
      int g = 0;
      for (int blk = b0; blk < b1; ++blk) {
#pragma unroll
        for (int q = 0; q < D / 64; ++q, ++g) {
          const int st = g % kFwdStages;
          hop::mbar_wait(&sm.empty[st], ((g / kFwdStages) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&sm.full[st], kFwdBlock * 64 * 2);
          hop::tma_load_2d(sm.w[st], &w_map, &sm.full[st], 64 * q,
                           blk * kFwdBlock);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hop::set_max_regs_inc<232>();
    const int cw = wg - 1;                      // rows [64 cw, 64 cw + 64)
    const int t = threadIdx.x & 127;
    const bool leader = t == 0;
    const int row0 = 16 * (t >> 5) + ((t & 31) >> 2);   // and row0 + 8
    int lab[2];
    float m_run[2], s_run[2], pick[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 64 * cw + row0 + 8 * h;
      lab[h] = r < B ? label[r] : -1;
      m_run[h] = kNeg;
      s_run[h] = 0.f;
      pick[h] = 0.f;
    }
    float acc[kFwdBlock / 2];
    hop::mbar_wait(&sm.code_full, 0);
    int g = 0;
    for (int blk = b0; blk < b1; ++blk) {
      int prev = -1;
#pragma unroll
      for (int q = 0; q < D / 64; ++q, ++g) {
        const int st = g % kFwdStages;
        hop::mbar_wait(&sm.full[st], (g / kFwdStages) & 1);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.code[q])
                  + cw * 64 * 128 + kk * 32,
              16, 1024);
          const uint64_t db = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.w[st]) + kk * 32, 16,
              1024);
          hop::wgmma<kFwdBlock, 0>(acc, da, db, q > 0 || kk > 0);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        if (prev >= 0 && leader) hop::mbar_arrive(&sm.empty[prev]);
        prev = st;
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (leader) hop::mbar_arrive(&sm.empty[prev]);

      const int v0 = blk * kFwdBlock;
      if (v0 + kFwdBlock > nv) {                // masked columns take kNeg
#pragma unroll
        for (int j = 0; j < kFwdBlock / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (v0 + 8 * j + 2 * (t & 3) + e >= nv) {
              acc[4 * j + e] = kNeg;
              acc[4 * j + 2 + e] = kNeg;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // picked: the label's column, when it is a valid one of this block
        const int jj = lab[h] - v0;
        if (jj >= 0 && jj < kFwdBlock && lab[h] < nv) {
#pragma unroll
          for (int j = 0; j < kFwdBlock / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (8 * j + 2 * (t & 3) + e == jj) {
                pick[h] += acc[4 * j + 2 * h + e];
              }
            }
          }
        }
        // online (m, s) over this thread's columns; the exponent on the
        // SFU (2^(l log2 e - m log2 e))
        float bm = kNeg;
#pragma unroll
        for (int j = 0; j < kFwdBlock / 8; ++j) {
          bm = fmaxf(bm, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        }
        const float m_new = fmaxf(m_run[h], bm);
        // while this thread has seen only masked columns (m_new == kNeg),
        // take their exponent against 0: 2^(kNeg log2 e) is 0, where
        // kNeg log2 e - m_new log2 e would be the rounding residue of two
        // products near 1.44e30 (up to ~1e23: an infinite s)
        const float m2 = m_new == kNeg ? 0.f : m_new * kLog2e;
        float bs = 0.f;
#pragma unroll
        for (int j = 0; j < kFwdBlock / 8; ++j) {
          bs += exp2_approx(fmaf(acc[4 * j + 2 * h], kLog2e, -m2))
                + exp2_approx(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -m2));
        }
        s_run[h] = s_run[h] * exp2_approx((m_run[h] - m_new) * kLog2e) + bs;
        m_run[h] = m_new;
      }
    }
    // the quad's four column sets merged, then one partial per row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m_run[h], off);
        const float s_o = __shfl_xor_sync(0xffffffffu, s_run[h], off);
        const float m_n = fmaxf(m_run[h], m_o);
        s_run[h] = s_run[h] * exp2_approx((m_run[h] - m_n) * kLog2e)
                   + s_o * exp2_approx((m_o - m_n) * kLog2e);
        m_run[h] = m_n;
        pick[h] += __shfl_xor_sync(0xffffffffu, pick[h], off);
      }
      const int r = r0 + 64 * cw + row0 + 8 * h;
      if ((t & 3) == 0 && r < B) {
        const long long o = static_cast<long long>(split) * B + r;
        part_m[o] = m_run[h];
        part_s[o] = s_run[h];
        part_p[o] = pick[h];
      }
    }
  }
}

template <int D>
cudaError_t fwd_bf16_d(const void* code, const void* w, const int* label,
                       int B, int V, int nv, int n_splits, float* part_m,
                       float* part_s, float* part_p, cudaStream_t s) {
  CUtensorMap code_map, w_map;
  cudaError_t err =
      hop::encode_tmap_2d(&code_map, code, B, D, D * 2, kFwdRows);
  if (err != cudaSuccess) return err;
  err = hop::encode_tmap_2d(&w_map, w, V, D, D * 2, kFwdBlock);
  if (err != cudaSuccess) return err;
  const size_t smem = fwd_smem_bytes<D>();
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ce_fwd_wgmma_kernel<D>, smem, allowed);
  const int n_blocks = (V + kFwdBlock - 1) / kFwdBlock;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const int row_tiles = (B + kFwdRows - 1) / kFwdRows;
  ce_fwd_wgmma_kernel<D><<<row_tiles * n_splits, kBwdThreads, smem, s>>>(
      code_map, w_map, label, B, nv, n_blocks, per_split, part_m, part_s,
      part_p);
  return cudaGetLastError();
}

cudaError_t fwd_bf16(const void* code, const void* w, const int* label,
                     int B, int V, int D, int nv, int n_splits,
                     float* part_m, float* part_s, float* part_p,
                     cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(code) & 15)
      || (reinterpret_cast<uintptr_t>(w) & 15)) {
    return cudaErrorMisalignedAddress;
  }
  switch (D) {
    case 128:
      return fwd_bf16_d<128>(code, w, label, B, V, nv, n_splits, part_m,
                             part_s, part_p, s);
    case 256:
      return fwd_bf16_d<256>(code, w, label, B, V, nv, n_splits, part_m,
                             part_s, part_p, s);
    case 384:
      return fwd_bf16_d<384>(code, w, label, B, V, nv, n_splits, part_m,
                             part_s, part_p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t bwd_bf16_d(const void* code, const void* w, const int* label,
                       const float* lse, const float* dlse,
                       const float* dpicked, int B, int V, int nv,
                       int n_splits, float* dw, float* part_dcode,
                       cudaStream_t s) {
  CUtensorMap code_map, w_map;
  cudaError_t err = hop::encode_tmap_2d(&code_map, code, B, D, D * 2, kBlk);
  if (err != cudaSuccess) return err;
  err = hop::encode_tmap_2d(&w_map, w, V, D, D * 2, kBlk);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem_bytes<D>();
  static size_t allowed_dw = 48 * 1024;
  static size_t allowed_dcode = 48 * 1024;
  c2v::allow_smem(ce_bwd_wgmma_kernel<D, true>, smem, allowed_dw);
  c2v::allow_smem(ce_bwd_wgmma_kernel<D, false>, smem, allowed_dcode);
  const int sms = hop::sm_count();
  const int n_blocks = V / kBlk;
  const int row_tiles = (B + kBlk - 1) / kBlk;
  ce_bwd_wgmma_kernel<D, true><<<min(n_blocks, sms), kBwdThreads, smem, s>>>(
      code_map, w_map, label, lse, dlse, dpicked, B, nv, n_blocks, 0,
      n_blocks, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const int units = row_tiles * n_splits;
  ce_bwd_wgmma_kernel<D, false><<<min(units, sms), kBwdThreads, smem, s>>>(
      code_map, w_map, label, lse, dlse, dpicked, B, nv, n_blocks, per_split,
      units, part_dcode);
  return cudaGetLastError();
}

cudaError_t bwd_bf16(const void* code, const void* w, const int* label,
                     const float* lse, const float* dlse,
                     const float* dpicked, int B, int V, int D, int nv,
                     int n_splits, float* dw, float* part_dcode,
                     cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(code) & 15)
      || (reinterpret_cast<uintptr_t>(w) & 15)) {
    return cudaErrorMisalignedAddress;
  }
  switch (D) {
    case 128:
      return bwd_bf16_d<128>(code, w, label, lse, dlse, dpicked, B, V, nv,
                             n_splits, dw, part_dcode, s);
    case 256:
      return bwd_bf16_d<256>(code, w, label, lse, dlse, dpicked, B, V, nv,
                             n_splits, dw, part_dcode, s);
    case 384:
      return bwd_bf16_d<384>(code, w, label, lse, dlse, dpicked, B, V, nv,
                             n_splits, dw, part_dcode, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t fwd(int dtype_code, const void* code, const void* w,
                const int* label, int B, int V, int D, int nv, int n_splits,
                float* part_m, float* part_s, float* part_p, float* lse,
                float* picked, cudaStream_t s) {
  cudaError_t err;
  if (dtype_code == 0) {
    const CeLayout<float> L(D);
    const size_t smem = L.bytes();
    static size_t allowed = 48 * 1024;
    c2v::allow_smem(ce_fwd_kernel<float>, smem, allowed);
    const int n_blocks = V / kVocab;
    const int per_split = (n_blocks + n_splits - 1) / n_splits;
    const dim3 grid((B + kRows - 1) / kRows, n_splits);
    ce_fwd_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(code), static_cast<const float*>(w), label,
        B, V, D, nv, per_split, part_m, part_s, part_p);
    err = cudaGetLastError();
  } else if (dtype_code == 1) {
    err = fwd_bf16(code, w, label, B, V, D, nv, n_splits, part_m, part_s,
                   part_p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  ce_merge_kernel<<<(B + 255) / 256, 256, 0, s>>>(part_m, part_s, part_p, B,
                                                  n_splits, lse, picked);
  return cudaGetLastError();
}

// dcode = the splits' partials summed in a fixed order
cudaError_t reduce_dcode(const float* part_dcode, int B, int D, int n_splits,
                         float* dcode, cudaStream_t s) {
  const long long n = static_cast<long long>(B) * D;
  ce_reduce_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, s>>>(
      part_dcode, n, n_splits, dcode);
  return cudaGetLastError();
}

cudaError_t bwd_fp32(const void* code, const void* w, const int* label,
                     const float* lse, const float* dlse,
                     const float* dpicked, int B, int V, int D, int nv,
                     int n_splits, float* dw, float* part_dcode,
                     cudaStream_t s) {
  const CeLayout<float> L(D);
  const size_t smem = L.bytes();
  static size_t allowed_dw = 48 * 1024;
  static size_t allowed_dcode = 48 * 1024;
  c2v::allow_smem(ce_bwd_dw_kernel<float>, smem, allowed_dw);
  c2v::allow_smem(ce_bwd_dcode_kernel<float>, smem, allowed_dcode);
  const int n_blocks = V / kVocab;
  ce_bwd_dw_kernel<float><<<n_blocks, kThreads, smem, s>>>(
      static_cast<const float*>(code), static_cast<const float*>(w), label,
      lse, dlse, dpicked, B, D, nv, dw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const dim3 grid((B + kRows - 1) / kRows, n_splits);
  ce_bwd_dcode_kernel<float><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(code), static_cast<const float*>(w), label,
      lse, dlse, dpicked, B, V, D, nv, per_split, part_dcode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Vocabulary rows per block: V must be a multiple of it.
int ce_vocab_block() { return kVocab; }

// dtype_code 0: float32 code and W (CUDA cores, 64-row tiles x 64-column
// blocks); 1: bfloat16 (wgmma fed by TMA, 128-row units x 128-column blocks;
// code and w 16-byte aligned). lse, picked (B,) f32 out; part_* (n_splits,
// B) scratch, n_splits vocabulary splits per row tile. The caller checks
// the shapes (D a multiple of 128, at most 384; V a multiple of 64).
// Returns cudaGetLastError() after the launches (0 = launched).
int ce_fwd(int dtype_code, const void* code, const void* w, const int* label,
           int B, int V, int D, int nv, int n_splits, float* part_m,
           float* part_s, float* part_p, float* lse, float* picked,
           void* stream) {
  if (B == 0) return 0;
  return static_cast<int>(fwd(dtype_code, code, w, label, B, V, D, nv,
                              n_splits, part_m, part_s, part_p, lse, picked,
                              static_cast<cudaStream_t>(stream)));
}

// dw (V, D) and dcode (B, D) f32 out; part_dcode (n_splits, B, D) scratch.
// bf16 runs on wgmma fed by TMA (code and w 16-byte aligned), fp32 on the
// CUDA cores.
int ce_bwd(int dtype_code, const void* code, const void* w, const int* label,
           const float* lse, const float* dlse, const float* dpicked, int B,
           int V, int D, int nv, int n_splits, float* dw, float* part_dcode,
           float* dcode, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = bwd_fp32(code, w, label, lse, dlse, dpicked, B, V, D, nv,
                   n_splits, dw, part_dcode, s);
  } else if (dtype_code == 1) {
    err = bwd_bf16(code, w, label, lse, dlse, dpicked, B, V, D, nv,
                   n_splits, dw, part_dcode, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) {
    err = reduce_dcode(part_dcode, B, D, n_splits, dcode, s);
  }
  return static_cast<int>(err);
}

const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
