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
// fp32, below: the same units on mma.sync in three TF32 terms (the TPU's
// Precision.HIGHEST counterpart).
// Every sum runs in a fixed order (K order inside wgmma and mma.sync,
// blocks in order, splits in order): no atomics, the same bits on every
// run.
//
// Bound at the training shape (B = 1024, V = 262,144, D = 384), on an
// H100 SXM: the forward is 2 B V D ~ 206 GFLOP -> ~0.21 ms at 989 TFLOP/s
// bf16 (its W read, 201 MB, is ~0.06 ms); the backward's least work is 3
// such products (~0.62 ms), this kernel does 4. Operations bound both (fp32:
// ~1.25 ms a product at 165 TFLOP/s, the three-term TF32 rate).
// The forward's W is read by 8 row tiles of 128 (1.6 GB from L2 at B =
// 1024).
//
// Shapes: D a multiple of 128 and at most 384; V a multiple of 64; code and
// W 16-byte aligned (bf16: TMA; fp32: cp.async).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using c2v::bf16;
using c2v::kNeg;
using t32::load_a_kmajor;
using t32::load_b_kmajor;
using t32::mma_tf32x3;
using t32::split_frag;
using t32::split_tf32;

constexpr int kVocab = 64;     // table rows per block: V is a multiple of it

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

// ------------------------------- fp32: three-term TF32 on mma.sync
// fp32 runs on the tensor cores as three TF32 products, the counterpart of
// the TPU kernels' Precision.HIGHEST (a multi-pass bf16 product on the
// matrix unit). Each fp32 operand a is split as a = hi + lo, hi = tf32(a)
// and lo = tf32(a - hi), both rounded by cvt.rna.tf32.f32 (to nearest,
// ties away from zero; the low 13 bits cleared; a - hi is exact in fp32),
// and each product is lo.hi + hi.lo + hi.hi with fp32 accumulation; lo.lo
// (~2^-22 of a term) is dropped. The split is made in registers from each
// fragment as it is read, so shared memory holds every operand once, in
// fp32. ops/ce.py::_mm_tf32x3 emulates the arithmetic for the tests.
//
// Tensor cores have been measured (on earlier parts) to add an
// instruction's products into its accumulator with truncation, so one
// long sum in one accumulator could drift by up to an ulp an instruction:
// every product is summed in chunks of 32 of K (12 instructions) into a
// fresh accumulator, and the chunks are added with fp32 FADDs (round to
// nearest).
//
// Operand layout. wgmma takes .tf32 operands K-major only (the transpose
// bits are for f16/bf16), and the backward's products read code and W
// MN-major (dW = dl^T code has K = batch, dcode = dl W has K = vocab).
// These kernels therefore use mma.sync.m16n8k8.tf32, whose fragments come
// from plain shared-memory reads in any order: K-major fragments by
// ldmatrix (a b16 8 x 8 matrix is an 8 x 4 fp32 one), MN-major ones by
// 32-bit loads. No transpose pass and no second copy of an operand; the
// cost is mma.sync's lower peak against wgmma, and three ALU instructions
// of the split per fragment element. Shared rows are padded by 4 floats:
// K-major reads are free of bank conflicts, MN-major ones two-way. The
// split, the products and the fragment loads are tf32.cuh's, shared with
// the fp32 routes of encode.cu and ragged_bwd.cu.
//
// ce_fwd_tf32_kernel has the bf16 forward's cut: a unit is 128 code rows
// x one vocabulary split of 128-row W blocks, the row tiles of a split
// neighbours in launch order (W read from device memory about once). Both
// operands stream in 32-column K slices through a ring of 4 cp.async
// stages (a code tile of 128 x 384 fp32 is 196 KB: it cannot stay). Eight
// warps, each 32 rows x 64 columns of the 128 x 128 logits, fold every
// block into a running (m, s, picked) per row (expf); the quad's columns
// are merged by shuffles, the two column warps through shared memory.
// ce_bwd_tf32_kernel<D, DW> has the bf16 backward's two passes: a unit
// holds a fixed 64 x D tile (pass 1: a W block; pass 2: a code tile) and
// streams 32-row blocks of the other operand, double-buffered (99 KB + 2 x
// 50 KB at D = 384). Per block: the 64 x 32 logits (K = D), dl into shared
// memory, acc (64 x D, 96 registers a thread at D = 384) += dl . block.
// Four products, as in the bf16 kernel: three would need either dW reduced
// over row tiles across CTAs (16 x 402 MB at B = 1024) or a read-modify-
// write of a (B, D) dcode partial per vocabulary block (~12.6 GB), each
// dearer than the fourth product (~1.25 ms at the three-term bound).
// Bound at the training shape (B = 1024, V = 262,144, D = 384): a product
// is 2 B V D ~ 206 GFLOP, ~1.25 ms at the three-term rate (495 / 3 =
// 165 TFLOP/s dense TF32); the forward ~1.25 ms, the backward ~5.0 ms (4
// products; 3.75 for three). Operations bound both.
constexpr int kT32Threads = 256;     // eight warps
constexpr int kT32K = t32::kK;       // K of a staged slice (fwd) or block (bwd)
constexpr int kT32Pad = t32::kPad;   // floats of padding a shared row
constexpr int kT32Ld = t32::kLd;
constexpr int kT32FwdRows = 128;     // code rows of a forward unit
constexpr int kT32FwdBlock = 128;    // W rows of a forward block
constexpr int kT32FwdStages = 4;
constexpr int kT32Fixed = 64;        // rows of the backward's fixed tile
constexpr int kT32Stream = 32;       // rows of a backward streamed block

// operand staging by the CTA's kT32Threads threads (tf32.cuh)
__device__ __forceinline__ void stage_f32(const float* __restrict__ src,
                                          long long ld_src, int n_rows,
                                          int row0, int rows, int col0,
                                          int cols, float* dst, int ld_dst) {
  t32::stage_f32<kT32Threads>(src, ld_src, n_rows, row0, rows, col0, cols,
                              dst, ld_dst);
}

// (m, s) of two column sets merged: s = s e^(m - m') + s_o e^(m_o - m')
__device__ __forceinline__ void fold_ms(float& m, float& s, float m_o,
                                        float s_o) {
  const float m_n = fmaxf(m, m_o);
  s = s * expf(m - m_n) + s_o * expf(m_o - m_n);
  m = m_n;
}

struct FwdT32Smem {
  float code[kT32FwdStages][kT32FwdRows * kT32Ld];
  float w[kT32FwdStages][kT32FwdBlock * kT32Ld];
};

// Unit blockIdx.x: row tile u % row_tiles (128 rows), split u / row_tiles
// (W blocks [split per_split, + per_split) of 128 rows). Warp (wm, wn)
// holds logits rows [32 wm, + 32) x block columns [64 wn, + 64); columns
// at or past nv are masked (kNeg): while a row has seen only masked
// columns its m is kNeg and each adds e^0 = 1, as the plain version's
// logsumexp over kNeg does, and the first valid column scales them away.
__global__ void __launch_bounds__(kT32Threads, 1) ce_fwd_tf32_kernel(
    const float* __restrict__ code, const float* __restrict__ w,
    const int* __restrict__ label, int B, int V, int D, int nv, int n_blocks,
    int per_split, float* __restrict__ part_m, float* __restrict__ part_s,
    float* __restrict__ part_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdT32Smem& sm = *reinterpret_cast<FwdT32Smem*>(smem_raw);
  const int row_tiles = (B + kT32FwdRows - 1) / kT32FwdRows;
  const int split = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - split * row_tiles) * kT32FwdRows;
  const int b0 = min(n_blocks, split * per_split);
  const int b1 = min(n_blocks, b0 + per_split);
  const int nk = D / kT32K;                 // slices a block
  const int total = (b1 - b0) * nk;
  auto load = [&](int it) {                 // slice it into its stage
    const int st = it % kT32FwdStages;
    const int k0 = (it % nk) * kT32K;
    stage_f32(code, D, B, r0, kT32FwdRows, k0, kT32K, sm.code[st], kT32Ld);
    stage_f32(w, D, V, (b0 + it / nk) * kT32FwdBlock, kT32FwdBlock, k0,
              kT32K, sm.w[st], kT32Ld);
  };
#pragma unroll
  for (int it = 0; it < kT32FwdStages - 1; ++it) {
    if (it < total) load(it);
    c2v::cp_async_commit();
  }
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  // this thread's rows 32 wm + 16 mt + 8 h + g
  int lab[2][2];
  float m_run[2][2], s_run[2][2], pick[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 32 * wm + 16 * mt + 8 * h + g;
      lab[mt][h] = r < B ? label[r] : -1;
      m_run[mt][h] = kNeg;
      s_run[mt][h] = 0.f;
      pick[mt][h] = 0.f;
    }
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int it = 0; it < total; ++it) {
    c2v::cp_async_wait<kT32FwdStages - 2>();
    __syncthreads();          // slice it landed; slice it - 1's stage free
    if (it + kT32FwdStages - 1 < total) load(it + kT32FwdStages - 1);
    c2v::cp_async_commit();
    const int st = it % kT32FwdStages;
    float part[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT32K / 8; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t raw[4];
        load_a_kmajor(raw, sm.code[st], kT32Ld, 32 * wm + 16 * mt, 8 * kk);
        split_frag(raw, ah[mt], al[mt]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t raw[4], bh[4], bl[4];
        load_b_kmajor(raw, sm.w[st], kT32Ld, 64 * wn + 16 * np, 8 * kk);
        split_frag(raw, bh, bl);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32x3(part[mt][2 * np], ah[mt], al[mt], bh[0], bh[1], bl[0],
                     bl[1]);
          mma_tf32x3(part[mt][2 * np + 1], ah[mt], al[mt], bh[2], bh[3],
                     bl[2], bl[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    if (it % nk != nk - 1) continue;
    // the block's logits are complete: fold them into the running stats
    const int v_base = (b0 + it / nk) * kT32FwdBlock + 64 * wn + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float bm = kNeg;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = v_base + 8 * nt + e;
            float& l = acc[mt][nt][2 * h + e];
            if (v >= nv) {
              l = kNeg;
            } else if (v == lab[mt][h]) {
              pick[mt][h] += l;
            }
            bm = fmaxf(bm, l);
          }
        }
        const float m_new = fmaxf(m_run[mt][h], bm);
        float bs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bs += expf(acc[mt][nt][2 * h + e] - m_new);
          }
        }
        s_run[mt][h] = s_run[mt][h] * expf(m_run[mt][h] - m_new) + bs;
        m_run[mt][h] = m_new;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  // the quad's four column sets, then the two column warps (wn 0 first)
  c2v::cp_async_wait<0>();
  __syncthreads();                          // the ring is free
  float* red = sm.code[0];                  // [wn][row][m, s, picked]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m_run[mt][h], off);
        const float s_o = __shfl_xor_sync(0xffffffffu, s_run[mt][h], off);
        fold_ms(m_run[mt][h], s_run[mt][h], m_o, s_o);
        pick[mt][h] += __shfl_xor_sync(0xffffffffu, pick[mt][h], off);
      }
      if (t == 0) {
        float* o = red + 3 * (wn * kT32FwdRows + 32 * wm + 16 * mt + 8 * h
                              + g);
        o[0] = m_run[mt][h];
        o[1] = s_run[mt][h];
        o[2] = pick[mt][h];
      }
    }
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row < kT32FwdRows && r0 + row < B) {
    const float* a = red + 3 * row;
    const float* b = red + 3 * (kT32FwdRows + row);
    float m = a[0], s = a[1];
    fold_ms(m, s, b[0], b[1]);
    const long long o = static_cast<long long>(split) * B + r0 + row;
    part_m[o] = m;
    part_s[o] = s;
    part_p[o] = a[2] + b[2];
  }
}

template <int D>
struct BwdT32Smem {
  static constexpr int kLd = D + kT32Pad;
  float fixed[kT32Fixed * kLd];
  float stream[2][kT32Stream * kLd];
  float dl[kT32Fixed * kT32Ld];     // dl (fixed rows x block rows), K-major
};

// Pass 1 (DW): unit u = W rows [64 u, + 64) (fixed) over every 32-row block
// of code; dl is (vocab r, batch row c) and its row parameters follow the
// column. Pass 2 (!DW): unit u = code rows of row tile u % row_tiles
// (fixed) over the W blocks of split u / row_tiles; dl is (batch row r,
// vocab c). out: dW (V, D), or the partials (n_splits, B, D). Warp w
// computes logits rows [16 (w % 4), + 16) x block rows [16 (w / 4), + 16)
// and acc rows 0..63 x columns [w D / 8, + D / 8).
template <int D, bool DW>
__global__ void __launch_bounds__(kT32Threads, 1) ce_bwd_tf32_kernel(
    const float* __restrict__ code, const float* __restrict__ w,
    const int* __restrict__ label, const float* __restrict__ lse,
    const float* __restrict__ dlse, const float* __restrict__ dpicked, int B,
    int V, int nv, int n_blocks, int per_split, float* __restrict__ out) {
  constexpr int kLd = BwdT32Smem<D>::kLd;
  constexpr int kNT = D / 64;               // n8 tiles of a warp's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdT32Smem<D>& sm = *reinterpret_cast<BwdT32Smem<D>*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  int fixed_row, s0, n, split = 0;
  if (DW) {
    fixed_row = blockIdx.x * kT32Fixed;
    s0 = 0;
    n = (B + kT32Stream - 1) / kT32Stream;
  } else {
    const int row_tiles = (B + kT32Fixed - 1) / kT32Fixed;
    split = blockIdx.x / row_tiles;
    fixed_row = (blockIdx.x - split * row_tiles) * kT32Fixed;
    s0 = min(n_blocks, split * per_split);
    n = min(n_blocks, s0 + per_split) - s0;
  }
  const float* fixed_src = DW ? w : code;
  const float* block_src = DW ? code : w;
  const int block_rows = DW ? B : V;
  stage_f32(fixed_src, D, DW ? V : B, fixed_row, kT32Fixed, 0, D, sm.fixed,
            kLd);
  c2v::cp_async_commit();
  if (n > 0) {
    stage_f32(block_src, D, block_rows, s0 * kT32Stream, kT32Stream, 0, D,
              sm.stream[0], kLd);
  }
  c2v::cp_async_commit();
  // dl's row parameters: pass 2 per fixed row (k = h), pass 1 per block
  // row (k = 2 nt + e); lse, dlse, dpicked, label
  float q_lse[4], q_dlse[4], q_dp[4];
  int q_lab[4];
  auto row_params = [&](int k, int r) {
    const bool in = r < B;
    q_lse[k] = in ? lse[r] : 0.f;
    q_dlse[k] = in ? dlse[r] : 0.f;
    q_dp[k] = in ? dpicked[r] : 0.f;
    q_lab[k] = in ? label[r] : -1;
  };
  if (!DW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) row_params(h, fixed_row + 16 * wm + 8 * h + g);
  }
  float acc[4][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int c0 = warp * (D / 8);            // this warp's output columns
  for (int i = 0; i < n; ++i) {
    const int srow0 = (s0 + i) * kT32Stream;  // the block's first row
    if (i + 1 < n) {
      stage_f32(block_src, D, block_rows, srow0 + kT32Stream, kT32Stream, 0,
                D, sm.stream[(i + 1) & 1], kLd);
    }
    c2v::cp_async_commit();
    if (DW) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row_params(2 * nt + e, srow0 + 16 * wn + 8 * nt + 2 * t + e);
    }
    c2v::cp_async_wait<1>();
    __syncthreads();                        // the fixed tile and block i
    const float* S = sm.stream[i & 1];
    // logits, K = D in chunks of 32 (a fresh accumulator each)
    float lg[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / kT32K; ++kc) {
      float part[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT32K / 8; ++kk) {
        const int k0 = kc * kT32K + 8 * kk;
        uint32_t raw[4], ah[4], al[4], rb[4], bh[4], bl[4];
        load_a_kmajor(raw, sm.fixed, kLd, 16 * wm, k0);
        split_frag(raw, ah, al);
        load_b_kmajor(rb, S, kLd, 16 * wn, k0);
        split_frag(rb, bh, bl);
        mma_tf32x3(part[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_tf32x3(part[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) lg[nt][e] += part[nt][e];
    }
    // dl (fp32: no rounding) into sm.dl[fixed row][block row]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fr = 16 * wm + 8 * h + g;
        const int sc = 16 * wn + 8 * nt + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = DW ? 2 * nt + e : h;
          const int vocab = DW ? fixed_row + fr : srow0 + sc + e;
          const int brow = DW ? srow0 + sc + e : fixed_row + fr;
          const bool valid = vocab < nv && brow < B;
          const float p =
              valid ? expf(lg[nt][2 * h + e] - q_lse[k]) : 0.f;
          const float onehot = (valid && vocab == q_lab[k]) ? 1.f : 0.f;
          v[e] = q_dlse[k] * p + q_dp[k] * onehot;
        }
        *reinterpret_cast<float2*>(&sm.dl[fr * kT32Ld + sc]) =
            make_float2(v[0], v[1]);
      }
    }
    __syncthreads();                        // dl complete
    // acc += dl . block, one m16 row tile at a time, each block's sum in a
    // fresh accumulator (K = 32)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float part[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT32Stream / 8; ++kk) {
        uint32_t raw[4], ah[4], al[4];
        load_a_kmajor(raw, sm.dl, kT32Ld, 16 * mt, 8 * kk);
        split_frag(raw, ah, al);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          // B (n = output column, k = block row), MN-major
          const float* bp = S + (8 * kk + t) * kLd + c0 + 8 * nt + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(__float_as_uint(bp[0]), bh0, bl0);
          split_tf32(__float_as_uint(bp[4 * kLd]), bh1, bl1);
          mma_tf32x3(part[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
    }
    __syncthreads();                        // block i and dl free
  }
  c2v::cp_async_wait<0>();
  float* dst = out;
  int rows = kT32Fixed;
  if (DW) {
    dst += static_cast<long long>(fixed_row) * D;
  } else {
    dst += (static_cast<long long>(split) * B + fixed_row) * D;
    rows = min(kT32Fixed, B - fixed_row);
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + 8 * h + g;
        if (r < rows) {
          *reinterpret_cast<float2*>(dst + static_cast<long long>(r) * D + c0
                                     + 8 * nt + 2 * t) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
}

cudaError_t fwd_tf32(const void* code, const void* w, const int* label,
                     int B, int V, int D, int nv, int n_splits,
                     float* part_m, float* part_s, float* part_p,
                     cudaStream_t s) {
  if (t32::misaligned16(code) || t32::misaligned16(w)) {
    return cudaErrorMisalignedAddress;
  }
  const size_t smem = sizeof(FwdT32Smem);
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ce_fwd_tf32_kernel, smem, allowed);
  const int n_blocks = (V + kT32FwdBlock - 1) / kT32FwdBlock;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const int row_tiles = (B + kT32FwdRows - 1) / kT32FwdRows;
  ce_fwd_tf32_kernel<<<row_tiles * n_splits, kT32Threads, smem, s>>>(
      static_cast<const float*>(code), static_cast<const float*>(w), label,
      B, V, D, nv, n_blocks, per_split, part_m, part_s, part_p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_tf32_d(const float* code, const float* w, const int* label,
                       const float* lse, const float* dlse,
                       const float* dpicked, int B, int V, int nv,
                       int n_splits, float* dw, float* part_dcode,
                       cudaStream_t s) {
  const size_t smem = sizeof(BwdT32Smem<D>);
  static size_t allowed_dw = 48 * 1024;
  static size_t allowed_dcode = 48 * 1024;
  c2v::allow_smem(ce_bwd_tf32_kernel<D, true>, smem, allowed_dw);
  c2v::allow_smem(ce_bwd_tf32_kernel<D, false>, smem, allowed_dcode);
  ce_bwd_tf32_kernel<D, true><<<V / kT32Fixed, kT32Threads, smem, s>>>(
      code, w, label, lse, dlse, dpicked, B, V, nv, 0, 0, dw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_blocks = V / kT32Stream;
  const int per_split = (n_blocks + n_splits - 1) / n_splits;
  const int row_tiles = (B + kT32Fixed - 1) / kT32Fixed;
  ce_bwd_tf32_kernel<D, false>
      <<<row_tiles * n_splits, kT32Threads, smem, s>>>(
          code, w, label, lse, dlse, dpicked, B, V, nv, n_blocks, per_split,
          part_dcode);
  return cudaGetLastError();
}

cudaError_t bwd_tf32(const void* code, const void* w, const int* label,
                     const float* lse, const float* dlse,
                     const float* dpicked, int B, int V, int D, int nv,
                     int n_splits, float* dw, float* part_dcode,
                     cudaStream_t s) {
  if (t32::misaligned16(code) || t32::misaligned16(w)) {
    return cudaErrorMisalignedAddress;
  }
  const float* c = static_cast<const float*>(code);
  const float* t = static_cast<const float*>(w);
  switch (D) {
    case 128:
      return bwd_tf32_d<128>(c, t, label, lse, dlse, dpicked, B, V, nv,
                             n_splits, dw, part_dcode, s);
    case 256:
      return bwd_tf32_d<256>(c, t, label, lse, dlse, dpicked, B, V, nv,
                             n_splits, dw, part_dcode, s);
    case 384:
      return bwd_tf32_d<384>(c, t, label, lse, dlse, dpicked, B, V, nv,
                             n_splits, dw, part_dcode, s);
    default:
      return cudaErrorInvalidValue;
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
    err = fwd_tf32(code, w, label, B, V, D, nv, n_splits, part_m, part_s,
                   part_p, s);
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

}  // namespace

extern "C" {

// Vocabulary rows per block: V must be a multiple of it.
int ce_vocab_block() { return kVocab; }

// dtype_code 0: float32 code and W (three-term TF32 on mma.sync, operands
// by cp.async); 1: bfloat16 (wgmma fed by TMA); both 128-row units x
// 128-column blocks, code and w 16-byte aligned. lse, picked (B,) f32 out;
// part_* (n_splits,
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
// bf16 runs on wgmma fed by TMA, fp32 in three TF32 terms on mma.sync (code
// and w 16-byte aligned for both).
int ce_bwd(int dtype_code, const void* code, const void* w, const int* label,
           const float* lse, const float* dlse, const float* dpicked, int B,
           int V, int D, int nv, int n_splits, float* dw, float* part_dcode,
           float* dcode, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0) {
    err = bwd_tf32(code, w, label, lse, dlse, dpicked, B, V, D, nv,
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
