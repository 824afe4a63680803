// Ragged fused encode + attention statistics straight off the packed wire,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel code2vec_tpu/ops/pallas_ragged.py::
// _ragged_kernel (launched by _stats_pallas). Same outputs, so the shared
// finish (code2vec_tpu_torch/ops/ragged.py::_finish) serves both this kernel
// and its plain PyTorch version:
//   scores (N,) f32   per packed slot, -1e30 where the slot is invalid
//   m, z   (B,) f32   per example: max score, sum of exp(score - m)
//   acc    (B, D) f32 per example: sum of exp(score - m) * x
// with, per valid slot t of example b (segment [start_b, start_b+count_b)):
//   x_t = tanh(tok[src_t] W_src + path[pth_t] W_path + tok[tgt_t] W_tgt)
//   s_t = x_t . attention
// A slot is valid iff it lies in its example's segment and any of its three
// indices is not PAD (interior holes drop out). Training runs the same
// kernels on the fp32 master tables, each element rounded to the compute
// type as it is loaded (the reference's take, then astype: no per-step cast
// of ~1.7 GB of tables), with an optional (N, K) uint8 dropout keep mask
// applied to the gathered rows (e / keep where kept, 0 elsewhere): the mask
// the backward (ragged_bwd.cu) applies too.
//
// The TPU kernel walks the slot tiles in order on one core, resolves
// segment membership with a (T, n_seg) one-hot on the MXU and keeps (m, z,
// acc) for ALL examples in VMEM, rescaling them tile by tile. On Hopper
// blocks run in parallel and in no order, so each route writes per-piece
// partial statistics and ragged_merge_kernel folds each example's pieces
// with the FuseMax rescale (m = max m_i, z = sum z_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m)) in a fixed order. x stays fp32 for the score
// and the weighted sum, as in the Pallas kernel.
//
// fp32 (COMPUTE_DTYPE float32: the fp32 training path and the mesh's fp32
// train()), the bf16 route's tiles and pair map with every product as
// three TF32 terms on the tensor cores (tf32.cuh: hi/lo split by cvt.rna
// in registers, lo.hi + hi.lo + hi.hi on mma.sync.m16n8k8), the
// counterpart of the reference's Precision.HIGHEST, as the fp32 backward
// (ragged_bwd.cu) recomputes x. The tensor cores truncate as they
// accumulate, so each 32 of K is summed in a fresh accumulator and the
// sums added with FADD, in the fp32 backward's chunks and order: the
// forward forms the x that the backward recomputes. The launches:
//   ragged_fwd_plan_kernel: the pair map, as below;
//   ragged_fwd_gather_kernel<float, float>: the live tiles' rows, the
//      keep mask applied, into an (N, K) fp32 stream (on a mesh the
//      stream is given: no gather);
//   ragged_fwd_tile_tf32_kernel: one CTA per 64-slot tile (eight warps;
//      a tile holding no slot of an example writes its scores -1e30 and
//      stops). x = e W in 128-column blocks: e's 32-wide K slices
//      (K-major, ldmatrix) and W's 32-row slices (W is (K, D) row-major,
//      already the MN-major B operand: 32-bit loads from rows of 136
//      floats, free of bank conflicts; no W^T copy) stream by cp.async
//      through a ring of kT32Stages stages. tanh(x) stays in shared
//      memory (99 KB at D = 384, so the accumulators hold one 64 x 128
//      block: no spill); then, in fp32 and a fixed order: each row's
//      score by a warp in the fp32 backward's order (lanes' fma chains
//      over the blocks, then an xor tree), each pair's m and z by warp 0's
//      segmented scans (the bf16 kernel's), p = exp(s - m), and each
//      pair's acc = sum p x by one thread a column over the tile's rows
//      in order. Above D = 384 x does not fit beside the ring: the blocks
//      run twice, the scores from the first pass, acc from the second (x
//      recomputed);
//   ragged_merge_kernel: each example's partials folded.
// Gathering the rows inside the tile kernel instead (16-byte cp.async of
// table rows, the keep mask applied by the thread that copied them once
// its copies land) saves the stream's write and reads but was slower on
// an H100 (PERF.md): the stream stays.
//
// bf16 (the serving and training compute type), on Hopper's own hardware.
// The flat stream is cut into fixed 64-slot tiles (one wgmma M, as the TPU
// kernel walks SLOT_TILE rows of it), whatever the context counts, so a
// tile spans examples. Each (tile, example) pair writes one partial, at the
// pair index of its slots (-1 for a slot outside every example), numbered
// in example order; an example lies in one tile unless it crosses a tile
// edge, so there are at most batch + n_tiles pairs. The launches:
//   ragged_fwd_plan_kernel:   the pair map (one CTA: two block scans over
//                             the examples, then each example's slots);
//   ragged_fwd_gather_kernel: fp32 masters or a keep mask only: one CTA
//                             per tile that holds a slot of an example
//                             gathers its rows (rounded to bf16, the mask
//                             applied) into an (N, K) bf16 e stream. Fused
//                             into the tile kernel's producer warps this
//                             gather lost: 96 threads per SM keep too few
//                             random row reads in flight for a tile of fp32
//                             rows in the time the consumers take (PERF.md);
//                             a grid of 256-thread CTAs keeps the memory
//                             busy;
//   ragged_fwd_tile_kernel:   one persistent CTA per SM over the live tiles,
//                             three warpgroups. Producer warp 0 streams W
//                             (K x D, 288 KiB: more than a CTA holds) from
//                             L2 by TMA in 32-row slices through a ring of
//                             kWStages stages, every column of the slice,
//                             and loads the tile's e rows from the stream by
//                             TMA into a ring of two e tiles (128-byte
//                             swizzle). From bf16 tables without a mask
//                             (serving), producer warps 1-3 gather the rows
//                             into that ring instead, by 16-byte cp.async
//                             (all of a thread's copies in flight, no
//                             registers): there the gather hides behind the
//                             W stream, and the e stream would only add its
//                             own traffic. Two consumer
//                             warpgroups: x = e W for half of D each (wgmma
//                             m64n{D/2}, A = e K-major, B = the W slice
//                             MN-major through the descriptor's transpose);
//                             tanh in registers; each row's score from the
//                             two halves' partials met in shared memory;
//                             then, in fp32 on the CUDA cores and in a
//                             fixed order (no atomics), each pair's tile
//                             statistics: m by a segmented max scan over
//                             the 64 rows, z and acc = sum p x by segmented
//                             sum scans (acc in registers: across a warp's
//                             rows by shuffles, across warps through shared
//                             memory), written by the threads that hold the
//                             pair's last row. A pair whose rows are all
//                             invalid writes m = -1e30, z = 0, acc = 0;
//   ragged_merge_kernel:      each example's partials folded.
//
// Bound at the serving shape (B = 1024, java14m fill: ~37.4K retained
// slots, d = 128/128, K = D = 384), on an H100 SXM: bytes (gathered bf16
// rows, triples, W, the outputs) ~31 MB -> ~0.009 ms at 3.35 TB/s;
// operations 2 x 37.4K x 384 x 384 ~ 11 GFLOP -> ~0.011 ms at 989 TFLOP/s
// bf16. Training's fp32 masters double the rows' bytes and add the mask
// (~75 MB, ~0.022 ms): bound by bytes. This design reads all of W from L2
// for every 64-slot tile (~585 tiles x 288 KiB ~ 0.17 GB of L2 reads),
// its floor, and in training also writes and reads the e stream (~29 MB
// each way). fp32 (training shape, ~38.9K slots): the same ~11 GFLOP as
// three TF32 terms at 165 TFLOP/s, ~0.067 ms, against ~0.09 GB of bytes
// (~0.027 ms): bound by operations. This design also writes the e stream
// (~60 MB) and reads it once a 128-column block (three times at D = 384),
// and reads W (576 KiB) from L2 once a tile.
//
// Shapes: fp32: dt, dp multiples of 4, 16 <= D <= 1024 (K padded to a
// multiple of 32 and D to one of 128 with zeros in shared memory; W's row
// stride ldw a multiple of 4), the tables, W and a given stream 16-byte
// aligned, the keep mask 4-byte aligned; bf16: K = 2 dt + dp a multiple
// of 64, at most 384, dt and dp multiples of 8, D in {128, 256, 384}, W,
// the tables and the keep mask 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using c2v::bf16;
using c2v::kNeg;

// ---------------------------------------------------------------- merge
// the FuseMax factor of a partial with maximum m_i under the maximum m
__device__ __forceinline__ float rescale(float m_i, float m) {
  return expf(m_i - m);
}

// Per example b: fold its n[b] partials, from index first[b] on, with the
// FuseMax rescale, m = max m_i, z = sum z_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m). An example without a partial (count 0) gets
// m = -1e30, z = 0, acc = 0.
__global__ void ragged_merge_kernel(
    const int* __restrict__ first, const int* __restrict__ n, int D,
    const float* __restrict__ part_m, const float* __restrict__ part_z,
    const float* __restrict__ part_acc, float* __restrict__ m_out,
    float* __restrict__ z_out, float* __restrict__ acc_out) {
  const int b = blockIdx.x;
  const int i0 = first[b];
  const int n_parts = n[b];
  float m = kNeg;
  for (int i = 0; i < n_parts; ++i) m = fmaxf(m, part_m[i0 + i]);
  if (threadIdx.x == 0) {
    float z = 0.f;
    for (int i = 0; i < n_parts; ++i) {
      z += part_z[i0 + i] * rescale(part_m[i0 + i], m);
    }
    m_out[b] = m;
    z_out[b] = z;
  }
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n_parts; ++i) {
      acc += part_acc[static_cast<long long>(i0 + i) * D + j]
             * rescale(part_m[i0 + i], m);
    }
    acc_out[static_cast<long long>(b) * D + j] = acc;
  }
}

// ------------------------------------------------ bf16 (wgmma, TMA)
constexpr int kTile = 64;            // slots per tile: one wgmma M
constexpr int kWgThreads = 384;      // producer + two consumer warpgroups
constexpr int kGatherThreads = 96;   // producer warps 1-3 (rows gathered)
constexpr int kGatherCta = 256;      // threads of the gather kernel
constexpr int kMaxK = 384;
constexpr int kEStages = 2;          // e tiles in flight
constexpr int kWStages = 4;          // W slices in flight
constexpr int kWRows = 32;           // K rows per W slice
constexpr int kBoxE = 64 * 64;       // bf16 elements of a 64-row e box
constexpr int kBoxW = kWRows * 64;   // of a 32-row W box
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of ragged_fwd_tile_kernel: every box 1024-byte aligned.
template <int D>
struct FwdSmem {
  bf16 e[kEStages][kMaxK / 64][kBoxE];     // e tile: 64-column boxes of K
  bf16 w[kWStages][D / 64][kBoxW];         // W slice: 32 rows, every column
  float attn[D];
  float red[2][2][kTile];    // [tile parity][consumer][row]: score partials
  int pid[2][kTile];         // [tile parity][row]: pair, -1 outside
  int valid[2][kTile];
  float carry[2][3][D / 2];  // [consumer][warp 0-2]: its last row's sums
  int idx[3 * kTile];        // the tile's (src, pth, tgt) (rows gathered)
  uint64_t e_full[kEStages], e_empty[kEStages];
  uint64_t w_full[kWStages], w_empty[kWStages];
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 1024;   // room to align the base to 1024
}

constexpr int kPlanThreads = 1024;

// Exclusive prefix sum of `v` over the block (kPlanThreads threads, in
// thread order) plus `carry`; the block's total is added to carry. `red`:
// 32 ints of shared scratch.
__device__ __forceinline__ int block_scan(int v, int& carry, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += o;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = red[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += o;
    }
    red[lane] = w;                     // inclusive over the warps
  }
  __syncthreads();
  const int out = carry + (warp > 0 ? red[warp - 1] : 0) + x - v;
  const int total = red[31];
  __syncthreads();                     // red is reused by the next scan
  carry += total;
  return out;
}

// The pair map of the flat (shards x cap) stream (one CTA; the plain twin
// is ops/ragged.py::_pair_map): example b = d per_shard + i has the
// segment [start_b, start_b + count_b) with start_b = d cap + the counts
// of the shard's earlier examples, n_pairs[b] tiles of 64 slots
// (0 for count 0), its pairs from pair_start[b] (examples in order); a
// slot of the segment takes the pair of its tile, any other slot -1.
__global__ void __launch_bounds__(kPlanThreads) ragged_fwd_plan_kernel(
    const int* __restrict__ count, int shards, int per_shard, int cap,
    int* __restrict__ pair_start, int* __restrict__ n_pairs,
    int* __restrict__ pair) {
  __shared__ int red[32];
  __shared__ int ex_start[kPlanThreads], ex_count[kPlanThreads];
  __shared__ int ex_base[kPlanThreads];
  const int lane = threadIdx.x & 31;
  const long long n_slots = static_cast<long long>(shards) * cap;
  for (long long q = threadIdx.x; q < n_slots; q += kPlanThreads) {
    pair[q] = -1;
  }
  int pairs = 0;                       // the pairs of the earlier examples
  for (int d = 0; d < shards; ++d) {
    int fill = 0;                      // the shard's slots so far
    for (int i0 = 0; i0 < per_shard; i0 += kPlanThreads) {
      const int i = i0 + threadIdx.x;
      const int b = d * per_shard + i;
      const int c = i < per_shard ? count[b] : 0;
      const int start = d * cap + block_scan(c, fill, red);
      const int n = c > 0 ? (start + c - 1) / kTile - start / kTile + 1 : 0;
      const int first = block_scan(n, pairs, red);
      if (i < per_shard) {
        pair_start[b] = first;
        n_pairs[b] = n;
      }
      ex_start[threadIdx.x] = start;
      ex_count[threadIdx.x] = c;
      ex_base[threadIdx.x] = first - start / kTile;
      __syncthreads();   // (the -1 fill is ordered before by the scans')
      // one warp per example of the chunk, its lanes over the slots
      for (int e = threadIdx.x >> 5; e < kPlanThreads; e += 32) {
        const int start_e = ex_start[e];
        for (int t = lane; t < ex_count[e]; t += 32) {
          pair[start_e + t] = ex_base[e] + (start_e + t) / kTile;
        }
      }
      __syncthreads();   // the chunk's arrays are read
    }
  }
}

// Whether tile `slot0` holds a slot of some example; every lane of the
// calling warp gets the same answer (each warp decides on its own).
__device__ __forceinline__ bool tile_live(const int* __restrict__ pair,
                                          long long n_slots, long long slot0,
                                          int lane) {
  const long long s0 = slot0 + lane, s1 = slot0 + 32 + lane;
  const bool mine = (s0 < n_slots && pair[s0] >= 0)
                    || (s1 < n_slots && pair[s1] >= 0);
  return __any_sync(kFull, mine);
}

template <bool kMax>
__device__ __forceinline__ float combine(float earlier, float later) {
  return kMax ? fmaxf(earlier, later) : earlier + later;
}

// Inclusive segmented scan over the tile's 64 rows, forward, in one warp:
// lane l holds rows 2l (a) and 2l + 1 (b), with pair ids pa, pb; a segment
// is a run of rows with one id (a pair's rows are contiguous, so a row adds
// a value of another row only when both carry its id). A fixed order.
template <bool kMax>
__device__ __forceinline__ void seg_scan_up(float& a, float& b, int pa,
                                            int pb, int lane) {
  if (pb == pa) b = combine<kMax>(a, b);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, b, d);
    const int po = __shfl_up_sync(kFull, pb, d);
    if (lane >= d && po == pb) b = combine<kMax>(o, b);
  }
  const float o = __shfl_up_sync(kFull, b, 1);
  const int po = __shfl_up_sync(kFull, pb, 1);
  if (lane >= 1 && po == pa) a = combine<kMax>(o, a);
}

// The same from the last row down (a suffix scan).
template <bool kMax>
__device__ __forceinline__ void seg_scan_down(float& a, float& b, int pa,
                                              int pb, int lane) {
  if (pa == pb) a = combine<kMax>(b, a);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_down_sync(kFull, a, d);
    const int po = __shfl_down_sync(kFull, pa, d);
    if (lane + d < 32 && po == pa) a = combine<kMax>(o, a);
  }
  const float o = __shfl_down_sync(kFull, a, 1);
  const int po = __shfl_down_sync(kFull, pa, 1);
  if (lane < 31 && po == pb) b = combine<kMax>(o, b);
}

// two values rounded to bf16, as the 32 bits of a bf16 pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight consecutive elements of the e stream (16-byte aligned)
__device__ __forceinline__ void store8(bf16* p, float4 lo, float4 hi) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                 pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

// A row's element `col` of a table: clamped into the table, or, on a mesh
// (`ranged`: the table holds rows [lo, lo + rows) of the model-sharded
// table), nullptr for a row another rank holds (it reads as zeros).
template <typename TT>
__device__ __forceinline__ const TT* table_row(const TT* table, int idx,
                                               long long lo, long long rows,
                                               int ranged, int dim, int col) {
  if (ranged) {
    const long long r = static_cast<long long>(idx) - lo;
    return r >= 0 && r < rows ? table + r * dim + col : nullptr;
  }
  return table + c2v::clamp_row(idx, rows) * dim + col;
}

template <typename TT>
__device__ __forceinline__ float4 load4_or_zero(const TT* p) {
  return p == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f) : c2v::load4(p);
}

// The gather of the live tiles' rows into the (N, K) e stream of TO (bf16;
// fp32 for a mesh's fp32 route), one CTA per 64-slot tile: row t is
// [tok[src_t]; path[pth_t]; tok[tgt_t]], each element rounded to TO (a
// no-op for fp32) and, with a keep mask, divided by the keep rate and
// rounded again where kept, zero where dropped. Chunks of 16 bytes of
// TO (eight bf16 or four fp32 elements: dt, dp multiples of 8 or 4), four
// chunks' loads in flight per thread before the stores. A tile that holds no slot of an example is skipped (the tile
// kernel skips it too), so its rows are not written; with no pair map
// (pair == nullptr) every tile is written. On a mesh (`ranged`) the tables
// are this rank's row slices [tok_lo, tok_lo + tok_rows) and [path_lo,
// path_lo + path_rows) of the sharded tables, the indices global, and the
// parts of a row that another rank holds come out zero: the sum of the
// ranks' streams over the model axis is the whole stream, exactly.
template <typename TT, typename TO>
__global__ void __launch_bounds__(kGatherCta) ragged_fwd_gather_kernel(
    const TT* __restrict__ tok, long long tok_lo, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_lo, long long path_rows,
    int ranged, int dt, int dp, const int* __restrict__ ctx,
    const int* __restrict__ pair, long long n_slots,
    const uint8_t* __restrict__ keep, float keep_rate,
    TO* __restrict__ e) {
  __shared__ int idx_s[3 * kTile];
  const long long slot0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nt = static_cast<int>(
      min(static_cast<long long>(kTile), n_slots - slot0));
  const int t = threadIdx.x;
  if (pair != nullptr &&
      !__syncthreads_or(t < nt && pair[slot0 + t] >= 0)) {
    return;
  }
  if (t < nt) {
    const int* c = ctx + 3 * (slot0 + t);
    idx_s[3 * t] = c[0];
    idx_s[3 * t + 1] = c[1];
    idx_s[3 * t + 2] = c[2];
  }
  __syncthreads();
  constexpr int kC = 16 / sizeof(TO);            // elements a chunk
  const int K = 2 * dt + dp;
  const int kc = K / kC;                         // chunks per row
  const int total = nt * kc;
  const float rate_t = c2v::round_to<TO>(keep_rate);
#pragma unroll 4
  for (int q = t; q < total; q += kGatherCta) {
    const int r = q / kc;
    const int c = kC * (q - r * kc);
    const TT* src;
    if (c < dt) {
      src = table_row(tok, idx_s[3 * r], tok_lo, tok_rows, ranged, dt, c);
    } else if (c < dt + dp) {
      src = table_row(path_tab, idx_s[3 * r + 1], path_lo, path_rows, ranged,
                      dp, c - dt);
    } else {
      src = table_row(tok, idx_s[3 * r + 2], tok_lo, tok_rows, ranged, dt,
                      c - dt - dp);
    }
    const long long o = (slot0 + r) * K + c;
    const uint8_t* kp = keep == nullptr ? nullptr : keep + o;
    const float4 lo = c2v::round_keep<TO>(load4_or_zero(src), kp, rate_t);
    if constexpr (kC == 4) {
      *reinterpret_cast<float4*>(e + o) = lo;
    } else {
      const float4 hi = c2v::round_keep<TO>(
          load4_or_zero(src == nullptr ? src : src + 4),
          kp == nullptr ? nullptr : kp + 4, rate_t);
      store8(e + o, lo, hi);
    }
  }
}

// The fused gather of one tile by the producer warps 1-3 (bf16 tables, no
// mask): rows [slot0, slot0 + nt) of the stream, triples in sm.idx, into
// the e tile `e` (K/64 boxes, 128-byte swizzle) by 16-byte cp.async, all
// of a thread's copies in flight at once without registers, complete on
// return; rows past the stream are zero.
template <int D>
__device__ __forceinline__ void gather_tile(
    FwdSmem<D>& sm, bf16 (*e)[kBoxE], const bf16* __restrict__ tok,
    long long tok_rows, const bf16* __restrict__ path_tab,
    long long path_rows, int dt, int dp, int nt, int gt) {
  const int k8 = (2 * dt + dp) / 8;              // 16-byte chunks per row
#pragma unroll 1
  for (int q = gt; q < kTile * k8; q += kGatherThreads) {
    const int r = q / k8;
    const int c = 8 * (q - r * k8);
    const bool in = r < nt;
    const bf16* src = tok;
    if (in) {
      if (c < dt) {
        src = tok + c2v::clamp_row(sm.idx[3 * r], tok_rows) * dt + c;
      } else if (c < dt + dp) {
        src = path_tab + c2v::clamp_row(sm.idx[3 * r + 1], path_rows) * dp
              + (c - dt);
      } else {
        src = tok + c2v::clamp_row(sm.idx[3 * r + 2], tok_rows) * dt
              + (c - dt - dp);
      }
    }
    c2v::cp_async16(reinterpret_cast<unsigned char*>(e[c / 64])
                        + hop::sw128_offset(r, c % 64),
                    src, in);
  }
  c2v::cp_async_commit();
  c2v::cp_async_wait<0>();
}

// The per-tile statistics of every (tile, example) pair (design note
// above). kGather: the producer warps gather the rows from bf16 tables;
// else e comes by TMA from the stream the gather kernel wrote. out: scores
// (N,) for every slot of the stream; part_m, part_z (pairs,) and part_acc
// (pairs, D) at each pair's index.
template <int D, bool kGather>
__global__ void __launch_bounds__(kWgThreads, 1) ragged_fwd_tile_kernel(
        const __grid_constant__ CUtensorMap e_map,
        const __grid_constant__ CUtensorMap w_map,
        const bf16* __restrict__ tok, long long tok_rows,
        const bf16* __restrict__ path_tab, long long path_rows, int dt,
        int dp, const bf16* __restrict__ attn, const int* __restrict__ ctx,
        const int* __restrict__ pair, int token_pad, int path_pad,
        long long n_slots, int n_tiles, float* __restrict__ scores,
        float* __restrict__ part_m, float* __restrict__ part_z,
        float* __restrict__ part_acc) {
  constexpr int kN = D / 2;            // x columns per consumer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int K = 2 * dt + dp;
  const int n_slices = K / kWRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kEStages; ++s) {
      hop::mbar_init(&sm.e_full[s], kGather ? kGatherThreads : 1);
      hop::mbar_init(&sm.e_empty[s], 2);
    }
    for (int s = 0; s < kWStages; ++s) {
      hop::mbar_init(&sm.w_full[s], 1);
      hop::mbar_init(&sm.w_empty[s], 2);
    }
    hop::fence_barrier_init();
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    sm.attn[c] = __bfloat162float(attn[c]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x < 32) {
    // --------------------------------- producer: W (and e) by TMA, one warp
    if (lane == 0) {
      hop::prefetch_tmap(&w_map);
      if (!kGather) hop::prefetch_tmap(&e_map);
    }
    int it = 0;                        // live tiles begun so far
    int st = 0, phase = 0;             // the next W stage and its parity
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long slot0 = static_cast<long long>(tile) * kTile;
      if (!tile_live(pair, n_slots, slot0, lane)) continue;
      if (!kGather && lane == 0) {
        const int es = it % kEStages;
        hop::mbar_wait(&sm.e_empty[es], ((it / kEStages) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.e_full[es], K * kTile * 2);
        for (int b = 0; b < K / 64; ++b) {
          hop::tma_load_2d(sm.e[es][b], &e_map, &sm.e_full[es], 64 * b,
                           static_cast<int>(slot0));
        }
      }
      ++it;
      for (int q = 0; q < n_slices; ++q) {
        if (lane == 0) {
          hop::mbar_wait(&sm.w_empty[st], phase ^ 1);
          hop::mbar_arrive_expect_tx(&sm.w_full[st], (D / 64) * kBoxW * 2);
#pragma unroll
          for (int j = 0; j < D / 64; ++j) {
            hop::tma_load_2d(sm.w[st][j], &w_map, &sm.w_full[st], 64 * j,
                             kWRows * q);
          }
        }
        if (++st == kWStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else if (wg == 0) {
    // ------------------------ producer warps 1-3: the rows (bf16 tables)
    if (!kGather) return;
    const int gt = threadIdx.x - 32;
    int it = 0;                        // live tiles gathered so far
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long slot0 = static_cast<long long>(tile) * kTile;
      if (!tile_live(pair, n_slots, slot0, lane)) continue;
      const int es = it % kEStages;
      const int nt = static_cast<int>(
          min(static_cast<long long>(kTile), n_slots - slot0));
      hop::mbar_wait(&sm.e_empty[es], ((it / kEStages) & 1) ^ 1);
      hop::named_sync(4, kGatherThreads);   // the last tile's triples read
      if (gt < nt) {
        const int* c = ctx + 3 * (slot0 + gt);
        sm.idx[3 * gt] = c[0];
        sm.idx[3 * gt + 1] = c[1];
        sm.idx[3 * gt + 2] = c[2];
      }
      hop::named_sync(4, kGatherThreads);
      gather_tile<D>(sm, sm.e[es], tok, tok_rows, path_tab, path_rows, dt,
                     dp, nt, gt);
      hop::fence_proxy_async();       // the rows, to wgmma's async proxy
      hop::mbar_arrive(&sm.e_full[es]);
      ++it;
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int cw = wg - 1;                      // consumer 0 or 1
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const bool leader = t == 0;
    const int xc0 = cw * kN;                    // this consumer's columns
    float acc[kN / 2];
    int it = 0;                        // live tiles begun so far
    int ws = 0, w_phase = 0;           // the next W stage and its parity
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long slot0 = static_cast<long long>(tile) * kTile;
      if (!tile_live(pair, n_slots, slot0, lane)) {
        if (cw == 0 && warp == 0) {
          for (int r = lane; r < kTile; r += 32) {
            if (slot0 + r < n_slots) scores[slot0 + r] = kNeg;
          }
        }
        continue;
      }
      const int st = it % kEStages;
      const int buf = it & 1;
      // this thread's rows, opaque to the compiler: formed per tile, not
      // kept across the loop (at D = 384 one more value there spills)
      int r_h[2] = {16 * warp + g, 16 * warp + 8 + g};
      asm volatile("" : "+r"(r_h[0]), "+r"(r_h[1]));
      if (cw == 0 && t < kTile) {
        // a slot is valid in its example's segment and not all-PAD
        const long long slot = slot0 + t;
        const bool in = slot < n_slots;
        const int p = in ? pair[slot] : -1;
        int v = 0;
        if (p >= 0) {
          const int* c = ctx + 3 * slot;
          v = c[0] != token_pad || c[1] != path_pad || c[2] != token_pad;
        }
        sm.pid[buf][t] = p;
        sm.valid[buf][t] = v;
      }

      // x = e W (this consumer's columns)
      hop::mbar_wait(&sm.e_full[st], (it / kEStages) & 1);
      int prev = -1;
      for (int q = 0; q < n_slices; ++q) {
        hop::mbar_wait(&sm.w_full[ws], w_phase);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t da = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.e[st][q / 2])
                  + (q % 2) * 64 + kk * 32,
              16, 1024);
          const uint64_t db = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.w[ws][xc0 / 64])
                  + kk * 2048,
              kBoxW * 2, 1024);
          hop::wgmma<kN, 1>(acc, da, db, q > 0 || kk > 0);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();             // the previous slice's products
        if (prev >= 0 && leader) hop::mbar_arrive(&sm.w_empty[prev]);
        prev = ws;
        if (++ws == kWStages) {
          ws = 0;
          w_phase ^= 1;
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (leader) {
        hop::mbar_arrive(&sm.w_empty[prev]);
        hop::mbar_arrive(&sm.e_empty[st]);   // e read: the next may land
      }

      // x = tanh in place; this half's partials of each row's score. The
      // inputs of column group j are tied to a tanh of group j - 2
      // (x + 0 * t, the 0 opaque), so ptxas keeps ~8 tanh in flight, not
      // all 96 at once with the scalars spilled
      float ps[2] = {0.f, 0.f};
      const float zero = hop::opaque_zero();
      float link[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = xc0 + 8 * j + 2 * tq;
        const float a0 = sm.attn[c], a1 = sm.attn[c + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[4 * j + q] = fmaf(link[j & 1], zero, acc[4 * j + q]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = tanhf(acc[4 * j + 2 * h]);
          const float x1 = tanhf(acc[4 * j + 2 * h + 1]);
          acc[4 * j + 2 * h] = x0;
          acc[4 * j + 2 * h + 1] = x1;
          ps[h] = fmaf(x1, a1, fmaf(x0, a0, ps[h]));
        }
        link[j & 1] = acc[4 * j + 3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(kFull, ps[h], 1);
        ps[h] += __shfl_xor_sync(kFull, ps[h], 2);
        if (tq == 0) sm.red[buf][cw][r_h[h]] = ps[h];
      }
      hop::named_sync(1, 256);     // both halves' partials, the pair ids
      const int* pid = sm.pid[buf];

      // every warp: each row's pair maximum over the tile (lane l holds
      // rows 2l, 2l + 1), by segmented max scans up and down
      const int ra = 2 * lane, rb = ra + 1;
      const int pa = pid[ra], pb = pid[rb];
      const bool va = sm.valid[buf][ra] != 0, vb = sm.valid[buf][rb] != 0;
      const float sa = sm.red[buf][0][ra] + sm.red[buf][1][ra];
      const float sb = sm.red[buf][0][rb] + sm.red[buf][1][rb];
      float ma = va ? sa : kNeg, mb = vb ? sb : kNeg;
      {
        float da = ma, db = mb;
        seg_scan_up<true>(ma, mb, pa, pb, lane);
        seg_scan_down<true>(da, db, pa, pb, lane);
        ma = fmaxf(ma, da);
        mb = fmaxf(mb, db);
      }
      // this thread's rows: p = exp(s - m) where valid, else 0
      float p_h[2];
      int pid_h[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_h[h];
        const float m_a = __shfl_sync(kFull, ma, r >> 1);
        const float m_b = __shfl_sync(kFull, mb, r >> 1);
        const float s = sm.red[buf][0][r] + sm.red[buf][1][r];
        p_h[h] = sm.valid[buf][r] ? expf(s - ((r & 1) ? m_b : m_a)) : 0.f;
        pid_h[h] = pid[r];
      }
      if (cw == 0 && warp == 0) {
        // scores, and each pair's (m, z) from the lane of its last row
        if (slot0 + ra < n_slots) scores[slot0 + ra] = va ? sa : kNeg;
        if (slot0 + rb < n_slots) scores[slot0 + rb] = vb ? sb : kNeg;
        float za = va ? expf(sa - ma) : 0.f, zb = vb ? expf(sb - mb) : 0.f;
        seg_scan_up<false>(za, zb, pa, pb, lane);
        const int p_next = __shfl_down_sync(kFull, pa, 1);
        if (pa >= 0 && pb != pa) {
          part_m[pa] = ma;
          part_z[pa] = za;
        }
        if (pb >= 0 && (lane == 31 || p_next != pb)) {
          part_m[pb] = mb;
          part_z[pb] = zb;
        }
      }

      // acc = sum p x per pair: a segmented sum over each 8-row band
      // (lanes g, shuffles by 4, 8, 16), band 0's last row carried into
      // band 1, then the warps' last rows through shared memory
      bool same[2][3];
      bool end_h[2], cross_h[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_h[h];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          same[h][i] = g >= (1 << i) && pid[r - (1 << i)] == pid_h[h];
        }
        end_h[h] = pid_h[h] >= 0 && (r == kTile - 1 || pid[r + 1] != pid_h[h]);
        cross_h[h] = warp > 0 && pid[16 * warp - 1] == pid_h[h];
      }
      const bool carry_band = pid[r_h[1]] == pid[16 * warp + 7];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = p_h[0] * acc[4 * j + e];
          float v1 = p_h[1] * acc[4 * j + 2 + e];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float o0 = __shfl_up_sync(kFull, v0, 4 << i);
            const float o1 = __shfl_up_sync(kFull, v1, 4 << i);
            if (same[0][i]) v0 = o0 + v0;
            if (same[1][i]) v1 = o1 + v1;
          }
          const float b0 = __shfl_sync(kFull, v0, 28 + tq);
          if (carry_band) v1 = b0 + v1;
          acc[4 * j + e] = v0;
          acc[4 * j + 2 + e] = v1;
        }
      }
      if (g == 7 && warp < 3) {
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          *reinterpret_cast<float2*>(&sm.carry[cw][warp][8 * j + 2 * tq]) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      hop::named_sync(2 + cw, 128);   // this consumer's warps' last rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!end_h[h]) continue;
        float* dst = part_acc + static_cast<long long>(pid_h[h]) * D + xc0;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (cross_h[h]) {
            // the pair began in an earlier warp: add the warps' last rows
            for (int u = warp - 1; u >= 0; --u) {
              const float2 cv =
                  *reinterpret_cast<const float2*>(&sm.carry[cw][u][c]);
              v.x += cv.x;
              v.y += cv.y;
              if (u == 0 || pid[16 * u - 1] != pid_h[h]) break;
            }
          }
          *reinterpret_cast<float2*>(dst + c) = v;
        }
      }
      ++it;
    }
  }
}

template <int D, bool kGather>
cudaError_t launch_tiles(const CUtensorMap& e_map, const void* tok,
                         long long tok_rows, const void* path_tab,
                         long long path_rows, int dt, int dp, const void* w,
                         const void* attn, const int* ctx, const int* pair,
                         int token_pad, int path_pad, long long n_slots,
                         int n_tiles, int n_ctas, float* scores,
                         float* part_m, float* part_z, float* part_acc,
                         cudaStream_t s) {
  const int K = 2 * dt + dp;
  CUtensorMap w_map;
  const cudaError_t err = hop::encode_tmap_2d(&w_map, w, K, D, D * 2,
                                              kWRows);
  if (err != cudaSuccess) return err;
  static_assert(fwd_smem_bytes<D>() <= 232448, "shared memory");
  const size_t smem = fwd_smem_bytes<D>();
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_fwd_tile_kernel<D, kGather>, smem, allowed);
  ragged_fwd_tile_kernel<D, kGather><<<n_ctas, kWgThreads, smem, s>>>(
          e_map, w_map, static_cast<const bf16*>(tok), tok_rows,
          static_cast<const bf16*>(path_tab), path_rows, dt, dp,
          static_cast<const bf16*>(attn), ctx, pair, token_pad, path_pad,
          n_slots, n_tiles, scores, part_m, part_z, part_acc);
  return cudaGetLastError();
}

template <bool kGather>
cudaError_t launch_tiles_d(int D, const CUtensorMap& e_map, const void* tok,
                           long long tok_rows, const void* path_tab,
                           long long path_rows, int dt, int dp,
                           const void* w, const void* attn, const int* ctx,
                           const int* pair, int token_pad, int path_pad,
                           long long n_slots, int n_tiles, int n_ctas,
                           float* scores, float* part_m, float* part_z,
                           float* part_acc, cudaStream_t s) {
#define C2V_LAUNCH_TILES(DD)                                                 \
  launch_tiles<DD, kGather>(e_map, tok, tok_rows, path_tab, path_rows, dt,  \
                            dp, w, attn, ctx, pair, token_pad, path_pad,    \
                            n_slots, n_tiles, n_ctas, scores, part_m,       \
                            part_z, part_acc, s)
  switch (D) {
    case 128:
      return C2V_LAUNCH_TILES(128);
    case 256:
      return C2V_LAUNCH_TILES(256);
    case 384:
      return C2V_LAUNCH_TILES(384);
    default:
      return cudaErrorInvalidValue;
  }
#undef C2V_LAUNCH_TILES
}

// The bf16 route's tile kernel: straight from bf16 tables without a mask
// (its producer warps gather), else after the gather kernel into e; with
// `e_given` the e stream is the caller's (a mesh's stream, gathered by
// ragged_fwd_gather_rows and summed over the model axis) and no gather
// runs.
template <typename TT>
cudaError_t launch_bf16(int D, const void* tok, long long tok_rows,
                        const void* path_tab, long long path_rows, int dt,
                        int dp, const void* w, const void* attn,
                        const int* ctx, const int* pair, int token_pad,
                        int path_pad, long long n_slots, const uint8_t* keep,
                        float keep_rate, void* e, int e_given, int n_ctas,
                        float* scores, float* part_m, float* part_z,
                        float* part_acc, cudaStream_t s) {
  const int K = 2 * dt + dp;
  const int n_tiles = static_cast<int>((n_slots + kTile - 1) / kTile);
  if (n_tiles == 0) return cudaSuccess;
  if (!e_given && sizeof(TT) == 2 && keep == nullptr) {
    const CUtensorMap none{};           // not read: the rows are gathered
    return launch_tiles_d<true>(D, none, tok, tok_rows, path_tab, path_rows,
                                dt, dp, w, attn, ctx, pair, token_pad,
                                path_pad, n_slots, n_tiles, n_ctas, scores,
                                part_m, part_z, part_acc, s);
  }
  if (!e_given) {
    ragged_fwd_gather_kernel<TT, bf16><<<n_tiles, kGatherCta, 0, s>>>(
        static_cast<const TT*>(tok), 0, tok_rows,
        static_cast<const TT*>(path_tab), 0, path_rows, 0, dt, dp, ctx, pair,
        n_slots, keep, keep_rate, static_cast<bf16*>(e));
    const cudaError_t gerr = cudaGetLastError();
    if (gerr != cudaSuccess) return gerr;
  }
  cudaError_t err;
  CUtensorMap e_map;
  err = hop::encode_tmap_2d(&e_map, e, n_slots, K, K * 2, 64);
  if (err != cudaSuccess) return err;
  return launch_tiles_d<false>(D, e_map, tok, tok_rows, path_tab, path_rows,
                               dt, dp, w, attn, ctx, pair, token_pad,
                               path_pad, n_slots, n_tiles, n_ctas, scores,
                               part_m, part_z, part_acc, s);
}

// launches ragged_fwd_gather_kernel<TT, TO> over the whole stream, ranged
template <typename TT, typename TO>
cudaError_t launch_gather_rows(const void* tok, long long tok_lo,
                               long long tok_rows, const void* path_tab,
                               long long path_lo, long long path_rows,
                               int dt, int dp, const int* ctx,
                               long long n_slots, const uint8_t* keep,
                               float keep_rate, void* e, int n_tiles,
                               cudaStream_t s) {
  ragged_fwd_gather_kernel<TT, TO><<<n_tiles, kGatherCta, 0, s>>>(
      static_cast<const TT*>(tok), tok_lo, tok_rows,
      static_cast<const TT*>(path_tab), path_lo, path_rows, 1, dt, dp, ctx,
      nullptr, n_slots, keep, keep_rate, static_cast<TO*>(e));
  return cudaGetLastError();
}

// ---------------------------------- fp32 (three TF32 terms, mma.sync)
constexpr int kT32Threads = 256;     // eight warps
constexpr int kT32Stages = 4;        // K slices in flight
constexpr int kT32Cols = 128;        // x columns of a block
constexpr int kT32MnLd = kT32Cols + 8;   // W rows: 8 modulo 32 words
constexpr int kT32WholeD = 384;      // D up to which x stays whole

// Shared memory of ragged_fwd_tile_tf32_kernel: the ring (e and W
// slices), tanh(x) (all of D, or one block), and the per-slot state.
template <bool kWhole>
struct FwdT32Smem {
  static constexpr int kXCols = kWhole ? kT32WholeD : kT32Cols;
  static constexpr int kLdx = kXCols + t32::kPad;
  float a[kT32Stages][kTile * t32::kLd];       // e: 64 slots x 32 of K
  float b[kT32Stages][t32::kK * kT32MnLd];     // W: 32 rows x 128 columns
  float x[kTile * kLdx];                       // tanh(x)
  float attn[kWhole ? kT32WholeD : 1024];      // zero past D
  float sc[kTile];                             // each row's score
  float p[kTile];                              // exp(s - m), 0 if invalid
  int pid[kTile], valid[kTile];
};

// The per-tile statistics of the fp32 route (design note above), one CTA
// per 64-slot tile. Warp (wm, wn) holds rows [32 wm, + 32) x columns
// [32 wn, + 32) of each 128-column block of x = e W, e from the (N, K)
// stream (K a multiple of 4). kWhole: x stays whole in shared memory
// (D <= 384); else each block runs twice, the first pass for the scores,
// the second for acc. out: scores (N,) for every slot of the tile;
// part_m, part_z (pairs,) and part_acc (pairs, D) at each pair's index.
template <bool kWhole>
__global__ void __launch_bounds__(kT32Threads, 1) ragged_fwd_tile_tf32_kernel(
    const float* __restrict__ e, int K, const float* __restrict__ w, int ldw,
    const float* __restrict__ attn, int D, const int* __restrict__ ctx,
    const int* __restrict__ pair, int token_pad, int path_pad,
    long long n_slots, float* __restrict__ scores,
    float* __restrict__ part_m, float* __restrict__ part_z,
    float* __restrict__ part_acc) {
  using Smem = FwdT32Smem<kWhole>;
  constexpr int kLdx = Smem::kLdx;
  const int t = threadIdx.x;
  const long long slot0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nt = static_cast<int>(
      min(static_cast<long long>(kTile), n_slots - slot0));
  const int p_t = t < nt ? pair[slot0 + t] : -1;
  if (!__syncthreads_or(p_t >= 0)) {
    if (t < nt) scores[slot0 + t] = kNeg;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int nk = (K + t32::kK - 1) / t32::kK;          // K slices
  const int n_blocks = (D + kT32Cols - 1) / kT32Cols;  // x column blocks
  const int n_pass = n_blocks * nk;                    // slices a pass
  const int n_iter = (kWhole ? 1 : 2) * n_pass;
  if (t < kTile) {
    // a slot is valid in its example's segment and not all-PAD
    int s = token_pad, pp = path_pad, g = token_pad;
    if (t < nt) {
      const int* c = ctx + 3 * (slot0 + t);
      s = c[0];
      pp = c[1];
      g = c[2];
    }
    sm.pid[t] = p_t;
    sm.valid[t] = p_t >= 0
                  && (s != token_pad || pp != path_pad || g != token_pad);
  }
  for (int c = t; c < n_blocks * kT32Cols; c += kT32Threads) {
    sm.attn[c] = c < D ? attn[c] : 0.f;
  }
  // slice `it`: e's rows [slot0, + 64) x K [k0, + 32) (zero past the
  // stream and past K), W's rows [k0, + 32) x columns [col0, + 128) (zero
  // past K and ldw)
  auto load = [&](int it) {
    const int st = it % kT32Stages;
    const int k0 = (it % nk) * t32::kK;
    const int col0 = ((it / nk) % n_blocks) * kT32Cols;
    for (int q = t; q < kTile * (t32::kK / 4); q += kT32Threads) {
      const int r = q >> 3;
      const int c = 4 * (q & 7);
      const int k = k0 + c;
      const bool in = r < nt && k < K;
      c2v::cp_async16(sm.a[st] + r * t32::kLd + c,
                      in ? e + (slot0 + r) * K + k : e, in);
    }
    for (int q = t; q < t32::kK * (kT32Cols / 4); q += kT32Threads) {
      const int kr = q >> 5;
      const int c = 4 * (q & 31);
      const bool in = k0 + kr < K && col0 + c < ldw;
      c2v::cp_async16(sm.b[st] + kr * kT32MnLd + c,
                      in ? w + static_cast<long long>(k0 + kr) * ldw + col0
                               + c
                         : w,
                      in);
    }
  };
  const int warp = t >> 5;
  const int lane = t & 31;
  // each row's score in the fp32 backward's order (ragged_bwd.cu): a warp
  // a row, lane l's fma chain over columns 4l .. 4l + 3 of each block,
  // blocks in order (chain: block blk of x), then a fixed xor tree
  // (score_rows). s_lane carries the chains across the blocks of the
  // two-pass route.
  constexpr int kRowsPerWarp = kTile / (kT32Threads / 32);
  float s_lane[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s_lane[i] = 0.f;
  auto chain = [&](int blk) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + (kT32Threads / 32) * i;
      const float4 x4 = *reinterpret_cast<const float4*>(
          sm.x + r * kLdx + (kWhole ? blk * kT32Cols : 0) + 4 * lane);
      const float4 a4 = *reinterpret_cast<const float4*>(
          sm.attn + blk * kT32Cols + 4 * lane);
      s_lane[i] = fmaf(x4.w, a4.w, fmaf(x4.z, a4.z, fmaf(
          x4.y, a4.y, fmaf(x4.x, a4.x, s_lane[i]))));
    }
  };
  auto score_rows = [&]() {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float v = s_lane[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(kFull, v, off);
      }
      if (lane == 0) sm.sc[warp + (kT32Threads / 32) * i] = v;
    }
  };
  // warp 0: each pair's maximum by segmented max scans up and down (lane
  // l holds rows 2l, 2l + 1), p = exp(s - m) where valid, z by a
  // segmented sum, written from the lane of the pair's last row; every
  // slot's score
  auto stats = [&]() {
    if (warp != 0) return;
    const int ra = 2 * lane, rb = ra + 1;
    const int pa = sm.pid[ra], pb = sm.pid[rb];
    const bool va = sm.valid[ra] != 0, vb = sm.valid[rb] != 0;
    const float sa = sm.sc[ra], sb = sm.sc[rb];
    float ma = va ? sa : kNeg, mb = vb ? sb : kNeg;
    {
      float da = ma, db = mb;
      seg_scan_up<true>(ma, mb, pa, pb, lane);
      seg_scan_down<true>(da, db, pa, pb, lane);
      ma = fmaxf(ma, da);
      mb = fmaxf(mb, db);
    }
    float za = va ? expf(sa - ma) : 0.f, zb = vb ? expf(sb - mb) : 0.f;
    sm.p[ra] = za;
    sm.p[rb] = zb;
    if (ra < nt) scores[slot0 + ra] = va ? sa : kNeg;
    if (rb < nt) scores[slot0 + rb] = vb ? sb : kNeg;
    seg_scan_up<false>(za, zb, pa, pb, lane);
    const int p_next = __shfl_down_sync(kFull, pa, 1);
    if (pa >= 0 && pb != pa) {
      part_m[pa] = ma;
      part_z[pa] = za;
    }
    if (pb >= 0 && (lane == 31 || p_next != pb)) {
      part_m[pb] = mb;
      part_z[pb] = zb;
    }
  };
  // each pair's acc over columns [c0, c0 + cols) of D (x's columns from
  // x_col0): a thread a column, the tile's rows in order, written at the
  // end of each pair's rows
  auto pair_sums = [&](int c0, int cols, int x_col0) {
    for (int c = t; c < cols; c += kT32Threads) {
      float a = 0.f;
      int cur = sm.pid[0];
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) {
        const int pr = sm.pid[r];
        if (pr != cur) {
          if (cur >= 0) {
            part_acc[static_cast<long long>(cur) * D + c0 + c] = a;
          }
          a = 0.f;
          cur = pr;
        }
        a = fmaf(sm.p[r], sm.x[r * kLdx + x_col0 + c], a);
      }
      if (cur >= 0) part_acc[static_cast<long long>(cur) * D + c0 + c] = a;
    }
  };

#pragma unroll 1
  for (int it = 0; it < kT32Stages - 1; ++it) {
    if (it < n_iter) load(it);
    c2v::cp_async_commit();
  }
  const int g8 = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n8][q] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    c2v::cp_async_wait<kT32Stages - 2>();
    __syncthreads();          // slice it landed; slice it - 1's stage free
    if (it + kT32Stages - 1 < n_iter) load(it + kT32Stages - 1);
    c2v::cp_async_commit();
    const int st = it % kT32Stages;
    // the slice's 32 of K in a fresh accumulator, added with FADD (as the
    // fp32 backward forms x)
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mt][n8][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < t32::kK / 8; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t raw[4];
        t32::load_a_kmajor(raw, sm.a[st], t32::kLd, 32 * wm + 16 * mt,
                           8 * kk);
        t32::split_frag(raw, ah[mt], al[mt]);
      }
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        uint32_t rb0, rb1, bh0, bh1, bl0, bl1;
        t32::load_b_mnmajor(rb0, rb1, sm.b[st], kT32MnLd, 32 * wn + 8 * n8,
                            8 * kk);
        t32::split_tf32(rb0, bh0, bl0);
        t32::split_tf32(rb1, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          t32::mma_tf32x3(part[mt][n8], ah[mt], al[mt], bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][n8][q] += part[mt][n8][q];
    if ((it + 1) % nk != 0) continue;
    // a block of x is complete: tanh into shared memory
    const int blk = (it / nk) % n_blocks;
    const int xc0 = (kWhole ? blk * kT32Cols : 0) + 32 * wn + 2 * tq;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mt + 8 * h + g8;
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          *reinterpret_cast<float2*>(&sm.x[r * kLdx + xc0 + 8 * n8]) =
              make_float2(tanhf(acc[mt][n8][2 * h]),
                          tanhf(acc[mt][n8][2 * h + 1]));
          acc[mt][n8][2 * h] = 0.f;
          acc[mt][n8][2 * h + 1] = 0.f;
        }
      }
    }
    if (kWhole) continue;
    __syncthreads();          // the block's x complete
    if (it < n_pass) {
      chain(blk);
      if (blk == n_blocks - 1) {
        score_rows();
        __syncthreads();      // every row's score
        stats();
      }
    } else {
      pair_sums(blk * kT32Cols, min(kT32Cols, D - blk * kT32Cols), 0);
    }
    __syncthreads();          // x read: the next block may take its place
  }
  if (kWhole) {
    __syncthreads();          // x complete
    for (int b = 0; b < n_blocks; ++b) chain(b);
    score_rows();
    __syncthreads();
    stats();
    __syncthreads();          // p
    pair_sums(0, D, 0);
  }
}

template <bool kWhole>
cudaError_t launch_tiles_tf32(const float* e, int K, const float* w, int ldw,
                              const float* attn, int D, const int* ctx,
                              const int* pair, int token_pad, int path_pad,
                              long long n_slots, int n_tiles, float* scores,
                              float* part_m, float* part_z, float* part_acc,
                              cudaStream_t s) {
  static_assert(sizeof(FwdT32Smem<kWhole>) <= 232448, "shared memory");
  const size_t smem = sizeof(FwdT32Smem<kWhole>);
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_fwd_tile_tf32_kernel<kWhole>, smem, allowed);
  ragged_fwd_tile_tf32_kernel<kWhole><<<n_tiles, kT32Threads, smem, s>>>(
      e, K, w, ldw, attn, D, ctx, pair, token_pad, path_pad, n_slots, scores,
      part_m, part_z, part_acc);
  return cudaGetLastError();
}

// The fp32 route's tiles: the gather kernel writes the live tiles' rows
// into e first, unless e is a given stream (e_given; the keep mask then
// applied in it already).
cudaError_t launch_f32(const float* tok, long long tok_rows,
                       const float* path_tab, long long path_rows, int dt,
                       int dp, const float* w, int ldw, const float* attn,
                       int D, const int* ctx, const int* pair, int token_pad,
                       int path_pad, long long n_slots, const uint8_t* keep,
                       float keep_rate, float* e, int e_given,
                       float* scores, float* part_m, float* part_z,
                       float* part_acc, cudaStream_t s) {
  const int n_tiles = static_cast<int>((n_slots + kTile - 1) / kTile);
  if (n_tiles == 0) return cudaSuccess;
  if (!e_given) {
    ragged_fwd_gather_kernel<float, float><<<n_tiles, kGatherCta, 0, s>>>(
        tok, 0, tok_rows, path_tab, 0, path_rows, 0, dt, dp, ctx, pair,
        n_slots, keep, keep_rate, e);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int K = 2 * dt + dp;
  return D <= kT32WholeD
             ? launch_tiles_tf32<true>(e, K, w, ldw, attn, D, ctx, pair,
                                       token_pad, path_pad, n_slots, n_tiles,
                                       scores, part_m, part_z, part_acc, s)
             : launch_tiles_tf32<false>(e, K, w, ldw, attn, D, ctx, pair,
                                        token_pad, path_pad, n_slots, n_tiles,
                                        scores, part_m, part_z, part_acc, s);
}

}  // namespace

extern "C" {

// Slots per tile (both routes), for the wrapper's pair map.
int ragged_fwd_slot_tile() { return kTile; }

// The pair map alone (ragged_fwd_plan_kernel): count (batch,) int32 of
// the (shards x per_shard) examples, outputs pair_start, n_pairs (batch,)
// and pair (shards x cap). Returns cudaGetLastError() after the launch
// (0 = launched).
int ragged_fwd_plan(const int* count, int shards, int per_shard, int cap,
                    int* pair_start, int* n_pairs, int* pair, void* stream) {
  if (shards == 0 || (per_shard == 0 && cap == 0)) return 0;
  ragged_fwd_plan_kernel<<<1, kPlanThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      count, shards, per_shard, cap, pair_start, n_pairs, pair);
  return static_cast<int>(cudaGetLastError());
}

// bf16 route (W, attention bfloat16; tables bfloat16 when table_code is 1,
// float32 rounded on load when it is 0) over the (shards x cap) stream of
// (shards x per_shard) examples with counts `count`: the pair map
// (ragged_fwd_plan into pair_start, n_pairs (batch,) and pair (N,)
// scratch), the gather into e (N, K) bf16 scratch (keep, when not null,
// the (N, K) uint8 dropout keep mask; with e_given, e holds the stream
// already and is read, not written: the tables are then not read), the
// tile kernel on n_ctas
// persistent CTAs (partials part_m, part_z (batch + n_tiles,), part_acc
// (batch + n_tiles, D) scratch), the merge into m_out, z_out (batch,),
// acc_out (batch, D). Every slot of scores (N,) is written. The caller
// checks the shapes (header). Returns cudaGetLastError() after the
// launches (0 = launched).
int ragged_fwd_bf16(int table_code, const void* tok, long long tok_rows,
                    const void* path_tab, long long path_rows, const void* w,
                    const void* attn, const int* ctx, const int* count,
                    int shards, int per_shard, int cap, int dt, int dp,
                    int d_code, int token_pad, int path_pad,
                    const uint8_t* keep, float keep_rate, void* e,
                    int e_given, int n_ctas, int* pair_start, int* n_pairs,
                    int* pair,
                    float* scores, float* part_m, float* part_z,
                    float* part_acc, float* m_out, float* z_out,
                    float* acc_out, void* stream) {
  const int k_dim = 2 * dt + dp;
  if (k_dim % 64 || k_dim > kMaxK || dt % 8 || dp % 8
      || (reinterpret_cast<uintptr_t>(w) & 15)
      || (reinterpret_cast<uintptr_t>(e) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_slots = static_cast<long long>(shards) * cap;
  const int batch = shards * per_shard;
  cudaError_t err = static_cast<cudaError_t>(ragged_fwd_plan(
      count, shards, per_shard, cap, pair_start, n_pairs, pair, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table_code == 0) {
    err = launch_bf16<float>(d_code, tok, tok_rows, path_tab, path_rows, dt,
                             dp, w, attn, ctx, pair, token_pad, path_pad,
                             n_slots, keep, keep_rate, e, e_given, n_ctas,
                             scores, part_m, part_z, part_acc, s);
  } else if (table_code == 1) {
    err = launch_bf16<bf16>(d_code, tok, tok_rows, path_tab, path_rows, dt,
                            dp, w, attn, ctx, pair, token_pad, path_pad,
                            n_slots, keep, keep_rate, e, e_given, n_ctas,
                            scores, part_m, part_z, part_acc, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  ragged_merge_kernel<<<batch, 128, 0, s>>>(pair_start, n_pairs, d_code,
                                            part_m, part_z, part_acc, m_out,
                                            z_out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

// fp32 route (tables, W, attention float32) over the (shards x cap)
// stream of (shards x per_shard) examples with counts `count`: the pair
// map (ragged_fwd_plan into pair_start, n_pairs (batch,) and pair (N,)
// scratch), the tile kernel (three TF32 terms) on one CTA per 64-slot
// tile (partials part_m, part_z (batch + n_tiles,), part_acc (batch +
// n_tiles, D) scratch), the merge into m_out, z_out (batch,), acc_out
// (batch, D). W is (K, D) with row stride ldw (a multiple of 4, >= D).
// keep, when not null, is the (N, K) uint8 dropout keep mask. The gather
// kernel writes the rows into e ((N, K) fp32 scratch); with e_given, e
// holds the stream already (a mesh's, the mask applied) and is read, not
// written: the tables and keep are then not read. Every slot of
// scores (N,) is written. Returns cudaGetLastError() after the launches
// (0 = launched); cudaErrorInvalidValue for a shape or alignment the
// kernels do not take (header).
int ragged_fwd_f32(const void* tok, long long tok_rows, const void* path_tab,
                   long long path_rows, const void* w, int ldw,
                   const void* attn, const int* ctx, const int* count,
                   int shards, int per_shard, int cap, int dt, int dp,
                   int d_code, int token_pad, int path_pad,
                   const uint8_t* keep, float keep_rate, void* e,
                   int e_given, int* pair_start, int* n_pairs, int* pair,
                   float* scores, float* part_m, float* part_z,
                   float* part_acc, float* m_out, float* z_out,
                   float* acc_out, void* stream) {
  const bool tables = !e_given;
  if (dt % 4 || dp % 4 || d_code < 16 || d_code > 1024 || ldw % 4
      || ldw < d_code || t32::misaligned16(w) || t32::misaligned16(e)
      || (tables && (t32::misaligned16(tok) || t32::misaligned16(path_tab)
                     || (reinterpret_cast<uintptr_t>(keep) & 3)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_slots = static_cast<long long>(shards) * cap;
  const int batch = shards * per_shard;
  cudaError_t err = static_cast<cudaError_t>(ragged_fwd_plan(
      count, shards, per_shard, cap, pair_start, n_pairs, pair, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_f32(static_cast<const float*>(tok), tok_rows,
                   static_cast<const float*>(path_tab), path_rows, dt, dp,
                   static_cast<const float*>(w), ldw,
                   static_cast<const float*>(attn), d_code, ctx, pair,
                   token_pad, path_pad, n_slots, e_given ? nullptr : keep,
                   keep_rate, static_cast<float*>(e), e_given, scores,
                   part_m, part_z, part_acc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  ragged_merge_kernel<<<batch, 128, 0, s>>>(pair_start, n_pairs, d_code,
                                            part_m, part_z, part_acc, m_out,
                                            z_out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

// The mesh's gather (ragged_fwd_gather_kernel, every tile): the N slots'
// rows [tok[src]; path[pth]; tok[tgt]] of this rank's table slices (rows
// [tok_lo, tok_lo + tok_rows) and [path_lo, path_lo + path_rows) of the
// model-sharded tables; table_code 0: float32, 1: bfloat16), zero where
// another rank holds the row, rounded to the stream's type with the keep
// mask (when not null) applied, into e (N, K) (16-byte aligned; out_code
// 1: bfloat16, the bf16 route's stream; 0: float32, the fp32 route's).
// Returns cudaGetLastError() after the launch (0 = launched).
int ragged_fwd_gather_rows(int table_code, int out_code, const void* tok,
                           long long tok_lo, long long tok_rows,
                           const void* path_tab, long long path_lo,
                           long long path_rows, int dt, int dp,
                           const int* ctx, long long n_slots,
                           const uint8_t* keep, float keep_rate, void* e,
                           void* stream) {
  if ((2 * dt + dp) % 8 || dt % 8 || dp % 8
      || (reinterpret_cast<uintptr_t>(e) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = static_cast<int>((n_slots + kTile - 1) / kTile);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = 2 * table_code + out_code;
  cudaError_t err;
  switch (code) {
    case 0:
      err = launch_gather_rows<float, float>(
          tok, tok_lo, tok_rows, path_tab, path_lo, path_rows, dt, dp, ctx,
          n_slots, keep, keep_rate, e, n_tiles, s);
      break;
    case 1:
      err = launch_gather_rows<float, bf16>(
          tok, tok_lo, tok_rows, path_tab, path_lo, path_rows, dt, dp, ctx,
          n_slots, keep, keep_rate, e, n_tiles, s);
      break;
    case 2:
      err = launch_gather_rows<bf16, float>(
          tok, tok_lo, tok_rows, path_tab, path_lo, path_rows, dt, dp, ctx,
          n_slots, keep, keep_rate, e, n_tiles, s);
      break;
    case 3:
      err = launch_gather_rows<bf16, bf16>(
          tok, tok_lo, tok_rows, path_tab, path_lo, path_rows, dt, dp, ctx,
          n_slots, keep, keep_rate, e, n_tiles, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ragged_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
