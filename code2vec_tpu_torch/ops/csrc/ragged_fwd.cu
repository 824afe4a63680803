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
// fp32 (CUDA cores, exact fp32 FMAs: the tensor cores have no exact fp32
// product): a work item is one tile of 16 slots of one example's CSR
// segment, one CTA per item, the gather fused (rows read straight into
// shared memory), W read from L2 per item.
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
// each way).
//
// Shapes: dt, dp multiples of 4 (fp32 route); bf16: K = 2 dt + dp a
// multiple of 64, at most 384, dt and dp multiples of 8, D in {128, 256,
// 384}, W, the tables and the keep mask 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using c2v::bf16;
using c2v::kNeg;
using c2v::stage_triples;

constexpr int kTileF = 16;         // slots per work item, fp32 kernel

// One tile's softmax statistics: m = max of the valid scores (-1e30 if
// none), z = sum of exp(score - m) over them. Every thread computes the
// same values.
template <int TILE>
__device__ __forceinline__ void tile_stats(const float* sc_s,
                                           const int* valid_s, int nt,
                                           float& m, float& z) {
  m = kNeg;
  for (int t = 0; t < nt; ++t) {
    if (valid_s[t]) m = fmaxf(m, sc_s[t]);
  }
  z = 0.f;
  for (int t = 0; t < nt; ++t) {
    if (valid_s[t]) z += expf(sc_s[t] - m);
  }
}

// ----------------------------------------------------------- fp32 kernel
// One CTA per work item: tile `chunk` of example `b`, where the wrapper's
// item map gives b = item_ex[item] and chunk = item - item_start[b]. Writes
// the tile's partial (m, z, acc) at index `item`; ragged_merge_kernel folds
// the partials of each example.
__global__ void ragged_fwd_f32_kernel(
    const float* __restrict__ tok, long long tok_rows,
    const float* __restrict__ path_tab, long long path_rows,
    const float* __restrict__ w,   // (K, D) row-major, K = 2 dt + dp
    const float* __restrict__ attn,  // (D,)
    const int* __restrict__ ctx,     // (N, 3) packed triples
    const int* __restrict__ starts, const int* __restrict__ counts,  // (B,)
    const int* __restrict__ item_ex, const int* __restrict__ item_start,
    int dt, int dp, int D, int token_pad, int path_pad,
    const uint8_t* __restrict__ keep, float keep_rate,
    float* __restrict__ scores, float* __restrict__ part_m,
    float* __restrict__ part_z, float* __restrict__ part_acc) {
  const int item = blockIdx.x;
  const int b = item_ex[item];
  const int t0 = (item - item_start[b]) * kTileF;
  const int count = counts[b];
  if (t0 >= count) return;                 // past the last item
  extern __shared__ __align__(16) float smem[];
  const int K = 2 * dt + dp;
  float* e_s = smem;                       // (kTileF, K)
  float* red = e_s + kTileF * K;           // (32 warps, kTileF)
  float* sc_s = red + 32 * kTileF;         // (kTileF,)
  int* valid_s = reinterpret_cast<int*>(sc_s + kTileF);  // (kTileF,)
  int* idx_s = valid_s + kTileF;           // (3 kTileF,)

  const int j = threadIdx.x;               // this thread's output column
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
  const int start = starts[b];
  const float a_j = j < D ? attn[j] : 0.f;
  const int nt = min(kTileF, count - t0);

  stage_triples<kTileF>(ctx, start + t0, nt, token_pad, path_pad, idx_s,
                        valid_s);
  __syncthreads();
  c2v::gather_rows<float, float>(tok, tok_rows, path_tab, path_rows, dt, dp,
                                 idx_s, kTileF, nt, start + t0, keep,
                                 keep_rate, e_s, K);
  __syncthreads();

  float x[kTileF];
#pragma unroll
  for (int t = 0; t < kTileF; ++t) x[t] = 0.f;
  if (j < D) {
    for (int k = 0; k < K; k += 4) {
      const float w0 = w[static_cast<long long>(k) * D + j];
      const float w1 = w[static_cast<long long>(k + 1) * D + j];
      const float w2 = w[static_cast<long long>(k + 2) * D + j];
      const float w3 = w[static_cast<long long>(k + 3) * D + j];
#pragma unroll
      for (int t = 0; t < kTileF; ++t) {
        const float4 e = *reinterpret_cast<const float4*>(e_s + t * K + k);
        x[t] = fmaf(e.x, w0, x[t]);
        x[t] = fmaf(e.y, w1, x[t]);
        x[t] = fmaf(e.z, w2, x[t]);
        x[t] = fmaf(e.w, w3, x[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTileF; ++t) {
    x[t] = tanhf(x[t]);                    // columns j >= D: tanh(0) * 0
    float p = x[t] * a_j;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, off);
    }
    if (lane == 0) red[warp * kTileF + t] = p;
  }
  __syncthreads();
  if (j < kTileF) {
    float s = 0.f;
    for (int wi = 0; wi < nwarps; ++wi) s += red[wi * kTileF + j];
    s = valid_s[j] ? s : kNeg;
    sc_s[j] = s;
    if (j < nt) scores[start + t0 + j] = s;
  }
  __syncthreads();
  float m, z;
  tile_stats<kTileF>(sc_s, valid_s, nt, m, z);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kTileF; ++t) {
    const float p = (t < nt && valid_s[t]) ? expf(sc_s[t] - m) : 0.f;
    acc = fmaf(p, x[t], acc);
  }
  if (j == 0) {
    part_m[item] = m;
    part_z[item] = z;
  }
  if (j < D) part_acc[static_cast<long long>(item) * D + j] = acc;
}


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

// The gather of the live tiles' rows into the (N, K) bf16 e stream, one CTA
// per 64-slot tile: row t is [tok[src_t]; path[pth_t]; tok[tgt_t]], each
// element rounded to bf16 (fp32 masters) and, with a keep mask, divided by
// the keep rate and rounded again where kept, zero where dropped. Chunks of
// eight elements, four chunks' loads in flight per thread before the
// stores. A tile that holds no slot of an example is skipped (the tile
// kernel skips it too), so its rows are not written.
template <typename TT>
__global__ void __launch_bounds__(kGatherCta) ragged_fwd_gather_kernel(
    const TT* __restrict__ tok, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_rows, int dt, int dp,
    const int* __restrict__ ctx, const int* __restrict__ pair,
    long long n_slots, const uint8_t* __restrict__ keep, float keep_rate,
    bf16* __restrict__ e) {
  __shared__ int idx_s[3 * kTile];
  const long long slot0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nt = static_cast<int>(
      min(static_cast<long long>(kTile), n_slots - slot0));
  const int t = threadIdx.x;
  if (!__syncthreads_or(t < nt && pair[slot0 + t] >= 0)) return;
  if (t < nt) {
    const int* c = ctx + 3 * (slot0 + t);
    idx_s[3 * t] = c[0];
    idx_s[3 * t + 1] = c[1];
    idx_s[3 * t + 2] = c[2];
  }
  __syncthreads();
  const int K = 2 * dt + dp;
  const int k8 = K / 8;                          // 8-element chunks per row
  const int total = nt * k8;
  const float rate_t = c2v::round_to<bf16>(keep_rate);
#pragma unroll 4
  for (int q = t; q < total; q += kGatherCta) {
    const int r = q / k8;
    const int c = 8 * (q - r * k8);
    const TT* src;
    if (c < dt) {
      src = tok + c2v::clamp_row(idx_s[3 * r], tok_rows) * dt + c;
    } else if (c < dt + dp) {
      src = path_tab + c2v::clamp_row(idx_s[3 * r + 1], path_rows) * dp
            + (c - dt);
    } else {
      src = tok + c2v::clamp_row(idx_s[3 * r + 2], tok_rows) * dt
            + (c - dt - dp);
    }
    const long long o = (slot0 + r) * K + c;
    const uint8_t* kp = keep == nullptr ? nullptr : keep + o;
    const float4 lo = c2v::round_keep<bf16>(c2v::load4(src), kp, rate_t);
    const float4 hi = c2v::round_keep<bf16>(
        c2v::load4(src + 4), kp == nullptr ? nullptr : kp + 4, rate_t);
    *reinterpret_cast<uint4*>(e + o) =
        make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                   pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
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
// (its producer warps gather), else after the gather kernel into e.
template <typename TT>
cudaError_t launch_bf16(int D, const void* tok, long long tok_rows,
                        const void* path_tab, long long path_rows, int dt,
                        int dp, const void* w, const void* attn,
                        const int* ctx, const int* pair, int token_pad,
                        int path_pad, long long n_slots, const uint8_t* keep,
                        float keep_rate, void* e, int n_ctas, float* scores,
                        float* part_m, float* part_z, float* part_acc,
                        cudaStream_t s) {
  const int K = 2 * dt + dp;
  const int n_tiles = static_cast<int>((n_slots + kTile - 1) / kTile);
  if (n_tiles == 0) return cudaSuccess;
  if (sizeof(TT) == 2 && keep == nullptr) {
    const CUtensorMap none{};           // not read: the rows are gathered
    return launch_tiles_d<true>(D, none, tok, tok_rows, path_tab, path_rows,
                                dt, dp, w, attn, ctx, pair, token_pad,
                                path_pad, n_slots, n_tiles, n_ctas, scores,
                                part_m, part_z, part_acc, s);
  }
  ragged_fwd_gather_kernel<TT><<<n_tiles, kGatherCta, 0, s>>>(
      static_cast<const TT*>(tok), tok_rows,
      static_cast<const TT*>(path_tab), path_rows, dt, dp, ctx, pair,
      n_slots, keep, keep_rate, static_cast<bf16*>(e));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap e_map;
  err = hop::encode_tmap_2d(&e_map, e, n_slots, K, K * 2, 64);
  if (err != cudaSuccess) return err;
  return launch_tiles_d<false>(D, e_map, tok, tok_rows, path_tab, path_rows,
                               dt, dp, w, attn, ctx, pair, token_pad,
                               path_pad, n_slots, n_tiles, n_ctas, scores,
                               part_m, part_z, part_acc, s);
}

}  // namespace

extern "C" {

// Slots per fp32 work item, for the wrapper's item map.
int ragged_fwd_f32_tile() { return kTileF; }

// Slots per bf16 tile, for the wrapper's pair map.
int ragged_fwd_slot_tile() { return kTile; }

// fp32 route (tables, weights float32). keep, when not null, is the (N, K)
// uint8 dropout keep mask of the packed stream, applied to the gathered
// rows with keep_rate. `n_items` work items (item_ex, item_start from the
// wrapper; items past the last write nothing), n_chunks (batch,) items of
// each example, partials in part_* (n_items, and n_items x D), results in
// m_out, z_out (batch,) and acc_out (batch, D); scores (N,) must hold
// -1e30 on entry (slots outside every item are not written). The caller
// checks the shapes (dt, dp multiples of 4; 16 <= D <= 1024). Returns
// cudaGetLastError() after the launches (0 = launched).
int ragged_fwd_f32(const void* tok, long long tok_rows, const void* path_tab,
                   long long path_rows, const void* w, const void* attn,
                   const int* ctx, const int* starts, const int* counts,
                   const int* item_ex, const int* item_start,
                   const int* n_chunks, int batch, int n_items, int dt,
                   int dp, int d_code, int token_pad, int path_pad,
                   const uint8_t* keep, float keep_rate, float* scores,
                   float* part_m, float* part_z, float* part_acc,
                   float* m_out, float* z_out, float* acc_out,
                   void* stream) {
  if (batch == 0) return 0;
  const int k_dim = 2 * dt + dp;
  const int threads = ((d_code + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTileF) * k_dim
                                       + 32 * kTileF + kTileF)
                      + sizeof(int) * 4 * kTileF;
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_fwd_f32_kernel, smem, allowed);
  if (n_items > 0) {
    ragged_fwd_f32_kernel<<<n_items, threads, smem, s>>>(
        static_cast<const float*>(tok), tok_rows,
        static_cast<const float*>(path_tab), path_rows,
        static_cast<const float*>(w), static_cast<const float*>(attn), ctx,
        starts, counts, item_ex, item_start, dt, dp, d_code, token_pad,
        path_pad, keep, keep_rate, scores, part_m, part_z, part_acc);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_merge_kernel<<<batch, 128, 0, s>>>(item_start, n_chunks, d_code,
                                            part_m, part_z, part_acc, m_out,
                                            z_out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

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
// the (N, K) uint8 dropout keep mask), the tile kernel on n_ctas
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
                    int n_ctas, int* pair_start, int* n_pairs, int* pair,
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
                             n_slots, keep, keep_rate, e, n_ctas, scores,
                             part_m, part_z, part_acc, s);
  } else if (table_code == 1) {
    err = launch_bf16<bf16>(d_code, tok, tok_rows, path_tab, path_rows, dt,
                            dp, w, attn, ctx, pair, token_pad, path_pad,
                            n_slots, keep, keep_rate, e, n_ctas, scores,
                            part_m, part_z, part_acc, s);
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

const char* ragged_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
