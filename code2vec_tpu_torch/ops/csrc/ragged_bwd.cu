// Recompute backward of the ragged fused encode, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel code2vec_tpu/ops/pallas_ragged.py::
// _bwd_kernel (launched by _grads_pallas). Inputs: the packed stream and
// the forward's inputs (tables, W = [W_src; W_path; W_tgt] (K x D), the
// attention vector, the dropout keep mask), the forward's per-example
// softmax statistics m, z (B,) and the cotangents g (B, D), gc = g . code
// (B,). Per valid slot t of example b, with the per-slot state RECOMPUTED
// (nothing per slot was saved by the forward):
//   x_t  = tanh(e_t W),  s_t = x_t . attention,  w_t = exp(s_t - m_b) / z_b
//   ds_t = w_t (x_t . g_b - gc_b)
//   du_t = (1 - x_t^2) (w_t g_b + ds_t attention)
// Outputs:
//   de (N, K) f32  = du W^T per slot, times the keep mask / keep rate
//   dW (K, D) f32  = sum_t e_t^T du_t       (e_t after dropout)
//   d_attn (D,) f32 = sum_t ds_t x_t
// The caller scatters de into the token/path table gradients.
//
// Design, fp32 (CUDA cores, exact fp32 FMAs: the tensor cores have no exact
// fp32 product and TF32 is off). The per-slot work uses the forward's
// one-tile work items (32 slots of one example, the wrapper's item_ex map):
// one CTA re-gathers the tile's rows, recomputes x, forms w, ds and du,
// writes du (N, D) and de = du W^T for its slots, and a per-item d_attn
// partial. The TPU kernel carries dW and d_attn across its ordered grid in
// VMEM; on Hopper the CTAs run in no order, so a second kernel computes
// dW = e^T du as a product split over the slot axis (each CTA a 64 x 128
// tile of dW over one of P slot ranges, re-gathering e), a third sums the P
// partials in a fixed order (deterministic, no atomics), and a fourth the
// d_attn partials. du and de must be zero on entry (slots outside every
// item are not written).
//
// Design, bf16 (the training path), on Hopper's own hardware. The stream is
// walked in fixed 64-slot tiles (one wgmma M), as the TPU kernel walks
// SLOT_TILE rows of it, each slot's example given by its segment id:
//   1. ragged_bwd_gather_kernel (one CTA per tile) gathers e once: the
//      table rows (fp32 masters rounded to bf16, or bf16), the keep mask
//      applied, written as an (N, K) bf16 stream; a tile with no valid slot
//      is marked dead and gets zeros in e, du and de (it needs no product);
//   2. ragged_bwd_tile_kernel<K, D>: one persistent CTA per SM over the live
//      tiles, three warpgroups. A producer thread loads the tile's e by TMA
//      (128-byte swizzle) and its keep mask (uint8, no swizzle: the de
//      epilogue reads it from shared memory), and streams W from L2
//      through a ring of kWStages
//      stages: for x, W's 64-row slices (every column); for de, W's
//      64-column slices (every row). W (288 KiB) does not fit a CTA, and a
//      split of W over a cluster would need a cross-CTA sum of x or de in
//      one of the two products, so it streams: 2 x 288 KiB of L2 reads per
//      64 slots. Two consumer warpgroups split the outputs:
//        x = e W:      consumer c owns x's columns [c D/2, (c+1) D/2)
//                      (wgmma m64n{D/2}, A = e K-major, B = W MN-major
//                      through the descriptor's transpose);
//        epilogue:     tanh in registers; the per-row partials of s = x.a
//                      and x.g_b meet in shared memory (consumer 0's half
//                      first); w, ds; du = (1 - x^2)(w g_b + ds a) rounded
//                      to bf16 into the swizzled tile that held e (the
//                      next product's K-major A) and into the (N, D) du
//                      stream; ds x summed over the tile's rows into
//                      per-warp d_attn partials in shared memory;
//        de = du W^T:  consumer c owns de's columns [c K/2, (c+1) K/2)
//                      (wgmma m64n{K/2}, B = the W slice K-major), times
//                      the keep mask / keep rate, written from registers;
//   3. ragged_bwd_dw_kernel_bf16<D>: dW = e^T du, split over slot ranges:
//      a unit is (128 rows of dW, half of its columns, a slot range); the
//      producer streams e and du chunks by TMA (contiguous now: no second
//      gather), the consumers run wgmma with A = e^T (MN-major, the
//      descriptor's transpose of A) and B = du (MN-major); fp32 partials;
//   4. the partials of dW and d_attn summed in a fixed order.
// No atomics: a run gives the same bits every time.
//
// Rounding: in bf16 mode du is rounded to bf16 before the two products
// that use it (de and dW), as the TPU's DEFAULT matmul precision rounds it
// for the MXU; x, w, ds, d_attn and all sums stay fp32. The plain version
// (ops/ragged.py::_grads_plain) rounds at the same places.
//
// Bound at the training shape (B = 1024, ~37.4K retained slots, K = D =
// 384), on an H100 SXM: three products of 2 N K D ~ 11 GFLOP each, ~33
// GFLOP -> ~0.034 ms at 989 TFLOP/s bf16 (~0.5 ms at 67 TFLOP/s fp32);
// bytes (gathered fp32 rows, the mask, de out) ~0.14 GB -> ~0.04 ms. This
// design also writes and reads the e and du streams (~0.1 GB) and reads W
// from L2 twice per tile (~0.34 GB of L2 reads).
//
// Shapes: K and D multiples of 128, at most 384; dt, dp multiples of 4.
// bf16: W 16-byte aligned (TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using c2v::bf16;
using c2v::from_f32;
using c2v::kThreads;
using c2v::round_to;
using c2v::Tile;
using c2v::to_f32;

constexpr int kSlots = 32;     // slots per work item and per dW chunk
constexpr int kBK = 32;        // depth of one staged W chunk
constexpr int kGroups = 3;     // 128-column accumulator groups: K, D <= 384
constexpr int kDwRows = 64;    // dW tile rows (of K)
constexpr int kDwCols = 128;   // dW tile columns (of D)

template <typename T>
struct ItemLayout {
  int lde, ldx, ldu, ldw1, ldw2, wc;
  __host__ __device__ ItemLayout(int K, int D) {
    const int pad = c2v::Pad<T>::value;
    lde = K + pad;          // gathered rows (kSlots x K)
    ldx = D + 1;            // x, fp32 (kSlots x D)
    ldu = D + pad;          // du in T (kSlots x D)
    ldw1 = D + pad;         // W chunk for x: (kBK x D), D contiguous
    ldw2 = kBK + pad;       // W chunk for de: (K x kBK), chunk contiguous
    wc = kBK * ldw1 > K * ldw2 ? kBK * ldw1 : K * ldw2;
  }
  __host__ __device__ size_t bytes(int D) const {
    return sizeof(T) * (static_cast<size_t>(kSlots) * (lde + ldu) + wc)
           + sizeof(float) * (static_cast<size_t>(kSlots) * ldx + 2 * D
                              + 2 * kSlots)
           + sizeof(int) * 4 * kSlots;
  }
};

// ------------------------------------------------------ per-item kernel
template <typename TT, typename T>
__global__ void __launch_bounds__(kThreads) ragged_bwd_item_kernel(
    const TT* __restrict__ tok, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_rows,
    const T* __restrict__ w,         // (K, D) row-major
    const T* __restrict__ attn,      // (D,)
    const int* __restrict__ ctx, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ item_ex,
    const int* __restrict__ item_start, const float* __restrict__ m,
    const float* __restrict__ z, const float* __restrict__ gc,
    const float* __restrict__ g,     // (B, D)
    int dt, int dp, int D, int token_pad, int path_pad,
    const uint8_t* __restrict__ keep, float keep_rate,
    T* __restrict__ du_out,          // (N, D)
    float* __restrict__ de_out,      // (N, K)
    float* __restrict__ part_dattn) {  // (n_items, D)
  static_assert(sizeof(T) == 4, "bf16 runs ragged_bwd_tile_kernel");
  const int item = blockIdx.x;
  const int b = item_ex[item];
  const int t0 = (item - item_start[b]) * kSlots;
  const int count = counts[b];
  if (t0 >= count) {                       // past the last item
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      part_dattn[static_cast<long long>(item) * D + c] = 0.f;
    }
    return;
  }
  const int K = 2 * dt + dp;
  const ItemLayout<T> L(K, D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Es = reinterpret_cast<T*>(smem_raw);
  T* DUs = Es + kSlots * L.lde;
  T* Wc = DUs + kSlots * L.ldu;
  float* Xs = reinterpret_cast<float*>(Wc + L.wc);
  float* attn_s = Xs + kSlots * L.ldx;
  float* g_s = attn_s + D;
  float* w_s = g_s + D;
  float* ds_s = w_s + kSlots;
  int* idx_s = reinterpret_cast<int*>(ds_s + kSlots);
  int* valid_s = idx_s + 3 * kSlots;

  const int start = starts[b];
  const int nt = min(kSlots, count - t0);
  const long long slot0 = static_cast<long long>(start) + t0;
  c2v::stage_triples<kSlots>(ctx, start + t0, nt, token_pad, path_pad, idx_s,
                             valid_s);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    attn_s[c] = to_f32(attn[c]);
    g_s[c] = g[static_cast<long long>(b) * D + c];
  }
  __syncthreads();
  c2v::gather_rows<TT, T>(tok, tok_rows, path_tab, path_rows, dt, dp, idx_s,
                          kSlots, nt, slot0, keep, keep_rate, Es, L.lde);
  __syncthreads();

  // recompute x = tanh(e W), W staged kBK rows at a time
  const int groups_d = D / 128;
  const int groups_k = K / 128;
  Tile<T, kSlots, 128, 2> acc[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) acc[q].zero();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    c2v::stage_rows<T, T>(w + static_cast<long long>(k0) * D, D, kBK, D, kBK,
                          Wc, L.ldw1);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (q < groups_d) {
        acc[q].template mma<true>(Es + k0, L.lde, Wc + q * 128, L.ldw1, kBK);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q < groups_d) {
      acc[q].each([&](int r, int c, float& v) {
        Xs[r * L.ldx + q * 128 + c] = tanhf(v);
      });
    }
  }
  __syncthreads();

  // per slot: score, x . g, the softmax weight w and ds (one warp a slot)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float m_b = m[b];
  const float z_b = z[b] > 0.f ? z[b] : 1.f;
  const float gc_b = gc[b];
  for (int t = warp; t < kSlots; t += kThreads / 32) {
    float s = 0.f, gd = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float x = Xs[t * L.ldx + c];
      s = fmaf(x, attn_s[c], s);
      gd = fmaf(x, g_s[c], gd);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      gd += __shfl_xor_sync(0xffffffffu, gd, off);
    }
    if (lane == 0) {
      const float wt = (t < nt && valid_s[t]) ? expf(s - m_b) / z_b : 0.f;
      w_s[t] = wt;
      ds_s[t] = wt * (gd - gc_b);
    }
  }
  __syncthreads();

  // du, rounded to T for the two products; the d_attn partial in fp32
  for (int q = threadIdx.x; q < kSlots * D; q += blockDim.x) {
    const int t = q / D;
    const int c = q - t * D;
    const float x = Xs[t * L.ldx + c];
    const float dx = w_s[t] * g_s[c] + ds_s[t] * attn_s[c];
    const T du = from_f32<T>((1.f - x * x) * dx);
    DUs[t * L.ldu + c] = du;
    if (t < nt) du_out[(slot0 + t) * D + c] = du;
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float a = 0.f;
    for (int t = 0; t < nt; ++t) a = fmaf(ds_s[t], Xs[t * L.ldx + c], a);
    part_dattn[static_cast<long long>(item) * D + c] = a;
  }
  __syncthreads();

  // de = du W^T, W staged kBK columns at a time
#pragma unroll
  for (int q = 0; q < kGroups; ++q) acc[q].zero();
  for (int c0 = 0; c0 < D; c0 += kBK) {
    c2v::stage_rows<T, T>(w + c0, D, K, kBK, K, Wc, L.ldw2);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (q < groups_k) {
        acc[q].template mma<false>(DUs + c0, L.ldu, Wc + q * 128 * L.ldw2,
                                   L.ldw2, kBK);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    if (q < groups_k) {
      acc[q].each([&](int r, int c, float& v) {
        if (r < nt) {
          const long long o = (slot0 + r) * K + q * 128 + c;
          float d = v;
          if (keep != nullptr) d = keep[o] ? d / keep_rate : 0.f;
          de_out[o] = d;
        }
      });
    }
  }
}

// ------------------------------------------------------------ dW kernel
// dW tile (kDwRows x kDwCols) at (blockIdx.x, blockIdx.y) over slot range
// blockIdx.z of the stream: part_dw[z] = sum_t e_t[j]^T du_t[c]. du is zero
// for every slot outside a valid segment, so the range needs no mask.
template <typename TT, typename T>
__global__ void __launch_bounds__(kThreads) ragged_bwd_dw_kernel(
    const TT* __restrict__ tok, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_rows,
    const int* __restrict__ ctx, long long n_slots,
    const T* __restrict__ du, int dt, int dp, int D, int token_pad,
    int path_pad, const uint8_t* __restrict__ keep, float keep_rate,
    long long slots_per_split, float* __restrict__ part_dw) {
  static_assert(sizeof(T) == 4, "bf16 runs ragged_bwd_dw_kernel_bf16");
  constexpr int pad = c2v::Pad<T>::value;
  constexpr int lda = kSlots + pad;        // e^T: (kDwRows x kSlots)
  constexpr int ldb = kDwCols + pad;       // du:  (kSlots x kDwCols)
  static_assert(kSlots * kDwRows == 8 * kThreads, "gather shape");
  __shared__ __align__(16) T As[kDwRows * lda];
  __shared__ __align__(16) T Bs[kSlots * ldb];
  __shared__ int idx_s[3 * kSlots];
  __shared__ int valid_s[kSlots];
  const int K = 2 * dt + dp;
  const int j0 = blockIdx.x * kDwRows;
  const int c0 = blockIdx.y * kDwCols;
  const long long first = blockIdx.z * slots_per_split;
  const long long last = min(n_slots, first + slots_per_split);
  const float rate_t = round_to<T>(keep_rate);
  Tile<T, kDwRows, kDwCols, 2> acc;
  acc.zero();
  for (long long s0 = first; s0 < last; s0 += kSlots) {
    const int ns = static_cast<int>(min(static_cast<long long>(kSlots),
                                        last - s0));
    c2v::stage_triples<kSlots>(ctx, static_cast<int>(s0), ns, token_pad,
                               path_pad, idx_s, valid_s);
    __syncthreads();
    // e^T, eight loads in flight per thread (kSlots * kDwRows = 8 x 256)
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int t = q / kDwRows;
      const int j = j0 + (q - t * kDwRows);
      v[i] = 0.f;
      if (t < ns) {
        if (j < dt) {
          v[i] = to_f32(tok[c2v::clamp_row(idx_s[3 * t], tok_rows) * dt + j]);
        } else if (j < dt + dp) {
          v[i] = to_f32(path_tab[c2v::clamp_row(idx_s[3 * t + 1], path_rows)
                                 * dp + (j - dt)]);
        } else {
          v[i] = to_f32(tok[c2v::clamp_row(idx_s[3 * t + 2], tok_rows) * dt
                            + (j - dt - dp)]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int t = q / kDwRows;
      const int j = j0 + (q - t * kDwRows);
      float e = round_to<T>(v[i]);
      if (t < ns && keep != nullptr) {
        e = keep[(s0 + t) * K + j] ? round_to<T>(e / rate_t) : 0.f;
      }
      As[(j - j0) * lda + t] = from_f32<T>(e);
    }
    c2v::stage_rows<T, T>(du + s0 * D + c0, D, kSlots, kDwCols, ns, Bs, ldb);
    __syncthreads();
    acc.template mma<true>(As, lda, Bs, ldb, kSlots);
    __syncthreads();
  }
  acc.each([&](int r, int c, float& v) {
    part_dw[(static_cast<long long>(blockIdx.z) * K + j0 + r) * D + c0 + c] =
        v;
  });
}

// Sums the P dW partials in a fixed order.
__global__ void ragged_bwd_reduce_kernel(const float* __restrict__ part_dw,
                                         int n_splits, long long kd,
                                         float* __restrict__ dw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < kd) {
    float s = 0.f;
    for (int p = 0; p < n_splits; ++p) s += part_dw[p * kd + i];
    dw[i] = s;
  }
}

// d_attn[c] = sum over items of the per-item partials: one CTA per column,
// its threads strided over the items, then a tree in shared memory (a
// fixed order).
__global__ void ragged_bwd_dattn_kernel(const float* __restrict__ part_dattn,
                                        int n_items, int D,
                                        float* __restrict__ dattn) {
  __shared__ float red[kThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int it = threadIdx.x; it < n_items; it += kThreads) {
    s += part_dattn[static_cast<long long>(it) * D + c];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) dattn[c] = red[0];
}


// Sums the reduction's inputs as the fp32 route did: part_dw (n_splits, K,
// D) into dw, part_dattn (n_parts, D) into dattn, each in a fixed order.
cudaError_t reduce_parts(const float* part_dw, int n_splits, int K, int D,
                         float* dw, const float* part_dattn, int n_parts,
                         float* dattn, cudaStream_t s) {
  const long long kd = static_cast<long long>(K) * D;
  ragged_bwd_reduce_kernel<<<static_cast<int>((kd + 255) / 256), 256, 0,
                             s>>>(part_dw, n_splits, kd, dw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ragged_bwd_dattn_kernel<<<D, kThreads, 0, s>>>(part_dattn, n_parts, D,
                                                 dattn);
  return cudaGetLastError();
}

template <typename TT, typename T>
cudaError_t launch_f32(const void* tok, long long tok_rows,
                       const void* path_tab, long long path_rows,
                       const void* w, const void* attn, const int* ctx,
                       const int* starts, const int* counts,
                       const int* item_ex, const int* item_start,
                       long long n_slots, int n_items, int dt, int dp, int D,
                       int token_pad, int path_pad, const uint8_t* keep,
                       float keep_rate, const float* m, const float* z,
                       const float* gc, const float* g, void* du, float* de,
                       float* part_dattn, int n_splits, float* part_dw,
                       float* dw, float* dattn, cudaStream_t s) {
  const int K = 2 * dt + dp;
  const ItemLayout<T> L(K, D);
  const size_t smem = L.bytes(D);
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_bwd_item_kernel<TT, T>, smem, allowed);
  if (n_items > 0) {
    ragged_bwd_item_kernel<TT, T><<<n_items, kThreads, smem, s>>>(
        static_cast<const TT*>(tok), tok_rows,
        static_cast<const TT*>(path_tab), path_rows,
        static_cast<const T*>(w), static_cast<const T*>(attn), ctx, starts,
        counts, item_ex, item_start, m, z, gc, g, dt, dp, D, token_pad,
        path_pad, keep, keep_rate, static_cast<T*>(du), de, part_dattn);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long chunks = (n_slots + kSlots - 1) / kSlots;
  const long long slots_per_split =
      ((chunks + n_splits - 1) / n_splits) * kSlots;
  const dim3 grid(K / kDwRows, D / kDwCols, n_splits);
  ragged_bwd_dw_kernel<TT, T><<<grid, kThreads, 0, s>>>(
      static_cast<const TT*>(tok), tok_rows,
      static_cast<const TT*>(path_tab), path_rows, ctx, n_slots,
      static_cast<const T*>(du), dt, dp, D, token_pad, path_pad, keep,
      keep_rate, slots_per_split, part_dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_parts(part_dw, n_splits, K, D, dw, part_dattn, n_items,
                      dattn, s);
}

// ------------------------------------------------ bf16 (wgmma, TMA)
constexpr int kTileSlots = 64;       // slots per tile: one wgmma M
constexpr int kWgThreads = 384;      // producer + two consumer warpgroups
constexpr int kBox = 64 * 64;        // bf16 elements of a 64 x 64 box
constexpr uint32_t kBoxBytes = kBox * 2;
constexpr int kWStages = 3;          // W slices in flight
constexpr int kDwStages = 4;         // e / du chunks in flight (dW)

// 1. One CTA per 64-slot tile: e (rounded, masked) into the (N, K) bf16
// stream and live[tile]; a tile without a valid slot gets zeros in e, du
// and de.
template <typename TT>
__global__ void __launch_bounds__(kThreads) ragged_bwd_gather_kernel(
    const TT* __restrict__ tok, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_rows,
    const int* __restrict__ ctx, const uint8_t* __restrict__ slot_valid,
    long long n_slots, int dt, int dp, int D, int token_pad, int path_pad,
    const uint8_t* __restrict__ keep, float keep_rate, bf16* __restrict__ e,
    bf16* __restrict__ du, float* __restrict__ de, int* __restrict__ live) {
  __shared__ int idx_s[3 * kTileSlots];
  __shared__ int valid_s[kTileSlots];
  const int K = 2 * dt + dp;
  const long long slot0 = static_cast<long long>(blockIdx.x) * kTileSlots;
  const int nt = static_cast<int>(
      min(static_cast<long long>(kTileSlots), n_slots - slot0));
  const int mine =
      threadIdx.x < nt ? static_cast<int>(slot_valid[slot0 + threadIdx.x]) : 0;
  const int any = __syncthreads_or(mine);
  if (threadIdx.x == 0) live[blockIdx.x] = any;
  if (any) {
    c2v::stage_triples<kTileSlots>(ctx, static_cast<int>(slot0), nt,
                                   token_pad, path_pad, idx_s, valid_s);
    __syncthreads();
    c2v::gather_rows<TT, bf16>(tok, tok_rows, path_tab, path_rows, dt, dp,
                               idx_s, nt, nt, slot0, keep, keep_rate,
                               e + slot0 * K, K);
    return;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4* e4 = reinterpret_cast<uint4*>(e + slot0 * K);
  for (int q = threadIdx.x; q < nt * K / 8; q += blockDim.x) e4[q] = zero;
  uint4* du4 = reinterpret_cast<uint4*>(du + slot0 * D);
  for (int q = threadIdx.x; q < nt * D / 8; q += blockDim.x) du4[q] = zero;
  uint4* de4 = reinterpret_cast<uint4*>(de + slot0 * K);
  for (int q = threadIdx.x; q < nt * K / 4; q += blockDim.x) de4[q] = zero;
}

// Shared memory of ragged_bwd_tile_kernel: every box 1024-byte aligned.
template <int K, int D>
struct TileSmem {
  static constexpr int kBoxes = (K > D ? K : D) / 64;
  bf16 ed[kBoxes][kBox];             // e (K/64 boxes), then du (D/64 boxes)
  bf16 w[kWStages][kBoxes][kBox];    // W slice: 64 rows (x) or 64 cols (de)
  uint8_t keep[K / 128][kTileSlots * 128];   // the tile's keep mask
  float attn[D];
  float red[2][kTileSlots][2];       // per consumer: row partials of s, x.g
  float dattn[2][4][D / 2];          // per consumer and warp: sum of ds x
  uint64_t e_full, e_empty, keep_full, keep_empty;
  uint64_t full[kWStages], empty[kWStages];
};

template <int K, int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(TileSmem<K, D>) + 1024;   // room to align the base to 1024
}

// 2. The per-slot products of the live tiles (design note above). out:
// du (N, D) bf16 and de (N, K) f32 rows of the live tiles, part_dattn
// (gridDim.x, D).
template <int K, int D>
__global__ void __launch_bounds__(kWgThreads, 1) ragged_bwd_tile_kernel(
    const __grid_constant__ CUtensorMap e_map,
    const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap keep_map, int has_keep,
    const bf16* __restrict__ attn,
    const int* __restrict__ seg, const uint8_t* __restrict__ slot_valid,
    const int* __restrict__ live, long long n_slots, int n_tiles,
    const float* __restrict__ m, const float* __restrict__ z,
    const float* __restrict__ gc, const float* __restrict__ g,
    float keep_rate, bf16* __restrict__ du_out, float* __restrict__ de_out,
    float* __restrict__ part_dattn) {
  constexpr int kXN = D / 2;          // x columns per consumer
  constexpr int kDeN = K / 2;         // de columns per consumer
  constexpr int kAcc = (kXN > kDeN ? kXN : kDeN) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<K, D>& sm = *reinterpret_cast<TileSmem<K, D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    for (int st = 0; st < kWStages; ++st) {
      hop::mbar_init(&sm.full[st], 1);
      hop::mbar_init(&sm.empty[st], 2);
    }
    hop::mbar_init(&sm.e_full, 1);
    hop::mbar_init(&sm.e_empty, 2);
    hop::mbar_init(&sm.keep_full, 1);
    hop::mbar_init(&sm.keep_empty, 256);
    hop::fence_barrier_init();
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    sm.attn[c] = __bfloat162float(attn[c]);
  }
  for (int i = threadIdx.x; i < 2 * 4 * kXN; i += blockDim.x) {
    (&sm.dattn[0][0][0])[i] = 0.f;
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hop::set_max_regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_tmap(&e_map);
      hop::prefetch_tmap(&w_map);
      if (has_keep) hop::prefetch_tmap(&keep_map);
      int g_st = 0;                   // W slices issued so far
      int it = 0;                     // live tiles begun so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        if (!live[tile]) continue;
        hop::mbar_wait(&sm.e_empty, (it & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.e_full, K * kTileSlots * 2);
#pragma unroll
        for (int b = 0; b < K / 64; ++b) {
          hop::tma_load_2d(sm.ed[b], &e_map, &sm.e_full, 64 * b,
                           tile * kTileSlots);
        }
        // x: W rows [64 q, 64 q + 64), every column box
        for (int q = 0; q < K / 64; ++q, ++g_st) {
          const int st = g_st % kWStages;
          hop::mbar_wait(&sm.empty[st], ((g_st / kWStages) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&sm.full[st], (D / 64) * kBoxBytes);
#pragma unroll
          for (int j = 0; j < D / 64; ++j) {
            hop::tma_load_2d(sm.w[st][j], &w_map, &sm.full[st], 64 * j,
                             64 * q);
          }
        }
        // the keep mask, once the last tile's de epilogue has read it
        if (has_keep) {
          hop::mbar_wait(&sm.keep_empty, (it & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&sm.keep_full, K * kTileSlots);
#pragma unroll
          for (int b = 0; b < K / 128; ++b) {
            hop::tma_load_2d(sm.keep[b], &keep_map, &sm.keep_full, 128 * b,
                             tile * kTileSlots);
          }
        }
        // de: W columns [64 j, 64 j + 64), every row box
        for (int j = 0; j < D / 64; ++j, ++g_st) {
          const int st = g_st % kWStages;
          hop::mbar_wait(&sm.empty[st], ((g_st / kWStages) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&sm.full[st], (K / 64) * kBoxBytes);
#pragma unroll
          for (int i = 0; i < K / 64; ++i) {
            hop::tma_load_2d(sm.w[st][i], &w_map, &sm.full[st], 64 * j,
                             64 * i);
          }
        }
        ++it;
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hop::set_max_regs_inc<232>();
    const int cw = wg - 1;                      // consumer 0 or 1
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const bool leader = t == 0;
    const int row0_ = 16 * warp + ((t & 31) >> 2);  // and row0_ + 8
    const int xc0 = cw * kXN;                   // this consumer's x columns
    const int kc0 = cw * kDeN;                  // and de columns
    // one accumulator array for both products (x, then de), reset to an
    // opaque zero before each, so no value flows from one product into the
    // other: with two arrays, or values the compiler can see through, the
    // x epilogue spills at D = 384
    float acc_regs[kAcc];
    float (&acc)[kXN / 2] = *reinterpret_cast<float(*)[kXN / 2]>(acc_regs);
    float (&acc2)[kDeN / 2] =
        *reinterpret_cast<float(*)[kDeN / 2]>(acc_regs);
    // W slices consumed so far; a live tile takes kSteps of them, so the
    // live tiles begun so far (the parity of e_full and keep_full) need no
    // register of their own
    constexpr int kSteps = K / 64 + D / 64;
    int g_st = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      if (!live[tile]) continue;
      const long long slot0 = static_cast<long long>(tile) * kTileSlots;
      // this thread's quad lane and first row, opaque to the compiler: the
      // addresses derived from them are formed per tile, not hoisted out of
      // the loop and kept (48 of them per epilogue would not fit)
      int tq = t & 3;
      int row0 = row0_;
      asm volatile("" : "+r"(tq), "+r"(row0));
      // x = e W (this consumer's columns)
      {
        const float zero = hop::opaque_zero();
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc_regs[j] = zero;
      }
      hop::mbar_wait(&sm.e_full, (g_st / kSteps) & 1);
      int prev = -1;
      for (int q = 0; q < K / 64; ++q, ++g_st) {
        const int st = g_st % kWStages;
        hop::mbar_wait(&sm.full[st], (g_st / kWStages) & 1);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.ed[q]) + kk * 32, 16,
              1024);
          const uint64_t db = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.w[st][xc0 / 64])
                  + kk * 2048,
              kBoxBytes, 1024);
          hop::wgmma<kXN, 1>(acc, da, db);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();             // the previous slice's products
        if (prev >= 0 && leader) hop::mbar_arrive(&sm.empty[prev]);
        prev = st;
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (leader) hop::mbar_arrive(&sm.empty[prev]);

      // this thread's two rows: example, validity
      int ex[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long slot = slot0 + row0 + 8 * h;
        const bool in = slot < n_slots;
        ok[h] = in && slot_valid[slot] != 0;
        ex[h] = in ? seg[slot] : 0;
      }
      // x = tanh in place and this half's partials of s = x . a, then of
      // x . g_b (two passes: fewer values live at once)
      float ps[2] = {0.f, 0.f}, pg[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kXN / 8; ++j) {
        const int c = xc0 + 8 * j + 2 * tq;
        const float a0 = sm.attn[c], a1 = sm.attn[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = tanhf(acc[4 * j + 2 * h]);
          const float x1 = tanhf(acc[4 * j + 2 * h + 1]);
          acc[4 * j + 2 * h] = x0;
          acc[4 * j + 2 * h + 1] = x1;
          ps[h] = fmaf(x1, a1, fmaf(x0, a0, ps[h]));
        }
      }
#pragma unroll
      for (int j = 0; j < kXN / 8; ++j) {
        const int c = xc0 + 8 * j + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 gv = *reinterpret_cast<const float2*>(
              g + static_cast<long long>(ex[h]) * D + c);
          pg[h] = fmaf(acc[4 * j + 2 * h + 1], gv.y,
                       fmaf(acc[4 * j + 2 * h], gv.x, pg[h]));
        }
        // at most eight columns' loads in flight: x stays in registers
        if (j % 8 == 7) asm volatile("" ::: "memory");
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], off);
          pg[h] += __shfl_xor_sync(0xffffffffu, pg[h], off);
        }
      }
      if (tq == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sm.red[cw][row0 + 8 * h][0] = ps[h];
          sm.red[cw][row0 + 8 * h][1] = pg[h];
        }
      }
      hop::named_sync(1, 256);     // both halves' partials; e is no longer read
      float wt[2], ds[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const float s = sm.red[0][r][0] + sm.red[1][r][0];
        const float gd = sm.red[0][r][1] + sm.red[1][r][1];
        const float z_b = z[ex[h]] > 0.f ? z[ex[h]] : 1.f;
        wt[h] = ok[h] ? expf(s - m[ex[h]]) / z_b : 0.f;
        ds[h] = wt[h] * (gd - gc[ex[h]]);
      }

      // du in bf16 into the tile that held e and into the du stream; the
      // d_attn partials ds x summed over the tile's rows
#pragma unroll
      for (int j = 0; j < kXN / 8; ++j) {
        const int c = xc0 + 8 * j + 2 * tq;
        const float a0 = sm.attn[c], a1 = sm.attn[c + 1];
        float da0 = 0.f, da1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          const float x0 = acc[4 * j + 2 * h];
          const float x1 = acc[4 * j + 2 * h + 1];
          const float2 gv = *reinterpret_cast<const float2*>(
              g + static_cast<long long>(ex[h]) * D + c);
          da0 = fmaf(ds[h], x0, da0);
          da1 = fmaf(ds[h], x1, da1);
          const __nv_bfloat162 d2 = __floats2bfloat162_rn(
              (1.f - x0 * x0) * fmaf(ds[h], a0, wt[h] * gv.x),
              (1.f - x1 * x1) * fmaf(ds[h], a1, wt[h] * gv.y));
          *reinterpret_cast<__nv_bfloat162*>(
              reinterpret_cast<unsigned char*>(sm.ed[c / 64])
              + hop::sw128_offset(r, c % 64)) = d2;
          if (slot0 + r < n_slots) {
            *reinterpret_cast<__nv_bfloat162*>(du_out + (slot0 + r) * D + c) =
                d2;
          }
        }
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1) {
          da0 += __shfl_xor_sync(0xffffffffu, da0, off);
          da1 += __shfl_xor_sync(0xffffffffu, da1, off);
        }
        if ((t & 31) < 4) {
          sm.dattn[cw][warp][c - xc0] += da0;
          sm.dattn[cw][warp][c - xc0 + 1] += da1;
        }
      }
      hop::fence_proxy_async();
      hop::named_sync(2, 256);     // both halves of du written
      {
        const float zero = hop::opaque_zero();
#pragma unroll
        for (int j = 0; j < kAcc; ++j) acc_regs[j] = zero;
      }

      // de = du W^T (this consumer's columns)
      prev = -1;
      for (int j = 0; j < D / 64; ++j, ++g_st) {
        const int st = g_st % kWStages;
        hop::mbar_wait(&sm.full[st], (g_st / kWStages) & 1);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.ed[j]) + kk * 32, 16,
              1024);
          const uint64_t db = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.w[st][0])
                  + kc0 * 128 + kk * 32,
              16, 1024);
          hop::wgmma<kDeN, 0>(acc2, da, db);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();
        if (prev >= 0 && leader) hop::mbar_arrive(&sm.empty[prev]);
        prev = st;
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc2);
      if (leader) {
        hop::mbar_arrive(&sm.empty[prev]);
        hop::mbar_arrive(&sm.e_empty);     // du read: the next e may land
      }
      // de times the keep mask (from shared memory) / keep rate, fp32,
      // from registers
      if (has_keep) hop::mbar_wait(&sm.keep_full, (g_st / kSteps - 1) & 1);
#pragma unroll
      for (int j = 0; j < kDeN / 8; ++j) {
        const int c = kc0 + 8 * j + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          const long long slot = slot0 + r;
          if (slot < n_slots) {
            float v0 = acc2[4 * j + 2 * h];
            float v1 = acc2[4 * j + 2 * h + 1];
            if (has_keep) {
              const uchar2 k2 = *reinterpret_cast<const uchar2*>(
                  &sm.keep[c / 128][r * 128 + c % 128]);
              v0 = k2.x ? v0 / keep_rate : 0.f;
              v1 = k2.y ? v1 / keep_rate : 0.f;
            }
            *reinterpret_cast<float2*>(de_out + slot * K + c) =
                make_float2(v0, v1);
          }
        }
      }
      if (has_keep) hop::mbar_arrive(&sm.keep_empty);
    }
    // this CTA's d_attn partial: its four warps' sums in order
    hop::named_sync(3 + cw, 128);
    for (int c = t; c < kXN; c += 128) {
      part_dattn[static_cast<long long>(blockIdx.x) * D + xc0 + c] =
          ((sm.dattn[cw][0][c] + sm.dattn[cw][1][c]) + sm.dattn[cw][2][c])
          + sm.dattn[cw][3][c];
    }
  }
}

// Shared memory of ragged_bwd_dw_kernel_bf16: a stage is e's 128 dW rows
// (two boxes, one per consumer) and du's D/2 columns of one 64-slot chunk.
template <int D>
struct DwSmem {
  static constexpr int kStageBoxes = 2 + D / 128;
  bf16 st[kDwStages][kStageBoxes][kBox];
  uint64_t full[kDwStages], empty[kDwStages];
};

template <int D>
constexpr size_t dw_smem_bytes() {
  return sizeof(DwSmem<D>) + 1024;
}

// 3. dW = e^T du over slot ranges. Unit u: split u / (2 K/128), then
// 128-row block kb and column half hf of dW; consumer c owns rows
// [kb 128 + 64 c, + 64) and columns [hf D/2, + D/2). part_dw (n_splits, K,
// D).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) ragged_bwd_dw_kernel_bf16(
    const __grid_constant__ CUtensorMap e_map,
    const __grid_constant__ CUtensorMap du_map,
    const int* __restrict__ live, int n_tiles, int K, int chunks_per_split,
    float* __restrict__ part_dw) {
  constexpr int kN = D / 2;
  constexpr uint32_t kStageBytes = DwSmem<D>::kStageBoxes * kBoxBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<D>& sm = *reinterpret_cast<DwSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int per_split = 2 * (K / 128);
  const int split = blockIdx.x / per_split;
  const int kb = (blockIdx.x % per_split) / 2;
  const int hf = blockIdx.x % 2;
  const int ch0 = split * chunks_per_split;
  const int ch1 = min(n_tiles, ch0 + chunks_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], 2);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hop::set_max_regs_dec<40>();
    if (threadIdx.x == 0) {
      hop::prefetch_tmap(&e_map);
      hop::prefetch_tmap(&du_map);
      int g = 0;
      for (int ch = ch0; ch < ch1; ++ch) {
        if (!live[ch]) continue;
        const int s = g % kDwStages;
        hop::mbar_wait(&sm.empty[s], ((g / kDwStages) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.full[s], kStageBytes);
        for (int c = 0; c < 2; ++c) {
          hop::tma_load_2d(sm.st[s][c], &e_map, &sm.full[s],
                           kb * 128 + 64 * c, ch * kTileSlots);
        }
#pragma unroll
        for (int j = 0; j < D / 128; ++j) {
          hop::tma_load_2d(sm.st[s][2 + j], &du_map, &sm.full[s],
                           hf * kN + 64 * j, ch * kTileSlots);
        }
        ++g;
      }
    }
  } else {
    hop::set_max_regs_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const bool leader = t == 0;
    const int row0 = 16 * (t >> 5) + ((t & 31) >> 2);
    float acc[kN / 2];       // the first step overwrites it
    int g = 0;
    int prev = -1;
    for (int ch = ch0; ch < ch1; ++ch) {
      if (!live[ch]) continue;
      const int s = g % kDwStages;
      hop::mbar_wait(&sm.full[s], (g / kDwStages) & 1);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {        // 16 slots per step
        const uint64_t da = hop::desc_sw128(
            reinterpret_cast<const unsigned char*>(sm.st[s][cw]) + kk * 2048,
            kBoxBytes, 1024);
        const uint64_t db = hop::desc_sw128(
            reinterpret_cast<const unsigned char*>(sm.st[s][2]) + kk * 2048,
            kBoxBytes, 1024);
        hop::wgmma<kN, 1, 1>(acc, da, db, g > 0 || kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (prev >= 0 && leader) hop::mbar_arrive(&sm.empty[prev]);
      prev = s;
      ++g;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (g == 0) {                             // no live chunk: a zero partial
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) acc[j] = 0.f;
    }
    float* dst = part_dw
                 + (static_cast<long long>(split) * K + kb * 128 + 64 * cw)
                       * D
                 + hf * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        *reinterpret_cast<float2*>(dst + static_cast<long long>(r) * D + 8 * j
                                   + 2 * (t & 3)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int K, int D>
cudaError_t launch_tiles(const CUtensorMap& e_map, const void* w,
                         const void* attn, const int* seg,
                         const uint8_t* slot_valid, const int* live,
                         long long n_slots, int n_tiles, int n_parts,
                         const float* m, const float* z, const float* gc,
                         const float* g, const uint8_t* keep,
                         float keep_rate, void* du, float* de,
                         float* part_dattn, cudaStream_t s) {
  CUtensorMap w_map;
  cudaError_t err = hop::encode_tmap_2d(&w_map, w, K, D, D * 2, 64);
  if (err != cudaSuccess) return err;
  CUtensorMap keep_map = e_map;       // not read without a mask
  if (keep != nullptr) {
    if (reinterpret_cast<uintptr_t>(keep) & 15) {
      return cudaErrorMisalignedAddress;
    }
    err = hop::encode_tmap_2d_u8(&keep_map, keep, n_slots, K, K, 128,
                                 kTileSlots);
    if (err != cudaSuccess) return err;
  }
  static_assert(tile_smem_bytes<K, D>() <= 232448, "shared memory");
  const size_t smem = tile_smem_bytes<K, D>();
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_bwd_tile_kernel<K, D>, smem, allowed);
  ragged_bwd_tile_kernel<K, D><<<n_parts, kWgThreads, smem, s>>>(
      e_map, w_map, keep_map, keep != nullptr ? 1 : 0,
      static_cast<const bf16*>(attn), seg, slot_valid, live, n_slots,
      n_tiles, m, z, gc, g, keep_rate, static_cast<bf16*>(du), de,
      part_dattn);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dw(const CUtensorMap& e_map, const void* du,
                      long long n_slots, const int* live, int n_tiles, int K,
                      int n_splits, int chunks_per_split, float* part_dw,
                      cudaStream_t s) {
  CUtensorMap du_map;
  cudaError_t err = hop::encode_tmap_2d(&du_map, du, n_slots, D, D * 2, 64);
  if (err != cudaSuccess) return err;
  const size_t smem = dw_smem_bytes<D>();
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_bwd_dw_kernel_bf16<D>, smem, allowed);
  ragged_bwd_dw_kernel_bf16<D><<<n_splits * 2 * (K / 128), kWgThreads, smem,
                                 s>>>(e_map, du_map, live, n_tiles, K,
                                      chunks_per_split, part_dw);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_tiles_k(int D, const CUtensorMap& e_map, const void* w,
                           const void* attn, const int* seg,
                           const uint8_t* slot_valid, const int* live,
                           long long n_slots, int n_tiles, int n_parts,
                           const float* m, const float* z, const float* gc,
                           const float* g, const uint8_t* keep,
                           float keep_rate, void* du, float* de,
                           float* part_dattn, cudaStream_t s) {
  switch (D) {
    case 128:
      return launch_tiles<K, 128>(e_map, w, attn, seg, slot_valid, live,
                                  n_slots, n_tiles, n_parts, m, z, gc, g,
                                  keep, keep_rate, du, de, part_dattn, s);
    case 256:
      return launch_tiles<K, 256>(e_map, w, attn, seg, slot_valid, live,
                                  n_slots, n_tiles, n_parts, m, z, gc, g,
                                  keep, keep_rate, du, de, part_dattn, s);
    case 384:
      return launch_tiles<K, 384>(e_map, w, attn, seg, slot_valid, live,
                                  n_slots, n_tiles, n_parts, m, z, gc, g,
                                  keep, keep_rate, du, de, part_dattn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TT>
cudaError_t launch_bf16(const void* tok, long long tok_rows,
                        const void* path_tab, long long path_rows,
                        const void* w, const void* attn, const int* ctx,
                        const int* seg, const uint8_t* slot_valid,
                        long long n_slots, int dt, int dp, int D,
                        int token_pad, int path_pad, const uint8_t* keep,
                        float keep_rate, const float* m, const float* z,
                        const float* gc, const float* g, void* du, float* de,
                        void* e, int* live, float* part_dattn, int n_parts,
                        int n_splits, int chunks_per_split, float* part_dw,
                        float* dw, float* dattn, cudaStream_t s) {
  const int K = 2 * dt + dp;
  if (reinterpret_cast<uintptr_t>(w) & 15) return cudaErrorMisalignedAddress;
  const int n_tiles = static_cast<int>((n_slots + kTileSlots - 1) / kTileSlots);
  if (n_tiles > 0) {
    ragged_bwd_gather_kernel<TT><<<n_tiles, kThreads, 0, s>>>(
        static_cast<const TT*>(tok), tok_rows,
        static_cast<const TT*>(path_tab), path_rows, ctx, slot_valid,
        n_slots, dt, dp, D, token_pad, path_pad, keep, keep_rate,
        static_cast<bf16*>(e), static_cast<bf16*>(du), de, live);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap e_map;
  cudaError_t err = hop::encode_tmap_2d(&e_map, e, n_slots > 0 ? n_slots : 1,
                                        K, K * 2, 64);
  if (err != cudaSuccess) return err;
  switch (K) {
    case 128:
      err = launch_tiles_k<128>(D, e_map, w, attn, seg, slot_valid, live,
                                n_slots, n_tiles, n_parts, m, z, gc, g, keep,
                                keep_rate, du, de, part_dattn, s);
      break;
    case 256:
      err = launch_tiles_k<256>(D, e_map, w, attn, seg, slot_valid, live,
                                n_slots, n_tiles, n_parts, m, z, gc, g, keep,
                                keep_rate, du, de, part_dattn, s);
      break;
    case 384:
      err = launch_tiles_k<384>(D, e_map, w, attn, seg, slot_valid, live,
                                n_slots, n_tiles, n_parts, m, z, gc, g, keep,
                                keep_rate, du, de, part_dattn, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  switch (D) {
    case 128:
      err = launch_dw<128>(e_map, du, n_slots, live, n_tiles, K, n_splits,
                           chunks_per_split, part_dw, s);
      break;
    case 256:
      err = launch_dw<256>(e_map, du, n_slots, live, n_tiles, K, n_splits,
                           chunks_per_split, part_dw, s);
      break;
    case 384:
      err = launch_dw<384>(e_map, du, n_slots, live, n_tiles, K, n_splits,
                           chunks_per_split, part_dw, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return reduce_parts(part_dw, n_splits, K, D, dw, part_dattn, n_parts,
                      dattn, s);
}

}  // namespace

extern "C" {

// Slots per fp32 work item, for the wrapper's item map.
int ragged_bwd_tile() { return kSlots; }

// Slots per bf16 slot tile.
int ragged_bwd_slot_tile() { return kTileSlots; }

// dtype_code 0: float32 compute (tables, W, attention float32); 1:
// bfloat16 compute (W, attention bfloat16; tables bfloat16 when table_code
// is 1, float32 rounded on load when it is 0). The caller checks the
// shapes (K, D multiples of 128 and at most 384; dt, dp multiples of 4).
// Every output row is written: de (N, K) f32, dw (K, D) f32, dattn (D,)
// f32; du (N, D) in the compute type is the stream of du.
//   fp32: the work items (starts, counts, item_ex, item_start; n_parts
//     items); du and de must be zero on entry; part_dattn (n_parts, D) and
//     part_dw (n_splits, K, D) scratch; seg, slot_valid, e, live,
//     chunks_per_split unused.
//   bf16: seg (N,) int32 flat example of each slot, slot_valid (N,) uint8;
//     scratch e (N, K) bf16, live (ceil(N / 64),) int32, part_dattn
//     (n_parts, D) with n_parts the tile kernel's CTAs, part_dw (n_splits,
//     K, D) with chunks_per_split 64-slot chunks per split; w 16-byte
//     aligned; the item arguments unused.
// Returns cudaGetLastError() after the launches (0 = launched).
int ragged_bwd(int dtype_code, int table_code, const void* tok,
               long long tok_rows, const void* path_tab, long long path_rows,
               const void* w, const void* attn, const int* ctx,
               const int* starts, const int* counts, const int* item_ex,
               const int* item_start, const int* seg,
               const uint8_t* slot_valid, long long n_slots, int dt, int dp,
               int d_code, int token_pad, int path_pad, const uint8_t* keep,
               float keep_rate, const float* m, const float* z,
               const float* gc, const float* g, void* du, float* de, void* e,
               int* live, float* part_dattn, int n_parts, int n_splits,
               int chunks_per_split, float* part_dw, float* dw, float* dattn,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0 && table_code == 0) {
    err = launch_f32<float, float>(
        tok, tok_rows, path_tab, path_rows, w, attn, ctx, starts, counts,
        item_ex, item_start, n_slots, n_parts, dt, dp, d_code, token_pad,
        path_pad, keep, keep_rate, m, z, gc, g, du, de, part_dattn, n_splits,
        part_dw, dw, dattn, s);
  } else if (dtype_code == 1 && table_code == 0) {
    err = launch_bf16<float>(tok, tok_rows, path_tab, path_rows, w, attn, ctx,
                             seg, slot_valid, n_slots, dt, dp, d_code,
                             token_pad, path_pad, keep, keep_rate, m, z, gc,
                             g, du, de, e, live, part_dattn, n_parts,
                             n_splits, chunks_per_split, part_dw, dw, dattn,
                             s);
  } else if (dtype_code == 1 && table_code == 1) {
    err = launch_bf16<bf16>(tok, tok_rows, path_tab, path_rows, w, attn, ctx,
                            seg, slot_valid, n_slots, dt, dp, d_code,
                            token_pad, path_pad, keep, keep_rate, m, z, gc, g,
                            du, de, e, live, part_dattn, n_parts, n_splits,
                            chunks_per_split, part_dw, dw, dattn, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ragged_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
