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
// Design. The per-slot work uses the forward's one-tile work items (32
// slots of one example, the wrapper's item_ex map): one CTA re-gathers the
// tile's rows, recomputes x on the tensor cores (bf16) or CUDA cores
// (fp32), forms w, ds and du, writes du (N, D) in the compute type and
// de = du W^T for its slots, and a per-item d_attn partial. The TPU kernel
// carries dW and d_attn across its ordered grid in VMEM; on Hopper the CTAs
// run in no order, and per-item dW partials (~2,400 x 590 KB) would not
// fit, nor would millions of contended atomics be cheap. So a second
// kernel computes dW = e^T du as a product split over the slot axis: each
// CTA owns a 64 x 128 tile of dW and one of P slot ranges, re-gathers e
// (with the mask) and reads du, and writes an fp32 partial; a third kernel
// sums the P partials in a fixed order
// (deterministic, no atomics), and a fourth the d_attn partials.
//
// Rounding: in bf16 mode du is rounded to bf16 before the two products
// that use it (de and dW), as the TPU's DEFAULT matmul precision rounds it
// for the MXU; x, w, ds, d_attn and all sums stay fp32. The plain version
// (ops/ragged.py::_grads_plain) rounds at the same places.
//
// Bound at the training shape (B = 1024, ~37.4K retained slots, K = D =
// 384), on an H100 SXM: three products of 2 N K D ~ 11 GFLOP each, ~33
// GFLOP -> ~0.03 ms at 989 TFLOP/s bf16 (~0.5 ms at 67 TFLOP/s fp32);
// bytes (gathered rows, du and de out) ~0.1 GB -> ~0.03 ms. mma.sync with
// operands staged through shared memory, W re-read from L2 per tile and
// the recompute of x both keep this kernel well above that bound; wgmma
// and TMA-fed W tiles are the later work.
//
// Shapes: K and D multiples of 128, at most 384 (three 128-column groups
// of accumulators per thread); dt, dp multiples of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

template <typename TT, typename T>
cudaError_t launch(const void* tok, long long tok_rows, const void* path_tab,
                   long long path_rows, const void* w, const void* attn,
                   const int* ctx, const int* starts, const int* counts,
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
  const long long kd = static_cast<long long>(K) * D;
  ragged_bwd_reduce_kernel<<<static_cast<int>((kd + 255) / 256), 256, 0,
                             s>>>(part_dw, n_splits, kd, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ragged_bwd_dattn_kernel<<<D, kThreads, 0, s>>>(part_dattn, n_items, D,
                                                 dattn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots per work item, for the wrapper's item map.
int ragged_bwd_tile() { return kSlots; }

// dtype_code 0: float32 compute (tables, W, attention float32); 1:
// bfloat16 compute (W, attention bfloat16; tables bfloat16 when table_code
// is 1, float32 rounded on load when it is 0). du (N, D) in the compute
// type and de (N, K) float32 must be zero on entry (slots outside every
// item are not written). part_dattn (n_items, D), part_dw (n_splits, K, D)
// are scratch; dw (K, D) and dattn (D,) receive the sums. The caller checks
// the shapes (K, D multiples of 128 and at most 384; dt, dp multiples of
// 4). Returns cudaGetLastError() after the launches (0 = launched).
int ragged_bwd(int dtype_code, int table_code, const void* tok,
               long long tok_rows, const void* path_tab, long long path_rows,
               const void* w, const void* attn, const int* ctx,
               const int* starts, const int* counts, const int* item_ex,
               const int* item_start, long long n_slots, int n_items, int dt,
               int dp, int d_code, int token_pad, int path_pad,
               const uint8_t* keep, float keep_rate, const float* m,
               const float* z, const float* gc, const float* g, void* du,
               float* de, float* part_dattn, int n_splits, float* part_dw,
               float* dw, float* dattn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype_code == 0 && table_code == 0) {
    err = launch<float, float>(tok, tok_rows, path_tab, path_rows, w, attn,
                               ctx, starts, counts, item_ex, item_start,
                               n_slots, n_items, dt, dp, d_code, token_pad,
                               path_pad, keep, keep_rate, m, z, gc, g, du, de,
                               part_dattn, n_splits, part_dw, dw, dattn, s);
  } else if (dtype_code == 1 && table_code == 0) {
    err = launch<float, bf16>(tok, tok_rows, path_tab, path_rows, w, attn,
                              ctx, starts, counts, item_ex, item_start,
                              n_slots, n_items, dt, dp, d_code, token_pad,
                              path_pad, keep, keep_rate, m, z, gc, g, du, de,
                              part_dattn, n_splits, part_dw, dw, dattn, s);
  } else if (dtype_code == 1 && table_code == 1) {
    err = launch<bf16, bf16>(tok, tok_rows, path_tab, path_rows, w, attn,
                             ctx, starts, counts, item_ex, item_start,
                             n_slots, n_items, dt, dp, d_code, token_pad,
                             path_pad, keep, keep_rate, m, z, gc, g, du, de,
                             part_dattn, n_splits, part_dw, dw, dattn, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ragged_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
