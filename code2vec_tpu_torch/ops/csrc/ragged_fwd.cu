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
// A slot is valid iff any of its three indices is not PAD (interior holes
// drop out); slots past the shard total belong to no segment and keep the
// -1e30 the wrapper fills in.
//
// Design. The TPU kernel walks the slot tiles in order on one core, resolves
// segment membership with a (T, n_seg) one-hot on the MXU and keeps (m, z,
// acc) for ALL examples in VMEM, rescaling them tile by tile. On Hopper
// blocks run in parallel and in no order, so the work is cut by example: a
// work item is one tile (up to 16 or 32 slots) of one example's CSR segment,
// and one CTA takes one item. It needs no one-hot: its slots all belong to
// one example. It writes that tile's partial (m, z, acc); a second small
// kernel folds each example's partials with the FuseMax rescale
// (acc = sum acc_i e^(m_i - m)). Cutting long segments into items keeps the
// longest example (200 slots) from serialising on one CTA: with one CTA per
// example that tail set the kernel's time. The gather is fused: each tile's
// (src, pth, tgt) rows are read from the tables straight into shared memory
// (16-byte or 8-byte loads, eight in flight per thread), so no gathered
// (N, 3d) intermediate reaches device memory. W (3d x D, 295 KB in bf16)
// does not fit in shared memory; it is read from L2, each element once per
// tile. x stays fp32 for the score and the weighted sum, as in the Pallas
// kernel. Training runs the same kernel on the fp32 master tables, each
// element rounded to bf16 as it is loaded (the reference's take, then
// astype: no per-step cast of ~1.7 GB of tables), with an optional (N, K)
// uint8 dropout keep mask applied to the gathered rows (e / keep where
// kept, 0 elsewhere): the mask the backward (ragged_bwd.cu) applies too.
//   bf16: tiles of 32 slots (two m16 tiles) on the tensor cores with
//         mma.sync m16n8k16 (bf16 in, fp32 accumulation); each warp owns 32
//         output columns.
//   fp32: tiles of 16 slots on the CUDA cores (fp32 FMAs, one output column
//         per thread): the tensor cores have no exact-fp32 product.
//
// Bound at the serving shape (B = 1024, java14m fill: median 28 of 200
// slots, ~28.7K retained slots, d = 128/128, D = 384), on an H100 SXM:
//   bytes: gathered rows 28.7K x 384 x 2 B ~ 22 MB in bf16 (44 MB from fp32
//          tables) -> ~7-13 us at 3.35 TB/s;
//   operations: 2 x 28.7K x 384 x 384 ~ 8.5 GFLOP -> ~9 us at 989 TFLOP/s
//          bf16 on the tensor cores (~127 us at 67 TFLOP/s fp32).
// So bf16 is bound by memory and tensor-core rate about equally. This kernel
// re-reads W from L2 once per tile (~1,400 tiles x 295 KB), with half-used
// sectors, and mma.sync reaches a fraction of the wgmma rate: wgmma with
// W tiles brought in by TMA is the later work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using c2v::bf16;
using c2v::kNeg;
using c2v::stage_triples;

constexpr int kTileF = 16;         // slots per tile, fp32 kernel
constexpr int kTileM = 32;         // slots per tile, bf16 mma kernel

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

// ----------------------------------------------------------- bf16 kernel
// Same work items and partial outputs as the fp32 kernel. Requires
// D % 32 == 0 (one warp per 32 columns), K % 16 == 0, dt, dp % 4 == 0.
// The tables are bf16 (serving copies) or fp32 (training masters, each
// element rounded to bf16 on load: no per-step cast of the whole tables).
template <typename TT>
__global__ void ragged_fwd_bf16_kernel(
    const TT* __restrict__ tok, long long tok_rows,
    const TT* __restrict__ path_tab, long long path_rows,
    const __nv_bfloat16* __restrict__ w,     // (K, D) row-major
    const __nv_bfloat16* __restrict__ attn,  // (D,)
    const int* __restrict__ ctx, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ item_ex,
    const int* __restrict__ item_start, int dt, int dp, int D,
    int token_pad, int path_pad, const uint8_t* __restrict__ keep,
    float keep_rate, float* __restrict__ scores,
    float* __restrict__ part_m, float* __restrict__ part_z,
    float* __restrict__ part_acc) {
  const int item = blockIdx.x;
  const int b = item_ex[item];
  const int t0 = (item - item_start[b]) * kTileM;
  const int count = counts[b];
  if (t0 >= count) return;                 // past the last item
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = 2 * dt + dp;
  const int KS = K + 8;                    // padded row: conflict-free A loads
  __nv_bfloat16* e_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(e_s + kTileM * KS);  // (32, kTileM)
  float* sc_s = red + 32 * kTileM;         // (kTileM,)
  int* valid_s = reinterpret_cast<int*>(sc_s + kTileM);      // (kTileM,)
  int* idx_s = valid_s + kTileM;           // (3 kTileM,)
  const uint16_t* w16 = reinterpret_cast<const uint16_t*>(w);

  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2;                 // mma group: row within m16
  const int tq = lane & 3;                 // thread in group: column pair
  const int col0 = warp * 32;              // this warp's 32 output columns
  const int start = starts[b];
  const int nt = min(kTileM, count - t0);

  stage_triples<kTileM>(ctx, start + t0, nt, token_pad, path_pad, idx_s,
                        valid_s);
  __syncthreads();
  c2v::gather_rows<TT, bf16>(tok, tok_rows, path_tab, path_rows, dt, dp,
                             idx_s, kTileM, nt, start + t0, keep, keep_rate,
                             e_s, KS);
  __syncthreads();

  // x = e . W[:, col0:col0+32] on the tensor cores: [m-tile][n-tile][4]
  float c[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* base = e_s + (mt * 16 + g) * KS + k0 + 2 * tq;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * KS);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * KS + 8);
    }
    const long long r0 = static_cast<long long>(k0 + 2 * tq) * D;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = col0 + n * 8 + g;
      const uint32_t b0 = w16[r0 + col] | (uint32_t(w16[r0 + D + col]) << 16);
      const uint32_t b1 = w16[r0 + 8 * D + col]
                          | (uint32_t(w16[r0 + 9 * D + col]) << 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        c2v::mma_bf16_16816(c[mt][n], a[mt], b0, b1);
      }
    }
  }

  // tanh; score partials for this thread's rows g, g+8 of each m-tile
  float attn_c[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      attn_c[n][e] = __bfloat162float(attn[col0 + n * 8 + 2 * tq + e]);
    }
  }
  float part[2][2] = {};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        c[mt][n][e] = tanhf(c[mt][n][e]);
        c[mt][n][2 + e] = tanhf(c[mt][n][2 + e]);
        part[mt][0] = fmaf(c[mt][n][e], attn_c[n][e], part[mt][0]);
        part[mt][1] = fmaf(c[mt][n][2 + e], attn_c[n][e], part[mt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p = part[mt][h];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (tq == 0) red[warp * kTileM + mt * 16 + h * 8 + g] = p;
    }
  }
  __syncthreads();
  if (j < kTileM) {
    float s = 0.f;
    for (int wi = 0; wi < nwarps; ++wi) s += red[wi * kTileM + j];
    s = valid_s[j] ? s : kNeg;
    sc_s[j] = s;
    if (j < nt) scores[start + t0 + j] = s;
  }
  __syncthreads();
  float m, z;
  tile_stats<kTileM>(sc_s, valid_s, nt, m, z);
  float p_row[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = mt * 16 + h * 8 + g;
      p_row[mt][h] = (t < nt && valid_s[t]) ? expf(sc_s[t] - m) : 0.f;
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        s = fmaf(p_row[mt][0], c[mt][n][e], s);
        s = fmaf(p_row[mt][1], c[mt][n][2 + e], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) {
        part_acc[static_cast<long long>(item) * D + col0 + n * 8 + 2 * tq
                 + e] = s;
      }
    }
  }
  if (j == 0) {
    part_m[item] = m;
    part_z[item] = z;
  }
}

// ---------------------------------------------------------------- merge
// Per example: fold the partials of its ceil(count / tile) items with the
// FuseMax rescale, m = max m_i, z = sum z_i e^(m_i - m),
// acc = sum acc_i e^(m_i - m). An example with count == 0 has no items and
// gets m = -1e30, z = 0, acc = 0.
__global__ void ragged_merge_kernel(
    const int* __restrict__ counts, const int* __restrict__ item_start,
    int tile, int D, const float* __restrict__ part_m,
    const float* __restrict__ part_z, const float* __restrict__ part_acc,
    float* __restrict__ m_out, float* __restrict__ z_out,
    float* __restrict__ acc_out) {
  const int b = blockIdx.x;
  const int first = item_start[b];
  const int n_items = (counts[b] + tile - 1) / tile;
  float m = kNeg;
  for (int i = 0; i < n_items; ++i) m = fmaxf(m, part_m[first + i]);
  if (threadIdx.x == 0) {
    float z = 0.f;
    for (int i = 0; i < n_items; ++i) {
      z += part_z[first + i] * expf(part_m[first + i] - m);
    }
    m_out[b] = m;
    z_out[b] = z;
  }
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < n_items; ++i) {
      acc += part_acc[static_cast<long long>(first + i) * D + j]
             * expf(part_m[first + i] - m);
    }
    acc_out[static_cast<long long>(b) * D + j] = acc;
  }
}

// Launches the bf16 route for table type TT; returns the launch error.
template <typename TT>
cudaError_t launch_bf16(int n_items, int threads, size_t smem,
                        cudaStream_t s, const void* tok, long long tok_rows,
                        const void* path_tab, long long path_rows,
                        const void* w, const void* attn, const int* ctx,
                        const int* starts, const int* counts,
                        const int* item_ex, const int* item_start, int dt,
                        int dp, int d_code, int token_pad, int path_pad,
                        const uint8_t* keep, float keep_rate, float* scores,
                        float* part_m, float* part_z, float* part_acc) {
  static size_t allowed = 48 * 1024;
  c2v::allow_smem(ragged_fwd_bf16_kernel<TT>, smem, allowed);
  if (n_items > 0) {
    ragged_fwd_bf16_kernel<TT><<<n_items, threads, smem, s>>>(
        static_cast<const TT*>(tok), tok_rows,
        static_cast<const TT*>(path_tab), path_rows,
        static_cast<const bf16*>(w), static_cast<const bf16*>(attn), ctx,
        starts, counts, item_ex, item_start, dt, dp, d_code, token_pad,
        path_pad, keep, keep_rate, scores, part_m, part_z, part_acc);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots per work item of each route, for the wrapper's item map.
int ragged_fwd_tile(int dtype_code) {
  return dtype_code == 0 ? kTileF : kTileM;
}

// dtype_code 0: float32 compute (tables, weights float32); 1: bfloat16
// compute (weights bfloat16; tables bfloat16 when table_code is 1, float32
// rounded on load when it is 0). keep, when not null, is the (N, K) uint8
// dropout keep mask of the packed stream, applied to the gathered rows
// with keep_rate. `n_items` work items (item_ex, item_start from the
// wrapper; items past the last write nothing), partials in part_*
// (n_items, and n_items x D), results in m_out, z_out (batch,) and acc_out
// (batch, D). The caller checks the shapes (dt, dp multiples of 4; for
// bf16 also D % 32 == 0 and K % 16 == 0; 16 <= D <= 1024). Returns
// cudaGetLastError() after the launches (0 = launched).
int ragged_fwd(int dtype_code, int table_code, const void* tok,
               long long tok_rows, const void* path_tab, long long path_rows,
               const void* w, const void* attn, const int* ctx,
               const int* starts, const int* counts, const int* item_ex,
               const int* item_start, int batch, int n_items, int dt, int dp,
               int d_code, int token_pad, int path_pad, const uint8_t* keep,
               float keep_rate, float* scores, float* part_m, float* part_z,
               float* part_acc, float* m_out, float* z_out, float* acc_out,
               void* stream) {
  if (batch == 0) return 0;
  const int k_dim = 2 * dt + dp;
  const int threads = ((d_code + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tile;
  cudaError_t launched;
  if (dtype_code == 0 && table_code == 0) {
    tile = kTileF;
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
    launched = cudaGetLastError();
  } else if (dtype_code == 1 && (table_code == 0 || table_code == 1)) {
    tile = kTileM;
    const size_t smem = sizeof(bf16) * static_cast<size_t>(kTileM)
                            * (k_dim + 8)
                        + sizeof(float) * (32 * kTileM + kTileM)
                        + sizeof(int) * 4 * kTileM;
    launched = table_code == 0
        ? launch_bf16<float>(n_items, threads, smem, s, tok, tok_rows,
                             path_tab, path_rows, w, attn, ctx, starts,
                             counts, item_ex, item_start, dt, dp, d_code,
                             token_pad, path_pad, keep, keep_rate, scores,
                             part_m, part_z, part_acc)
        : launch_bf16<bf16>(n_items, threads, smem, s, tok, tok_rows,
                            path_tab, path_rows, w, attn, ctx, starts,
                            counts, item_ex, item_start, dt, dp, d_code,
                            token_pad, path_pad, keep, keep_rate, scores,
                            part_m, part_z, part_acc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (launched != cudaSuccess) return static_cast<int>(launched);
  ragged_merge_kernel<<<batch, 128, 0, s>>>(counts, item_start, tile, d_code,
                                            part_m, part_z, part_acc, m_out,
                                            z_out, acc_out);
  return static_cast<int>(cudaGetLastError());
}

const char* ragged_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
