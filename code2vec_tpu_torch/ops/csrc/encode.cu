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
// bf16 (serving and evaluation), on Hopper's own hardware. The TPU kernel
// keeps all of W in VMEM and walks 512-row blocks in order. W in bf16 is
// 288 KiB, more than a CTA's 227 KB of shared memory, so a cluster of two
// CTAs shares it: CTA rank r holds W's output columns [r D/2, (r+1) D/2)
// (K x D/2, 147 KB at K = D = 384), loaded once by TMA and kept for the
// whole kernel. The pair is persistent over 128-row tiles (tile t goes to
// cluster t mod n_clusters). In each CTA:
//   - a producer thread streams the tile's K slices (64 columns of src,
//     path or tgt, 128 rows, 16 KB) by TMA into a ring of kStages stages,
//     one full and one empty mbarrier per stage; rows past N and columns
//     past an input's width read as zero (TMA bounds), so the tail needs no
//     padded copy and a slice that ends inside an input multiplies zeros;
//   - two consumer warpgroups own 64 rows each and all of the CTA's D/2
//     columns: acc (64 x D/2 fp32, 96 registers at D = 384) += slice .
//     W rows (wgmma m64n{D/2}k16, A K-major, W MN-major through the
//     descriptor's transpose), each stage released as soon as the next
//     slice's wgmma is in flight;
//   - the epilogue applies tanhf (not tanh.approx, ~2^-11 relative error)
//     in registers and writes x as fp32 straight from them; each row's
//     score is its two halves' partials: rank 1 stores its partial into
//     rank 0's shared memory (distributed shared memory) and arrives on
//     rank 0's mbarrier; rank 0 adds it to its own, rank 0's half first,
//     and writes the score. No atomics: the same result every run.
// x stays fp32 for the score, as in the TPU kernel.
// fp32: 32-row tiles on the CUDA cores (exact fp32 FMAs: the tensor cores
// have no exact-fp32 product; TF32 is off), K streamed in 16-wide chunks
// with W's matching rows, double buffered by cp.async.
//
// Bound at the plane wire's shape (N = 1024 x 200 = 204,800 rows, dt = dp =
// 128, D = 384), on an H100 SXM: bytes 204,800 x (384 x 2 B in + 384 x 4 B
// out) ~ 473 MB in bf16 -> ~0.14 ms at 3.35 TB/s; operations 2 x 204,800 x
// 384 x 384 ~ 60 GFLOP -> ~0.06 ms at 989 TFLOP/s. So bf16 is bound by the
// bytes, two thirds of them the fp32 x. fp32 (~0.63 GB, ~0.9 ms at 67
// TFLOP/s) is bound by the operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using c2v::bf16;
using c2v::kThreads;

constexpr int kWarpRows = 2;       // fp32 tile: warps along the rows

// fp32: rows per CTA and K columns per staged chunk
constexpr int kF32Rows = 32;
constexpr int kF32Bk = 16;

// Shared memory of one fp32 CTA: two stages of (A chunk: rows x BK, W
// chunk: BK x D), then attention (D floats) and the score partials.
template <int D>
struct Layout {
  static constexpr int kRows = kF32Rows;
  static constexpr int kBk = kF32Bk;
  static constexpr int kLda = kBk + c2v::Pad<float>::value;
  static constexpr int kLdb = D + c2v::Pad<float>::value;
  static constexpr int kA = kRows * kLda;
  static constexpr int kStage = kA + kBk * kLdb;
  static_assert((kA * sizeof(float)) % 16 == 0
                    && (kStage * sizeof(float)) % 16 == 0,
                "stage alignment");
  static size_t bytes() {
    return 2 * kStage * sizeof(float) + sizeof(float) * (D + 4 * kRows);
  }
};

// fp32 tile: thread (ty, tx) of 16 x 16 owns rows ty + 16 i and columns
// tx + 16 j, so a row's threads are the 16 lanes of one half-warp
template <int D>
__device__ __forceinline__ void row_scores(
    c2v::Tile<float, kF32Rows, D, kWarpRows>& tile, const float* attn_s,
    float* red, int rows, long long row0, float* __restrict__ scores) {
  using TileT = c2v::Tile<float, kF32Rows, D, kWarpRows>;
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

// One CTA per tile of 32 rows, fp32 inputs and weights.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) encode_f32_kernel(
    const float* __restrict__ src, const float* __restrict__ pth,
    const float* __restrict__ tgt,
    const float* __restrict__ w,       // (K, D) row-major
    const float* __restrict__ attn,    // (D,)
    long long n, int dt, int dp, float* __restrict__ x,
    float* __restrict__ scores) {
  using L = Layout<D>;
  constexpr int kRows = L::kRows;
  constexpr int kBk = L::kBk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);
  float* attn_s = stages + 2 * L::kStage;
  float* red = attn_s + D;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      n - row0 < kRows ? n - row0 : static_cast<long long>(kRows));
  for (int j = threadIdx.x; j < D; j += blockDim.x) attn_s[j] = attn[j];

  // chunk c: K columns [c BK, (c + 1) BK), inside one of src | pth | tgt
  const int n_chunks = (2 * dt + dp) / kBk;
  auto stage_chunk = [&](int c) {
    float* buf = stages + (c & 1) * L::kStage;
    const int k0 = c * kBk;
    const float* in = src;
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
    c2v::stage_rows_async<float, float>(in + row0 * ld + kk, ld, kRows, kBk,
                                        rows, buf, L::kLda);
    c2v::stage_rows_async<float, float>(w + static_cast<long long>(k0) * D,
                                        D, kBk, D, kBk, buf + L::kA,
                                        L::kLdb);
    c2v::cp_async_commit();
  };

  c2v::Tile<float, kRows, D, kWarpRows> tile;
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
    const float* buf = stages + (c & 1) * L::kStage;
    tile.template mma<true>(buf, L::kLda, buf + L::kA, L::kLdb, kBk);
    __syncthreads();
  }

  tile.each([&](int r, int col, float& v) {
    v = tanhf(v);
    if (r < rows) x[(row0 + r) * D + col] = v;
  });
  row_scores<D>(tile, attn_s, red, rows, row0, scores);
}

template <int D>
cudaError_t launch_f32(const void* src, const void* pth, const void* tgt,
                       const void* w, const void* attn, long long n, int dt,
                       int dp, float* x, float* scores, cudaStream_t s) {
  using L = Layout<D>;
  static size_t allowed = 48 * 1024;
  const size_t smem = L::bytes();
  c2v::allow_smem(encode_f32_kernel<D>, smem, allowed);
  const long long blocks = (n + L::kRows - 1) / L::kRows;
  encode_f32_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(pth),
      static_cast<const float*>(tgt), static_cast<const float*>(w),
      static_cast<const float*>(attn), n, dt, dp, x, scores);
  return cudaGetLastError();
}

// ----------------------------------------------------- bf16 (wgmma, TMA)
constexpr int kTile = 128;           // rows per tile: 64 per consumer
constexpr int kStages = 4;           // K slices in flight
constexpr int kMaxSlices = 6;        // K slices per tile: W's rows in smem
constexpr int kEncThreads = 384;     // producer + two consumer warpgroups
constexpr int kBox = 64 * 64;        // bf16 elements of a 64 x 64 W box

template <int D>
struct EncSmem {
  static constexpr int kCols = D / 2;           // W columns of this CTA
  // column box j (64 columns) holds every K slice's 64 W rows in turn
  bf16 w[kCols / 64][kMaxSlices * kBox];
  bf16 a[kStages][kTile * 64];                  // 128 rows x 64 K, swizzled
  float attn[kCols];
  float peer[2][kTile];          // rank 0: rank 1's score partials
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t w_full;
  uint64_t ready[2];             // rank 0: rank 1's partials stored
  uint64_t consumed[2];          // rank 1: rank 0 read them
};

template <int D>
constexpr size_t enc_smem_bytes() {
  return sizeof(EncSmem<D>) + 1024;   // room to align the base to 1024
}

// K slice q (64 columns): which input, its first column there, and its
// first row of W
struct Slice {
  int which, col0, w_row;
};

__device__ __forceinline__ Slice slice_of(int q, int dt, int dp) {
  const int cs = (dt + 63) / 64;
  const int cp = (dp + 63) / 64;
  Slice s;
  if (q < cs) {
    s.which = 0;
    s.col0 = 64 * q;
    s.w_row = s.col0;
  } else if (q < cs + cp) {
    s.which = 1;
    s.col0 = 64 * (q - cs);
    s.w_row = dt + s.col0;
  } else {
    s.which = 2;
    s.col0 = 64 * (q - cs - cp);
    s.w_row = dt + dp + s.col0;
  }
  return s;
}

struct EncMaps {
  CUtensorMap in[3];             // src (N, dt), pth (N, dp), tgt (N, dt)
  CUtensorMap w;                 // (K, D)
};

template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kEncThreads, 1)
    encode_bf16_kernel(const __grid_constant__ EncMaps maps,
                       const bf16* __restrict__ attn, long long n, int dt,
                       int dp, float* __restrict__ x,
                       float* __restrict__ scores) {
  constexpr int kCols = D / 2;
  constexpr int kColBoxes = kCols / 64;
  constexpr uint32_t kSliceBytes = kTile * 64 * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  EncSmem<D>& sm = *reinterpret_cast<EncSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t rank = hop::cluster_rank();
  const int n_slices = 2 * ((dt + 63) / 64) + (dp + 63) / 64;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const int col_base = static_cast<int>(rank) * kCols;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], 2);
    }
    hop::mbar_init(&sm.w_full, 1);
    for (int p = 0; p < 2; ++p) {
      hop::mbar_init(&sm.ready[p], 64);
      hop::mbar_init(&sm.consumed[p], 64);
    }
    hop::fence_barrier_init();
  }
  for (int c = threadIdx.x; c < kCols; c += blockDim.x) {
    sm.attn[c] = __bfloat162float(attn[col_base + c]);
  }
  // the peer's barriers are initialised before any remote arrive
  hop::cluster_sync();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    hop::set_max_regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) hop::prefetch_tmap(&maps.in[i]);
      hop::prefetch_tmap(&maps.w);
      hop::mbar_arrive_expect_tx(&sm.w_full,
                                 n_slices * kColBoxes * kBox * 2);
      for (int q = 0; q < n_slices; ++q) {
        const Slice sl = slice_of(q, dt, dp);
#pragma unroll
        for (int j = 0; j < kColBoxes; ++j) {
          hop::tma_load_2d(sm.w[j] + q * kBox, &maps.w, &sm.w_full,
                           col_base + 64 * j, sl.w_row);
        }
      }
      int g = 0;
      for (long long t = hop::cluster_id(); t < n_tiles;
           t += hop::n_clusters()) {
        for (int q = 0; q < n_slices; ++q, ++g) {
          const Slice sl = slice_of(q, dt, dp);
          const int st = g % kStages;
          hop::mbar_wait(&sm.empty[st], ((g / kStages) & 1) ^ 1);
          hop::mbar_arrive_expect_tx(&sm.full[st], kSliceBytes);
          hop::tma_load_2d(sm.a[st], &maps.in[sl.which], &sm.full[st],
                           sl.col0, static_cast<int>(t * kTile));
        }
      }
    }
    hop::cluster_sync();
  } else {
    // ----------------------------------------------------------- consumers
    hop::set_max_regs_inc<232>();
    const int cw = wg - 1;                    // rows [64 cw, 64 cw + 64)
    const int t = threadIdx.x & 127;
    const bool leader = t == 0;
    const bool quad_leader = (t & 3) == 0;
    const int row0 = 16 * (t >> 5) + ((t & 31) >> 2);   // and row0 + 8
    constexpr uint32_t kWStride = kMaxSlices * kBox * 2;  // column boxes
    float acc[kCols / 2];
    hop::mbar_wait(&sm.w_full, 0);
    int g = 0;
    int it = 0;
    for (long long tile = hop::cluster_id(); tile < n_tiles;
         tile += hop::n_clusters(), ++it) {
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) acc[j] = 0.f;
      int prev = -1;
      for (int q = 0; q < n_slices; ++q, ++g) {
        const int st = g % kStages;
        hop::mbar_wait(&sm.full[st], (g / kStages) & 1);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.a[st])
                  + cw * 64 * 128 + kk * 32,
              16, 1024);
          const uint64_t db = hop::desc_sw128(
              reinterpret_cast<const unsigned char*>(sm.w[0] + q * kBox)
                  + kk * 2048,
              kWStride, 1024);
          hop::wgmma<kCols, 1>(acc, da, db);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();           // the previous slice's products
        if (prev >= 0 && leader) hop::mbar_arrive(&sm.empty[prev]);
        prev = st;
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (leader) hop::mbar_arrive(&sm.empty[prev]);

      // epilogue: x = tanh(acc), fp32, and this half's score partials
      const long long tile_row = tile * kTile + 64 * cw;
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int c = 8 * j + 2 * (t & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = tanhf(acc[4 * j + 2 * h]);
          const float v1 = tanhf(acc[4 * j + 2 * h + 1]);
          part[h] = fmaf(v0, sm.attn[c], part[h]);
          part[h] = fmaf(v1, sm.attn[c + 1], part[h]);
          const long long row = tile_row + row0 + 8 * h;
          if (row < n) {
            *reinterpret_cast<float2*>(x + row * D + col_base + c) =
                make_float2(v0, v1);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      }
      const int p = it & 1;
      if (quad_leader) {
        const int r = 64 * cw + row0;           // rows r and r + 8 of tile
        if (rank == 1) {
          // rank 0 has read what this buffer held two tiles ago
          hop::mbar_wait_cluster(&sm.consumed[p], ((it >> 1) & 1) ^ 1);
          hop::st_cluster(hop::mapa(&sm.peer[p][r], 0), part[0]);
          hop::st_cluster(hop::mapa(&sm.peer[p][r + 8], 0), part[1]);
          hop::mbar_arrive_cluster(hop::mapa(&sm.ready[p], 0));
        } else {
          hop::mbar_wait_cluster(&sm.ready[p], (it >> 1) & 1);
          const float s0 = part[0] + sm.peer[p][r];
          const float s1 = part[1] + sm.peer[p][r + 8];
          hop::mbar_arrive_cluster(hop::mapa(&sm.consumed[p], 1));
          const long long row = tile * kTile + r;
          if (row < n) scores[row] = s0;
          if (row + 8 < n) scores[row + 8] = s1;
        }
      }
    }
    hop::cluster_sync();
  }
}

// clusters that fit on the card at once, read once per instantiation
template <int D>
int max_clusters() {
  static int found = 0;
  if (found == 0) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(2 * hop::sm_count(), 1, 1);
    config.blockDim = dim3(kEncThreads, 1, 1);
    config.dynamicSmemBytes = enc_smem_bytes<D>();
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.attrs = &attr;
    config.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, encode_bf16_kernel<D>, &config)
            != cudaSuccess
        || n <= 0) {
      n = hop::sm_count() / 2;
    }
    found = n;
  }
  return found;
}

template <int D>
cudaError_t launch_bf16(const void* src, const void* pth, const void* tgt,
                        const void* w, const void* attn, long long n, int dt,
                        int dp, float* x, float* scores, cudaStream_t s) {
  const int n_slices = 2 * ((dt + 63) / 64) + (dp + 63) / 64;
  if (n_slices > kMaxSlices || dt % 8 || dp % 8) return cudaErrorInvalidValue;
  EncMaps maps;
  const void* ins[3] = {src, pth, tgt};
  const int widths[3] = {dt, dp, dt};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(ins[i]) & 15) {
      return cudaErrorMisalignedAddress;
    }
    cudaError_t err = hop::encode_tmap_2d(&maps.in[i], ins[i], n, widths[i],
                                          widths[i] * 2, kTile);
    if (err != cudaSuccess) return err;
  }
  if (reinterpret_cast<uintptr_t>(w) & 15) return cudaErrorMisalignedAddress;
  cudaError_t err = hop::encode_tmap_2d(&maps.w, w, 2 * dt + dp, D, D * 2,
                                        64);
  if (err != cudaSuccess) return err;
  static size_t allowed = 48 * 1024;
  const size_t smem = enc_smem_bytes<D>();
  c2v::allow_smem(encode_bf16_kernel<D>, smem, allowed);
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long clusters =
      n_tiles < max_clusters<D>() ? n_tiles : max_clusters<D>();
  encode_bf16_kernel<D><<<static_cast<unsigned>(2 * clusters), kEncThreads,
                          smem, s>>>(maps, static_cast<const bf16*>(attn), n,
                                     dt, dp, x, scores);
  return cudaGetLastError();
}

cudaError_t launch_d(bool bf16_in, int d_code, const void* src,
                     const void* pth, const void* tgt, const void* w,
                     const void* attn, long long n, int dt, int dp, float* x,
                     float* scores, cudaStream_t s) {
  switch (d_code) {
    case 128:
      return bf16_in ? launch_bf16<128>(src, pth, tgt, w, attn, n, dt, dp, x,
                                        scores, s)
                     : launch_f32<128>(src, pth, tgt, w, attn, n, dt, dp, x,
                                       scores, s);
    case 256:
      return bf16_in ? launch_bf16<256>(src, pth, tgt, w, attn, n, dt, dp, x,
                                        scores, s)
                     : launch_f32<256>(src, pth, tgt, w, attn, n, dt, dp, x,
                                       scores, s);
    case 384:
      return bf16_in ? launch_bf16<384>(src, pth, tgt, w, attn, n, dt, dp, x,
                                        scores, s)
                     : launch_f32<384>(src, pth, tgt, w, attn, n, dt, dp, x,
                                       scores, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype_code 0: float32 inputs and weights; 1: bfloat16. src, tgt (n, dt),
// pth (n, dp), w (2 dt + dp, d_code), attn (d_code,), all contiguous; x
// (n, d_code) and scores (n,) float32. The caller checks the shapes (dt,
// dp multiples of 32, at most six 64-wide K slices in bf16; d_code 128,
// 256 or 384) and, in bf16, the 16-byte alignment of every input (TMA).
// Returns cudaGetLastError() after the launch (0 = launched).
int encode_fwd(int dtype_code, const void* src, const void* pth,
               const void* tgt, const void* w, const void* attn, long long n,
               int dt, int dp, int d_code, float* x, float* scores,
               void* stream) {
  if (n <= 0) return 0;
  if (dt % 32 || dp % 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code != 0 && dtype_code != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_d(dtype_code == 1, d_code, src, pth, tgt, w,
                                   attn, n, dt, dp, x, scores, s));
}

const char* encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
