// Adam's parameter updates, written by hand for Hopper (sm_90a). No Pallas
// kernel of the JAX package stands behind them: there XLA fuses optax's
// elementwise update (code2vec_tpu/training/adam_dtypes.py:62-91) into one
// streaming pass per parameter, and lazy Adam's gathered-row update
// (code2vec_tpu/ops/lazy_adam.py:48-78) into a gather and a scatter.
//
// adam_update: the dense pass, in place, in the order of the JAX package's
// expression, one rounding per operation (round-to-nearest intrinsics, so
// nvcc contracts nothing into an FMA):
//   m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) (g g)
//   u = (m / b1c) / (sqrt(v / b2c) + eps),  p = p + (-lr) u
// with g upcast from fp32 or bf16, the moments read from and stored to fp32
// or bf16 (round to nearest even), p fp32, every scalar float32. The plain
// version (ops/adam.py::adam_update_plain) runs the same operations through
// torch's elementwise kernels, so the two agree bit for bit.
// Bound: purely by the bytes. Each element is read once (p, g, m, v) and
// written once (p, m, v): 20 bytes an element with bf16 moments and fp32
// gradients, 18 with bf16 gradients, 28 with fp32 moments; java14m's
// 384,041,344 parameters move 7.68 GB -> 2.29 ms at 3.35 TB/s. So the
// design is a plain stream: each thread takes chunks of 8 elements with
// 16-byte loads and stores (two per fp32 stream, one per bf16 stream), a
// grid-stride loop over a grid sized to the SMs, and a scalar prologue
// (until every stream is 16-byte aligned together) and tail; a launch whose
// streams can never align together runs scalar throughout.
//
// adam_rows: lazy Adam's row update over a uint8 mask `touched` of the
// table's rows (not 0: update the row). From a row list, adam_rows_mark
// sets the mask first (a memset, then a thread an entry; an entry outside
// [0, n_rows) sets nothing, a repeated one the same byte), so each touched
// row is updated exactly once, from its old values, with no sort. The
// update is lazy Adam's own (fp32 throughout):
//   m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) (g g)
//   p = p - (lr_t m) / (sqrt(v) + eps)
// Untouched rows are not read or written. Bound: the bytes of the touched
// rows (p, g, m, v read, p, m, v written: 28 bytes an element) plus the
// mask (or the row list). adam_rows_kernel spends no warp on an untouched
// or repeated row: a warp reads the flags of 32 consecutive rows (a byte a
// lane, the next group's read ahead), ballots them and updates the flagged
// rows kRowsInFlight at a time, each lane's 16-byte loads of p, g, m and v
// of all of them issued before the arithmetic and the stores (a 128-wide
// row is one float4 a lane); grid-stride over the table's 32-row groups.
// Rows whose width is not a multiple of 4, or tensors off a 16-byte
// boundary, take the same walk one float a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Scalars {
  float b1, omb1, b2, omb2, b1c, b2c, eps, neg_lr;
};

__device__ __forceinline__ void step(const Scalars& s, float& p, float g,
                                     float& m, float& v) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float u = __fdiv_rn(__fdiv_rn(m, s.b1c),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), s.eps));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// eight consecutive elements, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename G, typename M, typename V>
__device__ __forceinline__ void step1(const Scalars& s, float* p, const G* g,
                                      M* mu, V* nu, long long i) {
  float pv = p[i], m = load1(mu + i), v = load1(nu + i);
  step(s, pv, load1(g + i), m, v);
  p[i] = pv;
  store1(mu + i, m);
  store1(nu + i, v);
}

// Elements [0, head) and [head + 8 n_vec, n) one at a time; the n_vec
// chunks of 8 from `head` by 16-byte vectors (n_vec = 0: all scalar).
template <typename G, typename M, typename V>
__global__ void __launch_bounds__(256) adam_update_kernel(
    float* __restrict__ p, const G* __restrict__ g, M* __restrict__ mu,
    V* __restrict__ nu, long long n, long long head, long long n_vec,
    Scalars s) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = tid; c < n_vec; c += stride) {
    const long long i = head + 8 * c;
    float pv[8], gv[8], m[8], v[8];
    load8(p + i, pv);
    load8(g + i, gv);
    load8(mu + i, m);
    load8(nu + i, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) step(s, pv[k], gv[k], m[k], v[k]);
    store8(p + i, pv);
    store8(mu + i, m);
    store8(nu + i, v);
  }
  const long long tail0 = head + 8 * n_vec;
  const long long n_scalar = head + (n - tail0);
  for (long long q = tid; q < n_scalar; q += stride) {
    step1(s, p, g, mu, nu, q < head ? q : tail0 + (q - head));
  }
}

// The first index from which every stream is 16-byte aligned (element
// index i is aligned when (address / size + i) % (16 / size) == 0), or -1
// when no index in [0, 8) serves them all.
long long common_head(const void* const* ptrs, const int* sizes, int count) {
  for (int head = 0; head < 8; ++head) {
    bool ok = true;
    for (int k = 0; k < count && ok; ++k) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(ptrs[k]);
      const int per = 16 / sizes[k];
      ok = a % sizes[k] == 0 && ((a / sizes[k]) + head) % per == 0;
    }
    if (ok) return head;
  }
  return -1;
}

template <typename G, typename M, typename V>
cudaError_t launch_update(void* p, const void* g, void* mu, void* nu,
                          long long n, const Scalars& s, int n_blocks,
                          cudaStream_t stream) {
  const void* ptrs[4] = {p, g, mu, nu};
  const int sizes[4] = {4, static_cast<int>(sizeof(G)),
                        static_cast<int>(sizeof(M)),
                        static_cast<int>(sizeof(V))};
  long long head = common_head(ptrs, sizes, 4);
  long long n_vec = 0;
  if (head < 0 || head >= n) {
    head = n;                 // all scalar
  } else {
    n_vec = (n - head) / 8;
  }
  const long long work = n_vec > 0 ? n_vec : n;
  const long long need = (work + 255) / 256;
  const int blocks = static_cast<int>(need < n_blocks ? need : n_blocks);
  adam_update_kernel<G, M, V><<<blocks > 0 ? blocks : 1, 256, 0, stream>>>(
      static_cast<float*>(p), static_cast<const G*>(g), static_cast<M*>(mu),
      static_cast<V*>(nu), n, head, n_vec, s);
  return cudaGetLastError();
}

template <typename G, typename M>
cudaError_t dispatch_nu(int nu_code, void* p, const void* g, void* mu,
                        void* nu, long long n, const Scalars& s, int n_blocks,
                        cudaStream_t stream) {
  if (nu_code == 0) {
    return launch_update<G, M, float>(p, g, mu, nu, n, s, n_blocks, stream);
  }
  if (nu_code == 1) {
    return launch_update<G, M, bf16>(p, g, mu, nu, n, s, n_blocks, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename G>
cudaError_t dispatch_mu(int mu_code, int nu_code, void* p, const void* g,
                        void* mu, void* nu, long long n, const Scalars& s,
                        int n_blocks, cudaStream_t stream) {
  if (mu_code == 0) {
    return dispatch_nu<G, float>(nu_code, p, g, mu, nu, n, s, n_blocks,
                                 stream);
  }
  if (mu_code == 1) {
    return dispatch_nu<G, bf16>(nu_code, p, g, mu, nu, n, s, n_blocks,
                                stream);
  }
  return cudaErrorInvalidValue;
}

struct RowScalars {
  float b1, omb1, b2, omb2, lr_t, eps;
};

constexpr int kRowsInFlight = 4;     // rows a warp loads before it stores
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void row_step(const RowScalars& s, float& p,
                                         float g, float& m, float& v) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr_t, m),
                             __fadd_rn(__fsqrt_rn(v), s.eps)));
}
__device__ __forceinline__ void row_step(const RowScalars& s, float4& p,
                                         float4 g, float4& m, float4& v) {
  row_step(s, p.x, g.x, m.x, v.x);
  row_step(s, p.y, g.y, m.y, v.y);
  row_step(s, p.z, g.z, m.z, v.z);
  row_step(s, p.w, g.w, m.w, v.w);
}

// Sets touched[r] = 1 for each entry r of rows inside [0, n_rows).
__global__ void __launch_bounds__(256) adam_rows_mark_kernel(
    const long long* __restrict__ rows, long long n, long long n_rows,
    uint8_t* __restrict__ touched) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += stride) {
    const long long r = rows[i];
    if (r >= 0 && r < n_rows) touched[r] = 1;
  }
}

// A warp per group of 32 rows (grid-stride), its flagged rows
// kRowsInFlight at a time; V float4 (d a multiple of 4, every tensor
// 16-byte aligned) or float.
template <typename V>
__global__ void __launch_bounds__(256) adam_rows_kernel(
    float* __restrict__ table, float* __restrict__ mu, float* __restrict__ nu,
    const float* __restrict__ grad, const uint8_t* __restrict__ touched,
    long long n_rows, int d, RowScalars s) {
  const int lane = threadIdx.x & 31;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const long long n_groups = (n_rows + 31) >> 5;
  const int dv = d / static_cast<int>(sizeof(V) / sizeof(float));
  V* pv = reinterpret_cast<V*>(table);
  V* mv = reinterpret_cast<V*>(mu);
  V* vv = reinterpret_cast<V*>(nu);
  const V* gv = reinterpret_cast<const V*>(grad);
  long long grp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  auto flag_of = [&](long long gr) {
    const long long r = (gr << 5) + lane;
    return gr < n_groups && r < n_rows && touched[r] != 0;
  };
  bool flag = flag_of(grp);
  for (; grp < n_groups; grp += n_warps) {
    unsigned mask = __ballot_sync(kFull, flag);
    flag = flag_of(grp + n_warps);     // the next group's, read ahead
    while (mask != 0) {
      long long row[kRowsInFlight];
      int n = 0;
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        row[i] = 0;
        if (mask != 0) {
          row[i] = (grp << 5) + __ffs(mask) - 1;
          mask &= mask - 1;
          n = i + 1;
        }
      }
      for (int c = lane; c < dv; c += 32) {
        V p[kRowsInFlight], g[kRowsInFlight], m[kRowsInFlight],
            v[kRowsInFlight];
#pragma unroll
        for (int i = 0; i < kRowsInFlight; ++i) {
          if (i < n) {
            const long long o = row[i] * dv + c;
            p[i] = pv[o];
            g[i] = gv[o];
            m[i] = mv[o];
            v[i] = vv[o];
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsInFlight; ++i) {
          if (i < n) {
            const long long o = row[i] * dv + c;
            row_step(s, p[i], g[i], m[i], v[i]);
            pv[o] = p[i];
            mv[o] = m[i];
            vv[o] = v[i];
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Dense Adam in place over n elements: p float32; g, mu, nu float32
// (code 0) or bfloat16 (code 1); any storage offset (the kernel aligns its
// vectors itself). Scalars as the header says, each float32: b1, 1 - b1,
// b2, 1 - b2, the bias corrections b1c, b2c, eps and -lr. n_blocks caps
// the grid (the caller sizes it to the SMs). Returns cudaGetLastError()
// after the launch (0 = launched).
int adam_update(int g_code, int mu_code, int nu_code, void* p, const void* g,
                void* mu, void* nu, long long n, float b1, float omb1,
                float b2, float omb2, float b1c, float b2c, float eps,
                float neg_lr, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  const Scalars s{b1, omb1, b2, omb2, b1c, b2c, eps, neg_lr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (g_code == 0) {
    err = dispatch_mu<float>(mu_code, nu_code, p, g, mu, nu, n, s, n_blocks,
                             st);
  } else if (g_code == 1) {
    err = dispatch_mu<bf16>(mu_code, nu_code, p, g, mu, nu, n, s, n_blocks,
                            st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Lazy Adam's row list as a mask: touched (n_rows,) uint8 zeroed, then 1
// at each entry of rows (n,) int64 inside [0, n_rows) (adam_rows_mark_kernel
// on at most n_blocks blocks). Returns cudaGetLastError() after the
// launches (0 = launched).
int adam_rows_mark(const long long* rows, long long n, uint8_t* touched,
                   long long n_rows, int n_blocks, void* stream) {
  if (n_rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(touched, 0, n_rows, st);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const long long need = (n + 255) / 256;
  adam_rows_mark_kernel<<<static_cast<unsigned>(need < n_blocks ? need
                                                                : n_blocks),
                          256, 0, st>>>(rows, n, n_rows, touched);
  return static_cast<int>(cudaGetLastError());
}

// Lazy Adam's row update in place: table, mu, nu and grad (n_rows, d)
// float32, contiguous; every row whose byte of touched (n_rows,) is not 0
// (adam_rows_kernel on at most n_blocks blocks). Returns cudaGetLastError()
// after the launch.
int adam_rows(float* table, float* mu, float* nu, const float* grad,
              const uint8_t* touched, long long n_rows, int d, float b1,
              float omb1, float b2, float omb2, float lr_t, float eps,
              int n_blocks, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const RowScalars s{b1, omb1, b2, omb2, lr_t, eps};
  const long long need = ((n_rows + 31) / 32 + 7) / 8;   // 8 warps a block
  const unsigned blocks =
      static_cast<unsigned>(need < n_blocks ? need : n_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(table) && aligned16(mu) && aligned16(nu)
      && aligned16(grad)) {
    adam_rows_kernel<float4><<<blocks, 256, 0, st>>>(
        table, mu, nu, grad, touched, n_rows, d, s);
  } else {
    adam_rows_kernel<float><<<blocks, 256, 0, st>>>(
        table, mu, nu, grad, touched, n_rows, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
