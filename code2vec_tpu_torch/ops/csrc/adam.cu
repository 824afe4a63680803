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
// adam_rows: lazy Adam's row update. rows (n,) is the touched-row list,
// sorted; one warp per entry, and an entry whose row equals its
// predecessor's does nothing, so each touched row is updated exactly once,
// from its old values (in place, a duplicate would read a row another warp
// has already written). The update is lazy Adam's own (fp32 throughout):
//   m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) (g g)
//   p = p - (lr_t m) / (sqrt(v) + eps)
// Untouched rows are not read or written. Bound: the bytes of the touched
// rows (p, g, m, v read, p, m, v written: 28 bytes an element) plus the row
// list; the lanes of a warp read a row's consecutive elements.

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

// One warp per entry of the sorted row list; lanes stride over the row.
__global__ void __launch_bounds__(256) adam_rows_kernel(
    float* __restrict__ table, float* __restrict__ mu, float* __restrict__ nu,
    const float* __restrict__ grad, const long long* __restrict__ rows,
    long long n_rows, long long n, int d, float b1, float omb1, float b2,
    float omb2, float lr_t, float eps) {
  const long long entry =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (entry >= n) return;
  const long long r = rows[entry];
  if (r < 0 || r >= n_rows) return;
  if (entry > 0 && rows[entry - 1] == r) return;
  const long long base = r * d;
  for (int c = lane; c < d; c += 32) {
    const long long i = base + c;
    const float g = grad[i];
    const float m = __fadd_rn(__fmul_rn(b1, mu[i]), __fmul_rn(omb1, g));
    const float v =
        __fadd_rn(__fmul_rn(b2, nu[i]), __fmul_rn(omb2, __fmul_rn(g, g)));
    const float step_ = __fdiv_rn(__fmul_rn(lr_t, m),
                                  __fadd_rn(__fsqrt_rn(v), eps));
    table[i] = __fsub_rn(table[i], step_);
    mu[i] = m;
    nu[i] = v;
  }
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

// Lazy Adam's row update in place: table, mu, nu and grad (n_rows, d)
// float32, contiguous; rows (n,) int64, sorted ascending (entries outside
// [0, n_rows) are skipped). Returns cudaGetLastError() after the launch.
int adam_rows(float* table, float* mu, float* nu, const float* grad,
              const long long* rows, long long n_rows, long long n, int d,
              float b1, float omb1, float b2, float omb2, float lr_t,
              float eps, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long threads = n * 32;
  const long long blocks = (threads + 255) / 256;
  adam_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, mu, nu, grad, rows, n_rows, n, d, b1, omb1, b2, omb2, lr_t, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
