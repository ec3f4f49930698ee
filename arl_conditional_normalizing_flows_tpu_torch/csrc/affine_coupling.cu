// Affine coupling law kernels for Hopper (sm_90a), bound with ctypes.
//
// Replace the Pallas TPU kernels of
// arl_conditional_normalizing_flows_tpu/ops/pallas/affine_coupling.py:
//   affine_forward: _fwd_kernel / _fwd_pallas_2d  v2 = exp(a)*u2 + b,
//                   ld[row] = sum(a[row, :]) in float32
//   affine_inverse: _inv_kernel / fused_affine_inverse  u2 = exp(-a)*(v2 - b)
//
// Inputs are row-major (rows, n) in float32 or bfloat16; the law is computed
// in float32 and rounded once to the input type; the log-det is float32.
//
// Bound: device memory. Each element is read three times and written once
// (5 or 4 values a row's element against ~4 operations), so what a launch
// can save is memory round trips. The design gives each element one:
//   - every access is 16 bytes (4 float32 or 8 bfloat16 values), and a
//     thread issues all of its loads before the arithmetic that uses them;
//   - affine_forward gives one block to a row, sized so that one vector per
//     thread covers it (n = 784 float32: 196 vectors, 224 threads), so the
//     row's three inputs are in flight at once and no loop is left; the
//     log-det is summed in the same pass (a warp shuffle, then one step
//     through shared memory). The TPU kernel carried the log-det across a
//     sequential feature-grid axis and zero-padded n to full tiles; here the
//     block owns its row and masks the ragged end itself. At the flagship's
//     128 rows one block a row already covers the card's 132 SMs;
//   - affine_inverse is elementwise over rows * n: a grid of at most one
//     wave (what the card holds at once), each thread owning one vector, or
//     a few, one an iteration, where the tensor is larger than a wave.
// Rows wider than 1024 vectors loop in blocks of 1024 threads, one vector a
// thread an iteration.
//
// The 16-byte path needs every pointer 16-byte aligned and, for the forward
// (whose rows must start on a vector), n a whole number of vectors. The C
// entries check both; what fails takes the scalar path (one value an
// access), so a misaligned view never reaches a vector load. The inverse's
// last rows * n % 4 (or 8) values go through the scalar tail.
//
// Every entry point launches on the given stream, does not synchronise and
// returns cudaGetLastError() so that the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kInverseThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Values [i * V, i * V + V) of p as float32: one 16-byte load when V > 1
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* __restrict__ p, int64_t i, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f(p[i]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte access");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = to_f(e[k]);
  }
}

// in[0..V) rounded to T into [i * V, i * V + V) of p: one 16-byte store when V > 1
template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, int64_t i, const float (&in)[V]) {
  if constexpr (V == 1) {
    p[i] = from_f<T>(in[0]);
  } else {
    alignas(16) T e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<T>(in[k]);
    reinterpret_cast<uint4*>(p)[i] = *reinterpret_cast<const uint4*>(e);
  }
}

// One block a row of n = nv * V values, one vector a thread an iteration
// (one iteration where nv <= blockDim.x, as at the flagship's rows).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
affine_forward_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ u2, T* __restrict__ v2,
                      float* __restrict__ ld, int64_t nv) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * nv;  // in accesses of V values
  float acc = 0.f;
  for (int64_t j = threadIdx.x; j < nv; j += blockDim.x) {
    float av[V], bv[V], uv[V], out[V];
    load_v<T, V>(a, row + j, av);
    load_v<T, V>(u2, row + j, uv);
    load_v<T, V>(b, row + j, bv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      out[e] = expf(av[e]) * uv[e] + bv[e];
      acc += av[e];
    }
    store_v<T, V>(v2, row + j, out);
  }
  // row sum: shuffle within each warp, then the warps' sums through shared
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sum[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) ld[blockIdx.x] = acc;
  }
}

// Elementwise over total = nv * V + tail values, one vector a thread an
// iteration (one iteration where the grid gives every vector a thread).
template <typename T, int V>
__global__ void __launch_bounds__(kInverseThreads)
affine_inverse_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ v2, T* __restrict__ u2, int64_t nv,
                      int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < nv; i += stride) {
    float av[V], bv[V], vv[V], out[V];
    load_v<T, V>(a, i, av);
    load_v<T, V>(v2, i, vv);
    load_v<T, V>(b, i, bv);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = expf(-av[e]) * (vv[e] - bv[e]);
    store_v<T, V>(u2, i, out);
  }
  if constexpr (V > 1) {  // the scalar tail, fewer than V values
    const int64_t i = nv * V + first;
    if (i < total) u2[i] = from_f<T>(expf(-to_f(a[i])) * (to_f(v2[i]) - to_f(b[i])));
  }
}

bool aligned16(const void* p0, const void* p1, const void* p2, const void* p3) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1) |
                         reinterpret_cast<uintptr_t>(p2) | reinterpret_cast<uintptr_t>(p3);
  return (bits & 15u) == 0;
}

template <typename T, int V>
void launch_forward_v(const void* a, const void* b, const void* u2, void* v2, void* ld,
                      int rows, int n, cudaStream_t stream) {
  const int64_t nv = n / V;
  const int64_t whole_warps = (nv + 31) / 32 * 32;  // one vector a thread, or a loop past 1024
  const int threads = static_cast<int>(whole_warps < kMaxThreads ? whole_warps : kMaxThreads);
  affine_forward_kernel<T, V><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(u2),
      static_cast<T*>(v2), static_cast<float*>(ld), nv);
}

template <typename T>
void launch_forward(const void* a, const void* b, const void* u2, void* v2, void* ld,
                    int rows, int n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && aligned16(a, b, u2, v2)) {
    launch_forward_v<T, V>(a, b, u2, v2, ld, rows, n, stream);
  } else {
    launch_forward_v<T, 1>(a, b, u2, v2, ld, rows, n, stream);
  }
}

// Blocks of kInverseThreads that the card holds at once (its SMs times the
// blocks one SM holds), queried at the first call. The grid-stride loop
// covers any size, so this value only sizes the grid.
template <typename T, int V>
int64_t inverse_wave() {
  static const int64_t wave = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, affine_inverse_kernel<T, V>,
                                                  kInverseThreads, 0);
    return static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  return wave;
}

template <typename T, int V>
void launch_inverse_v(const void* a, const void* b, const void* v2, void* u2,
                      int64_t total, cudaStream_t stream) {
  const int64_t nv = total / V;
  const int64_t needed = (nv + kInverseThreads - 1) / kInverseThreads;
  const int64_t wave = inverse_wave<T, V>();
  const int64_t blocks = needed < 1 ? 1 : (needed < wave ? needed : wave);  // 1: the tail alone
  affine_inverse_kernel<T, V><<<static_cast<int>(blocks), kInverseThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(v2),
      static_cast<T*>(u2), nv, total);
}

template <typename T>
void launch_inverse(const void* a, const void* b, const void* v2, void* u2, int64_t total,
                    cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (aligned16(a, b, v2, u2)) {
    launch_inverse_v<T, V>(a, b, v2, u2, total, stream);
  } else {
    launch_inverse_v<T, 1>(a, b, v2, u2, total, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ld is always float32 (rows,).
extern "C" int affine_forward(const void* a, const void* b, const void* u2, void* v2,
                              void* ld, int rows, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    launch_forward<float>(a, b, u2, v2, ld, rows, n, s);
  } else if (dtype == 1) {
    launch_forward<__nv_bfloat16>(a, b, u2, v2, ld, rows, n, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int affine_inverse(const void* a, const void* b, const void* v2, void* u2,
                              int rows, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(rows) * n;
  if (dtype == 0) {
    launch_inverse<float>(a, b, v2, u2, total, s);
  } else if (dtype == 1) {
    launch_inverse<__nv_bfloat16>(a, b, v2, u2, total, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
