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
// The TPU kernel carries the log-det across a sequential feature-grid axis
// and zero-pads n to full tiles; here one block owns one row (rows <= the
// card's 132 SMs at the flagship batch of 128), loops over it and masks the
// ragged end itself, so no padding is needed. Both kernels are bound by
// device memory (5 or 4 values moved per element against ~4 operations).
//
// Every entry point launches on the given stream, does not synchronise and
// returns cudaGetLastError() so that the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
affine_forward_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ u2, T* __restrict__ v2,
                      float* __restrict__ ld, int n) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  float acc = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float av = load_f(a, base + j);
    store_f(v2, base + j, expf(av) * load_f(u2, base + j) + load_f(b, base + j));
    acc += av;
  }
  // row sum: shuffle within each warp, then the warps' sums through shared
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sum[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) ld[blockIdx.x] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
affine_inverse_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ v2, T* __restrict__ u2, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    store_f(u2, i, expf(-load_f(a, i)) * (load_f(v2, i) - load_f(b, i)));
  }
}

template <typename T>
void launch_forward(const void* a, const void* b, const void* u2, void* v2, void* ld,
                    int rows, int n, cudaStream_t stream) {
  affine_forward_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(u2),
      static_cast<T*>(v2), static_cast<float*>(ld), n);
}

template <typename T>
void launch_inverse(const void* a, const void* b, const void* v2, void* u2,
                    int64_t total, cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  affine_inverse_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(v2),
      static_cast<T*>(u2), total);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ld is always float32 (rows,).
extern "C" int affine_forward(const void* a, const void* b, const void* u2, void* v2,
                              void* ld, int rows, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
