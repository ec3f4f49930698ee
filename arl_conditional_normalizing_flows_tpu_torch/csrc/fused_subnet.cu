// A coupling subnet's whole conv chain as one Hopper (sm_90a) kernel, bound
// with ctypes.
//
// Replaces the Pallas TPU kernel of
// arl_conditional_normalizing_flows_tpu/ops/pallas/fused_subnet.py:
// _build_pallas_fn (body subnet_math), reached by subnet_apply_pallas. For x
// (B, h, w, cin) float32, NHWC:
//
//   y = conv_k(x->dt, entry_w) + entry_b                       f32 trunk
//   repeat res_blocks:
//     t = lrelu(conv_1x1(lrelu(y)->dt, pre_w) + pre_b) -> dt
//     u = sum_d conv_1x1(lrelu(gconv_k,dil_d(t[..., :w_d], bw_d) + bb_d) -> dt,
//                        post_w[rows of branch d])
//     y = y + u + post_b
//   out = conv_k(lrelu(y)->dt, head_w) + head_b                f32
//
// lrelu has slope 0.3; dt (float32 or bfloat16) is the type of every product's
// operands, every sum is float32, biases are float32. SAME padding is
// dil*(k-1) in total, total/2 low and the rest high (asymmetric for even k).
// Branch d (width w_d = K/dil_d) reads the first w_d trunk channels in
// `card` groups of g_d = w_d/card: output j reads inputs [j/g_d*g_d, +g_d).
//
// Design. One block per sample: the chain is sequential within a sample and
// independent across samples, so block barriers are all the ordering it
// needs (128 samples fill 128 of the card's 132 SMs). The stage input t lives
// in dynamic shared memory in dt (at most 28*28*64*2 = 98 KB at the flagship);
// the f32 trunk y does not fit beside it and lives in a scratch tensor the
// caller allocates (B*h*w*K floats, 25.7 MB at the largest flagship spec,
// held by the 50 MB L2). The grouped convs are computed grouped, not expanded
// block-diagonally as the TPU kernel does (4x the work at the flagship). Each
// branch output is rounded to dt and multiplied into the post-1x1 pixel tile
// by tile, so no branch output is concatenated or written to device memory.
//
// Bound: operations. At the flagship a pass needs 50.4 GFLOP of grouped
// products (51 us on the tensor cores at 989 TFLOP/s) against ~1.3 MB of
// inputs and outputs per launch. This first kernel runs the products as
// float32 FMAs on CUDA cores (67 TFLOP/s), each thread computing kRows pixels
// of one output channel so that each weight it loads serves kRows products;
// wgmma, TMA and clusters are left to the PR that makes it fast.
//
// Barriers: every __syncthreads() is at the top level of the kernel or inside
// loops whose trip counts (res_blocks, pixel tiles) are the same for every
// thread of the block. The entry point returns cudaGetLastError(), and
// cudaErrorInvalidValue for sizes it does not take, without launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Mirrored in ops/kernels/fused_subnet.py (a CPU test compares them).
constexpr int kThreads = 512;
constexpr int kTile = 32;  // pixels per tile of the 1x1 stages
constexpr int kRows = 4;   // pixels per thread in the tiled stages
constexpr int kMaxBranches = 4;
constexpr int kMaxShared = 232448;  // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr float kSlope = 0.3f;
static_assert(kTile % kRows == 0, "a tile holds whole row groups");

struct Dims {
  int h, w, cin, K, res_blocks, card, ksize, nd, out_total;
  int dil[kMaxBranches];
};

// Offsets, in elements, of each weight and bias in the packed buffers. The
// order is flax_param_order's: kernels in one dt buffer, biases in one f32
// buffer, entry, then each residual block, then the head.
struct Layout {
  int sum_w;
  int width[kMaxBranches], group[kMaxBranches], col[kMaxBranches];
  int w_block0, w_block, w_branch[kMaxBranches], w_post, w_head;
  int b_block0, b_block, b_branch[kMaxBranches], b_post, b_head;
  int act_elems, act_bytes, stage_bytes;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : kSlope * v; }

// SAME k x k conv at dilation 1 over act (h*w pixels of cs channels, dt) into
// dst (h*w pixels of cout channels, f32), plus bias. No barrier inside.
template <typename T>
__device__ void conv_same(const Dims& d, const T* act, int cs, const T* __restrict__ wt,
                          const float* __restrict__ bias, int cout, float* dst) {
  const int hw = d.h * d.w, k = d.ksize, lo = (k - 1) / 2;
  for (int e = threadIdx.x; e < hw * cout; e += kThreads) {
    const int p = e / cout, co = e - p * cout;
    const int py = p / d.w, px = p - py * d.w;
    float acc = 0.f;
    for (int ty = 0; ty < k; ++ty) {
      const int iy = py + ty - lo;
      if (iy < 0 || iy >= d.h) continue;
      for (int tx = 0; tx < k; ++tx) {
        const int ix = px + tx - lo;
        if (ix < 0 || ix >= d.w) continue;
        const T* a = act + (iy * d.w + ix) * cs;
        const T* wtap = wt + (ty * k + tx) * cs * cout + co;
        for (int ci = 0; ci < cs; ++ci) acc = fmaf(to_f(a[ci]), to_f(wtap[ci * cout]), acc);
      }
    }
    dst[e] = acc + bias[co];
  }
}

// rows [0, kTile) of `in` (n channels each, f32) times w (n x cout, dt):
// calls put(pixel row, output channel, sum) for the first `np` rows. No
// barrier inside.
template <typename T, typename Put>
__device__ __forceinline__ void tile_1x1(const float* in, int n, int np,
                                         const T* __restrict__ w, int cout, Put put) {
  const int groups = (np + kRows - 1) / kRows;
  for (int task = threadIdx.x; task < groups * cout; task += kThreads) {
    const int r0 = task / cout * kRows, co = task - task / cout * cout;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int ci = 0; ci < n; ++ci) {
      const float wv = to_f(w[ci * cout + co]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(in[(r0 + r) * n + ci], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < np) put(r0 + r, co, acc[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_subnet_kernel(const float* __restrict__ x, const T* __restrict__ wts,
                    const float* __restrict__ bias, float* trunk,
                    float* __restrict__ out, const Dims d, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);                            // act_elems of dt
  float* stage = reinterpret_cast<float*>(smem + L.act_bytes);    // kTile pixel rows
  const int hw = d.h * d.w, K = d.K, k = d.ksize, S = L.sum_w;
  const int64_t n = blockIdx.x;
  const float* xs = x + n * hw * d.cin;
  // y is written and read back by other threads of the block: plain loads,
  // never the read-only path
  float* y = trunk + n * hw * K;
  float* o = out + n * hw * d.out_total;

  // entry conv: act <- dt(x); y <- conv_k(act, entry_w) + entry_b
  for (int e = threadIdx.x; e < hw * d.cin; e += kThreads) act[e] = from_f<T>(xs[e]);
  __syncthreads();
  conv_same<T>(d, act, d.cin, wts, bias, K, y);
  __syncthreads();

  for (int blk = 0; blk < d.res_blocks; ++blk) {
    const T* wb = wts + L.w_block0 + blk * L.w_block;
    const float* bb = bias + L.b_block0 + blk * L.b_block;

    // pre 1x1, tile by tile: act <- dt(lrelu(dt(lrelu(y)) @ pre_w + pre_b))
    for (int p0 = 0; p0 < hw; p0 += kTile) {
      const int np = min(kTile, hw - p0);
      for (int e = threadIdx.x; e < np * K; e += kThreads)
        stage[e] = round_to<T>(lrelu(y[p0 * K + e]));
      __syncthreads();
      tile_1x1<T>(stage, K, np, wb, K, [&](int r, int co, float v) {
        act[(p0 + r) * K + co] = from_f<T>(lrelu(v + bb[co]));
      });
      __syncthreads();
    }

    // branches then post 1x1, tile by tile:
    // stage <- dt(lrelu(gconv(act) + bb)) for every branch column,
    // y <- y + stage @ post_w + post_b
    for (int p0 = 0; p0 < hw; p0 += kTile) {
      const int np = min(kTile, hw - p0);
      const int groups = (np + kRows - 1) / kRows;
      for (int task = threadIdx.x; task < groups * S; task += kThreads) {
        const int r0 = task / S * kRows;
        const int col = task - task / S * S;
        int br = 0;
        while (br + 1 < d.nd && col >= L.col[br + 1]) ++br;
        const int wd = L.width[br], g = L.group[br], dil = d.dil[br];
        const int j = col - L.col[br], ci0 = j / g * g, lo = dil * (k - 1) / 2;
        const T* wbr = wb + L.w_branch[br] + j;  // (k, k, g, wd) from column j
        int py[kRows], px[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int p = min(p0 + r0 + r, hw - 1);  // rows past np are computed, not stored
          py[r] = p / d.w;
          px[r] = p - py[r] * d.w;
        }
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int ty = 0; ty < k; ++ty) {
          for (int tx = 0; tx < k; ++tx) {
            int off[kRows];
            bool in[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int iy = py[r] + ty * dil - lo, ix = px[r] + tx * dil - lo;
              in[r] = iy >= 0 && iy < d.h && ix >= 0 && ix < d.w;
              off[r] = in[r] ? (iy * d.w + ix) * K + ci0 : 0;
            }
            const T* wtap = wbr + (ty * k + tx) * g * wd;
            for (int c = 0; c < g; ++c) {
              const float wv = to_f(wtap[c * wd]);
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                if (in[r]) acc[r] = fmaf(to_f(act[off[r] + c]), wv, acc[r]);
            }
          }
        }
        const float b = bb[L.b_branch[br] + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) stage[(r0 + r) * S + col] = round_to<T>(lrelu(acc[r] + b));
      }
      __syncthreads();
      tile_1x1<T>(stage, S, np, wb + L.w_post, K, [&](int r, int co, float v) {
        const int i = (p0 + r) * K + co;
        y[i] = (y[i] + v) + bb[L.b_post + co];
      });
      __syncthreads();
    }
  }

  // head: act <- dt(lrelu(y)); out <- conv_k(act, head_w) + head_b
  for (int e = threadIdx.x; e < hw * K; e += kThreads) act[e] = from_f<T>(lrelu(y[e]));
  __syncthreads();
  conv_same<T>(d, act, K, wts + L.w_head, bias + L.b_head, d.out_total, o);
}

// Fills L from d; false for sizes the kernel does not take.
template <typename T>
bool make_layout(const Dims& d, Layout& L) {
  if (d.h < 1 || d.w < 1 || d.cin < 1 || d.K < 1 || d.res_blocks < 0 || d.card < 2 ||
      d.ksize < 1 || d.nd < 1 || d.nd > kMaxBranches || d.out_total < 1)
    return false;
  const int64_t kk = static_cast<int64_t>(d.ksize) * d.ksize;
  int64_t sum_w = 0, branch_w = 0;
  for (int i = 0; i < d.nd; ++i) {
    if (d.dil[i] < 1 || d.K % d.dil[i] != 0) return false;
    const int wd = d.K / d.dil[i];
    if (wd % d.card != 0) return false;
    L.width[i] = wd;
    L.group[i] = wd / d.card;
    L.col[i] = static_cast<int>(sum_w);
    L.w_branch[i] = static_cast<int>(static_cast<int64_t>(d.K) * d.K + branch_w);
    L.b_branch[i] = static_cast<int>(d.K + sum_w);
    branch_w += kk * L.group[i] * wd;
    sum_w += wd;
  }
  const int64_t hw = static_cast<int64_t>(d.h) * d.w;
  const int64_t w_entry = kk * d.cin * d.K;
  const int64_t w_block = static_cast<int64_t>(d.K) * d.K + branch_w + sum_w * d.K;
  const int64_t w_total = w_entry + d.res_blocks * w_block + kk * d.K * d.out_total;
  const int64_t act_elems = hw * (d.cin > d.K ? d.cin : d.K);
  const int64_t act_bytes = (act_elems * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 16;
  const int64_t stage_bytes = kTile * (sum_w > d.K ? sum_w : d.K) * 4;
  if (w_total > INT32_MAX || hw * d.K > INT32_MAX || hw * d.out_total > INT32_MAX ||
      act_bytes + stage_bytes > kMaxShared)
    return false;
  L.sum_w = static_cast<int>(sum_w);
  L.w_block0 = static_cast<int>(w_entry);
  L.w_block = static_cast<int>(w_block);
  L.w_post = static_cast<int>(d.K * d.K + branch_w);
  L.w_head = static_cast<int>(w_entry + d.res_blocks * w_block);
  L.b_block0 = d.K;
  L.b_block = static_cast<int>(2 * d.K + sum_w);
  L.b_post = static_cast<int>(d.K + sum_w);
  L.b_head = d.K + d.res_blocks * L.b_block;
  L.act_elems = static_cast<int>(act_elems);
  L.act_bytes = static_cast<int>(act_bytes);
  L.stage_bytes = static_cast<int>(stage_bytes);
  return true;
}

template <typename T>
int launch(const void* x, const void* wts, const void* bias, void* trunk, void* out,
           int batch, const Dims& d, cudaStream_t stream) {
  Layout L;
  if (batch < 1 || !make_layout<T>(d, L)) return static_cast<int>(cudaErrorInvalidValue);
  // raise the block's dynamic shared memory limit to the card's most, once
  // per device, before its first launch (so never during stream capture)
  static bool limit_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!limit_set[dev]) {
    err = cudaFuncSetAttribute(fused_subnet_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set[dev] = true;
  }
  fused_subnet_kernel<T><<<batch, kThreads, L.act_bytes + L.stage_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const T*>(wts),
      static_cast<const float*>(bias), static_cast<float*>(trunk), static_cast<float*>(out),
      d, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (batch, h, w, cin) f32; weights: the packed dt kernels; biases: the packed
// f32 biases; trunk: batch*h*w*K f32 scratch; out (batch, h, w, out_total) f32.
// dtype: 0 = float32, 1 = bfloat16 (the type of weights and of the products'
// operands). dil0..dil3: the first n_dil are the branches' dilations.
extern "C" int fused_subnet_forward(const void* x, const void* weights, const void* biases,
                                    void* trunk, void* out, int batch, int h, int w, int cin,
                                    int kernels, int res_blocks, int cardinality, int ksize,
                                    int n_dil, int dil0, int dil1, int dil2, int dil3,
                                    int out_total, int dtype, void* stream) {
  Dims d{h, w, cin, kernels, res_blocks, cardinality, ksize, n_dil, out_total,
         {dil0, dil1, dil2, dil3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, weights, biases, trunk, out, batch, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, weights, biases, trunk, out, batch, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
