// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm_fwd
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * w over the last dim,
// math in f32, cast back to x's type.
//
// Bound on this card: bytes. Each element is read once and written once
// (4 bytes of traffic per bf16 element, with 2 flops), far below the ~295
// flops per byte where the tensor cores would become the limit. So the design
// moves each byte once, in 16-byte vectors:
//   * dim <= 1024 (the q/k norms over head_dim): one warp per row, 8 rows a
//     block, the sum of squares reduced with shuffles only;
//   * dim > 1024 (ln1, ln2, the final norm over the hidden size): one block
//     per row, a warp-shuffle then shared-memory reduction. The second pass
//     re-reads the row, which the first pass has just brought into L1/L2.
// Rows whose width is not a multiple of the vector, or whose pointers are not
// 16-byte aligned, take the same kernels with scalar loads.
#include <cstdint>

#include "dtype.cuh"
#include "launch.h"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kVecBytes = 16;
constexpr int kWarpRows = 8;       // rows per block in the warp-per-row kernel
constexpr int kMaxBlockThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ float partial_sumsq(const T* __restrict__ xr, int dim,
                                               int lane, int nthr, bool vec) {
  float acc = 0.f;
  if (vec) {
    constexpr int N = kVecBytes / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < dim / N; i += nthr) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    for (int i = lane; i < dim; i += nthr) {
      const float f = to_f32(xr[i]);
      acc = fmaf(f, f, acc);
    }
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void scale_row(const T* __restrict__ xr,
                                          const T* __restrict__ w,
                                          T* __restrict__ yr, int dim, int lane,
                                          int nthr, bool vec, float r) {
  if (vec) {
    constexpr int N = kVecBytes / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < dim / N; i += nthr) {
      const uint4 xraw = xv[i];
      const uint4 wraw = wv[i];
      uint4 yraw;
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* we = reinterpret_cast<const T*>(&wraw);
      T* ye = reinterpret_cast<T*>(&yraw);
#pragma unroll
      for (int j = 0; j < N; ++j) ye[j] = from_f32<T>(to_f32(xe[j]) * r * to_f32(we[j]));
      yv[i] = yraw;
    }
  } else {
    for (int i = lane; i < dim; i += nthr)
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpRows)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int64_t rows, int dim, float eps, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * dim;
  const float ss = warp_sum(partial_sumsq(xr, dim, lane, 32, vec));
  const float r = rsqrtf(ss / static_cast<float>(dim) + eps);
  scale_row(xr, w, y + row * dim, dim, lane, 32, vec, r);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int dim, float eps, bool vec) {
  __shared__ float warp_sums[kMaxBlockThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * dim;
  float ss = warp_sum(partial_sumsq(xr, dim, threadIdx.x, blockDim.x, vec));
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = warp_sum(lane < nwarps ? warp_sums[lane] : 0.f);
    if (lane == 0) total = ss;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(dim) + eps);
  scale_row(xr, w, y + row * dim, dim, threadIdx.x, blockDim.x, vec, r);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % kVecBytes) == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows, int dim,
                   float eps, cudaStream_t stream) {
  constexpr int N = kVecBytes / sizeof(T);
  const bool vec = dim % N == 0 && aligned16(x) && aligned16(w) && aligned16(y);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (dim <= 1024) {
    const int64_t blocks = (rows + kWarpRows - 1) / kWarpRows;
    rmsnorm_warp_kernel<T><<<static_cast<unsigned>(blocks), 32 * kWarpRows, 0, stream>>>(
        xt, wt, yt, rows, dim, eps, vec);
  } else {
    const int units = vec ? dim / N : dim;
    int threads = ((units + 31) / 32) * 32;
    if (threads > kMaxBlockThreads) threads = kMaxBlockThreads;
    rmsnorm_block_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
        xt, wt, yt, dim, eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

cudaError_t repro_rmsnorm_fwd(const void* x, const void* w, void* y, int64_t rows,
                              int dim, float eps, int dtype, cudaStream_t stream) {
  if (rows <= 0 || dim <= 0 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (dtype == REPRO_F32) return launch<float>(x, w, y, rows, dim, eps, stream);
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(x, w, y, rows, dim, eps, stream);
  return cudaErrorInvalidValue;
}
