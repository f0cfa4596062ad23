// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm_fwd
// (_rmsnorm_kernel): y = x * rsqrt(mean(x^2) + eps) * w over the last dim,
// math in f32, cast back to x's type, multiplied in that order (x r w).
//
// Bound on this card: bytes. x is read once, y written once and w read once:
// 2 flops to 4 bytes in bf16, far below the ~295 flops per byte where the
// tensor cores would set the limit. So the design is about bytes in flight and
// the length of each row's chain of dependent steps, not about wgmma or TMA.
//
// The vector kernel (rmsnorm_vec_kernel<T, LPR, VPT, RPT, THREADS>):
//   * a row is cut into 16-byte vectors (8 bf16 or 4 f32); LPR lanes share a
//     row, each holding VPT of its vectors (lane l holds vectors l, l + LPR,
//     ..., so neighbouring lanes read neighbouring addresses); a thread holds
//     RPT rows, RPT * VPT vectors of x and VPT of w in registers;
//   * every load of x and w is issued before any arithmetic, with compile-time
//     trip counts (a vector past the row's end is masked, not branched
//     around), so a row costs one round trip to memory, one reduction and one
//     store. x is read from memory exactly once and y written from registers;
//     w stays in registers for the thread's rows. No variant re-reads w;
//   * the reduction is __shfl_xor_sync over the lanes of a row (LPR <= 32:
//     several rows share a warp), plus one shared-memory step across warps
//     (LPR > 32). Rows past the end of x take part in the shuffles with
//     masked (zero) loads and store nothing: no thread leaves early;
//   * x may be a strided view: row r starts at element
//     (r / n_inner) * s_outer + (r % n_inner) * s_inner (int64), which holds
//     the q and k views of the fused qkv product ((B S, H) rows, strides
//     ((H + 2 Hkv) D, D)); y is contiguous.
//
// (dtype, D, rows) -> (LPR, VPT, RPT, THREADS), pick_config below. With V =
// D / (16 / sizeof(T)) vectors a row (8 bf16 or 4 f32 elements each):
//   * a call of at least 2^18 vectors (4 MB of bf16 x: the forward's q/k
//     norms, ln over 1024 x 4096): VPT = 4 (fewer when V < 4), LPR = V / 4
//     rounded up to a power of two, 256-thread blocks (wider rows: one row a
//     block of LPR threads). 64 bytes of x in flight a thread, with the row
//     in a few lanes of a warp at head sizes (bf16 D = 128: 4 lanes, 8 rows a
//     warp) and across warps at hidden sizes (D = 4096: 128 lanes);
//   * below that (prefill, decode, the k norm of a short batch): VPT = 1,
//     LPR = V rounded up to a power of two (up to 1024, then VPT = 2 and 4),
//     128-thread blocks or one row a block, so every vector has its own
//     thread and the critical path is one round trip for x and w, the
//     shuffles, at most one barrier and one store;
//   * RPT = 1 throughout: a thread holding 2 or 4 rows was no faster than
//     VPT = 4 over a quarter of the lanes at any shape of the main paths.
//   tools/rmsnorm_variants.py times every configuration (and the extra ones
//   it builds) at those shapes; the picks and the 2^18 threshold come from it
//   (PERF.md). On the same tool, a row spread over a cluster of 2-8 blocks
//   that reduce through distributed shared memory was slower at (4, 4096)
//   and (4, 1024) than one block a row, so it is not built here.
//   Registers: at most 64 a thread at 1024 threads; VPT = 8 at 1024 threads
//   spilled, hence REPRO_RMSNORM_MAX_VECTORS = 4096.
//
// Rows the vector kernel cannot read (a width that is not a multiple of the
// vector, a base pointer or stride off the 16-byte grid, V above
// REPRO_RMSNORM_MAX_VECTORS) take the scalar kernels when x is contiguous:
// one warp a row for D <= 1024, one block a row above, each reading the row
// twice. A strided x that the vector kernel cannot read is refused.
#include <cstdint>

#include "dtype.cuh"
#include "launch.h"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kVecBytes = 16;

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int64_t row_offset(const RmsNormRows& p, int64_t row) {
  const uint32_t r = static_cast<uint32_t>(row);
  const uint32_t outer = r / static_cast<uint32_t>(p.n_inner);
  const uint32_t inner = r - outer * static_cast<uint32_t>(p.n_inner);
  return static_cast<int64_t>(outer) * p.s_outer + static_cast<int64_t>(inner) * p.s_inner;
}

// ---------------------------------------------------------------------------
// vector kernel
// ---------------------------------------------------------------------------

template <typename T, int LPR, int VPT, int RPT, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                   RmsNormRows p, float eps) {
  static_assert(THREADS % 32 == 0 && THREADS % LPR == 0 && (LPR & (LPR - 1)) == 0,
                "LPR: a power of two dividing THREADS");
  constexpr int N = kVecBytes / sizeof(T);
  constexpr int GROUPS = THREADS / LPR;  // rows a block holds at once
  constexpr int WARPS_PER_ROW = LPR > 32 ? LPR / 32 : 1;
  const int lane = threadIdx.x % LPR;
  const int group = threadIdx.x / LPR;
  const int nvec = p.dim / N;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * GROUPS * RPT + group;

  uint4 wv[VPT];
  uint4 xv[RPT][VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = lane + j * LPR;
    wv[j] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(w) + v) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int64_t row = row0 + static_cast<int64_t>(k) * GROUPS;
    const bool live = row < p.rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row_offset(p, row) : 0));
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = lane + j * LPR;
      xv[k][j] = live && v < nvec ? __ldg(xr + v) : make_uint4(0, 0, 0, 0);
    }
  }

  float ss[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const T* e = reinterpret_cast<const T*>(&xv[k][j]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float f = to_f32(e[i]);
        acc = fmaf(f, f, acc);
      }
    }
    ss[k] = group_sum<(LPR < 32 ? LPR : 32)>(acc);
  }
  __shared__ float part[RPT][LPR > 32 ? THREADS / 32 : 1];
  if constexpr (LPR > 32) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) part[k][warp] = ss[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS_PER_ROW; ++i) s += part[k][group * WARPS_PER_ROW + i];
      ss[k] = s;
    }
  }

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int64_t row = row0 + static_cast<int64_t>(k) * GROUPS;
    if (row >= p.rows) continue;
    const float r = rsqrtf(ss[k] / static_cast<float>(p.dim) + eps);
    uint4* yr = reinterpret_cast<uint4*>(y) + row * nvec;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = lane + j * LPR;
      if (v >= nvec) continue;
      uint4 out;
      const T* xe = reinterpret_cast<const T*>(&xv[k][j]);
      const T* we = reinterpret_cast<const T*>(&wv[j]);
      T* ye = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < N; ++i) ye[i] = from_f32<T>(to_f32(xe[i]) * r * to_f32(we[i]));
      yr[v] = out;
    }
  }
}

// Every configuration the vector kernel is built in, X(LPR, VPT, RPT, THREADS):
// those pick_config can choose, and REPRO_RMSNORM_EXTRA_CONFIGS, which only
// tools/rmsnorm_variants.py defines, to time other choices.
#define REPRO_RMSNORM_CONFIGS(X)                                                   \
  X(1, 1, 1, 128) X(2, 1, 1, 128) X(4, 1, 1, 128) X(8, 1, 1, 128) X(16, 1, 1, 128) \
  X(32, 1, 1, 128) X(64, 1, 1, 128) X(128, 1, 1, 128) X(256, 1, 1, 256)            \
  X(512, 1, 1, 512) X(1024, 1, 1, 1024) X(1024, 2, 1, 1024) X(1, 2, 1, 256)        \
  X(1, 4, 1, 256) X(2, 4, 1, 256) X(4, 4, 1, 256) X(8, 4, 1, 256) X(16, 4, 1, 256) \
  X(32, 4, 1, 256) X(64, 4, 1, 256) X(128, 4, 1, 256) X(256, 4, 1, 256)           \
  X(512, 4, 1, 512) X(1024, 4, 1, 1024)
#ifndef REPRO_RMSNORM_EXTRA_CONFIGS
#define REPRO_RMSNORM_EXTRA_CONFIGS(X)
#endif

struct VecConfig {
  int lpr, vpt, rpt, threads;
};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Four vectors a thread once a call moves 2^18 vectors (4 MB of bf16 x);
// below that, one vector a thread, as wide as the row goes (up to 1024
// threads, then two and four vectors a thread).
constexpr int64_t kManyVectors = int64_t{1} << 18;

VecConfig pick_config(int nvec, int64_t rows) {
  int vpt = rows * nvec >= kManyVectors ? (nvec < 4 ? pow2_at_least(nvec) : 4) : 1;
  int lpr = pow2_at_least((nvec + vpt - 1) / vpt);
  while (lpr > 1024) {
    vpt *= 2;
    lpr = pow2_at_least((nvec + vpt - 1) / vpt);
  }
  const int min_threads = vpt == 1 ? 128 : 256;
  return {lpr, vpt, 1, lpr > min_threads ? lpr : min_threads};
}

template <typename T>
cudaError_t launch_vec(const VecConfig& c, const void* x, const void* w, void* y,
                       const RmsNormRows& p, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
#define REPRO_RMSNORM_LAUNCH(L, V, R, TH)                                             \
  if (c.lpr == L && c.vpt == V && c.rpt == R && c.threads == TH) {                    \
    constexpr int64_t kRows = (TH / L) * R;                                           \
    rmsnorm_vec_kernel<T, L, V, R, TH>                                                \
        <<<static_cast<unsigned>((p.rows + kRows - 1) / kRows), TH, 0, stream>>>(    \
            xt, wt, yt, p, eps);                                                      \
    return cudaGetLastError();                                                        \
  }
  REPRO_RMSNORM_CONFIGS(REPRO_RMSNORM_LAUNCH)
  REPRO_RMSNORM_EXTRA_CONFIGS(REPRO_RMSNORM_LAUNCH)
#undef REPRO_RMSNORM_LAUNCH
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// scalar kernels (contiguous rows of any width or alignment)
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 8;  // rows per block in the warp-per-row kernel
constexpr int kMaxBlockThreads = 256;

template <typename T>
__device__ __forceinline__ float partial_sumsq(const T* __restrict__ xr, int dim, int lane,
                                               int nthr) {
  float acc = 0.f;
  for (int i = lane; i < dim; i += nthr) {
    const float f = to_f32(xr[i]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void scale_row(const T* __restrict__ xr, const T* __restrict__ w,
                                          T* __restrict__ yr, int dim, int lane, int nthr,
                                          float r) {
  for (int i = lane; i < dim; i += nthr) yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpRows)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int64_t rows, int dim, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together: one row a warp
  const T* xr = x + row * dim;
  const float ss = group_sum<32>(partial_sumsq(xr, dim, lane, 32));
  const float r = rsqrtf(ss / static_cast<float>(dim) + eps);
  scale_row(xr, w, y + row * dim, dim, lane, 32, r);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int dim, float eps) {
  __shared__ float warp_sums[kMaxBlockThreads / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * dim;
  float ss = group_sum<32>(partial_sumsq(xr, dim, threadIdx.x, blockDim.x));
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = group_sum<32>(lane < nwarps ? warp_sums[lane] : 0.f);
    if (lane == 0) total = ss;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(dim) + eps);
  scale_row(xr, w, y + row * dim, dim, threadIdx.x, blockDim.x, r);
}

template <typename T>
cudaError_t launch_scalar(const void* x, const void* w, void* y, int64_t rows, int dim,
                          float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (dim <= 1024) {
    const int64_t blocks = (rows + kWarpRows - 1) / kWarpRows;
    rmsnorm_warp_kernel<T><<<static_cast<unsigned>(blocks), 32 * kWarpRows, 0, stream>>>(
        xt, wt, yt, rows, dim, eps);
  } else {
    int threads = ((dim + 31) / 32) * 32;
    if (threads > kMaxBlockThreads) threads = kMaxBlockThreads;
    rmsnorm_block_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
        xt, wt, yt, dim, eps);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % kVecBytes == 0; }

// Row r starts at r * dim.
bool dense(const RmsNormRows& p) {
  return (p.n_inner == 1 || p.s_inner == p.dim) &&
         (p.rows == p.n_inner || p.s_outer == p.n_inner * p.dim);
}

// Rows the vector kernel reads: whole 16-byte vectors on the 16-byte grid.
bool vector_rows(const RmsNormRows& p, int n, bool pointers_aligned) {
  return pointers_aligned && p.dim % n == 0 && p.dim / n <= REPRO_RMSNORM_MAX_VECTORS &&
         p.s_outer % n == 0 && p.s_inner % n == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, const RmsNormRows& p, float eps,
                   cudaStream_t stream) {
  constexpr int N = kVecBytes / sizeof(T);
  if (vector_rows(p, N, aligned16(x) && aligned16(w) && aligned16(y)))
    return launch_vec<T>(pick_config(p.dim / N, p.rows), x, w, y, p, eps, stream);
  if (!dense(p)) return cudaErrorMisalignedAddress;
  return launch_scalar<T>(x, w, y, p.rows, p.dim, eps, stream);
}

}  // namespace

cudaError_t repro_rmsnorm_fwd(const void* x, const void* w, void* y, const RmsNormRows& p,
                              float eps, int dtype, cudaStream_t stream) {
  if (p.rows <= 0 || p.dim <= 0 || p.rows > 0x7fffffffLL || p.n_inner <= 0 ||
      p.rows % p.n_inner != 0 || p.s_outer < 0 || p.s_inner < 0)
    return cudaErrorInvalidValue;
  if (dtype == REPRO_F32) return launch<float>(x, w, y, p, eps, stream);
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(x, w, y, p, eps, stream);
  return cudaErrorInvalidValue;
}
