// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:ssd_scan_fwd
// (_ssd_kernel): per head, h_t = exp(A dt_t) h_{t-1} + dt_t x_t (outer) B_t and
// y_t = h_t . C_t + D x_t, from a zero state, returning y (x's type) and the
// final (P, N) state in f32. The sequence is cut into chunks of L steps; inside
// a chunk the recurrence is the masked quadratic form of the TPU kernel, and
// the state carries the chunks before it:
//   g_t      = sum_{u <= t} A dt_u                      (cumulative log-decay)
//   y_t      = sum_{s <= t} (C_t . B_s) exp(g_t - g_s) dt_s x_s
//              + exp(g_t) C_t . h_in + D x_t
//   h_out    = exp(G) h_in + sum_s exp(G - g_s) dt_s x_s (outer) B_s,  G = g_{L-1}
//
// Bound on this card: at the full-sequence forward's shape (B=4, S=2048, H=32,
// P=64, N=128, bf16) the kernel must move about 76 MB (x and y dominate) and
// do about 12 GFLOP at L = 64 (causal pairs only), so the ideal kernel is
// bound by the bytes. This first kernel is simple: its products run in f32 on
// the CUDA cores from shared memory, so it is bound by operations (f32 FMA
// issue and shared-memory reads). Tensor cores (wgmma), TMA, and sharing C.B^T
// across the heads of one (b, chunk) (it does not depend on the head) are
// later work.
//
// Design. The TPU grid walks (b, h) in parallel and the chunks in sequence,
// carrying the state in VMEM scratch across grid steps. Here one block of 256
// threads owns one (b, h) and loops over the chunks itself, with the (P, N)
// state in shared memory in f32 (32 KB at P=64, N=128):
//   * per chunk, C, B, x and dt land in shared memory as f32 (rows past the
//     end of the sequence as zeros, dt = 0 there, so the state does not move
//     and the ragged tail is masked as ssd.py does);
//   * warp 0 scans a dt into g with shuffles, in double: on a head that
//     decays fast g reaches -250 within a chunk, and g_t - g_s taken from two
//     f32 sums near the diagonal loses ~1e-5 of the exponent, which put the
//     f32 chunked form ten times further from the sequential scan than the
//     sequential scan's own rounding. The products a dt stay f32, as in the
//     plain version; each difference is rounded to f32 before its expf.
//     exp(g_t) and w_s = exp(G - g_s) dt_s are computed once per step;
//   * the three products (C B^T, then S x + C h^T, then x^T diag(w) B) are
//     register-tiled: thread (ty, tx) = (tid / 16, tid % 16) owns rows
//     ty + 16 i and columns tx + 16 j (i, j < 4) of a 64 x 64 output tile.
//     Rows of C, B and h are padded by one float so the 16 lanes of a row
//     read 16 banks;
//   * above the diagonal g_t - g_s > 0 and exp can overflow to inf: those
//     scores are selected to 0, never multiplied by a mask (inf * 0 = NaN),
//     and score tiles wholly above the diagonal are never computed or read.
// Operands may be strided views with a contiguous last dim: x, B and C are
// slices of one split of the depthwise-conv output, and the kernel takes their
// strides instead of a copy.
#include <cmath>
#include <cstdint>

#include "dtype.cuh"
#include "launch.h"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TM = 4;         // output rows per thread: ty + 16 i
constexpr int TN = 4;         // output columns per thread: tx + 16 j
constexpr int TILE = 16 * TM; // a pass covers 64 x 64 outputs (TM == TN)

// acc[i][j] += sum_{k < K} a(mi[i], k) * b(k, nj[j])
template <class FA, class FB>
__device__ __forceinline__ void tile_accumulate(float (&acc)[TM][TN], const int (&mi)[TM],
                                                const int (&nj)[TN], int K, FA a, FB b) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a(mi[i], k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b(k, nj[j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// This thread's rows and columns of the tile at (m0, n0), clamped into
// [0, M) x [0, Ncol) so the reads stay in bounds; the epilogue writes only
// the real ones.
__device__ __forceinline__ void tile_index(int m0, int n0, int M, int Ncol, int (&mi)[TM],
                                           int (&nj)[TN]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) mi[i] = min(m0 + ty + 16 * i, M - 1);
#pragma unroll
  for (int j = 0; j < TN; ++j) nj[j] = min(n0 + tx + 16 * j, Ncol - 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ C, const float* __restrict__ Dv,
               T* __restrict__ y, float* __restrict__ state, const SsdParams p) {
  extern __shared__ double smem_d[];
  const int L = p.L, P = p.P, N = p.N;
  const int NP = N + 1, LP = L + 1;  // padded row lengths
  double* sG = smem_d;        // [L] cumulative log-decay, in double
  float* sC = reinterpret_cast<float*>(sG + L);  // [L][N + 1]
  float* sB = sC + L * NP;    // [L][N + 1]
  float* sX = sB + L * NP;    // [L][P]
  float* sH = sX + L * P;     // [P][N + 1], the carried state
  float* sS = sH + P * NP;    // [L][L + 1], masked scores
  float* sDt = sS + L * LP;   // [L]
  float* sEg = sDt + L;       // [L] exp(g_t)
  float* sW = sEg + L;        // [L] exp(G - g_s) dt_s

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h], dcoef = Dv[h];
  const T* xb = x + b * p.x_b + h * p.x_h;
  const T* dtb = dt + b * p.dt_b + h * p.dt_h;
  const T* Bb = Bm + b * p.bm_b;
  const T* Cb = C + b * p.c_b;
  const int64_t y_row = static_cast<int64_t>(p.H) * P;  // y is contiguous (B, S, H, P)
  T* yb = y + static_cast<int64_t>(b) * p.S * y_row + static_cast<int64_t>(h) * P;

  for (int e = tid; e < P * NP; e += THREADS) sH[e] = 0.f;

  const int n_chunks = (p.S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int len = min(L, p.S - c * L);  // c * L < S fits an int
    const int64_t t0 = static_cast<int64_t>(c) * L;
    __syncthreads();  // the previous chunk is done with sC, sB, sX, sW and sH

    for (int e = tid; e < L * N; e += THREADS) {
      const int s = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (s < len) {
        bv = to_f32(Bb[(t0 + s) * p.bm_s + n]);
        cv = to_f32(Cb[(t0 + s) * p.c_s + n]);
      }
      sB[s * NP + n] = bv;
      sC[s * NP + n] = cv;
    }
    for (int e = tid; e < L * P; e += THREADS) {
      const int s = e / P, q = e % P;
      sX[e] = s < len ? to_f32(xb[(t0 + s) * p.x_s + q]) : 0.f;
    }
    for (int s = tid; s < L; s += THREADS)
      sDt[s] = s < len ? to_f32(dtb[(t0 + s) * p.dt_s]) : 0.f;
    __syncthreads();

    if (tid < 32) {  // inclusive scan of a * dt, 32 steps at a time
      double carry = 0.0;
      for (int s0 = 0; s0 < L; s0 += 32) {
        const int s = s0 + tid;
        double v = s < L ? static_cast<double>(a * sDt[s]) : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (s < L) sG[s] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double G = sG[L - 1];
    for (int s = tid; s < L; s += THREADS) {
      sEg[s] = expf(static_cast<float>(sG[s]));
      sW[s] = expf(static_cast<float>(G - sG[s])) * sDt[s];
    }

    // scores S[t][s] = (C_t . B_s) exp(g_t - g_s) dt_s for s <= t, else 0.
    // Tiles with n0 > m0 lie wholly above the diagonal: y never reads them.
    for (int m0 = 0; m0 < len; m0 += TILE) {
      for (int n0 = 0; n0 <= m0; n0 += TILE) {
        int mi[TM], nj[TN];
        tile_index(m0, n0, len, len, mi, nj);
        float acc[TM][TN] = {};
        tile_accumulate(acc, mi, nj, N, [&](int t, int n) { return sC[t * NP + n]; },
                        [&](int n, int s) { return sB[s * NP + n]; });
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = m0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int s = n0 + tx + 16 * j;
            if (t < len && s < len)
              sS[t * LP + s] =
                  s <= t ? acc[i][j] * expf(static_cast<float>(sG[t] - sG[s])) * sDt[s] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // y[t][q] = sum_{s <= t} S[t][s] x[s][q] + exp(g_t) sum_n C[t][n] h[q][n] + D x[t][q]
    for (int m0 = 0; m0 < len; m0 += TILE) {
      const int k_end = min(len, m0 + TILE);  // rows of this tile see s < k_end
      for (int n0 = 0; n0 < P; n0 += TILE) {
        int mi[TM], nj[TN];
        tile_index(m0, n0, len, P, mi, nj);
        float intra[TM][TN] = {}, carried[TM][TN] = {};
        tile_accumulate(intra, mi, nj, k_end, [&](int t, int s) { return sS[t * LP + s]; },
                        [&](int s, int q) { return sX[s * P + q]; });
        tile_accumulate(carried, mi, nj, N, [&](int t, int n) { return sC[t * NP + n]; },
                        [&](int n, int q) { return sH[q * NP + n]; });
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = m0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int q = n0 + tx + 16 * j;
            if (t < len && q < P)
              yb[(t0 + t) * y_row + q] = from_f32<T>(
                  intra[i][j] + sEg[t] * carried[i][j] + dcoef * sX[t * P + q]);
          }
        }
      }
    }
    __syncthreads();  // y has read h_in

    // h[q][n] = exp(G) h[q][n] + sum_s (x[s][q] w_s) B[s][n]; each entry has one owner
    const float eG = expf(static_cast<float>(G));
    for (int m0 = 0; m0 < P; m0 += TILE) {
      for (int n0 = 0; n0 < N; n0 += TILE) {
        int mi[TM], nj[TN];
        tile_index(m0, n0, P, N, mi, nj);
        float acc[TM][TN] = {};
        tile_accumulate(acc, mi, nj, len, [&](int q, int s) { return sX[s * P + q] * sW[s]; },
                        [&](int s, int n) { return sB[s * NP + n]; });
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int q = m0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx + 16 * j;
            if (q < P && n < N) sH[q * NP + n] = eG * sH[q * NP + n] + acc[i][j];
          }
        }
      }
    }
  }
  __syncthreads();

  float* st = state + (static_cast<int64_t>(b) * p.H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) st[e] = sH[(e / N) * NP + e % N];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm,
                   const void* C, const float* D, void* y, float* state, const SsdParams& p,
                   cudaStream_t stream) {
  const int64_t bytes = repro_ssd_smem_bytes(p.L, p.P, p.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_fwd_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(C), D, static_cast<T*>(y), state, p);
  return cudaGetLastError();
}

}  // namespace

cudaError_t repro_ssd_scan_fwd(const void* x, const void* dt, const float* A, const void* Bm,
                               const void* C, const float* D, void* y, float* state,
                               const SsdParams& p, int dtype, cudaStream_t stream) {
  if (p.B <= 0 || p.S <= 0 || p.H <= 0 || p.P <= 0 || p.N <= 0 || p.L <= 0 || p.L > p.S ||
      p.H > 65535 || p.B > 65535)
    return cudaErrorInvalidValue;
  if (dtype == REPRO_F32) return launch<float>(x, dt, A, Bm, C, D, y, state, p, stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, C, D, y, state, p, stream);
  return cudaErrorInvalidValue;
}
