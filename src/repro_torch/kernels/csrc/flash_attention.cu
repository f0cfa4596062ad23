// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_fwd (_flash_fwd_kernel): GQA attention with an online
// softmax, causal with the queries at absolute positions q_offset + i,
// returning out (q's type) and lse = m + log(l) in f32. Query head h reads
// kv head h / (Hq / Hkv) in place, with no K/V copy.
//
// Bound on this card: at the full-sequence forward's shapes (S = T = 512,
// D = 128) the causal work is about 4 * D * S * (S + 1) / 2 flops per head
// against 2 * D bytes per q/k/v/out row, so the ideal kernel is close to the
// line between the two; a tensor-core kernel would be bound by the bytes.
// This first kernel is simple: its dots run in f32 on the CUDA cores, so it is
// bound by operations (f32 FMA issue and shared-memory reads), far from the
// card's bf16 tensor rate. wgmma, TMA and tuning are later work.
//
// Design. The TPU grid walks (b, h, q-block) in parallel and the kv blocks in
// sequence, carrying (m, l, acc) in VMEM scratch across grid steps. Here one
// block of 128 threads owns (b, h, one 64-row q tile) and loops over 64-key
// tiles itself, so the running state lives in registers:
//   * thread (rg = tid / 8, cg = tid % 8) owns query rows rg + 16 i (i < 4),
//     score columns cg + 8 j (j < 8) and output columns cg + 8 j (j < D / 8).
//     A row's 8 owners are 8 lanes of one warp, so the row max and row sum are
//     three shuffles, and m, l and the output rows stay in that thread;
//   * Q and K tiles sit in shared memory d-major (padded by one float) so the
//     score loop reads consecutive floats; V sits key-major for P V;
//   * K/V rows at or past T are loaded as zeros (padding may hold NaN) and
//     their scores are set to -inf; the running max starts at the finite
//     -1e30, so exp never sees (-inf) - (-inf). With causal and q_offset >= 0
//     key 0 is visible to every row, so l > 0 for every real row;
//   * causal: key tiles past the last row's position are never visited; the
//     row mask still applies inside the diagonal tile.
#include <cmath>
#include <cstdint>

#include "dtype.cuh"
#include "launch.h"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int RPT = BQ / 16;  // rows per thread
constexpr int CPT = BK / 8;   // score columns per thread
constexpr float kNegInit = -1e30f;

template <int D>
constexpr int smem_floats() {
  return D * (BQ + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const FlashParams p) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // [D][BQ + 1]
  float* sK = sQ + D * (BQ + 1);    // [D][BK + 1]
  float* sV = sK + D * (BK + 1);    // [BK][D]
  float* sP = sV + BK * D;          // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* qb = q + b * p.q.b + h * p.q.h;
  const T* kb = k + b * p.k.b + hk * p.k.h;
  const T* vb = v + b * p.v.b + hk * p.v.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, qi = q0 + r;
    sQ[d * (BQ + 1) + r] = qi < p.S ? to_f32(qb[qi * p.q.s + d]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][D / 8];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  int kv_end = p.T;
  if (p.causal) {
    const int last_row = min(q0 + BQ, p.S) - 1;
    kv_end = min(p.T, p.q_offset + last_row + 1);
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sK/sV reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D, kj = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (kj < p.T) {
        kk = to_f32(kb[kj * p.k.s + d]);
        vv = to_f32(vb[kj * p.v.s + d]);
      }
      sK[d * (BK + 1) + c] = kk;
      sV[c * D + d] = vv;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[d * (BQ + 1) + rg + 16 * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[d * (BK + 1) + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = rg + 16 * i;
      const int qpos = p.q_offset + q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = k0 + cg + 8 * j;
        const bool live = kj < p.T && (!p.causal || kj <= qpos);
        s[i][j] = live ? s[i][j] * p.sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at -1e30
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(s[i][j] - m_new);  // 0 for a masked score
        sP[row * (BK + 1) + cg + 8 * j] = pj;
        rs += pj;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's P entries come from the 8 lanes of this warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(rg + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int dd = 0; dd < D / 8; ++dd) {
        const float vv = sV[c * D + cg + 8 * dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][dd] = fmaf(pv[i], vv, acc[i][dd]);
      }
    }
  }

  const int64_t head = static_cast<int64_t>(b) * p.Hq + h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= p.S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (head * p.S + qi) * D;
#pragma unroll
    for (int dd = 0; dd < D / 8; ++dd) orow[cg + 8 * dd] = from_f32<T>(acc[i][dd] / l_safe);
    if (cg == 0) lse[head * p.S + qi] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const FlashParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       float* lse, const FlashParams& p, cudaStream_t stream) {
  switch (p.D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, p, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, p, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, p, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      void* out, float* lse, const FlashParams& p,
                                      int dtype, cudaStream_t stream) {
  if (p.B <= 0 || p.Hq <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.S <= 0 ||
      p.T <= 0 || p.Hq > 65535 || p.B > 65535 || (p.causal && p.q_offset < 0))
    return cudaErrorInvalidValue;
  if (dtype == REPRO_F32) return dispatch_d<float>(q, k, v, out, lse, p, stream);
  if (dtype == REPRO_BF16) return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, p, stream);
  return cudaErrorInvalidValue;
}
