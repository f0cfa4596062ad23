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
// do about 12 GFLOP at L = 64 (causal pairs only): 0.0227 ms of bytes against
// 0.012 ms of bf16 tensor-core operations, so the ideal kernel is bound by the
// bytes. Two kernels, one per input type:
//
// bf16, the model's type: tensor cores (ssd_fwd_bf16).
//   * Enough blocks. Row q of the state depends only on column q of x, and
//     column q of y only on row q of the state, so P is split: one block of 4
//     warps owns (b, h, PB = 32 columns of P) (16 when P % 32 != 0) and walks
//     its chunks in order, its (PB, N) f32 slice of the state in registers.
//     At the forward's shape that is 256 blocks (the TPU grid's (b, h) alone
//     gave 128 on 132 SMs); each takes 100 KB of shared memory, so two fit an
//     SM. C.B^T does not depend on the head or on q; each block computes it
//     again, on the lower triangle only (21% of the block's products).
//   * All four products are mma.sync.m16n8k16 bf16 -> f32. Warp w owns score
//     rows t of 16 (row tile w, and at L = 128 also 7 - w, so the causal work
//     balances): C's A fragments are loaded once for C.B^T and C.h^T, and the
//     scores stay in registers as S x's A fragments, as K2 keeps P. The row
//     tile's loops take their trip counts from the tile at compile time
//     (with_tile), so no branch splits them. The state update
//     h = e^G h + (x w)^T B keeps h as the mma accumulator: warp w owns a
//     (16 q, N / 2) tile of it.
//   * Three operands are f32 values, not bf16 inputs: the scores S, x w and h.
//     One bf16 rounding of S (2^-9) already takes y past half its bf16 bound
//     in the CPU emulation (tests/test_torch_kernels.py), so each is split
//     into bf16 hi + lo (lo = the rounding error of hi, ~2^-17 of the value
//     left) and goes through two mma against the exact bf16 operand (x, B or
//     C); y's two parts go to separate accumulators (more chains in flight).
//     h reaches C.h^T through shared memory, as hi and lo bf16 rows written
//     after each update.
//   * Overlapped loads: C, B and the block's x columns of chunk c + 1 are
//     16-byte cp.async copies into a 2-stage ring while chunk c computes,
//     one __syncthreads() to land them. Rows past the sequence, rows between
//     L and 64 or 128, and state columns between N and N rounded up to 16, 32,
//     64 or 128 are zero-filled (src-size 0), with dt = 0 there, so the state
//     does not move.
//   * g is scanned in double with shuffles, one chunk ahead, by warp 0 (the
//     warp with the shortest row tile) into a second set of per-step rows
//     (g, exp(g), w = exp(G - g) dt, dt): on a head that decays fast g reaches
//     -250 within a chunk, and g_t - g_s from two f32 sums loses ~1e-5 of the
//     exponent. g log2(e) is kept as an f32 hi + lo pair, whose differences
//     carry the f64 difference's precision into ex2. dt is a gather with
//     stride H: warp 0 loads chunk c + 2's into registers during chunk c.
//   * Off-diagonal score tiles take exp(g_t - g_s) = exp(g_t - g_r) f_s, r the
//     last step of s's 8-step tile and f_s = exp(g_r - g_s) dt_s a per-step
//     row: both factors are <= 1, and a score costs two multiplies instead of
//     an exponential.
//   * Shared rows are padded by 16 bytes so that the 8 rows of one ldmatrix
//     fall on 8 distinct bank quads. x and B are read with ldmatrix.trans
//     where they are the k-major operand.
//   * Above the diagonal g_t - g_s > 0 and exp can overflow to inf: those
//     scores are selected to 0, never multiplied by a mask (inf * 0 = NaN),
//     and score tiles wholly above the diagonal are never computed.
//   Takes P % 16 == 0, N % 8 == 0 with N <= 128, L <= 128, and 16-byte
//   aligned x, B and C rows (cudaErrorMisalignedAddress otherwise).
//   What bounds it: not the bytes or the tensor cores, but the latency of
//   each warp's chain of copies, ldmatrix, mma and exponentials, with 8
//   warps an SM. tools/ssd_breakdown.py times the kernel with one part
//   switched off at a time (PERF.md has the numbers): no single part holds
//   most of the time. Warp-specialised and wgmma/TMA designs are the next
//   step.
// f32, the port's parity type: CUDA cores (ssd_fwd_f32). One block of 256
//   threads owns one (b, h), with the (P, N) f32 state in shared memory; the
//   three products (C B^T, then S x + C h^T, then x^T diag(w) B) are
//   register-tiled f32 FMAs: thread (ty, tx) = (tid / 16, tid % 16) owns rows
//   ty + 16 i and columns tx + 16 j (i, j < 4) of a 64 x 64 output tile.
//   Warp 0 scans g in double.
// Operands may be strided views with a contiguous last dim: x, B and C are
// slices of one split of the depthwise-conv output, and the kernels take their
// strides instead of a copy.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>

#include "dtype.cuh"
#include "launch.h"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int NMAX = 128;  // widest state the bf16 kernel takes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid == false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix and mma are not volatile, so that ptxas may interleave them; the
// barriers and cp.async waits order them against the shared stores
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) -> bf16x2 hi = round(v) and lo = round(v - hi), element 0 in the
// low half
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const uint32_t hb = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __uint_as_float(hb << 16),
                                                 v1 - __uint_as_float(hb & 0xffff0000u));
  hi = hb;
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the two bf16 of a bf16x2, as f32
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<m>()) for a warp-uniform m in [0, MT): the loops of a score row tile
// then have compile-time trip counts, with no branch inside them
template <int MT, class F>
__device__ __forceinline__ void with_tile(int m, const F& f) {
  if constexpr (MT > 1) {
    if (m == MT - 1)
      f(Int<MT - 1>());
    else
      with_tile<MT - 1>(m, f);
  } else {
    f(Int<0>());
  }
}

// Per-step rows of a chunk in shared memory (two sets, chunks c and c + 1):
// g log2(e) as an f32 hi + lo pair, exp(g), w = exp(G - g) dt, dt, and the
// column factor f = exp(g_r - g_s) dt_s with r the last step of s's 8-step
// tile (24 bytes a step), after exp(G) of each set (16 bytes).
constexpr int kScanBytesPerStep = 24;

// Shared memory of one bf16 block: the per-step rows; the state's hi and lo
// rows (PB x (NP + 8)); two stages of C and B (LMAX x (NP + 8)) and x
// (LMAX x (PB + 8)).
constexpr int tc_smem_bytes(int lmax, int pb, int np) {
  return 16 + 2 * lmax * kScanBytesPerStep + 2 * pb * (np + 8) * 2 +
         2 * lmax * (2 * (np + 8) + pb + 8) * 2;
}

template <int LMAX, int PB, int NP>
__global__ void __launch_bounds__(TC_THREADS)
ssd_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ C, const float* __restrict__ Dv,
             bf16* __restrict__ y, float* __restrict__ state, const SsdParams p) {
  constexpr int LDN = NP + 8;   // shared row stride of C, B and h (elements)
  constexpr int LDX = PB + 8;   // shared row stride of x
  constexpr int NK = NP / 16;   // k-steps of C.B^T and C.h^T
  constexpr int QT = PB / 16;   // 16-row q tiles of the state
  constexpr int NPARTS = TC_WARPS / QT < NP / 16 ? TC_WARPS / QT : NP / 16;
  constexpr int HT = NP / 8 / NPARTS;  // 8-wide n tiles of the state a warp owns
  constexpr int MT = LMAX / 16;        // 16-row tiles of a chunk
  constexpr int DPER = LMAX / 32;      // steps a lane scans
  constexpr int STAGE = LMAX * (2 * LDN + LDX);
  static_assert(TC_WARPS % QT == 0 && HT % 2 == 0 && LMAX % 32 == 0, "block shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* const sEG = reinterpret_cast<float*>(smem_raw);  // [2] exp(G) of each set
  float2* const sG0 = reinterpret_cast<float2*>(smem_raw + 16);  // [2][LMAX]
  float* const sEg0 = reinterpret_cast<float*>(sG0 + 2 * LMAX);  // [2][LMAX]
  float* const sW0 = sEg0 + 2 * LMAX;
  float* const sDt0 = sW0 + 2 * LMAX;
  float* const sF0 = sDt0 + 2 * LMAX;
  bf16* sHhi = reinterpret_cast<bf16*>(smem_raw + 16 + 2 * LMAX * kScanBytesPerStep);
  bf16* sHlo = sHhi + PB * LDN;
  bf16* const stage0 = sHlo + PB * LDN;

  const int r = lane >> 2, cc = (lane & 3) * 2;  // accumulator row and column pair
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h], dcoef = Dv[h];
  const bf16* xb = x + b * p.x_b + h * p.x_h + p0;
  const bf16* dtb = dt + b * p.dt_b + h * p.dt_h;
  const bf16* Bb = Bm + b * p.bm_b;
  const bf16* Cb = C + b * p.c_b;
  const int64_t y_row = static_cast<int64_t>(p.H) * p.P;  // y is contiguous (B, S, H, P)
  bf16* yb = y + static_cast<int64_t>(b) * p.S * y_row + static_cast<int64_t>(h) * p.P + p0;
  const int L = p.L;
  const int mt_n = (L + 15) / 16;  // row tiles of a chunk that hold steps
  const int n_chunks = (p.S + L - 1) / L;

  // ldmatrix lane offsets. Non-transposed x4 on [row][k] storage gives b0, b1
  // of two 8-row tiles (K2's K); transposed x4 on [k][col] storage gives b0,
  // b1 of two 8-column tiles (K2's V); a_*: the A fragment of the transpose
  // of a [k][row] block.
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;
  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8, a_col = ((lane >> 3) & 1) * 8;

  // all LMAX rows of a stage: rows past the chunk's steps are zeros
  auto load_chunk = [&](int c, int stage) {
    bf16* sC = stage0 + stage * STAGE;
    bf16* sB = sC + LMAX * LDN;
    bf16* sX = sB + LMAX * LDN;
    const int64_t t0 = static_cast<int64_t>(c) * L;
    const int len = min(L, p.S - c * L);
    constexpr int CH = NP / 8;  // 16-byte chunks of a C or B row
#pragma unroll
    for (int e = tid; e < LMAX * CH; e += TC_THREADS) {
      const int s = e / CH, k = (e % CH) * 8;
      const bool ok = s < len && k < p.N;
      cp_async16(smem_u32(sC + s * LDN + k), ok ? Cb + (t0 + s) * p.c_s + k : Cb, ok);
      cp_async16(smem_u32(sB + s * LDN + k), ok ? Bb + (t0 + s) * p.bm_s + k : Bb, ok);
    }
    constexpr int XCH = PB / 8;
#pragma unroll
    for (int e = tid; e < LMAX * XCH; e += TC_THREADS) {
      const int s = e / XCH, k = (e % XCH) * 8;
      const bool ok = s < len;
      cp_async16(smem_u32(sX + s * LDX + k), ok ? xb + (t0 + s) * p.x_s + k : xb, ok);
    }
  };
  float dtv[DPER];  // dt at s = lane + 32 i of the next chunk to scan
  auto load_dt = [&](int c) {
    const int64_t t0 = static_cast<int64_t>(c) * L;
    const int len = min(L, p.S - c * L);
#pragma unroll
    for (int i = 0; i < DPER; ++i) {
      const int s = lane + 32 * i;
      dtv[i] = s < len ? __bfloat162float(dtb[(t0 + s) * p.dt_s]) : 0.f;
    }
  };

  const int qt = warp % QT, part = warp / QT;
  const bool owns_h = part < NPARTS;
  const int hq0 = qt * 16, hn0 = part * HT * 8;  // this warp's tile of the state
  float hacc[HT][4];
#pragma unroll
  for (int j = 0; j < HT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;

  // g = inclusive scan of a dt of the chunk in dtv (each product in f32, the
  // sums in f64) and the per-step rows of it, into set `set`; one warp, warp
  // 0, scans chunk c + 1 during chunk c, after its row tile (the shortest).
  // g_t - g_s is taken later from the f32 hi + lo pairs of g log2(e), to the
  // precision of the f64 difference.
  auto scan = [&](int set) {
    double carry = 0.0, g[DPER];
#pragma unroll
    for (int i = 0; i < DPER; ++i) {
      double v = static_cast<double>(a * dtv[i]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      g[i] = v + carry;
      carry = __shfl_sync(0xffffffffu, g[i], 31);
    }
    const double G = carry;  // g at s = LMAX - 1: dt is 0 past the chunk's steps
#pragma unroll
    for (int i = 0; i < DPER; ++i) {
      const int s = lane + 32 * i, k = set * LMAX + s;
      const double g2 = g[i] * 1.4426950408889634;
      const float g2_hi = static_cast<float>(g2);
      const double g_r = __shfl_sync(0xffffffffu, g[i], lane | 7);
      sG0[k] = make_float2(g2_hi, static_cast<float>(g2 - g2_hi));
      sEg0[k] = expf(static_cast<float>(g[i]));
      sW0[k] = expf(static_cast<float>(G - g[i])) * dtv[i];
      sDt0[k] = dtv[i];
      sF0[k] = expf(static_cast<float>(g_r - g[i])) * dtv[i];
    }
    if (lane == 0) sEG[set] = expf(static_cast<float>(G));
  };

  load_chunk(0, 0);
  cp_async_commit();
  if (warp == 0) {
    load_dt(0);
    scan(0);
    if (n_chunks > 1) load_dt(1);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int64_t t0 = static_cast<int64_t>(c) * L;
    const int len = min(L, p.S - c * L);

    // chunk c has landed for every thread, its per-step rows are written,
    // and every warp is done with chunk c - 1, whose stage chunk c + 1 takes
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();

    const bf16* sC = stage0 + (c & 1) * STAGE;
    const bf16* sB = sC + LMAX * LDN;
    const bf16* sX = sB + LMAX * LDN;
    const float2* sG = sG0 + (c & 1) * LMAX;
    const float* sEg = sEg0 + (c & 1) * LMAX;
    const float* sW = sW0 + (c & 1) * LMAX;
    const float* sDt = sDt0 + (c & 1) * LMAX;
    const float* sF = sF0 + (c & 1) * LMAX;

    for (int mt = warp; mt < mt_n; mt += TC_WARPS) {
      with_tile<MT>(mt < TC_WARPS ? mt : mt_n + TC_WARPS - 1 - mt, [&](auto tile) {
        constexpr int M = decltype(tile)::value;
        const int tr0 = M * 16 + r;  // this thread's rows: tr0 and tr0 + 8

        uint32_t cf[NK][4];  // C rows of the tile: the A operand of C.h^T and C.B^T
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          ldsm_x4(cf[kk], smem_u32(sC + (M * 16 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8));

        // y = exp(g_t) C_t . h_in, zero in the first chunk. h's hi and lo
        // parts, and S's below, go to separate accumulators (more chains
        // in flight)
        float yacc[PB / 8][4], ylo[PB / 8][4];
#pragma unroll
        for (int j = 0; j < PB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[j][e] = ylo[j][e] = 0.f;
        if (c > 0) {
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
#pragma unroll
            for (int qp = 0; qp < PB / 16; ++qp) {
              uint32_t bh[4], bl[4];
              const int off = (qp * 16 + k_row) * LDN + kk * 16 + k_col;
              ldsm_x4(bh, smem_u32(sHhi + off));
              ldsm_x4(bl, smem_u32(sHlo + off));
              mma_bf16(yacc[2 * qp], cf[kk], bh[0], bh[1]);
              mma_bf16(ylo[2 * qp], cf[kk], bl[0], bl[1]);
              mma_bf16(yacc[2 * qp + 1], cf[kk], bh[2], bh[3]);
              mma_bf16(ylo[2 * qp + 1], cf[kk], bl[2], bl[3]);
            }
          const float e0 = sEg[tr0], e1 = sEg[tr0 + 8];
#pragma unroll
          for (int j = 0; j < PB / 8; ++j) {
            yacc[j][0] = (yacc[j][0] + ylo[j][0]) * e0;
            yacc[j][1] = (yacc[j][1] + ylo[j][1]) * e0;
            yacc[j][2] = (yacc[j][2] + ylo[j][2]) * e1;
            yacc[j][3] = (yacc[j][3] + ylo[j][3]) * e1;
#pragma unroll
            for (int e = 0; e < 4; ++e) ylo[j][e] = 0.f;
          }
        }

        // scores S[t][s] = (C_t . B_s) 2^(g_t log2 e - g_s log2 e) dt_s on
        // the s tiles up to the diagonal; in the two diagonal tiles s > t is
        // selected to 0
        constexpr int ST = 2 * (M + 1);
        float sc[ST][4];
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int sp = 0; sp <= M; ++sp) {
            uint32_t kf[4];
            ldsm_x4(kf, smem_u32(sB + (sp * 16 + k_row) * LDN + kk * 16 + k_col));
            mma_bf16(sc[2 * sp], cf[kk], kf[0], kf[1]);
            mma_bf16(sc[2 * sp + 1], cf[kk], kf[2], kf[3]);
          }
        const float2 gt0 = sG[tr0], gt1 = sG[tr0 + 8];
#pragma unroll
        for (int j = 0; j < ST; ++j) {
          const int s = 8 * j + cc;
          if (j < 2 * M) {  // wholly below the diagonal, t > r >= s: exp(g_t - g_r) f_s
            const float2 gr = sG[8 * j + 7];
            const float r0 = exp2_approx((gt0.x - gr.x) + (gt0.y - gr.y));
            const float r1 = exp2_approx((gt1.x - gr.x) + (gt1.y - gr.y));
            const float2 f = *reinterpret_cast<const float2*>(sF + s);
            sc[j][0] *= r0 * f.x;
            sc[j][1] *= r0 * f.y;
            sc[j][2] *= r1 * f.x;
            sc[j][3] *= r1 * f.y;
            continue;
          }
          const float2 gs0 = sG[s], gs1 = sG[s + 1];
          const float d0 = sDt[s], d1 = sDt[s + 1];
          float v[4] = {sc[j][0] * exp2_approx((gt0.x - gs0.x) + (gt0.y - gs0.y)) * d0,
                        sc[j][1] * exp2_approx((gt0.x - gs1.x) + (gt0.y - gs1.y)) * d1,
                        sc[j][2] * exp2_approx((gt1.x - gs0.x) + (gt1.y - gs0.y)) * d0,
                        sc[j][3] * exp2_approx((gt1.x - gs1.x) + (gt1.y - gs1.y)) * d1};
          if (j >= 2 * M) {  // a diagonal tile (compile-time)
            v[0] = s <= tr0 ? v[0] : 0.f;
            v[1] = s + 1 <= tr0 ? v[1] : 0.f;
            v[2] = s <= tr0 + 8 ? v[2] : 0.f;
            v[3] = s + 1 <= tr0 + 8 ? v[3] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = v[e];
        }

        // y += S x, S as hi + lo: s tiles 2 kt and 2 kt + 1 are the A
        // fragment of k-step kt
#pragma unroll
        for (int kt = 0; kt <= M; ++kt) {
          uint32_t ah[4], al[4];
          split2(sc[2 * kt][0], sc[2 * kt][1], ah[0], al[0]);
          split2(sc[2 * kt][2], sc[2 * kt][3], ah[1], al[1]);
          split2(sc[2 * kt + 1][0], sc[2 * kt + 1][1], ah[2], al[2]);
          split2(sc[2 * kt + 1][2], sc[2 * kt + 1][3], ah[3], al[3]);
#pragma unroll
          for (int dp = 0; dp < PB / 16; ++dp) {
            uint32_t vf[4];
            ldsm_x4_trans(vf, smem_u32(sX + (kt * 16 + v_row) * LDX + dp * 16 + v_col));
            mma_bf16(yacc[2 * dp], ah, vf[0], vf[1]);
            mma_bf16(ylo[2 * dp], al, vf[0], vf[1]);
            mma_bf16(yacc[2 * dp + 1], ah, vf[2], vf[3]);
            mma_bf16(ylo[2 * dp + 1], al, vf[2], vf[3]);
          }
        }

        // y += D x; rows past the chunk's steps are not written
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = tr0 + 8 * half;
          if (t >= len) continue;
#pragma unroll
          for (int j = 0; j < PB / 8; ++j) {
            const int q = 8 * j + cc;
            const uint32_t xv = *reinterpret_cast<const uint32_t*>(sX + t * LDX + q);
            *reinterpret_cast<uint32_t*>(yb + (t0 + t) * y_row + q) = pack_bf16(
                yacc[j][2 * half] + ylo[j][2 * half] + dcoef * bf_lo(xv),
                yacc[j][2 * half + 1] + ylo[j][2 * half + 1] + dcoef * bf_hi(xv));
          }
        }
      });
    }

    if (warp == 0 && c + 1 < n_chunks) {  // set (c + 1) & 1 was last read in chunk c - 1
      scan((c + 1) & 1);
      if (c + 2 < n_chunks) load_dt(c + 2);
    }

    // h = exp(G) h + (x w)^T B on this warp's (16 q, HT * 8 n) tile, with
    // x w (f32) as hi + lo; rows past the chunk's steps are zeros
    if (owns_h) {
      const float eG = sEG[c & 1];
#pragma unroll
      for (int j = 0; j < HT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= eG;
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
        uint32_t xa[4];  // x^T: rows q, columns s
        ldsm_x4_trans(xa, smem_u32(sX + (kt * 16 + a_row) * LDX + hq0 + a_col));
        const int s = kt * 16 + cc;
        const float w0 = sW[s], w1 = sW[s + 1], w8 = sW[s + 8], w9 = sW[s + 9];
        uint32_t ah[4], al[4];
        split2(bf_lo(xa[0]) * w0, bf_hi(xa[0]) * w1, ah[0], al[0]);
        split2(bf_lo(xa[1]) * w0, bf_hi(xa[1]) * w1, ah[1], al[1]);
        split2(bf_lo(xa[2]) * w8, bf_hi(xa[2]) * w9, ah[2], al[2]);
        split2(bf_lo(xa[3]) * w8, bf_hi(xa[3]) * w9, ah[3], al[3]);
#pragma unroll
        for (int jp = 0; jp < HT / 2; ++jp) {
          uint32_t bfr[4];
          ldsm_x4_trans(bfr, smem_u32(sB + (kt * 16 + v_row) * LDN + hn0 + jp * 16 + v_col));
          mma_bf16(hacc[2 * jp], ah, bfr[0], bfr[1]);
          mma_bf16(hacc[2 * jp + 1], ah, bfr[2], bfr[3]);
          mma_bf16(hacc[2 * jp], al, bfr[0], bfr[1]);
          mma_bf16(hacc[2 * jp + 1], al, bfr[2], bfr[3]);
        }
      }
    }
    if (c + 1 < n_chunks) {
      __syncthreads();  // every warp has read h_in
      if (owns_h) {
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int n = hn0 + 8 * j + cc;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t hi, lo;
            split2(hacc[j][2 * half], hacc[j][2 * half + 1], hi, lo);
            const int off = (hq0 + r + 8 * half) * LDN + n;
            *reinterpret_cast<uint32_t*>(sHhi + off) = hi;
            *reinterpret_cast<uint32_t*>(sHlo + off) = lo;
          }
        }
      }
    }
  }

  if (owns_h) {
    float* st = state + ((static_cast<int64_t>(b) * p.H + h) * p.P + p0 + hq0) * p.N;
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const int n = hn0 + 8 * j + cc;
      if (n >= p.N) continue;  // columns of the padding to NP
      *reinterpret_cast<float2*>(st + r * p.N + n) = make_float2(hacc[j][0], hacc[j][1]);
      *reinterpret_cast<float2*>(st + (r + 8) * p.N + n) = make_float2(hacc[j][2], hacc[j][3]);
    }
  }
}

template <int LMAX, int PB, int NP>
cudaError_t launch_bf16(const void* x, const void* dt, const float* A, const void* Bm,
                        const void* C, const float* D, void* y, float* state,
                        const SsdParams& p, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes(LMAX, PB, NP);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_bf16<LMAX, PB, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.P / PB, p.H, p.B);
  ssd_fwd_bf16<LMAX, PB, NP><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt), A,
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(C), D, static_cast<bf16*>(y),
      state, p);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const float*, const void*,
                                 const void*, const float*, void*, float*, const SsdParams&,
                                 cudaStream_t);

// N rounded up to 16, 32, 64 or 128
template <int LMAX, int PB>
Launcher for_state_width(int N) {
  if (N <= 16) return launch_bf16<LMAX, PB, 16>;
  if (N <= 32) return launch_bf16<LMAX, PB, 32>;
  if (N <= 64) return launch_bf16<LMAX, PB, 64>;
  return launch_bf16<LMAX, PB, 128>;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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
ssd_fwd_f32(const T* __restrict__ x, const T* __restrict__ dt,
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

cudaError_t launch_f32(const void* x, const void* dt, const float* A, const void* Bm,
                       const void* C, const float* D, void* y, float* state, const SsdParams& p,
                       cudaStream_t stream) {
  const int64_t bytes = repro_ssd_smem_bytes(p.L, p.P, p.N);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;  // the chunk is too long at this P, N
  err = cudaFuncSetAttribute(
      ssd_fwd_f32<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B);
  ssd_fwd_f32<float><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), A,
      static_cast<const float*>(Bm), static_cast<const float*>(C), D, static_cast<float*>(y),
      state, p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

cudaError_t repro_ssd_scan_fwd(const void* x, const void* dt, const float* A, const void* Bm,
                               const void* C, const float* D, void* y, float* state,
                               const SsdParams& p, int dtype, cudaStream_t stream) {
  if (p.B <= 0 || p.S <= 0 || p.H <= 0 || p.P <= 0 || p.N <= 0 || p.L <= 0 || p.L > p.S ||
      p.H > 65535 || p.B > 65535)
    return cudaErrorInvalidValue;
  if (dtype == REPRO_F32) return launch_f32(x, dt, A, Bm, C, D, y, state, p, stream);
  if (dtype != REPRO_BF16) return cudaErrorInvalidValue;
  // the shapes the tensor-core kernel takes (the wrapper's _plan checks too)
  if (p.P % 16 != 0 || p.N % 8 != 0 || p.N > NMAX || p.L > REPRO_SSD_TC_MAX_CHUNK)
    return cudaErrorInvalidValue;
  // 16-byte copies of x, B and C rows (strides of size-1 dims are 0)
  if (!aligned16(x) || !aligned16(Bm) || !aligned16(C) || !aligned16(y) ||
      (p.x_b | p.x_s | p.x_h | p.bm_b | p.bm_s | p.c_b | p.c_s) % 8 != 0)
    return cudaErrorMisalignedAddress;
  const bool pb32 = p.P % 32 == 0;
  const Launcher fn = p.L <= 64 ? (pb32 ? for_state_width<64, 32>(p.N) : for_state_width<64, 16>(p.N))
                                : (pb32 ? for_state_width<128, 32>(p.N)
                                        : for_state_width<128, 16>(p.N));
  return fn(x, dt, A, Bm, C, D, y, state, p, stream);
}
