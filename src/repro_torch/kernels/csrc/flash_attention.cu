// Flash-attention forward and bf16 backward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_fwd (_flash_fwd_kernel): GQA attention with an online
// softmax, causal with the queries at absolute positions q_offset + i,
// returning out (q's type) and lse = m + log(l) in f32. Query head h reads
// kv head h / (Hq / Hkv) in place, with no K/V copy. Head sizes
// D in {16, 24, 32, 64, 80, 128, 160}, q/k/v strided views whose last dim is
// contiguous.
//
// Bound on this card: at the full-sequence forward's shapes (S = T = 512,
// D = 128, causal) the work is about 4 * D * S * (S + 1) / 2 flops per head
// against 2 * D bytes per q/k/v/out row: ~200 flops a byte, just under the
// ~295 where the bf16 tensor cores become the limit, so an ideal kernel is
// bound by the bytes and close to the line.
//
// The TPU grid walks (b, h, q-block) in parallel and the kv blocks in
// sequence, carrying (m, l, acc) in VMEM scratch across grid steps. Here one
// block owns (b, h, one q tile) and loops over 64-key tiles itself, so the
// running state lives in registers. Two kernels, one per input type:
//
// bf16, the model's type: tensor cores (flash_fwd_bf16).
//   * 4 warps of 16 query rows each (BQ = 64). 8 warps (BQ = 128) was slower
//     at the forward's shape and at D = 80 and 160 (PERF.md). At about 250
//     registers a thread, 2 blocks fit an SM. At D = 160 it spills 32 bytes
//     (ptxas); fewer warps would not help, since a thread's registers hold
//     its warp's 16 rows whatever BQ is. A warp owns its rows: both
//     products are mma.sync.m16n8k16 bf16 -> f32, and the row max and row sum
//     take two quad shuffles, with no exchange through shared memory.
//   * Q is copied once (cp.async) and ldmatrix'ed into A fragments that stay
//     in registers for the whole key loop.
//   * K/V tiles of 64 keys are copied with 16-byte cp.async, in bf16 as
//     stored, into a 2-stage ring. K and V are separate copy groups: K of
//     tile t + 1 is issued before tile t's Q K^T, V of tile t + 1 before its
//     P V. The Q tile shares stage 1 until its fragments are loaded.
//   * Shared rows are padded by 16 bytes (row stride = 4 mod 8 words), so the
//     8 rows that one ldmatrix reads fall on 8 distinct bank quads. V is read
//     with ldmatrix.trans as the B operand of P V.
//   * Softmax in log2 units: the row max is taken on the unscaled scores and
//     p = 2^(s * scale * log2(e) - m) is one FFMA and one ex2.
//   * P stays in registers: the S accumulator fragment, exponentiated and
//     rounded to bf16, is P V's A fragment. That rounding is the only one the
//     plain version does not make (about 2^-9 of out); l sums the f32 values,
//     so lse keeps f32 row statistics.
//   * D = 24 is padded to a k-depth of 32: columns 24..31 of Q and K are
//     zero-filled in shared memory (cp.async with src-size 0), as are keys at
//     or past T and query rows past S.
// f32, the port's parity type: CUDA cores (flash_fwd_f32). A TF32 product
//   would miss the 2e-5 bound the JAX tests hold, so its dots run in f32:
//   thread (rg = tid / 8, cg = tid % 8) owns query rows rg + 16 i (i < 4),
//   score columns cg + 8 j (j < 8) and output columns cg + 8 j (j < D / 8);
//   Q and K sit in shared memory d-major (padded by one float), V key-major.
//
// Masking, both kernels: scores of keys at or past T, and causal scores of
// keys past the row's position, are -inf; the running max starts at the
// finite -1e30, so exp never sees (-inf) - (-inf). With causal and
// q_offset >= 0 key 0 is visible to every row, so l > 0 for every real row.
// Key tiles wholly in the future are never loaded, and causal q tiles launch
// longest first. The bf16 kernel masks only the tiles that cross the
// diagonal or T.
//
// Backward, bf16 only (the JAX package's _fa_bwd is the VJP of the plain
// version, which the port keeps for f32; this replaces no TPU kernel). It
// takes the forward's out and lse and never writes a score to device memory.
// Bound: about 2.5x the forward's operations (S, dP, dV, dK, dQ: five
// products against two) over the same bytes plus dO, dQ, dK, dV, so the
// tensor cores rather than the bytes at the train cells' shapes (S = T =
// 2048: ~1,000 flops a byte). Three kernels, each named flash_bwd_*:
//   * flash_bwd_prep: delta = rowsum(dO * O) and lse2 = lse * log2(e), f32,
//     into a scratch of S_pad rows a head (rows past S: delta 0, lse2 +inf,
//     so their P is 0), one group of lanes a row.
//   * flash_bwd_dkdv: one block owns (b, kv head, 64-key tile) and walks
//     every q head of its GQA group and every q tile that sees the tile
//     (causal: from the diagonal on; key tile 0, the longest, launches
//     first). Each warp owns 16 keys: S^T = K Q^T and dP^T = V dO^T with the
//     keys as mma rows, P^T = 2^(S^T scale log2(e) - lse2), dS^T =
//     P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T turned from accumulator fragments into bf16 A fragments, as the
//     forward turns S into P. dK and dV stay in f32 registers for the whole
//     walk, so a group's sum needs no atomics and no second buffer. Q, dO and
//     the tile's lse2 and delta come through a 2-stage cp.async ring; K and V
//     sit in shared memory and are ldmatrix'ed per use.
//   * flash_bwd_dq: one block owns (b, q head, 64-row tile), as the forward:
//     Q's A fragments in registers, dO's ldmatrix'ed at each use, K/V tiles
//     through the ring, S = Q K^T and dP = dO V^T, dS as above, dQ += dS K
//     (K with ldmatrix.trans).
//   Two passes, not one with f32 atomics on dQ, so that the gradients repeat
//   bit for bit. P and dS are rounded to bf16 only as operands of the next
//   product; delta, the row statistics and every accumulator are f32. The
//   q tile of dK/dV and the key tile of dQ shrink as D grows (BwdCfg), so
//   that no kernel spills. Keys past T only reach dK/dV rows never stored,
//   so dK/dV masks only the tiles that cross the diagonal; dQ also masks
//   keys past T.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "launch.h"

namespace {

constexpr int BK = 64;  // keys per tile
constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Key tiles of bk keys a q tile of rows [q0, q0 + bq) visits: causal stops at
// the last row's position.
__device__ __forceinline__ int key_tiles(const FlashParams& p, int q0, int bq, int bk = BK) {
  int kv_end = p.T;
  if (p.causal) kv_end = min(p.T, p.q_offset + min(q0 + bq, p.S));
  return (kv_end + bk - 1) / bk;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // of 16 query rows each

template <int D>
struct TcCfg {
  static constexpr int DP = (D + 15) / 16 * 16;  // k-depth of Q K^T, width of O
  static constexpr int LD = DP + 8;              // shared row stride (elements)
  static constexpr int BQ = 16 * kWarps;
  static constexpr int THREADS = 32 * kWarps;
  static constexpr int TILE = BK * LD;           // elements of one K or V tile
  static constexpr int SMEM_BYTES = 4 * TILE * 2;  // K0 V0 K1 V1
  static_assert(BQ * LD <= 2 * TILE, "the Q tile must fit in stage 1");
  static_assert(D % 8 == 0, "rows are copied in 16-byte chunks");
};

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

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, round to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies rows [row0, row0 + ROWS) of a (rows, D) operand with row stride
// `stride` into shared memory at row stride LD; rows at or past `n_rows` and
// the columns past D read as zeros. Every kernel here runs TcCfg's THREADS.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int64_t stride, int row0,
                                          int n_rows, int tid) {
  using C = TcCfg<D>;
  constexpr int CH = C::DP / 8;  // 16-byte chunks per shared row
  constexpr int N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + C::THREADS - 1) / C::THREADS; ++i) {
    const int e = tid + i * C::THREADS;
    if (N % C::THREADS != 0 && e >= N) break;
    const int r = e / CH, c = e % CH;
    const bool ok = row0 + r < n_rows && c * 8 < D;
    const bf16* src = ok ? g + static_cast<int64_t>(row0 + r) * stride + c * 8 : g;
    cp_async16(smem_u32(s + r * C::LD + c * 8), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, const FlashParams p) {
  using C = TcCfg<D>;
  constexpr int KSTEPS = C::DP / 16;  // k-steps of Q K^T; also pairs of O tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* const sQ = smem + 2 * C::TILE;  // stage 1, until the Q fragments load

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;  // longest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const bf16* qb = q + b * p.q.b + h * p.q.h;
  const bf16* kb = k + b * p.k.b + hk * p.k.h;
  const bf16* vb = v + b * p.v.b + hk * p.v.h;
  const int n_tiles = key_tiles(p, q0, C::BQ);

  // copy groups, in order: [Q, K0] [V0], then [K(t + 1)] [V(t + 1)] in
  // iteration t (empty past the last tile), so waiting for all but the newest
  // group finds K(t) at the top of iteration t and V(t) before P V
  load_rows<D, C::BQ>(sQ, qb, p.q.s, q0, p.S, tid);
  load_rows<D, BK>(smem, kb, p.k.s, 0, p.T, tid);
  cp_async_commit();
  load_rows<D, BK>(smem + C::TILE, vb, p.v.s, 0, p.T, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // A fragments of this warp's 16 rows: lanes 0-15 address rows 0-15 at
  // column 0 of the k-step, lanes 16-31 the same rows at column 8. A negative
  // sm_scale flips Q's sign (exact in bf16), so that the softmax takes the
  // row max of the unscaled scores.
  const uint32_t q_sign = p.sm_scale < 0.f ? 0x80008000u : 0u;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldsm_x4(qf[kk], smem_u32(sQ + (warp * 16 + (lane & 15)) * C::LD + kk * 16 +
                             (lane >> 4) * 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) qf[kk][e] ^= q_sign;
  }

  // Accumulator fragments: this thread holds rows r0 = lane / 4 and r0 + 8 of
  // the warp's 16, columns 2 (lane % 4) and + 1 of each 8-wide tile.
  float o[2 * KSTEPS][4];
#pragma unroll
  for (int j = 0; j < 2 * KSTEPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};  // m in log2 units
  const float scale = fabsf(p.sm_scale) * kLog2e;
  const int warp_row0 = q0 + warp * 16;
  const int qpos0 = p.q_offset + warp_row0 + (lane >> 2);  // position of row r0
  const int col0 = (lane & 3) * 2;

  // ldmatrix lane offsets. K (x4): matrices (keys 0-7, d 0-7), (keys 0-7,
  // d 8-15), (keys 8-15, d 0-7), (keys 8-15, d 8-15) = b0, b1 of two key
  // tiles. V (x4.trans): (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7,
  // d 8-15), (keys 8-15, d 8-15) = b0, b1 of two d tiles.
  const int k_lane = ((lane >> 4) * 8 + (lane & 7)) * C::LD + ((lane >> 3) & 1) * 8;
  const int v_lane = (((lane >> 3) & 1) * 8 + (lane & 7)) * C::LD + (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const bf16* sK = smem + (t & 1) * 2 * C::TILE;
    const bf16* sV = sK + C::TILE;
    bf16* nK = smem + ((t + 1) & 1) * 2 * C::TILE;  // tile t + 1's stage
    const bool more = t + 1 < n_tiles;
    // K(t) has landed for every thread, and every warp is done with tile
    // t - 1 (or the Q tile), whose stage tile t + 1 takes
    cp_async_wait<1>();
    __syncthreads();
    if (more) load_rows<D, BK>(nK, kb, p.k.s, (t + 1) * BK, p.T, tid);
    cp_async_commit();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_u32(sK + np * 16 * C::LD + kk * 16 + k_lane));
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // online softmax on the unscaled scores: p = 2^(s * scale - m)
    const int k0 = t * BK;
    if (k0 + BK > p.T || (p.causal && k0 + BK - 1 > p.q_offset + warp_row0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + col0 + (e & 1);
          if (key >= p.T || (p.causal && key > qpos0 + 8 * (e >> 1))) s[j][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], neg_m[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale);  // finite: m starts at -1e30
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(fmaf(s[j][e], scale, neg_m[e >> 1]));  // 0 if masked
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * KSTEPS; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // V(t) has landed for every thread; V(t + 1) goes to the stage whose
    // last reader, P V of tile t - 1, every warp finished before the top
    cp_async_wait<1>();
    __syncthreads();
    if (more) load_rows<D, BK>(nK + C::TILE, vb, p.v.s, (t + 1) * BK, p.T, tid);
    cp_async_commit();

    // P V: key tiles 2 kt and 2 kt + 1 of S are the A fragment of k-step kt
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                              pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KSTEPS; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_u32(sV + kt * 16 * C::LD + dp * 16 + v_lane));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  const int64_t head = static_cast<int64_t>(b) * p.Hq + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = warp_row0 + (lane >> 2) + 8 * r;
    if (qi >= p.S) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
    bf16* orow = out + (head * p.S + qi) * D;
#pragma unroll
    for (int j = 0; j < 2 * KSTEPS; ++j)
      if (j * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + col0) =
            pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if ((lane & 3) == 0) lse[head * p.S + qi] = m[r] * kLn2 + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                        const FlashParams& p, cudaStream_t stream) {
  using C = TcCfg<D>;
  const int n_q = (p.S + C::BQ - 1) / C::BQ;
  if (n_q > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, p.B, n_q);
  flash_fwd_bf16<D><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 backward: tensor cores
// ---------------------------------------------------------------------------

// prep: lanes a row (a power of 2 holding D / 8 16-byte chunks) and rows a block
template <int D>
struct PrepCfg {
  static constexpr int CH = D / 8;
  static constexpr int L = CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  static constexpr int ROWS = 32 / L * kWarps;
};

// Tiles of the two main kernels: each warp owns 16 rows of its block (keys
// in dK/dV, queries in dQ); the other side's tile, BQ queries an iteration
// of dK/dV and BKQ keys a tile of dQ, is a template parameter, and BwdCfg
// picks it by D: the fastest at D = 64 and 128 (PERF.md) of those whose
// f32 accumulators (D / 2 floats of each of dK and dV, or of dQ) and two
// score fragments (a tile / 4 floats each) fit 255 registers unspilled.
template <int D>
struct BwdCfg {
  static constexpr int TILE = D <= 80 ? 64 : 32;
};

constexpr int kBwdRows = 16 * kWarps;  // keys of a dK/dV block, queries of a dQ block

template <int D, int BQ>
constexpr int dkdv_smem() {  // K, V, then two stages of (Q, dO) rows and (lse2, delta)
  return (2 * kBwdRows + 4 * BQ) * TcCfg<D>::LD * 2 + 4 * BQ * 4;
}

template <int D, int BKQ>
constexpr int dq_smem() {  // Q, dO, then two stages of (K, V)
  return (2 * kBwdRows + 4 * BKQ) * TcCfg<D>::LD * 2;
}

// lse2 = lse * log2(e) and delta = rowsum(dO * O) in f32, (B, Hq, S_pad);
// rows past S get lse2 = +inf (so their P is 0) and delta = 0.
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_prep(const bf16* __restrict__ out, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float* __restrict__ delta, const FlashBwdParams bp) {
  using C = PrepCfg<D>;
  const FlashParams& p = bp.f;
  const int tid = threadIdx.x, c = threadIdx.x % C::L;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * C::ROWS + tid / C::L;
  const int64_t heads = static_cast<int64_t>(p.B) * p.Hq;
  const int64_t bh = row / bp.S_pad;
  const int i = static_cast<int>(row % bp.S_pad);
  float acc = 0.f;
  if (bh < heads && i < p.S && c < C::CH) {
    const int b = static_cast<int>(bh / p.Hq), h = static_cast<int>(bh % p.Hq);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + b * bp.o.b + h * bp.o.h +
                                                     i * bp.o.s + c * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + b * bp.dout.b + h * bp.dout.h +
                                                     i * bp.dout.s + c * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]), g = __bfloat1622float2(g2[e]);
      acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
    }
  }
#pragma unroll
  for (int off = C::L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c == 0 && bh < heads) {
    delta[row] = acc;
    lse2[row] = i < p.S ? lse[bh * p.S + i] * kLog2e : INFINITY;
  }
}

// dK and dV of one (b, kv head, 64-key tile): every q head of the group and
// every q tile that sees a key of the tile, in sequence, with dK and dV in
// f32 registers throughout. Per iteration a warp (16 keys) forms
// S^T = K Q^T and dP^T = V dO^T, P^T = 2^(S^T scale log2(e) - lse2),
// dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q, P^T and
// dS^T going from the accumulator fragments to bf16 A fragments in registers.
template <int D, int BQ>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, const FlashBwdParams bp) {
  static_assert(REPRO_FLASH_BWD_ROW_PAD % BQ == 0, "lse2 / delta tiles lie in a head's rows");
  constexpr int KSTEPS = TcCfg<D>::DP / 16, NQ = BQ / 8, LD = TcCfg<D>::LD, BKV = kBwdRows;
  const FlashParams& p = bp.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* const sV = sK + BKV * LD;
  bf16* const sQ0 = sV + BKV * LD;  // stage s: Q at + 2 s BQ LD, dO BQ LD further
  float* const sL0 = reinterpret_cast<float*>(sQ0 + 4 * BQ * LD);  // lse2, delta a stage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;  // key tile 0, which every causal row sees, first
  const int group = p.Hq / p.Hkv;
  // causal: the rows from k0 - q_offset on see a key of the tile
  const int qt0 = p.causal && k0 > p.q_offset ? (k0 - p.q_offset) / BQ : 0;
  const int n_live = max((p.S + BQ - 1) / BQ - qt0, 0);
  const int n_iter = group * n_live;

  auto load_iter = [&](int it, int st) {
    const int h = hk * group + it / n_live, q0 = (qt0 + it % n_live) * BQ;
    bf16* sQ = sQ0 + st * 2 * BQ * LD;
    load_rows<D, BQ>(sQ, q + b * p.q.b + h * p.q.h, p.q.s, q0, p.S, tid);
    load_rows<D, BQ>(sQ + BQ * LD, dout + b * bp.dout.b + h * bp.dout.h, bp.dout.s, q0,
                        p.S, tid);
    constexpr int CH = BQ / 4;  // 16-byte chunks of BQ floats
    if (tid < 2 * CH) {
      const int64_t row = (static_cast<int64_t>(b) * p.Hq + h) * bp.S_pad + q0 + tid % CH * 4;
      cp_async16(smem_u32(sL0 + st * 2 * BQ + (tid / CH) * BQ + tid % CH * 4),
                 (tid < CH ? lse2 : delta) + row, true);
    }
  };

  load_rows<D, BKV>(sK, k + b * p.k.b + hk * p.k.h, p.k.s, k0, p.T, tid);
  load_rows<D, BKV>(sV, v + b * p.v.b + hk * p.v.h, p.v.s, k0, p.T, tid);
  if (n_iter > 0) load_iter(0, 0);
  cp_async_commit();

  float dk_acc[2 * KSTEPS][4], dv_acc[2 * KSTEPS][4];
#pragma unroll
  for (int j = 0; j < 2 * KSTEPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const float scale = p.sm_scale * kLog2e;
  const int col0 = (lane & 3) * 2;
  const int key_r0 = k0 + warp * 16 + (lane >> 2);  // this thread's first key; + 8 the other
  // A fragments of the warp's 16 keys (as Q's in the forward); B fragments
  // as the forward's K (k_lane) and V (v_lane, ldmatrix.trans)
  const int a_lane = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_lane = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    // this iteration's tiles have landed, and every warp is done with the
    // last one, whose stage the next takes
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_iter) load_iter(it + 1, st ^ 1);
    cp_async_commit();
    const bf16* sQ = sQ0 + st * 2 * BQ * LD;
    const bf16* sdO = sQ + BQ * LD;
    const float* sL = sL0 + st * 2 * BQ;
    const int q0 = (qt0 + it % n_live) * BQ;

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, smem_u32(sK + a_lane + kk * 16));
      ldsm_x4(vf, smem_u32(sV + a_lane + kk * 16));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(sQ + np * 16 * LD + kk * 16 + k_lane));
        mma_bf16(s[2 * np], kf, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], kf, bf[2], bf[3]);
        ldsm_x4(bf, smem_u32(sdO + np * 16 * LD + kk * 16 + k_lane));
        mma_bf16(dp[2 * np], vf, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], vf, bf[2], bf[3]);
      }
    }

    // column c of a fragment is query row q0 + c; only tiles that cross the
    // diagonal mask (keys past T only reach rows of dK and dV never stored)
    const bool crosses = p.causal && k0 + warp * 16 + 15 > p.q_offset + q0;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sL + j * 8 + col0);
      const float2 d2 = *reinterpret_cast<const float2*>(sL + BQ + j * 8 + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2_approx(fmaf(s[j][e], scale, -((e & 1) ? l2.y : l2.x)));
        if (crosses && key_r0 + 8 * (e >> 1) > p.q_offset + q0 + j * 8 + col0 + (e & 1))
          x = 0.f;
        s[j][e] = x;
        dp[j][e] = x * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }

    // dV += P^T dO, dK += dS^T Q: query tiles 2 kt and 2 kt + 1 of the
    // fragments are the A fragment of k-step kt
#pragma unroll
    for (int kt = 0; kt < NQ / 2; ++kt) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                              pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kt][0], dp[2 * kt][1]),
                              pack_bf16(dp[2 * kt][2], dp[2 * kt][3]),
                              pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
                              pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3])};
#pragma unroll
      for (int dd = 0; dd < KSTEPS; ++dd) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_u32(sdO + kt * 16 * LD + dd * 16 + v_lane));
        mma_bf16(dv_acc[2 * dd], pa, bf[0], bf[1]);
        mma_bf16(dv_acc[2 * dd + 1], pa, bf[2], bf[3]);
        ldsm_x4_trans(bf, smem_u32(sQ + kt * 16 * LD + dd * 16 + v_lane));
        mma_bf16(dk_acc[2 * dd], da, bf[0], bf[1]);
        mma_bf16(dk_acc[2 * dd + 1], da, bf[2], bf[3]);
      }
    }
  }

  const int64_t head = static_cast<int64_t>(b) * p.Hkv + hk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_r0 + 8 * r;
    if (key >= p.T) continue;
    bf16* krow = dk + (head * p.T + key) * D;
    bf16* vrow = dv + (head * p.T + key) * D;
#pragma unroll
    for (int j = 0; j < 2 * KSTEPS; ++j)
      if (j * 8 < D) {
        *reinterpret_cast<uint32_t*>(krow + j * 8 + col0) =
            pack_bf16(dk_acc[j][2 * r] * p.sm_scale, dk_acc[j][2 * r + 1] * p.sm_scale);
        *reinterpret_cast<uint32_t*>(vrow + j * 8 + col0) =
            pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
  }
}

// dQ of one (b, q head, 64-row tile) over the key tiles of BKQ keys before
// its kv_end: the forward's loop with dP = dO V^T beside S = Q K^T, then
// dQ += dS K (K read with ldmatrix.trans).
template <int D, int BKQ>
__global__ void __launch_bounds__(32 * kWarps)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             bf16* __restrict__ dq, const FlashBwdParams bp) {
  constexpr int KSTEPS = TcCfg<D>::DP / 16, NK = BKQ / 8, LD = TcCfg<D>::LD, BQD = kBwdRows;
  const FlashParams& p = bp.f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* const sdO = sQ + BQD * LD;
  bf16* const sKV0 = sdO + BQD * LD;  // stage s: K at + 2 s BKQ LD, V BKQ LD further

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQD;  // longest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const bf16* kb = k + b * p.k.b + hk * p.k.h;
  const bf16* vb = v + b * p.v.b + hk * p.v.h;
  const int n_tiles = key_tiles(p, q0, BQD, BKQ);

  load_rows<D, BQD>(sQ, q + b * p.q.b + h * p.q.h, p.q.s, q0, p.S, tid);
  load_rows<D, BQD>(sdO, dout + b * bp.dout.b + h * bp.dout.h, bp.dout.s, q0, p.S, tid);
  load_rows<D, BKQ>(sKV0, kb, p.k.s, 0, p.T, tid);
  load_rows<D, BKQ>(sKV0 + BKQ * LD, vb, p.v.s, 0, p.T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int a_lane = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qf[kk], smem_u32(sQ + a_lane + kk * 16));
  const int warp_row0 = q0 + warp * 16;
  const int qpos0 = p.q_offset + warp_row0 + (lane >> 2);  // position of row r0
  const int col0 = (lane & 3) * 2;
  float neg_l2[2], d_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = (static_cast<int64_t>(b) * p.Hq + h) * bp.S_pad + warp_row0 +
                        (lane >> 2) + 8 * r;
    neg_l2[r] = -lse2[row];
    d_row[r] = delta[row];
  }
  float dq_acc[2 * KSTEPS][4];
#pragma unroll
  for (int j = 0; j < 2 * KSTEPS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float scale = p.sm_scale * kLog2e;
  const int k_lane = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const bf16* sK = sKV0 + (t & 1) * 2 * BKQ * LD;
    const bf16* sV = sK + BKQ * LD;
    // K(t), V(t) have landed, and every warp is done with tile t - 1, whose
    // stage tile t + 1 takes
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      bf16* nK = sKV0 + ((t + 1) & 1) * 2 * BKQ * LD;
      load_rows<D, BKQ>(nK, kb, p.k.s, (t + 1) * BKQ, p.T, tid);
      load_rows<D, BKQ>(nK + BKQ * LD, vb, p.v.s, (t + 1) * BKQ, p.T, tid);
    }
    cp_async_commit();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t fo[4];  // dO's A fragment: held for the whole loop, it would spill
      ldsm_x4(fo, smem_u32(sdO + a_lane + kk * 16));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(sK + np * 16 * LD + kk * 16 + k_lane));
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        ldsm_x4(bf, smem_u32(sV + np * 16 * LD + kk * 16 + k_lane));
        mma_bf16(dp[2 * np], fo, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], fo, bf[2], bf[3]);
      }
    }

    // keys past T are masked too: a zero K row times an unbounded P would
    // not vanish from dQ
    const int k0 = t * BKQ;
    const bool edge =
        k0 + BKQ > p.T || (p.causal && k0 + BKQ - 1 > p.q_offset + warp_row0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2_approx(fmaf(s[j][e], scale, neg_l2[e >> 1]));
        const int key = k0 + 8 * j + col0 + (e & 1);
        if (edge && (key >= p.T || (p.causal && key > qpos0 + 8 * (e >> 1)))) x = 0.f;
        dp[j][e] = x * (dp[j][e] - d_row[e >> 1]);
      }

#pragma unroll
    for (int kt = 0; kt < NK / 2; ++kt) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kt][0], dp[2 * kt][1]),
                              pack_bf16(dp[2 * kt][2], dp[2 * kt][3]),
                              pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
                              pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3])};
#pragma unroll
      for (int dd = 0; dd < KSTEPS; ++dd) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_u32(sK + kt * 16 * LD + dd * 16 + v_lane));
        mma_bf16(dq_acc[2 * dd], da, bf[0], bf[1]);
        mma_bf16(dq_acc[2 * dd + 1], da, bf[2], bf[3]);
      }
    }
  }

  const int64_t head = static_cast<int64_t>(b) * p.Hq + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = warp_row0 + (lane >> 2) + 8 * r;
    if (qi >= p.S) continue;
    bf16* row = dq + (head * p.S + qi) * D;
#pragma unroll
    for (int j = 0; j < 2 * KSTEPS; ++j)
      if (j * 8 < D)
        *reinterpret_cast<uint32_t*>(row + j * 8 + col0) =
            pack_bf16(dq_acc[j][2 * r] * p.sm_scale, dq_acc[j][2 * r + 1] * p.sm_scale);
  }
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* scratch, const FlashBwdParams& bp, cudaStream_t stream) {
  constexpr int tile = BwdCfg<D>::TILE;
  constexpr int dkdv_bytes = dkdv_smem<D, tile>(), dq_bytes = dq_smem<D, tile>();
  const FlashParams& p = bp.f;
  const int n_k = (p.T + kBwdRows - 1) / kBwdRows, n_q = (p.S + kBwdRows - 1) / kBwdRows;
  if (n_k > 65535 || n_q > 65535) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(p.B) * p.Hq * bp.S_pad;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* gb = static_cast<const bf16*>(dout);
  flash_bwd_prep<D><<<(rows + PrepCfg<D>::ROWS - 1) / PrepCfg<D>::ROWS, 32 * kWarps, 0,
                      stream>>>(static_cast<const bf16*>(out), gb, lse, lse2, delta, bp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D, tile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<D, tile><<<dim3(p.Hkv, p.B, n_k), 32 * kWarps, dkdv_bytes, stream>>>(
      qb, kb, vb, gb, lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D, tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D, tile><<<dim3(p.Hq, p.B, n_q), 32 * kWarps, dq_bytes, stream>>>(
      qb, kb, vb, gb, lse2, delta, static_cast<bf16*>(dq), bp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;       // query rows per block
constexpr int THREADS32 = 128;  // 16 row groups x 8 column lanes
constexpr int RPT = BQ32 / 16;  // rows per thread
constexpr int CPT = BK / 8;     // score columns per thread

template <int D>
constexpr int smem_floats() {
  return D * (BQ32 + 1) + D * (BK + 1) + BK * D + BQ32 * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, const FlashParams p) {
  extern __shared__ float smem[];
  float* sQ = smem;                   // [D][BQ32 + 1]
  float* sK = sQ + D * (BQ32 + 1);    // [D][BK + 1]
  float* sV = sK + D * (BK + 1);      // [BK][D]
  float* sP = sV + BK * D;            // [BQ32][BK + 1]

  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ32;  // longest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qb = q + b * p.q.b + h * p.q.h;
  const float* kb = k + b * p.k.b + hk * p.k.h;
  const float* vb = v + b * p.v.b + hk * p.v.h;

  for (int e = tid; e < BQ32 * D; e += THREADS32) {
    const int r = e / D, d = e % D, qi = q0 + r;
    sQ[d * (BQ32 + 1) + r] = qi < p.S ? qb[qi * p.q.s + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][D / 8];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = key_tiles(p, q0, BQ32);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sK/sV reads are done
    for (int e = tid; e < BK * D; e += THREADS32) {
      const int c = e / D, d = e % D, kj = k0 + c;
      float kk = 0.f, vv = 0.f;
      if (kj < p.T) {
        kk = kb[kj * p.k.s + d];
        vv = vb[kj * p.v.s + d];
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
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[d * (BQ32 + 1) + rg + 16 * i];
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
    float* orow = out + (head * p.S + qi) * D;
#pragma unroll
    for (int dd = 0; dd < D / 8; ++dd) orow[cg + 8 * dd] = acc[i][dd] / l_safe;
    if (cg == 0) lse[head * p.S + qi] = m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       const FlashParams& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const int n_q = (p.S + BQ32 - 1) / BQ32;
  if (n_q > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, p.B, n_q);
  flash_fwd_f32<D><<<grid, THREADS32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, p);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const void*, const void*, void*, float*,
                                 const FlashParams&, cudaStream_t);
using BwdLauncher = cudaError_t (*)(const void*, const void*, const void*, const void*,
                                    const float*, const void*, void*, void*, void*, float*,
                                    const FlashBwdParams&, cudaStream_t);

// L<D>::fn for the head sizes the kernels take, nullptr for any other
template <template <int> class L>
auto for_head_dim(int D) -> std::remove_const_t<decltype(L<16>::fn)> {
  switch (D) {
    case 16: return L<16>::fn;
    case 24: return L<24>::fn;
    case 32: return L<32>::fn;
    case 64: return L<64>::fn;
    case 80: return L<80>::fn;
    case 128: return L<128>::fn;
    case 160: return L<160>::fn;
    default: return nullptr;
  }
}

template <int D>
struct Bf16Launcher {
  static constexpr Launcher fn = launch_bf16<D>;
};
template <int D>
struct F32Launcher {
  static constexpr Launcher fn = launch_f32<D>;
};
template <int D>
struct Bf16BwdLauncher {
  static constexpr BwdLauncher fn = launch_bwd<D>;
};

bool aligned16(const void* ptr, const AttnStrides& s) {
  // 8 bf16 elements = 16 bytes
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.s % 8 == 0;
}

bool valid_shape(const FlashParams& p) {
  return p.B > 0 && p.Hq > 0 && p.Hkv > 0 && p.Hq % p.Hkv == 0 && p.S > 0 && p.T > 0 &&
         p.B <= 65535 && (!p.causal || p.q_offset >= 0);
}

}  // namespace

cudaError_t repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      void* out, float* lse, const FlashParams& p,
                                      int dtype, cudaStream_t stream) {
  if (!valid_shape(p)) return cudaErrorInvalidValue;
  Launcher fn = nullptr;
  if (dtype == REPRO_BF16) {
    // the 16-byte copies need 16-byte aligned rows (the wrapper checks too,
    // with strides of size-1 dims zeroed)
    if (!aligned16(q, p.q) || !aligned16(k, p.k) || !aligned16(v, p.v) ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return cudaErrorMisalignedAddress;
    fn = for_head_dim<Bf16Launcher>(p.D);
  } else if (dtype == REPRO_F32) {
    fn = for_head_dim<F32Launcher>(p.D);
  }
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, out, lse, p, stream);
}

cudaError_t repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* out, const float* lse, const void* dout,
                                      void* dq, void* dk, void* dv, float* scratch,
                                      const FlashBwdParams& p, int dtype,
                                      cudaStream_t stream) {
  if (!valid_shape(p.f) || p.S_pad < p.f.S || p.S_pad % REPRO_FLASH_BWD_ROW_PAD != 0)
    return cudaErrorInvalidValue;
  if (!aligned16(q, p.f.q) || !aligned16(k, p.f.k) || !aligned16(v, p.f.v) ||
      !aligned16(out, p.o) || !aligned16(dout, p.dout) ||
      reinterpret_cast<uintptr_t>(dq) % 16 != 0 || reinterpret_cast<uintptr_t>(dk) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dv) % 16 != 0 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return cudaErrorMisalignedAddress;
  BwdLauncher fn = dtype == REPRO_BF16 ? for_head_dim<Bf16BwdLauncher>(p.f.D) : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, out, lse, dout, dq, dk, dv, scratch, p, stream);
}
