// Plain C launch interface of the kernels in this directory. The .cu files
// implement it without any PyTorch header; bindings.cpp is the only file that
// sees torch/extension.h.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// The rows of an RMSNorm input: `rows` rows of `dim` contiguous elements,
// row r at element (r / n_inner) * s_outer + (r % n_inner) * s_inner of x
// (the leading dims collapsed into at most two levels).
struct RmsNormRows {
  int64_t rows;
  int dim;
  int64_t n_inner;  // divides rows
  int64_t s_outer, s_inner;
};

// Most 16-byte vectors a row the vector kernel takes (1024 threads x 4).
constexpr int REPRO_RMSNORM_MAX_VECTORS = 4096;

// y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w, y contiguous
// (rows, dim), in the element type `dtype`. Rows of whole 16-byte vectors
// with x, w and y 16-byte aligned and both strides multiples of the vector
// take the vector kernel; any other x must have row r at r * dim
// (cudaErrorMisalignedAddress otherwise) and takes the scalar kernels.
cudaError_t repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                              const RmsNormRows& p, float eps, int dtype,
                              cudaStream_t stream);

// Element strides of a (B, H, seq, D) operand whose last dim is contiguous.
struct AttnStrides {
  int64_t b, h, s;
};

struct FlashParams {
  int B, Hq, Hkv, S, T, D;
  AttnStrides q, k, v;
  int causal;    // 0 or 1
  int q_offset;  // absolute position of query 0; >= 0 when causal
  float sm_scale;
};

// D in {16, 24, 32, 64, 80, 128, 160}. bf16 runs on the tensor cores and
// needs 16-byte aligned base pointers and strides (cudaErrorMisalignedAddress
// otherwise); f32 runs on the CUDA cores.
// out: contiguous (B, Hq, S, D) in `dtype`; lse: contiguous (B, Hq, S) f32.
cudaError_t repro_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      const FlashParams& p, int dtype,
                                      cudaStream_t stream);

// The backward's operands beyond the forward's: the strides of out and dout
// (laid out as q), and the rows a head of its f32 scratch, S rounded up to a
// multiple of REPRO_FLASH_BWD_ROW_PAD.
struct FlashBwdParams {
  FlashParams f;
  AttnStrides o, dout;
  int S_pad;
};

constexpr int REPRO_FLASH_BWD_ROW_PAD = 128;

// Gradients of the forward above from its out and lse, bf16 only (the
// tensor cores; cudaErrorInvalidValue for another dtype or D), with every
// operand 16-byte aligned as the bf16 forward's (cudaErrorMisalignedAddress
// otherwise). dq: contiguous (B, Hq, S, D); dk, dv: contiguous
// (B, Hkv, T, D); scratch: 2 * B * Hq * S_pad floats. Three launches on
// `stream`; the result does not depend on their timing.
cudaError_t repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* out, const float* lse, const void* dout,
                                      void* dq, void* dk, void* dv, float* scratch,
                                      const FlashBwdParams& p, int dtype,
                                      cudaStream_t stream);

// Mamba-2 SSD scan shapes and the element strides of its operands, each with
// a contiguous last dim: x (B, S, H, P), dt (B, S, H), Bm and C (B, S, N).
struct SsdParams {
  int B, S, H, P, N;
  int L;  // chunk length, 1 <= L <= S
  int64_t x_b, x_s, x_h;
  int64_t dt_b, dt_s, dt_h;
  int64_t bm_b, bm_s;
  int64_t c_b, c_s;
};

// Dynamic shared memory of one block of the f32 SSD kernel, in bytes: C and B
// rows and the (P, N) state padded to N + 1, x, the (L, L + 1) scores, three
// per-step f32 rows and one per-step f64 row.
inline int64_t repro_ssd_smem_bytes(int L, int P, int N) {
  const int64_t l = L, np = N + 1;
  return 4 * (2 * l * np + l * P + int64_t{P} * np + l * (l + 1) + 5 * l);
}

// Longest chunk the bf16 (tensor-core) SSD kernel takes.
constexpr int REPRO_SSD_TC_MAX_CHUNK = 128;

// A and D: (H,) f32; y: contiguous (B, S, H, P) in `dtype`; state: contiguous
// (B, H, P, N) f32, the state after the last step from a zero state.
// f32 runs on the CUDA cores. bf16 runs on the tensor cores and takes
// P % 16 == 0, N % 8 == 0, N <= 128 and L <= REPRO_SSD_TC_MAX_CHUNK
// (cudaErrorInvalidValue otherwise), with 16-byte aligned base pointers of x,
// Bm, C and y and strides of x, Bm and C in multiples of 8 elements, 0 for a
// dim of size 1 (cudaErrorMisalignedAddress otherwise).
cudaError_t repro_ssd_scan_fwd(const void* x, const void* dt, const float* A,
                               const void* Bm, const void* C, const float* D,
                               void* y, float* state, const SsdParams& p,
                               int dtype, cudaStream_t stream);
