// Plain C launch interface of the kernels in this directory. The .cu files
// implement it without any PyTorch header; bindings.cpp is the only file that
// sees torch/extension.h.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w, for rows x dim
// contiguous row-major x and y, in the element type `dtype`.
cudaError_t repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                              int64_t rows, int dim, float eps, int dtype,
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

// out: contiguous (B, Hq, S, D) in `dtype`; lse: contiguous (B, Hq, S) f32.
cudaError_t repro_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      const FlashParams& p, int dtype,
                                      cudaStream_t stream);
