// PyTorch bindings of the kernels' plain C launchers (launch.h). The only
// source that includes torch/extension.h, which dominates the build time.
// The Python wrappers check device, dtype, shape and contiguity; the checks
// here guard what would otherwise read or write out of bounds.
#include <torch/extension.h>

#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include "launch.h"

namespace {

int dtype_code(const torch::Tensor& t) {
  if (t.scalar_type() == torch::kFloat32) return REPRO_F32;
  TORCH_CHECK(t.scalar_type() == torch::kBFloat16, "unsupported dtype ",
              t.scalar_type());
  return REPRO_BF16;
}

void check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, " kernel launch failed: ",
              cudaGetErrorString(err));
}

AttnStrides strides_of(const torch::Tensor& t) {
  TORCH_CHECK(t.dim() == 4 && t.stride(3) == 1,
              "attention operands must be 4-D with a contiguous last dim");
  return AttnStrides{t.stride(0), t.stride(1), t.stride(2)};
}

void rmsnorm_fwd(const torch::Tensor& x, const torch::Tensor& w, torch::Tensor y,
                 double eps) {
  TORCH_CHECK(x.is_cuda() && x.is_contiguous() && w.is_contiguous() &&
                  y.is_contiguous(),
              "rmsnorm: contiguous CUDA tensors expected");
  const int64_t dim = x.size(-1);
  TORCH_CHECK(dim > 0 && w.numel() == dim && y.sizes() == x.sizes() &&
                  w.scalar_type() == x.scalar_type() &&
                  y.scalar_type() == x.scalar_type(),
              "rmsnorm: shape or dtype mismatch");
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(repro_rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                 x.numel() / dim, static_cast<int>(dim),
                                 static_cast<float>(eps), dtype_code(x),
                                 c10::cuda::getCurrentCUDAStream().stream()),
               "rmsnorm");
}

void flash_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, torch::Tensor out,
                         torch::Tensor lse, bool causal, double sm_scale,
                         int64_t q_offset) {
  TORCH_CHECK(q.is_cuda() && out.is_contiguous() && lse.is_contiguous() &&
                  lse.scalar_type() == torch::kFloat32 &&
                  q.dim() == 4 && lse.numel() * q.size(3) == q.numel(),
              "flash_attention: bad output buffers");
  TORCH_CHECK(k.sizes() == v.sizes() && out.sizes() == q.sizes() &&
                  q.size(0) == k.size(0) && q.size(3) == k.size(3) &&
                  k.scalar_type() == q.scalar_type() &&
                  v.scalar_type() == q.scalar_type() &&
                  out.scalar_type() == q.scalar_type(),
              "flash_attention: shape or dtype mismatch");
  FlashParams p;
  p.B = static_cast<int>(q.size(0));
  p.Hq = static_cast<int>(q.size(1));
  p.S = static_cast<int>(q.size(2));
  p.D = static_cast<int>(q.size(3));
  p.Hkv = static_cast<int>(k.size(1));
  p.T = static_cast<int>(k.size(2));
  p.q = strides_of(q);
  p.k = strides_of(k);
  p.v = strides_of(v);
  p.causal = causal ? 1 : 0;
  p.q_offset = static_cast<int>(q_offset);
  p.sm_scale = static_cast<float>(sm_scale);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_flash_attention_fwd(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr<float>(), p, dtype_code(q),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rmsnorm_fwd", &rmsnorm_fwd, "RMSNorm forward (sm_90a)");
  m.def("flash_attention_fwd", &flash_attention_fwd,
        "GQA flash-attention forward (sm_90a)");
}
