// PyTorch bindings of the kernels' plain C launchers (launch.h). The only
// source that includes torch/extension.h, which dominates the build time.
// The Python wrappers check device, dtype, shape and layout; the checks
// here guard what would otherwise read or write out of bounds.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
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

// The stride of a dim of size 1 is never used; it is 0 here, so that the
// kernel's alignment check reads only the strides it steps by.
AttnStrides strides_of(const torch::Tensor& t) {
  TORCH_CHECK(t.dim() == 4 && t.stride(3) == 1,
              "attention operands must be 4-D with a contiguous last dim");
  auto st = [&](int d) { return t.size(d) == 1 ? int64_t{0} : t.stride(d); };
  return AttnStrides{st(0), st(1), st(2)};
}

// x's rows as the wrapper laid them out (rmsnorm.py:row_layout): row r at
// (r / n_inner) * s_outer + (r % n_inner) * s_inner. Checked to lie inside x's
// storage; the launcher refuses a strided x it cannot read.
void rmsnorm_fwd(const torch::Tensor& x, const torch::Tensor& w, torch::Tensor y,
                 double eps, int64_t n_inner, int64_t s_outer, int64_t s_inner) {
  TORCH_CHECK(x.is_cuda() && x.dim() >= 1 && w.is_contiguous() && y.is_contiguous(),
              "rmsnorm: CUDA x, contiguous weight and output expected");
  const int64_t dim = x.size(-1);
  TORCH_CHECK(dim > 0 && dim < (int64_t{1} << 31) && (dim == 1 || x.stride(-1) == 1) && w.numel() == dim &&
                  y.sizes() == x.sizes() && w.scalar_type() == x.scalar_type() &&
                  y.scalar_type() == x.scalar_type(),
              "rmsnorm: shape, last-dim stride or dtype mismatch");
  const int64_t rows = x.numel() / dim;
  TORCH_CHECK(n_inner >= 1 && rows % n_inner == 0 && s_outer >= 0 && s_inner >= 0,
              "rmsnorm: bad row layout");
  const int64_t end = x.storage_offset() + (rows / n_inner - 1) * s_outer +
                      (n_inner - 1) * s_inner + dim;
  TORCH_CHECK(end * static_cast<int64_t>(x.element_size()) <=
                  static_cast<int64_t>(x.storage().nbytes()),
              "rmsnorm: the row layout reaches past x's storage");
  const RmsNormRows p{rows, static_cast<int>(dim), n_inner, s_outer, s_inner};
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(repro_rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), p,
                                 static_cast<float>(eps), dtype_code(x),
                                 c10::cuda::getCurrentCUDAStream().stream()),
               "rmsnorm");
}

FlashParams flash_params(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, bool causal, double sm_scale,
                         int64_t q_offset) {
  TORCH_CHECK(k.sizes() == v.sizes() && q.size(0) == k.size(0) && q.size(3) == k.size(3) &&
                  k.scalar_type() == q.scalar_type() && v.scalar_type() == q.scalar_type(),
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
  return p;
}

void flash_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, torch::Tensor out,
                         torch::Tensor lse, bool causal, double sm_scale,
                         int64_t q_offset) {
  TORCH_CHECK(q.is_cuda() && out.is_contiguous() && lse.is_contiguous() &&
                  lse.scalar_type() == torch::kFloat32 &&
                  q.dim() == 4 && lse.numel() * q.size(3) == q.numel(),
              "flash_attention: bad output buffers");
  TORCH_CHECK(out.sizes() == q.sizes() && out.scalar_type() == q.scalar_type(),
              "flash_attention: shape or dtype mismatch");
  const FlashParams p = flash_params(q, k, v, causal, sm_scale, q_offset);
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_flash_attention_fwd(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr<float>(), p, dtype_code(q),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention");
}

// The f32 scratch (lse2 and delta, S_pad rows a head) is allocated here, on
// the current stream's allocator, and freed when the launches are done.
void flash_attention_bwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& out,
                         const torch::Tensor& lse, const torch::Tensor& dout,
                         torch::Tensor dq, torch::Tensor dk, torch::Tensor dv, bool causal,
                         double sm_scale, int64_t q_offset) {
  TORCH_CHECK(q.is_cuda() && q.dim() == 4 && lse.is_contiguous() &&
                  lse.scalar_type() == torch::kFloat32 &&
                  lse.numel() * q.size(3) == q.numel(),
              "flash_attention_bwd: bad lse");
  TORCH_CHECK(out.sizes() == q.sizes() && dout.sizes() == q.sizes() &&
                  dq.sizes() == q.sizes() && dk.sizes() == k.sizes() && dv.sizes() == k.sizes() &&
                  dq.is_contiguous() && dk.is_contiguous() && dv.is_contiguous(),
              "flash_attention_bwd: bad out, dout or gradient buffers");
  for (const torch::Tensor* t :
       std::initializer_list<const torch::Tensor*>{&out, &dout, &dq, &dk, &dv})
    TORCH_CHECK(t->scalar_type() == q.scalar_type(), "flash_attention_bwd: dtype mismatch");
  FlashBwdParams p;
  p.f = flash_params(q, k, v, causal, sm_scale, q_offset);
  p.o = strides_of(out);
  p.dout = strides_of(dout);
  p.S_pad = (p.f.S + REPRO_FLASH_BWD_ROW_PAD - 1) / REPRO_FLASH_BWD_ROW_PAD *
            REPRO_FLASH_BWD_ROW_PAD;
  const c10::cuda::CUDAGuard guard(q.device());
  torch::Tensor scratch = torch::empty({2 * q.size(0) * q.size(1) * int64_t{p.S_pad}},
                                       q.options().dtype(torch::kFloat32));
  check_launch(repro_flash_attention_bwd(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr<float>(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                   dv.data_ptr(), scratch.data_ptr<float>(), p, dtype_code(q),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention_bwd");
}

void ssd_scan_fwd(const torch::Tensor& x, const torch::Tensor& dt,
                  const torch::Tensor& A, const torch::Tensor& Bm,
                  const torch::Tensor& C, const torch::Tensor& D, torch::Tensor y,
                  torch::Tensor state, int64_t chunk) {
  TORCH_CHECK(x.is_cuda() && x.dim() == 4 && dt.dim() == 3 && Bm.dim() == 3 &&
                  C.sizes() == Bm.sizes(),
              "ssd: x (B, S, H, P), dt (B, S, H), Bm and C (B, S, N) expected");
  const int64_t B = x.size(0), S = x.size(1), H = x.size(2), P = x.size(3),
                N = Bm.size(2);
  TORCH_CHECK(dt.size(0) == B && dt.size(1) == S && dt.size(2) == H &&
                  Bm.size(0) == B && Bm.size(1) == S,
              "ssd: shape mismatch");
  TORCH_CHECK(dt.scalar_type() == x.scalar_type() &&
                  Bm.scalar_type() == x.scalar_type() &&
                  C.scalar_type() == x.scalar_type() &&
                  y.scalar_type() == x.scalar_type(),
              "ssd: x, dt, Bm, C and y must share one dtype");
  TORCH_CHECK(x.stride(3) == 1 && Bm.stride(2) == 1 && C.stride(2) == 1,
              "ssd: x, Bm and C need a contiguous last dim");
  for (const torch::Tensor* t : {&A, &D})
    TORCH_CHECK(t->scalar_type() == torch::kFloat32 && t->is_contiguous() &&
                    t->numel() == H,
                "ssd: A and D must be contiguous (H,) f32");
  TORCH_CHECK(y.is_contiguous() && y.sizes() == x.sizes() &&
                  state.is_contiguous() &&
                  state.scalar_type() == torch::kFloat32 &&
                  state.numel() == B * H * P * N,
              "ssd: bad output buffers");
  TORCH_CHECK(chunk >= 1 && chunk <= S, "ssd: chunk ", chunk, " outside [1, ", S, "]");
  // the stride of a dim of size 1 is never used; 0 here, as for attention
  auto st = [](const torch::Tensor& t, int d) {
    return t.size(d) == 1 ? int64_t{0} : t.stride(d);
  };
  SsdParams p;
  p.B = static_cast<int>(B);
  p.S = static_cast<int>(S);
  p.H = static_cast<int>(H);
  p.P = static_cast<int>(P);
  p.N = static_cast<int>(N);
  p.L = static_cast<int>(chunk);
  p.x_b = st(x, 0);
  p.x_s = st(x, 1);
  p.x_h = st(x, 2);
  p.dt_b = st(dt, 0);
  p.dt_s = st(dt, 1);
  p.dt_h = st(dt, 2);
  p.bm_b = st(Bm, 0);
  p.bm_s = st(Bm, 1);
  p.c_b = st(C, 0);
  p.c_s = st(C, 1);
  const c10::cuda::CUDAGuard guard(x.device());
  check_launch(repro_ssd_scan_fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr<float>(),
                                  Bm.data_ptr(), C.data_ptr(), D.data_ptr<float>(),
                                  y.data_ptr(), state.data_ptr<float>(), p,
                                  dtype_code(x),
                                  c10::cuda::getCurrentCUDAStream().stream()),
               "ssd");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rmsnorm_fwd", &rmsnorm_fwd, "RMSNorm forward (sm_90a)");
  m.def("flash_attention_fwd", &flash_attention_fwd,
        "GQA flash-attention forward (sm_90a)");
  m.def("flash_attention_bwd", &flash_attention_bwd,
        "GQA flash-attention backward from out and lse, bf16 (sm_90a)");
  m.def("ssd_scan_fwd", &ssd_scan_fwd, "Mamba-2 SSD chunked scan forward (sm_90a)");
}
