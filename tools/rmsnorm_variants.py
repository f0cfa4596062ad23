#!/usr/bin/env python3
"""Every configuration of the RMSNorm vector kernel, timed on one CUDA card at
the shapes of the port's main paths.

    python3 tools/rmsnorm_variants.py [--parent DIR]

Builds src/repro_torch/kernels/csrc/rmsnorm.cu once with nvcc, with more
configurations than the port's build (REPRO_RMSNORM_EXTRA_CONFIGS) and a plain
C entry point that launches any of them, and times, at each shape, every
configuration that fits its rows (lanes x vectors a lane covering the row,
less than half of it idle) with chip_smoke.py's device timing (torch.profiler,
inputs from HBM). Beside them: the configuration the kernel picks, F.rms_norm
on the same inputs, and the launch floor (a one-block elementwise op on 8 bf16
values). At the decode rows it also times a kernel that spreads each row over
a cluster of 2-8 blocks, reducing through distributed shared memory; the port
does not build that one. Then the kernel's own pick, F.rms_norm and, with
--parent, the RMSNorm kernel of another checkout (DIR, e.g. a `git archive` of
the parent commit; its launcher takes contiguous rows) are timed in turns (A,
B, C, C, B, A) after a warm-up, and their means printed. Every configuration
is held to ref.rmsnorm at chip_smoke's TOL first.

The build goes to build/rmsnorm_variants/ (registers from ptxas -v are
printed). Needs nvcc (/usr/local/cuda/bin) and a card; prints the card's name
and power limit first.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "rmsnorm_variants"
NVCC = "/usr/local/cuda/bin/nvcc"

# the configurations pick_config does not choose: rows over more lanes or
# several rows a thread at head sizes, other vectors a thread and block sizes
EXTRA = [(8, 2, 1, 256), (8, 2, 2, 256), (16, 2, 1, 256), (16, 2, 2, 256), (16, 1, 1, 256),
         (16, 1, 2, 256), (16, 1, 4, 256), (16, 1, 1, 64), (32, 1, 1, 256), (32, 1, 2, 256),
         (32, 1, 4, 256), (32, 1, 1, 64), (8, 1, 1, 64), (32, 2, 1, 256), (32, 2, 2, 256),
         (32, 4, 2, 256), (32, 4, 1, 32), (64, 1, 1, 256), (64, 1, 1, 64), (64, 2, 1, 256),
         (64, 2, 1, 64), (64, 2, 2, 256), (128, 1, 1, 256), (128, 2, 1, 256),
         (128, 2, 2, 256), (256, 2, 1, 256), (512, 2, 1, 512), (32, 8, 1, 256),
         (64, 8, 1, 256), (128, 8, 1, 256), (256, 8, 1, 256), (512, 8, 1, 512)]
CLUSTERS = [(2, 256), (4, 128), (8, 64), (2, 64), (4, 32)]  # (blocks a row, threads a block)

SHIM = r'''
#include <cooperative_groups.h>

namespace {
// A row over a cluster of CL blocks (launched with that cluster size) of
// THREADS lanes, one vector a lane: each block's partial sum of squares goes
// into every block's shared memory, then one cluster barrier.
template <typename T, int CL, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       int dim, float eps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int N = kVecBytes / sizeof(T);
  __shared__ float warp_part[THREADS / 32];
  __shared__ float parts[CL];
  const int part = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x / CL;
  const int nvec = dim / N;
  const int v = part * THREADS + threadIdx.x;
  const uint4 z = make_uint4(0, 0, 0, 0);
  const uint4 wv = v < nvec ? __ldg(reinterpret_cast<const uint4*>(w) + v) : z;
  const uint4 xv = v < nvec ? __ldg(reinterpret_cast<const uint4*>(x + row * dim) + v) : z;
  float acc = 0.f;
  const T* e = reinterpret_cast<const T*>(&xv);
#pragma unroll
  for (int i = 0; i < N; ++i) acc = fmaf(to_f32(e[i]), to_f32(e[i]), acc);
  acc = group_sum<32>(acc);
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += warp_part[i];
    for (int i = 0; i < CL; ++i) *cluster.map_shared_rank(&parts[part], i) = s;
  }
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < CL; ++i) total += parts[i];
  if (v >= nvec) return;
  const float r = rsqrtf(total / static_cast<float>(dim) + eps);
  uint4 out;
  const T* we = reinterpret_cast<const T*>(&wv);
  T* ye = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < N; ++i) ye[i] = from_f32<T>(to_f32(e[i]) * r * to_f32(we[i]));
  reinterpret_cast<uint4*>(y + row * dim)[v] = out;
}

template <typename T>
int cluster_launch(const void* x, const void* w, void* y, long long rows, int dim, float eps,
                   int cl, int threads, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  const unsigned grid = static_cast<unsigned>(rows * cl);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t c = {};
  c.gridDim = dim3(grid);
  c.blockDim = dim3(threads);
  c.stream = s;
  c.attrs = attr;
  c.numAttrs = 1;
#define CLUSTER(C, TH)                                                                    \
  if (cl == C && threads == TH)                                                           \
    return static_cast<int>(                                                              \
        cudaLaunchKernelEx(&c, rmsnorm_cluster_kernel<T, C, TH>, xt, wt, yt, dim, eps));
  CLUSTERS_LIST
#undef CLUSTER
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" int rmsnorm_run(const void* x, const void* w, void* y, long long rows, int dim,
                           long long n_inner, long long s_outer, long long s_inner, float eps,
                           int dtype, int lpr, int vpt, int rpt, int threads, void* stream) {
  const RmsNormRows p{rows, dim, n_inner, s_outer, s_inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lpr == 0) return static_cast<int>(repro_rmsnorm_fwd(x, w, y, p, eps, dtype, s));
  const VecConfig c{lpr, vpt, rpt, threads};
  return static_cast<int>(dtype == REPRO_BF16
                              ? launch_vec<__nv_bfloat16>(c, x, w, y, p, eps, s)
                              : launch_vec<float>(c, x, w, y, p, eps, s));
}

extern "C" int rmsnorm_cluster(const void* x, const void* w, void* y, long long rows, int dim,
                               float eps, int dtype, int cl, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == REPRO_BF16
             ? cluster_launch<__nv_bfloat16>(x, w, y, rows, dim, eps, cl, threads, s)
             : cluster_launch<float>(x, w, y, rows, dim, eps, cl, threads, s);
}

extern "C" void rmsnorm_pick(int nvec, long long rows, int* out) {
  const VecConfig c = pick_config(nvec, rows);
  out[0] = c.lpr, out[1] = c.vpt, out[2] = c.rpt, out[3] = c.threads;
}

extern "C" int rmsnorm_configs(int* out) {
  int n = 0;
#define LIST(L, V, R, TH) out[4 * n] = L, out[4 * n + 1] = V, out[4 * n + 2] = R, out[4 * n + 3] = TH, ++n;
  REPRO_RMSNORM_CONFIGS(LIST)
  REPRO_RMSNORM_EXTRA_CONFIGS(LIST)
#undef LIST
  return n;
}
'''

# bf16: the shapes of the main paths (chip_smoke.py's order phase); f32: those
# of its f32 model comparisons
SHAPES = {"bf16": [(32768, 128), (16384, 128), (8192, 128), (4096, 128), (128, 128),
                   (32, 128), (1024, 4096), (512, 4096), (4, 4096), (8192, 1024),
                   (512, 1024), (4, 1024)],
          "f32": [(1024, 4096), (32768, 128), (8192, 128), (1024, 1024)]}


PARENT_SHIM = r'''
extern "C" int parent_run(const void* x, const void* w, void* y, long long rows, int dim,
                          float eps, int dtype, void* stream) {
  return static_cast<int>(repro_rmsnorm_fwd(x, w, y, rows, dim, eps, dtype,
                                            static_cast<cudaStream_t>(stream)));
}
'''


def build(parent: pathlib.Path | None):
    """This tree's rmsnorm.cu with the extra configurations and SHIM, and,
    given a parent checkout, that tree's rmsnorm.cu behind PARENT_SHIM (its
    launcher takes contiguous (rows, dim) x): two nvcc runs at once. Returns
    the libraries and the first build's ptxas output."""
    OUT.mkdir(parents=True, exist_ok=True)
    extra = " ".join(f"X({lpr}, {vpt}, {rpt}, {th})" for lpr, vpt, rpt, th in EXTRA)
    clusters = " ".join(f"CLUSTER({c}, {th})" for c, th in CLUSTERS)
    sources = {"variants": (CSRC, f"#define REPRO_RMSNORM_EXTRA_CONFIGS(X) {extra}\n"
                                  f"#define CLUSTERS_LIST {clusters}\n"
                                  + (CSRC / "rmsnorm.cu").read_text() + SHIM)}
    if parent is not None:
        pcsrc = parent / CSRC.relative_to(ROOT)
        sources["parent"] = (pcsrc, (pcsrc / "rmsnorm.cu").read_text() + PARENT_SHIM)
    procs = {}
    for name, (inc, text) in sources.items():
        src, lib = OUT / f"rmsnorm_{name}.cu", OUT / f"librmsnorm_{name}.so"
        src.write_text(text)
        cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", str(inc), "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), lib)
    libs, log = {}, ""
    for name, (proc, lib) in procs.items():
        out, err = proc.communicate()
        (OUT / f"build_{name}.log").write_text(out + err)
        if proc.returncode != 0:
            print(err[-6000:], file=sys.stderr)
            raise SystemExit(f"rmsnorm_variants: the {name} build failed")
        libs[name] = ctypes.CDLL(str(lib))
        log = log or err
    return libs, log


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rmsnorm_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = pathlib.Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() \
        if "--parent" in sys.argv else None
    t0 = time.perf_counter()
    libs, log = build(parent)
    lib = libs["variants"]
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    regs = cs.ptxas_summary(log)
    spilled = [r for r in regs if "spill stores 0 B" not in r]
    print(f"ptxas: {len(regs)} kernels, registers "
          f"{sorted({int(r.split(': ')[1].split()[0]) for r in regs})}; spilling: "
          f"{spilled or 'none'}", flush=True)
    lib.rmsnorm_run.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
                                + [ctypes.c_longlong] * 3 + [ctypes.c_float]
                                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.rmsnorm_cluster.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                             ctypes.c_float]
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.rmsnorm_pick.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    if parent is not None:
        libs["parent"].parent_run.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                                       ctypes.c_int,
                                                                       ctypes.c_float,
                                                                       ctypes.c_int,
                                                                       ctypes.c_void_p])
    buf = (ctypes.c_int * 4096)()
    configs = list(dict.fromkeys(tuple(buf[4 * i:4 * i + 4])
                                 for i in range(lib.rmsnorm_configs(buf))))
    dtypes = {"bf16": (torch.bfloat16, 1), "f32": (torch.float32, 0)}

    def kernel(cfg, code):
        """cfg: (0, 0, 0, 0) for the kernel's own pick, (LPR, VPT, RPT,
        THREADS), ("cluster", blocks, threads) or ("parent",)."""
        def call(x, w):
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            rows, D = x.numel() // x.shape[-1], x.shape[-1]
            stream = torch.cuda.current_stream().cuda_stream
            if cfg[0] == "parent":
                rc = libs["parent"].parent_run(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                                               D, 1e-6, code, stream)
            elif cfg[0] == "cluster":
                rc = lib.rmsnorm_cluster(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D,
                                         1e-6, code, cfg[1], cfg[2], stream)
            else:
                rc = lib.rmsnorm_run(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, rows,
                                     0, D, 1e-6, code, *cfg, stream)
            if rc != 0:
                raise RuntimeError(f"rmsnorm_variants: {cfg} failed with cudaError {rc}")
            return y
        return call

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.inference_mode():
        floor_ms = cs.time_ms(lambda a: a * 2, [(torch.ones(8, device=dev,
                                                             dtype=torch.bfloat16),)])[0]
        print(f"launch floor (one-block elementwise op on 8 bf16 values): {floor_ms:.4f} ms",
              flush=True)
        for name, (dtype, code) in dtypes.items():
            n = 16 // torch.tensor([], dtype=dtype).element_size()
            for rows, D in SHAPES[name]:
                V = D // n
                pick = (ctypes.c_int * 4)()
                lib.rmsnorm_pick(V, rows, pick)
                pick = tuple(pick)
                cands = [c for c in configs if V <= c[0] * c[1] < 2 * V or c == pick]
                if rows <= 4:
                    cands += [("cluster", cl, th) for cl, th in CLUSTERS
                              if V <= cl * th < 2 * V]
                sets = cs.copies(cs._rmsnorm_inputs(rows, D, dtype, g, dev),
                                 (2 * rows * D + D) * dtype.itemsize)
                x, w = sets[0]
                want = ref.rmsnorm(x, w)
                mine = kernel((0, 0, 0, 0), code)
                for cfg in [(0, 0, 0, 0)] + cands + ([("parent",)] if parent else []):
                    e, ok = cs.err_vs(kernel(cfg, code)(x, w), want, dtype)
                    if not ok:
                        print(f"  {name} {(rows, D)} {cfg}: off by {e}", flush=True)
                        return 1
                cs.warm_up(mine, sets)
                times = {cfg: cs.time_ms(kernel(cfg, code), sets)[0] for cfg in cands}
                # the kernel's pick, the parent's kernel and F.rms_norm in turns
                lib_fn = lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, 1e-6)  # noqa
                turns = {"K1": mine, "F.rms_norm": lib_fn}
                if parent:
                    turns["parent K1"] = kernel(("parent",), code)
                order = list(turns) + list(reversed(turns))
                got = {k: [] for k in turns}
                for k in order:
                    got[k].append(cs.time_ms(turns[k], sets)[0])
                mean = {k: sum(v) / len(v) for k, v in got.items()}
                bound = (2 * rows * D + D) * dtype.itemsize / cs.HBM_BYTES_PER_S * 1e3
                best = min((t, c) for c, t in times.items())
                print(f"{name} ({rows}, {D}): picked {pick}; in turns "
                      + ", ".join(f"{k} {mean[k]:.4f} ms {[round(t, 5) for t in got[k]]}"
                                  for k in turns)
                      + f"; bound {bound:.4f} ms, bound / K1 {bound / mean['K1']:.3f}, floor "
                      f"{floor_ms:.4f}; best configuration {best[1]} {best[0]:.4f}", flush=True)
                print("   " + ", ".join(f"{c}: {t:.4f}" for c, t in sorted(
                    times.items(), key=lambda kv: kv[1])), flush=True)
                del sets, x, w, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
