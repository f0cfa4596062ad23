#!/usr/bin/env python3
"""Where the bf16 SSD kernel's time goes, on one CUDA card.

    python3 tools/ssd_breakdown.py

Builds src/repro_torch/kernels/csrc/ssd.cu several times with nvcc (all builds
at once), each with one part of the bf16 kernel switched off, and times every
build at the mamba2-370m forward's shape (B=4, S=2048, H=32, P=64, N=128,
bf16, chunk 64) with chip_smoke.py's device timing (torch.profiler, inputs
from HBM). A switched-off part is a line of the kernel made conditional on a
macro that the build sets to 0; the kernel then computes a wrong y, so only
the full build is held against the plain scan. What a part costs is the full
build's time less the build without it: parts overlap on the card, so these
differences do not add up to the total.

The builds go to build/ssd_breakdown/. Needs nvcc (/usr/local/cuda/bin) and a
card; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_breakdown"
NVCC = "/usr/local/cuda/bin/nvcc"

# part -> (macro, lines of ssd.cu, each with the code the macro guards)
PARTS = {
    "C.h^T": ("SSD_C", ["        if (c > 0) {"]),
    "state update": ("SSD_D", ["    if (owns_h) {\n      const float eG"]),
    "C.B^T": ("SSD_A", ["          for (int sp = 0; sp <= M; ++sp) {"]),
    "score exponentials": ("SSD_EXP", ["        for (int j = 0; j < ST; ++j) {"]),
    "S x": ("SSD_B", ["        for (int kt = 0; kt <= M; ++kt) {"]),
    "C and B copies": ("SSD_CB", ["      cp_async16(smem_u32(sC + s * LDN + k)",
                                  "      cp_async16(smem_u32(sB + s * LDN + k)"]),
    "x copies": ("SSD_X", ["      cp_async16(smem_u32(sX + s * LDX + k)"]),
    "scan": ("SSD_SCAN", ["      scan((c + 1) & 1);"]),
}
BUILDS = {"full": []}
BUILDS |= {f"without {part}": [macro] for part, (macro, _) in PARTS.items()}
BUILDS["without the four products"] = ["SSD_A", "SSD_B", "SSD_C", "SSD_D", "SSD_EXP"]

SHIM = r'''
extern "C" int ssd_run(const void* x, const void* dt, const float* A, const void* Bm,
                       const void* C, const float* D, void* y, float* state, int B, int S,
                       int H, int P, int N, int L, long long x_b, long long x_s, long long x_h,
                       long long dt_b, long long dt_s, long long dt_h, long long bm_b,
                       long long bm_s, long long c_b, long long c_s, void* stream) {
  SsdParams p{B, S, H, P, N, L, x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, c_b, c_s};
  return static_cast<int>(repro_ssd_scan_fwd(x, dt, A, Bm, C, D, y, state, p, REPRO_BF16,
                                             static_cast<cudaStream_t>(stream)));
}
'''


def switched_source() -> str:
    """ssd.cu with every part's lines made conditional on its macro (in a
    loop's condition, an if's condition, or an if around a statement), each
    macro 1 unless a build sets it to 0, and a plain C entry point for
    ctypes."""
    src = (CSRC / "ssd.cu").read_text()
    for macro, lines in PARTS.values():
        for line in lines:
            if src.count(line) != 1:
                raise SystemExit(f"ssd_breakdown: {line.strip()!r} is not one line of ssd.cu")
            code = line.lstrip(" ")
            if code.startswith("for ("):
                cut = line.index(";") + 2
                new = f"{line[:cut]}{macro} && {line[cut:]}"
            elif code.startswith("if ("):
                new = line.replace("if (", f"if ({macro} && ", 1)
            else:
                new = f"{line[:len(line) - len(code)]}if ({macro}) {code}"
            src = src.replace(line, new, 1)
    head = "".join(f"#ifndef {m}\n#define {m} 1\n#endif\n" for m, _ in PARTS.values())
    return head + src + SHIM


def build() -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_switched.cu"
    src.write_text(switched_source())
    procs = {}
    for i, (name, macros) in enumerate(BUILDS.items()):
        cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
               *(f"-D{m}=0" for m in macros), "-o", str(OUT / f"lib{i}.so"), str(src)]
        procs[name] = (subprocess.Popen(cmd), OUT / f"lib{i}.so")
    libs = {}
    for name, (proc, path) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"ssd_breakdown: the build {name!r} failed")
        libs[name] = ctypes.CDLL(str(path))
    return libs


def launcher(lib):
    import torch

    fn = lib.ssd_run
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, dt, A, Bm, C, D, chunk=64):
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
        state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
        st = [0 if t.shape[d] == 1 else t.stride(d) for t, d in
              ((x, 0), (x, 1), (x, 2), (dt, 0), (dt, 1), (dt, 2), (Bm, 0), (Bm, 1), (C, 0),
               (C, 1))]
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                D.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, P, N, min(chunk, S),
                *st, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ssd_breakdown: launch failed with cudaError {rc}")
        return y, state

    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    calls = {name: launcher(lib) for name, lib in build().items()}
    print(f"built {len(calls)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    B, S, H, P, N = 4, 2048, 32, 64, 128
    with torch.inference_mode():
        args = cs._ssd_inputs(B, S, H, P, N, torch.bfloat16, 1, dev)
        y, state = calls["full"](*args)
        y_r, state_r = ref.ssd_scan(*args, return_state=True)
        e, ok = cs.err_vs(y, y_r, torch.bfloat16)
        e_state = float((state - state_r).abs().max())
        print(f"full build vs plain scan: y {e:.3e} (ok={ok}), state {e_state:.3e}", flush=True)
        if not (ok and e_state <= cs.SSD_TOL):
            return 1
        sets = cs.copies(lambda: cs._ssd_inputs(B, S, H, P, N, torch.bfloat16, 20, dev),
                         cs._ssd_bytes(B, S, H, P, N))
        times = {name: [] for name in calls}
        for _ in range(2):  # two rounds, every build in turn
            for name, fn in calls.items():
                times[name].append(cs.time_ms(fn, sets)[0])
        full = min(times["full"])
        print(f"device ms at {(B, S, H, P, N)} bf16, chunk 64 (two rounds):", flush=True)
        for name, ts in times.items():
            print(f"  {name:34s} {ts[0]:.4f} {ts[1]:.4f}"
                  + ("" if name == "full" else f"   full - this: {full - min(ts):+.4f}"),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
