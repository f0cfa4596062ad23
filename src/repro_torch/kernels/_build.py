"""Build and load the CUDA kernels of ``csrc/`` at first use.

One ``torch.utils.cpp_extension.load`` call compiles every source (ninja runs
them in parallel) into ``build/repro_torch_kernels/`` at the root of the
checkout and loads the module. Only ``bindings.cpp`` includes PyTorch's
headers; the ``.cu`` files have a plain C interface (``csrc/launch.h``), so
``nvcc`` takes seconds on them.

The first call builds; later calls return the same module. With
``verbose=True`` the build is printed, with each kernel's registers, stack and
spills as ``ptxas -v`` reports them (``-Xptxas=-v`` is always passed, so a
verbose and a quiet build are the same build).
"""
from __future__ import annotations

import pathlib

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("bindings.cpp", "rmsnorm.cu", "flash_attention.cu", "ssd.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_module = None


def load_kernels(verbose: bool = False):
    """The compiled extension module (built on the first call)."""
    global _module
    if _module is None:
        from torch.utils.cpp_extension import load

        # load() does not create the directory and fails on its lock file
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _module = load(
            name="repro_torch_kernels",
            sources=[str(_CSRC / s) for s in _SOURCES],
            build_directory=str(BUILD_DIR),
            extra_include_paths=[str(_CSRC)],
            extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas=-v"],
            verbose=verbose,
        )
    return _module
