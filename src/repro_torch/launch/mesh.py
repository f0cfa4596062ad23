"""Meshes: the counterpart of ``repro/launch/mesh.py``, as torch
``DeviceMesh``es.

A function, not a module-level constant: importing this module starts no
process group. ``make_mesh`` joins the default process group when the caller
has not, from the ``env://`` variables that ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), with the backend of the
device type: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``. A group that runs
another backend is refused; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"no process-group backend for device type {device_type!r}; "
                         f"the port runs {sorted(BACKENDS)}")
    return BACKENDS[device_type]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the ranks of the default process group, in
    row-major order (rank r sits at the coordinates of r in ``shape``), its
    dims named ``axes``."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    backend = backend_for(device_type)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"a {device_type} mesh needs the {backend} backend; the default "
                           f"process group runs {dist.get_backend()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs CUDA, which is not available")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The JAX package's production shapes: 16x16 ("data", "model") or 2x16x16
    ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
