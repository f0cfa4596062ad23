"""Hardware catalog: accelerator specs, topology model, and cloud prices.

The catalog carries the paper's GPUs (A800/H100/H800 — used to reproduce the
paper's simulated experiments) and TPU v5e/v5p (the execution target of this
framework). All numbers are public list specs.

The port's copy of the JAX package's ``hw`` (NumPy and stdlib only):
the port imports nothing of the JAX package.
"""
from repro_torch.hw.catalog import (
    DeviceSpec,
    DEVICES,
    get_device,
    TPU_V5E,
    TPU_V5P,
)
from repro_torch.hw.topology import ClusterSpec, collective_bytes_on_wire

__all__ = [
    "DeviceSpec",
    "DEVICES",
    "get_device",
    "TPU_V5E",
    "TPU_V5P",
    "ClusterSpec",
    "collective_bytes_on_wire",
]
