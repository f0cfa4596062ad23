"""PyTorch/CUDA port of the Astra execution half (see ``src/repro`` for the
JAX reference).

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no explicit ``"cpu"`` they raise instead of quietly running
on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev
