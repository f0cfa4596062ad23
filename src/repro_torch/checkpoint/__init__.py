"""Checkpoints: atomic, async, keep-k, in the JAX package's file layout (the
counterpart of ``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
