"""Deterministic synthetic data pipeline (host-sharded, resumable)."""
from repro_torch.data.pipeline import MarkovCorpus, SyntheticPipeline

__all__ = ["MarkovCorpus", "SyntheticPipeline"]
