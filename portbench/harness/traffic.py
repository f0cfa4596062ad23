"""The one traffic generator: it reads a mix (``traffic/<mix>.json``) and
makes its inputs from the run's seed. A new mix is a new data file.

Every seed gets the same sizes; the seed changes only which tokens are drawn.
Tokens are uniform over the configuration's vocabulary, on which no
operation of the model fails.
"""
from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


def train_batch(mix: dict, vocab: int, seed: int, index: int) -> np.ndarray:
    """Batch ``index`` of a train mix: (batch, seq) token ids."""
    return _rng(seed, 1, index).integers(0, vocab, (mix["batch"], mix["seq"]), dtype=np.int64)


def train_pool(mix: dict, vocab: int, seed: int, device) -> list[dict]:
    """The ``pool`` distinct batches a train run cycles through, on the
    device: ``{"tokens": (batch, seq) int64}``."""
    return [{"tokens": torch.from_numpy(train_batch(mix, vocab, seed, i)).to(device)}
            for i in range(mix["pool"])]


def serve_prompts(mix: dict, vocab: int, seed: int, index: int) -> np.ndarray:
    """The prompts of batch ``index`` of a closed-loop serve mix:
    (batch, prompt_len) token ids."""
    return _rng(seed, 2, index).integers(0, vocab, (mix["batch"], mix["prompt_len"]),
                                         dtype=np.int64)


def sample(seed: int, population: int, k: int) -> list[int]:
    """``k`` of ``range(population)`` drawn from the seed (all of them when k
    is not less), sorted."""
    if k >= population:
        return list(range(population))
    return sorted(int(i) for i in _rng(seed, 3).choice(population, size=k, replace=False))
