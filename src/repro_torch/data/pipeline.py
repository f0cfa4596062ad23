"""Synthetic LM data with learnable structure + a resumable pipeline: the
port's own copy of ``repro/data/pipeline.py`` (numpy only; the port imports
nothing of ``repro``). For a seed it gives the same tokens as the JAX
package's. Batches are numpy; the caller moves them to its device.

``MarkovCorpus`` samples token streams from a fixed random first-order
Markov chain — entropy strictly below uniform, so a training run shows a
real, monotone loss descent toward the chain's entropy rate (used by the
end-to-end example and the loss-decreases test).

``SyntheticPipeline`` is the production-shaped wrapper: deterministic
per-(step, host_shard) batches so (a) every data-parallel host reads only
its shard, and (b) exact resume after checkpoint restore is a matter of
restoring one integer (no file offsets).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# The chain is a dense (V, V) float64 matrix, kept twice (P and its running
# sums) beside three temporaries of the same size while it is built: 5 x 8 V^2
# bytes, 2.7 GB at this vocab.
MAX_VOCAB = 8192


class MarkovCorpus:
    """First-order Markov chain over ``vocab`` states with temperature
    controlling how predictable transitions are (lower => lower entropy)."""

    def __init__(self, vocab: int, seed: int = 0, temperature: float = 0.3):
        if vocab > MAX_VOCAB:
            raise ValueError(
                f"MarkovCorpus over vocab {vocab}: its (V, V) float64 matrices take "
                f"{vocab}^2 x 8 B = {vocab ** 2 * 8 / 1e9:.1f} GB each, five while it is "
                f"built; it takes vocab <= {MAX_VOCAB} (a reduced config, e.g. --reduced)")
        rng = np.random.default_rng(seed)
        logits = rng.normal(size=(vocab, vocab)) / max(temperature, 1e-3)
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z)
        self.P = p / p.sum(axis=1, keepdims=True)  # (V, V)
        self.vocab = vocab
        self._cum = np.cumsum(self.P, axis=1)

    def entropy_rate(self) -> float:
        """Bits... nats per token of the stationary chain (loss floor)."""
        # stationary distribution via power iteration
        pi = np.full(self.vocab, 1.0 / self.vocab)
        for _ in range(200):
            pi = pi @ self.P
        H = -(self.P * np.log(np.maximum(self.P, 1e-12))).sum(axis=1)
        return float((pi * H).sum())

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int32)
        state = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = state
        for t in range(1, seq):
            u = rng.random(batch)
            state = (self._cum[state] > u[:, None]).argmax(axis=1)
            out[:, t] = state
        return out


@dataclasses.dataclass
class SyntheticPipeline:
    """Deterministic, shardable, resumable batch source."""

    corpus: MarkovCorpus
    global_batch: int
    seq_len: int
    shard_index: int = 0
    num_shards: int = 1
    step: int = 0  # checkpointable cursor

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards

    def next_batch(self) -> dict:
        """Tokens for this host's shard at the current step (advances cursor)."""
        rng = np.random.default_rng(
            (self.step * 1_000_003 + self.shard_index) & 0x7FFFFFFF
        )
        tokens = self.corpus.sample(rng, self.shard_batch, self.seq_len)
        self.step += 1
        return {"tokens": tokens}

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
