"""Faults planted underneath the timed path, to show that the comparison
catches them: each a context manager that breaks the program's own module
while it is open. ``portbench/tests`` drives whole runs through them, and
``calibrate.py`` reads a train cell's faults on the card.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def half_batch():
    """Half of each batch left out: the loss is the mean over the rest."""
    from repro_torch.train import train_step

    def make(real):
        def forward_train(params, arch, cfg, batch):
            return real(params, arch, cfg, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
        return forward_train
    return _patched(train_step, "forward_train", make)


def frozen_state():
    """A step that returns its params and optimizer state unchanged."""
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import OptState

    def make(real):
        def adamw_update(params, grads, state, **kwargs):
            return params, OptState(state.mu, state.nu, state.step + 1), {}
        return adamw_update
    return _patched(train_step, "adamw_update", make)


def token_altered(every: int = 3):
    """The logits of every ``every``-th decode step changed where they are
    made, so that each request's token there is another (token 0)."""
    from repro_torch.models import lm

    def make(real):
        calls = [0]

        def decode_step(*args, **kwargs):
            logits, caches = real(*args, **kwargs)
            calls[0] += 1
            if calls[0] % every == 0:
                logits[:, -1, 0] = logits[:, -1].amax(-1) + 1.0
            return logits, caches
        return decode_step
    return _patched(lm, "decode_step", make)


def cache_unwritten():
    """Decode steps that leave the KV cache as it was."""
    from repro_torch.models import lm

    def make(real):
        def _write_cache(cfg, cache, k, v, idx):
            if k.shape[2] > 1:
                real(cfg, cache, k, v, idx)
        return _write_cache
    return _patched(lm, "_write_cache", make)


def attention_dropped():
    """Decode steps whose attention over the KV cache gives zeros."""
    from repro_torch.models import lm

    def make(real):
        def flash_xla(q, k, v, **kwargs):
            out = real(q, k, v, **kwargs)
            return out.zero_() if q.shape[2] == 1 else out
        return flash_xla
    return _patched(lm, "flash_xla", make)


TRAIN = {"half_batch": half_batch, "frozen_state": frozen_state}
SERVE = {"token_altered": token_altered, "cache_unwritten": cache_unwritten,
         "attention_dropped": attention_dropped}
