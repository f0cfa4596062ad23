"""Faults planted underneath the timed path, to show that the comparison
catches them: each a context manager that breaks the program's own module
while it is open. ``portbench/tests`` drives whole runs through them, and
``calibrate.py`` reads a train cell's faults on the card.
"""
from __future__ import annotations

import contextlib

import torch


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


def experts_shifted():
    """Each assignment computed by the next expert, (e + 1) mod E, the
    routing and the gates left as they are."""
    from repro_torch.models import moe

    def make(real):
        def _experts(grouped, wi, wo, *args, **kwargs):
            return real(grouped, wi.roll(-1, 0), wo.roll(-1, 0), *args, **kwargs)
        return _experts
    return _patched(moe, "_experts", make)


def gates_uniform():
    """The router's experts weighed alike, 1 / k each."""
    from repro_torch.models import moe

    def make(real):
        def select(p, xt, top_k):
            gates, experts = real(p, xt, top_k)
            return torch.full_like(gates, 1.0 / top_k), experts
        return select
    return _patched(moe, "select", make)


def router_reversed():
    """The top k of the negated router logits, the gates a softmax over the
    logits at those experts: a wrong router whose products are sound."""
    from repro_torch.models import moe

    def make(real):
        def select(p, xt, top_k):
            logits = xt.float() @ p["router"].float()
            experts = torch.topk(-logits, top_k, dim=-1).indices
            return torch.softmax(logits.gather(-1, experts), dim=-1).to(xt.dtype), experts
        return select
    return _patched(moe, "select", make)


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


@contextlib.contextmanager
def attention_dropped():
    """Decode steps whose attention over the KV cache gives zeros, on either
    route: K2 over a plain cache (``_flash_cached_attention``), ``flash_xla``
    over the others."""
    from repro_torch.models import lm

    def make(real):
        def attend(q, *args, **kwargs):
            out = real(q, *args, **kwargs)
            return out.zero_() if q.shape[2] == 1 else out
        return attend
    with _patched(lm, "flash_xla", make), _patched(lm, "_flash_cached_attention", make):
        yield


def window_ignored():
    """The sliding-window layers' attention over every earlier key: the
    port's banded attention replaced by full causal attention."""
    from repro_torch.kernels import ops

    def make(real):
        def banded_attention(q, k, v, *, window):
            return ops.flash_attention(q, k, v, causal=True)
        return banded_attention
    return _patched(ops, "banded_attention", make)


TRAIN = {"half_batch": half_batch, "frozen_state": frozen_state}
MOE_TRAIN = {"experts_shifted": experts_shifted, "gates_uniform": gates_uniform,
             "router_reversed": router_reversed}
SERVE = {"token_altered": token_altered, "cache_unwritten": cache_unwritten,
         "attention_dropped": attention_dropped}


def train_faults(s, seq: int) -> dict:
    """The faults a train cell of the configuration ``s`` (a ``Shape``) at
    the sequence length ``seq`` can have: a mixture of experts adds its
    routing's and its experts', a layer whose window is shorter than the
    sequence ``window_ignored``."""
    windowed = any(0 < W < seq for W in s.windows)
    return (TRAIN | (MOE_TRAIN if s.experts else {})
            | ({"window_ignored": window_ignored} if windowed else {}))
