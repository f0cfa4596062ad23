"""Minimal batched serving engine: prefill once, then decode greedily or with
temperature (counterpart of ``repro/serve/engine.py``)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ModelArch
from repro_torch.models import lm
from repro_torch.models.lm import ModelCfg


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray  # (B, prompt + generated)
    prompt_len: int
    # wall time per decode step (seconds, one per generated token), each
    # ending in a device synchronise on the card
    step_times: tuple = ()
    # leading step_times entries that absorbed first-call set-up (1 on the
    # first generate at a given batch size, 0 once the engine is warm);
    # consumers drop these
    warmup_steps: int = 0
    prefill_time: float = 0.0  # seconds, synchronised like step_times


class ServeEngine:
    """Serves ``params`` (already on ``device``; ``None`` -> cuda)."""

    def __init__(self, arch: ModelArch, cfg: ModelCfg, params: dict,
                 max_len: int = 512, device=None):
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params lie on {embed.device}, engine runs on {self.device}")
        self.arch, self.cfg, self.params = arch, cfg, params
        self.max_len = max_len
        self._warm_batches: set[int] = set()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> GenerateResult:
        """prompts: (B, S_prompt) token ids. Sampling with temperature draws
        from the engine's ``torch.Generator`` seeded with ``seed``."""
        B, S = prompts.shape
        total = S + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt_len ({S}) + max_new_tokens ({max_new_tokens}) = {total} "
                f"exceeds max_len ({self.max_len}); decode positions past the KV "
                f"cache would clobber it silently"
            )
        caches = lm.init_caches(self.arch, self.cfg, B, self.max_len, device=self.device)
        toks = torch.as_tensor(np.asarray(prompts), device=self.device).long()
        t0 = time.perf_counter()
        logits, caches = lm.prefill(self.params, self.arch, self.cfg, caches, toks)
        self._sync()
        prefill_time = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [toks]
        last = logits[:, -1, :]
        warmup = 0 if B in self._warm_batches else min(1, max_new_tokens)
        step_times = []
        for i in range(max_new_tokens):
            t0 = time.perf_counter()
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)
            else:
                nxt = torch.argmax(last, dim=-1, keepdim=True)
            out.append(nxt)
            logits, caches = lm.decode_step(self.params, self.arch, self.cfg, caches,
                                            nxt, S + i)
            last = logits[:, -1, :]
            self._sync()
            step_times.append(time.perf_counter() - t0)
        if max_new_tokens > 0:
            self._warm_batches.add(B)
        return GenerateResult(
            tokens=torch.cat(out, dim=1).cpu().numpy(), prompt_len=S,
            step_times=tuple(step_times), warmup_steps=warmup,
            prefill_time=prefill_time,
        )
