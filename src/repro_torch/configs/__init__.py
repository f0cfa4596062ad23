"""Architecture registry of the port: every assigned model of the JAX
package (dense, ssm, hybrid, moe, encdec and vlm) and the paper's own models.

Each config module keeps its own copy of the JAX package's ``ARCH`` (the
published config) and ``reduced()`` (a small same-family config for CPU
tests). An unknown name is a ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.core.arch import ModelArch

# the JAX package's assigned models, in its order
ASSIGNED = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e", "qwen3-32b", "yi-6b",
            "command-r-35b", "qwen3-8b", "hymba-1.5b", "whisper-tiny", "mamba2-370m",
            "pixtral-12b")

_MODULES = {"qwen3-8b": "qwen3_8b", "yi-6b": "yi_6b", "mamba2-370m": "mamba2_370m",
            "qwen3-32b": "qwen3_32b", "command-r-35b": "command_r_35b",
            "hymba-1.5b": "hymba_1_5b", "granite-moe-3b-a800m": "granite_moe_3b_a800m",
            "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
            "whisper-tiny": "whisper_tiny", "pixtral-12b": "pixtral_12b"}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; known: "
            f"{sorted(_MODULES) + sorted(PAPER_MODELS)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_arch(name: str) -> ModelArch:
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]
    return _module(name).ARCH


def get_reduced(name: str) -> ModelArch:
    return _module(name).reduced()


# --- the paper's own evaluation models (dense llama/glm families) ----------
def _dense(name, L, d, H, kv, ffn, vocab) -> ModelArch:
    return ModelArch(name=name, family="dense", num_layers=L, hidden=d,
                     heads=H, kv_heads=kv, ffn=ffn, vocab=vocab)


PAPER_MODELS = {
    "llama2-7b": _dense("llama2-7b", 32, 4096, 32, 32, 11008, 32000),
    "llama2-13b": _dense("llama2-13b", 40, 5120, 40, 40, 13824, 32000),
    "llama2-70b": _dense("llama2-70b", 80, 8192, 64, 8, 28672, 32000),
    "llama3-8b": _dense("llama3-8b", 32, 4096, 32, 8, 14336, 128256),
    "llama3-70b": _dense("llama3-70b", 80, 8192, 64, 8, 28672, 128256),
    "glm-67b": _dense("glm-67b", 64, 8192, 64, 64, 22016, 65024),
    "glm-130b": _dense("glm-130b", 70, 12288, 96, 96, 32768, 150528),
}
