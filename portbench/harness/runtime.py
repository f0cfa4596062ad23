"""What the drivers share: the device, the clock, and the port's view of a
configuration. The program (``repro_torch``) is imported only inside the
functions that hand it its inputs.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench.harness.spec import Shape

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def port_arch(s: Shape):
    """The port's ``ModelArch`` of a configuration: the dense family, or the
    moe family where it has sparse experts, with the configuration's head
    size. Its attention windows, by this contract:

      * every layer full: no window;
      * every layer under one window W: ``sliding_window=W``;
      * full and windowed layers mixed: ``sliding_window=W`` and
        ``layer_types``, the tuple of each layer's published kind
        (``full_attention`` or ``sliding_attention``), which only a
        ``ModelArch`` with a ``layer_types`` field takes; without one, a
        ``ValueError`` that names the field.
    """
    from repro_torch.core.arch import ModelArch

    sizes = dict(name=s.name, num_layers=s.layers, hidden=s.hidden, heads=s.heads,
                 kv_heads=s.kv_heads, vocab=s.vocab, tie_embeddings=s.tie,
                 head_dim=s.head_dim)
    if max(s.windows):
        sizes["sliding_window"] = max(s.windows)
    if len(set(s.windows)) > 1:
        if "layer_types" not in {f.name for f in dataclasses.fields(ModelArch)}:
            raise ValueError(f"{s.name}: full and sliding-window layers mixed "
                             f"({', '.join(s.layer_types)}); the port's ModelArch has no "
                             f"layer_types field to take them")
        sizes["layer_types"] = s.layer_types
    if s.experts:
        return ModelArch(family="moe", ffn=s.expert_ffn, num_experts=s.experts,
                         top_k=s.top_k, moe_ffn=s.expert_ffn, **sizes)
    return ModelArch(family="dense", ffn=s.ffn, **sizes)


def moe_options(s: Shape, mix: dict) -> dict:
    """The port's ``ModelCfg`` options of a mix that a mixture of experts
    runs: its capacity factor and load-balancing weight (none for a dense
    model, whose options stay the port's defaults)."""
    if not s.experts:
        return {}
    return {"capacity_factor": float(mix["capacity_factor"]),
            "moe_aux_weight": float(mix["moe_aux_weight"])}


def check_port_constants(s: Shape) -> None:
    """The port has no option for these; a configuration that states other
    values is not what it runs."""
    import inspect

    from repro_torch.kernels import ops
    from repro_torch.models import layers

    eps = inspect.signature(ops.fused_rmsnorm).parameters["eps"].default
    theta = inspect.signature(layers.rope).parameters["theta"].default
    if (eps, theta) != (s.norm_eps, s.rope_theta):
        raise ValueError(f"{s.name}: the port runs rms_norm_eps {eps} and rope_theta {theta}, "
                         f"the configuration states {s.norm_eps} and {s.rope_theta}")
    if abs(s.scale - s.head_dim ** -0.5) > 1e-12:
        raise ValueError(f"{s.name}: the port scales attention by 1 / sqrt(head_dim)")


def launch_counters() -> dict:
    """The port's kernel wrappers' launch counts (K1, K2)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    return {"rmsnorm": rmsnorm_fwd.launches, "flash_attention": flash_attention_fwd.launches}


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.float()))
