"""Decoder-only LM: the port's counterpart of ``repro/models/lm.py``, for the
dense family (without sliding window) and the ssm family (Mamba-2): the
full-sequence forward and its training loss, and the cached serving path.

Same layouts as the JAX package at the public functions: params are the same
nested dict, each per-layer leaf stacked on a leading L axis with the same
names; q/k/v are ``(B, H, S, D)``. A Python loop over layer slices takes the
place of ``lax.scan``, and ``torch.utils.checkpoint`` around each layer the
place of ``jax.checkpoint`` around the scan body. The caches (KV for dense,
conv and SSM state for ssm) are updated in place instead of being returned as
new arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.core.arch import ModelArch
from repro_torch.kernels import ops
from repro_torch.kernels.xla_flash import flash_xla
from repro_torch.models import layers as L
from repro_torch.models.ssm import CONV_K, ssm_block, ssm_dims


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Runtime (non-architectural) model options.

    ``attn_impl`` / ``norm_impl`` / ``ssm_impl``: ``"cuda"`` (the hand-written
    kernels, the default), ``"torch"`` (their plain versions) or ``"xla"``
    (the JAX package's "xla" path, ``ops.IMPLS``). ``remat``: the paper's
    recompute granularity, as the JAX package's (``REMATS``). The JAX
    package's serve knobs (``kv_cache_repeat``, ``kv_scatter_write``,
    ``kv_cache_quant``, ``decode_dense_attn``) and its MoE options are not
    ported yet; passing one is a ``TypeError``."""

    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "cuda"
    norm_impl: str = "cuda"
    ssm_impl: str = "cuda"
    remat: str = "none"
    cast_params_in_forward: bool = True  # False => caller pre-casts once

    def __post_init__(self):
        for field in ("attn_impl", "norm_impl", "ssm_impl"):
            if getattr(self, field) not in ops.IMPLS:
                raise ValueError(f"{field} must be one of {ops.IMPLS}, "
                                 f"got {getattr(self, field)!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {self.remat!r}")


# "full": each layer keeps only its input and runs its forward again in the
# backward (JAX's nothing_saveable). "selective": the layer also keeps the
# outputs of its weight products, x @ W, which reach aten.mm (JAX's
# dots_with_no_batch_dims_saveable); the attention einsums (aten.bmm), the
# norms and the elementwise ops run again.
REMATS = ("none", "selective", "full")


def _check_family(arch: ModelArch) -> None:
    if arch.family not in ("dense", "ssm") or arch.sliding_window:
        raise NotImplementedError(
            f"{arch.name}: the port runs the dense and ssm families without "
            f"sliding window only (got family={arch.family!r}, "
            f"sliding_window={arch.sliding_window})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_ZEROS_LEAVES = ("conv_b", "dt_bias", "A_log")  # f32 zeros, whatever dtype is
_F32_ONES_LEAVES = ("D",)


def _layer_param_templates(arch: ModelArch) -> dict[str, tuple[tuple[int, ...], float]]:
    """(shape, init_scale) per per-layer tensor, WITHOUT the L axis. Scale 0.0
    marks the constant leaves: ones for norms and D, zeros for conv_b,
    dt_bias and A_log."""
    _check_family(arch)
    d, hd = arch.hidden, arch.head_dim
    H, Hkv = arch.heads, arch.kv_heads
    fan = 1.0 / (d ** 0.5)
    out_scale = fan / (2.0 * max(arch.num_layers, 1)) ** 0.5
    t: dict[str, tuple[tuple[int, ...], float]] = {}
    if not arch.is_attention_free:
        t["attn.wqkv"] = ((d, (H + 2 * Hkv) * hd), fan)
        t["attn.wo"] = ((H * hd, d), out_scale)
        if arch.qk_norm:
            t["attn.q_norm"] = ((hd,), 0.0)
            t["attn.k_norm"] = ((hd,), 0.0)
    if arch.ffn > 0:
        t["mlp.wi"] = ((d, 2 * arch.ffn), fan)
        t["mlp.wo"] = ((arch.ffn, d), out_scale)
    if arch.family == "ssm":
        di, Hs, _, N = ssm_dims(arch)
        conv_dim = di + 2 * N
        t["ssm.in_proj"] = ((d, 2 * di + 2 * N + Hs), fan)
        t["ssm.conv_w"] = ((CONV_K, conv_dim), 0.5)
        t["ssm.conv_b"] = ((conv_dim,), 0.0)
        t["ssm.dt_bias"] = ((Hs,), 0.0)
        t["ssm.A_log"] = ((Hs,), 0.0)
        t["ssm.D"] = ((Hs,), 0.0)
        t["ssm.out_proj"] = ((di, d), out_scale)
    t["ln1"] = ((d,), 0.0)
    if arch.ffn > 0 and arch.family != "ssm":
        t["ln2"] = ((d,), 0.0)
    return t


def _normal(shape, scale, generator, dtype, device) -> torch.Tensor:
    # drawn straight in `dtype`: at full width an f32 draw of the stacked
    # mlp.wi alone would be a 14.5 GB temporary
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)


def init_params(arch: ModelArch, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Random params in the JAX package's nested layout, drawn from
    ``generator`` (which must live on ``device``; ``None`` -> cuda)."""
    device = resolve_device(device)
    d = arch.hidden
    layers: dict[str, Any] = {}
    for name, (shape, scale) in sorted(_layer_param_templates(arch).items()):
        full = (arch.num_layers,) + shape
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ZEROS_LEAVES:
            arr = torch.zeros(full, dtype=torch.float32, device=device)
        elif scale == 0.0:
            arr = torch.ones(full, device=device,
                             dtype=torch.float32 if leaf in _F32_ONES_LEAVES else dtype)
        else:
            arr = _normal(full, scale, generator, dtype, device)
        node = layers
        *parents, last = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = arr
    params: dict[str, Any] = {
        "embed": _normal((arch.vocab, d), 1.0 / (d ** 0.5), generator, dtype, device),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not arch.tie_embeddings:
        params["lm_head"] = _normal((d, arch.vocab), 1.0 / (d ** 0.5), generator,
                                    dtype, device)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Floating leaves -> ``dtype`` (a leaf already in it is not copied)."""
    return _tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def _layer(layers: dict, i: int) -> dict:
    return _tree_map(lambda x: x[i], layers)


# ---------------------------------------------------------------------------
# sub-layers
# ---------------------------------------------------------------------------

def _attn_sublayer(p: dict, h: torch.Tensor, positions: torch.Tensor,
                   arch: ModelArch, cfg: ModelCfg, cache) -> torch.Tensor:
    """Self-attention. cache: None (full sequence) or (k, v, start_pos), the
    layer's cache views, written in place at start_pos."""
    B, S, _ = h.shape
    H, Hkv, D = arch.heads, arch.kv_heads, arch.head_dim
    q, k, v = torch.split(h @ p["wqkv"], [H * D, Hkv * D, Hkv * D], dim=-1)
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    if arch.qk_norm:
        # normalised before the head transpose, as the JAX package does; the
        # norm kernel reads the q and k views of the fused product in place
        q = L.norm(q, p["q_norm"], impl=cfg.norm_impl)
        k = L.norm(k, p["k_norm"], impl=cfg.norm_impl)
    q = L.rope(q.transpose(1, 2), positions)
    k = L.rope(k.transpose(1, 2), positions)
    v = v.transpose(1, 2)
    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True, impl=cfg.attn_impl)
    else:
        ck, cv, start = cache
        ck[:, :, start:start + S] = k
        cv[:, :, start:start + S] = v
        out = flash_xla(q, ck, cv, q_start=start, kv_valid_len=start + S, causal=True)
    out = out.transpose(1, 2).reshape(B, S, H * D)
    return out @ p["wo"]


def _layer_fn(arch: ModelArch, cfg: ModelCfg, lp: dict, h: torch.Tensor,
              positions: torch.Tensor, cache: Optional[dict]) -> torch.Tensor:
    """cache: None (full sequence) or the layer's cache views, written in
    place: ``{"k", "v", "start"}`` for dense, ``{"conv", "state"}`` for ssm."""
    if arch.family == "ssm":
        s, new_cache = ssm_block(
            lp["ssm"], L.norm(h, lp["ln1"], impl=cfg.norm_impl), arch,
            ssm_impl=cfg.ssm_impl,
            cache=None if cache is None else (cache["conv"], cache["state"]))
        if new_cache is not None:
            cache["conv"].copy_(new_cache[0])
            cache["state"].copy_(new_cache[1])
        return h + s
    a = _attn_sublayer(lp["attn"], L.norm(h, lp["ln1"], impl=cfg.norm_impl), positions,
                       arch, cfg,
                       None if cache is None else (cache["k"], cache["v"], cache["start"]))
    h = h + a
    if arch.ffn > 0:
        h = h + L.swiglu(lp["mlp"], L.norm(h, lp["ln2"], impl=cfg.norm_impl))
    return h


def _head(params: dict, arch: ModelArch, cfg: ModelCfg, h: torch.Tensor) -> torch.Tensor:
    h = L.norm(h, params["final_norm"], impl=cfg.norm_impl)
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return h @ head.to(h.dtype)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _save_weight_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _selective_contexts():
    return create_selective_checkpoint_contexts(_save_weight_products)


def _train_layer(arch: ModelArch, cfg: ModelCfg, lp: dict, h: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """One layer of the full-sequence forward under ``cfg.remat``."""
    if cfg.remat == "none":
        return _layer_fn(arch, cfg, lp, h, positions, None)
    extra = {"context_fn": _selective_contexts} if cfg.remat == "selective" else {}
    return checkpoint(_layer_fn, arch, cfg, lp, h, positions, None, use_reentrant=False,
                      **extra)


def forward_logits(params: dict, arch: ModelArch, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    """Full-sequence forward over ``batch["tokens"]`` (B, S). Returns (B, S, V)
    logits. Attention goes through the flash-attention kernel, the ssm mixer
    through the SSD kernel."""
    _check_family(arch)
    if cfg.cast_params_in_forward:
        params = cast_params(params, cfg.dtype)
    tokens = batch["tokens"]
    h = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(arch.num_layers):
        h = _train_layer(arch, cfg, _layer(params["layers"], i), h, positions)
    return _head(params, arch, cfg, h)


def forward_train(params: dict, arch: ModelArch, cfg: ModelCfg, batch: dict):
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S), logits in
    f32, averaged over ``batch["loss_mask"]`` (B, S) where given (position t
    weighs the prediction of token t). Returns ``(loss, {"ce_loss",
    "loss"})``. The MoE family's aux loss is not ported (``_check_family``
    refuses the family)."""
    logits = forward_logits(params, arch, cfg, batch)
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1, :].float()
    del logits
    nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        m = mask[:, 1:].float()
        loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss, {"ce_loss": loss, "loss": loss}


# ---------------------------------------------------------------------------
# serving: caches / prefill / decode
# ---------------------------------------------------------------------------

def init_caches(arch: ModelArch, cfg: ModelCfg, batch_size: int, max_len: int,
                device=None) -> dict:
    """Per-layer-stacked decode caches: ``{"k", "v"}`` of (L, B, Hkv, max_len,
    D) for attention, ``{"conv"}`` (L, B, CONV_K - 1, conv channels) in
    ``cfg.dtype`` and ``{"state"}`` (L, B, H, P, N) f32 for ssm."""
    _check_family(arch)
    device = resolve_device(device)
    Ld = arch.num_layers
    caches: dict[str, torch.Tensor] = {}
    if not arch.is_attention_free:
        shape = (Ld, batch_size, arch.kv_heads, max_len, arch.head_dim)
        caches["k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        caches["v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    if arch.family == "ssm":
        di, H, P, N = ssm_dims(arch)
        caches["conv"] = torch.zeros((Ld, batch_size, CONV_K - 1, di + 2 * N),
                                     dtype=cfg.dtype, device=device)
        caches["state"] = torch.zeros((Ld, batch_size, H, P, N),
                                      dtype=torch.float32, device=device)
    return caches


@torch.no_grad()
def forward_cached(params: dict, arch: ModelArch, cfg: ModelCfg, caches: dict,
                   tokens: torch.Tensor, start_pos: int):
    """Shared prefill/decode path: processes S tokens starting at start_pos.

    Writes into ``caches`` in place (the tokens' K/V at start_pos; the new
    conv history and SSM state) and returns ``(logits, caches)`` (the same
    dict), mirroring the JAX signature."""
    _check_family(arch)
    if cfg.cast_params_in_forward:
        params = cast_params(params, cfg.dtype)
    h = params["embed"][tokens].to(cfg.dtype)
    S = h.shape[1]
    if "k" in caches and start_pos + S > caches["k"].shape[3]:
        raise ValueError(f"positions {start_pos}..{start_pos + S - 1} past the "
                         f"KV cache of length {caches['k'].shape[3]}")
    positions = start_pos + torch.arange(S, device=h.device)
    for i in range(arch.num_layers):
        cache = {name: c[i] for name, c in caches.items()}
        cache["start"] = start_pos
        h = _layer_fn(arch, cfg, _layer(params["layers"], i), h, positions, cache)
    return _head(params, arch, cfg, h), caches


def prefill(params, arch, cfg, caches, tokens):
    return forward_cached(params, arch, cfg, caches, tokens, 0)


def decode_step(params, arch, cfg, caches, tokens, position: int):
    """tokens: (B, 1) new token ids; position: current sequence length."""
    return forward_cached(params, arch, cfg, caches, tokens, position)
