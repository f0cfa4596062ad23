"""Decoder-only LM: the port's counterpart of ``repro/models/lm.py``, for the
dense, moe, ssm (Mamba-2) and hybrid (attention and Mamba-2 heads side by
side, hymba) families: the full-sequence forward and its training loss (with
the MoE aux loss), and the cached serving path with the JAX package's
KV-cache options. A sliding-window model keeps a ring KV cache of the window
and runs its full-sequence attention through ``banded_flash_xla`` once the
sequence is longer than the window.

Same layouts as the JAX package at the public functions: params are the same
nested dict, each per-layer leaf stacked on a leading L axis with the same
names; q/k/v are ``(B, H, S, D)``. A Python loop over layer slices takes the
place of ``lax.scan``, and ``torch.utils.checkpoint`` around each layer the
place of ``jax.checkpoint`` around the scan body. The caches (KV, with
int8 scales under ``kv_cache_quant``; conv and SSM state) are updated in
place instead of being returned as new arrays.
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
from repro_torch.kernels.xla_flash import banded_flash_xla, flash_xla
from repro_torch.models import layers as L
from repro_torch.models.moe import aux_load_balance_loss, moe_block
from repro_torch.models.ssm import CONV_K, ssm_block, ssm_dims


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Runtime (non-architectural) model options.

    ``attn_impl`` / ``norm_impl`` / ``ssm_impl``: ``"cuda"`` (the hand-written
    kernels, the default), ``"torch"`` (their plain versions) or ``"xla"``
    (the JAX package's "xla" path, ``ops.IMPLS``). ``remat``: the paper's
    recompute granularity, as the JAX package's (``REMATS``). The MoE
    options and the serve path's KV-cache options take the JAX package's
    names and defaults. Its activation shardings (``act_shard``) belong to
    sharding, which is not ported; passing it is a ``TypeError``."""

    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "cuda"
    norm_impl: str = "cuda"
    ssm_impl: str = "cuda"
    remat: str = "none"
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    cast_params_in_forward: bool = True  # False => caller pre-casts once
    # decode (S <= 16): attention as one masked product over the whole cache
    # instead of the blockwise online softmax
    decode_dense_attn: bool = False
    # the KV cache keeps each kv head r times (repeat_interleave), Hkv * r heads
    kv_cache_repeat: int = 1
    # write the cache through an index (scatter) instead of a slice
    kv_scatter_write: bool = False
    # int8 KV cache with a bf16 scale per (token, head)
    kv_cache_quant: bool = False

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


FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_family(arch: ModelArch) -> None:
    if arch.family not in FAMILIES:
        raise NotImplementedError(
            f"{arch.name}: the port runs the {', '.join(FAMILIES)} families, not "
            f"{arch.family!r} (encdec and vlm wait for their own slice)")


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
    if arch.family == "moe":
        F = arch.moe_ffn or arch.ffn
        t["moe.router"] = ((d, arch.num_experts), fan)
        t["moe.wi"] = ((arch.num_experts, d, 2 * F), fan)
        t["moe.wo"] = ((arch.num_experts, F, d), out_scale)
        if arch.shared_expert:
            t["moe.shared_wi"] = ((d, 2 * F), fan)
            t["moe.shared_wo"] = ((F, d), out_scale)
    elif arch.ffn > 0:
        t["mlp.wi"] = ((d, 2 * arch.ffn), fan)
        t["mlp.wo"] = ((arch.ffn, d), out_scale)
    if arch.family in ("ssm", "hybrid"):
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
    if arch.family == "moe" or (arch.ffn > 0 and arch.family != "ssm"):
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

def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, Hkv, S, D) -> int8 values and a bf16 scale per (B, Hkv, S): the
    row's max |x| / 127, rounded half to even as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def _dense_cached_attention(q, k, v, start_pos: int, *, ring: bool = False) -> torch.Tensor:
    """Decode-path attention as one masked product over the whole cache. The
    JAX package multiplies its operands with f32 accumulation; widening them
    to f32 first gives the same products (those of two bf16 values are exact
    in f32). The probabilities go back to v's dtype before the second
    product, as there."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, S, D)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), k.float()) / (D ** 0.5)
    if not (ring and start_pos + S - 1 >= T):
        qpos = start_pos + torch.arange(S, device=q.device)
        mask = torch.arange(T, device=q.device)[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


def _write_cache(cfg: ModelCfg, cache: dict, k: torch.Tensor, v: torch.Tensor,
                 idx: int) -> None:
    """k/v (B, Hkv', S, D) into the layer's cache views at slots idx .. idx +
    S - 1, int8 with scales under kv_cache_quant, by index or by slice."""
    S = k.shape[2]
    if cfg.kv_cache_quant:
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
        rows = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    else:
        rows = {"k": k, "v": v}
    slots = (torch.arange(idx, idx + S, device=k.device) if cfg.kv_scatter_write
             else slice(idx, idx + S))
    for name, x in rows.items():
        cache[name][:, :, slots] = x.to(cache[name].dtype)


def _attn_sublayer(p: dict, h: torch.Tensor, positions: torch.Tensor,
                   arch: ModelArch, cfg: ModelCfg, cache: Optional[dict]) -> torch.Tensor:
    """Self-attention. cache: None (full sequence) or the layer's cache views
    ``{"k", "v"[, "k_scale", "v_scale"], "start"}``, written in place.

    With a sliding window the cache is a ring of T slots in which slot j
    holds the position p with ``p % T == j``. A prefill of S >= T tokens
    attends through ``banded_flash_xla`` and keeps the last T positions;
    shorter chunks are written at ``start % T`` and must not cross the end of
    the ring (the JAX package clamps such a slice, or drops the rows of such
    a scatter: a different answer, refused here)."""
    B, S, _ = h.shape
    H, Hkv, D = arch.heads, arch.kv_heads, arch.head_dim
    window = arch.sliding_window or 0
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
        if window and window < S:
            out = banded_flash_xla(q, k, v, window=window)
        else:
            out = ops.flash_attention(q, k, v, causal=True, impl=cfg.attn_impl)
    else:
        if cfg.kv_cache_repeat > 1:
            k = k.repeat_interleave(cfg.kv_cache_repeat, dim=1)
            v = v.repeat_interleave(cfg.kv_cache_repeat, dim=1)
        start, T = cache["start"], cache["k"].shape[2]
        if window and S >= T:
            if start:
                raise ValueError(f"a ring-cache prefill of {S} >= {T} tokens starts at "
                                 f"position 0, not {start}")
            out = banded_flash_xla(q, k, v, window=window)
            # ring invariant: slot j holds position p with p % T == j
            shift = (S - T) % T
            _write_cache(cfg, cache, torch.roll(k[:, :, -T:], shift, dims=2),
                         torch.roll(v[:, :, -T:], shift, dims=2), 0)
        else:
            idx = start % T if window else start
            if idx + S > T:
                raise ValueError(f"positions {start}..{start + S - 1} cross the end of the "
                                 f"{T}-slot KV cache at slot {idx}")
            _write_cache(cfg, cache, k, v, idx)
            if cfg.kv_cache_quant:
                k_read = _kv_dequantize(cache["k"], cache["k_scale"], cfg.dtype)
                v_read = _kv_dequantize(cache["v"], cache["v_scale"], cfg.dtype)
            else:
                k_read, v_read = cache["k"], cache["v"]
            if cfg.decode_dense_attn and S <= 16:
                out = _dense_cached_attention(q, k_read, v_read, start, ring=bool(window))
            else:
                out = flash_xla(q, k_read, v_read, q_start=start, kv_valid_len=start + S,
                                ring=bool(window), causal=True)
    out = out.transpose(1, 2).reshape(B, S, H * D)
    return out @ p["wo"]


def _ssm_sublayer(arch: ModelArch, cfg: ModelCfg, p: dict, x: torch.Tensor,
                  cache: Optional[dict]) -> torch.Tensor:
    """The Mamba-2 mixer; with a cache, its conv history and state are
    replaced in place."""
    s, new_cache = ssm_block(p, x, arch, ssm_impl=cfg.ssm_impl,
                             cache=None if cache is None else (cache["conv"], cache["state"]))
    if new_cache is not None:
        cache["conv"].copy_(new_cache[0])
        cache["state"].copy_(new_cache[1])
    return s


def _layer_fn(arch: ModelArch, cfg: ModelCfg, lp: dict, h: torch.Tensor,
              positions: torch.Tensor, cache: Optional[dict]) -> torch.Tensor:
    """cache: None (full sequence) or the layer's cache views, written in
    place: ``{"k", "v"[, "k_scale", "v_scale"], "start"}`` for attention,
    ``{"conv", "state"}`` for the mixer; the hybrid has both."""
    family = arch.family
    x = L.norm(h, lp["ln1"], impl=cfg.norm_impl)
    if family == "ssm":
        return h + _ssm_sublayer(arch, cfg, lp["ssm"], x, cache)
    a = _attn_sublayer(lp["attn"], x, positions, arch, cfg, cache)
    if family == "hybrid":
        # hymba: attention and mamba heads run side by side on one input
        h = h + 0.5 * (a + _ssm_sublayer(arch, cfg, lp["ssm"], x, cache))
    else:
        h = h + a
    if family == "moe":
        return h + moe_block(lp["moe"], L.norm(h, lp["ln2"], impl=cfg.norm_impl),
                             top_k=arch.top_k, capacity_factor=cfg.capacity_factor)
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
    logits. Attention goes through the flash-attention kernel (through
    ``banded_flash_xla`` when a sliding window is shorter than S), the ssm
    mixer through the SSD kernel."""
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
    "loss"})``; the moe family adds ``moe_aux_weight`` times the
    load-balancing loss, reported as ``"aux_loss"``. As in the JAX package,
    that loss is layer 0's router applied to the embedded tokens."""
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
    metrics = {"ce_loss": loss}
    if arch.family == "moe" and cfg.moe_aux_weight > 0:
        h = params["embed"][batch["tokens"]].to(cfg.dtype)
        aux = aux_load_balance_loss(_tree_map(lambda x: x[0], params["layers"]["moe"]), h,
                                    top_k=arch.top_k)
        metrics["aux_loss"] = aux
        loss = loss + cfg.moe_aux_weight * aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: caches / prefill / decode
# ---------------------------------------------------------------------------

def init_caches(arch: ModelArch, cfg: ModelCfg, batch_size: int, max_len: int,
                device=None) -> dict:
    """Per-layer-stacked decode caches: ``{"k", "v"}`` of (L, B, Hkv * r, T,
    D) for attention, r = ``kv_cache_repeat`` and T = max_len, or the window
    when that is shorter (a ring); in ``cfg.dtype``, or int8 beside bf16
    ``{"k_scale", "v_scale"}`` (L, B, Hkv * r, T) under ``kv_cache_quant``.
    ``{"conv"}`` (L, B, CONV_K - 1, conv channels) in ``cfg.dtype`` and
    ``{"state"}`` (L, B, H, P, N) f32 for the ssm and hybrid mixers."""
    _check_family(arch)
    device = resolve_device(device)
    Ld = arch.num_layers
    caches: dict[str, torch.Tensor] = {}
    if not arch.is_attention_free:
        kv_len = min(max_len, arch.sliding_window) if arch.sliding_window else max_len
        kv_heads = arch.kv_heads * max(cfg.kv_cache_repeat, 1)
        shape = (Ld, batch_size, kv_heads, kv_len, arch.head_dim)
        kv_dtype = torch.int8 if cfg.kv_cache_quant else cfg.dtype
        caches["k"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        caches["v"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        if cfg.kv_cache_quant:
            caches["k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
            caches["v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
    if arch.family in ("ssm", "hybrid"):
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

    Writes into ``caches`` in place (the tokens' K/V; the new conv history and
    SSM state) and returns ``(logits, caches)`` (the same dict), mirroring
    the JAX signature. Positions must lie in the KV cache, except in a ring
    that holds the whole window, which serves any position."""
    _check_family(arch)
    if cfg.cast_params_in_forward:
        params = cast_params(params, cfg.dtype)
    h = params["embed"][tokens].to(cfg.dtype)
    S = h.shape[1]
    if "k" in caches:
        T = caches["k"].shape[3]
        if T != arch.sliding_window and start_pos + S > T:
            raise ValueError(f"positions {start_pos}..{start_pos + S - 1} past the "
                             f"KV cache of length {T}")
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
