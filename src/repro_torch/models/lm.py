"""The LM: the port's counterpart of ``repro/models/lm.py``, for every family
of the JAX package: dense, moe, ssm (Mamba-2), hybrid (attention and Mamba-2
heads side by side, hymba), encdec (a bidirectional encoder over stub frame
embeddings, cross-attended by every decoder layer, whisper) and vlm (stub
patch embeddings in front of the text, pixtral): the full-sequence forward
and its training loss (with the MoE aux loss), and the cached serving path
with the JAX package's KV-cache options. A sliding-window model keeps a ring
KV cache of the window and runs its full-sequence attention through
``banded_flash_xla`` once the sequence is longer than the window. The cached
path attends over a cache that is neither a ring nor int8 through the flash
kernel under the ``"cuda"`` impl, as the full-sequence path does; a ring, an
int8 cache and the ``"xla"`` and ``"torch"`` impls go through ``flash_xla``,
as does a sharded cache split over its sequence.

Same layouts as the JAX package at the public functions: params are the same
nested dict, each per-layer leaf stacked on a leading L axis with the same
names (an encdec model's encoder under ``params["encoder"]``); q/k/v are
``(B, H, S, D)``. A Python loop over layer slices takes the place of
``lax.scan``, and ``torch.utils.checkpoint`` around each layer the
place of ``jax.checkpoint`` around the scan body. The caches (KV, with
int8 scales under ``kv_cache_quant``; conv and SSM state) are updated in
place instead of being returned as new arrays.

Sharded (``repro_torch.parallel``): the full-sequence forward and its loss
take params and a batch of DTensors, placed by ``param_specs`` and
``batch_spec``, for every family; the stub inputs (an encdec model's frames,
a vlm model's frontend embeddings) lie over the batch axes as the tokens do.
DTensor's propagation inserts the collectives; the layer carry (the
encoder's too) is pinned by ``constrain_batch_sharding`` where the JAX
package pins it,
``ModelCfg.act_shard`` pins the activations it pins, and the logits are made
whole over "model" before the loss. The kernels, the sliding window's banded
attention and the Mamba-2 mixer's conv and scan run on each rank's shards
through ``local_apply`` (``ops``, ``models/ssm.py``; the cross-attention on
each rank's q heads), as does the MoE block, whose dispatch keeps the global capacity and drops of the unsharded
program (``models/moe.py``); the aux loss takes its means over the global
tokens and comes back, with the loss, as a plain tensor. The cached path
(prefill and decode) takes params, caches and tokens as DTensors too, placed
by ``param_specs``, ``cache_specs`` and ``batch_spec``: the KV cache, a ring
included, over its heads or its sequence (``_sharded_cached_attention``,
dense decode attention too), the conv and state caches written in place on
each rank's shard, an encdec model's cross K/V placed by ``init_caches``; an
MoE layer's capacity there comes from the chunk's global B x S.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device, spans
from repro_torch.core.arch import ModelArch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd, scored_pairs
from repro_torch.kernels.xla_flash import banded_flash_xla, flash_xla, flash_xla_lse, live_pairs
from repro_torch.models import layers as L
from repro_torch.models.moe import aux_load_balance_loss, moe_block
from repro_torch.models.ssm import CONV_K, ssm_block, ssm_dims
from repro_torch.parallel.sharding import (MODEL_AXIS, P, constrain_batch_sharding,
                                           gather_fsdp, local_apply, placements,
                                           split_over_model, whole_over_model)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Runtime (non-architectural) model options.

    ``attn_impl`` / ``norm_impl`` / ``ssm_impl``: ``"cuda"`` (the hand-written
    kernels, the default), ``"torch"`` (their plain versions) or ``"xla"``
    (the JAX package's "xla" path, ``ops.IMPLS``). ``remat``: the paper's
    recompute granularity, as the JAX package's (``REMATS``). The MoE
    options and the serve path's KV-cache options take the JAX package's
    names and defaults. ``act_shard``: explicit activation shardings,
    ``{"batch": axes, "model": axis}`` or None (see ``constrain``)."""

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
    # explicit activation shardings: {"batch": axes, "model": axis} or None
    act_shard: Any = None

    def __post_init__(self):
        for field in ("attn_impl", "norm_impl", "ssm_impl"):
            if getattr(self, field) not in ops.IMPLS:
                raise ValueError(f"{field} must be one of {ops.IMPLS}, "
                                 f"got {getattr(self, field)!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {self.remat!r}")

    def constrain(self, x, dims: tuple):
        """Redistribute ``x`` by logical dim tags per position: 'b' -> the
        batch axes, 'm' -> the model axis, None -> unsharded (and whole over
        every mesh dim not named). The identity without ``act_shard`` or on a
        plain tensor, which lies on no mesh."""
        if self.act_shard is None or not isinstance(x, DTensor):
            return x
        tags = {"b": self.act_shard.get("batch"), "m": self.act_shard.get("model")}
        spec = P(*(tags.get(d) for d in dims))
        return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


# "full": each layer keeps only its input and runs its forward again in the
# backward (JAX's nothing_saveable). "selective": the layer also keeps the
# outputs of its weight products, x @ W, which reach aten.mm (JAX's
# dots_with_no_batch_dims_saveable); the attention einsums (aten.bmm), the
# norms and the elementwise ops run again.
REMATS = ("none", "selective", "full")


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(arch: ModelArch) -> None:
    if arch.family not in FAMILIES:
        raise ValueError(f"{arch.name}: unknown family {arch.family!r}; the families are "
                         f"{', '.join(FAMILIES)}")


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
    if arch.family == "encdec":
        t["cross.wq"] = ((d, H * hd), fan)
        t["cross.wkv"] = ((d, 2 * Hkv * hd), fan)
        t["cross.wo"] = ((H * hd, d), out_scale)
        t["ln_cross"] = ((d,), 0.0)
    t["ln1"] = ((d,), 0.0)
    if arch.family == "moe" or (arch.ffn > 0 and arch.family != "ssm"):
        t["ln2"] = ((d,), 0.0)
    return t


def _normal(shape, scale, generator, dtype, device) -> torch.Tensor:
    # drawn straight in `dtype`: at full width an f32 draw of the stacked
    # mlp.wi alone would be a 14.5 GB temporary
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(scale)


def _init_layer_stack(arch: ModelArch, n_layers: int, generator: torch.Generator,
                      dtype: torch.dtype, device: torch.device) -> dict:
    layers: dict[str, Any] = {}
    for name, (shape, scale) in sorted(_layer_param_templates(arch).items()):
        full = (n_layers,) + shape
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
    return layers


def _encoder_arch(arch: ModelArch) -> ModelArch:
    """The encoder's layers: dense ones of the model's width, without q/k norms."""
    return dataclasses.replace(arch, family="dense", qk_norm=False)


def init_params(arch: ModelArch, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Random params in the JAX package's nested layout, drawn from
    ``generator`` (which must live on ``device``; ``None`` -> cuda)."""
    device = resolve_device(device)
    d = arch.hidden
    layers = _init_layer_stack(arch, arch.num_layers, generator, dtype, device)
    params: dict[str, Any] = {
        "embed": _normal((arch.vocab, d), 1.0 / (d ** 0.5), generator, dtype, device),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not arch.tie_embeddings:
        params["lm_head"] = _normal((d, arch.vocab), 1.0 / (d ** 0.5), generator,
                                    dtype, device)
    if arch.family == "encdec":
        params["encoder"] = {
            "layers": _init_layer_stack(_encoder_arch(arch), arch.encoder_layers, generator,
                                        dtype, device),
            "final_norm": torch.ones((d,), dtype=dtype, device=device),
        }
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


def _dense_cached_attention_over_t(q, k, v, start_pos: int, t0: int, T: int, group, *,
                                   ring: bool = False) -> torch.Tensor:
    """``_dense_cached_attention`` on one rank's part of a cache split over T
    on "model": k/v hold the global slots t0 .. t0 + T_l - 1 of T, q every
    query. The mask is taken at those global slots (none once a ring has
    wrapped). One softmax over the parts: the global max of the logits (an
    all-reduce ``max`` over ``group``), the exps' global sum (a second), the
    probabilities normalised and cast to v's dtype as on one rank, the local
    products summed over the parts (a third). The probabilities are the
    unsharded ones up to the f32 order of the sum; a part whose slots are all
    masked adds exps of 0."""
    import torch.distributed._functional_collectives as funcol

    B, H, S, D = q.shape
    Hkv, T_l = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, S, D)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), k.float()) / (D ** 0.5)
    if not (ring and start_pos + S - 1 >= T):
        qpos = start_pos + torch.arange(S, device=q.device)
        slots = t0 + torch.arange(T_l, device=q.device)
        logits = torch.where(slots[None, :] <= qpos[:, None], logits, -1e30)
    top = funcol.all_reduce(logits.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(logits - top)
    probs = e / funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs.to(v.dtype).float(), v.float())
    out = funcol.all_reduce(out, "sum", group)
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


def _flash_cached_attention(q, k, v, start: int) -> torch.Tensor:
    """q ``(B, H, S, D)`` at positions ``start .. start + S - 1`` over the
    cache's written slots ``0 .. start + S - 1`` through the flash kernel,
    causal at ``q_offset=start``: ``flash_xla``'s mask with ``kv_valid_len =
    start + S``, the unwritten slots not passed. Counts the pairs the kernel
    scores (``attn.pairs_scored``) and the causal ones (``attn.pairs_live``)."""
    B, H, S, _ = q.shape
    T = start + S
    if spans.counting():
        spans.count("attn.pairs_scored", B * H * scored_pairs(S, T, start))
        spans.count("attn.pairs_live", B * H * live_pairs(start, S, T, T, True))
    out, _ = flash_attention_fwd(q, k[:, :, :T], v[:, :, :T], causal=True, q_offset=start)
    return out


def _attn_sublayer(p: dict, h: torch.Tensor, positions: torch.Tensor,
                   arch: ModelArch, cfg: ModelCfg, cache: Optional[dict],
                   causal: bool = True) -> torch.Tensor:
    """Self-attention. cache: None (full sequence) or the layer's cache views
    ``{"k", "v"[, "k_scale", "v_scale"], "start"}``, written in place.
    ``causal=False``: the encoder's bidirectional attention (full sequence
    only, no window). A cached call attends through ``_cached_attention``."""
    B, S, _ = h.shape
    H, Hkv, D = arch.heads, arch.kv_heads, arch.head_dim
    window = arch.sliding_window or 0
    qkv = whole_over_model(h @ gather_fsdp(p["wqkv"]))
    q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    if arch.qk_norm:
        # normalised before the head transpose, as the JAX package does; the
        # norm kernel reads the q and k views of the fused product in place
        q = L.norm(q, p["q_norm"], impl=cfg.norm_impl)
        k = L.norm(k, p["k_norm"], impl=cfg.norm_impl)
    q = cfg.constrain(L.rope(q.transpose(1, 2), positions), ("b", "m", None, None))
    k = cfg.constrain(L.rope(k.transpose(1, 2), positions), ("b", None, None, None))
    v = cfg.constrain(v.transpose(1, 2), ("b", None, None, None))
    if cache is None:
        if causal and window and window < S:
            out = ops.banded_attention(q, k, v, window=window)
        else:
            out = ops.flash_attention(q, k, v, causal=causal, impl=cfg.attn_impl)
    else:
        out = _cached_attention(cfg, cache, q, k, v, window)
    # split over "model" before the row-sharded wo: where the heads do not
    # split (hymba's 25 at 16-way), its backward then hands the reshape a
    # whole grad, not one cut inside a head; where they do, out is so already
    out = split_over_model(out.transpose(1, 2).reshape(B, S, H * D), -1)
    return out @ gather_fsdp(p["wo"])


def _cached_attention(cfg: ModelCfg, cache: dict, q, k, v, window: int):
    """The layer's attention over its KV cache: q ``(B, H, S, D)`` at
    positions ``start .. start + S - 1`` and the chunk's k/v ``(B, Hkv, S,
    D)``, written into the cache first. With a sliding ``window`` the cache
    is a ring of T slots in which slot j holds the position p with ``p % T
    == j``: a prefill of S >= T tokens starts at position 0, and a shorter
    chunk is written at ``start % T``. No chunk may cross the end of the
    cache (the JAX package clamps such a slice, or drops the rows of such a
    scatter: a different answer, refused here). A plain cache is the one
    part of ``_attend_part``; a DTensor cache is cut into parts over "model"
    by ``_sharded_cached_attention``."""
    start, T, S = cache["start"], cache["k"].shape[2], q.shape[2]
    idx = start % T if window else start
    if window and S >= T:
        if start:
            raise ValueError(f"a ring-cache prefill of {S} >= {T} tokens starts at "
                             f"position 0, not {start}")
    elif idx + S > T:
        raise ValueError(f"positions {start}..{start + S - 1} cross the end of the "
                         f"{T}-slot KV cache at slot {idx}")
    if isinstance(q, DTensor):
        return _sharded_cached_attention(cfg, cache, q, k, v, window)
    return _attend_part(cfg, cache, q, k, v, window)


def _attend_part(cfg: ModelCfg, cache: dict, q, k, v, window: int, layout: str = "whole",
                 tp: int = 1, rank: int = 0, split_q: bool = False, group=None):
    """One part of ``_cached_attention``: ``cache`` holds ``"start"`` and the
    part's views of the layer's cache (a plain cache whole, or one rank's
    shards), q the part's query heads, k/v the chunk's rows of every kv head.
    ``layout``, ``tp`` and ``rank`` place the part over "model" as
    ``_cache_layout`` says (the defaults: a plain cache); ``split_q``: q's
    heads are split over "model"; ``group``: "model"'s group, across which
    the parts of a cache over its sequence merge.

    The part writes its slots of the chunk (none, a part of it, or all of
    it; each kv head ``kv_cache_repeat`` times; int8 with scales under
    ``kv_cache_quant``) and attends after the write:

      * a ring prefill through ``banded_flash_xla`` on the part's q heads,
        the part's slots of the last T positions written rolled into place;
      * over its heads or whole (reading the kv heads of its q heads): one
        masked product under ``decode_dense_attn`` at S <= 16; the flash
        kernel (``_flash_cached_attention``) under the ``"cuda"`` impl over a
        cache that is neither a ring nor int8, the prefill, a chunk and a
        decode step alike (its wrapper refuses operands it lacks, as on the
        full-sequence path); else ``flash_xla`` (a ring, an int8 cache, the
        ``"xla"`` and ``"torch"`` impls);
      * over its part of T: ``flash_xla_lse`` at its own positions, the parts
        merged across "model" as an exact rescale, the max of their
        log-sum-exps first (one all-reduce), then the weighted sums of
        outputs and weights (a second); once a ring has wrapped every slot
        is live and no mask applies. Under ``decode_dense_attn`` at S <= 16,
        ``_dense_cached_attention_over_t``."""
    start, Hc_l, T_l = cache["start"], cache["k"].shape[1], cache["k"].shape[2]
    T, t0 = (T_l * tp, rank * T_l) if layout == "seq" else (T_l, 0)
    n_q, S, D = q.shape[1], q.shape[2], q.shape[3]
    if cfg.kv_cache_repeat > 1:
        k = k.repeat_interleave(cfg.kv_cache_repeat, dim=1)
        v = v.repeat_interleave(cfg.kv_cache_repeat, dim=1)
    # q heads per cache head, of the global heads: q holds n_q of them
    group_size = (n_q * tp if split_q else n_q) // k.shape[1]
    if layout == "heads":
        k, v = k[:, rank * Hc_l:(rank + 1) * Hc_l], v[:, rank * Hc_l:(rank + 1) * Hc_l]
    if window and S >= T:
        kq, vq = ((k, v) if layout == "heads" or not split_q
                  else ops._kv_heads_of(k, v, rank * n_q, n_q, group_size))
        out = banded_flash_xla(q, kq, vq, window=window)
        # ring invariant: slot j holds position p with p % T == j
        shift = (S - T) % T
        _write_cache(cfg, cache, torch.roll(k[:, :, -T:], shift, dims=2)[:, :, t0:t0 + T_l],
                     torch.roll(v[:, :, -T:], shift, dims=2)[:, :, t0:t0 + T_l], 0)
        return out
    idx = start % T if window else start
    lo, hi = max(idx, t0), min(idx + S, t0 + T_l)
    if lo < hi:
        _write_cache(cfg, cache, k[:, :, lo - idx:hi - idx], v[:, :, lo - idx:hi - idx],
                     lo - t0)
    if cfg.kv_cache_quant:
        k_read = _kv_dequantize(cache["k"], cache["k_scale"], cfg.dtype)
        v_read = _kv_dequantize(cache["v"], cache["v_scale"], cfg.dtype)
    else:
        k_read, v_read = cache["k"], cache["v"]
    if layout == "whole" and split_q:
        k_read, v_read = ops._kv_heads_of(k_read, v_read, rank * n_q, n_q, group_size)
    dense = cfg.decode_dense_attn and S <= 16
    if layout != "seq":
        if dense:
            return _dense_cached_attention(q, k_read, v_read, start, ring=bool(window))
        if cfg.attn_impl == "cuda" and not window and not cfg.kv_cache_quant:
            return _flash_cached_attention(q, k_read, v_read, start)
        return flash_xla(q, k_read, v_read, q_start=start, kv_valid_len=start + S,
                         ring=bool(window), causal=True)
    if dense:
        return _dense_cached_attention_over_t(q, k_read, v_read, start, t0, T, group,
                                              ring=bool(window))
    import torch.distributed._functional_collectives as funcol

    if window and start + S - 1 >= T:  # the ring has wrapped
        out, lse = flash_xla_lse(q, k_read, v_read, q_start=0, kv_valid_len=T_l, causal=False)
    else:
        out, lse = flash_xla_lse(q, k_read, v_read, q_start=start - t0,
                                 kv_valid_len=min(max(start + S - t0, 0), T_l))
    w = torch.exp(lse - funcol.all_reduce(lse, "max", group))
    both = funcol.all_reduce(torch.cat([out * w[..., None], w[..., None]], dim=-1),
                             "sum", group)
    return (both[..., :D] / both[..., D:]).to(q.dtype)


def _cache_layout(cache_k) -> tuple[str, int, int]:
    """How a layer's KV cache DTensor ``(B, Hkv', T, D)`` lies over "model":
    ``("heads" | "seq" | "whole", tp, this rank's index on "model")``."""
    mesh = cache_k.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if MODEL_AXIS not in names:
        return "whole", 1, 0
    i = names.index(MODEL_AXIS)
    tp, rank = mesh.shape[i], mesh.get_local_rank(MODEL_AXIS)
    place = cache_k.placements[i]
    if place == Shard(1):
        return "heads", tp, rank
    if place == Shard(2):
        return "seq", tp, rank
    return "whole", tp, rank


def _sharded_cached_attention(cfg: ModelCfg, cache: dict, q, k, v, window: int = 0):
    """``_cached_attention`` on DTensors: ``_attend_part`` on each rank's
    shards through ``local_apply``. The cache lies as ``cache_specs`` places
    it: B over the batch axes where they divide it, and over "model" the kv
    heads where "model" divides them, else the sequence T where it divides
    that, else nothing. q and the new k/v lie over the batch axes as the
    cache does and k/v whole over "model"; q's heads lie over "model" with
    the cache's heads, or where "model" divides them and the cache is whole
    or the call is a ring prefill; q is whole over "model" otherwise."""
    kc = cache["k"]
    mesh = kc.device_mesh
    H, S, T = q.shape[1], q.shape[2], kc.shape[2]
    layout, tp, rank = _cache_layout(kc)
    split_q = layout == "heads" or ((layout == "whole" or (bool(window) and S >= T))
                                    and tp > 1 and H % tp == 0)
    q_pl, kv_pl = [], []
    for name, place in zip(mesh.mesh_dim_names, kc.placements):
        if name == MODEL_AXIS:
            q_pl.append(Shard(1) if split_q else Replicate())
            kv_pl.append(Replicate())
        else:
            q_pl.append(place)
            kv_pl.append(place)
    part = {n: cache[n].to_local() for n in ("k", "v", "k_scale", "v_scale") if n in cache}
    part["start"] = cache["start"]
    group = mesh.get_group(MODEL_AXIS) if layout == "seq" else None

    def local(q, k, v):
        return _attend_part(cfg, part, q, k, v, window, layout, tp, rank, split_q, group)

    return local_apply(local, (q, k, v), (tuple(q_pl), tuple(kv_pl), tuple(kv_pl)), q_pl)


def _cross_sublayer(p: dict, h: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor,
                    arch: ModelArch) -> torch.Tensor:
    """encdec: the decoder's queries against the encoder's K/V ``(B, Hkv,
    T_enc, D)``, non-causal. Pinned to the blockwise "xla" attention whatever
    ``cfg.attn_impl`` says, as the JAX package pins it; its padding mask hides
    the zero keys that fill T_enc up to whole 512-key blocks."""
    B, S, _ = h.shape
    H, D = arch.heads, arch.head_dim
    # sharded: as the self-attention's products (``_attn_sublayer``); each
    # rank then attends with its q heads (``ops._sharded_heads``)
    q = whole_over_model(h @ gather_fsdp(p["wq"])).reshape(B, S, H, D).transpose(1, 2)
    out = ops.flash_attention(q, enc_k, enc_v, causal=False, impl="xla")
    out = split_over_model(out.transpose(1, 2).reshape(B, S, H * D), -1)
    return out @ gather_fsdp(p["wo"])


def _ssm_sublayer(arch: ModelArch, cfg: ModelCfg, p: dict, x: torch.Tensor,
                  cache: Optional[dict]) -> torch.Tensor:
    """The Mamba-2 mixer; with a cache, its conv history and state are
    replaced in place."""
    s, new_cache = ssm_block(p, x, arch, ssm_impl=cfg.ssm_impl,
                             cache=None if cache is None else (cache["conv"], cache["state"]))
    if new_cache is not None:
        for name, new in zip(("conv", "state"), new_cache):
            _copy_into(cache[name], new)
    return s


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; for DTensors, on each rank's shard of ``dst`` (a
    view into the stacked cache), ``src`` laid out as ``dst`` first."""
    if isinstance(dst, DTensor):
        if tuple(src.placements) != tuple(dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst, src = dst.to_local(), src.to_local()
    dst.copy_(src)


def _layer_fn(arch: ModelArch, cfg: ModelCfg, lp: dict, h: torch.Tensor,
              positions: torch.Tensor, cache: Optional[dict],
              enc_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True) -> torch.Tensor:
    """cache: None (full sequence) or the layer's cache views, written in
    place: ``{"k", "v"[, "k_scale", "v_scale"], "start"}`` for attention,
    ``{"conv", "state"}`` for the mixer; the hybrid has both; encdec adds
    ``{"enc_k", "enc_v"}``, which it only reads. enc_kv: encdec's cross K/V
    for this layer in the full-sequence forward. causal: False for the
    encoder's layers."""
    family = arch.family
    x = L.norm(h, lp["ln1"], impl=cfg.norm_impl)
    if family == "ssm":
        return h + _ssm_sublayer(arch, cfg, lp["ssm"], x, cache)
    a = _attn_sublayer(lp["attn"], x, positions, arch, cfg, cache, causal)
    if family == "hybrid":
        # hymba: attention and mamba heads run side by side on one input
        h = h + 0.5 * (a + _ssm_sublayer(arch, cfg, lp["ssm"], x, cache))
    else:
        h = h + a
    if family == "encdec":
        enc_k, enc_v = enc_kv if cache is None else (cache["enc_k"], cache["enc_v"])
        h = h + _cross_sublayer(lp["cross"], L.norm(h, lp["ln_cross"], impl=cfg.norm_impl),
                                enc_k, enc_v, arch)
    if family == "moe":
        return h + moe_block(lp["moe"], L.norm(h, lp["ln2"], impl=cfg.norm_impl),
                             top_k=arch.top_k, capacity_factor=cfg.capacity_factor)
    if arch.ffn > 0:
        h = h + L.swiglu(lp["mlp"], L.norm(h, lp["ln2"], impl=cfg.norm_impl),
                         constrain=cfg.constrain if cfg.act_shard else None)
    return h


def _head(params: dict, arch: ModelArch, cfg: ModelCfg, h: torch.Tensor) -> torch.Tensor:
    """The final norm and the (d, V) head, gathered over the batch axes first
    (``gather_fsdp``): else every data rank would hold the logits of every
    row, at a vocab of 150k the largest tensor of a step."""
    h = L.norm(h, params["final_norm"], impl=cfg.norm_impl)
    head = params["embed"].T if arch.tie_embeddings else params["lm_head"]
    return h @ gather_fsdp(head).to(h.dtype)


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _save_weight_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _selective_contexts():
    return create_selective_checkpoint_contexts(_save_weight_products)


def _train_layer(arch: ModelArch, cfg: ModelCfg, lp: dict, h: torch.Tensor,
                 positions: torch.Tensor, enc_kv=None, causal: bool = True) -> torch.Tensor:
    """One layer of the full-sequence forward under ``cfg.remat``; encdec's
    cross K/V reach it as arguments, as the JAX package's
    ``_encdec_train_layer`` takes them."""
    if cfg.remat == "none":
        return _layer_fn(arch, cfg, lp, h, positions, None, enc_kv, causal)
    extra = {"context_fn": _selective_contexts} if cfg.remat == "selective" else {}
    return checkpoint(_layer_fn, arch, cfg, lp, h, positions, None, enc_kv, causal,
                      use_reentrant=False, **extra)


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``. Sharded, each rank looks its own tokens up in the
    whole table (gathered over the vocab and d), and the table's grad is a
    partial sum over the mesh dims that split the tokens: DTensor's own
    propagation of the lookup's backward (``index_put``) fails in torch 2.11
    (2.13 propagates it)."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    pt = tuple(tokens.placements)
    whole = (Replicate(),) * embed.device_mesh.ndim
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in pt)
    return local_apply(lambda e, t: e[t], (embed, tokens), (whole, pt), pt, (grad, pt),
                       out_shape=(*tokens.shape, embed.shape[1]))


def _embed_inputs(params: dict, arch: ModelArch, cfg: ModelCfg, batch: dict):
    """The token embeddings in ``cfg.dtype``, behind ``batch["frontend"]``
    (B, F, d), the stub's embeddings, where the model has a frontend stub and
    the batch holds them; and the positions 0 .. F + S - 1."""
    h = _lookup(params["embed"], batch["tokens"]).to(cfg.dtype)
    if arch.frontend_stub and "frontend" in batch:
        h = _behind_frontend(batch["frontend"], h, cfg)
    return h, torch.arange(h.shape[1], device=h.device)


def _check_stub(like, name: str, x) -> None:
    """A stub input (the frontend, the encoder's frames) is a DTensor, placed
    by ``batch_spec``, where ``like`` (the tokens' embeddings, the params) is
    one: a plain one beside DTensors is refused, as plain tokens beside
    DTensor params are."""
    if isinstance(x, DTensor) != isinstance(like, DTensor):
        raise TypeError(f"the tokens and {name} are DTensors or plain tensors together "
                        f"(batch_spec places both)")


def _behind_frontend(frontend, h, cfg: ModelCfg):
    """The frontend's embeddings (B, F, d) in front of the token embeddings
    (B, S, d); sharded, both lie over the batch axes (``batch_spec``)."""
    _check_stub(h, "frontend", frontend)
    return torch.cat([frontend.to(cfg.dtype), h], dim=1)


def _encode(params: dict, arch: ModelArch, cfg: ModelCfg,
            features: torch.Tensor) -> torch.Tensor:
    """encdec: the bidirectional encoder over stub frame embeddings (B, T, d):
    dense layers without q/k norms, non-causal attention through the
    flash-attention kernel, under ``cfg.remat`` as the decoder's, then the
    encoder's final norm; the carry's batch sharding pinned before each
    layer, as the JAX package pins it."""
    enc = params["encoder"]
    enc_arch = _encoder_arch(arch)
    _check_stub(params["embed"], "enc_features", features)
    h = features.to(cfg.dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(arch.encoder_layers):
        h = constrain_batch_sharding(h)
        h = _train_layer(enc_arch, cfg, _layer(enc["layers"], i), h, positions, causal=False)
    return L.norm(h, enc["final_norm"], impl=cfg.norm_impl)


def _cross_kv(params: dict, arch: ModelArch,
              enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross K and V from the encoder output through its
    ``cross.wkv``: two (L, B, Hkv, T_enc, D). Sharded, the packed product is
    made whole over "model" before its split, as the self-attention's is:
    its weight grad then comes back split as ``wkv`` is, not whole on every
    rank."""
    B, T, _ = enc_out.shape
    Hkv, D = arch.kv_heads, arch.head_dim
    wkv = params["layers"]["cross"]["wkv"]
    ks, vs = [], []
    for i in range(wkv.shape[0]):
        k, v = whole_over_model(enc_out @ gather_fsdp(wkv[i])).chunk(2, dim=-1)
        ks.append(k.reshape(B, T, Hkv, D).transpose(1, 2))
        vs.append(v.reshape(B, T, Hkv, D).transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def forward_logits(params: dict, arch: ModelArch, cfg: ModelCfg, batch: dict) -> torch.Tensor:
    """Full-sequence forward over ``batch["tokens"]`` (B, S), behind
    ``batch["frontend"]`` (B, F, d) for a model with a frontend stub (vlm);
    encdec encodes ``batch["enc_features"]`` (B, T_enc, d) first. Returns (B,
    F + S, V) logits. Attention goes through the flash-attention kernel
    (through ``banded_flash_xla`` when a sliding window is shorter than S;
    cross-attention through the blockwise "xla" attention), the ssm mixer
    through the SSD kernel. Params and batch may be DTensors (see the module
    docstring)."""
    _check_family(arch)
    if cfg.cast_params_in_forward:
        params = cast_params(params, cfg.dtype)
    h, positions = _embed_inputs(params, arch, cfg, batch)
    enc_k = enc_v = None
    if arch.family == "encdec":
        enc_k, enc_v = _cross_kv(params, arch, _encode(params, arch, cfg, batch["enc_features"]))
    for i in range(arch.num_layers):
        h = constrain_batch_sharding(h)
        h = _train_layer(arch, cfg, _layer(params["layers"], i), h, positions,
                         None if enc_k is None else (enc_k[i], enc_v[i]))
    return _head(params, arch, cfg, h)


def forward_train(params: dict, arch: ModelArch, cfg: ModelCfg, batch: dict):
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S), logits in
    f32, averaged over ``batch["loss_mask"]`` (B, S) where given (position t
    weighs the prediction of token t); frontend positions carry no loss.
    Returns ``(loss, {"ce_loss", "loss"})``; the moe family adds
    ``moe_aux_weight`` times the load-balancing loss, reported as
    ``"aux_loss"``. As in the JAX package, that loss is layer 0's router
    applied to the embedded inputs (sharded, its means run over the global
    tokens). Sharded, the logits are made whole over every mesh dim but the
    batch's before the loss, each rank takes the losses of its own rows
    (``local_apply``: DTensor's backward of the gather would allocate zeros
    of the *global* logits on every rank, 40 GB at train_4k), and the loss
    and metrics come back as plain tensors, the same on every rank."""
    logits = forward_logits(params, arch, cfg, batch)
    S_txt = batch["tokens"].shape[1]
    targets = batch["tokens"][:, 1:].long()

    def token_nll(logits, targets):
        lg = logits[:, -S_txt:-1, :].float()
        return torch.logsumexp(lg, dim=-1) - lg.gather(-1, targets[..., None])[..., 0]

    if isinstance(logits, DTensor):
        # a vocab-sharded or partial-sum operand breaks the gather
        rows = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
        nll = local_apply(token_nll, (logits, targets), (rows, rows), rows,
                          out_shape=targets.shape)
    else:
        nll = token_nll(logits, targets)
    del logits
    mask = batch.get("loss_mask")
    if mask is not None:
        m = mask[:, 1:].float()
        loss = (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        loss = nll.mean()
    metrics = {"ce_loss": loss}
    if arch.family == "moe" and cfg.moe_aux_weight > 0:
        h, _ = _embed_inputs(params, arch, cfg, batch)
        aux = aux_load_balance_loss(_tree_map(lambda x: x[0], params["layers"]["moe"]), h,
                                    top_k=arch.top_k)
        metrics["aux_loss"] = aux
        loss = loss + cfg.moe_aux_weight * aux
    metrics["loss"] = loss
    if isinstance(loss, DTensor):
        metrics = {k: v.full_tensor() for k, v in metrics.items()}
        loss = metrics["loss"]
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: caches / prefill / decode
# ---------------------------------------------------------------------------

def init_caches(arch: ModelArch, cfg: ModelCfg, batch_size: int, max_len: int,
                enc_features: Optional[torch.Tensor] = None, params: Optional[dict] = None,
                device=None) -> dict:
    """Per-layer-stacked decode caches: ``{"k", "v"}`` of (L, B, Hkv * r, T,
    D) for attention, r = ``kv_cache_repeat`` and T = max_len, or the window
    when that is shorter (a ring); in ``cfg.dtype``, or int8 beside bf16
    ``{"k_scale", "v_scale"}`` (L, B, Hkv * r, T) under ``kv_cache_quant``.
    ``{"conv"}`` (L, B, CONV_K - 1, conv channels) in ``cfg.dtype`` and
    ``{"state"}`` (L, B, H, P, N) f32 for the ssm and hybrid mixers. For
    encdec, ``{"enc_k", "enc_v"}`` (L, B, Hkv, T_enc, D): the encoder run once
    over ``enc_features`` (B, T_enc, d) with ``params`` (cast to
    ``cfg.dtype`` under ``cast_params_in_forward``), each decoder layer's
    cross K/V; both are required, a ``ValueError`` otherwise.

    Sharded: with ``params`` as DTensors (``param_specs``), every leaf comes
    back as a DTensor on the params' mesh, placed as ``cache_specs`` places
    it: the KV, conv and state caches as zeros on each rank's shard, and an
    encdec model's cross K/V from the encoder run on DTensors, over
    ``enc_features`` placed by ``batch_spec`` (a plain tensor there is
    refused), redistributed to their placements. That is how a caller gets
    a sharded encdec cache: the encoder's output lies on the mesh already,
    so ``distribute`` (which takes whole tensors) has nothing to place.
    ``device`` is then the mesh's, whatever is passed."""
    _check_family(arch)
    mesh = params["embed"].device_mesh if params is not None and isinstance(
        params["embed"], DTensor) else None
    # sharded, the zeros are made on each rank's shard (``_placed_caches``)
    device = torch.device("meta") if mesh is not None else resolve_device(device)
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
    if arch.family == "encdec":
        if enc_features is None or params is None:
            raise ValueError(f"{arch.name}: an encdec cache holds the encoder's cross K/V; "
                             f"init_caches needs enc_features and params")
        if cfg.cast_params_in_forward:
            params = cast_params(params, cfg.dtype)
        with torch.no_grad():
            enc_out = _encode(params, arch, cfg, enc_features)
            caches["enc_k"], caches["enc_v"] = _cross_kv(params, arch, enc_out)
    if mesh is not None:
        caches = _placed_caches(arch, mesh, caches)
    return caches


def _placed_caches(arch: ModelArch, mesh, caches: dict) -> dict:
    """``init_caches``' leaves on ``mesh`` in ``cache_specs``' placements: the
    zeros (meta tensors here) made on each rank's shard, nothing whole
    allocated; the cross K/V redistributed."""
    from torch.distributed.tensor import zeros as dzeros

    from repro_torch.parallel.sharding import cache_specs, make_plan

    specs = cache_specs(arch, make_plan(mesh), caches)
    out = {}
    for name, x in caches.items():
        places = placements(mesh, specs[name])
        if isinstance(x, DTensor):
            out[name] = x.redistribute(mesh, places)
        else:
            out[name] = dzeros(x.shape, dtype=x.dtype, device_mesh=mesh, placements=places)
    return out


@torch.no_grad()
def forward_cached(params: dict, arch: ModelArch, cfg: ModelCfg, caches: dict,
                   tokens: torch.Tensor, start_pos: int,
                   frontend: Optional[torch.Tensor] = None):
    """Shared prefill/decode path: processes the S tokens, behind
    ``frontend`` (B, F, d) where given, from position start_pos on.

    Writes into ``caches`` in place (the K/V of the F + S positions; the new
    conv history and SSM state; encdec's cross K/V are only read) and returns
    ``(logits, caches)`` (the same dict), mirroring the JAX signature.
    Positions must lie in the KV cache, except in a ring that holds the whole
    window, which serves any position.

    Sharded: params, caches and tokens (and the frontend) as DTensors,
    placed by ``param_specs``, ``cache_specs`` and ``batch_spec``; the
    logits come back as one. The caches are written in place on each rank's
    shards (``_sharded_cached_attention``, ``_ssm_sublayer``)."""
    _check_family(arch)
    sharded = isinstance(params["embed"], DTensor)
    if sharded and not isinstance(tokens, DTensor):
        raise TypeError("sharded params take the tokens as a DTensor (batch_spec)")
    if cfg.cast_params_in_forward:
        params = cast_params(params, cfg.dtype)
    h = _lookup(params["embed"], tokens).to(cfg.dtype)
    if frontend is not None:
        h = _behind_frontend(frontend, h, cfg)
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


def prefill(params, arch, cfg, caches, tokens, frontend=None):
    return forward_cached(params, arch, cfg, caches, tokens, 0, frontend=frontend)


def decode_step(params, arch, cfg, caches, tokens, position: int):
    """tokens: (B, 1) new token ids; position: current sequence length."""
    return forward_cached(params, arch, cfg, caches, tokens, position)
