"""Public wrappers over the kernels, the counterparts of
``repro/kernels/ops.py`` (``flash_attention``, ``fused_rmsnorm``, ``ssd``,
``ssd_with_state``).

Each op takes ``impl``:
  * ``"cuda"``  - the hand-written kernel (its wrapper runs the plain version
                  for a tensor on the CPU);
  * ``"torch"`` - the plain PyTorch version (``ref``), on any device: the JAX
                  package's "naive" path, which the kernels are held against;
  * ``"xla"``   - the JAX package's "xla" path: attention through
                  ``xla_flash.flash_xla_train`` (blockwise, with a
                  blockwise-recompute backward), the norm and the SSD scan
                  through their plain versions.

The kernel path is a ``torch.autograd.Function``. The norm's and the SSD
scan's backward is the JAX package's: the VJP of the plain version,
recomputed from the saved inputs (``repro/kernels/ops.py`` ``_rn_bwd``,
``_ssd_bwd``). Attention saves the forward's ``out`` and ``lse`` beside q, k
and v: bf16 on the card takes the hand-written backward
(``flash_attention_bwd``, bf16 products on the tensor cores, no score in
device memory), which the JAX package lacks (its ``_fa_bwd`` is the plain
VJP). f32, the parity type the JAX tests hold at 2e-5, and CPU tensors keep
the plain VJP, whose f32 products a bf16 kernel would not match there.

A DTensor operand (a sharded model, ``repro_torch.parallel``) reaches every
op through ``sharding.local_apply``, the counterpart of ``shard_map``: its
input is first laid out as the op needs it, then the chosen ``impl`` runs on
each rank's local shard, the kernel on a card (on a CUDA shard the kernel
runs or the call raises; nothing falls back to the plain version). RMSNorm
takes rows sharded any way and the normalised last dim whole; attention
(and ``banded_attention``, the sliding window past its length) takes B over
the batch axes ("pod", "data") and heads over "model", with k/v kept whole
over "model" when their heads do not split (GQA with ``kv_heads < tp``); the
SSD scan takes B over the batch axes and its heads H over "model" where
"model" divides them (else every rank scans every head), with B/C whole
over "model" (their grads partial sums there).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import spans
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels.ssd import ssd_scan_fwd
from repro_torch.kernels.xla_flash import banded_flash_xla, flash_xla_train
from repro_torch.parallel.sharding import BATCH_AXES, MODEL_AXIS, local_apply

IMPLS = ("cuda", "torch", "xla")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _plain_vjp(ctx, plain, grad_out, saved=None):
    """Gradients of ``plain`` at the saved inputs (``saved``, by default all
    of ``ctx.saved_tensors``, the op's leading inputs) against ``grad_out``,
    for the inputs that need one (None for the rest)."""
    saved = ctx.saved_tensors if saved is None else saved
    wanted = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
        out = plain(*inputs)
        grads = torch.autograd.grad(out, [t for t, w in zip(inputs, wanted) if w],
                                    grad_out)
    it = iter(grads)
    return [next(it) if w else None for w in wanted]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        with spans.span("attn.backward", device=g.is_cuda):
            if g.is_cuda and q.dtype == torch.bfloat16:
                grads = flash_attention_bwd(q, k, v, out, lse, g, causal=ctx.causal,
                                            sm_scale=ctx.sm_scale)
                return (*(d if w else None for d, w in zip(grads, ctx.needs_input_grad)),
                        None, None)

            def plain(q, k, v):
                return ref.attention(q, k, v, causal=ctx.causal, sm_scale=ctx.sm_scale)

            return (*_plain_vjp(ctx, plain, g, (q, k, v)), None, None)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rmsnorm_fwd(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, g):
        return (*_plain_vjp(ctx, lambda x, w: ref.rmsnorm(x, w, eps=ctx.eps), g), None)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D):
        ctx.save_for_backward(x, dt, A, Bm, C, D)
        y, _ = ssd_scan_fwd(x, dt, A, Bm, C, D)
        return y

    @staticmethod
    def backward(ctx, g):
        return tuple(_plain_vjp(ctx, ref.ssd_scan, g))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, impl: str = "cuda"):
    """GQA flash attention. q ``(B, Hq, S, D)``, k/v ``(B, Hkv, T, D)``."""
    _check_impl(impl)
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal, sm_scale, impl)
    return _attention(q, k, v, causal, sm_scale, impl)


def _attention(q, k, v, causal, sm_scale, impl):
    if impl == "cuda":
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    if impl == "xla":
        return flash_xla_train(q, k, v, causal, sm_scale, 512)
    return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale)


def _kv_heads_of(k, v, first: int, n: int, group: int):
    """k/v reduced to the kv heads that q heads ``first .. first + n - 1``
    read (q head h reads kv head h // group), as a view where those q heads
    cover whole groups or lie in one, else one kv head per q head."""
    lo, hi = first // group, (first + n - 1) // group + 1
    if (first % group == 0 and n % group == 0) or hi - lo == 1:
        return k[:, lo:hi], v[:, lo:hi]
    idx = torch.arange(first, first + n, device=k.device) // group
    return k.index_select(1, idx), v.index_select(1, idx)


def _sharded_heads(q, k, v, attend):
    """``attend(q, k, v)`` (plain tensors, ``(B, H, S, D)``) on DTensors:
    each rank runs it on its batch rows and q heads. Where the kv heads do
    not split over "model" (Hkv % tp != 0), k/v stay whole there and each
    rank reads only the kv heads of its q heads; their grads are then
    partial sums over "model"."""
    mesh = q.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    B, Hq, Hkv = q.shape[0], q.shape[1], k.shape[1]
    batch = [a for a in BATCH_AXES if a in sizes]
    # over batch axes of size 1 B stays whole: a one-row B sharded there is a
    # size-1 sharded dim, which the next product's view cannot merge
    dp = math.prod(sizes[a] for a in batch)
    split_b = dp > 1 and B % dp == 0
    tp = sizes.get(MODEL_AXIS, 1)
    split_q = tp > 1 and Hq % tp == 0
    split_kv = split_q and Hkv % tp == 0
    pq, pkv, gkv = [], [], []  # q's (and out's), k/v's, and k/v's grads'
    for name in mesh.mesh_dim_names:
        if name in batch and split_b:
            places = (Shard(0), Shard(0), Shard(0))
        elif name == MODEL_AXIS and split_kv:
            places = (Shard(1), Shard(1), Shard(1))
        elif name == MODEL_AXIS and split_q:
            places = (Shard(1), Replicate(), Partial())
        else:
            places = (Replicate(), Replicate(), Replicate())
        for out, place in zip((pq, pkv, gkv), places):
            out.append(place)
    n_local = Hq // tp if split_q else Hq
    first = mesh.get_local_rank(MODEL_AXIS) * n_local if split_q else 0

    def local(q, k, v):
        if split_q and not split_kv:
            k, v = _kv_heads_of(k, v, first, n_local, Hq // Hkv)
        return attend(q, k, v)

    return local_apply(local, (q, k, v), (pq, pkv, pkv), pq, (pq, gkv, gkv))


def _sharded_attention(q, k, v, causal, sm_scale, impl):
    return _sharded_heads(q, k, v, lambda q, k, v: _attention(q, k, v, causal, sm_scale, impl))


def banded_attention(q, k, v, *, window: int):
    """Causal sliding-window attention past the window's length:
    ``xla_flash.banded_flash_xla`` (the JAX package's path there, whatever
    the attention impl), on DTensors through ``_sharded_heads``."""
    if isinstance(q, DTensor):
        return _sharded_heads(q, k, v, lambda q, k, v: banded_flash_xla(q, k, v, window=window))
    return banded_flash_xla(q, k, v, window=window)


def fused_rmsnorm(x, weight, *, eps: float = 1e-6, impl: str = "cuda"):
    _check_impl(impl)
    if isinstance(x, DTensor):
        return _sharded_rmsnorm(x, weight, eps, impl)
    return _rmsnorm(x, weight, eps, impl)


def _rmsnorm(x, weight, eps, impl):
    if impl == "cuda":
        return _RMSNorm.apply(x, weight, eps)
    return ref.rmsnorm(x, weight, eps=eps)


def _sharded_rmsnorm(x, weight, eps, impl):
    """RMSNorm on DTensors: x keeps any sharding of its rows and is whole
    over the normalised last dim; the weight is whole everywhere, its grad a
    partial sum over the mesh dims that split the rows."""
    mesh = x.device_mesh
    px = tuple(p if isinstance(p, Shard) and p.dim < x.dim() - 1 else Replicate()
               for p in x.placements)
    pw = (Replicate(),) * mesh.ndim
    gw = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in px)
    return local_apply(lambda x, w: _rmsnorm(x, w, eps, impl), (x, weight), (px, pw), px,
                       (px, gw))


def _zeros_d(x, D):
    return torch.zeros(x.shape[2], dtype=torch.float32, device=x.device) if D is None else D


def ssd(x, dt, A, Bm, C, D=None, *, impl: str = "cuda"):
    """Mamba-2 SSD mixer, training form (zero initial state, no state out).
    x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)``, Bm/C ``(B, S, N)``;
    D None means f32 zeros. DTensors go through ``_sharded_ssd``."""
    _check_impl(impl)
    if isinstance(x, DTensor):
        return _sharded_ssd(x, dt, A, Bm, C, D, None, impl, with_state=False)
    return _ssd(x, dt, A, Bm, C, D, impl)


def _ssd(x, dt, A, Bm, C, D, impl):
    D = _zeros_d(x, D)
    if impl == "cuda":
        return _SSD.apply(x, dt, A, Bm, C, D)
    return ref.ssd_scan(x, dt, A, Bm, C, D)


def ssd_with_state(x, dt, A, Bm, C, D=None, *, init_state=None, impl: str = "torch"):
    """Prefill/decode form: returns ``(y, final_state)``. The kernel starts
    from a zero state, so an ``init_state`` always takes the plain version.
    ``init_state`` ``(B, H, P, N)``; DTensors go through ``_sharded_ssd``."""
    _check_impl(impl)
    if isinstance(x, DTensor):
        return _sharded_ssd(x, dt, A, Bm, C, D, init_state, impl, with_state=True)
    return _ssd_with_state(x, dt, A, Bm, C, D, init_state, impl)


def _ssd_with_state(x, dt, A, Bm, C, D, init_state, impl):
    D = _zeros_d(x, D)
    if impl == "cuda" and init_state is None:
        return ssd_scan_fwd(x, dt, A, Bm, C, D)
    return ref.ssd_scan(x, dt, A, Bm, C, D, init_state=init_state, return_state=True)


def _sharded_ssd(x, dt, A, Bm, C, D, init_state, impl, *, with_state: bool):
    """The SSD scan on DTensors: each rank scans its batch rows (x's own
    rows: B keeps its placement over the batch axes) and its heads, H over
    "model" where "model" divides it, else all H on every rank. x/dt/y and
    the state follow the heads; A and D are split with them, their grads
    partial sums over the batch axes; B/C are whole over "model", their
    grads partial sums there. The chosen ``impl`` runs on the local shards:
    the kernel (strided B/C views and all) on a card."""
    mesh = x.device_mesh
    H = x.shape[2]
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(MODEL_AXIS, 1)
    split_h = tp > 1 and H % tp == 0
    # per mesh dim: x/dt/y, A/D, B/C, the state; the grads of A/D and of B/C
    px, ph, pbc, ps, gh, gbc = [], [], [], [], [], []
    for name, place in zip(mesh.mesh_dim_names, x.placements):
        if name == MODEL_AXIS:
            places = ((Shard(2), Shard(0), Replicate(), Shard(1), Shard(0), Partial())
                      if split_h else (Replicate(),) * 6)
        elif place == Shard(0):
            places = (Shard(0), Replicate(), Shard(0), Shard(0), Partial(), Shard(0))
        else:
            places = (Replicate(),) * 6
        for out, p in zip((px, ph, pbc, ps, gh, gbc), places):
            out.append(p)
    if D is None:
        D = DTensor.from_local(_zeros_d(x, None), mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    args = [x, dt, A, Bm, C, D]
    ins, grads = [px, px, ph, pbc, pbc, ph], [px, px, gh, gbc, gbc, gh]
    if init_state is not None:
        args.append(init_state)
        ins.append(ps)
        grads.append(ps)
    if not with_state:
        return local_apply(lambda *a: _ssd(*a, impl), args, ins, px, grads)
    Bsz, _, _, P = x.shape
    state = (Bsz, H, P, Bm.shape[-1])

    def local(x, dt, A, Bm, C, D, s=None):
        return tuple(_ssd_with_state(x, dt, A, Bm, C, D, s, impl))

    return local_apply(local, args, ins, (px, ps), grads, out_shape=(x.shape, state))
