"""Op accounting of one rank's step: FLOPs, HBM bytes, collective wire bytes
and peak memory, the counterpart of ``repro/launch/hlo_account.py``.

The JAX package reads them off the compiled HLO. An eager PyTorch program has
no such text, so :class:`OpAccountant` is a ``TorchDispatchMode`` that counts
the ops as the rank runs them, on real or on fake tensors alike:

  * FLOPs: the formulas of ``torch.utils.flop_counter`` (its registry, as
    ``FlopCounterMode`` applies them). Only products count (mm, bmm, addmm,
    ...); elementwise ops are left out, as in the JAX accountant.
  * bytes: each op's operands plus its result, views, allocations and
    ``prim.device`` skipped (the counterpart of ``_SKIP_BYTES``). An eager
    program has no fusion: these are the port's own HBM traffic, every
    intermediate written and read again, not what XLA's fusions would move.
  * collectives: the ``_c10d_functional`` ops (all_gather_into_tensor,
    all_reduce, reduce_scatter_tensor, all_to_all_single) with the size and
    ranks of the group named in the op, each turned into wire bytes by the
    JAX ring model (``roofline._wire_bytes``) and into seconds at the rate of
    its group's slowest link (``roofline.link_bw``).
  * peak memory: the live bytes of the rank's storages. The storages of the
    arguments (``add_arguments``: the inputs' local shards) are live from the
    start; each op's new result storage is added when it appears and dropped
    when its last tensor dies (a weak reference to the storage). ``temp`` is
    the peak minus the arguments, as XLA's temp buffer is.

DTensors: the mode passes every op on a DTensor through (``NotImplemented``)
and counts the local ops and collectives DTensor runs for it on the rank's
shards. DTensor's sharding propagation also runs ops of its own: each op once
on fake tensors of the *global* shapes to learn its output's metadata
(``ShardingPropagator._propagate_tensor_meta_non_cached``, in torch 2.11 and
2.13 alike), and index arithmetic in its cost model. It caches its answers,
so counted, those ops would add a global product on a first trace and none
on a second. While the mode is active the propagator's entry points
(``propagate_op_sharding``, ``propagate_op_sharding_non_cached`` and the
metadata run) are wrapped: every op run inside them is left out, so each
trace counts only what the rank itself runs. They also run outside any
``FakeTensorMode`` (``unset_fake_temporarily``): propagation reads placements,
not the rank's data, and torch 2.13's cost model of a strided shard builds
index tensors and reads them back, which a fake tensor cannot.

Loops: the JAX accountant multiplies a ``lax.scan`` body by its trip count.
The port's plain SSD scan (``kernels/ref.py``) is a Python loop of S steps,
each a few ops: traced op by op on fake tensors, a prefill of 32768 tokens
at 48 layers would dispatch some 1.6e7 ops. While the accountant is active
(``count_loops``) it puts ``_CountedScan`` in the loop's place for fake
tensors: a ``scaled(n)`` scope multiplies what the ops inside it count by n,
and the counted scan traces the steps it must (the first, one in the middle
and the last, whose backward ops differ at the ends of the chain) and scales
the middle one by the S - 2 it stands for, forward and backward, to the
loop's FLOPs and HBM bytes exactly. It keeps, from its forward to its
backward, a tensor of the bytes the loop's autograd would keep for its S
steps, so that the peak still holds them. Real tensors always run the loop.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ref
from repro_torch.launch.roofline import _wire_bytes, link_bw

# _c10d_functional op -> the JAX accountant's collective name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_aten = torch.ops.aten
_SKIP_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.lift_fresh.default,
    torch.ops.prim.device.default, torch.ops._c10d_functional.wait_tensor.default,
}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    # sum over the collectives of wire bytes / the rate of the group's link
    collective_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.bytes,
            "wire_bytes": self.wire_bytes,
            "collective_counts": self.collective_counts,
            "collective_bytes": self.collective_bytes,
            "collective_s": self.collective_s,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _propagator():
    return DTensor._op_dispatcher.sharding_propagator


def _group_ranks(group) -> list[int]:
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    return dist.get_process_group_ranks(group)


class OpAccountant(TorchDispatchMode):
    """Counts what one rank runs while it is active (``with
    OpAccountant() as acc: ...``). ``totals``, ``collectives`` (one
    ``(kind, result_bytes, group_size, ranks)`` per collective),
    ``breakdown()`` and ``memory()`` read the count. ``count_loops=False``
    leaves the plain SSD scan's loop as it is (see the module docstring)."""

    def __init__(self, count_loops: bool = True):
        super().__init__()
        self.count_loops = count_loops
        self._scale = 1
        self.totals = Totals()
        self.collectives: list[tuple[str, float, int, tuple[int, ...]]] = []
        self._by_op: dict = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        self._muted = 0
        self.muted_ops = 0  # ops run inside DTensor's bookkeeping, left out
        self._live: dict[int, int] = {}  # id of a live storage -> its bytes
        self._refs: dict = {}  # id -> a weak reference that releases it
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._saved: dict = {}

    # -- DTensor's sharding propagation --------------------------------
    _PROPAGATION = ("propagate_op_sharding", "propagate_op_sharding_non_cached",
                    "_propagate_tensor_meta_non_cached")

    def __enter__(self):
        prop = _propagator()
        self._saved = {}
        for name in self._PROPAGATION:
            self._saved[name] = prop.__dict__.get(name)
            inner = getattr(prop, name)

            setattr(prop, name, self.muted(inner))
        self._saved_scan = ref.scan_steps
        if self.count_loops:
            ref.scan_steps = functools.partial(_counted_scan_steps, self)
        return super().__enter__()

    @contextlib.contextmanager
    def scaled(self, n: int):
        """What the ops inside count (FLOPs, bytes, wire bytes, calls) is
        multiplied by n; under n = 0 they count nothing and their results
        hold no memory."""
        outer = self._scale
        self._scale = outer * n
        try:
            yield
        finally:
            self._scale = outer

    def muted(self, fn):
        """``fn`` as a function whose ops are not counted, run outside any
        ``FakeTensorMode``: for DTensor's bookkeeping, which reads placements
        and indices, never the rank's data."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        @functools.wraps(fn)
        def run(*args, **kwargs):
            self._muted += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                self._muted -= 1

        return run

    def __exit__(self, *exc):
        ref.scan_steps = self._saved_scan
        prop = _propagator()
        for name, saved in self._saved.items():
            if saved is None:
                delattr(prop, name)
            else:
                setattr(prop, name, saved)
        return super().__exit__(*exc)

    # -- memory -----------------------------------------------------------
    def _add_storage(self, t: torch.Tensor) -> bool:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return False
        n = st.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._release(key))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return True

    def _release(self, key: int) -> None:
        self._refs.pop(key, None)
        self.live_bytes -= self._live.pop(key, 0)

    def add_arguments(self, tree) -> int:
        """Registers the storages of the tensors in ``tree`` (a DTensor's
        local shard) as arguments: live from the start. Returns their bytes."""
        n0 = self.live_bytes
        for x in tree_leaves(tree):
            if isinstance(x, DTensor):
                x = x.to_local()
            if isinstance(x, torch.Tensor):
                self._add_storage(x)
        added = self.live_bytes - n0
        self.argument_bytes += added
        return added

    def memory(self) -> dict:
        temp = self.peak_bytes - self.argument_bytes
        return {"argument_bytes": self.argument_bytes, "temp_bytes": temp,
                "peak_bytes": self.peak_bytes,
                "per_device_total": self.argument_bytes + temp}

    # -- counting ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._muted:
            self.muted_ops += 1
            return out
        n = self._scale
        if n == 0:
            return out
        row = self._by_op[str(func)]
        row[0] += n
        if func.namespace in _COLLECTIVE_NAMESPACES and func not in _SKIP_BYTES:
            self._collective(func, args, kwargs, out, row)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out)) * n
            self.totals.flops += f
            row[1] += f
        if func.is_view or func in _SKIP_BYTES:
            return out
        moved = sum(_nbytes(x) for x in tree_leaves((args, kwargs, out))
                    if isinstance(x, torch.Tensor)) * n
        self.totals.bytes += moved
        row[2] += moved
        for x in tree_leaves(out):
            if isinstance(x, torch.Tensor):
                self._add_storage(x)
        return out

    def _collective(self, func, args, kwargs, out, row) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is None:
            raise NotImplementedError(f"the op accountant has no rule for the collective {func}")
        group = kwargs.get("group_name", args[-1] if args else None)
        ranks = tuple(_group_ranks(group))
        result = float(sum(_nbytes(x) for x in tree_leaves(out) if isinstance(x, torch.Tensor)))
        wire = _wire_bytes(kind, result, len(ranks))
        t = self.totals
        t.collective_counts[kind] = t.collective_counts.get(kind, 0) + 1
        t.collective_bytes[kind] = t.collective_bytes.get(kind, 0.0) + result
        t.wire_bytes += wire
        t.collective_s += wire / link_bw(ranks)
        row[3] += wire
        self.collectives.append((kind, result, len(ranks), ranks))

    def breakdown(self, top: int = 15) -> list[dict]:
        """The ops by HBM bytes, most first: the profile view the JAX
        accountant's ``breakdown`` gives by computation."""
        rows = [{"op": name, "calls": c, "flops": f, "bytes": b, "wire_bytes": w}
                for name, (c, f, b, w) in self._by_op.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:top]


def _counted_scan_steps(acc: OpAccountant, xf, dtf, Af, Bf, Cf, h):
    """``ref.scan_steps`` under ``acc``: the counted scan on fake tensors of
    S >= 3 steps from a state that takes no grad, else the loop."""
    from torch._subclasses.fake_tensor import FakeTensor

    ins = (xf, dtf, Af, Bf, Cf)
    if xf.shape[1] < 3 or not isinstance(xf, FakeTensor) or h.requires_grad:
        return ref._scan_steps(*ins, h)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return _CountedScan.apply(acc, h, *ins)
    return _counted_forward(acc, ins, h)


def _counted_forward(acc: OpAccountant, ins, h0):
    """The loop's forward as counted: step 0 under ``scaled(S)``, then the
    stack of S outputs, with the other S - 1 outputs the loop holds until
    its stack standing in the tally."""
    S = ins[0].shape[1]
    with acc.scaled(S):
        h, y = ref.scan_step(*ins, h0, 0)
    others = torch.empty((S - 1) * _nbytes(y), dtype=torch.uint8, device=y.device)
    acc._add_storage(others)
    y = torch.stack([y] * S, dim=1)
    acc._release(id(others.untyped_storage()))
    return y, h


def _step_residual_bytes(ins, h) -> int:
    """The bytes one step's autograd keeps for its backward beyond its
    inputs' storages (its new state, its decay, ...): traced with grad on
    ``ins`` (xf, dtf, Af, Bf, Cf) from state ``h``, under a scale of 0."""
    known = {id(t.untyped_storage()) for t in (*ins, h)}
    kept: dict = {}

    def pack(t):
        st = t.untyped_storage()
        if id(st) not in known:
            kept[id(st)] = st.nbytes()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        inputs = [t.detach().requires_grad_() for t in (*ins, h)]
        ref.scan_step(*inputs, 0)
    return sum(kept.values())


class _CountedScan(torch.autograd.Function):
    """``ref._scan_steps`` as the accountant counts it, in three traced
    steps instead of S (module docstring). Its outputs have the loop's
    shapes; their values are those of step 0 (fake tensors carry none).

    Forward: step 0 under ``scaled(S)`` (every step runs the same ops on
    tensors of the same shapes), then the stack of S outputs. Backward: the
    first, a middle and the last step are traced again with grad under
    ``scaled(0)``; the stack's backward (a select a step), then the last
    step's VJP, the middle
    one's under ``scaled(S - 2)`` and the first's, each from the state grad
    the step after it hands back, as the loop's autograd runs them; the grads
    of the inputs (each step's reach the whole input, through its select's
    backward) add up in S - 1 sums as the engine adds the loop's."""

    @staticmethod
    def forward(ctx, acc, h0, *ins):
        S = ins[0].shape[1]
        y, h = _counted_forward(acc, ins, h0)
        with acc.scaled(0):
            per_step = _step_residual_bytes(ins, h0)
        # what the loop's autograd keeps for its S steps, live until backward
        kept = torch.empty(S * per_step, dtype=torch.uint8, device=h0.device)
        acc._add_storage(kept)
        ctx.acc = acc
        ctx.save_for_backward(h0, *ins, kept)
        ctx.mark_non_differentiable(h)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, _gh):
        acc = ctx.acc
        h0, *ins, _kept = ctx.saved_tensors
        S = ins[0].shape[1]
        wanted = ctx.needs_input_grad[2:]
        with acc.scaled(0), torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(ins, wanted)]
            h1, y_first = ref.scan_step(*inputs, h0, 0)
            h_mid_in = h1.detach().requires_grad_()
            h_mid, y_mid = ref.scan_step(*inputs, h_mid_in, 1)
            h_last_in = h_mid.detach().requires_grad_()
            _, y_last = ref.scan_step(*inputs, h_last_in, S - 1)
        need = [t for t in inputs if t.requires_grad]
        # the stack's backward: one select of gy a step
        gy_last = gy.select(1, S - 1)
        with acc.scaled(S - 2):
            gy_mid = gy.select(1, 1)
        gy_first = gy.select(1, 0)
        dh, *g_last = torch.autograd.grad([y_last], [h_last_in, *need], [gy_last])
        # the loop frees each step's residuals as its backward ends: here
        # they leave the tally at once, once the last step's is done
        acc._release(id(_kept.untyped_storage()))
        with acc.scaled(S - 2):
            dh, *g_mid = torch.autograd.grad([y_mid, h_mid], [h_mid_in, *need], [gy_mid, dh])
        g_first = torch.autograd.grad([y_first, h1], need, [gy_first, dh])
        total = [a + b for a, b in zip(g_first, g_last)]
        with acc.scaled(S - 2):
            total = [a + b for a, b in zip(total, g_mid)]
        it = iter(total)
        return (None, None, *[next(it) if w else None for w in wanted])


def account(fn, *args, arguments=None, **kwargs):
    """``fn(*args, **kwargs)`` under a fresh accountant, ``arguments`` (a
    tree of tensors, by default ``args``) registered as live from the start.
    Returns ``(result, accountant)``."""
    acc = OpAccountant()
    acc.add_arguments(args if arguments is None else arguments)
    with acc:
        out = fn(*args, **kwargs)
    return out, acc
