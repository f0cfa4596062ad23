"""The port's dry-run (``repro_torch.launch.dryrun``, ``specs``, ``roofline``,
``op_account``, ``report``) against the JAX package's, on the CPU.

(a) ``model_flops`` equals the JAX one for every assigned arch x shape.
(b) ``_wire_bytes`` equals the JAX one per collective at group sizes 1-16.
(c) The specs have the JAX shapes and dtypes for every arch x shape.
(d) The accountant counts a tanh(x @ w) chain's products exactly, forward
    and backward.
(e) A DTensor product on a fake (2, 2) mesh counts the rank's local product
    once, on a first trace and on a second: the global product DTensor's
    sharding propagation runs for its metadata is left out.
(f) An all-gather over a group of 2 gives the JAX ring model's wire bytes.
(g) ``lower_cell`` on a (1, 1) mesh for reduced qwen3-8b at a train shape and
    at prefill and decode shapes, against the JAX ``lower_cell`` on one
    device: argument bytes equal but for the JAX program's int32 scalar (the
    optimizer step in train, the position in decode; the port keeps both as
    Python ints); FLOPs within 2%. The one gap is in the train cell: with
    remat, the port's count holds one attention block product per layer and
    microbatch more than the JAX count, 2 B Hq S T D (8388608 FLOPs, 1.2% of
    the cell). The port's recomputed forward runs flash_xla_train's q k^T and
    p v products again, as written; the optimised HLO the JAX accountant
    reads holds one fewer. Without remat the two counts are equal.
    ``per_device_total`` is printed, not compared: XLA's buffer assignment
    against the port's eager live bytes.
(h) The same cells on a fake (2, 2) mesh: FLOPs per chip x 4 within 1% of the
    (1, 1) cell's, argument bytes per chip the local shards that
    ``param_specs``/``cache_specs``/``batch_spec`` give, collectives counted
    and their wire bytes by the JAX formula.
(i) ``python -m repro_torch.launch.dryrun --device cpu`` writes an artifact
    that ``report`` renders, and prints a full-attention arch's long_500k
    cell as SKIP, as the JAX dry-run does.
(j) The counted SSD scan (``op_account._CountedScan``) on fake tensors
    against the plain loop it stands for (``OpAccountant(count_loops=False)``)
    at S = 3, 4, 8, 17 and 64: FLOPs and HBM bytes equal, forward alone,
    forward and backward, under a non-reentrant checkpoint, and in the
    stateful form under no_grad, f32 and bf16; after the forward the tally
    holds the bytes the loop's autograd keeps, exactly; from S = 17 on,
    where the S steps' tensors outweigh the few kB a single step's
    temporaries hold, the peak is within 25% of the loop's.
(k) (g) and (h) for reduced mamba2-370m and hymba-1.5b at the same cells.
    FLOPs within 2% of the JAX count; the gaps are in the train cells, where
    the eager recompute of remat "full" runs products the optimised HLO the
    JAX accountant reads drops as dead: the SSD scan's output einsum, 2 B H P
    N S per layer and microbatch (the recomputed forward needs only the
    states), and for hymba past its window one banded block's q k^T per
    layer and microbatch, 2 B Hq bq (window + bq) D, as the dense gap of
    (g). mamba2 +0.99%, hymba +1.30%. Argument bytes equal but for the JAX
    int32 scalar and what JAX's jit drops as never read: mamba2's decode
    position (no attention reads it) and, in hymba's prefill of 64 > its
    ring of 32, the k/v caches, which the ring prefill overwrites unread.
(l) (g) and (h) for reduced granite-moe-3b-a800m and llama4-scout-17b-a16e,
    whose experts (8 and 4) split over "data" of 2 on the (2, 2) mesh: the
    one-rank cells' FLOPs equal the JAX count in prefill and decode, and in
    train lie above it by the attention block product of (g) alone, 2 B Hq
    S T D per layer and microbatch (granite +1.73%, llama4 +0.74%); the
    experts' products count as the JAX einsums over the (E, C, d) buffer do.
    Four ranks: FLOPs per chip x 4 within 1% of the one-rank cell (each
    model rank routes its T / tp of the tokens; an expert's
    buffer is split over "data", its F over "model"), argument bytes the
    local shards, collectives by the JAX formula. Granite without FSDP, its
    experts whole over "data" (as granite's 40 at 16-way): each data rank
    multiplies a whole C-slot buffer of its own rows, so 4 x the per-chip
    FLOPs exceed the one-rank cell's by its expert products, exactly the
    split cell's plus their difference. On its own under the
    accountant, on a fake (2, 2) mesh, one MoE block runs each collective
    of its dispatch once: forward, the router's choices gathered over
    "model" (gates and experts), the counts over "data", the buffer's
    reduce-scatter over "data", the expert product's all-gather over "model"
    and the products' over "data"; backward, the mirror of each that carries
    a grad.
(m) (g) and (h) for reduced whisper-tiny and pixtral-12b, with their stub
    inputs (whisper's frames in train, its cross K/V in the serve cells'
    caches; pixtral's frontend in train and prefill), on (2, 2) and (1, 4)
    (where pixtral's 2 kv heads put its cache over T). The one-rank cells'
    FLOPs equal the JAX count in prefill and decode and lie above it in
    train by (g)'s gap, one attention product per attention, layer and
    microbatch: 2 B Hq Sq Tk D over the decoder's self-attention (S x S),
    whisper's encoder (T x T) and its cross-attention (S x T). Argument
    bytes equal but for the JAX int32 scalar and what JAX's jit drops as
    never read: whisper's serve cells read neither the encoder's params nor
    ``cross.wkv`` (the cross K/V are in the cache). Four ranks: FLOPs per
    chip x 4 within 1% of the one-rank cell (whisper's cross K/V product
    made whole over "model" after the product, as the self-attention's, so
    that no rank makes the whole weight grad), argument bytes the local
    shards, collectives by the JAX formula. Reduced qwen3-8b's decode under ``--opt dense_decode``:
    its one-rank cell equals the JAX one, and on (1, 4), where its 2 kv heads
    put the cache over T, the dense product over each rank's part of T
    splits it (x 4 within 1%), with three all-reduces over "model" a layer.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core.arch import ASSIGNED_SHAPES as JAX_SHAPES  # noqa: E402
from repro.core.arch import InputShape as JaxShape  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.configs import get_arch, get_reduced  # noqa: E402
from repro_torch.core.arch import ASSIGNED_SHAPES, InputShape  # noqa: E402
from repro_torch.launch import dryrun, report, specs  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.op_account import OpAccountant, account  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.sharding import (MeshShape, batch_spec, cache_specs,  # noqa: E402
                                           make_plan, param_specs)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = {"train": (64, 4), "prefill": (64, 2), "decode": (64, 2)}  # kind -> (S, B)
MESH_1, MESH_4 = ((1, 1), ("data", "model")), ((2, 2), ("data", "model"))
FLOP_TOL_JAX, FLOP_TOL_MESH = 0.02, 0.01


# --- (a), (b) --------------------------------------------------------------

@pytest.mark.parametrize("name", ASSIGNED)
def test_model_flops_equal_the_jax_ones(name):
    for jshape, shape in zip(JAX_SHAPES, ASSIGNED_SHAPES):
        want = jrl.model_flops(jax_arch(name), jshape)
        assert rl.model_flops(get_arch(name), shape) == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_wire_bytes_equal_the_jax_ring_model(op):
    for g in (1, 2, 4, 16):
        assert rl._wire_bytes(op, 3.0e6, g) == jrl._wire_bytes(op, 3.0e6, g)


def test_the_slowest_link_sets_a_collectives_rate():
    assert rl.PEAK_FLOPS == 989e12 and rl.HBM_BW == 3.35e12 and rl.MEM_BYTES == 80e9
    assert rl.link_bw(range(8)) == 900e9
    assert rl.link_bw(range(16)) == rl.link_bw(range(0, 256, 16)) == 50e9


# --- (c) -------------------------------------------------------------------

def _same_structs(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_structs(got[k], w)
        else:
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("name", ASSIGNED)
def test_specs_have_the_jax_shapes_and_dtypes(name):
    import jax.numpy as jnp

    from repro.launch import specs as jspecs
    from repro.models import lm as jlm

    jcfg = jlm.ModelCfg(dtype=jnp.bfloat16)
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    jarch, arch = jax_arch(name), get_arch(name)
    for jshape, shape in zip(JAX_SHAPES, ASSIGNED_SHAPES):
        assert specs.text_len(arch, shape.seq_len) == jspecs.text_len(jarch, jshape.seq_len)
        _same_structs(specs.train_batch_specs(arch, shape, cfg),
                      jax.eval_shape(lambda: jspecs.train_batch_specs(jarch, jshape, jcfg)))
        _same_structs(specs.prefill_specs(arch, shape, cfg),
                      jax.eval_shape(lambda: jspecs.prefill_specs(jarch, jshape, jcfg)))
        want = jspecs.decode_specs(jarch, jshape, jcfg)
        got = specs.decode_specs(arch, shape, cfg)
        assert want.pop("position").shape == () and got.pop("position") == shape.seq_len - 1
        _same_structs(got, want)


# --- (d), (e), (f) ---------------------------------------------------------

def test_the_accountant_counts_a_product_chain_forward_and_backward():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(128, 256, generator=g, requires_grad=True)
    w = torch.randn(256, 256, generator=g, requires_grad=True)

    def chain(x, w):
        h = x
        for _ in range(8):
            h = torch.tanh(h @ w)
        return h

    fwd = 2 * 8 * 128 * 256 * 256
    _, acc = account(chain, x, w)
    assert acc.totals.flops == fwd
    _, acc = account(lambda x, w: chain(x, w).sum().backward(), x, w)
    assert acc.totals.flops == 3 * fwd
    assert acc.memory()["argument_bytes"] == (128 + 256) * 256 * 4


def _local(mesh, shape, places, local_shape):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(torch.empty(local_shape), mesh, places, run_check=False,
                              shape=shape, stride=(shape[1], 1))


def test_a_dtensor_product_counts_the_ranks_local_product_once_per_trace():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with dryrun.fake_mesh(MeshShape(*MESH_4), "cpu") as mesh, FakeTensorMode():
        x = _local(mesh, (64, 256), (Shard(0), Replicate()), (32, 256))
        w = _local(mesh, (512, 256), (Replicate(), Shard(0)), (256, 256))
        muted = []
        for _ in range(2):
            acc = OpAccountant()
            with acc:
                y = x @ w.T
            assert acc.totals.flops == 2 * 32 * 256 * 256
            assert y.to_local().shape == (32, 256)
            muted.append(acc.muted_ops)
    # the first trace ran DTensor's metadata product (left out), the second
    # found it cached
    assert muted[0] > 0 and muted[1] == 0


def test_an_all_gather_over_two_ranks_has_the_jax_wire_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    with dryrun.fake_mesh(MeshShape(*MESH_4), "cpu") as mesh, FakeTensorMode():
        x = _local(mesh, (64, 256), (Replicate(), Shard(0)), (32, 256))
        acc = OpAccountant()
        with acc:
            x.redistribute(mesh, (Replicate(), Replicate())).to_local()
    result = 64 * 256 * 4
    assert [c[:3] for c in acc.collectives] == [("all-gather", result, 2)]
    assert acc.collectives[0][3] == (0, 1)  # rank 0's "model" group, one node
    assert acc.totals.wire_bytes == jrl._wire_bytes("all-gather", result, 2)
    assert acc.totals.collective_s == acc.totals.wire_bytes / rl.INTRA_NODE_BW


# --- (g), (h) --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cells():
    """The JAX lower_cell reports on one device. Importing repro.launch.dryrun
    sets XLA_FLAGS for 512 host devices: the backend is started first, and
    the variable is put back after the import."""
    from repro.launch.mesh import make_mesh

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    mesh = make_mesh(*MESH_1)
    return {kind: jdryrun.lower_cell(jax_reduced("qwen3-8b"), JaxShape(kind, S, B, kind), mesh)
            for kind, (S, B) in CELLS.items()}


@pytest.fixture(scope="module")
def port_cells():
    arch = get_reduced("qwen3-8b")
    return {(mesh, kind): dryrun.lower_cell(arch, InputShape(kind, S, B, kind),
                                            MeshShape(*mesh), device="cpu")
            for mesh in (MESH_1, MESH_4) for kind, (S, B) in CELLS.items()}


# the JAX program's int32 scalar argument the port keeps as a Python int
JAX_ONLY_ARG_BYTES = {"train": 4, "prefill": 0, "decode": 4}


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_one_rank_cell_against_the_jax_dry_run(kind, jax_cells, port_cells):
    want, got = jax_cells[kind], port_cells[(MESH_1, kind)]
    assert got["ok"] and got["mesh"] == "1x1"
    assert (got["memory"]["argument_bytes"] + JAX_ONLY_ARG_BYTES[kind]
            == want["memory"]["argument_bytes"])
    jf, tf = want["roofline"]["flops_per_chip"], got["roofline"]["flops_per_chip"]
    assert abs(tf - jf) <= FLOP_TOL_JAX * jf, (tf, jf)
    assert got["roofline"]["model_flops_total"] == want["roofline"]["model_flops_total"]
    print(f"{kind}: per_device_total port {got['memory']['per_device_total']} bytes, "
          f"JAX {want['memory']['per_device_total']} bytes")


def _local_bytes(plan, spec_tree, struct_tree) -> int:
    if isinstance(struct_tree, dict):
        return sum(_local_bytes(plan, spec_tree[k], v) for k, v in struct_tree.items())
    n = struct_tree.numel() * struct_tree.element_size()
    for entry in spec_tree:
        for axis in (entry,) if isinstance(entry, str) else tuple(entry or ()):
            n //= plan.axis_size(axis)
    return n


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_four_rank_cell_splits_the_one_rank_cell(kind, port_cells):
    one, four = port_cells[(MESH_1, kind)], port_cells[(MESH_4, kind)]
    f1, f4 = one["roofline"]["flops_per_chip"], four["roofline"]["flops_per_chip"]
    assert abs(4 * f4 - f1) <= FLOP_TOL_MESH * f1, (4 * f4, f1)
    arch, (S, B) = get_reduced("qwen3-8b"), CELLS[kind]
    plan = make_plan(MeshShape(*MESH_4), fsdp=True)
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    shape = InputShape(kind, S, B, kind)
    if kind == "train":
        p = lm.init_params(arch, torch.Generator(), torch.float32, device="meta")
        b = specs.train_batch_specs(arch, shape, cfg)
        want = 3 * _local_bytes(plan, param_specs(arch, plan, p), p)  # params, mu, nu
        want += _local_bytes(plan, batch_spec(plan, b), b)
    else:
        p = lm.init_params(arch, torch.Generator(), torch.bfloat16, device="meta")
        s = (specs.prefill_specs if kind == "prefill" else specs.decode_specs)(arch, shape, cfg)
        want = (_local_bytes(plan, param_specs(arch, plan, p), p)
                + _local_bytes(plan, cache_specs(arch, plan, s["caches"]), s["caches"])
                + _local_bytes(plan, batch_spec(plan, {"t": s["tokens"]}), {"t": s["tokens"]}))
    assert four["memory"]["argument_bytes"] == want
    coll = four["collectives"]
    assert sum(coll["counts"].values()) > 0
    wire = sum(jrl._wire_bytes(r["op"], r["result_bytes"], r["group_size"])
               for r in coll["by_group_size"])
    assert coll["wire_bytes"] == pytest.approx(wire, rel=1e-12)
    assert four["roofline"]["chips"] == 4 and four["memory"]["fits_h100_80g"]


def test_lower_cell_refuses_what_it_cannot_trace():
    from repro_torch.core.arch import ASSIGNED_SHAPES

    decode = {s.name: s for s in ASSIGNED_SHAPES}["decode_32k"]
    with pytest.raises(ValueError, match="unknown --opt"):
        dryrun.lower_cell(get_reduced("qwen3-8b"), decode, MeshShape(*MESH_4), device="cpu",
                          opts=frozenset({"no_such_opt"}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            dryrun.lower_cell(get_reduced("qwen3-8b"), decode, MeshShape(*MESH_4))


# --- (i) -------------------------------------------------------------------

def _cli(*argv, out):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--reduced",
         "--shape", "decode_32k", "--mesh", "2x2", "--out", str(out), *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def test_the_cli_writes_an_artifact_that_report_renders(tmp_path):
    res = _cli("--arch", "qwen3-8b", out=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "  ok lower=" in res.stdout
    cells = report.load_cells(str(tmp_path))
    assert [c["arch"] for c in cells] == ["qwen3-8b-reduced"] and cells[0]["ok"]
    assert json.loads((tmp_path / "qwen3-8b-reduced__decode_32k__2x2.json").read_text())["ok"]
    table = report.markdown_table(cells, single_pod_only=False)  # "2x..." reads as two pods
    assert "| qwen3-8b-reduced | decode_32k | 2x2 |" in table
    assert report.summary(cells)["cells_ok"] == 1

    res = _cli("--arch", "pixtral-12b", "--shape", "long_500k", out=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert ("SKIP pixtral-12b x long_500k: full-attention arch: 500k dense decode skipped"
            in res.stdout)
    assert len(report.load_cells(str(tmp_path))) == 1
    assert math.isfinite(report.summary(cells)["worst_fraction"][0])


# --- (j) ---------------------------------------------------------------------

def _scan_count(count_loops: bool, S: int, mode: str, dtype):
    """The plain SSD scan on fake tensors under an accountant: ``mode``
    "forward", "backward" (forward + grads), "remat" (forward + grads through
    a non-reentrant checkpoint) or "state" (init_state, return_state, under
    no_grad). Returns the accountant and its live bytes after the forward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import ref

    B, H, P, N = 2, 4, 8, 16
    with FakeTensorMode():
        grad = mode != "state"
        ins = (torch.empty(B, S, H, P, dtype=dtype, requires_grad=grad),
               torch.empty(B, S, H, dtype=dtype, requires_grad=grad),
               torch.empty(H, requires_grad=grad),
               torch.empty(B, S, N, dtype=dtype, requires_grad=grad),
               torch.empty(B, S, N, dtype=dtype, requires_grad=grad),
               torch.empty(H, requires_grad=grad))
        acc = OpAccountant(count_loops=count_loops)
        acc.add_arguments(ins)
        with acc:
            if mode == "state":
                with torch.no_grad():
                    ref.ssd_scan(*ins, init_state=torch.empty(B, H, P, N), return_state=True)
                return acc, acc.live_bytes
            if mode == "remat":
                loss = checkpoint(lambda *a: ref.ssd_scan(*a).sum(), *ins, use_reentrant=False)
                after = acc.live_bytes
            else:
                loss = ref.ssd_scan(*ins).sum()
                after = acc.live_bytes
            if mode != "forward":
                torch.autograd.grad(loss, ins)
    return acc, after


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["forward", "backward", "remat", "state"])
def test_the_counted_scan_counts_what_the_loop_runs(mode, dtype):
    for S in (3, 4, 8, 17, 64):
        loop, loop_after = _scan_count(False, S, mode, dtype)
        counted, counted_after = _scan_count(True, S, mode, dtype)
        assert counted.totals.flops == loop.totals.flops > 0, (S, mode)
        assert counted.totals.bytes == loop.totals.bytes > 0, (S, mode)
        if mode in ("forward", "backward"):
            assert counted_after == loop_after, (S, mode)  # the loop's residuals, held
        if S >= 17:
            assert abs(counted.peak_bytes - loop.peak_bytes) <= 0.25 * loop.peak_bytes, (
                S, mode, counted.peak_bytes, loop.peak_bytes)


def test_the_counted_scan_traces_three_steps_not_s():
    """At S = 64 the plain loop dispatches an op set per step; the counted
    scan dispatches the same op set a fixed number of times whatever S is."""
    from repro_torch.launch import op_account

    seen = []
    step = op_account.ref.scan_step
    op_account.ref.scan_step = lambda *a: seen.append(a[-1]) or step(*a)
    try:
        _scan_count(True, 64, "backward", torch.float32)
    finally:
        op_account.ref.scan_step = step
    # forward: step 0 and its residual trace; backward: the first, a middle
    # and the last step
    assert seen == [0, 0, 0, 1, 63]


# --- (k) ---------------------------------------------------------------------

SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")


@pytest.fixture(scope="module")
def jax_ssm_cells():
    """The JAX lower_cell reports of the ssm and hybrid archs on one device
    (``jax_cells``'s import guard)."""
    from repro.launch.mesh import make_mesh

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    mesh = make_mesh(*MESH_1)
    return {(name, kind): jdryrun.lower_cell(jax_reduced(name), JaxShape(kind, S, B, kind), mesh)
            for name in SSM_ARCHS for kind, (S, B) in CELLS.items()}


@pytest.fixture(scope="module")
def port_ssm_cells():
    return {(name, mesh, kind): dryrun.lower_cell(get_reduced(name), InputShape(kind, S, B, kind),
                                                  MeshShape(*mesh), device="cpu")
            for name in SSM_ARCHS for mesh in (MESH_1, MESH_4)
            for kind, (S, B) in CELLS.items()}


def _unread_bytes(arch, kind: str, S: int, B: int) -> int:
    """The argument bytes JAX's jit drops from a program that never reads
    them: the int32 position of an attention-free model's decode step, and
    the k/v caches of a ring prefill (S >= the ring's T), which it writes
    unread."""
    if kind == "decode" and arch.is_attention_free:
        return JAX_ONLY_ARG_BYTES[kind]
    if kind != "prefill" or not arch.sliding_window or S < arch.sliding_window:
        return 0
    caches = specs.prefill_specs(arch, InputShape(kind, S, B, kind),
                                 lm.ModelCfg(dtype=torch.bfloat16))["caches"]
    return sum(caches[k].numel() * caches[k].element_size() for k in ("k", "v"))


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_an_ssm_or_hybrid_one_rank_cell_against_the_jax_dry_run(name, kind, jax_ssm_cells,
                                                                port_ssm_cells):
    want, got = jax_ssm_cells[(name, kind)], port_ssm_cells[(name, MESH_1, kind)]
    S, B = CELLS[kind]
    assert got["ok"] and got["mesh"] == "1x1"
    unread = _unread_bytes(get_reduced(name), kind, S, B)
    assert (got["memory"]["argument_bytes"] + JAX_ONLY_ARG_BYTES[kind] - unread
            == want["memory"]["argument_bytes"])
    jf, tf = want["roofline"]["flops_per_chip"], got["roofline"]["flops_per_chip"]
    assert abs(tf - jf) <= FLOP_TOL_JAX * jf, (tf, jf)
    if kind != "train":  # the gap of docstring (k) is the train cells' alone
        assert tf == jf
    assert got["roofline"]["model_flops_total"] == want["roofline"]["model_flops_total"]


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_an_ssm_or_hybrid_four_rank_cell_splits_the_one_rank_cell(name, kind, port_ssm_cells):
    one, four = port_ssm_cells[(name, MESH_1, kind)], port_ssm_cells[(name, MESH_4, kind)]
    f1, f4 = one["roofline"]["flops_per_chip"], four["roofline"]["flops_per_chip"]
    assert abs(4 * f4 - f1) <= FLOP_TOL_MESH * f1, (4 * f4, f1)
    arch, (S, B) = get_reduced(name), CELLS[kind]
    plan = make_plan(MeshShape(*MESH_4), fsdp=True)
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    shape = InputShape(kind, S, B, kind)
    if kind == "train":
        p = lm.init_params(arch, torch.Generator(), torch.float32, device="meta")
        b = specs.train_batch_specs(arch, shape, cfg)
        want = 3 * _local_bytes(plan, param_specs(arch, plan, p), p)  # params, mu, nu
        want += _local_bytes(plan, batch_spec(plan, b), b)
    else:
        p = lm.init_params(arch, torch.Generator(), torch.bfloat16, device="meta")
        s = (specs.prefill_specs if kind == "prefill" else specs.decode_specs)(arch, shape, cfg)
        want = (_local_bytes(plan, param_specs(arch, plan, p), p)
                + _local_bytes(plan, cache_specs(arch, plan, s["caches"]), s["caches"])
                + _local_bytes(plan, batch_spec(plan, {"t": s["tokens"]}), {"t": s["tokens"]}))
    assert four["memory"]["argument_bytes"] == want
    coll = four["collectives"]
    assert sum(coll["counts"].values()) > 0
    wire = sum(jrl._wire_bytes(r["op"], r["result_bytes"], r["group_size"])
               for r in coll["by_group_size"])
    assert coll["wire_bytes"] == pytest.approx(wire, rel=1e-12)
    assert four["roofline"]["chips"] == 4 and four["memory"]["fits_h100_80g"]


# --- (l) ---------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
WHOLE = "granite-moe-3b-a800m without FSDP"  # its experts whole over "data"


@pytest.fixture(scope="module")
def jax_moe_cells():
    """The JAX lower_cell reports of the moe archs on one device
    (``jax_cells``'s import guard)."""
    from repro.launch.mesh import make_mesh

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    mesh = make_mesh(*MESH_1)
    return {(name, kind): jdryrun.lower_cell(jax_reduced(name), JaxShape(kind, S, B, kind), mesh)
            for name in MOE_ARCHS for kind, (S, B) in CELLS.items()}


@pytest.fixture(scope="module")
def port_moe_cells():
    return {(name, mesh, kind): dryrun.lower_cell(get_reduced(name), InputShape(kind, S, B, kind),
                                                  MeshShape(*mesh), device="cpu")
            for name in MOE_ARCHS for mesh in (MESH_1, MESH_4)
            for kind, (S, B) in CELLS.items()} | {
        (WHOLE, MESH_4, kind): dryrun.lower_cell(get_reduced("granite-moe-3b-a800m"),
                                                 InputShape(kind, S, B, kind),
                                                 MeshShape(*MESH_4), fsdp=False, device="cpu")
        for kind, (S, B) in CELLS.items()}


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_a_moe_one_rank_cell_against_the_jax_dry_run(name, kind, jax_moe_cells, port_moe_cells):
    want, got = jax_moe_cells[(name, kind)], port_moe_cells[(name, MESH_1, kind)]
    arch, (S, B) = get_reduced(name), CELLS[kind]
    assert got["ok"] and got["mesh"] == "1x1"
    assert (got["memory"]["argument_bytes"] + JAX_ONLY_ARG_BYTES[kind]
            == want["memory"]["argument_bytes"])
    jf, tf = want["roofline"]["flops_per_chip"], got["roofline"]["flops_per_chip"]
    assert abs(tf - jf) <= FLOP_TOL_JAX * jf, (tf, jf)
    gap = 0
    if kind == "train":  # docstring (g): one attention block product a layer and microbatch
        K = got["num_microbatches"]
        gap = arch.num_layers * K * 2 * (B // K) * arch.heads * S * S * arch.head_dim
    assert tf - jf == gap
    assert got["roofline"]["model_flops_total"] == want["roofline"]["model_flops_total"]


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_a_moe_four_rank_cell_splits_the_one_rank_cell(name, kind, port_moe_cells):
    one, four = port_moe_cells[(name, MESH_1, kind)], port_moe_cells[(name, MESH_4, kind)]
    f1, f4 = one["roofline"]["flops_per_chip"], four["roofline"]["flops_per_chip"]
    assert abs(4 * f4 - f1) <= FLOP_TOL_MESH * f1, (4 * f4, f1)
    assert get_reduced(name).num_experts % 2 == 0  # the experts split over "data"
    _four_rank_bytes_and_wire(name, kind, four, fsdp=True)
    assert four["collectives"]["counts"]["reduce-scatter"] > 0  # the dispatch's, at least


def _expert_flops(arch, kind: str, report: dict, dp: int, tp: int) -> tuple[int, int, int]:
    """The grouped expert products' FLOPs per chip of a moe cell, the slots
    of one expert's buffer, and C. Per layer, microbatch and pass, the two
    products over an (E, C', d) buffer make 6 E C' d F, over tp (which
    splits F); C' = min(C, T / dp), C from the microbatch's T: all C slots
    on one rank, at most a data rank's own tokens where the experts lie
    whole over "data". A train cell runs each product 4 times: forward,
    remat's recompute, and two products in backward."""
    from repro_torch.models.moe import capacity

    S, B = CELLS[kind]
    K = report["num_microbatches"] if kind == "train" else 1
    T = B // K * (1 if kind == "decode" else S)
    C = capacity(T, arch.top_k, 1.25, arch.num_experts)
    slots = min(C, T // dp)
    passes = 4 if kind == "train" else 1
    return (arch.num_layers * K * passes * 6 * arch.num_experts * slots * arch.hidden
            * arch.moe_ffn // tp, slots, C)


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_moe_four_rank_cell_with_experts_whole_over_data(kind, port_moe_cells):
    """Granite without FSDP on (2, 2): its experts lie whole over "data", as
    granite's 40 do over a data axis of 16 at production. Each data rank
    multiplies its own kept rows in an (E, min(C, T / 2), d) buffer, and
    here C <= T / 2: each of the two data ranks runs the products of a whole
    C-slot buffer (F split over "model"). So the four chips run twice the
    one-rank cell's expert FLOPs X, and 4 x the per-chip FLOPs exceed the
    one-rank cell's by X (4 x the split cell's exceed them by under 1%, the
    aux loss's router product, replicated over "model"). Per chip, exactly:
    the split cell plus the expert products' difference."""
    name = "granite-moe-3b-a800m"
    arch = get_reduced(name)
    one, split = port_moe_cells[(name, MESH_1, kind)], port_moe_cells[(name, MESH_4, kind)]
    whole = port_moe_cells[(WHOLE, MESH_4, kind)]
    x1, _, _ = _expert_flops(arch, kind, one, dp=1, tp=1)
    x4, slots, C = _expert_flops(arch, kind, whole, dp=2, tp=2)
    assert slots == C and 4 * x4 == 2 * x1
    f1, fs, fw = (r["roofline"]["flops_per_chip"] for r in (one, split, whole))
    assert fw - fs == x4 - x1 / 4
    assert abs(4 * fw - f1 - x1) <= FLOP_TOL_MESH * f1
    _four_rank_bytes_and_wire(name, kind, whole, fsdp=False)


def _four_rank_bytes_and_wire(name: str, kind: str, four: dict, fsdp: bool):
    """A four-rank cell's argument bytes are each leaf's local shard under the
    rules, its collectives' wire bytes the JAX formula's, and it fits."""
    arch, (S, B) = get_reduced(name), CELLS[kind]
    plan = make_plan(MeshShape(*MESH_4), fsdp=fsdp)
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    shape = InputShape(kind, S, B, kind)
    if kind == "train":
        p = lm.init_params(arch, torch.Generator(), torch.float32, device="meta")
        b = specs.train_batch_specs(arch, shape, cfg)
        want = 3 * _local_bytes(plan, param_specs(arch, plan, p), p)  # params, mu, nu
        want += _local_bytes(plan, batch_spec(plan, b), b)
    else:
        p = lm.init_params(arch, torch.Generator(), torch.bfloat16, device="meta")
        s = (specs.prefill_specs if kind == "prefill" else specs.decode_specs)(arch, shape, cfg)
        want = (_local_bytes(plan, param_specs(arch, plan, p), p)
                + _local_bytes(plan, cache_specs(arch, plan, s["caches"]), s["caches"])
                + _local_bytes(plan, batch_spec(plan, {"t": s["tokens"]}), {"t": s["tokens"]}))
    assert four["memory"]["argument_bytes"] == want
    coll = four["collectives"]
    wire = sum(jrl._wire_bytes(r["op"], r["result_bytes"], r["group_size"])
               for r in coll["by_group_size"])
    assert coll["wire_bytes"] == pytest.approx(wire, rel=1e-12)
    assert four["roofline"]["chips"] == 4 and four["memory"]["fits_h100_80g"]


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "forward-backward"])
def test_a_moe_block_runs_each_collective_of_its_dispatch_once(backward):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.moe import capacity, moe_block
    from repro_torch.parallel.sharding import P

    arch = get_reduced("granite-moe-3b-a800m")
    E, d, F, k = arch.num_experts, arch.hidden, arch.moe_ffn, arch.top_k
    B, S = 2, 16
    plan = make_plan(MeshShape(*MESH_4), fsdp=True)
    with dryrun.fake_mesh(MeshShape(*MESH_4), "cpu") as mesh, FakeTensorMode():
        p = lm.init_params(arch, torch.Generator(), torch.float32, device="cpu")
        p = dryrun._placed(mesh, p, param_specs(arch, plan, p))
        lp = {name: w[0] for name, w in p["layers"]["moe"].items()}
        x = dryrun._placed(mesh, torch.empty(B, S, d), P("data", None, None))
        leaves = [x, *lp.values()]
        for t in leaves:
            t.requires_grad_(backward)
        acc = OpAccountant()
        with acc:
            y = moe_block(lp, x, top_k=k)
            if backward:
                torch.autograd.grad(y.to_local().sum(), leaves)
    C = capacity(B * S, k, 1.25, E)
    T_r = B * S // 2  # a rank's tokens; each "model" rank routes half of them
    f32, i64 = 4, 8
    fwd = [("all-gather", T_r * k * f32, 2), ("all-gather", T_r * k * i64, 2),  # gates, experts
           ("all-gather", 2 * E * i64, 2),  # the counts, over "data"
           ("reduce-scatter", E // 2 * C * d * f32, 2),  # the buffer, over "data"
           ("all-gather", E // 2 * C * 2 * F * f32, 2),  # wi's product, over "model"
           ("all-gather", E * C * d * f32, 2)]  # the products, over "data"
    bwd = [("reduce-scatter", E // 2 * C * d * f32, 2),  # the products' grad
           ("reduce-scatter", E // 2 * C * F * f32, 2),  # wi's product's
           ("all-gather", E * C * d * f32, 2),  # the buffer's
           ("reduce-scatter", T_r // 2 * k * f32, 2)]  # the gates'
    got = sorted(c[:3] for c in acc.collectives)
    assert got == sorted(fwd + (bwd if backward else [])), got


# --- (m) ---------------------------------------------------------------------

STUB_ARCHS = ("whisper-tiny", "pixtral-12b")
MESH_1x4 = ((1, 4), ("data", "model"))
DENSE_DECODE = frozenset({"dense_decode"})


def _jax_lower(cells):
    """The JAX lower_cell reports of ``cells`` ((label, name, kind, opts)) on
    one device (``jax_cells``'s import guard)."""
    from repro.launch.mesh import make_mesh

    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    mesh = make_mesh(*MESH_1)
    return {(label, kind): jdryrun.lower_cell(jax_reduced(name),
                                              JaxShape(kind, *CELLS[kind], kind), mesh, opts=opts)
            for label, name, kind, opts in cells}


@pytest.fixture(scope="module")
def jax_stub_cells():
    return _jax_lower([(name, name, kind, frozenset()) for name in STUB_ARCHS for kind in CELLS]
                      + [("qwen3-8b dense", "qwen3-8b", "decode", DENSE_DECODE)])


@pytest.fixture(scope="module")
def port_stub_cells():
    cells = {(name, mesh, kind): dryrun.lower_cell(get_reduced(name), InputShape(kind, S, B, kind),
                                                   MeshShape(*mesh), device="cpu")
             for name in STUB_ARCHS for mesh in (MESH_1, MESH_4, MESH_1x4)
             for kind, (S, B) in CELLS.items()}
    S, B = CELLS["decode"]
    for mesh in (MESH_1, MESH_1x4):
        cells[("qwen3-8b dense", mesh, "decode")] = dryrun.lower_cell(
            get_reduced("qwen3-8b"), InputShape("decode", S, B, "decode"), MeshShape(*mesh),
            device="cpu", opts=DENSE_DECODE)
    return cells


def _serve_unread_bytes(arch) -> int:
    """What JAX's jit drops from whisper's serve programs as never read: the
    encoder's params and each layer's ``cross.wkv`` (bf16)."""
    if arch.family != "encdec":
        return 0
    p = lm.init_params(arch, torch.Generator(), torch.bfloat16, device="meta")
    leaves = [p["layers"]["cross"]["wkv"]]
    stack = [p["encoder"]]
    while stack:
        node = stack.pop()
        for v in node.values():
            (stack if isinstance(v, dict) else leaves).append(v)
    return sum(x.numel() * x.element_size() for x in leaves)


def _attention_gap(arch, kind: str, K: int) -> int:
    """(g)'s gap: one attention product, 2 B Hq Sq Tk D, per attention, layer
    and microbatch of a train cell (the decoder's self-attention, and
    whisper's encoder and cross-attention over its T frames)."""
    if kind != "train":
        return 0
    S, B = CELLS[kind]
    area = arch.num_layers * S * S  # a vlm's frontend and text positions: S in all
    if arch.family == "encdec":
        T = arch.encoder_seq
        area += arch.num_layers * S * T + arch.encoder_layers * T * T
    return K * 2 * (B // K) * arch.heads * arch.head_dim * area


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("name", STUB_ARCHS)
def test_an_encdec_or_vlm_one_rank_cell_against_the_jax_dry_run(name, kind, jax_stub_cells,
                                                                port_stub_cells):
    want, got = jax_stub_cells[(name, kind)], port_stub_cells[(name, MESH_1, kind)]
    arch = get_reduced(name)
    assert got["ok"] and got["mesh"] == "1x1"
    unread = 0 if kind == "train" else _serve_unread_bytes(arch)
    assert (got["memory"]["argument_bytes"] + JAX_ONLY_ARG_BYTES[kind] - unread
            == want["memory"]["argument_bytes"])
    jf, tf = want["roofline"]["flops_per_chip"], got["roofline"]["flops_per_chip"]
    assert abs(tf - jf) <= FLOP_TOL_JAX * jf, (tf, jf)
    assert tf - jf == _attention_gap(arch, kind, got.get("num_microbatches", 1))
    assert got["roofline"]["model_flops_total"] == want["roofline"]["model_flops_total"]


def _mesh_bytes(name: str, kind: str, mesh) -> int:
    """A cell's argument bytes per chip on ``mesh``: each leaf's local shard
    under the rules (a vlm prefill's frontend beside its tokens)."""
    arch, (S, B) = get_reduced(name), CELLS[kind]
    plan = make_plan(MeshShape(*mesh), fsdp=True)
    cfg = lm.ModelCfg(dtype=torch.bfloat16)
    shape = InputShape(kind, S, B, kind)
    if kind == "train":
        p = lm.init_params(arch, torch.Generator(), torch.float32, device="meta")
        b = specs.train_batch_specs(arch, shape, cfg)
        return 3 * _local_bytes(plan, param_specs(arch, plan, p), p) + _local_bytes(
            plan, batch_spec(plan, b), b)  # params, mu, nu; the batch
    p = lm.init_params(arch, torch.Generator(), torch.bfloat16, device="meta")
    s = (specs.prefill_specs if kind == "prefill" else specs.decode_specs)(arch, shape, cfg)
    b = {k: s[k] for k in ("tokens", "frontend") if k in s}
    return (_local_bytes(plan, param_specs(arch, plan, p), p)
            + _local_bytes(plan, cache_specs(arch, plan, s["caches"]), s["caches"])
            + _local_bytes(plan, batch_spec(plan, b), b))


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("mesh", [MESH_4, MESH_1x4], ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", STUB_ARCHS)
def test_an_encdec_or_vlm_four_rank_cell_splits_the_one_rank_cell(name, mesh, kind,
                                                                  port_stub_cells):
    one, four = port_stub_cells[(name, MESH_1, kind)], port_stub_cells[(name, mesh, kind)]
    f1, f4 = one["roofline"]["flops_per_chip"], four["roofline"]["flops_per_chip"]
    assert abs(4 * f4 - f1) <= FLOP_TOL_MESH * f1, (4 * f4, f1)
    assert four["memory"]["argument_bytes"] == _mesh_bytes(name, kind, mesh)
    coll = four["collectives"]
    assert sum(coll["counts"].values()) > 0
    wire = sum(jrl._wire_bytes(r["op"], r["result_bytes"], r["group_size"])
               for r in coll["by_group_size"])
    assert coll["wire_bytes"] == pytest.approx(wire, rel=1e-12)
    assert four["roofline"]["chips"] == 4 and four["memory"]["fits_h100_80g"]


def test_dense_decode_over_a_t_split_cache_splits_its_one_rank_cell(jax_stub_cells,
                                                                    port_stub_cells):
    """Reduced qwen3-8b's decode with ``--opt dense_decode``: the one-rank
    cell's FLOPs equal the JAX cell's (its argument bytes but the position);
    on (1, 4) the cache lies over T (2 kv heads), each rank's dense product
    runs over its 16 slots, FLOPs x 4 within 1% of the one-rank cell, and
    each layer merges its parts with three all-reduces over "model" (the
    max, the sum of the exps, the outputs) beside the cell's others."""
    want = jax_stub_cells[("qwen3-8b dense", "decode")]
    one = port_stub_cells[("qwen3-8b dense", MESH_1, "decode")]
    four = port_stub_cells[("qwen3-8b dense", MESH_1x4, "decode")]
    assert one["opts"] == ["dense_decode"] and one["ok"] and four["ok"]
    jf, f1 = want["roofline"]["flops_per_chip"], one["roofline"]["flops_per_chip"]
    assert abs(f1 - jf) <= FLOP_TOL_JAX * jf and f1 == jf
    assert (one["memory"]["argument_bytes"] + JAX_ONLY_ARG_BYTES["decode"]
            == want["memory"]["argument_bytes"])
    f4 = four["roofline"]["flops_per_chip"]
    assert abs(4 * f4 - f1) <= FLOP_TOL_MESH * f1, (4 * f4, f1)
    plain = dryrun.lower_cell(get_reduced("qwen3-8b"), InputShape("decode", *CELLS["decode"],
                                                                  "decode"),
                              MeshShape(*MESH_1x4), device="cpu")
    extra = four["collectives"]["counts"]["all-reduce"] - plain["collectives"]["counts"].get(
        "all-reduce", 0)
    assert extra == get_reduced("qwen3-8b").num_layers  # 3 a layer against the flash merge's 2
