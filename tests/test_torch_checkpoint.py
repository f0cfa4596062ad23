"""The port's CheckpointManager against the JAX package's, on the CPU:
tests/test_checkpoint_data.py's manager cases on the port, checkpoints written
by one package and restored by the other (f32 exact; bf16 as the same bits,
the two files' ``.npy`` entries byte for byte), ``opt/step`` as int32 on
disk, the async snapshot against an in-place AdamW update, and the train
driver's resume: N steps, then ``--resume`` to 2N, equal bit for bit to 2N
steps in one run.
"""
import json
import os
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint.manager import _flatten as jax_flatten  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, manager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.launch import train as driver  # noqa: E402
from repro_torch.train import OptState, adamw_init, adamw_update  # noqa: E402


def _state():
    params = {"layer": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}}
    return {"params": params, "opt": adamw_init(params)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*(_map(fn, v) for v in tree))
    return fn(tree)


def _assert_same(got, want):
    """Same keys, and each leaf of the same type, dtype and bits."""
    g, w = _flatten(got), _flatten(want)
    assert list(g) == list(w)
    for k in w:
        assert type(g[k]) is type(w[k]), k
        if isinstance(w[k], torch.Tensor):
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
        else:
            assert g[k] == w[k], k


def _entries(directory, step) -> dict:
    """The raw bytes of each ``.npy`` entry of a checkpoint's arrays.npz."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


# ---------------------------------------------------------------------------
# tests/test_checkpoint_data.py's manager cases, on the port
# ---------------------------------------------------------------------------

def test_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(10, state, metadata={"data_step": 7}, blocking=True)
    restored, meta = mgr.restore(state)
    assert meta["step"] == 10 and meta["data_step"] == 7
    _assert_same(restored, state)


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_k_garbage_collection(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(), blocking=True)
    assert mgr.steps() == [3, 4]


def test_no_tmp_dirs_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(), blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_restore_latest_and_specific(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(1, s, blocking=True)
    s2 = _map(lambda x: x + 1, s)
    mgr.save(2, s2, blocking=True)
    r2, _ = mgr.restore(s)
    _assert_same(r2, s2)
    r1, _ = mgr.restore(s, step=1)
    _assert_same(r1, s)


@pytest.mark.parametrize("whole", [True, False], ids=["every-leaf", "prefix"])
def test_elastic_restore_with_shardings(tmp_path, whole):
    """Restore placing leaves onto explicit devices: a pytree of
    torch.device matching the template, or a prefix of it. The template lies
    on the meta device, so every restored leaf's place comes from shardings."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(3, s, blocking=True)
    template = _map(lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x, s)
    cpu = torch.device("cpu")
    sh = (_map(lambda _: cpu, template) if whole
          else {"params": cpu, "opt": {"mu": cpu, "nu": "cpu"}})
    restored, _ = mgr.restore(template, shardings=sh)
    _assert_same(restored, s)
    assert restored["params"]["layer"]["w"].device == cpu


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore({})


# ---------------------------------------------------------------------------
# both ways with the JAX manager
# ---------------------------------------------------------------------------

def _pair(bf16=False, seed=0):
    """The same {"params", "opt"} state in each package: params from numpy,
    mu and nu random, the step 5."""
    rng = np.random.default_rng(seed)
    arrays = {"embed": rng.normal(size=(8, 4)), "layers": {
        "wqkv": rng.normal(size=(2, 4, 12)), "ln1": rng.normal(size=(2, 4))}}
    p = _map(lambda a: a.astype(np.float32), arrays)
    m = _map(lambda a: rng.normal(size=a.shape).astype(np.float32), p)
    v = _map(lambda a: rng.random(size=a.shape).astype(np.float32), p)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jstate = {"params": _map(lambda a: jnp.asarray(a).astype(jdt), p),
              "opt": jopt.OptState(mu=_map(jnp.asarray, m), nu=_map(jnp.asarray, v),
                                   step=jnp.asarray(5, jnp.int32))}
    tstate = {"params": _map(lambda a: torch.from_numpy(a).to(tdt), p),
              "opt": OptState(mu=_map(torch.from_numpy, m), nu=_map(torch.from_numpy, v),
                              step=5)}
    return jstate, tstate


def test_flatten_keys_match_the_jax_manager():
    jstate, tstate = _pair()
    assert list(_flatten(tstate)) == list(jax_flatten(jstate))
    assert "opt/step" in _flatten(tstate) and "opt/mu/layers/wqkv" in _flatten(tstate)


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _pair()
    JaxManager(str(tmp_path)).save(5, jstate, metadata={"data_step": 5}, blocking=True)
    template = _map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
                    tstate)
    restored, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta["data_step"] == 5 and meta["step"] == 5
    _assert_same(restored, tstate)


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    jstate, tstate = _pair()
    CheckpointManager(str(tmp_path)).save(5, tstate, metadata={"data_step": 5}, blocking=True)
    template = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    restored, meta = JaxManager(str(tmp_path)).restore(template)
    assert meta["data_step"] == 5 and meta["step"] == 5
    got, want = jax_flatten(restored), jax_flatten(jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_opt_step_is_int32_0dim_on_disk(tmp_path):
    _, tstate = _pair()
    CheckpointManager(str(tmp_path)).save(5, tstate, blocking=True)
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as z:
        step = z["opt/step"]
    assert step.dtype == np.int32 and step.shape == () and int(step) == 5
    restored, _ = CheckpointManager(str(tmp_path)).restore(tstate)
    assert type(restored["opt"].step) is int and restored["opt"].step == 5


def test_bf16_leaves_both_ways(tmp_path):
    """The JAX package writes a bf16 leaf as its raw 2-byte values under the
    descr '<V2'. The port writes the same entries, byte for byte, and reads
    the JAX file's values back as the same bf16 bits. (The JAX manager
    restores them as the |V2 data np.load returns, which jnp.asarray refuses.
    No JAX path saves bf16, so the JAX package stays as it is.)"""
    jstate, tstate = _pair(bf16=True)
    JaxManager(str(tmp_path / "jax")).save(5, jstate, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(5, tstate, blocking=True)
    jfile, tfile = _entries(tmp_path / "jax", 5), _entries(tmp_path / "port", 5)
    assert list(tfile) == list(jfile)
    assert b"'descr': '<V2'" in jfile["params/embed.npy"]
    for name in jfile:
        assert tfile[name] == jfile[name], name
    template = _map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
                    tstate)
    restored, _ = CheckpointManager(str(tmp_path / "jax")).restore(template)
    _assert_same(restored, tstate)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    jrestored, _ = JaxManager(str(tmp_path / "jax")).restore(jstate)
    assert jrestored["params"]["embed"].dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jnp.asarray(jrestored["params"]["embed"])


@pytest.mark.parametrize("raw", [np.uint16, np.int16])
def test_bf16_template_reads_16_bit_integer_data_by_its_bits(tmp_path, raw):
    """A file that holds bf16 values as 16-bit integers restores into a bf16
    template leaf bit for bit, as the JAX file's '<V2' data does."""
    want = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    step = np.asarray(1, np.int32)
    os.makedirs(tmp_path / "step_00000001")
    bits = want.view(torch.int16).numpy().view(raw)
    np.savez(tmp_path / "step_00000001" / "arrays.npz", w=bits, step=step)
    with open(tmp_path / "step_00000001" / "meta.json", "w") as f:
        json.dump({"step": 1}, f)
    got, _ = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros(5, 3, dtype=torch.bfloat16), "step": 0})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    assert got["step"] == 1


# ---------------------------------------------------------------------------
# the async snapshot, and the driver's resume
# ---------------------------------------------------------------------------

def test_async_save_snapshots_before_an_in_place_update(tmp_path, monkeypatch):
    """adamw_update overwrites params, mu and nu in place. An async save
    followed at once by an update must write the values before it. The write
    is held until the update is done, so a snapshot that shares memory with
    the state would write the updated values."""
    updated = threading.Event()
    real = manager._write_npz

    def held(*args):
        assert updated.wait(timeout=60)
        real(*args)

    monkeypatch.setattr(manager, "_write_npz", held)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(512, 512, generator=g), "b": torch.randn(512, generator=g)}
    opt = adamw_init(params)
    grads = _map(lambda x: torch.randn(x.shape, generator=g), params)
    params, opt, _ = adamw_update(params, grads, opt, lr=1e-2)
    state = {"params": params, "opt": opt}
    before = _map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    params, opt, _ = adamw_update(params, grads, opt, lr=1e-2)
    updated.set()
    mgr.wait()
    assert not torch.equal(params["w"], before["params"]["w"])  # updated in place
    restored, _ = mgr.restore(before)
    _assert_same(restored, before)


# N + N steps against 2N. 2N stays inside the driver's 10 warmup steps, where
# the learning rate of a step does not depend on --steps (past them the
# cosine's length does, in either package's driver).
N = 3
_ARGS = ["--arch", "qwen3-8b", "--reduced", "--batch", "8", "--seq", "32", "--device", "cpu",
         "--checkpoint-every", str(N)]


@pytest.fixture
def one_thread():
    """One intra-op thread for the test. On several, the embedding's backward
    (an accumulating index_put_) adds rows from several threads in any order,
    so two uninterrupted runs already differ in the last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_wait_raises_what_the_background_write_raised(tmp_path):
    (tmp_path / "step_00000001.tmp").write_text("")  # a file where the write's dir goes
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.steps() == []


def test_driver_resume_equals_an_uninterrupted_run(tmp_path, one_thread):
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    whole = driver.main(_ARGS + ["--steps", str(2 * N), "--checkpoint-dir", one])
    first = driver.main(_ARGS + ["--steps", str(N), "--checkpoint-dir", two])
    assert CheckpointManager(two).steps() == [N] and first["steps"] == N
    rest = driver.main(_ARGS + ["--steps", str(2 * N), "--checkpoint-dir", two, "--resume"])
    assert rest["steps"] == N
    assert rest["last_loss"] == whole["last_loss"]
    assert CheckpointManager(one).steps() == CheckpointManager(two).steps() == [N, 2 * N]
    a, b = _entries(one, 2 * N), _entries(two, 2 * N)
    assert list(a) == list(b) and "opt/step.npy" in a
    for name in a:
        assert a[name] == b[name], name
    for d in (one, two):
        with open(os.path.join(d, f"step_{2 * N:08d}", "meta.json")) as f:
            meta = json.load(f)
        assert (meta["step"], meta["data_step"]) == (2 * N, 2 * N)
