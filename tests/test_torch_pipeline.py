"""The port's GPipe pipeline (``repro_torch.parallel.pipeline``) against the
JAX package's sequential reference, on the CPU: tests/test_distributed.py's
case (L=8 layers of ``h + silu(h @ w)``, d=32, 6 microbatches of 3) over 4
gloo ranks as stages, forward within 1e-5 (absolute) and ``torch.autograd``'s
grad of sum(y ** 2) against ``jax.grad`` within 1e-5 (relative to its
largest element); the same on one stage (every rank its own pipeline, the
rotation a copy); ``stack_for_stages`` against the JAX one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro.parallel import pipeline as jpipe  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402

L, D, K, MBS = 8, 32, 6, 3
TOL = 1e-5


def _inputs():
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * 0.1)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (K, MBS, D)))
    return w, x


def _reference(w, x):
    def body(c, wl):
        return c + jax.nn.silu(c @ wl), None

    out, _ = jax.lax.scan(body, x.reshape(-1, D), w)
    return out.reshape(x.shape)


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    w, x = _inputs()
    torch_ranks.run_ranks(torch_ranks.pipeline_program, 4, tmp, str(tmp / "out.pt"), w, x)
    return torch.load(tmp / "out.pt", weights_only=False)


@pytest.mark.parametrize("stages", [4, 1])
def test_gpipe_matches_the_sequential_stack(piped, stages):
    w, x = _inputs()
    want_y = np.asarray(_reference(jnp.asarray(w), jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda w: (_reference(w, jnp.asarray(x)) ** 2).sum())(
        jnp.asarray(w)))
    got = piped[stages]
    assert got["same_on_every_rank"]
    assert np.abs(got["y"] - want_y).max() < TOL
    assert np.abs(got["grad"] - want_g).max() / np.abs(want_g).max() < TOL


def test_stack_for_stages_matches_the_jax_one():
    w, _ = _inputs()
    tree = {"w": w, "b": np.arange(L * 3.0).reshape(L, 3)}
    want = jpipe.stack_for_stages(jax.tree_util.tree_map(jnp.asarray, tree), 4)
    got = pipeline.stack_for_stages({k: torch.from_numpy(v) for k, v in tree.items()}, 4)
    for k in tree:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="do not split"):
        pipeline.stack_for_stages({"w": torch.zeros(6, 2)}, 4)
