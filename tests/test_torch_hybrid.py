"""The port's hybrid family (hymba-1.5b, reduced: attention and Mamba-2 heads
side by side, a sliding window, a ring KV cache) and its attention pieces
(``flash_xla`` with ``ring=True``, ``banded_flash_xla``) against the JAX
package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross through numpy;
inputs are numpy arrays from a seed. f32 throughout. Bounds: 2e-5 for the
attention functions, as tests/test_kernels.py; 1e-4 for whole models, as
tests/test_models.py's serve parity.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.kernels.xla_flash import banded_flash_xla as jax_banded  # noqa: E402
from repro.kernels.xla_flash import flash_xla as jax_flash_xla  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_arch, get_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.xla_flash import banded_flash_xla, flash_xla  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ATTN_TOL = 2e-5
TOL = 1e-4
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas",
                    ssm_impl="pallas")
CFG = lm.ModelCfg(dtype=torch.float32)
NAME = "hymba-1.5b"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _setup(window=None, B=2, S=12, seed=0):
    """hymba reduced (its window 32, or ``window``) on both sides."""
    jarch, arch = jax_reduced(NAME), get_reduced(NAME)
    if window is not None:
        jarch = dataclasses.replace(jarch, sliding_window=window)
        arch = dataclasses.replace(arch, sliding_window=window)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(seed).integers(0, jarch.vocab, size=(B, S)).astype(np.int32)
    return jarch, arch, jparams, params, toks


def _qkv(B, Hq, Hkv, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,q_start,block", [
    (1, 8, 5, 512),    # before the wrap: causal, slots past q_start + 1 hidden
    (1, 8, 7, 512),    # the last position before the wrap
    (1, 8, 8, 512),    # the first after it: every slot live
    (1, 8, 21, 512),   # long after
    (3, 8, 2, 512),    # a chunk before the wrap
    (1, 32, 40, 16),   # wrapped, over two KV blocks
    (2, 24, 10, 16),   # not wrapped, over two KV blocks (one partial)
])
def test_flash_xla_ring_matches_jax(S, T, q_start, block):
    q, k, v = _qkv(2, 6, 3, S, T, 16, seed=T + q_start)
    want = jax_flash_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_start=q_start,
                         kv_valid_len=q_start + S, ring=True, block=block)
    got = flash_xla(*(torch.from_numpy(a) for a in (q, k, v)), q_start=q_start,
                    kv_valid_len=q_start + S, ring=True, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


def test_flash_xla_ring_wrapped_over_a_partial_block():
    """A fault of the JAX reference, which the port does not copy: once the
    ring has wrapped, the JAX flash_xla counts every slot of its zero-padded
    last KV block as live, so when T is not a multiple of the block the
    padding's zero keys join the softmax. The port attends over the T slots
    only. (Not reached by the JAX models: a ring holds a whole window, 1024
    for hymba-1.5b, and the block is 512.)"""
    q, k, v = _qkv(1, 6, 3, 1, 24, 16, seed=3)
    want = jax_flash_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_start=30,
                         kv_valid_len=31, ring=True, block=16)
    got = flash_xla(*(torch.from_numpy(a) for a in (q, k, v)), q_start=30, kv_valid_len=31,
                    ring=True, block=16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    torch.testing.assert_close(got, ref.attention(tq, tk, tv, causal=False), rtol=0,
                               atol=ATTN_TOL)
    pad = torch.nn.functional.pad  # the JAX side: 8 zero keys and values beside the 24
    np.testing.assert_allclose(
        np.asarray(want), ref.attention(tq, pad(tk, (0, 0, 0, 8)), pad(tv, (0, 0, 0, 8)),
                                        causal=False).numpy(), atol=ATTN_TOL, rtol=0)


def _banded_oracle(q, k, v, window):
    """Dense masked softmax over (S, S) with the band i - window < j <= i."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k) / D ** 0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill(~((j <= i) & (j > i - window)), float("-inf"))
    return torch.einsum("bhgst,bhtd->bhgsd", torch.softmax(s, -1), v).reshape(B, Hq, S, D)


@pytest.mark.parametrize("B,Hq,Hkv,S,window,block_q", [
    (1, 4, 2, 32, 8, 8),     # whole blocks
    (2, 6, 3, 37, 5, 16),    # S not a multiple of block_q; groups of 2
    (1, 5, 1, 20, 6, 512),   # one block (block_q > S); groups of 5
    (1, 4, 4, 19, 30, 8),    # window > S: plain causal
])
def test_banded_flash_xla_and_its_grads_match_jax(B, Hq, Hkv, S, window, block_q):
    q, k, v = _qkv(B, Hq, Hkv, S, S, 16, seed=S + window)
    g = np.random.default_rng(S).standard_normal(q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jax_banded(a, b, c, window=window, block_q=block_q),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = banded_flash_xla(*inputs, window=window, block_q=block_q)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)
    oracle = _banded_oracle(*(t.detach() for t in inputs), window)
    np.testing.assert_allclose(got.detach().numpy(), oracle.numpy(), atol=ATTN_TOL, rtol=0)
    grads = torch.autograd.grad(got, inputs, torch.from_numpy(g))
    for t, w in zip(grads, want_grads):
        assert t.shape == w.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=ATTN_TOL, rtol=0)
    if window >= S:  # the band holds every causal pair
        torch.testing.assert_close(got.detach(), ref.attention(*(t.detach() for t in inputs)),
                                   rtol=0, atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_copied_config_and_init_match_the_jax_package():
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(jax_arch(NAME))
    assert dataclasses.asdict(get_reduced(NAME)) == dataclasses.asdict(jax_reduced(NAME))
    assert get_arch(NAME).total_params() == jax_arch(NAME).total_params()
    jflat = _flat(jax.device_get(jlm.init_params(jax_reduced(NAME), jax.random.PRNGKey(0),
                                                 dtype=jnp.bfloat16)))
    tflat = _flat(lm.init_params(get_reduced(NAME), torch.Generator().manual_seed(0),
                                 torch.bfloat16, "cpu"))
    assert {k: (v.shape, str(v.dtype)) for k, v in jflat.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tflat.items()}
    # attn.*, ssm.* and mlp.* side by side, and both norms
    for part in ("attn/wqkv", "ssm/in_proj", "ssm/A_log", "mlp/wi", "ln1", "ln2"):
        assert f"layers/{part}" in tflat, part


@pytest.mark.parametrize("window,S", [(None, 12), (6, 14)], ids=["window32", "banded"])
@pytest.mark.parametrize("impl", ["cuda", "torch", "xla"])
def test_forward_logits_matches_jax(impl, window, S):
    """At the reduced window 32 the forward takes the flash path; at window
    6 and S 14, banded_flash_xla."""
    jarch, arch, jparams, params, toks = _setup(window, S=S)
    jcfg = JCFG if impl != "xla" else jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla",
                                                   ssm_impl="xla")
    want = np.asarray(jlm.forward_logits(jparams, jarch, jcfg, {"tokens": jnp.asarray(toks)}))
    cfg = lm.ModelCfg(dtype=torch.float32, attn_impl=impl, norm_impl=impl, ssm_impl=impl)
    got = lm.forward_logits(params, arch, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("window,S", [(None, 12), (6, 14)], ids=["window32", "banded"])
def test_forward_train_loss_and_grads_match_jax(window, S):
    jarch, arch, jparams, params, toks = _setup(window, S=S, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jarch, JCFG, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    leaves = {k: v.requires_grad_() for k, v in _flat(params).items()}
    loss, m = lm.forward_train(params, arch, CFG, {"tokens": torch.from_numpy(toks).long()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert sorted(m) == sorted(jm) == ["ce_loss", "loss"]
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    for k, g in _flat(jax.device_get(jgrads)).items():
        scale = float(np.abs(g).max()) + 1e-30
        assert float(np.abs(grads[k].numpy() - g).max()) / scale < TOL, k


def test_prefill_decode_match_teacher_forcing_and_jax():
    """tests/test_models.py's serve parity for the hybrid, and every cache
    (k, v, conv, state) against the JAX package's after each step."""
    jarch, arch, jparams, params, toks = _setup()
    B, S = toks.shape
    t = torch.from_numpy(toks).long()
    full = lm.forward_logits(params, arch, CFG, {"tokens": t})
    caches = lm.init_caches(arch, CFG, B, S + 4, device="cpu")
    jc = jlm.init_caches(jarch, JCFG, B, S + 4)
    lg, caches = lm.prefill(params, arch, CFG, caches, t[:, :S - 2])
    jl, jc = jlm.prefill(jparams, jarch, JCFG, jc, jnp.asarray(toks[:, :S - 2]))
    assert float((lg - full[:, :S - 2]).abs().max()) < TOL
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for pos in (S - 2, S - 1):
        lg, caches = lm.decode_step(params, arch, CFG, caches, t[:, pos:pos + 1], pos)
        jl, jc = jlm.decode_step(jparams, jarch, JCFG, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                 pos)
        assert float((lg[:, 0] - full[:, pos]).abs().max()) < TOL
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert sorted(caches) == sorted(jc) == ["conv", "k", "state", "v"]
    for name in jc:
        np.testing.assert_allclose(caches[name].numpy(), np.asarray(jc[name]), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("prefill_len", [10, 6, 4])
def test_hybrid_ring_cache_wraps_correctly(prefill_len):
    """tests/test_models.py's ring test: window 6, decode past it. A prefill
    of 10 or 6 tokens fills the ring through banded_flash_xla and the roll; a
    prefill of 4 writes slots 0-3, and the decode wraps at position 6. Each
    step against the full forward and against the JAX package's step."""
    jarch, arch, jparams, params, toks = _setup(6, B=1, S=14, seed=1)
    t = torch.from_numpy(toks).long()
    full = lm.forward_logits(params, arch, CFG, {"tokens": t})
    caches = lm.init_caches(arch, CFG, 1, 14, device="cpu")
    assert caches["k"].shape[3] == 6
    jc = jlm.init_caches(jarch, JCFG, 1, 14)
    lg, caches = lm.prefill(params, arch, CFG, caches, t[:, :prefill_len])
    jl, jc = jlm.prefill(jparams, jarch, JCFG, jc, jnp.asarray(toks[:, :prefill_len]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert float((lg - full[:, :prefill_len]).abs().max()) < TOL
    for i in range(prefill_len, 14):
        lg, caches = lm.decode_step(params, arch, CFG, caches, t[:, i:i + 1], i)
        jl, jc = jlm.decode_step(jparams, jarch, JCFG, jc, jnp.asarray(toks[:, i:i + 1]), i)
        assert float((lg[:, 0] - full[:, i]).abs().max()) < TOL, i
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        np.testing.assert_allclose(caches["k"].numpy(), np.asarray(jc["k"]), atol=TOL, rtol=0)


def test_ring_chunks_that_would_cross_the_end_are_refused():
    """The JAX package clamps a slice write that runs past the ring (or drops
    the rows of such a scatter), which changes the answer; the port refuses
    the chunk, and a ring prefill that does not start at 0."""
    _, arch, _, params, toks = _setup(6, B=1, S=14)
    t = torch.from_numpy(toks).long()
    for cfg in (CFG, dataclasses.replace(CFG, kv_scatter_write=True)):
        caches = lm.init_caches(arch, cfg, 1, 14, device="cpu")
        lm.prefill(params, arch, cfg, caches, t[:, :4])
        with pytest.raises(ValueError, match="cross the end"):
            lm.forward_cached(params, arch, cfg, caches, t[:, 4:7], 4)  # slots 4, 5, 0
        with pytest.raises(ValueError, match="starts at position 0"):
            lm.forward_cached(params, arch, cfg, caches, t[:, 4:10], 4)
    # a ring shorter than the window (max_len < window) serves no position past it
    caches = lm.init_caches(arch, CFG, 1, 5, device="cpu")
    lm.prefill(params, arch, CFG, caches, t[:, :5])
    with pytest.raises(ValueError, match="past the KV cache"):
        lm.decode_step(params, arch, CFG, caches, t[:, 5:6], 5)


def test_greedy_tokens_match_jax_engine():
    """The reduced window (32) is longer than the run: the ring never wraps.
    And at window 6, where every decode step wraps it."""
    for window in (None, 6):
        jarch, arch, jparams, params, _ = _setup(window, seed=2)
        prompts = np.random.default_rng(0).integers(0, arch.vocab, size=(3, 7)).astype(np.int32)
        want = JaxEngine(jarch, JCFG, jparams, max_len=20).generate(prompts, max_new_tokens=8)
        got = ServeEngine(arch, CFG, params, max_len=20, device="cpu").generate(
            prompts, max_new_tokens=8)
        np.testing.assert_array_equal(got.tokens, want.tokens)
