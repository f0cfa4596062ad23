"""The serve path's KV-cache options (``decode_dense_attn``, ``kv_scatter_write``,
``kv_cache_repeat``, ``kv_cache_quant``) against the JAX package's, on the
CPU: tests/test_perf_opts.py's cases on the port, each also held against the
JAX package's logits for the same weights.

f32 model. Bounds: 1e-4 for the exact options, as tests/test_perf_opts.py;
0.02 of the largest logit for the int8 cache, as there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = 1e-4
QUANT_REL = 0.02
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
CFG = lm.ModelCfg(dtype=torch.float32, attn_impl="xla", norm_impl="xla", ssm_impl="xla")
EXACT_OPTS = [
    {"decode_dense_attn": True},
    {"kv_scatter_write": True},
    {"kv_cache_repeat": 2},
    {"decode_dense_attn": True, "kv_scatter_write": True},
    {"decode_dense_attn": True, "kv_cache_repeat": 2},
]
QUANT_OPTS = [{}, {"kv_scatter_write": True, "decode_dense_attn": True}]


def _ids(opts):
    return "+".join(sorted(opts)) or "default"


def _model(name, window=None, seed=0, B=2, S=12):
    jarch, arch = jax_reduced(name), get_reduced(name)
    if window is not None:
        jarch = dataclasses.replace(jarch, sliding_window=window)
        arch = dataclasses.replace(arch, sliding_window=window)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(seed + 2).integers(0, arch.vocab, size=(B, S)).astype(np.int32)
    return jarch, arch, jparams, params, toks


@pytest.fixture(scope="module")
def qwen():
    jarch, arch, jparams, params, toks = _model("qwen3-8b")
    full = lm.forward_logits(params, arch, CFG, {"tokens": torch.from_numpy(toks).long()})
    return jarch, arch, jparams, params, toks, full


def _roundtrip(jarch, arch, jparams, params, toks, opts):
    """tests/test_perf_opts.py's _serve_roundtrip on both sides: prefill of
    S - 1 tokens, one decode step; the port's logits and caches, then the
    JAX package's."""
    B, S = toks.shape
    cfg, jcfg = dataclasses.replace(CFG, **opts), dataclasses.replace(JCFG, **opts)
    t = torch.from_numpy(toks).long()
    caches = lm.init_caches(arch, cfg, B, S, device="cpu")
    pre, caches = lm.prefill(params, arch, cfg, caches, t[:, :S - 1])
    dec, caches = lm.decode_step(params, arch, cfg, caches, t[:, S - 1:], S - 1)
    jc = jlm.init_caches(jarch, jcfg, B, S)
    jpre, jc = jlm.prefill(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, :S - 1]))
    jdec, jc = jlm.decode_step(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, S - 1:]), S - 1)
    return (pre, dec, caches), (np.array(jpre), np.array(jdec), jc)


@pytest.mark.parametrize("opts", EXACT_OPTS, ids=_ids)
def test_serve_opts_parity(qwen, opts):
    jarch, arch, jparams, params, toks, full = qwen
    S = toks.shape[1]
    (pre, dec, caches), (jpre, jdec, jc) = _roundtrip(jarch, arch, jparams, params, toks, opts)
    assert float((pre - full[:, :S - 1]).abs().max()) < TOL
    assert float((dec[:, 0] - full[:, S - 1]).abs().max()) < TOL
    np.testing.assert_allclose(pre.numpy(), jpre, atol=TOL, rtol=0)
    np.testing.assert_allclose(dec.numpy(), jdec, atol=TOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[name].numpy(), np.asarray(jc[name]), atol=TOL, rtol=0)


@pytest.mark.parametrize("extra", QUANT_OPTS, ids=_ids)
def test_int8_kv_cache_parity_within_quant_error(qwen, extra):
    """Against the f32 teacher forcing and against the JAX package's int8
    path, within 0.02 of the largest logit; the int8 values within one step
    of the JAX package's (f32 products summed in another order can land on
    either side of a rounding midpoint) and the scales within a bf16 ulp."""
    jarch, arch, jparams, params, toks, full = qwen
    S = toks.shape[1]
    opts = dict(kv_cache_quant=True, **extra)
    (pre, dec, caches), (jpre, jdec, jc) = _roundtrip(jarch, arch, jparams, params, toks, opts)
    for got, want in ((pre, full[:, :S - 1]), (dec[:, 0], full[:, S - 1]),
                      (pre, torch.from_numpy(jpre)), (dec, torch.from_numpy(jdec))):
        assert float((got - want).abs().max()) / float(want.abs().max()) < QUANT_REL
    for name in ("k", "v"):
        assert caches[name].dtype == torch.int8
        diff = caches[name].int() - torch.from_numpy(np.asarray(jc[name]).astype(np.int32))
        assert int(diff.abs().max()) <= 1, name
        scale = caches[f"{name}_scale"]
        want = np.asarray(jc[f"{name}_scale"], np.float32)
        np.testing.assert_allclose(scale.float().numpy(), want, rtol=2.0 ** -7, atol=0)


def test_kv_quantize_matches_jax_exactly():
    """Same input, same int8 values and bf16 scales: rounding half to even on
    both sides, clipped to +-127, exact ties included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = np.linspace(-1.0, 1.0, 16) * 127 / 2  # halves: x / scale = k + 0.5
    x[0, 0, 1] = 0.0  # an all-zero row: the 1e-6 floor
    jq, js = jlm._kv_quantize(jnp.asarray(x))
    q, s = lm._kv_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js, np.float32))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = lm._kv_dequantize(q, s, dtype)
        want = jlm._kv_dequantize(jq, js, jdtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("opts", [{"kv_scatter_write": True, "decode_dense_attn": True},
                                  {"kv_scatter_write": True, "decode_dense_attn": True,
                                   "kv_cache_repeat": 2}], ids=_ids)
def test_hybrid_serve_opts_parity(opts):
    """tests/test_perf_opts.py's hybrid case: the ring cache with scatter
    writes and dense decode attention, past the window."""
    jarch, arch, jparams, params, toks = _model("hymba-1.5b", window=6, seed=1, B=1, S=14)
    t = torch.from_numpy(toks).long()
    full = lm.forward_logits(params, arch, CFG, {"tokens": t})
    cfg, jcfg = dataclasses.replace(CFG, **opts), dataclasses.replace(JCFG, **opts)
    caches = lm.init_caches(arch, cfg, 1, 14, device="cpu")
    jc = jlm.init_caches(jarch, jcfg, 1, 14)
    _, caches = lm.prefill(params, arch, cfg, caches, t[:, :10])
    _, jc = jlm.prefill(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, :10]))
    for i in range(10, 14):
        lg, caches = lm.decode_step(params, arch, cfg, caches, t[:, i:i + 1], i)
        jl, jc = jlm.decode_step(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, i:i + 1]), i)
        assert float((lg[:, 0] - full[:, i]).abs().max()) < TOL, i
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)


@pytest.mark.parametrize("prefill_len", [10, 4])
def test_hybrid_int8_ring_cache_within_quant_error(prefill_len):
    """The options of the chip's KV-option run on the ring: int8 K/V written
    by the ring prefill's roll (10 tokens) or slot by slot (4), scatter
    writes, dense decode attention; against teacher forcing and the JAX
    package within 0.02 of the largest logit."""
    opts = {"kv_cache_quant": True, "decode_dense_attn": True, "kv_scatter_write": True}
    jarch, arch, jparams, params, toks = _model("hymba-1.5b", window=6, seed=1, B=1, S=14)
    t = torch.from_numpy(toks).long()
    full = lm.forward_logits(params, arch, CFG, {"tokens": t})
    cfg, jcfg = dataclasses.replace(CFG, **opts), dataclasses.replace(JCFG, **opts)
    caches = lm.init_caches(arch, cfg, 1, 14, device="cpu")
    jc = jlm.init_caches(jarch, jcfg, 1, 14)
    _, caches = lm.prefill(params, arch, cfg, caches, t[:, :prefill_len])
    _, jc = jlm.prefill(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, :prefill_len]))
    for i in range(prefill_len, 14):
        lg, caches = lm.decode_step(params, arch, cfg, caches, t[:, i:i + 1], i)
        jl, jc = jlm.decode_step(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, i:i + 1]), i)
        for want in (full[:, i], torch.from_numpy(np.array(jl))[:, 0]):
            assert float((lg[:, 0] - want).abs().max()) / float(want.abs().max()) < QUANT_REL


@pytest.mark.parametrize("opts", [{}, {"kv_cache_repeat": 2}, {"kv_cache_quant": True},
                                  {"kv_cache_quant": True, "kv_cache_repeat": 3}], ids=_ids)
@pytest.mark.parametrize("name,max_len", [("qwen3-8b", 10), ("hymba-1.5b", 20),
                                          ("hymba-1.5b", 40), ("granite-moe-3b-a800m", 10)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_shapes_and_dtypes_match_jax(opts, name, max_len, dtype):
    """Every cache's name, shape and dtype: the ring of min(max_len, window)
    slots (hymba's reduced window is 32), Hkv * r heads, int8 K/V with bf16
    scales whatever the model's dtype."""
    cfg = dataclasses.replace(CFG, dtype=getattr(torch, dtype), **opts)
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype), **opts)
    got = lm.init_caches(get_reduced(name), cfg, 3, max_len, device="cpu")
    want = jlm.init_caches(jax_reduced(name), jcfg, 3, max_len)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(not bool(v.any()) for v in got.values())


@pytest.mark.parametrize("name", ["qwen3-8b", "hymba-1.5b"])
def test_greedy_tokens_under_the_options_match_jax_engine(name):
    """ServeEngine under all four options at once: the same greedy tokens as
    the JAX engine under the same options."""
    opts = {"decode_dense_attn": True, "kv_scatter_write": True, "kv_cache_repeat": 2,
            "kv_cache_quant": True}
    jarch, arch, jparams, params, _ = _model(name, window=6 if name == "hymba-1.5b" else None)
    prompts = np.random.default_rng(0).integers(0, arch.vocab, size=(3, 7)).astype(np.int32)
    want = JaxEngine(jarch, dataclasses.replace(JCFG, **opts), jparams,
                     max_len=20).generate(prompts, max_new_tokens=8)
    got = ServeEngine(arch, dataclasses.replace(CFG, **opts), params, max_len=20,
                      device="cpu").generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
