"""The port's encdec family (whisper-tiny reduced) against the JAX package's,
on the CPU: the bidirectional encoder, the cross K/V, cross-attention over an
encoder length that is not a multiple of its 512-key blocks, the loss and
grads under each remat policy, the caches, the engine and the train driver.

Weights come from the JAX package's ``init_params`` and cross through numpy
(``params_from_numpy``); tokens and frames are numpy arrays from a seed. f32
throughout. Bounds: 2e-5 for the encoder alone (the kernels' CPU parity
bound, tests/test_torch_kernels.py), 1e-4 for the model, its loss and its
grads by each leaf's largest value (tests/test_torch_models.py,
tests/test_torch_train.py). Full-sequence logits and prefill + decode
against teacher forcing and against the JAX package run in
tests/test_torch_models.py, whose ``ARCHS`` holds whisper-tiny.
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
from repro_torch.launch import train as driver  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "whisper-tiny"
TOL = 1e-4
ENC_TOL = 2e-5
CFG = lm.ModelCfg(dtype=torch.float32)
# port impl -> the JAX config it is held against
JCFGS = {
    "cuda": jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas"),
    "xla": jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", norm_impl="xla"),
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _max_rel(got: dict, want: dict) -> dict:
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    return {k: float(np.abs(_np(g[k]) - _np(w[k])).max() / (np.abs(_np(w[k])).max() + 1e-30))
            for k in w}


@pytest.fixture(scope="module")
def model():
    jarch = jax_reduced(NAME)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jarch, get_reduced(NAME), jparams, params


def _inputs(arch, B=2, S=10, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab, size=(B, S)).astype(np.int32)
    feats = rng.standard_normal((B, arch.encoder_seq, arch.hidden)).astype(np.float32)
    return toks, feats


def _cfgs(impl):
    return JCFGS[impl], lm.ModelCfg(dtype=torch.float32, attn_impl=impl, norm_impl=impl)


def test_params_carry_the_encdec_leaves(model):
    """The cross-attention leaves, ln_cross and the encoder subtree: the same
    names, shapes and values through params_from_numpy, and the same layout
    and dtypes from the port's own init_params, in f32 and bf16."""
    jarch, arch, jparams, params = model
    jflat, tflat = _flat(jax.device_get(jparams)), _flat(params)
    assert sorted(jflat) == sorted(tflat)
    new = {"layers/cross/wq", "layers/cross/wkv", "layers/cross/wo", "layers/ln_cross",
           "encoder/final_norm", "encoder/layers/ln1", "encoder/layers/ln2",
           "encoder/layers/attn/wqkv", "encoder/layers/attn/wo", "encoder/layers/mlp/wi",
           "encoder/layers/mlp/wo"}
    assert new <= set(tflat)
    assert not any(k.startswith("encoder/layers/attn/q_norm") for k in tflat)
    assert tflat["encoder/layers/ln1"].shape[0] == arch.encoder_layers
    for name, a in jflat.items():
        np.testing.assert_array_equal(tflat[name].numpy(), np.asarray(a))
    for dtype in ("float32", "bfloat16"):
        j = _flat(jax.device_get(jlm.init_params(jarch, jax.random.PRNGKey(1),
                                                 dtype=getattr(jnp, dtype))))
        t = _flat(lm.init_params(arch, torch.Generator().manual_seed(1), getattr(torch, dtype),
                                 "cpu"))
        assert {k: (v.shape, str(v.dtype)) for k, v in j.items()} == \
            {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in t.items()}
        assert bool((t["layers/ln_cross"] == 1).all())


@pytest.mark.parametrize("impl", sorted(JCFGS))
def test_encode_matches_jax(model, impl):
    """The encoder: the port's plain kernels against the Pallas kernels in
    interpret mode, and the two "xla" paths against each other."""
    jarch, arch, jparams, params = model
    _, feats = _inputs(arch)
    jcfg, cfg = _cfgs(impl)
    want = np.asarray(jlm._encode(jparams, jarch, jcfg, jnp.asarray(feats)))
    got = lm._encode(params, arch, cfg, torch.from_numpy(feats))
    assert got.shape == want.shape == (2, arch.encoder_seq, arch.hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=ENC_TOL, rtol=0)


def test_cross_kv_matches_jax(model):
    jarch, arch, jparams, params = model
    _, feats = _inputs(arch)
    enc = np.asarray(jlm._encode(jparams, jarch, JCFGS["xla"], jnp.asarray(feats)))
    jk, jv = jlm._cross_kv(jparams, jarch, jnp.asarray(enc))
    k, v = lm._cross_kv(params, arch, torch.from_numpy(enc))
    want = (arch.num_layers, 2, arch.kv_heads, arch.encoder_seq, arch.head_dim)
    assert tuple(k.shape) == tuple(v.shape) == jk.shape == want
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ENC_TOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ENC_TOL, rtol=0)


def test_cross_attention_masks_the_padding_of_its_last_block():
    """Cross-attention over 600 encoder positions, one whole 512-key block and
    one of 88 live keys beside 424 zero ones: out and every grad against the
    JAX package's cross sub-layer. Unmasked, the zero keys would join each
    softmax with a logit of 0."""
    arch = dataclasses.replace(jax_reduced(NAME), heads=2, kv_heads=2, hidden=32, head_dim=16)
    rng = np.random.default_rng(3)
    p = {"wq": rng.standard_normal((32, 32)).astype(np.float32) / 6,
         "wo": rng.standard_normal((32, 32)).astype(np.float32) / 6}
    h = rng.standard_normal((1, 5, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 600, 16)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((1, 5, 32)).astype(np.float32)

    def jfn(p_, h_, k_, v_):
        return jlm._cross_sublayer(p_, h_, k_, v_, arch, JCFGS["xla"])

    want, vjp = jax.vjp(jfn, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(h),
                        jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tp = {n: torch.from_numpy(a).requires_grad_() for n, a in p.items()}
    ins = [torch.from_numpy(a).requires_grad_() for a in (h, k, v)]
    got = lm._cross_sublayer(tp, *ins, arch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ENC_TOL, rtol=0)
    grads = torch.autograd.grad(got, [tp["wq"], tp["wo"], *ins], torch.from_numpy(g))
    for t, w in zip(grads, [jgrads[0]["wq"], jgrads[0]["wo"], *jgrads[1:]]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_attention_calls_of_one_forward(model, monkeypatch):
    """Which attention each sub-layer takes: the encoder's bidirectional and
    the decoder's causal self-attention through cfg.attn_impl (K2 on the
    card), cross-attention through "xla" whatever attn_impl says, as the JAX
    package pins it."""
    _, arch, _, params = model
    toks, feats = _inputs(arch)
    calls = []
    real = lm.ops.flash_attention

    def spy(q, k, v, *, causal=True, sm_scale=None, impl="cuda"):
        calls.append((causal, impl, k.shape[2]))
        return real(q, k, v, causal=causal, sm_scale=sm_scale, impl=impl)

    monkeypatch.setattr(lm.ops, "flash_attention", spy)
    lm.forward_logits(params, arch, CFG, {"tokens": torch.from_numpy(toks),
                                          "enc_features": torch.from_numpy(feats)})
    T, S, n = arch.encoder_seq, toks.shape[1], arch.num_layers
    assert calls == ([(False, "cuda", T)] * arch.encoder_layers
                     + [(True, "cuda", S), (False, "xla", T)] * n)


@pytest.mark.parametrize("remat", lm.REMATS)
@pytest.mark.parametrize("impl", sorted(JCFGS))
def test_forward_train_matches_jax_under_each_remat(model, impl, remat):
    """Loss and every grad, encoder and cross leaves included, against
    jax.value_and_grad(forward_train) under the same remat policy."""
    jarch, arch, jparams, params = model
    toks, feats = _inputs(arch)
    jcfg, cfg = _cfgs(impl)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jarch, jcfg, {"tokens": jnp.asarray(toks),
                                                     "enc_features": jnp.asarray(feats)}),
        has_aux=True)(jparams)
    tree = lm._tree_map(lambda x: x.clone().requires_grad_(), params)
    leaves = _flat(tree)
    loss, metrics = lm.forward_train(tree, arch, cfg, {"tokens": torch.from_numpy(toks),
                                                       "enc_features": torch.from_numpy(feats)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert sorted(metrics) == ["ce_loss", "loss"]
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    rel = _max_rel(dict(zip(leaves, grads)), _flat(jax.device_get(jgrads)))
    assert max(rel.values()) < TOL, rel
    assert rel.keys() >= {"encoder/layers/attn/wqkv", "layers/cross/wkv"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_matches_jax(model, dtype):
    """Shapes and dtypes of every cache (bf16 weights for a bf16 model); the
    cross K/V's values in f32."""
    jarch, arch, jparams, params = model
    _, feats = _inputs(arch, B=3)
    jparams = jax.tree_util.tree_map(lambda x: x.astype(getattr(jnp, dtype)), jparams)
    params = lm.cast_params(params, getattr(torch, dtype))
    jcfg = jlm.ModelCfg(dtype=getattr(jnp, dtype), attn_impl="xla")
    cfg = lm.ModelCfg(dtype=getattr(torch, dtype))
    jc = jlm.init_caches(jarch, jcfg, 3, 20, enc_features=jnp.asarray(feats), params=jparams)
    tc = lm.init_caches(arch, cfg, 3, 20, enc_features=torch.from_numpy(feats), params=params,
                        device="cpu")
    assert {k: (v.shape, str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tc.items()}
    assert tuple(tc["enc_k"].shape) == (arch.num_layers, 3, arch.kv_heads, arch.encoder_seq,
                                        arch.head_dim)
    if dtype == "float32":
        for name in ("enc_k", "enc_v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), atol=ENC_TOL,
                                       rtol=0)


def test_init_caches_needs_enc_features_and_params(model):
    _, arch, _, params = model
    _, feats = _inputs(arch)
    with pytest.raises(ValueError, match="enc_features"):
        lm.init_caches(arch, CFG, 2, 16, params=params, device="cpu")
    with pytest.raises(ValueError, match="params"):
        lm.init_caches(arch, CFG, 2, 16, enc_features=torch.from_numpy(feats), device="cpu")
    engine = ServeEngine(arch, CFG, params, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="enc_features"):
        engine.generate(np.zeros((2, 4), np.int32), max_new_tokens=2)


def test_decode_never_writes_the_cross_kv(model):
    _, arch, _, params = model
    toks, feats = _inputs(arch)
    caches = lm.init_caches(arch, CFG, 2, 16, enc_features=torch.from_numpy(feats),
                            params=params, device="cpu")
    before = {n: caches[n].clone() for n in ("enc_k", "enc_v")}
    t = torch.from_numpy(toks).long()
    _, caches = lm.prefill(params, arch, CFG, caches, t[:, :6])
    _, caches = lm.decode_step(params, arch, CFG, caches, t[:, 6:7], 6)
    for n, x in before.items():
        assert torch.equal(caches[n], x), n


def test_engine_greedy_tokens_match_jax_engine(model):
    jarch, arch, jparams, params = model
    toks, feats = _inputs(arch, B=3, S=6, seed=4)
    want = JaxEngine(jarch, JCFGS["cuda"], jparams, max_len=20).generate(
        toks, max_new_tokens=8, enc_features=jnp.asarray(feats))
    got = ServeEngine(arch, CFG, params, max_len=20, device="cpu").generate(
        toks, max_new_tokens=8, enc_features=feats)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    # other frames, other tokens: the cache holds this call's encoder pass
    other = ServeEngine(arch, CFG, params, max_len=20, device="cpu").generate(
        toks, max_new_tokens=8, enc_features=feats[::-1].copy())
    assert not np.array_equal(other.tokens[:, 6:], got.tokens[:, 6:])


def test_driver_trains_whisper_with_frames_from_the_step(monkeypatch):
    """The driver's whisper batches carry enc_features (batch, encoder_seq,
    hidden) in the model's dtype, drawn from a generator seeded with the
    step; the loss drops."""
    seen = []
    real = driver.make_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def wrapped(params, opt, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(params, opt, batch)
        return wrapped

    monkeypatch.setattr(driver, "make_train_step", recording)
    res = driver.main(["--arch", NAME, "--reduced", "--steps", "8", "--batch", "8", "--seq",
                       "16", "--device", "cpu", "--log-every", "10", "--lr", "1e-2"])
    arch = get_reduced(NAME)
    assert res["last_loss"] < res["first_loss"]
    for step, batch in enumerate(seen):
        f = batch["enc_features"]
        assert tuple(f.shape) == (8, arch.encoder_seq, arch.hidden) and f.dtype == torch.float32
        want = torch.randn((8, arch.encoder_seq, arch.hidden),
                           generator=torch.Generator().manual_seed(step))
        assert torch.equal(f, want)
    assert not torch.equal(seen[0]["enc_features"], seen[1]["enc_features"])

