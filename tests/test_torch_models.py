"""The port's LM (every family) against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross through numpy
(``params_from_numpy``), so both sides run the same model. The JAX side runs
norms, full-sequence attention and the full-sequence SSD scan through its
Pallas kernels (interpret mode), as the configuration the port mirrors. f32
throughout; the bound is the 1e-4 of tests/test_models.py's serve-parity test
(f32 matmuls in another order over a few layers stay near 1e-6; the chunked
and the sequential SSD scan differ by ~2e-6 at this size).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_arch, get_reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = 1e-4
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas",
                    ssm_impl="pallas")
CFG = lm.ModelCfg(dtype=torch.float32)
# yi-6b: no qk_norm, MQA-like kv=1 when reduced; mamba2: attention-free ssm;
# whisper: encdec (the encoder's frames in every batch); pixtral: vlm (stub
# patch embeddings in front of the text)
ARCHS = ["qwen3-8b", "yi-6b", "mamba2-370m", "whisper-tiny", "pixtral-12b"]


def _setup(name, B=2, S=12, seed=0):
    jarch = jax_reduced(name)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(seed).integers(0, jarch.vocab, size=(B, S)).astype(np.int32)
    return jarch, get_reduced(name), jparams, params, toks


def _extra(arch, B, seed=0) -> dict:
    """The family's stub inputs as numpy f32: the encoder's frames (encdec),
    the frontend's embeddings in front of the text (vlm)."""
    rng = np.random.default_rng(seed + 100)
    if arch.family == "encdec":
        return {"enc_features": rng.standard_normal(
            (B, arch.encoder_seq, arch.hidden)).astype(np.float32)}
    if arch.family == "vlm":
        return {"frontend": rng.standard_normal(
            (B, arch.frontend_seq, arch.hidden)).astype(np.float32)}
    return {}


def _batches(arch, toks, seed=0):
    """The same batch for both packages: (jax, torch)."""
    extra = _extra(arch, toks.shape[0], seed)
    jb = {"tokens": jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(toks).long(),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_keeps_names_and_values(dtype):
    jarch = jax_reduced("qwen3-8b")
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(0), dtype=getattr(jnp, dtype))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    jflat, tflat = _flat(jax.device_get(jparams)), _flat(params)
    assert sorted(jflat) == sorted(tflat)
    for name, a in jflat.items():
        t = tflat[name]
        assert t.dtype == getattr(torch, dtype), name
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    again = params_from_numpy(jax.device_get(jparams), device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in _flat(again).values())


def test_init_params_matches_the_jax_layout():
    jarch = jax_reduced("qwen3-8b")
    jflat = _flat(jax.device_get(jlm.init_params(jarch, jax.random.PRNGKey(0))))
    tflat = _flat(lm.init_params(get_reduced("qwen3-8b"), torch.Generator().manual_seed(0),
                                 torch.float32, "cpu"))
    assert {k: v.shape for k, v in jflat.items()} == {k: tuple(v.shape) for k, v in tflat.items()}


def test_full_configs_match_the_jax_package():
    import dataclasses

    from repro.configs import PAPER_MODELS, get_arch as jax_arch
    from repro_torch.configs import PAPER_MODELS as T_PAPER

    for name in ARCHS:
        ours, theirs = get_arch(name), jax_arch(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
        assert ours.total_params() == theirs.total_params()
        assert dataclasses.asdict(get_reduced(name)) == dataclasses.asdict(jax_reduced(name))
    assert {k: v.total_params() for k, v in T_PAPER.items()} == \
        {k: v.total_params() for k, v in PAPER_MODELS.items()}
    with pytest.raises(KeyError):
        get_arch("no-such-model")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_the_jax_layout_and_dtypes_for_ssm(dtype):
    """mamba2: the ssm.* leaves, no attention and no ln2; D, conv_b, dt_bias
    and A_log stay f32 in a bf16 tree, as the JAX package keeps them."""
    jtree = jlm.init_params(jax_reduced("mamba2-370m"), jax.random.PRNGKey(0),
                            dtype=getattr(jnp, dtype))
    jflat = _flat(jax.device_get(jtree))
    tflat = _flat(lm.init_params(get_reduced("mamba2-370m"), torch.Generator().manual_seed(0),
                                 getattr(torch, dtype), "cpu"))
    assert {k: (v.shape, str(v.dtype)) for k, v in jflat.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tflat.items()}
    assert not any(k.startswith("layers/attn") or k == "layers/ln2" for k in tflat)
    for leaf, value in (("D", 1.0), ("conv_b", 0.0), ("dt_bias", 0.0), ("A_log", 0.0)):
        t = tflat[f"layers/ssm/{leaf}"]
        assert t.dtype == torch.float32 and bool((t == value).all()), leaf
    # params_from_numpy carries the mixed tree leaf for leaf
    carried = _flat(params_from_numpy(jax.device_get(jtree), device="cpu"))
    for name, a in jflat.items():
        assert str(carried[name].dtype).removeprefix("torch.") == str(a.dtype), name
        np.testing.assert_array_equal(carried[name].float().numpy(), np.asarray(a, np.float32))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_forward_logits_matches_jax(name, impl):
    jarch, arch, jparams, params, toks = _setup(name)
    jb, tb = _batches(arch, toks)
    want = np.asarray(jlm.forward_logits(jparams, jarch, JCFG, jb))
    cfg = lm.ModelCfg(dtype=torch.float32, attn_impl=impl, norm_impl=impl, ssm_impl=impl)
    got = lm.forward_logits(params, arch, cfg, tb)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)



@pytest.mark.parametrize("name", ["qwen3-32b", "command-r-35b"])
def test_copied_config_matches_jax_and_its_logits(name):
    """The dense configs copied beside qwen3-8b: the same published and
    reduced configs as the JAX package, and the reduced model's logits."""
    import dataclasses

    from repro.configs import get_arch as jax_arch

    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(jax_arch(name))
    jarch, arch, jparams, params, toks = _setup(name)
    assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
    want = np.asarray(jlm.forward_logits(jparams, jarch, JCFG, {"tokens": jnp.asarray(toks)}))
    got = lm.forward_logits(params, arch, CFG, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)

@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_teacher_forcing(name):
    """prefill + step-by-step decode == the full forward (tests/test_models.py);
    a frontend takes the first F positions, so decoding starts at F + S - 2."""
    _, arch, _, params, toks = _setup(name)
    B, S = toks.shape
    _, tb = _batches(arch, toks)
    t, fe = tb["tokens"], tb.get("frontend")
    F = 0 if fe is None else fe.shape[1]
    full = lm.forward_logits(params, arch, CFG, tb)
    caches = lm.init_caches(arch, CFG, B, F + S + 4, enc_features=tb.get("enc_features"),
                            params=params, device="cpu")
    lg, caches = lm.prefill(params, arch, CFG, caches, t[:, : S - 2], frontend=fe)
    assert float((lg - full[:, : F + S - 2]).abs().max()) < TOL
    lg1, caches = lm.decode_step(params, arch, CFG, caches, t[:, S - 2 : S - 1], F + S - 2)
    assert float((lg1[:, 0] - full[:, F + S - 2]).abs().max()) < TOL
    lg2, caches = lm.decode_step(params, arch, CFG, caches, t[:, S - 1 :], F + S - 1)
    assert float((lg2[:, 0] - full[:, F + S - 1]).abs().max()) < TOL


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_logits_match_jax(name):
    jarch, arch, jparams, params, toks = _setup(name, seed=1)
    B, S = toks.shape
    jb, tb = _batches(arch, toks, seed=1)
    F = arch.frontend_seq if "frontend" in tb else 0
    jc = jlm.init_caches(jarch, JCFG, B, F + S + 2, enc_features=jb.get("enc_features"),
                         params=jparams)
    tc = lm.init_caches(arch, CFG, B, F + S + 2, enc_features=tb.get("enc_features"),
                        params=params, device="cpu")
    t = tb["tokens"]
    jl, jc = jlm.prefill(jparams, jarch, JCFG, jc, jnp.asarray(toks[:, : S - 1]),
                         frontend=jb.get("frontend"))
    tl, tc = lm.prefill(params, arch, CFG, tc, t[:, : S - 1], frontend=tb.get("frontend"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    jl, jc = jlm.decode_step(jparams, jarch, JCFG, jc, jnp.asarray(toks[:, S - 1 :]),
                             F + S - 1)
    tl, tc = lm.decode_step(params, arch, CFG, tc, t[:, S - 1 :], F + S - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    # every cache: k/v for attention, conv and state for ssm, encdec's cross K/V
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tc[name].dtype == getattr(torch, str(jc[name].dtype)), name
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), atol=TOL, rtol=0)


def test_model_cfg_and_families_outside_the_slice_raise():
    """Bad runtime options, an unknown family, and a prefill past the cache."""
    with pytest.raises(ValueError):
        lm.ModelCfg(attn_impl="pallas")
    lm.ModelCfg(act_shard={"batch": ("data",), "model": "model"})  # the sharding slice
    import dataclasses

    with pytest.raises(ValueError):
        lm.ModelCfg(ssm_impl="naive")
    unknown = dataclasses.replace(get_reduced("qwen3-8b"), family="retnet")
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        lm.init_params(unknown, torch.Generator(), torch.float32, "cpu")
    with pytest.raises(ValueError, match="unknown family"):
        lm.init_caches(unknown, CFG, 1, 4, device="cpu")
    _, arch, _, params, toks = _setup("qwen3-8b")
    caches = lm.init_caches(arch, CFG, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="past the KV cache"):
        lm.prefill(params, arch, CFG, caches, torch.from_numpy(toks).long())
