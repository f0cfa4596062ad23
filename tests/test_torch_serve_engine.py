"""The port's ServeEngine against the JAX package's, on the CPU (reduced
qwen3-8b, f32, weights carried across through numpy)."""
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

CFG = lm.ModelCfg(dtype=torch.float32)


@pytest.fixture(scope="module")
def setup():
    jarch = jax_reduced("qwen3-8b")
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jarch, jparams, get_reduced("qwen3-8b"), params


def _prompts(vocab: int, batch: int = 2, length: int = 5) -> np.ndarray:
    return np.random.default_rng(0).integers(0, vocab, size=(batch, length)).astype(np.int32)


def test_greedy_tokens_match_jax_engine(setup):
    jarch, jparams, arch, params = setup
    prompts = _prompts(arch.vocab, batch=3, length=7)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas")
    want = JaxEngine(jarch, jcfg, jparams, max_len=24).generate(prompts, max_new_tokens=8)
    got = ServeEngine(arch, CFG, params, max_len=24, device="cpu").generate(
        prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prompt_len == want.prompt_len == 7


def test_greedy_tokens_match_jax_engine_for_mamba2():
    """The ssm family through the same engine: conv and SSM-state caches in
    place of the KV cache. Prefill and decode run the sequential scan on the
    cache on both sides, as the JAX package does."""
    jarch = jax_reduced("mamba2-370m")
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    arch = get_reduced("mamba2-370m")
    prompts = _prompts(arch.vocab, batch=3, length=7)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, norm_impl="pallas", ssm_impl="pallas")
    want = JaxEngine(jarch, jcfg, jparams, max_len=24).generate(prompts, max_new_tokens=8)
    got = ServeEngine(arch, CFG, params, max_len=24, device="cpu").generate(
        prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    # greedy decode == argmax of teacher forcing over the generated sequence
    seq = torch.from_numpy(got.tokens).long()
    tf = lm.forward_logits(params, arch, CFG, {"tokens": seq[:, :-1]})
    np.testing.assert_array_equal(tf[:, 6:].argmax(-1).numpy(), got.tokens[:, 7:])


def test_max_len_guard(setup):
    _, _, arch, params = setup
    engine = ServeEngine(arch, CFG, params, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        engine.generate(_prompts(arch.vocab), max_new_tokens=4)
    assert engine.generate(_prompts(arch.vocab), max_new_tokens=3).tokens.shape == (2, 8)


def test_step_times_and_warmup(setup):
    _, _, arch, params = setup
    engine = ServeEngine(arch, CFG, params, max_len=16, device="cpu")
    first = engine.generate(_prompts(arch.vocab), max_new_tokens=4)
    assert isinstance(first.step_times, tuple) and len(first.step_times) == 4
    assert all(t > 0 for t in first.step_times) and first.prefill_time > 0
    assert first.warmup_steps == 1
    assert engine.generate(_prompts(arch.vocab), max_new_tokens=3).warmup_steps == 0
    # a new batch size is cold again
    assert engine.generate(_prompts(arch.vocab, batch=1), max_new_tokens=2).warmup_steps == 1


def test_seeded_sampling_is_deterministic(setup):
    _, _, arch, params = setup
    engine = ServeEngine(arch, CFG, params, max_len=16, device="cpu")
    p = _prompts(arch.vocab)
    a = engine.generate(p, max_new_tokens=6, temperature=1.0, seed=7)
    b = engine.generate(p, max_new_tokens=6, temperature=1.0, seed=7)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.tokens[:, :5], p)
    assert a.tokens.min() >= 0 and a.tokens.max() < arch.vocab


def test_no_cuda_and_no_explicit_cpu_raises(setup, monkeypatch):
    _, _, arch, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(arch, CFG, params, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(arch, torch.Generator(), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(2, np.float32)}, device=None)
