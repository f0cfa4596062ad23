"""The port's vlm family (pixtral-12b reduced) against the JAX package's, on
the CPU: the loss over the text behind the frontend's stub embeddings, with
and without a loss mask, the engine's frontend (its cache slots, where decode
starts) and the train driver.

Weights come from the JAX package's ``init_params`` and cross through numpy
(``params_from_numpy``); tokens and stub embeddings are numpy arrays from a
seed. f32 throughout; the bound is tests/test_torch_models.py's 1e-4 (of
each grad leaf's largest value for the grads). Full-sequence logits with a
frontend, and prefill with a frontend + decode against teacher forcing and
against the JAX package, run in tests/test_torch_models.py, whose ``ARCHS``
holds pixtral-12b.
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
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import train as driver  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "pixtral-12b"
TOL = 1e-4
CFG = lm.ModelCfg(dtype=torch.float32)
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def model():
    jarch = jax_reduced(NAME)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jarch, get_reduced(NAME), jparams, params


def _inputs(arch, B=2, S=10, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab, size=(B, S)).astype(np.int32)
    fe = rng.standard_normal((B, arch.frontend_seq, arch.hidden)).astype(np.float32)
    return toks, fe


def _port_loss_and_grads(params, arch, batch):
    tree = lm._tree_map(lambda x: x.clone().requires_grad_(), params)
    leaves = _flat(tree)
    loss, _ = lm.forward_train(tree, arch, CFG, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "loss_mask"])
def test_forward_train_skips_the_frontend_positions(model, masked):
    """Loss and every grad against jax.value_and_grad(forward_train), and
    the loss as the cross-entropy of the text positions' logits alone: the
    frontend's F positions predict nothing."""
    jarch, arch, jparams, params = model
    toks, fe = _inputs(arch)
    batch = {"tokens": toks, "frontend": fe}
    if masked:
        mask = np.random.default_rng(5).integers(0, 2, size=toks.shape).astype(np.int32)
        mask[1] = 0
        mask[1, 3] = 1
        batch["loss_mask"] = mask
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jarch, JCFG, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _port_loss_and_grads(params, arch, tb)
    assert loss == pytest.approx(float(jloss), rel=TOL)
    jflat = _flat(jax.device_get(jgrads))
    rel = {k: float((g - torch.from_numpy(np.asarray(jflat[k]))).abs().max()
                    / np.abs(np.asarray(jflat[k])).max()) for k, g in grads.items()}
    assert max(rel.values()) < TOL, rel
    # the loss by hand: the text positions' logits, each predicting the next token
    with torch.no_grad():
        logits = lm.forward_logits(params, arch, CFG, tb)
    F = arch.frontend_seq
    assert logits.shape[1] == F + toks.shape[1]
    lg = logits[:, F:-1]
    nll = torch.nn.functional.cross_entropy(lg.reshape(-1, arch.vocab),
                                            tb["tokens"][:, 1:].reshape(-1).long(),
                                            reduction="none")
    m = tb["loss_mask"][:, 1:].reshape(-1).float() if masked else torch.ones_like(nll)
    assert loss == pytest.approx(float((nll * m).sum() / m.sum()), rel=1e-5)


def test_engine_counts_the_frontend_in_max_len(model):
    """tests/test_serving_elastic.py's guard on the port's engine: frontend
    slots count against max_len, and the error names them."""
    _, arch, _, params = model
    engine = ServeEngine(arch, CFG, params, max_len=8, device="cpu")
    prompts = np.zeros((1, 5), dtype=np.int32)
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(prompts, max_new_tokens=4)
    with pytest.raises(ValueError, match="frontend_len"):
        engine.generate(prompts, max_new_tokens=1, frontend=np.zeros((1, 3, arch.hidden),
                                                                     np.float32))
    # 5 + 2 + 1 fills the cache exactly
    res = engine.generate(prompts, max_new_tokens=1, frontend=np.zeros((1, 2, arch.hidden),
                                                                       np.float32))
    assert res.tokens.shape == (1, 6)


def test_generate_decodes_past_the_frontend(model):
    """Greedy tokens with a frontend: equal to the JAX engine's, and each
    new token the argmax of the teacher-forced forward over frontend +
    tokens. Decode positions start at F + S: a decode at S would overwrite
    the frontend's cache slots and change the tokens."""
    jarch, arch, jparams, params = model
    toks, fe = _inputs(arch, B=3, S=6, seed=2)
    F, S, N = arch.frontend_seq, 6, 8
    want = JaxEngine(jarch, JCFG, jparams, max_len=F + S + N).generate(
        toks, max_new_tokens=N, frontend=jnp.asarray(fe))
    res = ServeEngine(arch, CFG, params, max_len=F + S + N, device="cpu").generate(
        toks, max_new_tokens=N, frontend=fe)
    np.testing.assert_array_equal(res.tokens, want.tokens)
    assert res.tokens.shape == (3, S + N) and res.prompt_len == S
    seq = torch.from_numpy(res.tokens).long()
    with torch.no_grad():
        tf = lm.forward_logits(params, arch, CFG, {"tokens": seq[:, :-1],
                                                   "frontend": torch.from_numpy(fe)})
    np.testing.assert_array_equal(tf[:, F + S - 1:].argmax(-1).numpy(), res.tokens[:, S:])


def test_driver_trains_pixtral_with_a_frontend_from_the_step(monkeypatch):
    """The driver's pixtral batches carry frontend (batch, frontend_seq,
    hidden) in the model's dtype, drawn from a generator seeded with the
    step; the loss over the text drops."""
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
        assert sorted(batch) == ["frontend", "tokens"]
        want = torch.randn((8, arch.frontend_seq, arch.hidden),
                           generator=torch.Generator().manual_seed(step))
        assert torch.equal(batch["frontend"], want)
