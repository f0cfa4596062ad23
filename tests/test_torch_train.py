"""The port's training path against the JAX package's, on the CPU: the loss,
remat, AdamW, the train step, the data pipeline and the driver.

Weights come from the JAX package's ``init_params`` and cross through numpy
(``params_from_numpy``); tokens and optimizer inputs are numpy arrays from a
seed. f32 throughout. Bounds: 1e-4 relative to each leaf's largest value for
the loss and the grads (the 1e-4 of tests/test_torch_models.py: f32 matmuls
summed in another order over a few layers, and the chunked against the
sequential SSD scan); 1e-6 for one AdamW update, whose arithmetic runs in the
same order on both sides.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data import MarkovCorpus as JaxCorpus  # noqa: E402
from repro.data import SyntheticPipeline as JaxPipeline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data import MarkovCorpus, SyntheticPipeline  # noqa: E402
from repro_torch.data.pipeline import MAX_VOCAB  # noqa: E402
from repro_torch.launch import train as driver  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train import (TrainStepCfg, adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule, global_norm, make_train_step)

TOL = 1e-4
# tests/test_train.py's model config, on both sides
CFG = lm.ModelCfg(dtype=torch.float32, attn_impl="xla", norm_impl="xla", ssm_impl="xla")
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
ARCHS = ["qwen3-8b", "yi-6b", "mamba2-370m"]


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
    """Per leaf: max |got - want| over max |want|."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    return {k: float(np.abs(_np(g[k]) - _np(w[k])).max() / (np.abs(_np(w[k])).max() + 1e-30))
            for k in w}


def _setup(name, B=2, S=12, seed=0):
    jarch = jax_reduced(name)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(seed).integers(0, jarch.vocab, size=(B, S)).astype(np.int32)
    return jarch, get_reduced(name), jparams, params, toks


def _port_params(name, seed=0):
    return lm.init_params(get_reduced(name), torch.Generator().manual_seed(seed),
                          torch.float32, "cpu")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _grad_leaves(params):
    """A copy of params whose leaves require grad, and those leaves by name."""
    tree = _clone(params)
    leaves = {k: v.requires_grad_() for k, v in _flat(tree).items()}
    return tree, leaves


def _torch_value_and_grad(params, arch, cfg, batch):
    tree, leaves = _grad_leaves(params)
    loss, metrics = lm.forward_train(tree, arch, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, {k: g for k, g in zip(leaves, grads)}


# ---------------------------------------------------------------------------
# tests/test_train.py, on the port
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, lr=0.1, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping():
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    big = {"w": torch.full((3,), 1e6)}
    _, _, metrics = adamw_update(params, big, opt, lr=0.0, clip_norm=1.0)
    assert metrics["grad_norm"] > 1e6  # reported norm is pre-clip


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup_steps=10, total_steps=100, min_ratio=0.1)
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1.0, rel=1e-3)
    assert lr(100) == pytest.approx(0.1, rel=1e-2)
    assert lr(5) == pytest.approx(0.5, rel=1e-6)
    jlr = jopt.cosine_schedule(1.0, warmup_steps=10, total_steps=100, min_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        assert lr(step) == float(jlr(jnp.array(step))), step


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)


def test_grad_accumulation_matches_single_batch():
    """K-microbatch accumulated grads == one-shot grads of the mean loss (not
    the post-Adam params: eps amplifies f32 summation-order noise on
    near-zero gradient entries)."""
    arch = get_reduced("yi-6b")
    params = _port_params("yi-6b")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, arch.vocab, (8, 16), generator=g)}
    _, _, g_full = _torch_value_and_grad(params, arch, CFG, batch)
    K = 4
    g_acc = {k: torch.zeros_like(v) for k, v in g_full.items()}
    for i in range(K):
        _, _, gi = _torch_value_and_grad(params, arch, CFG,
                                         {"tokens": batch["tokens"][2 * i:2 * i + 2]})
        for k in g_acc:
            g_acc[k] += gi[k] / K
    assert max(_max_rel(g_acc, g_full).values()) < 1e-4
    losses = {}
    for k in (1, 4):
        cfg = TrainStepCfg(num_microbatches=k, base_lr=1e-2, warmup_steps=0, total_steps=10)
        p = _clone(params)
        _, _, m = make_train_step(arch, CFG, cfg)(p, adamw_init(p), batch)
        losses[k] = float(m["loss"])
    assert losses[1] == pytest.approx(losses[4], rel=1e-5)


def test_loss_decreases_toward_entropy_floor():
    arch = get_reduced("qwen3-8b")
    corpus = MarkovCorpus(arch.vocab, seed=0)
    pipe = SyntheticPipeline(corpus=corpus, global_batch=16, seq_len=64)
    cfg = TrainStepCfg(num_microbatches=1, base_lr=3e-3, warmup_steps=5, total_steps=60)
    step = make_train_step(arch, CFG, cfg)
    params = _port_params("qwen3-8b")
    opt = adamw_init(params)
    losses = []
    for _ in range(60):
        batch = {k: torch.as_tensor(v).long() for k, v in pipe.next_batch().items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    floor = corpus.entropy_rate()
    assert losses[-1] < losses[0] - 1.0
    assert losses[-1] < floor + 1.5  # approaching the markov entropy rate
    assert np.isfinite(losses).all()


def test_bf16_grad_accumulation_close_to_fp32():
    arch = get_reduced("yi-6b")
    params = _port_params("yi-6b")
    batch = {"tokens": torch.randint(0, arch.vocab, (8, 16),
                                     generator=torch.Generator().manual_seed(1))}
    p32 = _clone(params)
    p32, _, _ = make_train_step(arch, CFG, TrainStepCfg(num_microbatches=4))(
        p32, adamw_init(p32), batch)
    p16 = _clone(params)
    p16, _, _ = make_train_step(
        arch, CFG, TrainStepCfg(num_microbatches=4, accum_dtype=torch.bfloat16))(
        p16, adamw_init(p16), batch)
    assert max(_max_rel(p16, p32).values()) < 0.05


# ---------------------------------------------------------------------------
# forward_train and remat against the JAX package
# ---------------------------------------------------------------------------

_IMPLS = {  # port impl -> the JAX config it is held against
    "cuda": jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas",
                         ssm_impl="pallas"),
    "xla": jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", norm_impl="xla", ssm_impl="xla"),
}


@pytest.mark.parametrize("impl", sorted(_IMPLS))
@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_matches_jax(name, impl):
    """Loss and every grad against jax.value_and_grad(forward_train): the
    port's kernels (their plain versions here) against the Pallas kernels in
    interpret mode, and the two "xla" paths against each other."""
    jarch, arch, jparams, params, toks = _setup(name)
    jcfg = _IMPLS[impl]
    cfg = lm.ModelCfg(dtype=torch.float32, attn_impl=impl, norm_impl=impl, ssm_impl=impl)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jarch, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    loss, metrics, grads = _torch_value_and_grad(params, arch, cfg,
                                                 {"tokens": torch.from_numpy(toks)})
    assert sorted(metrics) == ["ce_loss", "loss"]
    assert float(metrics["ce_loss"].detach()) == float(loss)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    rel = _max_rel(grads, jax.device_get(jgrads))
    assert max(rel.values()) < TOL, rel


def test_forward_train_loss_mask_matches_jax():
    """A mask over positions, with a row that masks every target but one;
    and an all-zero mask, where the JAX package divides by max(0, 1)."""
    jarch, arch, jparams, params, toks = _setup("qwen3-8b", B=3)
    mask = np.random.default_rng(5).integers(0, 2, size=toks.shape).astype(np.int32)
    mask[1] = 0
    mask[1, 4] = 1
    jcfg = _IMPLS["cuda"]
    for m in (mask, np.zeros_like(mask)):
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jlm.forward_train(p, jarch, jcfg, {"tokens": jnp.asarray(toks),
                                                         "loss_mask": jnp.asarray(m)}),
            has_aux=True)(jparams)
        loss, _, grads = _torch_value_and_grad(
            params, arch, lm.ModelCfg(dtype=torch.float32),
            {"tokens": torch.from_numpy(toks), "loss_mask": torch.from_numpy(m)})
        assert float(loss) == pytest.approx(float(jloss), rel=TOL, abs=1e-30)
        if m.any():
            assert max(_max_rel(grads, jax.device_get(jgrads)).values()) < TOL
        else:
            assert float(loss) == 0.0
            assert all(float(g.abs().max()) == 0.0 for g in grads.values())


class _CountMM(TorchDispatchMode):
    """Counts aten.mm calls (the weight products x @ W)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func == torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


# The weight products that "full" runs again in one layer: all but the
# layer's last (mlp.wo; out_proj for ssm), whose output only feeds the
# residual add. The recompute stops once the tensors the backward saved are
# back (torch.utils.checkpoint's early stop), before it reaches that product.
_MM_RECOMPUTED_PER_LAYER = {"qwen3-8b": 3, "mamba2-370m": 1}


@pytest.mark.parametrize("name", sorted(_MM_RECOMPUTED_PER_LAYER))
def test_remat_does_not_change_loss_or_grads(name):
    """tests/test_models.py's remat test on the port, and what each policy
    recomputes: the backward's aten.mm calls beyond those of remat "none"
    (the grads' own products) are the forward's weight products run again;
    none under "selective", which keeps them, every one the backward needs
    under "full"."""
    arch = get_reduced(name)
    params = _port_params(name)
    toks = torch.randint(0, arch.vocab, (2, 16), generator=torch.Generator().manual_seed(2))
    outs, mm = {}, {}
    for remat in ("none", "selective", "full"):
        cfg = dataclasses.replace(lm.ModelCfg(dtype=torch.float32), remat=remat)
        tree, leaves = _grad_leaves(params)
        loss, _ = lm.forward_train(tree, arch, cfg, {"tokens": toks})
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, list(leaves.values()))
        outs[remat] = (float(loss.detach()), dict(zip(leaves, grads)))
        mm[remat] = count.mm
    for remat in ("selective", "full"):
        assert outs[remat][0] == pytest.approx(outs["none"][0], rel=1e-6)
        err = {k: float((g - outs["none"][1][k]).abs().max()) for k, g in outs[remat][1].items()}
        assert max(err.values()) < 1e-5, err
    assert mm["none"] > 0
    assert mm["selective"] == mm["none"], mm
    assert mm["full"] == mm["none"] + _MM_RECOMPUTED_PER_LAYER[name] * arch.num_layers, mm


def test_model_cfg_takes_the_new_values_and_refuses_others():
    lm.ModelCfg(attn_impl="xla", norm_impl="xla", ssm_impl="xla", remat="selective")
    with pytest.raises(ValueError, match="remat"):
        lm.ModelCfg(remat="some")
    lm.ModelCfg(capacity_factor=8.0, moe_aux_weight=0.0)
    # activation shardings, taken since the sharding slice; the identity on a
    # plain tensor (tests/test_torch_sharding.py runs them on a mesh)
    cfg = lm.ModelCfg(act_shard={"batch": ("data",), "model": "model"})
    x = torch.ones(2, 3)
    assert cfg.constrain(x, ("b", "m")) is x


# ---------------------------------------------------------------------------
# AdamW and the train step against the JAX package
# ---------------------------------------------------------------------------

def _adam_inputs(seed):
    """A matrix, a stacked (L, d) norm (decayed, as any leaf of 2+ dims) and a
    1-D final norm (not decayed); mu >= 0 noise and nu > 0 as after a few
    steps."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "layers": {"ln1": (3, 5)}, "final_norm": (5,)}

    def tree(fn):
        return {k: ({kk: fn(s) for kk, s in v.items()} if isinstance(v, dict) else fn(v))
                for k, v in shapes.items()}

    def f32(a):
        return a.astype(np.float32)

    return (tree(lambda s: f32(1.0 + 0.5 * rng.standard_normal(s))),
            tree(lambda s: f32(0.05 * rng.standard_normal(s))),
            tree(lambda s: f32(0.1 * rng.standard_normal(s))),
            tree(lambda s: f32(0.01 * rng.random(s))))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("step0,grad_scale", [(0, 1.0), (2, 1.0), (2, 50.0)],
                         ids=["step1", "step3", "step3-clipped"])
def test_adamw_update_matches_jax(step0, grad_scale):
    """One update from the state after step0 steps: params, mu and nu at 1e-6
    of each leaf's largest value. The grads' global norm is ~0.35; grad_scale
    50 puts it above clip_norm, so the grads are clipped."""
    p, g, mu, nu = _adam_inputs(step0)
    g = jax.tree_util.tree_map(lambda a: a * np.float32(grad_scale), g)
    lr = jopt.cosine_schedule(1e-2, 2, 10)
    jstate = jopt.OptState(mu=mu, nu=nu, step=jnp.asarray(step0, jnp.int32))
    jp, js, jm = jopt.adamw_update(p, g, jstate, lr=lr, weight_decay=0.1, clip_norm=1.0)
    tp, tg = _torch_tree(p), _torch_tree(g)
    state = adamw_init(tp)._replace(mu=_torch_tree(mu), nu=_torch_tree(nu), step=step0)
    tp, ts, tm = adamw_update(tp, tg, state, lr=cosine_schedule(1e-2, 2, 10),
                              weight_decay=0.1, clip_norm=1.0)
    assert ts.step == int(js.step) == step0 + 1
    assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1.0)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert tm["lr"] == float(jm["lr"])
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        rel = _max_rel(got, jax.device_get(want))
        assert max(rel.values()) < 1e-6, rel
    # the grads are left as they were
    assert all(np.array_equal(_np(t), np.asarray(a)) for t, a in
               zip(_flat(tg).values(), _flat(g).values()))
    # decay by ndim: a zero grad moves a 2-D leaf (the stacked norm too) and
    # leaves the 1-D final norm where it was
    zero = jax.tree_util.tree_map(np.zeros_like, g)
    tp, _, _ = adamw_update(_torch_tree(p), _torch_tree(zero), adamw_init(_torch_tree(p)),
                            lr=1e-2, weight_decay=0.1)
    assert not np.array_equal(_np(tp["layers"]["ln1"]), p["layers"]["ln1"])
    assert not np.array_equal(_np(tp["w"]), p["w"])
    assert np.array_equal(_np(tp["final_norm"]), p["final_norm"])


@pytest.mark.parametrize("K,pre_cast", [(1, False), (4, False), (1, True), (4, True)])
def test_train_step_matches_jax(K, pre_cast):
    """One make_train_step step against the JAX step: loss, grad_norm and mu
    at 1e-4 (not the params: at step 1 the update is ~ sign(g), and eps
    amplifies f32 noise on near-zero grads)."""
    jarch, arch, jparams, params, toks = _setup("qwen3-8b", B=8, S=16)
    kw = dict(num_microbatches=K, base_lr=1e-2, warmup_steps=2, total_steps=10,
              pre_cast=pre_cast)
    _, jo, jm = jstep.make_train_step(jarch, JCFG, jstep.TrainStepCfg(**kw))(
        jparams, jopt.adamw_init(jparams), {"tokens": jnp.asarray(toks)})
    step = make_train_step(arch, CFG, TrainStepCfg(**kw))
    params2, opt, m = step(params, adamw_init(params), {"tokens": torch.from_numpy(toks)})
    assert params2 is params and opt.step == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=TOL)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert max(_max_rel(opt.mu, jax.device_get(jo.mu)).values()) < TOL


@pytest.mark.parametrize("remat,K,pre_cast", [("none", 1, False), ("selective", 2, True),
                                               ("full", 1, False)])
def test_train_step_leaves_no_tensor_to_the_garbage_collector(remat, K, pre_cast):
    """Everything a step allocates is freed when the step returns: no tensor
    lies in a reference cycle, which only the garbage collector would free,
    after the next step has allocated its own (at full width, a step's grads
    are 11 GB)."""
    import gc

    arch = get_reduced("qwen3-8b")
    params = _port_params("qwen3-8b")
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, arch.vocab, (4, 16),
                                     generator=torch.Generator().manual_seed(3))}
    step = make_train_step(arch, lm.ModelCfg(dtype=torch.float32, remat=remat),
                           TrainStepCfg(num_microbatches=K, pre_cast=pre_cast))
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step(params, opt, batch)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert not cyclic, [tuple(t.shape) for t in cyclic]


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh on a one-rank gloo group, taken down
    after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_train_step_refuses_sharding_knobs(one_rank_mesh):
    """``batch_axes`` is taken, as the JAX package's; a batch axis the mesh
    lacks, and a family that the port does not shard, are refused."""
    from repro_torch.parallel.sharding import batch_spec, distribute, make_plan, named, param_specs

    assert TrainStepCfg(batch_axes=("data",)).batch_axes == ("data",)
    plan = make_plan(one_rank_mesh)
    for name, cfg, err in (("qwen3-8b", TrainStepCfg(num_microbatches=2, batch_axes=("pod",)),
                            ValueError),
                           ("pixtral-12b", TrainStepCfg(), NotImplementedError)):
        _, arch, _, params, toks = _setup(name, B=2, S=8)
        params = distribute(params, named(plan, param_specs(arch, plan, params)))
        batch = {"tokens": torch.from_numpy(toks).long()}
        batch = distribute(batch, named(plan, batch_spec(plan, batch)))
        with pytest.raises(err):
            make_train_step(arch, CFG, cfg)(params, adamw_init(params), batch)


# ---------------------------------------------------------------------------
# the data copy and the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed", [(128, 0), (500, 3)])
def test_data_pipeline_matches_jax(vocab, seed):
    ours = SyntheticPipeline(MarkovCorpus(vocab, seed=seed), global_batch=8, seq_len=32,
                             shard_index=1, num_shards=2)
    theirs = JaxPipeline(JaxCorpus(vocab, seed=seed), global_batch=8, seq_len=32,
                         shard_index=1, num_shards=2)
    for _ in range(3):
        a, b = ours.next_batch()["tokens"], theirs.next_batch()["tokens"]
        assert a.shape == (4, 32)
        np.testing.assert_array_equal(a, b)
    assert ours.state_dict() == theirs.state_dict() == {"step": 3}
    assert ours.corpus.entropy_rate() == theirs.corpus.entropy_rate()


def test_markov_corpus_refuses_a_full_vocab():
    with pytest.raises(ValueError, match=r"151936\^2 x 8 B = 184.7 GB"):
        MarkovCorpus(151936)
    MarkovCorpus(MAX_VOCAB // 64)


def test_driver_lowers_the_loss_on_the_cpu(capsys):
    res = driver.main(["--arch", "qwen3-8b", "--reduced", "--steps", "6", "--batch", "8",
                       "--seq", "32", "--device", "cpu", "--log-every", "5"])
    assert res["steps"] == 6 and len(res["step_times"]) == 6
    assert res["last_loss"] < res["first_loss"]
    assert res["entropy_floor"] < res["first_loss"]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step     0 loss") and out[-1].startswith('{"first_loss"')


@pytest.fixture
def small_eta(tmp_path, monkeypatch):
    """A small GBT eta model cached where both packages' ``load_or_train``
    look, so the driver and the JAX search below score with one model."""
    from repro.calibration.fit import train_eta_model

    model, _ = train_eta_model(n_samples=600, n_estimators=40, seed=0)
    model.save(str(tmp_path / "eta_model.json"))
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    return model


_DRIVER = ["--arch", "qwen3-8b", "--reduced", "--steps", "4", "--batch", "16", "--seq", "32",
           "--device", "cpu", "--log-every", "5"]


def test_driver_auto_strategy_picks_what_jax_astra_picks(small_eta, capsys):
    from repro.core import Astra, FixedPool, SearchSpec, Workload

    want = Astra(small_eta).search(SearchSpec(
        arch=jax_reduced("qwen3-8b"), pool=FixedPool("H100", 1), workload=Workload(16, 32),
    )).best
    got = driver.pick_strategy(get_reduced("qwen3-8b"), 1, 16, 32)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    res = driver.main(_DRIVER + ["--auto-strategy"])
    assert res["last_loss"] < res["first_loss"]
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[astra]")]
    assert line == [
        f"[astra] strategy: tp={want.tensor_parallel} pp={want.pipeline_parallel} "
        f"dp={want.data_parallel} mbs={want.micro_batch_size} "
        f"remat={want.recompute_granularity} dist_opt={want.use_distributed_optimizer}"]
    assert (want.tensor_parallel, want.pipeline_parallel, want.data_parallel) == (1, 1, 1)


@pytest.mark.parametrize("auto", [False, True], ids=["given", "searched"])
def test_driver_emits_a_trace_the_jax_package_reads(auto, small_eta, tmp_path):
    from repro.calibration.traces import read_traces

    path = str(tmp_path / "t.jsonl")
    res = driver.main(_DRIVER + ["--emit-traces", path, "--microbatches", "2"]
                      + ["--auto-strategy"] * auto)
    (trace,) = read_traces(path)
    assert trace.source == "train" and trace.step_times == tuple(res["step_times"])
    assert len(trace.step_times) == res["steps"] == 4
    assert (trace.global_batch, trace.seq, trace.arch.name) == (16, 32, "qwen3-8b-reduced")
    s = trace.strategy
    assert (s.device, s.num_devices, s.tensor_parallel, s.pipeline_parallel) == ("H100", 1, 1, 1)
    if auto:
        assert dataclasses.asdict(s) == dataclasses.asdict(
            driver.pick_strategy(get_reduced("qwen3-8b"), 1, 16, 32))
    else:
        assert s.micro_batch_size == 8  # 16 rows in 2 microbatches


_CKPT = ["--arch", "qwen3-8b", "--reduced", "--batch", "4", "--seq", "16", "--device", "cpu",
         "--log-every", "100"]


def test_driver_checkpoint_every_defaults_to_25(tmp_path):
    """25 steps under --checkpoint-dir save once, at 25: any other period
    would save at another multiple (and keep-3 leaves the last ones)."""
    res = driver.main(_CKPT + ["--steps", "25", "--checkpoint-dir", str(tmp_path)])
    assert res["steps"] == 25
    assert CheckpointManager(str(tmp_path)).steps() == [25]


def test_driver_resume_without_a_checkpoint_starts_at_step_0(tmp_path, capsys):
    res = driver.main(_CKPT + ["--steps", "2", "--checkpoint-dir", str(tmp_path / "ck"),
                               "--resume", "--log-every", "1"])
    out = capsys.readouterr().out
    assert res["steps"] == 2 and "[ckpt] resumed" not in out
    assert out.startswith("step     0 loss")
    assert CheckpointManager(str(tmp_path / "ck")).steps() == []  # 2 steps < 25


def test_driver_keeps_the_last_3_checkpoints(tmp_path):
    driver.main(_CKPT + ["--steps", "4", "--checkpoint-every", "1",
                         "--checkpoint-dir", str(tmp_path)])
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003", "step_00000004"]


def test_driver_checkpoint_meta_holds_the_data_cursor_and_arch(tmp_path):
    driver.main(_CKPT + ["--steps", "4", "--checkpoint-every", "2",
                         "--checkpoint-dir", str(tmp_path)])
    for step in (2, 4):
        with open(tmp_path / f"step_{step:08d}" / "meta.json") as f:
            meta = json.load(f)
        assert meta["step"] == meta["data_step"] == step
        assert meta["arch"] == "qwen3-8b-reduced"
        assert "opt/step" in meta["keys"] and "params/embed" in meta["keys"]
