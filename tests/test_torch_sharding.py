"""The port's sharding (``repro_torch.parallel.sharding``, ``launch.mesh``,
``ModelCfg.act_shard``, ``TrainStepCfg.batch_axes``, sharded checkpoints)
against the JAX package's, on the CPU.

(a) The rules without processes: ``param_specs``, ``batch_spec`` and
    ``cache_specs`` equal the JAX package's leaf for leaf, for every config
    (reduced and full, shapes only), on meshes (1,1), (2,1), (1,2), (4,2) and
    (2,2,2), with and without FSDP; the JAX plan on an ``AbstractMesh``.
(b) 4 gloo ranks, a (2, 2) data x model mesh with FSDP, reduced yi-6b
    (kv_heads 1 < tp) and qwen3-8b (q/k norms), f32, impl "cuda" (the plain
    versions on the CPU, each rank on its shard): one ``make_train_step``
    step against the JAX single-device step on the same params and batch,
    loss within 1e-4 and params within 1e-3 (tests/test_distributed.py's
    bounds), and against the port's unsharded step within 1e-5 (loss, params
    and the global grad norm, relative); then K = 2 microbatches with
    ``batch_axes``. The same for reduced mamba2-370m (in_proj's 548 columns
    cut at 274, inside x; the conv's 288 channels at 144, inside x) and
    hymba-1.5b (S = 64 past its window of 32: the banded attention; 532
    in_proj columns cut at 266), with every grad leaf within 1e-5 of the
    unsharded port's and the weight grads of in_proj, conv_w and out_proj
    handed back split over "model" as their params are. Their leaves that
    start at zero (conv_b, dt_bias, A_log) are, after one step, the AdamW
    update alone, lr g / (|g| + eps), whose relative error is eps / |g|
    times the grad's: at hymba's conv_b channel with |g| = 3e-7 (the leaf's
    largest is 3.4e-2) the unsharded f32 step itself lies 5e-5 from the f64
    step. Those leaves are held at 1e-5 through their grads, and through
    their params at the JAX bound. A mamba2 state saved from the (2, 2) mesh
    restores onto it leaf for leaf. A tensor dim over ("pod", "data") lands
    on each rank as JAX puts it on the device of that index.
(f) The moe family (reduced granite-moe-3b-a800m, 8 experts top-2, and
    llama4-scout-17b-a16e, 4 experts top-1 with a shared expert) on the same
    (2, 2) mesh at capacity factor 1.25, where the step drops assignments:
    the experts over "data" (8 and 4 over 2), and whole over it (granite
    with 5 experts, which 2 does not divide, and granite without FSDP). Each
    held against the JAX single-device step (loss 1e-4, params 1e-3) and the
    unsharded port (1e-5, every grad leaf too), K = 2 with ``batch_axes``,
    and the assignments the sharded forward drops equal in number to the
    unsharded forward's (the capacity and the drops are the global
    program's). On a (4, 1) mesh, at a capacity that no rank's own
    assignments to an expert exceed but the global count does, the kept
    (token, expert) pairs equal the unsharded ``global_route``'s exactly. A
    granite state saved from the (2, 2) mesh (experts over "data" and
    "model") restores onto it leaf for leaf. Granite's block on 3 rows over
    "data" of 2 (blocks of 2 and 1 rows) is the unsharded block, output and
    grads; make_train_step refuses microbatches the batch axes do not divide.
(c) An elastic restart: two steps on (4, 1), a save, a restore onto (2, 2)
    with placements, two more: the loss within 1e-4 of four steps in one
    run; rank 0 alone copies the state to the host; the checkpoint restores
    in ``repro.checkpoint.CheckpointManager``.
(d) ``act_shard`` on a (1, 2) mesh leaves the forward as it was; DTensor's
    ``loss_parallel`` on logits sharded over the vocab gives the loss that
    the port computes with the logits made whole (the JAX formula).
(e) The local q/k views that the sharded qwen3 step hands K1 go through K1's
    ``_plan`` as strided views.

The ranks run the programs of tests/torch_ranks.py; the JAX references run
in this process.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import torch_ranks  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import PAPER_MODELS, get_arch, get_reduced  # noqa: E402
from repro_torch.configs import _MODULES  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import TrainStepCfg, adamw_init, make_train_step  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
CFG = lm.ModelCfg(dtype=torch.float32)
LOSS_TOL, PARAM_TOL = 1e-4, 1e-3  # tests/test_distributed.py
PORT_TOL = 1e-5

# --- (a) the rules ----------------------------------------------------------

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CONFIGS = ([(n, True) for n in sorted(_MODULES)] + [(n, False) for n in sorted(_MODULES)]
           + [(n, False) for n in sorted(PAPER_MODELS)])


def _norm(spec, ndim) -> tuple:
    """A spec as a tuple of ndim entries, each None or a tuple of axis names
    (JAX writes ("data",) as "data")."""
    parts = [None if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    return tuple(parts + [None] * (ndim - len(parts)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _shapes(name: str, reduced: bool):
    """The JAX params' and caches' shapes and the port's, for one config."""
    jarch = jax_reduced(name) if reduced else jax_arch(name)
    arch = get_reduced(name) if reduced else get_arch(name)
    jparams = jax.eval_shape(lambda: jlm.init_params(jarch, jax.random.PRNGKey(0)))
    params = lm.init_params(arch, torch.Generator(), torch.float32, device="meta")
    jcfg = dataclasses.replace(JCFG, kv_cache_quant=True)
    cfg = lm.ModelCfg(attn_impl="torch", norm_impl="torch", ssm_impl="torch",
                      kv_cache_quant=True)
    B, T = 8, 64
    if arch.family == "encdec":
        feats = jax.ShapeDtypeStruct((B, arch.encoder_seq, arch.hidden), jnp.float32)
        jcaches = jax.eval_shape(
            lambda p, f: jlm.init_caches(jarch, jcfg, B, T, enc_features=f, params=p),
            jparams, feats)
        caches = lm.init_caches(arch, cfg, B, T, params=params, device="meta",
                                enc_features=torch.empty(feats.shape, device="meta"))
    else:
        jcaches = jax.eval_shape(lambda: jlm.init_caches(jarch, jcfg, B, T))
        caches = lm.init_caches(arch, cfg, B, T, device="meta")
    return jarch, arch, jparams, params, jcaches, caches


def _same_specs(got: dict, want: dict, shapes: dict):
    g, w, s = _flat(got), _flat(want), _flat(shapes)
    assert sorted(g) == sorted(w)
    bad = {k: (g[k], w[k]) for k in w
           if _norm(g[k], len(s[k].shape)) != _norm(w[k], len(s[k].shape))}
    assert not bad, bad


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name,reduced", CONFIGS,
                         ids=[f"{n}-{'reduced' if r else 'full'}" for n, r in CONFIGS])
def test_specs_equal_the_jax_rules(name, reduced, mesh, fsdp):
    jarch, arch, jparams, params, jcaches, caches = _shapes(name, reduced)
    shape, axes = MESHES[mesh]
    jplan = jsh.make_plan(AbstractMesh(shape, axes), fsdp=fsdp)
    plan = sharding.make_plan(sharding.MeshShape(shape, axes), fsdp=fsdp)
    assert (plan.batch_axes, plan.model_axis, plan.fsdp) == (
        jplan.batch_axes, jplan.model_axis, jplan.fsdp)
    _same_specs(sharding.param_specs(arch, plan, params),
                jsh.param_specs(jarch, jplan, jparams), params)
    _same_specs(sharding.cache_specs(arch, plan, caches),
                jsh.cache_specs(jarch, jplan, jcaches), caches)
    for B in (8, 6):  # 6: not divided by the batch axes of 4x2 and 2x2x2
        batch = {"tokens": np.zeros((B, 16), np.int32),
                 "frontend": np.zeros((B, 4, arch.hidden), np.float32)}
        _same_specs(sharding.batch_spec(plan, batch), jsh.batch_spec(jplan, batch), batch)


def test_placements_follow_the_spec():
    mesh = sharding.MeshShape((2, 2, 2), ("pod", "data", "model"))

    class Mesh:  # placements() reads the dim names only
        mesh_dim_names = mesh.axis_names

    P = sharding.P
    assert sharding.placements(Mesh, P(("pod", "data"), None, "model")) == (
        sharding.Shard(0), sharding.Shard(0), sharding.Shard(2))
    assert sharding.placements(Mesh, P(None, None)) == (sharding.Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements(Mesh, P(("data", "pod")))


def test_act_shard_and_batch_axes_are_accepted():
    cfg = lm.ModelCfg(act_shard={"batch": ("data",), "model": "model"})
    x = torch.ones(2, 3, 4)
    assert cfg.constrain(x, ("b", None, "m")) is x  # a plain tensor lies on no mesh
    assert TrainStepCfg(batch_axes=("data",)).batch_axes == ("data",)
    assert sharding.constrain_batch_sharding(x) is x


# --- (b) and (e): the sharded train step on 4 ranks ---------------------------

ARCHS = ("yi-6b", "qwen3-8b")
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
# label -> (arch, fields of its reduced config replaced, FSDP)
MOE_CASES = {
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}, True),  # 8 experts over data 2
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}, True),  # 4 over data 2, shared
    "granite-5-experts": ("granite-moe-3b-a800m", {"num_experts": 5}, True),  # whole over data
    "granite-no-fsdp": ("granite-moe-3b-a800m", {}, False),  # whole over data
}
MOE = tuple(MOE_CASES)
WHOLE_OVER_DATA = ("granite-5-experts", "granite-no-fsdp")
# token ids drawn below this: llama4's router spreads uniform ids over its 4
# experts too evenly to drop at 1.25; the first 64 of its 128 ids drop 31 and 7
# assignments in its two layers
TOKEN_IDS = {"llama4-scout-17b-a16e": 64}
SEQ = {"hymba-1.5b": 64}  # past the reduced window of 32
# zero at init: one step leaves them the AdamW update alone (docstring (b))
ZERO_INIT = ("layers/ssm/conv_b", "layers/ssm/dt_bias", "layers/ssm/A_log")
ORDER_CASES = [((2, 2, 1), ("pod", "data", "model"), sharding.P(("pod", "data"), None)),
               ((2, 1, 2), ("pod", "data", "model"), sharding.P("pod", "model")),
               ((1, 2, 2), ("pod", "data", "model"), sharding.P(None, ("data", "model")))]


def _arch_of(label):
    """The JAX and the port's reduced config of a case label."""
    name, over, _ = MOE_CASES.get(label, (label, {}, True))
    return (dataclasses.replace(jax_reduced(name), **over),
            dataclasses.replace(get_reduced(name), **over))


def _case(name, seed=0, B=8, S=None):
    S = S or SEQ.get(name, 32)
    jarch = _arch_of(name)[0]
    jparams = jax.device_get(jlm.init_params(jarch, jax.random.PRNGKey(seed)))
    tokens = np.random.default_rng(seed + 1).integers(0, TOKEN_IDS.get(name, jarch.vocab),
                                                      (B, S)).astype(np.int32)
    return jarch, jparams, tokens


def _rank_case(label):
    name, over, fsdp = MOE_CASES.get(label, (label, {}, True))
    opts = {"label": label, "arch": over, "fsdp": fsdp} if label != name or not fsdp else {}
    return (name, *_case(label)[1:]) + ((opts,) if opts else ())


def _kept_case():
    """Reduced granite's layer-0 router and an input (16, 8, d) split over 4
    ranks, with the capacity factor that puts C at the largest count of one
    rank's own assignments to one expert, below the largest global count."""
    jarch = jax_reduced("granite-moe-3b-a800m")
    router = np.array(jlm.init_params(jarch, jax.random.PRNGKey(0))["layers"]["moe"]["router"][0])
    x = np.random.default_rng(9).standard_normal((16, 8, jarch.hidden)).astype(np.float32)
    logits = x.reshape(4, -1, jarch.hidden) @ router
    experts = np.argsort(-logits, axis=-1, kind="stable")[..., :jarch.top_k]
    local = np.stack([np.bincount(e.ravel(), minlength=jarch.num_experts) for e in experts])
    C = int(local.max())
    assert local.sum(0).max() > C
    T = x.shape[0] * x.shape[1]
    return router, x, jarch.top_k, (C + 0.5) * jarch.num_experts / (T * jarch.top_k)


def _uneven_case():
    """Reduced granite's params, an input x (3, 32, d) and a cotangent for
    its MoE block, and a batch of 6 rows."""
    _, jparams, tokens = _case("granite-moe-3b-a800m", B=6)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 32, jax_reduced("granite-moe-3b-a800m").hidden))
    return jparams, x.astype(np.float32), rng.standard_normal(x.shape).astype(np.float32), tokens


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    cases = [_rank_case(label) for label in ARCHS + SSM_ARCHS + MOE]
    torch_ranks.run_ranks(torch_ranks.train_step_program, 4, tmp, str(tmp / "out.pt"), cases,
                          [(shape, axes, tuple(spec)) for shape, axes, spec in ORDER_CASES],
                          str(tmp / "ckpt"), _kept_case(), _uneven_case(), timeout=240)
    return torch.load(tmp / "out.pt", weights_only=False)


def _max_err(got: dict, want: dict) -> float:
    w = _flat(want)
    assert sorted(got) == sorted(w)
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(w[k], np.float32)).max())
               for k in w)


@pytest.mark.parametrize("name", ARCHS + SSM_ARCHS + MOE)
def test_sharded_step_matches_the_jax_step(name, sharded_steps):
    jarch, jparams, tokens = _case(name)
    step = jax.jit(jstep.make_train_step(jarch, JCFG, jstep.TrainStepCfg()))
    p1, _, m1 = step(jparams, jopt.adamw_init(jparams), {"tokens": jnp.asarray(tokens)})
    got = sharded_steps[(name, 1)]
    assert abs(got["loss"] - float(m1["loss"])) < LOSS_TOL
    assert _max_err(got["params"], jax.device_get(p1)) < PARAM_TOL
    assert got["kept_placements"]


def _port_step(name, K):
    _, jparams, tokens = _case(name)
    arch = _arch_of(name)[1]
    params = params_from_numpy(jparams, device="cpu")
    step = make_train_step(arch, CFG, TrainStepCfg(num_microbatches=K))
    params, _, m = step(params, adamw_init(params), {"tokens": torch.from_numpy(tokens).long()})
    return params, m


@pytest.mark.parametrize("K", [1, 2], ids=["K1", "K2-batch_axes"])
@pytest.mark.parametrize("name", ARCHS + SSM_ARCHS + MOE)
def test_sharded_step_matches_the_unsharded_port(name, K, sharded_steps):
    params, m = _port_step(name, K)
    got = sharded_steps[(name, K)]
    assert abs(got["loss"] - float(m["loss"])) <= PORT_TOL * abs(float(m["loss"]))
    assert abs(got["grad_norm"] - float(m["grad_norm"])) <= PORT_TOL * float(m["grad_norm"])
    want = {k: v.numpy() for k, v in _flat(params).items()}
    for k, w in want.items():
        if k in ZERO_INIT:  # held through their grads (docstring (b))
            assert np.abs(got["params"][k] - w).max() < PARAM_TOL, k
            continue
        rel = np.abs(got["params"][k] - w).max() / (np.abs(w).max() + 1e-30)
        assert rel <= PORT_TOL, (k, rel)


def _unsharded_grads(name):
    """The loss's grads on the unsharded port at the case's params, and the
    assignments its forward dropped (moe)."""
    _, jparams, tokens = _case(name)
    arch = _arch_of(name)[1]
    params = {k: v.requires_grad_() for k, v in
              _flat(params_from_numpy(jparams, device="cpu")).items()}
    tree = {}
    for k, v in params.items():
        node = tree
        *parents, last = k.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = v
    with torch_ranks._Drops() as drops:  # counts in moe.global_route, as on the ranks
        loss, _ = lm.forward_train(tree, arch, CFG, {"tokens": torch.from_numpy(tokens).long()})
    return dict(zip(params, torch.autograd.grad(loss, list(params.values())))), drops.n


@pytest.mark.parametrize("name", SSM_ARCHS + MOE)
def test_sharded_grads_match_the_unsharded_port(name, sharded_steps):
    """Every grad leaf of the loss at the first step's params, made whole,
    within 1e-5 of the unsharded port's (relative to the leaf's largest);
    the weight grads of in_proj, conv_w and out_proj (ssm, hybrid) and of
    the experts' wi and wo (moe) come back from the backward split over
    "model" as their params are (no rank computes the whole weight grad),
    over "data" split as their params are or partial sums."""
    from torch.distributed.tensor import Partial

    want, _ = _unsharded_grads(name)
    got, placed = sharded_steps[(name, "grads")]
    for k, w in want.items():
        w = w.numpy()
        rel = np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-30)
        assert rel <= PORT_TOL, (k, rel)
    leaves = (("moe/wi", "moe/wo") if _arch_of(name)[1].family == "moe"
              else ("ssm/in_proj", "ssm/conv_w", "ssm/out_proj"))
    for leaf in leaves:
        grad, param = placed[f"layers/{leaf}"]
        data, model = 0, 1  # the mesh's dims
        assert grad[model] == param[model] and param[model].is_shard(), (leaf, grad, param)
        assert grad[data] in (param[data], Partial()), (leaf, grad, param)


@pytest.mark.parametrize("name", MOE)
def test_the_sharded_aux_loss_matches_jax(name, sharded_steps):
    """The load-balancing loss of the sharded step (its means over the
    global tokens) against the JAX forward's on the same params and batch."""
    jarch, jparams, tokens = _case(name)
    _, m = jlm.forward_train(jparams, jarch, JCFG, {"tokens": jnp.asarray(tokens)})
    got = sharded_steps[(name, 1)]["aux_loss"]
    assert got == pytest.approx(float(m["aux_loss"]), rel=PORT_TOL)


@pytest.mark.parametrize("name", MOE)
def test_the_sharded_moe_step_drops_what_the_unsharded_one_drops(name, sharded_steps):
    """At capacity factor 1.25 the forward drops assignments; over all
    ranks, as many as the unsharded forward, whose C comes from the same
    global token count. Whether experts split over "data" or not."""
    _, drops = _unsharded_grads(name)
    assert drops > 0
    assert sharded_steps[(name, "drops")] == drops
    split = name not in WHOLE_OVER_DATA
    grad, param = sharded_steps[(name, "grads")][1]["layers/moe/wi"]
    assert param[0].is_shard() == split


def test_an_uneven_block_of_rows_keeps_the_global_capacity(sharded_steps):
    """Reduced granite's layer-0 MoE block on (2, 2) with 3 rows over "data"
    of 2: the data ranks hold 2 and 1 rows (64 and 32 tokens). C comes from
    x's 96 tokens and the aux loss's means run over them, so the output, the
    aux loss, ``sum(y * cot) + aux`` and every grad are the unsharded
    block's (1e-5), where that block drops. make_train_step refuses K = 2
    microbatches of 3 rows over "data": DTensor cannot flatten blocks of
    unequal size in the model's first product, whatever the family."""
    from repro_torch.models import moe

    jparams, x, cot, _ = _uneven_case()
    got = sharded_steps["uneven"]
    assert got["rows"] == [32, 64]
    arch = get_reduced("granite-moe-3b-a800m")
    p = {k: v[0].requires_grad_()
         for k, v in params_from_numpy(jparams, device="cpu")["layers"]["moe"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    with torch_ranks._Drops() as drops:
        y = moe.moe_block(p, xt, top_k=arch.top_k, capacity_factor=1.25)
        aux = moe.aux_load_balance_loss(p, xt, top_k=arch.top_k)
    assert drops.n > 0
    loss = (y * torch.from_numpy(cot)).sum() + aux
    want = dict(zip(["x", *p], torch.autograd.grad(loss, [xt, *p.values()])))
    want["y"] = y
    for k, w in want.items():
        w = w.detach().numpy()
        g = got["y"] if k == "y" else got["grads"][k]
        assert np.abs(g - w).max() <= PORT_TOL * np.abs(w).max(), k
    assert got["aux"] == pytest.approx(float(aux.detach()), rel=PORT_TOL)
    assert got["loss"] == pytest.approx(float(loss.detach()), rel=PORT_TOL)
    assert got["refused"] == "2 microbatches of 3 rows do not split over ('data',) (2 ranks)"


def test_the_kept_mask_is_the_global_programs(sharded_steps):
    """(4, 1) mesh: no rank's own assignments to any expert exceed C, but
    the global count of one does, so a capacity applied per rank would keep
    every assignment; the global dispatch keeps exactly the (token, expert)
    pairs the unsharded ``global_route`` keeps."""
    from repro_torch.models import moe

    router, x, top_k, cf = _kept_case()
    got = sharded_steps["kept"]
    C = got["C"]
    counts = np.asarray(got["counts"])
    assert counts.max() <= C < counts.sum(0).max()
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, e_sorted, _, pos, t_sorted, _, c = moe.global_route(torch.from_numpy(router), xt, top_k,
                                                           cf, xt.shape[0])
    kept = pos < c
    want = sorted(zip(t_sorted[kept].tolist(), e_sorted[kept].tolist()))
    assert c == C and len(want) < xt.shape[0] * top_k
    assert got["pairs"] == want


def test_a_sharded_mamba2_state_round_trips_through_a_checkpoint(sharded_steps):
    got = sharded_steps[("ckpt", "mamba2-370m")]
    assert got["same_placements"] and got["equal"] and got["leaves"] > 0


def test_a_sharded_granite_state_round_trips_through_a_checkpoint(sharded_steps):
    """The expert leaves lie over "data" (E) and "model" (2F, F); the router
    and the rest as the rules place them."""
    got = sharded_steps[("ckpt", "granite-moe-3b-a800m")]
    assert got["same_placements"] and got["equal"] and got["leaves"] > 0
    assert got["expert_placements"] == [(sharding.Shard(1), sharding.Shard(3)),
                                        (sharding.Shard(1), sharding.Shard(2))]


def test_k1_takes_the_sharded_q_k_views_in_place(sharded_steps):
    """qwen3's q and k norms reach K1 as strided views of the fused qkv
    product on each rank (the rank's batch rows, every head: "model" is made
    whole before the split), and K1's ``_plan`` takes each of them without a
    copy; no norm input of the sharded step is refused."""
    arch = get_reduced("qwen3-8b")
    for K in (1, 2):
        seen = sharded_steps[("qwen3-8b", K)]["norm_inputs"]
        assert seen and all(kind != "refused" for *_, kind in seen)
        heads = [s for s in seen if s[0][-1] == arch.head_dim]
        # ln1, ln2 per layer, the final norm; q and k norms per layer
        assert len(heads) == 2 * arch.num_layers * K
        assert all(not contiguous for _, _, contiguous, _ in heads)
        assert {kind for *_, kind in heads} == {"vector"}


def test_a_dim_over_pod_and_data_lands_as_jax_places_it(sharded_steps):
    """JAX, on 4 host devices, for the same meshes and specs: the rows and
    columns of an (8, 8) arange on the device of each index, against the
    shard the rank of that index holds."""
    code = """
import json, jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(input())
out = []
for shape, axes, spec in cases:
    mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(axes))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map((8, 8))
    x = np.arange(64).reshape(8, 8)
    out.append({d.id: x[i].tolist() for d, i in idx.items()})
print(json.dumps(out))
"""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], input=json.dumps(ORDER_CASES),
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for case, by_device, by_rank in zip(ORDER_CASES, want, sharded_steps["shards"]):
        for rank, shard in enumerate(by_rank):
            assert shard.tolist() == by_device[str(rank)], (case, rank)


# --- (c) elastic restart --------------------------------------------------------

def test_elastic_restart_across_mesh_shapes(tmp_path):
    _, jparams, _ = _case("yi-6b")
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 128, (8, 32)).astype(np.int32) for _ in range(4)]
    arch = get_reduced("yi-6b")
    step = make_train_step(arch, CFG, TrainStepCfg(base_lr=1e-3))
    params = params_from_numpy(jparams, device="cpu")
    opt = adamw_init(params)
    for b in batches:
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(b).long()})
    ref_loss = float(m["loss"])

    ckpt = tmp_path / "ckpt"
    torch_ranks.run_ranks(torch_ranks.elastic_program, 4, tmp_path, str(tmp_path / "out.pt"),
                          str(ckpt), jparams, batches)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    assert got["restored_on_b"] and got["step"] == 2
    assert abs(got["losses"][-1] - ref_loss) < LOSS_TOL
    # rank 0 alone copies the gathered leaves to the host
    with open(ckpt / "step_00000002" / "meta.json") as f:
        n_leaves = len(json.load(f)["keys"])
    assert got["host_copies"] == [n_leaves, 0, 0, 0]
    # the sharded save is the JAX package's file
    template = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    state, meta = JaxManager(str(ckpt)).restore(template)
    assert meta["step"] == 2 and int(state["opt"].step) == 2


# --- (d) act_shard ----------------------------------------------------------------

def test_act_shard_leaves_the_forward_as_it_was(tmp_path):
    cases = [(name, *_case(name)[1:]) for name in ARCHS]
    torch_ranks.run_ranks(torch_ranks.act_shard_program, 2, tmp_path,
                          str(tmp_path / "out.pt"), cases)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    for name, jparams, tokens in cases:
        arch = get_reduced(name)
        want = lm.forward_logits(params_from_numpy(jparams, device="cpu"), arch, CFG,
                                 {"tokens": torch.from_numpy(tokens).long()}).numpy()
        np.testing.assert_allclose(got[name]["act_shard"], got[name]["plain"], rtol=0,
                                   atol=PORT_TOL)
        np.testing.assert_allclose(got[name]["act_shard"], want, rtol=0, atol=PORT_TOL)
        loss = float(lm.forward_train(params_from_numpy(jparams, device="cpu"), arch, CFG,
                                      {"tokens": torch.from_numpy(tokens).long()})[0])
        assert abs(got[name]["loss"] - loss) <= PORT_TOL * loss
        assert abs(got[name]["loss_parallel"] - loss) <= PORT_TOL * loss


@pytest.mark.parametrize("Hq,Hkv,tp", [(8, 1, 2), (8, 2, 4), (12, 3, 2), (12, 4, 4),
                                       (6, 2, 3), (32, 8, 16)])
def test_each_rank_reads_the_kv_heads_of_its_q_heads(Hq, Hkv, tp):
    """GQA under TP with k/v whole over "model": the attention of rank r's q
    heads against the kv heads ``_kv_heads_of`` hands it equals those heads
    of the whole attention, whether they cover whole groups, lie in one, or
    straddle two (then one kv head per q head)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(Hq * 100 + Hkv * 10 + tp)
    q = torch.randn(2, Hq, 5, 16, generator=g)
    k, v = (torch.randn(2, Hkv, 5, 16, generator=g) for _ in range(2))
    whole = ref.attention(q, k, v, causal=True)
    n = Hq // tp
    for r in range(tp):
        kr, vr = ops._kv_heads_of(k, v, r * n, n, Hq // Hkv)
        got = ref.attention(q[:, r * n:(r + 1) * n], kr, vr, causal=True)
        torch.testing.assert_close(got, whole[:, r * n:(r + 1) * n], rtol=0, atol=1e-6)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, taken down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_takes_the_backend_of_its_device_and_no_other(one_rank_group):
    from repro_torch.launch import mesh

    m = mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="nccl"):  # a gloo group is no cuda mesh
        mesh.make_mesh((1, 1), ("data", "model"), "cuda")
    with pytest.raises(ValueError, match="differ in length"):
        mesh.make_mesh((1,), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="no process-group backend"):
        mesh.backend_for("xpu")
