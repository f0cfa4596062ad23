"""The port's moe family (granite-moe-3b-a800m and llama4-scout-17b-a16e,
reduced) against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross through numpy
(``params_from_numpy``); inputs are numpy arrays from a seed. f32 throughout.
Bounds: 1e-5 for one MoE block (the same f32 products, summed in another
order), 1e-4 for whole models as tests/test_torch_models.py; the dispatch
(which assignment takes which capacity slot, which are dropped) must be the
same exactly.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import get_arch, get_reduced  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import TrainStepCfg, adamw_init, make_train_step  # noqa: E402

TOL = 1e-4
BLOCK_TOL = 1e-5
JCFG = jlm.ModelCfg(dtype=jnp.float32, attn_impl="pallas", norm_impl="pallas")
CFG = lm.ModelCfg(dtype=torch.float32)
ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _setup(name, B=2, S=12, seed=0):
    jarch = jax_reduced(name)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    toks = np.random.default_rng(seed).integers(0, jarch.vocab, size=(B, S)).astype(np.int32)
    return jarch, get_reduced(name), jparams, params, toks


def _block(name, seed=0, T=(4, 16)):
    """Layer 0's moe params on both sides and an input x (B, S, d)."""
    jarch = jax_reduced(name)
    jparams = jlm.init_params(jarch, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(lambda x: x[0], jparams["layers"]["moe"])
    p = params_from_numpy(jax.device_get(jp), device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(T + (jarch.hidden,)).astype(np.float32)
    return jarch, jp, p, x


def _jax_dest(p, x, top_k, capacity_factor):
    """The slot of each sorted assignment, as repro/models/moe.py computes it
    inside moe_block (lines 41-63 there, which do not return it)."""
    E = p["router"].shape[-1]
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    logits = xt.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    _, experts = jax.lax.top_k(logits, top_k)
    expert_flat = experts.reshape(-1)
    order = jnp.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    C = max(int(T * top_k * capacity_factor / E), 1)
    counts = jnp.bincount(expert_flat, length=E)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(expert_flat.shape[0]) - starts[e_sorted]
    dest = jnp.where(pos < C, e_sorted * C + pos, E * C)
    return np.asarray(dest), np.asarray(jnp.repeat(jnp.arange(T), top_k)[order]), C


@pytest.mark.parametrize("name", ARCHS)
def test_copied_configs_match_the_jax_package(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(jax_arch(name))
    assert dataclasses.asdict(get_reduced(name)) == dataclasses.asdict(jax_reduced(name))
    assert get_arch(name).total_params() == jax_arch(name).total_params()


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_and_params_from_numpy_carry_the_moe_leaves(name, dtype):
    """moe.router, moe.wi (L, E, d, 2F), moe.wo and, for llama4-scout, the
    shared expert: the layout and dtypes of the JAX tree, and the JAX values
    leaf for leaf."""
    jtree = jax.device_get(jlm.init_params(jax_reduced(name), jax.random.PRNGKey(0),
                                           dtype=getattr(jnp, dtype)))
    jflat = _flat(jtree)
    tflat = _flat(lm.init_params(get_reduced(name), torch.Generator().manual_seed(0),
                                 getattr(torch, dtype), "cpu"))
    assert {k: (v.shape, str(v.dtype)) for k, v in jflat.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tflat.items()}
    arch = get_reduced(name)
    want = {"layers/moe/router", "layers/moe/wi", "layers/moe/wo", "layers/ln2"}
    if arch.shared_expert:
        want |= {"layers/moe/shared_wi", "layers/moe/shared_wo"}
    assert want <= set(tflat) and not any(k.startswith("layers/mlp") for k in tflat)
    F = arch.moe_ffn
    assert tflat["layers/moe/wi"].shape == (arch.num_layers, arch.num_experts, arch.hidden, 2 * F)
    carried = _flat(params_from_numpy(jtree, device="cpu"))
    for k, a in jflat.items():
        np.testing.assert_array_equal(carried[k].float().numpy(), np.asarray(a, np.float32))


def _route(p, xt, top_k, capacity_factor):
    """The one-rank dispatch of tokens xt (T, d): each assignment's slot
    ``e * C + i`` in expert order, or ``E * C`` where dropped; its token; C."""
    E = p["router"].shape[-1]
    _, e, _, pos, tok, _, C = moe.global_route(p["router"], xt, top_k, capacity_factor,
                                               xt.shape[0])
    return torch.where(pos < C, e * C + pos, E * C), tok, C


@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_without_drops_matches_jax(name):
    jarch, jp, p, x = _block(name)
    want = jmoe.moe_block(jp, jnp.asarray(x), top_k=jarch.top_k, capacity_factor=8.0)
    got = moe.moe_block(p, torch.from_numpy(x), top_k=jarch.top_k, capacity_factor=8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BLOCK_TOL, rtol=0)
    dest, _, C = _route(p, torch.from_numpy(x).reshape(-1, jarch.hidden), jarch.top_k, 8.0)
    assert int((dest == jarch.num_experts * C).sum()) == 0


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("T", [(4, 16), (1, 7), (3, 1)])
def test_moe_block_with_drops_matches_jax(name, T):
    """At the default capacity factor some experts overflow: the same
    assignments keep the same slots and the same ones are dropped."""
    jarch, jp, p, x = _block(name, T=T)
    want_dest, want_tok, C = _jax_dest(jp, jnp.asarray(x), jarch.top_k, 1.25)
    dest, tok, c = _route(p, torch.from_numpy(x).reshape(-1, jarch.hidden), jarch.top_k, 1.25)
    assert c == C == moe.capacity(T[0] * T[1], jarch.top_k, 1.25, jarch.num_experts)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    if T == (4, 16):
        assert int((dest == jarch.num_experts * C).sum()) > 0  # this case drops
    want = jmoe.moe_block(jp, jnp.asarray(x), top_k=jarch.top_k, capacity_factor=1.25)
    got = moe.moe_block(p, torch.from_numpy(x), top_k=jarch.top_k, capacity_factor=1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BLOCK_TOL, rtol=0)


def test_expert_counts_are_bincounts_with_a_static_shape():
    """The static count gives bincount's integers, experts nobody picked
    included, with no read back to the host."""
    g = torch.Generator().manual_seed(4)
    for E, shape in ((40, (100, 8)), (16, (7, 1)), (8, (1, 2))):
        experts = torch.randint(0, E // 2, shape, generator=g)  # the upper half unpicked
        got = moe.expert_counts(experts, E)
        assert got.shape == (E,) and got.dtype == torch.long
        assert torch.equal(got, torch.bincount(experts.flatten(), minlength=E))


@pytest.mark.parametrize("name", ARCHS)
def test_moe_block_and_aux_loss_trace_on_fake_tensors(name):
    """The block and the aux loss run under FakeTensorMode (the dry-run's
    tensors): nothing on their path has a shape that depends on the data."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    arch = get_reduced(name)
    with FakeTensorMode():
        params = lm.init_params(arch, torch.Generator(), torch.float32, "cpu")
        lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
        x = torch.empty(2, 12, arch.hidden)
        y = moe.moe_block(lp, x, top_k=arch.top_k)
        aux = moe.aux_load_balance_loss(lp, x, top_k=arch.top_k)
    assert y.shape == x.shape and aux.shape == ()


def test_moe_routing_is_sparse_and_weighted():
    """tests/test_models.py's check on the port: zeroing an expert no token
    chose leaves the outputs exactly as they were."""
    arch = get_reduced("granite-moe-3b-a800m")
    params = lm.init_params(arch, torch.Generator().manual_seed(0), torch.float32, "cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, arch.hidden))
                         .astype(np.float32))
    y = moe.moe_block(lp, x, top_k=arch.top_k, capacity_factor=8.0)
    sel = torch.topk(x.reshape(-1, arch.hidden) @ lp["router"], arch.top_k).indices
    unused = [e for e in range(arch.num_experts) if not bool((sel == e).any())]
    assert unused
    lp2 = dict(lp, wi=lp["wi"].clone(), wo=lp["wo"].clone())
    lp2["wi"][unused[0]] = 0.0
    lp2["wo"][unused[0]] = 0.0
    y2 = moe.moe_block(lp2, x, top_k=arch.top_k, capacity_factor=8.0)
    assert float((y - y2).abs().max()) == 0.0


def _sorted_scatter(xt, dest, order, top_k: int, rows: int):
    """The dispatch as the port wrote it before its slot and token maps: the
    sorted assignments' token rows put at ``dest`` in a zeroed (rows + 1, d)
    buffer whose last row, the drop slot, is cut off."""
    d = xt.shape[-1]
    src = xt.unsqueeze(1).expand(xt.shape[0], top_k, d).reshape(-1, d)[order]
    buf = torch.zeros((rows + 1, d), dtype=xt.dtype, device=xt.device)
    return buf.index_put((dest,), src)[:rows]


def _sorted_combine(out_flat, dest, order, g_sorted, top_k: int):
    """The combine as the port wrote it before its maps: a zero row appended
    for the dropped, each sorted assignment's row times its gate, put back
    in token order and summed over k."""
    d = out_flat.shape[-1]
    out_flat = torch.cat([out_flat, torch.zeros((1, d), dtype=out_flat.dtype)])
    per_assignment = out_flat[dest] * g_sorted[:, None]
    inverse = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0]))
    return per_assignment[inverse].reshape(-1, top_k, d).sum(dim=1)


def _sorted_block(p, x, top_k: int, capacity_factor: float):
    """``moe_block`` on one rank through the formulation above: the
    reference the maps must equal bit for bit."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    E = p["router"].shape[-1]
    order, e_sorted, _, pos, _, g_sorted, C = moe.global_route(p["router"], xt, top_k,
                                                               capacity_factor, B * S)
    dest = torch.where(pos < C, e_sorted * C + pos, E * C)
    grouped = _sorted_scatter(xt, dest, order, top_k, E * C).reshape(E, C, d)
    out = moe._experts(grouped, p["wi"], p["wo"]).reshape(-1, d)
    y = _sorted_combine(out, dest, order, g_sorted, top_k)
    if "shared_wi" in p:
        y = y + moe._shared(xt, p["shared_wi"], p["shared_wo"])
    return y.reshape(B, S, d)


def _crowded(name, dtype, T=64, copies=24):
    """Layer 0's moe params in ``dtype`` and an input (1, T, d) whose last
    ``copies`` tokens repeat its first: they choose the same experts, so at
    1.25 the last copies lose every one of their k assignments, while the
    spare slots leave some expert partly empty."""
    _, _, p, x = _block(name, T=(1, T))
    x[0, T - copies:] = x[0, 0]
    return ({k: v.to(dtype) for k, v in p.items()},
            torch.from_numpy(x).to(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("name,top_k", [(name, None) for name in ARCHS]
                         + [("granite-moe-3b-a800m", 4)])
def test_the_maps_equal_the_sorted_scatter_and_combine_bit_for_bit(name, top_k,
                                                                   capacity_factor, dtype):
    """The block through its slot and token maps against the sorted scatter
    and combine it replaced: the output and the grads of x, the router and
    the experts (the shared expert's too) ``torch.equal``, where the block
    drops (a token losing all its k assignments, an expert with empty slots)
    and where nothing drops. The same products and the same sums over k in
    the same layout; the zeros of dropped rows were copies, 0 + v = v.
    Granite also at k = 4, where a sum over k in another order would show
    (two terms add alike either way)."""
    arch = dataclasses.replace(get_reduced(name), top_k=top_k or get_reduced(name).top_k)
    p, x = _crowded(name, getattr(torch, dtype))
    xt = x.reshape(-1, arch.hidden)
    _, e_sorted, _, pos, t_sorted, _, C = moe.global_route(p["router"], xt, arch.top_k,
                                                           capacity_factor, xt.shape[0])
    dropped = torch.bincount(t_sorted[pos >= C], minlength=xt.shape[0])
    counts = moe.expert_counts(e_sorted, arch.num_experts)
    if capacity_factor == 8.0:
        assert int(dropped.sum()) == 0
    else:
        assert int(dropped.max()) == arch.top_k  # a token keeps none of its k
        assert bool(((counts > 0) & (counts < C)).any())  # an expert partly empty
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(x.dtype)
    got, want = [], []
    for block, out in ((moe.moe_block, got), (_sorted_block, want)):
        leaves = {"x": x.clone().requires_grad_(),
                  **{k: v.clone().requires_grad_() for k, v in p.items()}}
        y = block({k: v for k, v in leaves.items() if k != "x"}, leaves["x"],
                  top_k=arch.top_k, capacity_factor=capacity_factor)
        out.append(y.detach())
        out += torch.autograd.grad((y * cot).sum(), list(leaves.values()))
    names = ["y", "x", *p]
    assert ("shared_wi" in names) == arch.shared_expert
    for k, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), k


@pytest.mark.parametrize("name", ARCHS)
def test_the_dispatch_backward_holds_no_index_backward(name):
    """The block's backward graph, walked from its output: the dispatch and
    the combine are one gather each way, so no ``IndexBackward0`` (whose
    backward sorts its indices and accumulates, serially where many repeat)
    and no ``IndexPutBackward0`` is left on it."""
    arch = get_reduced(name)
    p, x = _crowded(name, torch.float32)
    p = {k: v.requires_grad_() for k, v in p.items()}
    y = moe.moe_block(p, x.requires_grad_(), top_k=arch.top_k)
    seen, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [n for n, _ in node.next_functions]
    names = {type(n).__name__ for n in seen}
    assert {"_DispatchBackward", "_CombineBackward"} <= names, names
    assert not names & {"IndexBackward0", "IndexPutBackward0"}, names


@pytest.mark.parametrize("name", ARCHS)
def test_aux_load_balance_loss_matches_jax(name):
    jarch, jp, p, x = _block(name, seed=2)
    want = jmoe.aux_load_balance_loss(jp, jnp.asarray(x), top_k=jarch.top_k)
    got = moe.aux_load_balance_loss(p, torch.from_numpy(x), top_k=jarch.top_k)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", ["cuda", "torch", "xla"])
def test_forward_logits_matches_jax(name, impl):
    jarch, arch, jparams, params, toks = _setup(name)
    jcfg = JCFG if impl != "xla" else jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla")
    want = np.asarray(jlm.forward_logits(jparams, jarch, jcfg, {"tokens": jnp.asarray(toks)}))
    cfg = lm.ModelCfg(dtype=torch.float32, attn_impl=impl, norm_impl=impl, ssm_impl=impl)
    got = lm.forward_logits(params, arch, cfg, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_loss_aux_loss_and_grads_match_jax(name):
    """loss = ce_loss + moe_aux_weight * aux_loss, where aux_loss is layer
    0's router on the embedded tokens (the JAX package's definition); every
    grad leaf, the routers' and the embedding's included."""
    jarch, arch, jparams, params, toks = _setup(name, B=2, S=10, seed=1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jarch, JCFG, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    leaves = {k: v.requires_grad_() for k, v in _flat(params).items()}
    loss, m = lm.forward_train(params, arch, CFG, {"tokens": torch.from_numpy(toks).long()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert sorted(m) == sorted(jm) == ["aux_loss", "ce_loss", "loss"]
    for k in m:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=TOL), k
    assert float(m["loss"]) == pytest.approx(
        float(m["ce_loss"]) + CFG.moe_aux_weight * float(m["aux_loss"]), rel=1e-6)
    for k, g in _flat(jax.device_get(jgrads)).items():
        scale = float(np.abs(g).max()) + 1e-30
        assert float(np.abs(grads[k].numpy() - g).max()) / scale < TOL, k
    # no aux loss at weight 0
    _, m0 = lm.forward_train(params, arch, dataclasses.replace(CFG, moe_aux_weight=0.0),
                             {"tokens": torch.from_numpy(toks).long()})
    assert "aux_loss" not in m0


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_match_teacher_forcing_and_jax(name):
    """tests/test_models.py's serve parity, at capacity factor 8.0: the
    capacity depends on the number of tokens, so prefill, decode and teacher
    forcing drop different assignments at 1.25."""
    jarch, arch, jparams, params, toks = _setup(name)
    B, S = toks.shape
    cfg = dataclasses.replace(CFG, capacity_factor=8.0)
    jcfg = dataclasses.replace(JCFG, capacity_factor=8.0)
    t = torch.from_numpy(toks).long()
    full = lm.forward_logits(params, arch, cfg, {"tokens": t})
    caches = lm.init_caches(arch, cfg, B, S + 4, device="cpu")
    jc = jlm.init_caches(jarch, jcfg, B, S + 4)
    lg, caches = lm.prefill(params, arch, cfg, caches, t[:, :S - 2])
    jl, jc = jlm.prefill(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, :S - 2]))
    assert float((lg - full[:, :S - 2]).abs().max()) < TOL
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for pos in (S - 2, S - 1):
        lg, caches = lm.decode_step(params, arch, cfg, caches, t[:, pos:pos + 1], pos)
        jl, jc = jlm.decode_step(jparams, jarch, jcfg, jc, jnp.asarray(toks[:, pos:pos + 1]),
                                 pos)
        assert float((lg[:, 0] - full[:, pos]).abs().max()) < TOL
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=TOL, rtol=0)


def test_greedy_tokens_match_jax_engine():
    """At the default capacity factor: both engines drop the same
    assignments, since prefill and decode see the same token counts."""
    jarch, arch, jparams, params, _ = _setup("granite-moe-3b-a800m", seed=2)
    prompts = np.random.default_rng(0).integers(0, arch.vocab, size=(3, 7)).astype(np.int32)
    want = JaxEngine(jarch, JCFG, jparams, max_len=20).generate(prompts, max_new_tokens=8)
    got = ServeEngine(arch, CFG, params, max_len=20, device="cpu").generate(
        prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_train_step_matches_jax():
    """One make_train_step step for granite reduced against the JAX step, as
    tests/test_torch_train.py holds qwen3: loss, grad_norm and mu at 1e-4;
    the step's metrics carry aux_loss."""
    jarch, arch, jparams, params, toks = _setup("granite-moe-3b-a800m", B=8, S=16)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
    kw = dict(num_microbatches=1, base_lr=1e-2, warmup_steps=2, total_steps=10)
    _, jo, jm = jstep.make_train_step(jarch, jcfg, jstep.TrainStepCfg(**kw))(
        jparams, jopt.adamw_init(jparams), {"tokens": jnp.asarray(toks)})
    cfg = lm.ModelCfg(dtype=torch.float32, attn_impl="xla", norm_impl="xla", ssm_impl="xla")
    _, opt, m = make_train_step(arch, cfg, TrainStepCfg(**kw))(
        params, adamw_init(params), {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "aux_loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=TOL), k
    for k, want in _flat(jax.device_get(jo.mu)).items():
        got = _flat(opt.mu)[k].numpy()
        assert float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30) < TOL, k


def _losses(out: str) -> list[float]:
    return [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]


def test_driver_prints_the_jax_drivers_loss_curve(capsys, monkeypatch):
    """``--arch granite-moe-3b-a800m --reduced`` in both drivers from the JAX
    driver's initial weights (its init_params at PRNGKey(0), carried across
    through numpy) on the same synthetic corpus: the same loss at every step
    to the printed 4 decimals (1e-4 apart where f32 rounding puts the two
    on either side of a last printed digit)."""
    from repro.launch import train as jdriver
    from repro_torch.launch import train as driver

    argv = ["--arch", "granite-moe-3b-a800m", "--reduced", "--steps", "4", "--batch", "8",
            "--seq", "32", "--log-every", "1"]
    want = jdriver.main(argv)
    want_losses = _losses(capsys.readouterr().out)
    jparams = jax.device_get(jlm.init_params(jax_reduced("granite-moe-3b-a800m"),
                                             jax.random.PRNGKey(0), dtype=jnp.float32))
    monkeypatch.setattr(driver, "init_params",
                        lambda *a, **k: params_from_numpy(jparams, device="cpu"))
    got = driver.main(argv + ["--device", "cpu"])
    got_losses = _losses(capsys.readouterr().out)
    assert len(got_losses) == len(want_losses) == 4
    np.testing.assert_allclose(got_losses, want_losses, atol=1e-4 + 1e-9, rtol=0)
    for k in ("first_loss", "last_loss"):
        assert got[k] == pytest.approx(want[k], rel=TOL), k
    assert got["last_loss"] < got["first_loss"]
