"""The cached path (prefill and decode) on DTensors, over 4 gloo ranks on a
(2, 2) data x model mesh with FSDP: params, caches and tokens placed by
``param_specs``, ``cache_specs`` and ``batch_spec``, as the JAX dry-run
places them.

Reduced yi-6b has one kv head, which "model" does not divide, so its cache's
sequence T lies over "model" and each rank's part of T merges through the
log-sum-exp rescale; reduced qwen3-8b has two, and its cache's heads split.
A prompt of 40 into a cache of 64 crosses the T shards' boundary at 32. Each
case runs a prefill and 8 greedy decode steps in f32 and is held against the
unsharded port (every step's logits within 1e-5, the tokens equal) and, for
the default options, against the JAX ``prefill``/``decode_step`` on the same
params (1e-4, the serve tests' tolerance). The KV-cache options run on the
ranks' shards as on a plain cache.

The ssm and hybrid families: reduced mamba2-370m (conv and state caches over
"model" by channels and heads) and hymba-1.5b (a 32-slot ring for its window
of 32) on the (2, 2) mesh, where hymba's 2 kv heads split, and hymba on a
(1, 4) mesh, where they do not: there the ring's T lies over "model", 8
slots a rank, as at production. Each hymba layout runs a prompt of 24 and 16
decode steps that wrap the ring at 32, and a prompt of 40 > 32 (the ring
prefill, each rank writing its slots of the last 32 positions) and 8 decode
steps. Every step's logits are held against the unsharded port (1e-5) and
the JAX package (1e-4), and the caches lie as ``cache_specs`` places them.

Dense decode attention over a cache split over T (``decode_dense_attn``):
yi-6b's on the (2, 2) mesh, and hymba's ring on the (1, 4) mesh decoded past
its window of 32, each rank's masked product over its part of T merged by one
softmax over the parts: every step's logits within 1e-5 of the unsharded
port's dense decode and 1e-4 of the JAX package's.

The encdec and vlm families: reduced whisper-tiny (4 heads, split by "model"
on both meshes; its frames encoded by ``init_caches`` on the DTensor params
into cross K/V placed as ``cache_specs`` places them) and pixtral-12b (a
frontend of 8 embeddings in front of each prompt, placed by ``batch_spec``;
2 kv heads, which split on (2, 2) and put the cache over T on (1, 4)), each
on both meshes against the unsharded port (1e-5), the JAX package's
prefill and decode steps (1e-4) and the JAX ``ServeEngine``'s tokens.

The moe family: reduced granite-moe-3b-a800m (8 experts, top-2) and
llama4-scout-17b-a16e (4, top-1, a shared expert) on the (2, 2) mesh, their
experts over "data", at the default capacity factor 1.25: C comes from the
chunk's global B x S (80 tokens in the prefill, 2 in a decode step), so the
sharded run drops what the unsharded one and the JAX package drop. Each run's
logits are held as the dense cases' are, and its tokens against the JAX
``ServeEngine``'s greedy tokens.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

PORT_TOL, JAX_TOL = 1e-5, 1e-4
B, P, N, T = 2, 40, 8, 64
CASES = {  # label -> (arch, ModelCfg options)
    "yi-6b-seq": ("yi-6b", {}),
    "qwen3-8b-heads": ("qwen3-8b", {}),
    "yi-6b-seq-int8-scatter": ("yi-6b", {"kv_cache_quant": True, "kv_scatter_write": True}),
    "yi-6b-repeat2-heads": ("yi-6b", {"kv_cache_repeat": 2}),
    "qwen3-8b-heads-dense": ("qwen3-8b", {"decode_dense_attn": True}),
    "yi-6b-seq-dense": ("yi-6b", {"decode_dense_attn": True}),
    "granite-moe-experts-over-data": ("granite-moe-3b-a800m", {}),
    "llama4-moe-experts-over-data": ("llama4-scout-17b-a16e", {}),
}
MOE_LABELS = ["granite-moe-experts-over-data", "llama4-moe-experts-over-data"]
CHUNK = (30, 4)  # a prefill of 30, then 4 tokens at slots 30..33 across the boundary at 32
# label -> (arch, mesh, prompt length, decode steps[, ModelCfg options]): the
# ssm and hybrid cases; the last decodes densely over its ring split over T
SSM_CASES = {
    "mamba2-2x2": ("mamba2-370m", (2, 2), 40, 8),
    "hymba-heads-wrap": ("hymba-1.5b", (2, 2), 24, 16),
    "hymba-heads-ring-prefill": ("hymba-1.5b", (2, 2), 40, 8),
    "hymba-seq-wrap": ("hymba-1.5b", (1, 4), 24, 16),
    "hymba-seq-ring-prefill": ("hymba-1.5b", (1, 4), 40, 8),
    "hymba-seq-wrap-dense": ("hymba-1.5b", (1, 4), 24, 16, {"decode_dense_attn": True}),
}
# label -> (arch, mesh): the encdec and vlm cases, P prompts and N steps each
STUB_CASES = {
    "whisper-2x2": ("whisper-tiny", (2, 2)), "pixtral-2x2": ("pixtral-12b", (2, 2)),
    "whisper-1x4": ("whisper-tiny", (1, 4)), "pixtral-1x4": ("pixtral-12b", (1, 4)),
}


def _case(name: str, seed: int = 0, P: int = P):
    """The JAX config and params, the prompts, and the family's stub inputs
    (numpy f32: an encdec model's frames, a vlm model's frontend)."""
    jarch = jax_reduced(name)
    jparams = jax.device_get(jlm.init_params(jarch, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, jarch.vocab, (B, P)).astype(np.int32)
    extra = {}
    if jarch.family == "encdec":
        extra["enc_features"] = rng.standard_normal((B, jarch.encoder_seq, jarch.hidden))
    elif jarch.family == "vlm":
        extra["frontend"] = rng.standard_normal((B, jarch.frontend_seq, jarch.hidden))
    return jarch, jparams, prompts, {k: v.astype(np.float32) for k, v in extra.items()}


def _ssm_case(label):
    """(arch, mesh, prompt length, decode steps, ModelCfg options)."""
    name, mesh, p, n, *opts = SSM_CASES[label]
    return name, mesh, p, n, (opts[0] if opts else {})


def _mesh_cases(mesh):
    """The cases of ``cached_program`` on ``mesh``: the ssm, hybrid, encdec
    and vlm ones."""
    out = []
    for label in SSM_CASES:
        name, m, p, n, opts = _ssm_case(label)
        if m == mesh:
            out.append((label, name, *_case(name, P=p)[1:3], n, T, opts))
    for label, (name, m) in STUB_CASES.items():
        if m == mesh:
            _, jparams, prompts, extra = _case(name)
            out.append((label, name, jparams, prompts, N, T, {}, extra))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cached")
    cases = [(label, name, _case(name)[1], _case(name)[2], N, T, opts)
             for label, (name, opts) in CASES.items()]
    toks = np.random.default_rng(7).integers(0, 64, (B, sum(CHUNK)))
    torch_ranks.run_ranks(torch_ranks.cached_program, 4, tmp, str(tmp / "out.pt"), (2, 2),
                          cases + _mesh_cases((2, 2)),
                          (_case("yi-6b")[1], CHUNK[0], CHUNK[1], T, toks))
    return torch.load(tmp / "out.pt", weights_only=False)


@pytest.fixture(scope="module")
def ranks_1x4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cached_1x4")
    torch_ranks.run_ranks(torch_ranks.cached_program, 4, tmp, str(tmp / "out.pt"), (1, 4),
                          _mesh_cases((1, 4)), None)
    return torch.load(tmp / "out.pt", weights_only=False)


def _unsharded(name: str, opts: dict, got_tokens, P: int = P, N: int = N):
    """The port on plain tensors, teacher-forced with the sharded run's
    tokens (behind the case's frontend, its frames in the cache): every
    step's logits and the greedy tokens."""
    _, jparams, prompts, extra = _case(name, P=P)
    arch = get_reduced(name)
    cfg = lm.ModelCfg(dtype=torch.float32, **opts)
    params = params_from_numpy(jparams, device="cpu")
    stub = {k: torch.from_numpy(v) for k, v in extra.items()}
    caches = lm.init_caches(arch, cfg, B, T, device="cpu", params=params,
                            enc_features=stub.get("enc_features"))
    frontend = stub.get("frontend")
    F = 0 if frontend is None else frontend.shape[1]
    seq = torch.as_tensor(got_tokens).long()
    logits, _ = lm.prefill(params, arch, cfg, caches, seq[:, :P], frontend=frontend)
    steps, greedy = [logits.numpy()], [logits[:, -1].argmax(-1)]
    for i in range(N):
        logits, _ = lm.decode_step(params, arch, cfg, caches, seq[:, P + i:P + i + 1],
                                   F + P + i)
        steps.append(logits.numpy())
        greedy.append(logits[:, -1].argmax(-1))
    return steps, torch.stack(greedy[:-1], 1).numpy()


def _jax_logits(name: str, tokens, P: int = P, N: int = N, opts=None):
    """The JAX package's prefill and N decode steps (under the ModelCfg
    options ``opts``), teacher-forced with ``tokens``, behind the case's
    frontend, its frames in the cache (one run for the meshes that gave the
    same tokens)."""
    tokens = np.asarray(tokens, np.int64)
    return _jax_run(name, tokens.tobytes(), tokens.shape, P, N,
                    tuple(sorted((opts or {}).items())))


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, token_bytes: bytes, shape, P: int, N: int, opts: tuple):
    tokens = np.frombuffer(token_bytes, np.int64).reshape(shape)
    jarch, jparams, prompts, extra = _case(name, P=P)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla", **dict(opts))
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    caches = jlm.init_caches(jarch, jcfg, B, T, enc_features=jextra.get("enc_features"),
                             params=jparams)
    frontend = jextra.get("frontend")
    F = 0 if frontend is None else frontend.shape[1]
    logits, caches = jlm.prefill(jparams, jarch, jcfg, caches, jnp.asarray(prompts),
                                 frontend=frontend)
    out = [np.asarray(logits)]
    for i in range(N):
        tok = jnp.asarray(tokens[:, P + i:P + i + 1], jnp.int32)
        logits, caches = jlm.decode_step(jparams, jarch, jcfg, caches, tok, F + P + i)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("label", list(CASES))
def test_sharded_cached_path_matches_the_unsharded_port(label, ranks):
    name, opts = CASES[label]
    got = ranks[label]
    want, greedy = _unsharded(name, opts, got["tokens"])
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"][:, P:], greedy)


@pytest.mark.parametrize("label", ["yi-6b-seq", "qwen3-8b-heads", "yi-6b-seq-dense"]
                         + MOE_LABELS)
def test_sharded_cached_path_matches_jax(label, ranks):
    name, opts = CASES[label]
    got = ranks[label]
    want = _jax_logits(name, got["tokens"], opts=opts)
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=JAX_TOL, rtol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("label,dim", [("yi-6b-seq", 3), ("qwen3-8b-heads", 2),
                                       ("yi-6b-repeat2-heads", 2)])
def test_the_cache_lies_over_model_as_cache_specs_place_it(label, dim, ranks):
    from torch.distributed.tensor import Shard

    # (L, B, Hkv, T, D): B over "data", the heads or T over "model"
    assert ranks[label]["placements"]["k"] == (Shard(1), Shard(dim))


def _run_of(label, ranks, ranks_1x4):
    """(arch name, decode steps, ModelCfg options, the ranks' run) of a case
    of CASES, SSM_CASES or STUB_CASES."""
    if label in CASES:
        name, opts = CASES[label]
        return name, N, opts, ranks[label]
    if label in SSM_CASES:
        name, _, n, run, opts = _ssm_run(label, ranks, ranks_1x4)
        return name, n, opts, run
    name, _, run = _stub_run(label, ranks, ranks_1x4)
    return name, N, {}, run


@pytest.mark.parametrize("label", list(CASES) + list(SSM_CASES) + list(STUB_CASES))
def test_each_rank_attends_as_a_plain_cache_would(label, ranks, ranks_1x4):
    """Each rank's part goes through the one cached route a plain cache
    takes (``lm._cached_attention``, one ``_attend_part`` per rank): a KV
    cache over its heads or whole takes the flash kernel once a layer in
    every cached forward (the prefill alone under dense decode); a ring, an
    int8 cache and a cache over its sequence never reach it."""
    from torch.distributed.tensor import Shard

    name, n, opts, run = _run_of(label, ranks, ranks_1x4)
    arch = get_reduced(name)
    k = run["placements"].get("k")  # (data, model)
    flash = (k is not None and k[1] != Shard(3) and not arch.sliding_window
             and not opts.get("kv_cache_quant"))
    forwards = 1 + (0 if opts.get("decode_dense_attn") else n)
    assert run["kernel_calls"] == (arch.num_layers * forwards if flash else 0)


def test_a_chunk_across_a_shard_boundary_lands_in_both_shards(ranks):
    """Slots 30..33 of a 64-slot cache split at 32: the "model" rank 0 takes
    30 and 31, rank 1 takes 32 and 33, each equal to the unsharded cache."""
    jparams = _case("yi-6b")[1]
    arch = get_reduced("yi-6b")
    cfg = lm.ModelCfg(dtype=torch.float32)
    params = params_from_numpy(jparams, device="cpu")
    caches = lm.init_caches(arch, cfg, B, T, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, 64, (B, sum(CHUNK))))
    P0, C = CHUNK
    lm.prefill(params, arch, cfg, caches, toks[:, :P0])
    before = caches["k"].clone()
    lm.forward_cached(params, arch, cfg, caches, toks[:, P0:], P0)
    half = T // 2
    got = ranks["chunk"]
    for (coord, prefilled), (_, chunked) in zip(*got["shards"]):
        d, m = coord
        rows = slice(d * (B // 2), (d + 1) * (B // 2))
        slots = slice(m * half, (m + 1) * half)
        np.testing.assert_allclose(prefilled, before[:, rows, :, slots].numpy(), atol=PORT_TOL)
        np.testing.assert_allclose(chunked, caches["k"][:, rows, :, slots].numpy(),
                                   atol=PORT_TOL)
        written = [s for s in range(P0, P0 + C) if m * half <= s < (m + 1) * half]
        assert written == ([30, 31] if m == 0 else [32, 33])
        for s in written:
            assert np.abs(chunked[:, :, :, s - m * half]).max() > 0
            assert not np.abs(prefilled[:, :, :, s - m * half]).any()


def test_dense_decode_over_a_sequence_split_cache_is_refused(ranks):
    """yi-6b's dense decode over its cache split over T (1 kv head on
    "model" of 2) runs, each rank over its 32 slots, and every step's logits
    equal the unsharded port's dense decode (1e-5), its tokens the unsharded
    greedy ones."""
    from torch.distributed.tensor import Shard

    got = ranks["yi-6b-seq-dense"]
    assert "error" not in got and got["placements"]["k"] == (Shard(1), Shard(3))
    want, greedy = _unsharded("yi-6b", {"decode_dense_attn": True}, got["tokens"])
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"][:, P:], greedy)


def test_an_unsharded_family_refuses_dtensors_in_the_cached_path(ranks):
    """Every family takes DTensors: reduced pixtral-12b's prefill on
    DTensors behind a frontend placed by ``batch_spec`` (4 tokens behind 8
    embeddings) equals the unsharded prefill (1e-5)."""
    arch = get_reduced("pixtral-12b")
    cfg = lm.ModelCfg(dtype=torch.float32)
    params = lm.init_params(arch, torch.Generator().manual_seed(0), torch.float32, "cpu")
    front = torch.randn((2, arch.frontend_seq, arch.hidden),
                        generator=torch.Generator().manual_seed(0))
    want, _ = lm.prefill(params, arch, cfg, lm.init_caches(arch, cfg, 2, 16, device="cpu"),
                         torch.zeros((2, 4), dtype=torch.long), frontend=front)
    got = ranks["vlm_prefill"]
    assert got.shape == (2, arch.frontend_seq + 4, arch.vocab)
    np.testing.assert_allclose(got, want.numpy(), atol=PORT_TOL, rtol=0)


def test_a_plain_frontend_beside_dtensor_tokens_is_refused():
    """On a one-rank gloo mesh: DTensor params and tokens with a plain
    frontend (or plain frames for init_caches) raise a TypeError, as plain
    tokens beside DTensor params do."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (batch_spec, distribute, make_plan, named,
                                               param_specs)

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        plan = make_plan(make_mesh((1, 1), ("data", "model"), "cpu"))
        cfg = lm.ModelCfg(dtype=torch.float32)
        for name in ("pixtral-12b", "whisper-tiny"):
            arch = get_reduced(name)
            params = lm.init_params(arch, torch.Generator().manual_seed(0), torch.float32, "cpu")
            params = distribute(params, named(plan, param_specs(arch, plan, params)))
            toks = torch.zeros((2, 4), dtype=torch.long)
            toks = distribute({"t": toks}, named(plan, batch_spec(plan, {"t": toks})))["t"]
            stub = torch.zeros((2, arch.frontend_seq or arch.encoder_seq, arch.hidden))
            with pytest.raises(TypeError, match="DTensors or plain tensors together"):
                if name == "pixtral-12b":
                    lm.prefill(params, arch, cfg, lm.init_caches(arch, cfg, 2, 16, device="cpu"),
                               toks, frontend=stub)
                else:
                    lm.init_caches(arch, cfg, 2, 16, params=params, enc_features=stub)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("label", MOE_LABELS)
def test_sharded_moe_tokens_equal_the_jax_engines(label, ranks):
    """The JAX ``ServeEngine``'s greedy decode from the same prompts (its
    prefill and decode steps at the same chunk sizes, so the same drops)."""
    from repro.serve import ServeEngine as JaxEngine

    name, _ = CASES[label]
    jarch, jparams, prompts, _ = _case(name)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
    want = JaxEngine(jarch, jcfg, jparams, max_len=T).generate(prompts, max_new_tokens=N)
    np.testing.assert_array_equal(ranks[label]["tokens"], np.asarray(want.tokens))


def _ssm_run(label, ranks, ranks_1x4):
    name, mesh, p, n, opts = _ssm_case(label)
    return name, p, n, (ranks if mesh == (2, 2) else ranks_1x4)[label], opts


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_and_hybrid_cached_paths_match_the_unsharded_port(label, ranks, ranks_1x4):
    name, p, n, got, opts = _ssm_run(label, ranks, ranks_1x4)
    want, greedy = _unsharded(name, opts, got["tokens"], P=p, N=n)
    assert len(got["logits"]) == n + 1
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"][:, p:], greedy)


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_and_hybrid_cached_paths_match_jax(label, ranks, ranks_1x4):
    name, p, n, got, opts = _ssm_run(label, ranks, ranks_1x4)
    want = _jax_logits(name, got["tokens"], p, n, opts)
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=JAX_TOL, rtol=0, err_msg=f"step {step}")


def _placements_of_cache_specs(arch, mesh, caches) -> dict:
    from repro_torch.parallel.sharding import MeshShape, cache_specs, make_plan, placements

    specs = cache_specs(arch, make_plan(MeshShape(mesh, ("data", "model"))), caches)

    class Mesh:  # placements() reads the dim names only
        mesh_dim_names = ("data", "model")

    return {k: placements(Mesh, spec) for k, spec in specs.items()}


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_and_hybrid_caches_lie_as_cache_specs_place_them(label, ranks, ranks_1x4):
    name, p, n, run, _ = _ssm_run(label, ranks, ranks_1x4)
    mesh = _ssm_case(label)[1]
    got = run["placements"]
    arch = get_reduced(name)
    caches = lm.init_caches(arch, lm.ModelCfg(dtype=torch.float32), B, T, device="meta")
    assert got == _placements_of_cache_specs(arch, mesh, caches)
    if mesh == (1, 4) and "k" in got:  # 2 kv heads do not split 4 ways: T does
        from torch.distributed.tensor import Shard

        assert got["k"][1] == Shard(3) and caches["k"].shape[3] // 4 == 8


def _stub_run(label, ranks, ranks_1x4):
    name, mesh = STUB_CASES[label]
    return name, mesh, (ranks if mesh == (2, 2) else ranks_1x4)[label]


@pytest.mark.parametrize("label", list(STUB_CASES))
def test_encdec_and_vlm_cached_paths_match_the_unsharded_port(label, ranks, ranks_1x4):
    name, _, got = _stub_run(label, ranks, ranks_1x4)
    want, greedy = _unsharded(name, {}, got["tokens"])
    assert len(got["logits"]) == N + 1
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"][:, P:], greedy)


@pytest.mark.parametrize("label", list(STUB_CASES))
def test_encdec_and_vlm_cached_paths_match_jax(label, ranks, ranks_1x4):
    """Every step's logits against the JAX package's prefill and decode
    steps (1e-4), and the tokens against the JAX ``ServeEngine``'s greedy
    decode from the same prompts, frames and frontend."""
    name, _, got = _stub_run(label, ranks, ranks_1x4)
    for step, (g, w) in enumerate(zip(got["logits"], _jax_logits(name, got["tokens"]))):
        np.testing.assert_allclose(g, w, atol=JAX_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"], _jax_engine_tokens(name))


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens(name: str) -> np.ndarray:
    from repro.serve import ServeEngine as JaxEngine

    jarch, jparams, prompts, extra = _case(name)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
    want = JaxEngine(jarch, jcfg, jparams, max_len=T).generate(
        prompts, max_new_tokens=N, **{k: jnp.asarray(v) for k, v in extra.items()})
    return np.asarray(want.tokens)


@pytest.mark.parametrize("label", list(STUB_CASES))
def test_init_caches_on_dtensor_params_places_every_leaf_as_cache_specs(label, ranks,
                                                                         ranks_1x4):
    """whisper's cache from ``init_caches`` on DTensor params (its frames
    placed by ``batch_spec``) and pixtral's: every leaf, the cross K/V
    included, in ``cache_specs``' placements. whisper's 4 heads split over
    "model" on both meshes; pixtral's 2 put its cache over T on (1, 4)."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch.specs import cache_structs

    name, mesh, got = _stub_run(label, ranks, ranks_1x4)
    arch = get_reduced(name)
    caches = cache_structs(arch, lm.ModelCfg(dtype=torch.float32), B, T)  # init_caches' shapes
    assert got["placements"] == _placements_of_cache_specs(arch, mesh, caches)
    heads = Shard(2) if arch.kv_heads % mesh[1] == 0 else Shard(3)
    assert got["placements"]["k"][1] == heads
    if arch.family == "encdec":
        assert got["placements"]["enc_k"][1] == Shard(2)
