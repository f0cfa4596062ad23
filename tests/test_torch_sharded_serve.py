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
ranks' shards as on a plain cache, but dense decode attention over a cache
split over T, which is refused with the option's name.

The ssm and hybrid families: reduced mamba2-370m (conv and state caches over
"model" by channels and heads) and hymba-1.5b (a 32-slot ring for its window
of 32) on the (2, 2) mesh, where hymba's 2 kv heads split, and hymba on a
(1, 4) mesh, where they do not: there the ring's T lies over "model", 8
slots a rank, as at production. Each hymba layout runs a prompt of 24 and 16
decode steps that wrap the ring at 32, and a prompt of 40 > 32 (the ring
prefill, each rank writing its slots of the last 32 positions) and 8 decode
steps. Every step's logits are held against the unsharded port (1e-5) and
the JAX package (1e-4), and the caches lie as ``cache_specs`` places them.

The moe family: reduced granite-moe-3b-a800m (8 experts, top-2) and
llama4-scout-17b-a16e (4, top-1, a shared expert) on the (2, 2) mesh, their
experts over "data", at the default capacity factor 1.25: C comes from the
chunk's global B x S (80 tokens in the prefill, 2 in a decode step), so the
sharded run drops what the unsharded one and the JAX package drop. Each run's
logits are held as the dense cases' are, and its tokens against the JAX
``ServeEngine``'s greedy tokens.
"""
import dataclasses

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
# label -> (arch, mesh, prompt length, decode steps): the ssm and hybrid cases
SSM_CASES = {
    "mamba2-2x2": ("mamba2-370m", (2, 2), 40, 8),
    "hymba-heads-wrap": ("hymba-1.5b", (2, 2), 24, 16),
    "hymba-heads-ring-prefill": ("hymba-1.5b", (2, 2), 40, 8),
    "hymba-seq-wrap": ("hymba-1.5b", (1, 4), 24, 16),
    "hymba-seq-ring-prefill": ("hymba-1.5b", (1, 4), 40, 8),
}


def _case(name: str, seed: int = 0, P: int = P):
    jarch = jax_reduced(name)
    jparams = jax.device_get(jlm.init_params(jarch, jax.random.PRNGKey(seed)))
    prompts = np.random.default_rng(seed + 1).integers(0, jarch.vocab, (B, P)).astype(np.int32)
    return jarch, jparams, prompts


def _ssm_cases(mesh):
    return [(label, name, *_case(name, P=p)[1:], n, T, {})
            for label, (name, m, p, n) in SSM_CASES.items() if m == mesh]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cached")
    cases = [(label, name, _case(name)[1], _case(name)[2], N, T, opts)
             for label, (name, opts) in CASES.items()]
    toks = np.random.default_rng(7).integers(0, 64, (B, sum(CHUNK)))
    torch_ranks.run_ranks(torch_ranks.cached_program, 4, tmp, str(tmp / "out.pt"), (2, 2),
                          cases + _ssm_cases((2, 2)),
                          (_case("yi-6b")[1], CHUNK[0], CHUNK[1], T, toks))
    return torch.load(tmp / "out.pt", weights_only=False)


@pytest.fixture(scope="module")
def ranks_1x4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cached_1x4")
    torch_ranks.run_ranks(torch_ranks.cached_program, 4, tmp, str(tmp / "out.pt"), (1, 4),
                          _ssm_cases((1, 4)), None)
    return torch.load(tmp / "out.pt", weights_only=False)


def _unsharded(name: str, opts: dict, got_tokens, P: int = P, N: int = N):
    """The port on plain tensors, teacher-forced with the sharded run's
    tokens: every step's logits and the greedy tokens."""
    _, jparams, prompts = _case(name, P=P)
    arch = get_reduced(name)
    cfg = lm.ModelCfg(dtype=torch.float32, **opts)
    params = params_from_numpy(jparams, device="cpu")
    caches = lm.init_caches(arch, cfg, B, T, device="cpu")
    seq = torch.as_tensor(got_tokens).long()
    logits, _ = lm.prefill(params, arch, cfg, caches, seq[:, :P])
    steps, greedy = [logits.numpy()], [logits[:, -1].argmax(-1)]
    for i in range(N):
        logits, _ = lm.decode_step(params, arch, cfg, caches, seq[:, P + i:P + i + 1], P + i)
        steps.append(logits.numpy())
        greedy.append(logits[:, -1].argmax(-1))
    return steps, torch.stack(greedy[:-1], 1).numpy()


@pytest.mark.parametrize("label", [k for k in CASES if k != "yi-6b-seq-dense"])
def test_sharded_cached_path_matches_the_unsharded_port(label, ranks):
    name, opts = CASES[label]
    got = ranks[label]
    want, greedy = _unsharded(name, opts, got["tokens"])
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"][:, P:], greedy)


@pytest.mark.parametrize("label", ["yi-6b-seq", "qwen3-8b-heads"] + MOE_LABELS)
def test_sharded_cached_path_matches_jax(label, ranks):
    name, _ = CASES[label]
    jarch, jparams, prompts = _case(name)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
    got = ranks[label]
    caches = jlm.init_caches(jarch, jcfg, B, T)
    logits, caches = jlm.prefill(jparams, jarch, jcfg, caches, jnp.asarray(prompts))
    np.testing.assert_allclose(got["logits"][0], np.asarray(logits), atol=JAX_TOL, rtol=0)
    for i in range(N):
        tok = jnp.asarray(got["tokens"][:, P + i:P + i + 1], jnp.int32)
        logits, caches = jlm.decode_step(jparams, jarch, jcfg, caches, tok, P + i)
        np.testing.assert_allclose(got["logits"][i + 1], np.asarray(logits), atol=JAX_TOL,
                                   rtol=0, err_msg=f"decode step {i}")


@pytest.mark.parametrize("label,dim", [("yi-6b-seq", 3), ("qwen3-8b-heads", 2),
                                       ("yi-6b-repeat2-heads", 2)])
def test_the_cache_lies_over_model_as_cache_specs_place_it(label, dim, ranks):
    from torch.distributed.tensor import Shard

    # (L, B, Hkv, T, D): B over "data", the heads or T over "model"
    assert ranks[label]["placements"]["k"] == (Shard(1), Shard(dim))


def test_a_chunk_across_a_shard_boundary_lands_in_both_shards(ranks):
    """Slots 30..33 of a 64-slot cache split at 32: the "model" rank 0 takes
    30 and 31, rank 1 takes 32 and 33, each equal to the unsharded cache."""
    _, jparams, _ = _case("yi-6b")
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
    assert "decode_dense_attn" in ranks["yi-6b-seq-dense"]["error"]


def test_an_unsharded_family_refuses_dtensors_in_the_cached_path(ranks):
    msg = ranks["unsharded_family"]
    assert "vlm family takes no DTensor" in msg and "dense, moe, ssm, hybrid" in msg


@pytest.mark.parametrize("label", MOE_LABELS)
def test_sharded_moe_tokens_equal_the_jax_engines(label, ranks):
    """The JAX ``ServeEngine``'s greedy decode from the same prompts (its
    prefill and decode steps at the same chunk sizes, so the same drops)."""
    from repro.serve import ServeEngine as JaxEngine

    name, _ = CASES[label]
    jarch, jparams, prompts = _case(name)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
    want = JaxEngine(jarch, jcfg, jparams, max_len=T).generate(prompts, max_new_tokens=N)
    np.testing.assert_array_equal(ranks[label]["tokens"], np.asarray(want.tokens))


def _ssm_run(label, ranks, ranks_1x4):
    name, mesh, p, n = SSM_CASES[label]
    return name, p, n, (ranks if mesh == (2, 2) else ranks_1x4)[label]


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_and_hybrid_cached_paths_match_the_unsharded_port(label, ranks, ranks_1x4):
    name, p, n, got = _ssm_run(label, ranks, ranks_1x4)
    want, greedy = _unsharded(name, {}, got["tokens"], P=p, N=n)
    assert len(got["logits"]) == n + 1
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(g, w, atol=PORT_TOL, rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(got["tokens"][:, p:], greedy)


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_and_hybrid_cached_paths_match_jax(label, ranks, ranks_1x4):
    name, p, n, got = _ssm_run(label, ranks, ranks_1x4)
    jarch, jparams, prompts = _case(name, P=p)
    jcfg = jlm.ModelCfg(dtype=jnp.float32, attn_impl="xla", ssm_impl="xla")
    caches = jlm.init_caches(jarch, jcfg, B, T)
    logits, caches = jlm.prefill(jparams, jarch, jcfg, caches, jnp.asarray(prompts))
    np.testing.assert_allclose(got["logits"][0], np.asarray(logits), atol=JAX_TOL, rtol=0)
    for i in range(n):
        tok = jnp.asarray(got["tokens"][:, p + i:p + i + 1], jnp.int32)
        logits, caches = jlm.decode_step(jparams, jarch, jcfg, caches, tok, p + i)
        np.testing.assert_allclose(got["logits"][i + 1], np.asarray(logits), atol=JAX_TOL,
                                   rtol=0, err_msg=f"decode step {i}")


@pytest.mark.parametrize("label", list(SSM_CASES))
def test_ssm_and_hybrid_caches_lie_as_cache_specs_place_them(label, ranks, ranks_1x4):
    from repro_torch.parallel.sharding import MeshShape, cache_specs, make_plan, placements

    name, mesh, _, _ = SSM_CASES[label]
    got = _ssm_run(label, ranks, ranks_1x4)[3]["placements"]
    arch = get_reduced(name)
    cfg = lm.ModelCfg(dtype=torch.float32)
    caches = lm.init_caches(arch, cfg, B, T, device="meta")
    specs = cache_specs(arch, make_plan(MeshShape(mesh, ("data", "model"))), caches)

    class Mesh:  # placements() reads the dim names only
        mesh_dim_names = ("data", "model")

    assert got == {k: placements(Mesh, spec) for k, spec in specs.items()}
    if mesh == (1, 4) and "k" in got:  # 2 kv heads do not split 4 ways: T does
        from torch.distributed.tensor import Shard

        assert got["k"][1] == Shard(3) and caches["k"].shape[3] // 4 == 8
