"""The RMSNorm wrapper's row layouts on the CPU: which views the kernels read
in place (``row_layout``, ``_plan``), the plain path on such a view against
the JAX kernel, and the views the model hands the norm.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
to ``ref.rmsnorm`` there, on these views too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm  # noqa: E402
from repro_torch.configs import get_arch, get_reduced  # noqa: E402
from repro_torch.kernels.rmsnorm import _plan, rmsnorm_fwd, row_layout  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

# as tests/test_torch_kernels.py: f32 2e-5; bf16 2e-2 plus one bf16 ulp
_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qk_views(B, S, H, Hkv, D, dtype=torch.float32, fused=None):
    """q and k as the attention sub-layer takes them: heads of one fused
    (B, S, (H + 2 Hkv) D) projection output."""
    if fused is None:
        fused = torch.arange(B * S * (H + 2 * Hkv) * D, dtype=torch.float32)
        fused = fused.reshape(B, S, -1).to(dtype)
    q, k, _ = torch.split(fused, [H * D, Hkv * D, Hkv * D], dim=-1)
    return q.reshape(B, S, H, D), k.reshape(B, S, Hkv, D)


def _rows_by_layout(x):
    """x's rows read from its storage where row_layout says they start."""
    n0, n1, s0, s1 = row_layout(x)
    D = x.shape[-1]
    base = x.as_strided((x.untyped_storage().nbytes() // x.element_size(),), (1,), 0)
    rows = []
    for r in range(n0 * n1):
        start = x.storage_offset() + (r // n1) * s0 + (r % n1) * s1
        rows.append(base[start:start + D])
    return torch.stack(rows)


_HEADS = {"reduced": (8, 2, 16), "full": (32, 8, 128)}  # qwen3-8b: H, Hkv, head_dim


def test_head_layouts_are_qwen3s():
    for which, arch in (("reduced", get_reduced("qwen3-8b")), ("full", get_arch("qwen3-8b"))):
        assert _HEADS[which] == (arch.heads, arch.kv_heads, arch.head_dim)


@pytest.mark.parametrize("which", sorted(_HEADS))
@pytest.mark.parametrize("view", ["q", "k"])
@pytest.mark.parametrize("B,S", [(2, 12), (1, 7), (4, 1), (1, 1)])
def test_row_layout_reads_the_fused_qk_views(which, view, B, S):
    H, Hkv, D = _HEADS[which]
    q, k = _qk_views(B, S, H, Hkv, D)
    x, heads = (q, H) if view == "q" else (k, Hkv)
    W = (H + 2 * Hkv) * D
    assert x.is_contiguous() == (B * S == 1)  # one token's heads lie side by side
    want = (B * S, heads, W, D) if B * S > 1 else (1, heads, 0, D)
    assert row_layout(x) == want
    torch.testing.assert_close(_rows_by_layout(x), x.reshape(-1, D), rtol=0, atol=0)
    for dtype in (torch.float32, torch.bfloat16):
        xq, xk = _qk_views(B, S, H, Hkv, D, dtype)
        assert _plan(xq if view == "q" else xk, torch.ones(D, dtype=dtype))[0] == "vector"


def _refused(case):
    if case == "last_dim":  # heads with the head dim strided
        return torch.zeros(2, 16, 4).transpose(1, 2)
    if case == "three_levels":  # a crop in three dims: no two steps merge
        return torch.zeros(4, 6, 5, 8)[:, :4, :3, :]
    if case == "row_stride":  # bf16 rows 66 elements (132 bytes) apart
        return torch.zeros(12, 66, dtype=torch.bfloat16)[:, :64]
    if case == "base_pointer":  # the q view of a fused row one element off the grid
        buf = torch.zeros(2 * 4 * 48 * 16 + 1, dtype=torch.bfloat16)[1:]
        return _qk_views(2, 4, 32, 8, 16, torch.bfloat16, fused=buf.view(2, 4, 48 * 16))[0]
    if case == "width":  # a strided view whose rows are not whole vectors
        return torch.zeros(6, 40, dtype=torch.bfloat16)[:, :20]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["last_dim", "three_levels", "row_stride", "base_pointer",
                                  "width"])
def test_plan_refuses_views_it_cannot_read(case):
    x = _refused(case)
    with pytest.raises(ValueError):
        _plan(x, torch.ones(x.shape[-1], dtype=x.dtype))
    if case in ("last_dim", "three_levels"):
        with pytest.raises(ValueError):
            row_layout(x)


@pytest.mark.parametrize("shape,offset,dtype,path", [
    ((3, 100), 0, torch.bfloat16, "scalar"),    # width off the vector
    ((5, 64), 1, torch.bfloat16, "scalar"),     # base one element off the grid
    ((2, 3, 64), 0, torch.bfloat16, "vector"),
    ((7, 12), 0, torch.float32, "vector"),      # 3 f32 vectors a row
    ((2, 10), 2, torch.float32, "scalar"),
    ((1, 4, 4097 * 8), 0, torch.bfloat16, "scalar"),  # more vectors than the kernel holds
    ((4, 4096 * 8), 0, torch.bfloat16, "vector"),
    ((2, 4096 * 4), 0, torch.float32, "vector"),
])
def test_plan_takes_contiguous_rows_of_any_width(shape, offset, dtype, path):
    n = int(np.prod(shape))
    x = torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    assert _plan(x, torch.ones(shape[-1], dtype=dtype))[0] == path
    assert row_layout(x) == (1, n // shape[-1], 0, shape[-1])


@pytest.mark.parametrize("view", ["q", "k"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_path_on_a_view_matches_jax_kernel(view, dtype):
    B, S, (H, Hkv, D) = 2, 12, _HEADS["reduced"]
    rng = np.random.default_rng(11)
    fused = rng.standard_normal((B, S, (H + 2 * Hkv) * D)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    q, k = _qk_views(B, S, H, Hkv, D, fused=torch.from_numpy(fused).to(_TORCH[dtype]))
    x = q if view == "q" else k
    tw = torch.from_numpy(w).to(_TORCH[dtype])
    got = rmsnorm_fwd(x, tw)
    assert got.shape == x.shape and got.dtype == _TORCH[dtype]
    x_np = x.float().numpy().reshape(-1, D)  # the same numbers, rows stacked
    want = jax_rmsnorm(jnp.asarray(x_np, _JNP[dtype]), jnp.asarray(w, _JNP[dtype]),
                       block_rows=8)
    atol, rtol = _TOL[dtype]
    np.testing.assert_allclose(got.float().numpy().reshape(-1, D),
                               np.asarray(jnp.asarray(want, jnp.float32)), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_hands_the_norm_views_the_vector_kernel_reads(monkeypatch, dtype):
    """The reduced qwen3 forward, prefill and decode: every q/k norm gets a
    strided view of the fused product (no copy before it), and every norm
    input is one the vector kernel takes in place."""
    arch = get_reduced("qwen3-8b")
    params = lm.init_params(arch, torch.Generator().manual_seed(0), dtype, "cpu")
    cfg = lm.ModelCfg(dtype=dtype)
    seen = []
    norm = L.norm

    def spy(x, w, impl="cuda"):
        seen.append((x.is_contiguous(), _plan(x, w)))
        return norm(x, w, impl=impl)

    monkeypatch.setattr(L, "norm", spy)
    toks = torch.randint(0, arch.vocab, (2, 6), generator=torch.Generator().manual_seed(1))
    lm.forward_logits(params, arch, cfg, {"tokens": toks})
    caches = lm.init_caches(arch, cfg, 2, 8, device="cpu")
    _, caches = lm.prefill(params, arch, cfg, caches, toks[:, :5])
    lm.decode_step(params, arch, cfg, caches, toks[:, 5:6], 5)
    per_pass = 4 * arch.num_layers + 1
    assert len(seen) == 3 * per_pass
    views = [layout for contiguous, (_, layout) in seen if not contiguous]
    assert len(views) == 3 * 2 * arch.num_layers  # q and k of every layer
    assert all(path == "vector" for _, (path, _) in seen)
    W = (arch.heads + 2 * arch.kv_heads) * arch.head_dim
    assert all(layout[2:] == (W, arch.head_dim) for layout in views)
