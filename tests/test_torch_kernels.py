"""The port's kernel modules against the JAX package's, on the CPU.

Same inputs (numpy, seeded) go to both sides; the JAX Pallas kernels run in
interpret mode, as tests/test_kernels.py runs them. On a CPU tensor the port's
wrappers take their plain versions, so these tests hold the plain versions to
the JAX kernels; the CUDA kernels are held to the same plain versions on the
card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm  # noqa: E402
from repro.kernels.xla_flash import flash_xla as jax_flash_xla  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_fwd  # noqa: E402
from repro_torch.kernels.xla_flash import flash_xla  # noqa: E402

# f32: 2e-5, as tests/test_kernels.py. bf16: 2e-2 as there, plus one bf16 ulp
# (2^-7 of the value): both sides round the same f32 math once, and f32 results
# that differ in the last bits can straddle a bf16 rounding midpoint.
_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, dtype=_JNP[dtype]), torch.from_numpy(a).to(_TORCH[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype: str):
    atol, rtol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("D", [16, 128, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_kernel(D, dtype):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((3, 7, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    got = rmsnorm_fwd(tx, tw)
    assert got.dtype == _TORCH[dtype] and got.shape == tx.shape
    _assert_close(got, jax_rmsnorm(jx, jw, block_rows=8), dtype)
    _assert_close(got, jref.rmsnorm(jx, jw), dtype)


def _qkv(B, Hq, Hkv, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


# the cases of tests/test_kernels.py::test_pallas_flash_vs_oracle
_FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True),
    (2, 8, 2, 256, 256, 64, True),     # GQA
    (1, 4, 2, 200, 200, 128, True),    # uneven blocks
    (2, 2, 1, 128, 128, 32, False),    # MQA, non-causal
    (2, 8, 2, 1, 300, 64, True),       # decode: 1 query vs long KV
]


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,causal", _FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_kernel(B, Hq, Hkv, S, T, D, causal, dtype):
    q, k, v = _qkv(B, Hq, Hkv, S, T, D)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    out, lse = flash_attention_fwd(tq, tk, tv, causal=causal)
    jout, jlse = jax_flash(jq, jk, jv, causal=causal)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    _assert_close(out, jout, dtype)
    # lse is f32 math on both sides from the same inputs
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=2e-5, rtol=2e-6)
    _assert_close(ops.flash_attention(tq, tk, tv, causal=causal, impl="torch"),
                  jref.attention(jq, jk, jv, causal=causal), dtype)


def test_flash_plain_rejects_negative_causal_offset():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 4, 16))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_fwd(q, k, v, causal=True)
    out, _ = flash_attention_fwd(q, k, v, causal=False)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("S,T,block,causal,q_start,valid", [
    (200, 200, 64, True, None, None),
    (128, 128, 512, True, None, None),
    (100, 100, 32, False, None, None),
    (1, 256, 64, True, 150, 151),      # as test_xla_flash_cached_partial_validity
    (3, 256, 64, True, 20, 23),        # a chunk written at 20 into a longer cache
])
def test_flash_xla_matches_jax(S, T, block, causal, q_start, valid):
    q, k, v = _qkv(2, 4, 2, S, T, 32, seed=S + T)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in (q, k, v))
    got = flash_xla(tq, tk, tv, q_start=q_start, kv_valid_len=valid, causal=causal,
                    block=block)
    want = jax_flash_xla(jq, jk, jv, q_start=q_start, kv_valid_len=valid,
                         causal=causal, block=block)
    _assert_close(got, want, "float32")


def test_flash_xla_ring_is_not_ported():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 1, 8, 16))
    with pytest.raises(NotImplementedError):
        flash_xla(q, k, v, ring=True)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.ones(64)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 16, 16))
    n_norm, n_flash = rmsnorm_fwd.launches, flash_attention_fwd.launches
    torch.testing.assert_close(ops.fused_rmsnorm(x, w, impl="cuda"), ref.rmsnorm(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.flash_attention(q, k, v, impl="cuda"),
                               ref.attention(q, k, v), rtol=1e-6, atol=1e-6)
    assert (rmsnorm_fwd.launches, flash_attention_fwd.launches) == (n_norm, n_flash)


def test_kernel_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        rmsnorm_fwd(torch.ones(4, 8), torch.ones(7))
    with pytest.raises(ValueError):
        flash_attention_fwd(torch.ones(1, 3, 4, 16), torch.ones(1, 2, 4, 16),
                            torch.ones(1, 2, 4, 16))
    with pytest.raises(ValueError):
        ops.fused_rmsnorm(torch.ones(2, 4), torch.ones(4), impl="pallas")


@pytest.mark.parametrize("op", ["rmsnorm", "flash"])
def test_kernel_backward_raises(op):
    rng = np.random.default_rng(1)
    if op == "rmsnorm":
        x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32)).requires_grad_()
        y = ops.fused_rmsnorm(x, torch.ones(32), impl="cuda")
    else:
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 16))
        x = q.requires_grad_()
        y = ops.flash_attention(x, k, v, impl="cuda")
    assert y.grad_fn is not None
    with pytest.raises(NotImplementedError, match="training slice"):
        y.sum().backward()
