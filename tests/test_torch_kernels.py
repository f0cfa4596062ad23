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
from torch_threads import pin_threads  # noqa: E402

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm  # noqa: E402
from repro.kernels.ssd import ssd_scan_fwd as jax_ssd  # noqa: E402
from repro.kernels.xla_flash import flash_xla as jax_flash_xla  # noqa: E402
from repro.kernels.xla_flash import flash_xla_train as jax_flash_xla_train  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS, _plan, _plan_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_fwd  # noqa: E402
from repro_torch.kernels.ssd import DEFAULT_CHUNK, ssd_scan_fwd  # noqa: E402
from repro_torch.kernels.ssd import _plan as _ssd_plan  # noqa: E402
from repro_torch.kernels.xla_flash import flash_xla, flash_xla_train  # noqa: E402

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
    # head sizes of the JAX package's configs beyond the cases above:
    # whisper-tiny reduced (24), qwen3-32b (80), pixtral-12b (160)
    (1, 4, 2, 160, 160, 24, True),
    (1, 4, 2, 130, 200, 80, True),     # S < T: q_offset 70
    (1, 2, 1, 96, 96, 160, False),
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


def _tensor_core_emulation(q, k, v, *, causal, block_k=64):
    """The bf16 flash kernel's arithmetic in f32 torch: key tiles of 64, an
    online softmax with f32 row statistics, and P rounded to bf16 before P V
    (the one rounding the plain version does not make). Queries are the last
    S of the T keys."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    m = torch.full((B, Hq, S), -1e30)
    l = torch.zeros((B, Hq, S))
    acc = torch.zeros((B, Hq, S, D))
    q_pos = torch.arange(S) + (T - S)
    for k0 in range(0, T, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bhsd,bhtd->bhst", qf, kt) / np.sqrt(D)
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[2])
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhst,bhtd->bhsd", p.to(torch.bfloat16).float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16), m + torch.log(l)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,causal", [
    (1, 4, 1, 256, 256, 128, True),
    (1, 4, 2, 200, 256, 80, True),
])
def test_tensor_core_rounding_fits_the_bf16_bound(B, Hq, Hkv, S, T, D, causal):
    """The bf16 kernel's design, emulated, against the JAX kernel on the same
    bf16 inputs: out within the bf16 kernel tolerance, lse within the 1e-4
    that chip_smoke.py holds the kernel's lse to."""
    q, k, v = _qkv(B, Hq, Hkv, S, T, D, seed=D)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    out, lse = _tensor_core_emulation(tq, tk, tv, causal=causal)
    jout, jlse = jax_flash(jq, jk, jv, causal=causal)
    _assert_close(out, jout, "bfloat16")
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=1e-4, rtol=0)
    # the P rounding is real: the emulation is not the plain version
    plain, _ = flash_attention_fwd(tq, tk, tv, causal=causal)
    assert float((out.float() - plain.float()).abs().max()) > 0


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plan_picks_the_path_by_dtype(D, dtype):
    """bf16 takes the tensor cores, f32 the CUDA cores, at every head size and
    on the model's head-transposed views of one projection output."""
    B, S, Hq, Hkv = 2, 16, 4, 2
    qkv = torch.zeros(B, S, (Hq + 2 * Hkv) * D, dtype=_TORCH[dtype])
    q, k, v = torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1)
    q, k, v = (t.reshape(B, S, -1, D).transpose(1, 2) for t in (q, k, v))
    assert _plan(q, k, v) == ("tensor_cores" if dtype == "bfloat16" else "cuda_cores")


def _buf(shape, dtype=torch.bfloat16, offset=0, width=None):
    """A zero tensor of `shape` whose data starts `offset` elements into its
    buffer and whose rows are `width` elements apart (default: the last dim)."""
    width = width or shape[-1]
    n = int(np.prod(shape[:-1])) * width
    t = torch.zeros(n + offset, dtype=dtype)[offset:].view(*shape[:-1], width)
    return t[..., :shape[-1]]


_SHAPE = (1, 2, 8, 64)


@pytest.mark.parametrize("case", ["head_dim", "base_pointer", "row_stride", "last_dim",
                                  "dtype"])
def test_flash_plan_rejects(case):
    def operands(dtype):
        q = k = v = _buf(_SHAPE, dtype)
        if case == "head_dim":
            q = k = v = _buf((1, 2, 8, 48), dtype)
        elif case == "base_pointer":  # one element past a 16-byte boundary
            k = _buf(_SHAPE, dtype, offset=1)
        elif case == "row_stride":  # rows 66 elements apart: 132 bytes in bf16
            v = _buf(_SHAPE, dtype, width=66)
        elif case == "last_dim":
            q = _buf((1, 2, 64, 8), dtype).transpose(2, 3)
        elif case == "dtype":
            q = q.float()
        return q, k, v

    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        _plan(*operands(torch.bfloat16))
    # the f32 kernel copies no 16-byte chunks: it takes unaligned operands
    if case in ("base_pointer", "row_stride"):
        assert _plan(*operands(torch.float32)) == "cuda_cores"


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


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,causal,block", [
    (2, 4, 2, 200, 200, 32, True, 64),     # T not a multiple of the block, GQA
    (1, 8, 2, 130, 130, 16, False, 64),    # groups of 4, not causal
    (2, 4, 4, 64, 64, 32, True, 512),      # one block longer than T
    (1, 4, 1, 40, 100, 32, True, 32),      # S < T: the queries are the last S keys
])
def test_flash_xla_train_matches_jax(B, Hq, Hkv, S, T, D, causal, block):
    """Out and the grads of q, k and v (the blockwise-recompute backward,
    the kv heads' grads summed over their groups) against the JAX custom_vjp
    on one cotangent, f32; grads by 1e-5 of their value too, as
    test_kernel_backward_matches_jax_grad."""
    q = np.random.default_rng(S).standard_normal((B, Hq, S, D)).astype(np.float32)
    _, k, v = _qkv(B, Hq, Hkv, S, T, D, seed=T + 1)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_xla_train(q_, k_, v_, causal, None, block),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_xla_train(*inputs, causal=causal, block=block)
    _assert_close(out.detach(), out_j, "float32")
    _assert_close(out.detach(), ref.attention(*inputs, causal=causal).detach(), "float32")
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for t, w in zip(got, want):
        assert t.shape == w.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_flash_xla_train_is_the_xla_impl():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 4, 2, 16, 16, 16))
    out = ops.flash_attention(q, k, v, impl="xla")
    assert type(out.grad_fn).__name__ == "_FlashXlaTrainBackward"
    torch.testing.assert_close(out, flash_xla_train(q, k, v), rtol=0, atol=0)


def test_flash_xla_ring_is_not_ported():
    """(The name is the one this test had while the port refused rings.)
    Once the ring has wrapped, every slot is live and no causal mask
    applies: the result is attention over all T slots in any order. Before,
    the ring mask is the plain causal one with kv_valid_len."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 1, 8, 16))
    perm = torch.randperm(8, generator=torch.Generator().manual_seed(0))
    full = ref.attention(q, k, v, causal=False)
    for q_start in (8, 13):
        got = flash_xla(q, k[:, :, perm], v[:, :, perm], q_start=q_start,
                        kv_valid_len=q_start + 1, ring=True)
        torch.testing.assert_close(got, full, rtol=0, atol=2e-6)
    torch.testing.assert_close(flash_xla(q, k, v, q_start=4, kv_valid_len=5, ring=True),
                               flash_xla(q, k, v, q_start=4, kv_valid_len=5), rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.ones(64)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 16, 16))
    s_in = [torch.from_numpy(a) for a in _ssd_inputs(1, 16, 2, 8, 4)]
    counters = (rmsnorm_fwd, flash_attention_fwd, ssd_scan_fwd)
    before = [c.launches for c in counters]
    torch.testing.assert_close(ops.fused_rmsnorm(x, w, impl="cuda"), ref.rmsnorm(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.flash_attention(q, k, v, impl="cuda"),
                               ref.attention(q, k, v), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ops.ssd(*s_in, impl="cuda"), ref.ssd_scan(*s_in),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.ssd_with_state(*s_in, impl="cuda"),
                               ref.ssd_scan(*s_in, return_state=True), rtol=0, atol=0)
    assert [c.launches for c in counters] == before


def test_kernel_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        rmsnorm_fwd(torch.ones(4, 8), torch.ones(7))
    with pytest.raises(ValueError):
        flash_attention_fwd(torch.ones(1, 3, 4, 16), torch.ones(1, 2, 4, 16),
                            torch.ones(1, 2, 4, 16))
    with pytest.raises(ValueError):
        ops.fused_rmsnorm(torch.ones(2, 4), torch.ones(4), impl="pallas")
    with pytest.raises(ValueError):  # dt (B, S, H) does not match x
        ssd_scan_fwd(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 3), torch.ones(2),
                     torch.ones(1, 4, 4), torch.ones(1, 4, 4))
    with pytest.raises(ValueError):
        ssd_scan_fwd(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2), torch.ones(2),
                     torch.ones(1, 4, 4), torch.ones(1, 4, 4), chunk=0)
    with pytest.raises(ValueError):
        ops.ssd(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2), torch.ones(2),
                torch.ones(1, 4, 4), torch.ones(1, 4, 4), impl="naive")


# ---------------------------------------------------------------------------
# flash attention backward: the plain version of the bf16 kernel
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, S, T, D, causal): groups of 1, 3 and 8, S = T and S < T,
# ragged S and T, and every head size
_BWD_CASES = [
    (1, 4, 4, 64, 64, 64, True),
    (2, 6, 2, 96, 96, 32, True),
    (1, 8, 1, 80, 80, 128, False),
    (1, 3, 1, 65, 1500, 64, True),
    (1, 3, 1, 65, 1500, 64, False),
    (1, 8, 1, 1, 77, 64, True),
    *((1, 4, 2, 70, 130, D, True) for D in HEAD_DIMS),
    *((2, 3, 3, 33, 33, D, False) for D in HEAD_DIMS),
]


def _attention_grads(q, k, v, g, causal):
    """torch.autograd.grad of the plain attention: what the plain VJP gives."""
    x = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(ref.attention(*x, causal=causal), x, g)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,causal", _BWD_CASES)
def test_flash_bwd_plain_matches_autograd(B, Hq, Hkv, S, T, D, causal):
    """The flash formulas (P from the saved lse, delta from the saved out, the
    group's sum for dk and dv) give the plain attention's gradients in f32,
    within the JAX tests' 2e-5; the wrapper runs them on CPU tensors and
    counts no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, Hq, Hkv, S, T, D, seed=S + D))
    g = torch.from_numpy(np.random.default_rng(T).standard_normal(q.shape).astype(np.float32))
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal)
    assert flash_attention_bwd.launches == before
    for a, b, t in zip(got, _attention_grads(q, k, v, g, causal), (q, k, v)):
        assert a.shape == t.shape and a.dtype == t.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)


def _bwd_kernel_emulation(q, k, v, out, lse, dout, causal):
    """The bf16 backward kernel's arithmetic in f32 torch: products of bf16
    operands summed in f32, P = 2^(S scale log2(e) - lse log2(e)), delta
    from the bf16 out, P and dS rounded to bf16 as the A operands of dV,
    dK and dQ, each gradient rounded to bf16 once."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G, scale, log2e = Hq // Hkv, 1.0 / np.sqrt(D), float(np.log2(np.e))

    def bf(x):
        return x.to(torch.bfloat16).float()

    qf, kf, vf = q.float().reshape(B, Hkv, G, S, D), k.float(), v.float()
    do = dout.float().reshape(B, Hkv, G, S, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, kf)
    if causal:
        s = s.masked_fill(~ref._causal_mask(S, T, T - S, q.device), float("-inf"))
    p = torch.exp2(s * (scale * log2e) - (lse.reshape(B, Hkv, G, S) * log2e)[..., None])
    delta = (do * out.float().reshape(B, Hkv, G, S, D)).sum(-1)
    ds = p * (torch.einsum("bhgsd,bhtd->bhgst", do, vf) - delta[..., None])
    dq = torch.einsum("bhgst,bhtd->bhgsd", bf(ds), kf) * scale
    dk = torch.einsum("bhgst,bhgsd->bhtd", bf(ds), qf) * scale
    dv = torch.einsum("bhgst,bhgsd->bhtd", bf(p), do)
    return bf(dq.reshape(B, Hq, S, D)), bf(dk), bf(dv)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,causal", [
    (1, 8, 1, 512, 512, 128, True),
    (1, 6, 2, 512, 512, 64, True),
    (1, 4, 2, 200, 300, 80, False),
])
def test_bwd_tensor_core_rounding_fits_the_smoke_bound(B, Hq, Hkv, S, T, D, causal):
    """The bf16 backward's design, emulated, against the f32 plain VJP of the
    same bf16 inputs: each gradient's max |error| over its max |value| within
    half of chip_smoke.py's FLASH_BWD_REL, 2e-2 (the CPU reads ~3e-3 to
    5e-3: the bf16 rounding of each gradient, ~2^-9 of a value, plus those
    of P and dS)."""
    rng = np.random.default_rng(D)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
                  for shape in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D), (B, Hq, S, D)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    got = _bwd_kernel_emulation(q, k, v, out, lse, g, causal)
    want = _attention_grads(q.float(), k.float(), v.float(), g.float(), causal)
    for a, b in zip(got, want):
        assert 0 < float((a - b).abs().max() / b.abs().max()) < 1e-2


def _bwd_operands(dtype=torch.bfloat16, D=64, S=8):
    q = _buf((1, 2, S, D), dtype)
    k = v = _buf((1, 1, S, D), dtype)
    return q, k, v, _buf((1, 2, S, D), dtype), torch.zeros(1, 2, S), _buf((1, 2, S, D), dtype)


@pytest.mark.parametrize("case", ["f32", "head_dim", "out_dtype", "dout_dtype", "lse_dtype",
                                  "lse_strided", "out_aligned", "out_last_dim"])
def test_flash_bwd_plan_rejects(case):
    """The backward kernel takes bf16 only (f32 operands keep the plain VJP
    in ops and raise at the wrapper on the card), at the forward's head
    sizes, out and dout in q's dtype, lse contiguous f32, out aligned."""
    q, k, v, out, lse, dout = _bwd_operands(torch.float32 if case == "f32" else torch.bfloat16,
                                            D=48 if case == "head_dim" else 64)
    if case == "out_dtype":
        out = out.float()
    elif case == "dout_dtype":
        dout = dout.float()
    elif case == "lse_dtype":
        lse = lse.bfloat16()
    elif case == "lse_strided":
        lse = torch.zeros(1, 2, 16)[..., ::2]
    elif case == "out_aligned":
        out = _buf((1, 2, 8, 64), offset=1)
    elif case == "out_last_dim":
        out = _buf((1, 2, 64, 8)).transpose(2, 3)
    err = ValueError if case in ("head_dim", "out_aligned", "out_last_dim") else TypeError
    with pytest.raises(err):
        _plan_bwd(q, k, v, out, lse, dout)


def test_flash_bwd_plan_makes_dout_readable():
    """An aligned dout view (the head-transposed gradient of the model's
    output) is read in place; one off the 16-byte grid, or with a strided
    last dim, is copied contiguous."""
    q, k, v, out, lse, _ = _bwd_operands()
    view = _buf((1, 8, 2, 64)).transpose(1, 2)
    assert _plan_bwd(q, k, v, out, lse, view) is view
    for dout in (_buf((1, 2, 8, 64), offset=1), _buf((1, 2, 64, 8)).transpose(2, 3)):
        got = _plan_bwd(q, k, v, out, lse, dout)
        assert got.is_contiguous() and torch.equal(got, dout)


@pytest.mark.parametrize("case", ["out", "dout", "lse", "kv"])
def test_flash_bwd_rejects_mismatched_shapes(case):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 16, 16, 16))
    out, lse = flash_attention_fwd(q, k, v)
    dout = torch.ones_like(q)
    if case == "out":
        out = out[:, :, :8]
    elif case == "dout":
        dout = dout[:, :2]
    elif case == "lse":
        lse = lse[..., None]
    else:
        v = v[:, :, :8]
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse, dout)


def test_flash_attention_saves_out_and_lse():
    """The kernel op keeps the forward's out and lse for its backward beside
    q, k and v: the lse of the forward it ran, the very out it returned."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 4, 2, 32, 32, 32))
    y = ops.flash_attention(q, k, v, causal=True, impl="cuda")
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(a is b for a, b in zip(saved[:3], (q, k, v)))
    assert torch.equal(saved[3], y)
    _, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach(), causal=True)
    assert torch.equal(saved[4], lse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cpu_backward_is_the_plain_vjp(dtype):
    """On CPU tensors, bf16 too, the kernel op's backward is the plain
    VJP, bit for bit: autograd of the plain attention at the same inputs."""
    arrays = _qkv(2, 6, 2, 40, 40, 64, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 6, 40, 64))
                         .astype(np.float32)).to(_TORCH[dtype])
    q, k, v = (torch.from_numpy(a).to(_TORCH[dtype]).requires_grad_() for a in arrays)
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=True, impl="cuda"),
                              (q, k, v), g)
    for a, b in zip(got, _attention_grads(q, k, v, g, True)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, N, seed=0):
    """x, dt, A, Bm, C, D as tests/test_kernels.py draws them (numpy here)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)  # softplus
    A = (-np.exp(rng.standard_normal(H))).astype(f32)
    Bm = rng.standard_normal((B, S, N)).astype(f32)
    C = rng.standard_normal((B, S, N)).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    return x, dt, A, Bm, C, D


# the cases of tests/test_kernels.py::test_ssd_kernel_vs_oracle
_SSD_CASES = [
    (1, 128, 2, 32, 16, 64),
    (2, 300, 4, 64, 32, 128),   # uneven chunks
    (1, 64, 1, 16, 8, 256),     # chunk > seq
]


@pytest.mark.parametrize("B,S,H,P,N,chunk", _SSD_CASES)
def test_ssd_plain_matches_jax_kernel(B, S, H, P, N, chunk):
    arrays = _ssd_inputs(B, S, H, P, N)
    jin = [jnp.asarray(a) for a in arrays]
    tin = [torch.from_numpy(a) for a in arrays]
    y, state = ssd_scan_fwd(*tin, chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    # the chunked (Pallas, interpret mode) and sequential forms: 2e-3, as
    # tests/test_kernels.py holds them
    jy, jstate = jax_ssd(*jin, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(jy), atol=2e-3, rtol=0)
    np.testing.assert_allclose(_np(state), _np(jstate), atol=2e-3, rtol=0)
    # the same sequential f32 recurrence on both sides: rounding only
    ey, estate = jref.ssd_scan(*jin, return_state=True)
    np.testing.assert_allclose(_np(y), _np(ey), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(state), _np(estate), atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_ops_match_jax_ops(dtype):
    x, dt, A, Bm, C, D = _ssd_inputs(2, 40, 3, 16, 8, seed=3)
    (jx, tx), (jdt, tdt), (jb, tb), (jc, tc) = (_both(a, dtype) for a in (x, dt, Bm, C))
    jA, jD = jnp.asarray(A), jnp.asarray(D)
    tA, tD = torch.from_numpy(A), torch.from_numpy(D)
    want = jops.ssd(jx, jdt, jA, jb, jc, jD, impl="xla")
    for impl in ops.IMPLS:
        got = ops.ssd(tx, tdt, tA, tb, tc, tD, impl=impl)
        assert got.dtype == _TORCH[dtype]
        _assert_close(got, want, dtype)
    # D omitted: f32 zeros on both sides
    _assert_close(ops.ssd(tx, tdt, tA, tb, tc, impl="cuda"),
                  jops.ssd(jx, jdt, jA, jb, jc, impl="xla"), dtype)


def test_ssd_streaming_equals_full():
    """Chunked decode (carrying state) == one full scan (tests/test_kernels.py),
    and the carried state matches the JAX package's."""
    x, dt, A, Bm, C, D = (torch.from_numpy(a) for a in _ssd_inputs(1, 96, 2, 16, 8))
    full = ref.ssd_scan(x, dt, A, Bm, C, D)
    y1, st = ops.ssd_with_state(x[:, :64], dt[:, :64], A, Bm[:, :64], C[:, :64], D,
                                impl="cuda")
    y2, st2 = ops.ssd_with_state(x[:, 64:], dt[:, 64:], A, Bm[:, 64:], C[:, 64:], D,
                                 init_state=st, impl="cuda")
    assert float((torch.cat([y1, y2], dim=1) - full).abs().max()) < 1e-4
    jin = [jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, C, D)]
    _, jst = jops.ssd_with_state(*[a[:, :64] if a.ndim > 1 else a for a in jin])
    _, jst2 = jops.ssd_with_state(*[a[:, 64:] if a.ndim > 1 else a for a in jin],
                                  init_state=jst)
    np.testing.assert_allclose(_np(st2), _np(jst2), atol=2e-5, rtol=0)


def _bf16_split(v):
    """f32 v as bf16 hi + lo: hi = round(v), lo = round(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _ssd_tensor_core_emulation(x, dt, A, Bm, C, D, *, chunk, split_scores=True):
    """The bf16 SSD kernel's arithmetic in f32 torch: chunks of L = min(chunk,
    S) steps padded with zero rows to a multiple of 16, g = cumsum(a dt) with
    each product in f32 and the sums in f64, g_t - g_s rounded to f32 before
    its exp, exact bf16 products C B^T; the scores S, x w and the carried h
    each split into bf16 hi + lo against the exact bf16 operand (x, B, C); h
    carried in f32 between chunks; y rounded to bf16 once.
    ``split_scores=False`` rounds S to bf16 once instead, as K2 rounds P."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    Lp = -(-L // 16) * 16
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), C.float()
    Af, Df = A.float(), D.float()
    h = torch.zeros(Bsz, H, P, N)
    causal = torch.tril(torch.ones(Lp, Lp, dtype=torch.bool))[None, :, :, None]
    ys = []
    for t0 in range(0, S, L):
        n = min(L, S - t0)
        xc, dtc = torch.zeros(Bsz, Lp, H, P), torch.zeros(Bsz, Lp, H)
        Bc, Cc = torch.zeros(Bsz, Lp, N), torch.zeros(Bsz, Lp, N)
        xc[:, :n], dtc[:, :n] = xf[:, t0:t0 + n], dtf[:, t0:t0 + n]
        Bc[:, :n], Cc[:, :n] = Bf[:, t0:t0 + n], Cf[:, t0:t0 + n]
        g = torch.cumsum((Af * dtc).double(), dim=1)  # (B, Lp, H)
        G = g[:, -1]
        cb = torch.einsum("btn,bsn->bts", Cc.double(), Bc.double()).float()
        diff = (g[:, :, None, :] - g[:, None, :, :]).float()  # (B, t, s, H)
        decay = torch.where(causal, torch.exp(diff), torch.zeros(()))
        scores = cb[..., None] * decay * dtc[:, None, :, :]
        s_hi, s_lo = (_bf16_split(scores) if split_scores
                      else (scores.to(torch.bfloat16).float(), torch.zeros_like(scores)))
        y = (torch.einsum("btsh,bshp->bthp", s_hi, xc)
             + torch.einsum("btsh,bshp->bthp", s_lo, xc))
        if t0 > 0:
            h_hi, h_lo = _bf16_split(h)
            carried = (torch.einsum("btn,bhpn->bthp", Cc, h_hi)
                       + torch.einsum("btn,bhpn->bthp", Cc, h_lo))
            y = y + torch.exp(g.float())[..., None] * carried
        ys.append((y + Df[:, None] * xc)[:, :n])
        w = torch.exp((G[:, None, :] - g).float()) * dtc  # (B, s, H)
        xw_hi, xw_lo = _bf16_split(xc * w[..., None])
        h = (torch.exp(G.float())[..., None, None] * h
             + torch.einsum("bshp,bsn->bhpn", xw_hi, Bc)
             + torch.einsum("bshp,bsn->bhpn", xw_lo, Bc))
    return torch.cat(ys, dim=1).to(torch.bfloat16), h


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 256, 2, 64, 128),   # mamba2-370m's head: P 64, N 128
    (1, 300, 2, 64, 16),    # hymba-1.5b's: N 16; a ragged last chunk
])
def test_ssd_tensor_core_rounding_fits_the_bound(B, S, H, P, N):
    """The bf16 SSD kernel's design, emulated, on bf16 inputs against the JAX
    kernel (interpret mode) and the JAX plain scan: y within the bf16 kernel
    tolerance, the f32 state within the 2e-3 that chip_smoke.py holds the
    kernel's state to (SSD_TOL). A single bf16 rounding of S would be allowed
    only within half the y tolerance; it is not, hence S's hi + lo split."""
    x, dt, A, Bm, C, D = _ssd_inputs(B, S, H, P, N, seed=N)
    (jx, tx), (jdt, tdt), (jb, tb), (jc, tc) = (_both(a, "bfloat16") for a in (x, dt, Bm, C))
    jA, jD, tA, tD = jnp.asarray(A), jnp.asarray(D), torch.from_numpy(A), torch.from_numpy(D)
    y, state = _ssd_tensor_core_emulation(tx, tdt, tA, tb, tc, tD, chunk=DEFAULT_CHUNK)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    jy, jstate = jax_ssd(jx, jdt, jA, jb, jc, jD, chunk=DEFAULT_CHUNK)
    ey, estate = jref.ssd_scan(jx, jdt, jA, jb, jc, jD, return_state=True)
    for want_y, want_state in ((jy, jstate), (ey, estate)):
        _assert_close(y, want_y, "bfloat16")
        np.testing.assert_allclose(_np(state), _np(want_state), atol=2e-3, rtol=0)
    # the splits and the chunking are real: the emulation is not the plain version
    plain_y, plain_state = ssd_scan_fwd(tx, tdt, tA, tb, tc, tD)
    assert not (torch.equal(y, plain_y) and torch.equal(state, plain_state))
    y_once, _ = _ssd_tensor_core_emulation(tx, tdt, tA, tb, tc, tD, chunk=DEFAULT_CHUNK,
                                           split_scores=False)
    atol, rtol = _TOL["bfloat16"]
    ref_y = _np(ey)
    assert float((np.abs(_np(y_once) - ref_y) / (atol + rtol * np.abs(ref_y))).max()) > 0.5


def _xbc_views(B, S, H, P, N, dtype, *, offset=0, pad=0):
    """x (B, S, H, P), Bm and C (B, S, N): views of one (B, S, H*P + 2N + pad)
    tensor whose data starts `offset` elements into its buffer, as the model
    hands them over; dt (B, S, H) contiguous."""
    width = H * P + 2 * N + pad
    xbc = torch.zeros(B * S * width + offset, dtype=dtype)[offset:].view(B, S, width)
    x, Bm, C, _ = torch.split(xbc, [H * P, N, N, pad], dim=-1)
    return x.reshape(B, S, H, P), torch.zeros(B, S, H, dtype=dtype), Bm, C


@pytest.mark.parametrize("shape", [(4, 2048, 32, 64, 128), (2, 1024, 50, 64, 16),
                                   (1, 128, 2, 32, 16), (1, 64, 1, 16, 8), (3, 1, 4, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plan_picks_the_path_by_dtype(shape, dtype):
    """bf16 takes the tensor cores, f32 the CUDA cores, on the model's views of
    one conv output at mamba2's, hymba's and the test shapes."""
    x, dt, Bm, C = _xbc_views(*shape, _TORCH[dtype])
    want = "tensor_cores" if dtype == "bfloat16" else "cuda_cores"
    assert _ssd_plan(x, dt, Bm, C, DEFAULT_CHUNK) == want


@pytest.mark.parametrize("case", ["base_pointer", "row_stride", "chunk", "head_size",
                                  "state_width", "last_dim", "dtype"])
def test_ssd_plan_rejects(case):
    """Each operand the bf16 kernel does not take raises in the wrapper, before
    any launch; the f32 kernel copies no 16-byte chunks and takes unaligned
    views."""
    def operands(dtype):
        shape, chunk = (2, 256, 4, 64, 32), DEFAULT_CHUNK
        kw = {}
        if case == "base_pointer":  # one element past a 16-byte boundary
            kw = {"offset": 1}
        elif case == "row_stride":  # rows 325 elements apart
            kw = {"pad": 5}
        elif case == "chunk":
            chunk = 256
        elif case == "head_size":
            shape = (2, 256, 4, 24, 32)
        elif case == "state_width":
            shape = (2, 256, 4, 64, 12)
        x, dt, Bm, C = _xbc_views(*shape, dtype, **kw)
        if case == "last_dim":
            x = x.transpose(2, 3).contiguous().transpose(2, 3)
        elif case == "dtype":
            dt = dt.float()
        return x, dt, Bm, C, chunk

    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        _ssd_plan(*operands(torch.bfloat16))
    if case in ("base_pointer", "row_stride", "chunk", "head_size", "state_width"):
        assert _ssd_plan(*operands(torch.float32)) == "cuda_cores"


# ---------------------------------------------------------------------------
# backward: the VJP of the plain version, as the JAX package's custom_vjp
# ---------------------------------------------------------------------------

def _grads_rmsnorm():
    """tests/test_kernels.py::test_rmsnorm_grad's input, weight grad too."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 96)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jax_fn(x, w):
        return (jops.fused_rmsnorm(x, w, impl="pallas") * g).sum()

    def torch_fn(x, w):
        return (ops.fused_rmsnorm(x, w, impl="cuda") * torch.from_numpy(g)).sum()

    return (x, w), jax_fn, torch_fn


def _grads_flash():
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=2)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)

    def jax_fn(q, k, v):
        return (jops.flash_attention(q, k, v, causal=True, impl="pallas") * g).sum()

    def torch_fn(q, k, v):
        out = ops.flash_attention(q, k, v, causal=True, impl="cuda")
        return (out * torch.from_numpy(g)).sum()

    return (q, k, v), jax_fn, torch_fn


def _grads_ssd():
    """tests/test_kernels.py::test_ssd_grad_parity's shapes and loss."""
    x, dt, A, Bm, C, _ = _ssd_inputs(1, 128, 2, 16, 8)

    def jax_fn(x, dt, A, Bm, C):
        return jops.ssd(x, dt, A, Bm, C, impl="pallas").sum()

    def torch_fn(x, dt, A, Bm, C):
        return ops.ssd(x, dt, A, Bm, C, impl="cuda").sum()

    return (x, dt, A, Bm, C), jax_fn, torch_fn


_GRAD_CASES = {"rmsnorm": _grads_rmsnorm, "flash": _grads_flash, "ssd": _grads_ssd}


@pytest.mark.parametrize("op", sorted(_GRAD_CASES))
def test_kernel_backward_matches_jax_grad(op):
    """Every input's gradient through the kernel op equals jax.grad through
    the JAX op: both are the plain version's VJP, in f32. The first input (x,
    or q) is held to 1e-5 absolute, the tests/test_kernels.py grad bound; the
    others also by 1e-5 of their value, since the gradients of a weight, dt,
    A, B or C sum over every row or step and reach 1e1-1e2, where f32 sums
    taken in another order differ by a few ulps."""
    arrays, jax_fn, torch_fn = _GRAD_CASES[op]()
    want = jax.grad(jax_fn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    loss = torch_fn(*inputs)
    assert loss.grad_fn is not None
    loss.backward()
    for i, (t, w) in enumerate(zip(inputs, want)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0 if i == 0 else 1e-5)
