"""The cached path's attention over a plain KV cache (``models/lm.py``
``_cached_attention``, the one route a sharded cache takes too, one part
per rank) on the CPU: which route each cached call takes, the flash
kernel's route against ``flash_xla`` on the same inputs, and the pairs the
route counts.

On the CPU the flash kernel's wrapper runs its plain version, so the route
and its arguments are what these tests hold; chip_smoke.py holds the kernel
itself at the serve cell's shapes. Bounds: 2e-5 on attention outputs and
1e-4 on logits in f32, as tests/test_torch_kernels.py and
tests/test_torch_models.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import pin_threads  # noqa: E402

pin_threads()
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import BQ, HEAD_DIMS  # noqa: E402
from repro_torch.kernels.xla_flash import flash_xla  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ATTN_TOL = 2e-5
TOL = 1e-4
ARCH = get_reduced("qwen3-8b")
CFG = lm.ModelCfg(dtype=torch.float32)
MAX_LEN = 40


@pytest.fixture(autouse=True)
def _fresh():
    spans.clear()
    yield
    spans.clear()


def _params(arch):
    return lm.init_params(arch, torch.Generator().manual_seed(0), device="cpu")


def _tokens(n, seed=1):
    return torch.randint(0, ARCH.vocab, (2, n), generator=torch.Generator().manual_seed(seed))


class _Spy:
    """Wraps the attention routes ``_attend_part`` chooses among (through
    ``_cached_attention``), recording each call's query length, q_offset (or
    start) and key count."""

    def __init__(self, monkeypatch):
        self.calls = {"kernel": [], "flash_xla": [], "dense": []}
        for name, key in (("flash_attention_fwd", "kernel"), ("flash_xla", "flash_xla"),
                          ("_dense_cached_attention", "dense")):
            monkeypatch.setattr(lm, name, self._wrap(getattr(lm, name), key))

    def _wrap(self, fn, key):
        def spy(q, k, v, *args, **kw):
            start = kw.get("q_offset", kw.get("q_start", args[0] if args else None))
            self.calls[key].append((q.shape[2], start, k.shape[2]))
            return fn(q, k, v, *args, **kw)

        return spy


# (filled by a prefill first, the measured call's S, its start) of each case
_PREFILL, _CHUNK, _DECODE = (0, 10, 0), (10, 5, 10), (10, 1, 10)
KERNEL_CASES = {
    "prefill": ({}, _PREFILL),
    "chunk": ({}, _CHUNK),
    "decode": ({}, _DECODE),
    # decode_dense_attn keeps its dense product only at S <= 16
    "prefill_past_dense_decode": ({"decode_dense_attn": True}, (0, 20, 0)),
    # a head size the kernel lacks: its plain version on the CPU, a refusal
    # on the card, as on the full-sequence path
    "head_dim_48": ({"head_dim": 48}, _DECODE),
    # each kv head kept twice (8 q heads over 4 cache heads), and the rows
    # written by index
    "kv_cache_repeat_2": ({"kv_cache_repeat": 2}, _DECODE),
    "kv_scatter_write": ({"kv_scatter_write": True}, _CHUNK),
}
FLASH_XLA_CASES = {
    "ring": ({"window": 16}, _DECODE),
    "ring_prefill": ({"window": 16}, _PREFILL),
    "int8": ({"kv_cache_quant": True}, _DECODE),
    "impl_xla": ({"attn_impl": "xla"}, _DECODE),
    "impl_torch": ({"attn_impl": "torch"}, _CHUNK),
}


def _run_case(monkeypatch, opts, case):
    opts = dict(opts)
    arch = ARCH
    for key in ("window", "head_dim"):
        if key in opts:
            field = "sliding_window" if key == "window" else key
            arch = dataclasses.replace(arch, **{field: opts.pop(key)})
    cfg = dataclasses.replace(CFG, **opts)
    params = _params(arch)
    caches = lm.init_caches(arch, cfg, 2, MAX_LEN, device="cpu")
    filled, S, start = case
    toks = _tokens(filled + S)
    if filled:
        lm.prefill(params, arch, cfg, caches, toks[:, :filled])
    spy = _Spy(monkeypatch)
    lm.forward_cached(params, arch, cfg, caches, toks[:, filled:], start)
    return spy.calls, arch, S, start


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_a_plain_cache_attends_through_the_flash_kernel(monkeypatch, name):
    opts, case = KERNEL_CASES[name]
    assert opts.get("head_dim") is None or opts["head_dim"] not in HEAD_DIMS
    calls, arch, S, start = _run_case(monkeypatch, opts, case)
    assert calls["kernel"] == [(S, start, start + S)] * arch.num_layers
    assert calls["flash_xla"] == [] and calls["dense"] == []


@pytest.mark.parametrize("name", sorted(FLASH_XLA_CASES))
def test_other_caches_keep_flash_xla(monkeypatch, name):
    opts, case = FLASH_XLA_CASES[name]
    calls, arch, S, start = _run_case(monkeypatch, opts, case)
    assert calls["kernel"] == [] and calls["dense"] == []
    T = min(MAX_LEN, arch.sliding_window or MAX_LEN)
    assert calls["flash_xla"] == [(S, start, T)] * arch.num_layers


def test_dense_decode_keeps_its_masked_product(monkeypatch):
    calls, arch, S, start = _run_case(monkeypatch, {"decode_dense_attn": True}, _DECODE)
    assert calls["kernel"] == [] and calls["flash_xla"] == []
    assert calls["dense"] == [(S, start, MAX_LEN)] * arch.num_layers


def _qkv_cache(B, Hq, Hkv, S, T, D, seed):
    """q and a cache of T slots, every slot filled: the slots past the
    call's last position hold values no query may see."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, S, D, generator=g)
    k, v = (torch.randn(B, Hkv, T, D, generator=g) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("B,Hq,Hkv,S,start,T,D", [
    (2, 4, 2, 10, 0, 24, 16),     # prefill into a longer cache
    (2, 4, 2, 5, 10, 24, 16),     # a chunk into a partly filled cache
    (2, 4, 2, 1, 23, 24, 16),     # decode at the last slot
    (1, 8, 1, 1, 70, 96, 128),    # decode, one kv head, the serve cell's head size
    (1, 4, 4, 70, 3, 80, 24),     # more than one tile of rows, no grouping
])
def test_flash_route_matches_flash_xla(B, Hq, Hkv, S, start, T, D):
    q, k, v = _qkv_cache(B, Hq, Hkv, S, T, D, seed=S + start)
    got = lm._flash_cached_attention(q, k, v, start)
    want = flash_xla(q, k, v, q_start=start, kv_valid_len=start + S, causal=True)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, atol=ATTN_TOL, rtol=0)


def test_model_logits_through_the_flash_route_match_flash_xla():
    """Prefill and three decode steps of the reduced model: the default impl
    (the flash route) against ``attn_impl="xla"`` (flash_xla; on the CPU the
    norms take the same plain version either way)."""
    params = _params(ARCH)
    toks = _tokens(13)
    logits = {}
    for impl in ("cuda", "xla"):
        cfg = dataclasses.replace(CFG, attn_impl=impl)
        caches = lm.init_caches(ARCH, cfg, 2, MAX_LEN, device="cpu")
        out = [lm.prefill(params, ARCH, cfg, caches, toks[:, :10])[0]]
        for pos in range(10, 13):
            out.append(lm.decode_step(params, ARCH, cfg, caches, toks[:, pos:pos + 1], pos)[0])
        logits[impl] = torch.cat(out, dim=1)
    torch.testing.assert_close(logits["cuda"], logits["xla"], atol=TOL, rtol=0)


def _kernel_pairs(S, start):
    """A brute-force count of the flash kernel's tiles over T = start + S
    keys: every row of a tile of BQ rows against the keys before the tile's
    kv_end (``min(T, start + min(q0 + BQ, S))``), and of those the causal
    ones; (scored, live) for one head."""
    T = start + S
    scored = live = 0
    for q0 in range(0, S, BQ):
        kv_end = min(T, start + min(q0 + BQ, S))
        for i in range(q0, min(q0 + BQ, S)):  # row i sees keys j <= start + i
            scored += kv_end
            live += min(kv_end, start + i + 1)
    return scored, live


@pytest.mark.parametrize("S,start", [
    (64, 0), (128, 0), (100, 0), (65, 0),   # prefill, rows on and off tiles
    (64, 64), (70, 58),                     # chunks, T on and off multiples of 64
    (1, 63), (1, 64), (1, 200),             # decode steps
])
def test_flash_route_counts_the_kernels_pairs(S, start):
    B, Hq, Hkv, D = 2, 4, 2, 16
    q, k, v = _qkv_cache(B, Hq, Hkv, S, start + S + 5, D, seed=0)
    lm._flash_cached_attention(q, k, v, start)  # off: nothing counted
    assert spans.recorded() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("attn"):
            lm._flash_cached_attention(q, k, v, start)
    (got,) = spans.recorded()
    scored, live = _kernel_pairs(S, start)
    assert got.counts == {"attn.pairs_scored": B * Hq * scored,
                          "attn.pairs_live": B * Hq * live}


def test_the_serve_cells_prefill_reads_its_route():
    """The serve cell's prefill (S = T = 4080): 98.48% of the pairs the
    kernel scores are live, where flash_xla's 4096 slots leave 49.82%."""
    scored, live = _kernel_pairs(4080, 0)
    assert (scored, live) == (8_453_376, 8_325_240)
    assert round(100 * live / scored, 2) == 98.48
    assert round(100 * live / (4080 * 4096), 2) == 49.82
