"""The port against the plain reference at small sizes on the CPU, both in
float32: the train step's first steps (forward through the norms and
attention, the backward, AdamW), the MoE layer on the port's routing, and
the served path (prefill, then decode through the KV cache, against the
reference's full forward), with full attention and with a head size and a
sliding window of the configuration's own; and the reference's windowed
attention against one masked product."""
import numpy as np
import pytest
import torch

from portbench.drivers import serve, train
from portbench.harness import runtime as rt
from portbench.harness.spec import Shape
from portbench.harness.traffic import serve_prompts, train_pool
from portbench.harness.weights import make_weights
from portbench.refs import lm as ref
from portbench.tests.cells import DENSE, WINDOWED, serve_cell, train_cell

CPU = torch.device("cpu")


def _causal_as_before(q, k, v, scale, q_ops, block=512):
    """``ref.attention`` as it was before it took a window."""
    B, H, S, D = q.shape
    g = H // k.shape[1]
    k, v = q_ops(k), q_ops(v)
    outs = []
    for a in range(0, S, block):
        b = min(a + block, S)
        qb = q_ops(q[:, :, a:b]).reshape(B, k.shape[1], g, b - a, D)
        s = torch.einsum("bhgsd,bhtd->bhgst", qb, k[:, :, :b]) * scale
        keys, queries = (torch.arange(n, b, device=q.device) for n in (0, a))
        p = torch.softmax(s.masked_fill(keys[None, :] > queries[:, None], float("-inf")), dim=-1)
        out = torch.einsum("bhgst,bhtd->bhgsd", q_ops(p), v[:, :, :b])
        outs.append(out.reshape(B, H, b - a, D))
    return torch.cat(outs, dim=2)


def _qkv(S, D=24):
    g = torch.Generator().manual_seed(5)
    return (torch.randn(2, 4, S, D, generator=g), torch.randn(2, 2, S, D, generator=g),
            torch.randn(2, 2, S, D, generator=g))


@pytest.mark.parametrize("window,block", [(12, 8), (5, 8), (1, 8), (8, 8), (9, 16), (30, 8)])
def test_windowed_attention_is_one_masked_product(window, block):
    # S = 40 in blocks of 8 or 16: most blocks begin inside the window of the
    # block before them
    q, k, v = _qkv(40)
    got = ref.attention(q, k, v, 0.2, lambda t: t, window, block=block)
    i, j = torch.arange(40)[:, None], torch.arange(40)[None, :]
    s = torch.einsum("bhgsd,bhtd->bhgst", q.reshape(2, 2, 2, 40, 24), k) * 0.2
    p = torch.softmax(s.masked_fill((j > i) | (j <= i - window), float("-inf")), dim=-1)
    want = torch.einsum("bhgst,bhtd->bhgsd", p, v).reshape(2, 4, 40, 24)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", [0, 40, 41, 1000])
@pytest.mark.parametrize("prec", ["float32", "fp8"])
def test_attention_without_a_shorter_window_is_the_causal_path_bit_for_bit(window, prec):
    q, k, v = _qkv(40)
    q_ops = ref._ops(prec)
    assert torch.equal(ref.attention(q, k, v, 0.2, q_ops, window, block=16),
                       _causal_as_before(q, k, v, 0.2, q_ops, block=16))


@pytest.mark.parametrize("config", [DENSE, WINDOWED], ids=lambda c: c["name"])
def test_first_train_steps_match_the_reference(config):
    c = train_cell(config)
    batches = train_pool(c.mix, c.shape.vocab, 2 ** 31 + 5, CPU)[:3]
    *_, prog = train.first_steps(c, train.program(c), 2 ** 31 + 5, batches, CPU)
    want = train.reference(c, 2 ** 31 + 5, [b["tokens"] for b in batches], CPU)
    assert len(prog["losses"]) == 3 and prog["losses"][0] > 4.0
    np.testing.assert_allclose(prog["losses"], want["losses"], rtol=2e-6)
    for key in ("grad_norms", "change_norms"):
        assert set(prog[key]) == set(want[key])
        for leaf, v in want[key].items():
            assert prog[key][leaf] == pytest.approx(v, rel=2e-4, abs=1e-9), (key, leaf)


@pytest.mark.parametrize("config", [DENSE, WINDOWED], ids=lambda c: c["name"])
def test_served_logits_match_the_full_forward(config):
    from repro_torch.models import lm

    c = serve_cell(config)
    s, mix = c.shape, c.mix
    P, N = mix["prompt_len"], mix["new_tokens"]
    w = make_weights(s, 11, torch.float32, CPU, mix.get("query_key_noise"))
    eng = serve.engine(c, w, CPU)
    prompts = torch.from_numpy(serve_prompts(mix, s.vocab, 11, 0))
    caches = lm.init_caches(eng.arch, eng.cfg, prompts.shape[0], mix["max_len"], device=CPU)
    with torch.inference_mode():
        got = [lm.prefill(w, eng.arch, eng.cfg, caches, prompts)[0][:, -1]]
        seq = prompts
        for i in range(N - 1):
            nxt = got[-1].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            got.append(lm.decode_step(w, eng.arch, eng.cfg, caches, nxt, P + i)[0][:, -1])
    want = ref.logits_at(w, s, seq, list(range(P - 1, P + N - 1)))
    torch.testing.assert_close(torch.stack(got, 1), want, rtol=1e-4, atol=1e-4)
    run = serve.run(c, 11, 0.2, False, CPU, rt.now())
    assert run["numbers"]["logit_gap"] == pytest.approx(0.0, abs=1e-4)
    assert run["attempted"] % mix["batch"] == 0 and run["failed"] == 0


def test_moe_layer_matches_the_port_on_its_routing():
    """The reference's MoE layer against the port's ``moe_block`` at a small
    granite-shaped size, both in float32, the reference taking the port's
    experts: the output, the gradients of the input and of each weight, and
    the same assignments kept (some dropped past their capacity)."""
    from repro_torch.models import moe as port

    from portbench.refs import moe as ref_moe
    from portbench.tests.cells import MOE

    s = Shape.from_config(MOE)
    T, k, cf = 4 * 32, s.top_k, 1.0  # C = 32, the mean load: some experts overflow
    w = make_weights(s, 2 ** 31 + 7, torch.float32, CPU)["layers"]["moe"]
    x = torch.randn(4, 32, s.hidden, generator=torch.Generator().manual_seed(3))

    def grads(fn, **kw):
        p = {n: t[0].clone().requires_grad_(True) for n, t in w.items()}
        xi = x.clone().requires_grad_(True)
        y = fn(p, xi, **kw)
        y = y[0] if isinstance(y, tuple) else y
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        return y.detach(), xi.grad, {n: t.grad for n, t in p.items()}

    with train.recorded_routes(s) as routes:
        y_port, gx_port, gw_port = grads(lambda p, xi: port.moe_block(p, xi, top_k=k,
                                                                      capacity_factor=cf))
    y_ref, gx_ref, gw_ref = grads(lambda p, xi: ref_moe.layer(xi, p, s, lambda t: t, cf,
                                                              routes[0]))
    torch.testing.assert_close(y_ref, y_port, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx_ref, gx_port, rtol=1e-5, atol=1e-6)
    for n in w:
        torch.testing.assert_close(gw_ref[n], gw_port[n], rtol=1e-5, atol=1e-6, msg=n)

    xt = x.reshape(T, s.hidden)
    _, e_sorted, _, pos, t_sorted, _, C = port.global_route(w["router"][0], xt, k, cf, T)
    port_kept = {(int(t), int(e)) for t, e, p in zip(t_sorted, e_sorted, pos) if p < C}
    chosen = routes[0].long()
    slot = ref_moe.slots(chosen, s.experts)
    ref_kept = {(t, int(chosen[t, j])) for t in range(T) for j in range(k) if slot[t, j] < C}
    assert ref_kept == port_kept and 0 < len(ref_kept) < T * k
    _, read = ref_moe.layer(x, {n: t[0] for n, t in w.items()}, s, lambda t: t, cf, routes[0])
    assert float(read["gap"]) == 0 and int(read["differed"]) == 0
    assert int(read["dropped"]) == T * k - len(ref_kept)
