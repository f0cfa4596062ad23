"""The port against the plain reference at small sizes on the CPU, both in
float32: the train step's first steps (forward through the norms and
attention, the backward, AdamW) and
the served path (prefill, then decode through the KV cache, against the
reference's full forward)."""
import numpy as np
import pytest
import torch

from portbench.drivers import serve, train
from portbench.harness import runtime as rt
from portbench.harness.traffic import serve_prompts, train_pool
from portbench.harness.weights import make_weights
from portbench.refs import lm as ref
from portbench.tests.cells import DENSE, serve_cell, train_cell

CPU = torch.device("cpu")


def test_first_train_steps_match_the_reference():
    c = train_cell(DENSE)
    batches = train_pool(c.mix, c.shape.vocab, 2 ** 31 + 5, CPU)[:3]
    *_, prog = train.first_steps(c, train.program(c), 2 ** 31 + 5, batches, CPU)
    want = train.reference(c, 2 ** 31 + 5, [b["tokens"] for b in batches], CPU)
    assert len(prog["losses"]) == 3 and prog["losses"][0] > 4.0
    np.testing.assert_allclose(prog["losses"], want["losses"], rtol=2e-6)
    for key in ("grad_norms", "change_norms"):
        assert set(prog[key]) == set(want[key])
        for leaf, v in want[key].items():
            assert prog[key][leaf] == pytest.approx(v, rel=2e-4, abs=1e-9), (key, leaf)


def test_served_logits_match_the_full_forward():
    from repro_torch.models import lm

    c = serve_cell()
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
