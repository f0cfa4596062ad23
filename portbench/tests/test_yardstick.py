"""The yardstick's arithmetic against counts worked by hand, the roofline
readers, the traffic generator's seeding and the weights' attention."""
import numpy as np
import pytest
import torch

from portbench.harness import peaks, traffic
from portbench.harness.spec import BENCH, Shape, load_json
from portbench.harness.trace import (Trace, TraceError, breakdown, fold, gaps, idle_share,
                                     union_s)
from portbench.harness.weights import leaf_seed, leaf_specs, make_weights
from portbench.run import read_metric


def shape(name):
    return Shape.from_config(load_json(BENCH / "configs" / f"{name}.json"))


def test_yi_train_flops_by_hand():
    # d 4096, 32 q and 4 kv heads of 128, F 11008, V 64000, 8 layers
    layer = 4096 * 40 * 128 + 4096 * 4096 + 3 * 4096 * 11008
    params = 8 * layer + 4096 * 64000
    assert peaks.matmul_params(shape("yi-6b-l8")) == params == 1_646_264_320
    tokens = 4 * 2048
    attn = 3 * 4 * 32 * 128 * (2048 * 2049 // 2) * 4 * 8
    flops = peaks.train_flops(shape("yi-6b-l8"), 4, 2048)
    assert flops == 6 * params * tokens + attn
    assert f"{flops:.3g}" == "8.42e+13"


YI_SHAPES = {  # the values of the harness before it read the moe family
    "yi-6b-l8": dict(layers=8, matmul_params=1646264320.0, train_flops=84217329352704.0,
                     serve_flops=233314367569920.0, norm_launches=17, attn_launches=8,
                     wo_scale=0.00390625, mlp_wo_scale=0.002382790161446948),
    "yi-6b": dict(layers=32, matmul_params=5798625280.0, train_flops=298214611746816.0,
                  serve_flops=830203420999680.0, norm_launches=65, attn_launches=32,
                  wo_scale=0.001953125, mlp_wo_scale=0.001191395080723474),
}


@pytest.mark.parametrize("name", YI_SHAPES)
def test_dense_readings_stay_as_they_were(name):
    want, s = YI_SHAPES[name], shape(name)
    assert s == Shape(name, layers=want["layers"], hidden=4096, heads=32, kv_heads=4,
                      ffn=11008, vocab=64000, tie=False, rope_theta=10000.0, norm_eps=1e-6)
    L = want["layers"]
    assert leaf_specs(s) == [
        ("embed", (64000, 4096), 0.015625, False), ("final_norm", (4096,), 0.1, True),
        ("layers.ln1", (L, 4096), 0.1, True), ("layers.ln2", (L, 4096), 0.1, True),
        ("layers.attn.wqkv", (L, 4096, 5120), 0.015625, False),
        ("layers.attn.wo", (L, 4096, 4096), want["wo_scale"], False),
        ("layers.mlp.wi", (L, 4096, 22016), 0.015625, False),
        ("layers.mlp.wo", (L, 11008, 4096), want["mlp_wo_scale"], False),
        ("lm_head", (4096, 64000), 0.015625, False)]
    assert [leaf_seed(2 ** 31 + 977, i) for i in (0, 8)] == [2147491067461794,
                                                              2147491067525146]
    assert peaks.matmul_params(s) == want["matmul_params"]
    assert peaks.train_flops(s, 4, 2048) == want["train_flops"]
    assert peaks.serve_batch_flops(s, 16, 4080, 16) == want["serve_flops"]
    assert peaks.train_norm_launches(s) == want["norm_launches"]
    assert peaks.train_attn_launches(s) == want["attn_launches"]


def test_granite_train_flops_by_hand():
    # d 1536, 24 q and 8 kv heads of 64, 40 experts of 512, top 8, V 49155 tied,
    # 16 layers: a token runs the router and 8 experts, not the 40
    s = shape("granite-moe-3b-a800m-l16")
    assert (s.experts, s.top_k, s.expert_ffn, s.ffn, s.head_dim) == (40, 8, 512, 0, 64)
    layer = 1536 * 40 * 64 + 1536 * 1536 + 1536 * 40 + 8 * 3 * 1536 * 512
    params = 16 * layer + 1536 * 49155
    assert peaks.matmul_params(s) == params == 479_138_304
    attn = 3 * 4 * 24 * 64 * (2048 * 2049 // 2) * 8 * 16
    assert peaks.train_flops(s, 8, 2048) == 6 * params * 8 * 2048 + attn
    assert (peaks.train_norm_launches(s), peaks.train_attn_launches(s)) == (33, 16)
    assert [p for p, *_ in leaf_specs(s)][6:] == ["layers.moe.router", "layers.moe.wi",
                                                  "layers.moe.wo"]  # tied: no lm_head


def test_keys_the_port_does_not_run_are_refused_by_name():
    cfg = load_json(BENCH / "configs" / "granite-moe-3b-a800m-l16.json")
    for key, value in (("residual_multiplier", 0.22), ("logits_scaling", 6.0),
                       ("embedding_multiplier", 12.0), ("shared_intermediate_size", 1024)):
        with pytest.raises(ValueError, match=key):
            Shape.from_config(dict(cfg, **{key: value}))


def test_serve_flops_prefill_then_served_decode_steps():
    s = shape("yi-6b")
    per_tok = 2 * peaks.matmul_params(s)
    pair = 4 * 32 * 128 * 32
    want = 16 * (4080 * per_tok + pair * 4080 * 4081 // 2)
    want += sum(16 * (per_tok + pair * (4080 + i + 1)) for i in range(15))
    assert peaks.serve_batch_flops(s, 16, 4080, 16) == pytest.approx(want, rel=1e-12)


def test_kernel_bounds_by_hand():
    # K1 at (8192, 4096) bf16: 2 x 8192 x 4096 x 2 + 4096 x 2 bytes at 3.35 TB/s
    want = (2 * 8192 * 4096 + 4096) * 2 / 3.35e12
    assert peaks.rmsnorm_bound_s(8192, 4096) == pytest.approx(want)
    # K2 at yi's (4, 32, 4, 2048, 2048, 128), causal: bound by its operations
    ops = 4 * 4 * 32 * 128 * (2048 * 2049 // 2)
    assert peaks.attn_fwd_bound_s(4, 32, 4, 2048, 2048, 128) == pytest.approx(ops / 989e12)
    assert peaks.causal_pairs(3, 5) == 3 + 4 + 5


def test_union_counts_overlapping_kernels_once():
    assert union_s([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-9)
    assert union_s([(0, 100), (10, 20), (30, 40)]) == pytest.approx(100e-9)
    assert union_s([]) == 0
    assert gaps([(0, 10), (5, 15), (20, 30)]) == [(15, 20)]


def test_idle_share_and_breakdown():
    tr = Trace(device=[("void at::native::vectorized_elementwise_kernel<4, F>(int, F)", 0, 400),
                       ("_ZN12_GLOBAL__N_1_cu_0123abcd18rmsnorm_vec_kernelIfLi1EEEvPKT_", 300, 600),
                       ("ampere_bf16_s16816gemm", 800, 1000)],
               host=[("aten::mm", 550, 900), ("aten::copy_", 610, 700)],
               window_s=2000e-9, units=1, launches={}, counts=[3, 3])
    assert idle_share(tr) == pytest.approx(100 * (1 - 800 / 2000))
    b = breakdown(tr)
    assert b["device_ops"][0] == ["at::native::vectorized_elementwise_kernel", pytest.approx(4e-7)]
    assert ["rmsnorm_vec_kernel", pytest.approx(3e-7)] in b["device_ops"]
    assert b["idle_gaps"] == [["aten::mm", pytest.approx(2e-7)]]
    assert idle_share(None) is None


def test_fold_names():
    assert fold("_ZN12_GLOBAL__N_1_cu_5f3e2a1c14flash_fwd_bf16ILi128EEEvPK") == "flash_fwd_bf16"
    assert fold("void cutlass::Kernel2<cutlass_80_wmma>(Params)") == "cutlass::Kernel2"
    assert fold("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert fold("void (anonymous namespace)::rmsnorm_vec_kernel<__nv_bfloat16, 1, 4, 1, 128>"
                "(__nv_bfloat16 const*)") == "rmsnorm_vec_kernel"
    assert fold("void at::native::(anonymous namespace)::indexing_backward_kernel<float>"
                "(long const*)") == "at::native::indexing_backward_kernel"


@pytest.mark.parametrize("mix", ["train-b4-s2048", "train-b8-s2048", "serve-doc4k"])
def test_traffic_is_the_seeds(mix):
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    make = traffic.train_batch if m["driver"] == "train" else traffic.serve_prompts
    big = 2 ** 31 + 977
    a, b, c = make(m, 64000, big, 3), make(m, 64000, big, 3), make(m, 64000, big + 1, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (m["batch"], m.get("seq", m.get("prompt_len")))
    assert a.min() >= 0 and a.max() < 64000
    assert not np.array_equal(make(m, 64000, big, 4), a)
    assert len({r.tobytes() for r in a}) == a.shape[0]  # rows all differ
    assert traffic.sample(big, 100, 16) == traffic.sample(big, 100, 16)
    assert traffic.sample(big, 100, 16) != traffic.sample(big + 1, 100, 16)


K1 = "_ZN12_GLOBAL__N_1_cu_0123abcd18rmsnorm_vec_kernelIfLi1EEEvPKT_"
K2 = "_ZN12_GLOBAL__N_1_cu_5f3e2a1c14flash_fwd_bf16ILi128EEEvPK"


def _train_record(launches, device):
    s = shape("yi-6b-l8")
    mix = load_json(BENCH / "traffic" / "train-b4-s2048.json")
    tr = Trace(device=device, host=[], window_s=1.0, units=2, launches=launches,
               counts=[len(device)] * 2)
    return {"trace": tr, "shape": s, "mix": mix}


@pytest.mark.parametrize("metric,counter,kernel,per_step", [
    ("rmsnorm_roofline.train", "rmsnorm", K1, 17), ("attn_fwd_roofline.train",
                                                     "flash_attention", K2, 8)])
def test_roofline_readers(metric, counter, kernel, per_step):
    # two steps of yi-6b-l8, each kernel's events 1 ms in all
    events = [(kernel, 0, 500_000), (kernel, 600_000, 1_100_000)]
    assert read_metric(metric, _train_record({counter: 0}, [])) is None  # off the path
    got = read_metric(metric, _train_record({counter: 2 * per_step}, events))
    if counter == "rmsnorm":
        want = 17 * peaks.rmsnorm_bound_s(4 * 2048, 4096) / 0.5e-3
    else:
        want = 8 * peaks.attn_fwd_bound_s(4, 32, 4, 2048, 2048, 128) / 0.5e-3
    assert got == pytest.approx(100 * want)
    with pytest.raises(TraceError, match="launches"):  # other launches than the config's
        read_metric(metric, _train_record({counter: 2 * per_step + 2}, events))
    with pytest.raises(TraceError, match="no device event"):  # names changed or lost
        read_metric(metric, _train_record({counter: 2 * per_step}, []))


@pytest.mark.parametrize("metric", ["rmsnorm_roofline", "attn_fwd_roofline", "train_mfu",
                                    "idle_share"])
def test_the_moe_cell_reads_as_the_train_readers(metric):
    events = [(K1, 0, 500_000), (K2, 600_000, 1_100_000)]
    rec = dict(_train_record({"rmsnorm": 34, "flash_attention": 16}, events), steps=3,
               window_s=2.0)
    train = metric if metric == "train_mfu" else f"{metric}.train"
    assert read_metric(f"{metric}.moe", rec) == read_metric(train, rec) is not None


def test_queries_near_keys_make_attention_rest_on_each_token():
    # yi's head size, 128; the rows as a norm hands them to the product
    s = Shape("qk", layers=1, hidden=1024, heads=8, kv_heads=2, ffn=64, vocab=64)
    x = torch.randn(1, 512, 1024, generator=torch.Generator().manual_seed(1))

    def self_share(noise):
        w = make_weights(s, 2 ** 31 + 3, torch.float32, "cpu", noise)
        q, k, _ = (x @ w["layers"]["attn"]["wqkv"][0]).split([1024, 256, 256], dim=-1)
        q = q.reshape(1, 512, 8, 128).transpose(1, 2).reshape(1, 2, 4, 512, 128)
        k = k.reshape(1, 512, 2, 128).transpose(1, 2)
        p = torch.softmax(torch.einsum("bhgsd,bhtd->bhgst", q, k) * s.scale, dim=-1)
        return float(p.diagonal(dim1=-2, dim2=-1).mean())

    plain, near = self_share(None), self_share(0.5)
    assert plain < 0.02 and near > 0.8, (plain, near)
    w = make_weights(s, 5, torch.float32, "cpu", 0.5)
    again = make_weights(s, 5, torch.float32, "cpu", 0.5)
    assert torch.equal(w["layers"]["attn"]["wqkv"], again["layers"]["attn"]["wqkv"])
    # only the queries' columns differ from the independent draw
    plain_w = make_weights(s, 5, torch.float32, "cpu")["layers"]["attn"]["wqkv"]
    assert torch.equal(w["layers"]["attn"]["wqkv"][..., 1024:], plain_w[..., 1024:])
