"""The yardstick's arithmetic against counts worked by hand and against the
figures it read before it took a configuration's own head size and windows,
the reading of those keys, the roofline readers, the traffic generator's
seeding and the weights' attention."""
import numpy as np
import pytest
import torch

from portbench.harness import peaks, traffic
from portbench.harness.spec import BENCH, Shape, load_json
from portbench.harness.trace import (Trace, TraceError, breakdown, fold, gaps, idle_share,
                                     union_s)
from portbench.harness.weights import leaf_seed, leaf_specs, make_weights
from portbench.run import read_metric
from portbench.tests.cells import DENSE

DENSE_4 = dict(DENSE, num_hidden_layers=4)


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
    "yi-6b-l8": dict(layers=8, wo_scale=0.00390625, mlp_wo_scale=0.002382790161446948),
    "yi-6b": dict(layers=32, wo_scale=0.001953125, mlp_wo_scale=0.001191395080723474),
}


@pytest.mark.parametrize("name", YI_SHAPES)
def test_dense_readings_stay_as_they_were(name):
    want, s = YI_SHAPES[name], shape(name)
    assert s == Shape(name, layers=want["layers"], hidden=4096, heads=32, kv_heads=4,
                      ffn=11008, vocab=64000, tie=False, rope_theta=10000.0, norm_eps=1e-6)
    assert s.head_dim == 128 and s.windows == (0,) * want["layers"]
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


# the yardstick's figures of the cells' configurations as the harness read
# them before it took a head size and windows of a configuration's own: the
# train cells' B x S=2048 (B 4, yi-6b's as yi-6b-l8's; B 8 granite), and a
# served batch of 16 x 4080 + 16 tokens
PARENT = {
    "yi-6b-l8": dict(batch=4, matmul_params=1646264320.0, train_flops=84217329352704.0,
                     serve_flops=233314367569920.0, norm_launches=17, attn_launches=8,
                     norm_bound_s=0.0006811464597014926, attn_bound_s=0.0011122836184914054),
    "yi-6b": dict(batch=4, matmul_params=5798625280.0, train_flops=298214611746816.0,
                  serve_flops=830203420999680.0, norm_launches=65, attn_launches=32,
                  norm_bound_s=0.00260438352238806, attn_bound_s=0.0044491344739656215),
    "granite-moe-3b-a800m-l16": dict(
        batch=8, matmul_params=479138304.0, train_flops=52051430080512.0,
        serve_flops=75977201664000.0, norm_launches=33, attn_launches=16,
        norm_bound_s=0.0009916388489552238, attn_bound_s=0.0016684254277371082),
}


@pytest.mark.parametrize("name", PARENT)
def test_yardstick_reads_as_before(name):
    want, s, S = PARENT[name], shape(name), 2048
    B = want["batch"]
    assert peaks.matmul_params(s) == want["matmul_params"]
    assert peaks.train_flops(s, B, S) == want["train_flops"]
    assert peaks.serve_batch_flops(s, 16, 4080, 16) == want["serve_flops"]
    assert peaks.train_norm_launches(s) == want["norm_launches"]
    assert peaks.train_attn_launches(s, S) == want["attn_launches"]
    assert (peaks.train_norm_launches(s) * peaks.rmsnorm_bound_s(B * S, s.hidden)
            == want["norm_bound_s"])
    assert (peaks.train_attn_launches(s, S) * peaks.attn_fwd_bound_s(
        B, s.heads, s.kv_heads, S, S, s.head_dim) == want["attn_bound_s"])


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
    assert (peaks.train_norm_launches(s), peaks.train_attn_launches(s, 2048)) == (33, 16)
    assert [p for p, *_ in leaf_specs(s)][6:] == ["layers.moe.router", "layers.moe.wi",
                                                  "layers.moe.wo"]  # tied: no lm_head


@pytest.mark.parametrize("key,value", [
    ("residual_multiplier", 0.22), ("logits_scaling", 6.0), ("embedding_multiplier", 12.0),
    ("shared_intermediate_size", 1024), ("norm_topk_prob", False),
    ("rope_scaling", {"rope_type": "yarn", "factor": 16.0})])
def test_keys_the_port_does_not_run_are_refused_by_name(key, value):
    cfg = load_json(BENCH / "configs" / "granite-moe-3b-a800m-l16.json")
    with pytest.raises(ValueError, match=key):
        Shape.from_config(dict(cfg, **{key: value}))


# Mellum2-12B-A2.5B-Instruct's published keys, cut to one period of its layer
# pattern (three sliding-window layers, then one of full attention)
MELLUM2 = {
    "name": "mellum2-style", "head_dim": 128, "hidden_size": 2304, "intermediate_size": 7168,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"], "max_window_layers": 0,
    "moe_intermediate_size": 896, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_experts": 64, "num_experts_per_tok": 8, "num_hidden_layers": 4,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-6, "sliding_window": 1024,
    "tie_word_embeddings": False, "use_sliding_window": True, "vocab_size": 98304,
    "rope_parameters": {"full_attention": {"rope_type": "default", "rope_theta": 10000.0},
                        "sliding_attention": {"rope_type": "default", "rope_theta": 10000.0}},
    "published": {"num_hidden_layers": 28, "layer_types": (["sliding_attention"] * 3
                                                           + ["full_attention"]) * 7},
}


def test_a_stated_head_size_and_layer_types_are_read():
    s = Shape.from_config(MELLUM2)
    assert (s.head_dim, s.windows) == (128, (1024, 1024, 1024, 0)) and 2304 // 32 == 72
    assert s.scale == pytest.approx(128 ** -0.5) and s.rope_theta == 10000.0
    assert (s.experts, s.top_k, s.expert_ffn, s.ffn) == (64, 8, 896, 0)
    assert s.layer_types == tuple(MELLUM2["layer_types"])
    wqkv = dict((p, shape) for p, shape, *_ in leaf_specs(s))["layers.attn.wqkv"]
    assert wqkv == (4, 2304, (32 + 2 * 4) * 128)
    # the port sends a layer to K2 unless its window is shorter than S
    assert [peaks.train_attn_launches(s, S) for S in (4096, 1024, 1025)] == [1, 4, 1]


@pytest.mark.parametrize("keys,windows", [
    (dict(sliding_window=12), (12, 12, 12, 12)),
    (dict(sliding_window=12, use_sliding_window=False, max_window_layers=4), (0,) * 4),
    (dict(sliding_window=None), (0,) * 4),
    (dict(layer_types=["full_attention"] * 4), (0,) * 4),
    (dict(layer_types=["sliding_attention", "full_attention"] * 2, sliding_window=8),
     (8, 0, 8, 0))])
def test_windows_from_the_published_keys(keys, windows):
    cfg = dict(DENSE_4, **keys)
    assert Shape.from_config(cfg).windows == windows


@pytest.mark.parametrize("keys,named", [
    (dict(layer_types=["sliding_attention", "chunked_attention", "full_attention",
                       "full_attention"], sliding_window=8), "chunked_attention"),
    (dict(layer_types=["full_attention"] * 3), "layer_types has 3 entries"),
    (dict(layer_types=["sliding_attention"] * 4), "sliding_window"),
    (dict(layer_types=["sliding_attention"] * 4, sliding_window=8, use_sliding_window=False),
     "sliding_window"),
    (dict(sliding_window=8, max_window_layers=2), "max_window_layers"),
    (dict(rope_parameters={"rope_type": "yarn", "rope_theta": 1e4}), "yarn"),
    (dict(rope_theta=5e5, rope_parameters={"full_attention": {"rope_theta": 1e4}}),
     "rotary bases")])
def test_what_the_benchmark_does_not_run_is_refused_by_name(keys, named):
    with pytest.raises(ValueError, match=named):
        Shape.from_config(dict(DENSE_4, **keys))


@pytest.mark.parametrize("S,T,W", [(1, 1, 1), (5, 5, 1), (8, 8, 3), (8, 8, 8), (8, 8, 20),
                                   (3, 10, 4), (1, 10, 4), (1, 10, 11), (6, 9, 9), (7, 16, 5),
                                   (16, 16, 0), (4, 16, 0)])
def test_window_pairs_count_the_mask(S, T, W):
    brute = sum(1 for i in range(T - S, T) for j in range(T)
                if j <= i and (not W or j > i - W))
    assert peaks.window_pairs(S, T, W) == brute


def test_windowed_layers_count_their_own_pairs():
    s = Shape.from_config(MELLUM2)
    pair = 4.0 * 32 * 128
    full, banded = peaks.window_pairs(4096, 4096, 0), peaks.window_pairs(4096, 4096, 1024)
    assert banded == 1024 * 1025 // 2 + (4096 - 1024) * 1024
    attn = 3 * pair * (full + 3 * banded) * 2
    assert peaks.train_flops(s, 2, 4096) == 6 * peaks.matmul_params(s) * 2 * 4096 + attn
    # a decode step at position p reads min(p + 1, 1024) keys on a windowed layer
    want = 16 * (4080 * 2 * peaks.matmul_params(s)
                 + pair * (peaks.window_pairs(4080, 4080, 0) + 3 * peaks.window_pairs(4080, 4080, 1024)))
    want += sum(16 * (2 * peaks.matmul_params(s) + pair * (4080 + i + 1 + 3 * 1024))
                for i in range(15))
    assert peaks.serve_batch_flops(s, 16, 4080, 16) == want


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


def test_k2_roofline_counts_the_layers_k2_runs():
    # Mellum2's period at B=2 x S=4096: K2 runs the full layer, the three
    # sliding-window layers run banded_flash_xla
    s = Shape.from_config(MELLUM2)
    mix = dict(load_json(BENCH / "traffic" / "train-b4-s2048.json"), batch=2, seq=4096)
    events = [(K2, 0, 500_000), (K2, 600_000, 1_100_000)]

    def record(launches):
        return {"shape": s, "mix": mix, "trace": Trace(device=events, host=[], window_s=1.0,
                                                       units=2, launches=launches, counts=[2, 2])}

    want = 100 * peaks.attn_fwd_bound_s(2, 32, 4, 4096, 4096, 128) / 0.5e-3
    assert read_metric("attn_fwd_roofline.train", record({"flash_attention": 2})) == \
        pytest.approx(want)
    with pytest.raises(TraceError, match="launches"):  # K2 on every layer: not the port's rule
        read_metric("attn_fwd_roofline.train", record({"flash_attention": 8}))


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
