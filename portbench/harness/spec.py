"""The benchmark's own reading of a configuration file (the model's published
``config.json`` keys, as run) and of ``BENCHMARK.json``.

Nothing here imports the program: the plain reference and the metric
arithmetic take their sizes from :class:`Shape`, and only a driver turns one
into the port's ``ModelArch``.

Besides the llama keys, a configuration's own head size and its attention
windows are read from their published keys:

  * ``head_dim`` where stated, else ``hidden_size // num_attention_heads``;
  * ``layer_types``: one entry a layer, ``full_attention`` or
    ``sliding_attention``, whose query i sees the keys i - W < j <= i, W
    being ``sliding_window``. A file cut in depth states the list as run,
    and the published list under ``published``;
  * without ``layer_types``, a stated ``sliding_window`` covers every layer,
    unless ``use_sliding_window`` is false;
  * a sparse MLP from ``num_local_experts`` and ``intermediate_size``, or
    from ``num_experts`` and ``moe_intermediate_size``;
  * the rotary base from ``rope_theta`` or ``rope_parameters``, plain rotary
    embedding only.

Any other layer kind, a list of another length, a ``max_window_layers``
without ``layer_types`` and a key of ``NEUTRAL`` at another value are
refused by name: the benchmark would run another model than the file states.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]  # the checkout
BENCH = pathlib.Path(__file__).resolve().parents[1]  # portbench/
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


# Keys of a published configuration that the port has no option for, with the
# value at which they change nothing: a file that states another value is not
# what the port runs, and is refused by name.
NEUTRAL = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0, "logits_scaling": 1.0,
           "shared_intermediate_size": 0, "norm_topk_prob": True, "rope_scaling": None}
LAYER_KINDS = ("full_attention", "sliding_attention")


def _rope_theta(cfg: dict) -> float:
    """The rotary base: ``rope_theta``, or that of ``rope_parameters`` (one
    group, or one a layer kind), whose every group is plain rotary embedding
    at one base."""
    groups = cfg.get("rope_parameters") or {}
    if not all(isinstance(g, dict) for g in groups.values()):
        groups = {"": groups}
    thetas = {float(cfg["rope_theta"])} if "rope_theta" in cfg else set()
    for g in groups.values():
        if g.get("rope_type", "default") != "default":
            raise ValueError(f"{cfg['name']}: the benchmark does not run rope_parameters "
                             f"rope_type {g['rope_type']!r} (only 'default')")
        thetas |= {float(g["rope_theta"])} if "rope_theta" in g else set()
    if len(thetas) > 1:
        raise ValueError(f"{cfg['name']}: rope_theta and rope_parameters state the rotary "
                         f"bases {sorted(thetas)}; the benchmark runs one")
    return thetas.pop() if thetas else 10000.0


def _windows(cfg: dict, layers: int) -> tuple[int, ...]:
    """Each layer's attention window from the published keys: 0 for full
    attention, else the ``sliding_window`` W (query i sees keys i - W < j <=
    i)."""
    name, kinds = cfg["name"], cfg.get("layer_types")
    W = int(cfg.get("sliding_window") or 0) if cfg.get("use_sliding_window", True) else 0
    if kinds is None:
        if W and cfg.get("max_window_layers", 0):
            raise ValueError(f"{name}: max_window_layers {cfg['max_window_layers']} without "
                             f"layer_types: state each layer's kind in layer_types")
        return (W,) * layers
    if len(kinds) != layers:
        raise ValueError(f"{name}: layer_types has {len(kinds)} entries, "
                         f"num_hidden_layers is {layers}")
    other = sorted(set(kinds) - set(LAYER_KINDS))
    if other:
        raise ValueError(f"{name}: the benchmark does not run layer_types {other} "
                         f"(only {list(LAYER_KINDS)})")
    if "sliding_attention" in kinds and not W:
        raise ValueError(f"{name}: layer_types has sliding_attention layers, "
                         f"but no sliding_window is in force")
    return tuple(W if k == "sliding_attention" else 0 for k in kinds)


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes and constants of one configuration as the benchmark runs it.
    A dense model's MLP is ``ffn`` wide; a mixture of experts has no dense
    MLP (``ffn`` 0) and routes each token to ``top_k`` of ``experts`` SwiGLU
    experts ``expert_ffn`` wide. ``head_dim`` is the configuration's own
    (``hidden // heads`` where it states none); ``windows`` holds each
    layer's attention window, 0 for full causal attention (all 0 where none
    is given)."""

    name: str
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    ffn: int
    vocab: int
    tie: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    attn_scale: float = 0.0  # 0: 1 / sqrt(head_dim)
    experts: int = 0
    top_k: int = 0
    expert_ffn: int = 0
    head_dim: int = 0  # 0: hidden // heads
    windows: tuple[int, ...] = ()  # (): every layer full

    def __post_init__(self):
        if not self.head_dim:
            object.__setattr__(self, "head_dim", self.hidden // self.heads)
        if not self.windows:
            object.__setattr__(self, "windows", (0,) * self.layers)

    @property
    def layer_types(self) -> tuple[str, ...]:
        """The published kind of each layer."""
        return tuple(LAYER_KINDS[bool(w)] for w in self.windows)

    @property
    def scale(self) -> float:
        return self.attn_scale or 1.0 / math.sqrt(self.head_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "Shape":
        """A llama-architecture configuration, dense or with sparse experts in
        place of its MLP (``num_local_experts`` or ``num_experts``,
        ``num_experts_per_tok``, and ``moe_intermediate_size``, else
        ``intermediate_size``, as the width of one expert), with its head size
        and attention windows as the module's docstring sets out."""
        for key, value in NEUTRAL.items():
            if cfg.get(key, value) != value:
                raise ValueError(f"{cfg['name']}: the benchmark does not run {key} "
                                 f"{cfg[key]!r} (only {value!r})")
        experts = int(cfg.get("num_local_experts", cfg.get("num_experts", 0)))
        ffn = int(cfg["intermediate_size"])
        layers = int(cfg["num_hidden_layers"])
        return cls(
            name=cfg["name"], layers=layers,
            hidden=int(cfg["hidden_size"]), heads=int(cfg["num_attention_heads"]),
            kv_heads=int(cfg["num_key_value_heads"]), ffn=0 if experts else ffn,
            vocab=int(cfg["vocab_size"]), tie=bool(cfg.get("tie_word_embeddings", False)),
            rope_theta=_rope_theta(cfg),
            norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            attn_scale=float(cfg.get("attention_multiplier", 0.0)),
            experts=experts, top_k=int(cfg["num_experts_per_tok"]) if experts else 0,
            expert_ffn=int(cfg.get("moe_intermediate_size", ffn)) if experts else 0,
            head_dim=int(cfg.get("head_dim") or 0), windows=_windows(cfg, layers),
        )


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: dict
    shape: Shape
    mix: dict
    checks: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # and with --trace 1


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell, its configuration (by its ``file``), its traffic mix
    (``traffic/<mix>.json``), its limits (``checks/<cell>.json``) and the
    metrics it reports, found by the names in ``BENCHMARK.json``."""
    bench = benchmark(root)
    w = by_name(bench["workloads"], name, "workload")
    c = by_name(bench["configs"], w["config"], "config")
    config = load_json(root / c["file"])
    if config["name"] != c["name"]:
        raise ValueError(f"{c['file']} holds {config['name']!r}, not {c['name']!r}")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, shape=Shape.from_config(config),
        mix=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(BENCH / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )
