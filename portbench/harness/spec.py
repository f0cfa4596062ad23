"""The benchmark's own reading of a configuration file (the model's published
``config.json`` keys, as run) and of ``BENCHMARK.json``.

Nothing here imports the program: the plain reference and the metric
arithmetic take their sizes from :class:`Shape`, and only a driver turns one
into the port's ``ModelArch``.
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
           "shared_intermediate_size": 0, "sliding_window": None}


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes and constants of one configuration as the benchmark runs it.
    A dense model's MLP is ``ffn`` wide; a mixture of experts has no dense
    MLP (``ffn`` 0) and routes each token to ``top_k`` of ``experts`` SwiGLU
    experts ``expert_ffn`` wide."""

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

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def scale(self) -> float:
        return self.attn_scale or 1.0 / math.sqrt(self.head_dim)

    @classmethod
    def from_config(cls, cfg: dict) -> "Shape":
        """A llama-architecture configuration, dense or with sparse experts in
        place of its MLP (``num_local_experts``, ``num_experts_per_tok``, and
        ``intermediate_size`` as the width of one expert)."""
        for key, value in NEUTRAL.items():
            if cfg.get(key, value) != value:
                raise ValueError(f"{cfg['name']}: the benchmark does not run {key} "
                                 f"{cfg[key]!r} (only {value!r})")
        experts = int(cfg.get("num_local_experts", 0))
        ffn = int(cfg["intermediate_size"])
        return cls(
            name=cfg["name"], layers=int(cfg["num_hidden_layers"]),
            hidden=int(cfg["hidden_size"]), heads=int(cfg["num_attention_heads"]),
            kv_heads=int(cfg["num_key_value_heads"]), ffn=0 if experts else ffn,
            vocab=int(cfg["vocab_size"]), tie=bool(cfg.get("tie_word_embeddings", False)),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            attn_scale=float(cfg.get("attention_multiplier", 0.0)),
            experts=experts, top_k=int(cfg["num_experts_per_tok"]) if experts else 0,
            expert_ffn=ffn if experts else 0,
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
