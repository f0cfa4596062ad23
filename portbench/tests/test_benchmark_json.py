"""BENCHMARK.json keeps to the contract's rules, and every name in it finds
its files."""
import json
import re

import pytest

from portbench.harness import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]
TEXT = re.compile(r"[^\t\n\r]{1,200}")


def names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.fullmatch(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w.split("/") for w in cmd)
    assert (ROOT / cmd[1]).is_file() and cmd[1].startswith(BENCH["paths"][0] + "/")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", sorted(set(names())))
def test_name_characters(name):
    assert spec.NAME_RE.fullmatch(name), name


def test_entries_have_only_their_keys_units_and_texts():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.fullmatch(c["source"]) and TEXT.fullmatch(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.fullmatch(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.fullmatch(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[kind]]
        assert len(got) == len(set(got)), kind
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports_enough(cell):
    c = spec.load_cell(cell)
    assert c.mix["driver"] in ("train", "serve")
    assert (ROOT / "portbench" / "drivers" / f"{c.mix['driver']}.py").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert c.checks["numbers"]
    assert all(v["lower"] < v["limit"] < v["upper"] for v in c.checks["numbers"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_an_e2e_metric_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    moved = E2E[m["moves"]]
    assert "workloads" in m
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", CELLS)
    if m["unit"] == "%" and (metric.endswith("_roofline") or "mfu" in metric):
        assert m["better"] == "higher"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_names_what_it_changed(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("portbench/configs/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert set(entry["reduced"]) == set(cfg["reduced"]) == set(cfg["published"])
    for key in entry["reduced"]:
        assert key in cfg and cfg[key] != cfg["published"][key], key
        assert not re.search(r"(hidden_size|intermediate_size|latent|state|proj|expan|_dim$|"
                             r"_rank$|head_dim|experts_per_tok)", key)
    assert sum(w["config"] == entry["name"] for w in BENCH["workloads"]) >= 1
    spec.Shape.from_config(cfg)
