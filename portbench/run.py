"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic mix,
its limits and its metrics are found by the names in ``BENCHMARK.json``; the
mix names its driver (``drivers/<driver>.py``). With ``--trace 0`` the
result line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones (``metrics/<metric>.py`` each). The last lines on standard
error, and the result line's last key, give each number compared beside its
limit. Exits non-zero, and prints no result, without enough CUDA cards,
when the program is not in the checkout, or when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; the
    program and the benchmark importable."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def read_metric(name: str, record: dict):
    """``metrics/<name>.py``'s ``read(record)``: a number, or None when the
    run holds nothing for it to read."""
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from portbench.harness import isolation
    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", 3)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        _fail(f"the program (repro_torch) is not in {ROOT / 'src'}", 4)
    if isolation.refs_imports():
        _fail(f"the reference imports {isolation.refs_imports()}", 5)
    driver = importlib.import_module(f"portbench.drivers.{cell.mix['driver']}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)

    from portbench.harness.compare import verdict

    correct, checks = verdict(out["numbers"], cell.checks)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device_info}
    if args.trace:
        from portbench.harness.trace import breakdown, union_s

        tr = out["record"]["trace"]
        device_info["busy_s"] = union_s([(a, b) for _, a, b in tr.device])
        device_info["window_s"] = tr.window_s
        line["breakdown"] = breakdown(tr)
        print(f"trace units {tr.units} launches {tr.launches} device events of each trace "
              f"{tr.counts}", file=sys.stderr)
    found = isolation.loaded_forbidden()
    if found:
        _fail(f"the run loaded {', '.join(found)}: neither JAX nor the JAX package may load", 5)
    line["checks"] = checks
    for name, value in out["numbers"].items():
        if name not in checks and not name.startswith("_"):
            print(f"reported {name} {value!r}", file=sys.stderr)
    print(f"timing setup_s {out['setup_s']:.3f} window_s {out['record']['window_s']:.3f} "
          f"reference_s {out['reference_s']:.3f} total_s {time.perf_counter() - T_START:.3f}",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
