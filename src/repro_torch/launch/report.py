"""Render the port's dry-run artifacts into roofline tables, the counterpart
of ``repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report [TAG]
"""
from __future__ import annotations

import glob
import json
import os


def load_cells(art_dir: str = "artifacts/dryrun_torch", tag: str | None = None) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        base = os.path.basename(path)[:-5]
        parts = base.split("__")
        cell_tag = parts[3] if len(parts) > 3 else None
        if cell_tag != tag:
            continue
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def markdown_table(cells: list[dict], *, single_pod_only: bool = True) -> str:
    rows = [
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | "
        "dominant | useful/HLO | roofline frac | mem/dev (GB) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if not c.get("ok"):
            rows.append(f"| {c.get('arch')} | {c.get('shape')} | {c.get('mesh')} "
                        f"| FAILED | | | | | | |")
            continue
        if single_pod_only and c["mesh"].startswith("2x"):
            continue
        r = c["roofline"]
        m = (c.get("memory", {}).get("per_device_total") or 0) / 1e9
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['collective_s']:.4g} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.4f} "
            f"| {m:.1f} |"
        )
    return "\n".join(rows)


def summary(cells: list[dict]) -> dict:
    ok = [c for c in cells if c.get("ok")]
    return {
        "cells_ok": len(ok),
        "cells_failed": len(cells) - len(ok),
        "dominant_counts": {
            d: sum(1 for c in ok if c["roofline"]["dominant"] == d)
            for d in ("compute", "memory", "collective")
        },
        "worst_fraction": min(
            (c["roofline"]["roofline_fraction"], c["arch"], c["shape"], c["mesh"])
            for c in ok
        ),
        "best_fraction": max(
            (c["roofline"]["roofline_fraction"], c["arch"], c["shape"], c["mesh"])
            for c in ok
        ),
    }


if __name__ == "__main__":
    import sys

    tag = sys.argv[1] if len(sys.argv) > 1 else None
    cells = load_cells(tag=tag)
    print(markdown_table(cells, single_pod_only=False))
    print()
    print(json.dumps(summary(cells), indent=1))
