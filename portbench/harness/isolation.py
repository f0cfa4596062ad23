"""What a run may not load: JAX, its libraries, and the JAX package
(``repro``), compared by the whole top-level name of each module, since the
port's name (``repro_torch``) begins with the JAX package's. The plain
reference (``portbench/refs``) may not import the program either.
"""
from __future__ import annotations

import ast
import pathlib
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM = "repro_torch"
REFS = pathlib.Path(__file__).resolve().parents[1] / "refs"


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def imported_by(path: pathlib.Path) -> set:
    """The top-level names a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def refs_imports() -> dict:
    """Each reference file's forbidden or program imports (empty when clean)."""
    bad = set(FORBIDDEN) | {PROGRAM}
    return {p.name: sorted(imported_by(p) & bad) for p in sorted(REFS.glob("*.py"))
            if imported_by(p) & bad}
