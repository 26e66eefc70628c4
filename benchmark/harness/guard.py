"""Nothing the benchmark runs may load JAX or the JAX package.

Module names are compared by their top-level name, the part before the
first dot, whole: the port's own name, ``mustache_tpu_torch``, begins
with the JAX package's, ``mustache_tpu``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mustache_tpu"})
PROGRAM = "mustache_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    mods = sys.modules if modules is None else modules
    return sorted({top(m) for m in mods} & FORBIDDEN)


def imported_names(path: Path) -> set[str]:
    """Top-level names of the absolute imports in a Python file."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(top(node.module))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names.add(top(node.args[0].value))
    return names
