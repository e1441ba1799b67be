"""What the benchmark must not load: JAX and the JAX package, which the
port replaces.  Names are compared by their top-level module (the part
before the first dot), whole: ``selfreconcode_tpu_torch`` is the port and
may be imported by the harness, never by ``reference/``."""
from __future__ import annotations

import ast
import os
import os.path as osp
import sys
from typing import List

HERE = osp.dirname(osp.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "selfreconcode_tpu")
PORT = "selfreconcode_tpu_torch"


def _top(name: str) -> str:
    return name.split(".")[0]


def source_imports(path: str) -> List[str]:
    """Module names imported by one source file (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def static_violations(root: str = HERE) -> List[str]:
    """'file: module' for each forbidden import in the benchmark's sources
    (the port counts as forbidden under reference/)."""
    bad = []
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = osp.join(d, f)
            in_ref = osp.join(root, "reference") in path
            for m in source_imports(path):
                top = _top(m)
                if top in FORBIDDEN or (in_ref and top == PORT):
                    bad.append(f"{osp.relpath(path, root)}: {m}")
    return bad


def loaded_violations() -> List[str]:
    """Forbidden modules in this process's sys.modules."""
    return sorted(m for m in list(sys.modules) if _top(m) in FORBIDDEN)
