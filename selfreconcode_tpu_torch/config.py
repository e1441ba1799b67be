"""Config system: a minimal HOCON-subset parser preserving the reference's
`config.conf` semantics verbatim (train/sdf_net/mlp_deformer/render_net/
loss_{coarse,medium,fine} blocks; pyhocon-style get_int/get_float/get_bool/
get_config/get_list and dotted-path `in` checks).

The environment has no pyhocon, so this implements exactly the subset the
reference configs use: nested `name { ... }` blocks, `key = value` pairs,
numbers, quoted-number strings ("60."), booleans, strings, and `[ ... ]`
lists (one element per line), plus `#`/`//` comments.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List


class ConfigTree:
    def __init__(self, data: Dict[str, Any]):
        self._data = data

    # -- pyhocon-compatible accessors ---------------------------------------
    def _resolve(self, path: str):
        node: Any = self._data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(path)
            node = node[part]
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except KeyError:
            return False

    def get(self, path: str, default=None):
        try:
            v = self._resolve(path)
        except KeyError:
            return default
        return ConfigTree(v) if isinstance(v, dict) else v

    def get_int(self, path: str) -> int:
        return int(float(self._resolve(path)))

    def get_float(self, path: str) -> float:
        return float(self._resolve(path))

    def get_bool(self, path: str) -> bool:
        v = self._resolve(path)
        if isinstance(v, bool):
            return v
        return str(v).lower() == "true"

    def get_string(self, path: str) -> str:
        return str(self._resolve(path))

    def get_list(self, path: str) -> List:
        v = self._resolve(path)
        assert isinstance(v, list), path
        return v

    def get_config(self, path: str) -> "ConfigTree":
        v = self._resolve(path)
        assert isinstance(v, dict), path
        return ConfigTree(v)

    def as_dict(self) -> Dict[str, Any]:
        return self._data

    def dump(self, indent: int = 0) -> str:
        out = []
        pad = "  " * indent
        for k, v in self._data.items():
            if isinstance(v, dict):
                out.append(f"{pad}{k} {{")
                out.append(ConfigTree(v).dump(indent + 1))
                out.append(f"{pad}}}")
            elif isinstance(v, list):
                out.append(f"{pad}{k} = [")
                for item in v:
                    out.append(f"{pad}  {item}")
                out.append(f"{pad}]")
            elif isinstance(v, bool):
                out.append(f"{pad}{k} = {'true' if v else 'false'}")
            elif isinstance(v, str):
                out.append(f'{pad}{k} = "{v}"')
            else:
                out.append(f"{pad}{k} = {v}")
        return "\n".join(out)


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _parse_value(tok: str):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"'):
        inner = tok[1:-1]
        # the reference writes weights as quoted numbers ("60.") and relies on
        # pyhocon's get_float to coerce; keep them as strings, accessors coerce
        return inner
    if tok in ("true", "false"):
        return tok == "true"
    if _NUM_RE.match(tok):
        f = float(tok)
        return int(f) if f.is_integer() and "." not in tok and "e" not in tok.lower() else f
    return tok


def parse_hocon(text: str) -> ConfigTree:
    root: Dict[str, Any] = {}
    stack = [root]
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].split("#")[0].split("//")[0].strip()
        i += 1
        if not line:
            continue
        if line == "}" or line == "]":
            stack.pop()
            continue
        m = re.match(r"^([\w.\-]+)\s*\{$", line)
        if m:
            child: Dict[str, Any] = {}
            stack[-1][m.group(1)] = child
            stack.append(child)
            continue
        m = re.match(r"^([\w.\-]+)\s*=\s*\[\s*$", line)
        if m:
            lst: List = []
            stack[-1][m.group(1)] = lst
            # read list items until closing ]
            while i < len(lines):
                item = lines[i].split("#")[0].split("//")[0].strip()
                i += 1
                if item == "]":
                    break
                if item:
                    lst.append(_parse_value(item.rstrip(",")))
            continue
        m = re.match(r"^([\w.\-]+)\s*[=:]\s*(.+)$", line)
        if m:
            stack[-1][m.group(1)] = _parse_value(m.group(2))
            continue
        raise ValueError(f"cannot parse config line: {line!r}")
    if len(stack) != 1:
        raise ValueError("unbalanced braces in config")
    return ConfigTree(root)


def parse_file(path: str) -> ConfigTree:
    with open(path) as f:
        return parse_hocon(f.read())
