"""Recipe loader: YAML files -> one resolved config dict.

Counterpart of ``isp_tts_tpu/config/loader.py``, on the port's own YAML
reader (:mod:`.yamlio`):

- ``base:`` include-merge, a base path resolved against the including file;
- :func:`merge_dicts` deep merge (dicts merge, anything else replaces);
- ``_disable_: true`` subtree pruning;
- ``${a.b}`` interpolation; a value that is one whole interpolation keeps
  the type of what it points at;
- the resolvers ``version``, ``date``, ``index``, ``eval`` (arithmetic
  only), ``chips``/``gpus`` (NODES x CHIPS from the environment, else the
  number of CUDA devices) and ``env``.
"""

from __future__ import annotations

import ast
import copy
import datetime
import os
import re
from pathlib import Path
from typing import Any, Callable

from .yamlio import loads

_RESOLVERS: dict[str, Callable[..., Any]] = {}


def register_resolver(name: str, fn: Callable[..., Any], replace: bool = True) -> None:
    if not replace and name in _RESOLVERS:
        return
    _RESOLVERS[name] = fn


def _safe_eval(expr: str) -> Any:
    """Arithmetic-only eval for ``${eval:...}`` (no builtins, no names)."""
    node = ast.parse(expr, mode="eval")
    allowed = (
        ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Compare,
        ast.BoolOp, ast.IfExp, ast.Add, ast.Sub, ast.Mult, ast.Div,
        ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd, ast.Not,
        ast.And, ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
        ast.Tuple, ast.List,
    )
    for sub in ast.walk(node):
        if not isinstance(sub, allowed):
            raise ValueError(f"Disallowed expression in ${{eval:...}}: {expr!r}")
    return eval(compile(node, "<eval-resolver>", "eval"), {"__builtins__": {}}, {})


def _n_chips() -> int:
    """NODES x CHIPS (or GPUS) from the environment, else the CUDA device
    count (at least 1)."""
    nodes = os.environ.get("NODES")
    chips = os.environ.get("CHIPS", os.environ.get("GPUS"))
    if nodes is not None or chips is not None:
        return int(nodes or 1) * int(chips or 1)
    import torch

    return max(torch.cuda.device_count(), 1)


register_resolver("version", lambda: "v" + datetime.datetime.now().strftime("%y%m%d"))
register_resolver("date", lambda: datetime.datetime.now().strftime("%Y-%m-%d"))
register_resolver("index", lambda *args: "-".join(str(a) for a in args if str(a)))
register_resolver("eval", _safe_eval)
register_resolver("chips", _n_chips)
register_resolver("gpus", _n_chips)
register_resolver("env", lambda name, default="": os.environ.get(str(name), default))


def merge_dicts(base: dict, override: dict) -> dict:
    """Deep merge: dicts merge recursively; anything else is replaced."""
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_dicts(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def disable_nodes(cfg: Any) -> Any:
    """Remove every dict subtree that carries ``_disable_: true``."""
    if isinstance(cfg, dict):
        return {k: disable_nodes(v) for k, v in cfg.items()
                if not (isinstance(v, dict) and v.get("_disable_") is True)}
    if isinstance(cfg, list):
        return [disable_nodes(v) for v in cfg]
    return cfg


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: dict, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.lstrip("-").isdigit():
            node = node[int(part)]
        else:
            raise KeyError(f"Interpolation key not found: ${{{dotted}}}")
    return node


def _parse_resolver_arg(arg: str) -> Any:
    arg = arg.strip()
    try:
        return ast.literal_eval(arg)
    except (ValueError, SyntaxError):
        return arg


def _resolve_expr(expr: str, root: dict, stack: tuple) -> Any:
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            if name == "eval":
                return _RESOLVERS[name](argstr)
            args = [_parse_resolver_arg(a) for a in argstr.split(",")] if argstr else []
            return _RESOLVERS[name](*args)
    if expr in stack:
        raise ValueError(f"Interpolation cycle at ${{{expr}}}")
    return _resolve_value(_lookup(root, expr), root, stack + (expr,))


def _resolve_value(value: Any, root: dict, stack: tuple = ()) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value.strip())
        if full:  # a whole-string interpolation keeps its type
            return _resolve_expr(full.group(1), root, stack)

        def sub(m: re.Match) -> str:
            return str(_resolve_expr(m.group(1), root, stack))

        prev = None
        while prev != value and _INTERP_RE.search(value):
            prev = value
            value = _INTERP_RE.sub(sub, value)
        return value
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, stack) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root, stack) for v in value]
    return value


def resolve_interpolations(cfg: dict) -> dict:
    """Resolve every ``${...}`` reference and resolver against the root."""
    return _resolve_value(cfg, cfg)


def load_yaml(path: str | Path) -> dict:
    return loads(Path(path).read_text(encoding="utf-8")) or {}


def _load_with_bases(path: Path, seen: frozenset) -> dict:
    path = path.resolve()
    if str(path) in seen:
        raise ValueError(f"Cyclic `base:` include at {path}")
    cfg = load_yaml(path)
    bases = cfg.pop("base", None)
    if bases is None:
        return cfg
    if isinstance(bases, (str, Path)):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        bpath = Path(b)
        if not bpath.is_absolute():
            bpath = path.parent / bpath
        if not bpath.exists() and not str(bpath).endswith((".yaml", ".yml")):
            bpath = bpath.with_suffix(".yaml")
        merged = merge_dicts(merged, _load_with_bases(bpath, seen | {str(path)}))
    return merge_dicts(merged, cfg)


def load_recipe(config_name: str | Path, config_root: str | Path = ".",
                overrides: dict | None = None, resolve: bool = True) -> dict:
    """Load a recipe: base-merge, overrides, ``_disable_`` prune, interpolate."""
    path = Path(config_root) / str(config_name)
    if not path.exists() and not str(path).endswith((".yaml", ".yml")):
        path = path.with_suffix(".yaml")
    cfg = _load_with_bases(Path(path), frozenset())
    if overrides:
        cfg = merge_dicts(cfg, overrides)
    cfg = disable_nodes(cfg)
    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg


def parse_overrides(pairs: list[str] | None) -> dict:
    """``--set a.b.c=<yaml>`` pairs -> a nested override dict; each value
    is read as YAML, and one that is not YAML stays the raw string."""
    root: dict = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        try:
            value = loads(raw)
        except ValueError:
            value = raw
        node = root
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root
