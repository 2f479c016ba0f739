"""Config dataclasses from plain dicts, and name -> class registries.

Counterpart of ``isp_tts_tpu/config/registry.py``. :func:`build_config`
builds a config dataclass from a dict and keyword overrides (the overrides
win), recursing into fields whose type is itself a config dataclass.
Undeclared keys that start with ``_`` (the recipe loader's meta keys, such
as ``_name_``) are dropped, as there. Any other key the dataclass does not
declare raises, unless the dataclass lists it in its ``IGNORED_KEYS``: keys
of the JAX config that cannot change what the port computes. So a setting
the port does not compute is refused, never silently dropped. A field left
at the recipe's ``???`` raises, as there. :class:`Registry` maps the
recipes' ``_name_`` strings to classes.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Type, TypeVar

T = TypeVar("T")

MISSING = "???"


def _dataclass_of(hint: Any) -> type | None:
    if dataclasses.is_dataclass(hint):
        return hint
    for arg in typing.get_args(hint):
        if dataclasses.is_dataclass(arg):
            return arg
    return None


def strip_meta(cfg: dict) -> dict:
    """``cfg`` without its ``_``-prefixed meta keys."""
    return {k: v for k, v in cfg.items() if not k.startswith("_")}


def build_config(config_cls: Type[T], cfg: dict | None = None, **kwargs) -> T:
    """Build ``config_cls`` from ``cfg`` updated by ``kwargs``."""
    merged = dict(cfg or {})
    merged.update(kwargs)
    names = {f.name for f in dataclasses.fields(config_cls)}
    ignored = getattr(config_cls, "IGNORED_KEYS", frozenset())
    unknown = sorted(k for k in merged
                     if k not in names and k not in ignored and not k.startswith("_"))
    if unknown:
        raise ValueError(f"{config_cls.__name__}: the port does not compute {unknown}")
    hints = typing.get_type_hints(config_cls)
    known = {}
    for f in dataclasses.fields(config_cls):
        if f.name not in merged:
            continue
        value = merged[f.name]
        if isinstance(value, str) and value == MISSING:
            raise ValueError(f"{config_cls.__name__}.{f.name} is required (MISSING)")
        sub = _dataclass_of(hints.get(f.name))
        if sub is not None and isinstance(value, dict):
            value = build_config(sub, value)
        known[f.name] = value
    return config_cls(**known)


def as_dict(cfg: Any) -> dict:
    """A config given as a dict or a dataclass, as a dict."""
    if isinstance(cfg, dict):
        return cfg
    if dataclasses.is_dataclass(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    raise TypeError(f"cannot read {type(cfg).__name__} as a config")


def config_to_dict(obj: Any) -> Any:
    """Recursive dataclass -> plain dict, tuples as lists (what a
    checkpoint embeds)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: config_to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    return obj


class Registry:
    """Name -> class, for the recipes' ``_name_`` keys."""

    def __init__(self, name: str):
        self.name = name
        self._map: dict[str, type] = {}

    def add(self, name: str, cls: type) -> None:
        self._map[name] = cls

    def register(self, name: str | None = None):
        def deco(cls):
            self._map[name or cls.__name__] = cls
            return cls
        return deco

    def get(self, name: str) -> type:
        if name not in self._map:
            raise KeyError(f"{self.name} registry has no entry {name!r}; "
                           f"known: {sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def keys(self):
        return self._map.keys()
