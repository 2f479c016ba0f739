"""Config dataclasses from the plain dicts a checkpoint embeds.

A copy of the one function of ``isp_tts_tpu/config/registry.py`` that
serving needs: :func:`build_config` builds a config dataclass from a dict
and keyword overrides (the overrides win), recursing into fields whose type
is itself a config dataclass. Keys the dataclass does not declare are
dropped, so a checkpoint written with more settings than the port uses
still loads.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Type, TypeVar

T = TypeVar("T")


def _dataclass_of(hint: Any) -> type | None:
    if dataclasses.is_dataclass(hint):
        return hint
    for arg in typing.get_args(hint):
        if dataclasses.is_dataclass(arg):
            return arg
    return None


def build_config(config_cls: Type[T], cfg: dict | None = None, **kwargs) -> T:
    """Build ``config_cls`` from ``cfg`` updated by ``kwargs``."""
    merged = dict(cfg or {})
    merged.update(kwargs)
    hints = typing.get_type_hints(config_cls)
    known = {}
    for f in dataclasses.fields(config_cls):
        if f.name not in merged:
            continue
        value = merged[f.name]
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
