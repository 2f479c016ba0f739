"""Configs: dataclasses from dicts, registries, and the recipe loader."""

from .loader import (disable_nodes, load_recipe, load_yaml, merge_dicts,
                     parse_overrides, register_resolver, resolve_interpolations)
from .registry import MISSING, Registry, as_dict, build_config, config_to_dict, strip_meta

__all__ = ["MISSING", "Registry", "as_dict", "build_config", "config_to_dict",
           "disable_nodes", "load_recipe", "load_yaml", "merge_dicts",
           "parse_overrides", "register_resolver", "resolve_interpolations",
           "strip_meta"]
