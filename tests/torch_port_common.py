"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: carry a JAX module's parameters into its port counterpart, and
perturb JAX parameters so zero-initialised ones (AdaLN) carry signal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from isp_tts_tpu.models.base import flatten_state
from isp_tts_tpu_torch.models.base import torch_name


def jax_flat(module) -> dict[str, np.ndarray]:
    """A JAX module's parameters as {dotted name: np.ndarray}."""
    state = nnx.state(module, nnx.Not(nnx.RngState))
    pure = state.to_pure_dict() if hasattr(state, "to_pure_dict") else state
    return {k: np.asarray(v) for k, v in flatten_state(pure).items()}


def perturb(module, seed: int, scale: float = 0.1) -> dict[str, np.ndarray]:
    """Add seeded noise to every float parameter of a JAX module, in place;
    returns the new flat parameters."""
    rng = np.random.RandomState(seed)
    flat = {k: (v + scale * rng.randn(*v.shape)).astype(v.dtype)
            if np.issubdtype(v.dtype, np.floating) else v
            for k, v in jax_flat(module).items()}
    state = nnx.state(module, nnx.Not(nnx.RngState))
    _set(state, flat)
    nnx.update(module, state)
    return flat


def _set(state, flat, prefix=""):
    for k, v in state.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):
            _set(v, flat, name + ".")
        elif name in flat:
            v.value = jnp.asarray(flat[name])


def carry(flat: dict[str, np.ndarray], module: torch.nn.Module) -> None:
    """Load JAX flat parameters into a port module (strict), through the
    same name and layout mapping as ``Model.load_jax_state``."""
    own = module.state_dict()
    out = {}
    for key, value in flat.items():
        name, transpose = torch_name(key)
        arr = np.asarray(value).T if transpose else np.asarray(value)
        out[name] = torch.from_numpy(np.array(arr)).to(own[name].dtype)
    module.load_state_dict(out, strict=True)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))
