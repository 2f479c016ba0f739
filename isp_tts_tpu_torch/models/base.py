"""Model base: ``from_pretrained`` and the weight carry from the JAX package.

Counterpart of ``isp_tts_tpu/models/base.py``. :func:`load_jax_state` maps
the JAX package's flat dotted parameter names (``Model.state_dict()`` there,
or a checkpoint's ``state``) onto the port's module tree: flax's Dense
``kernel`` (in, out) becomes torch's ``weight`` (out, in), LayerNorm
``scale`` and Embed ``embedding`` become ``weight``, and every value is cast
to the port parameter's dtype, as ``load_params`` casts to the live one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..checkpoint import load_checkpoint
from ..config import build_config
from ..utils.device import resolve_device


def torch_name(jax_name: str) -> tuple[str, bool]:
    """The port's name for a JAX parameter, and whether to transpose it."""
    prefix, _, leaf = jax_name.rpartition(".")
    if leaf == "kernel":
        return f"{prefix}.weight", True
    if leaf in ("scale", "embedding"):
        return f"{prefix}.weight", False
    return jax_name, False


class Model(nn.Module):
    """Base for the port's models; subclasses set ``Config``."""

    Config: type = None  # type: ignore
    #: prefixes of checkpoint tensors that belong to training-only modules
    training_only: tuple = ()

    def load_jax_state(self, flat: dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameters, strictly: every port
        tensor must be given with its shape, and every given tensor must be
        used, apart from those under ``training_only`` prefixes."""
        own = self.state_dict()
        mapped: dict[str, torch.Tensor] = {}
        unexpected = []
        for key, value in flat.items():
            if key.startswith(self.training_only):
                continue
            name, transpose = torch_name(key)
            if name not in own:
                unexpected.append(key)
                continue
            arr = np.asarray(value)
            if transpose:
                arr = arr.T
            if tuple(arr.shape) != tuple(own[name].shape):
                raise ValueError(f"{key}: shape {arr.shape} does not fit "
                                 f"{name} {tuple(own[name].shape)}")
            mapped[name] = torch.from_numpy(np.array(arr)).to(own[name].dtype)
        missing = sorted(set(own) - set(mapped))
        if unexpected or missing:
            raise KeyError(f"unexpected JAX tensors {unexpected}; "
                           f"port tensors not given {missing}")
        self.load_state_dict(mapped, strict=True)

    @classmethod
    def from_pretrained(cls, path: str | Path, device: str | torch.device | None = None):
        """Rebuild the model from a ``.ckpt`` file's embedded config and
        weights, in eval mode, on ``device`` (CUDA unless named)."""
        dev = resolve_device(device)
        blob = load_checkpoint(path)["model"]
        model = cls(build_config(cls.Config, blob["config"]))
        model.load_jax_state(blob["state"])
        return model.to(dev).eval()
