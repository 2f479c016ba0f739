"""Model base: ``from_pretrained`` and the weight carry from the JAX package.

Counterpart of ``isp_tts_tpu/models/base.py``. :func:`load_jax_state` maps
the JAX package's flat dotted parameter names (``Model.state_dict()`` there,
or a checkpoint's ``state``) onto the port's module tree: flax's Dense
``kernel`` (in, out) becomes torch's ``weight`` (out, in), a Conv ``kernel``
(K, in, out) the Conv1d ``weight`` (out, in, K) by the same reversal of
axes, LayerNorm
``scale`` and Embed ``embedding`` become ``weight``, and every value is cast
to the port parameter's dtype, as ``load_params`` casts to the live one.
:meth:`Model.jax_state` is the inverse, the JAX flat names and layouts a
checkpoint stores; :meth:`Model.load_params` is the JAX package's partial
load (``ignore_layers``, shape-mismatched tensors skipped) for resume and
warm start; :meth:`Model.freeze` records the fine-tuning prefixes the
trainer's freeze mask reads.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..checkpoint import load_checkpoint, save_checkpoint
from ..config import build_config, config_to_dict
from ..utils.device import resolve_device

logger = logging.getLogger("isp_tts_tpu_torch")


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

    def __init__(self):
        super().__init__()
        #: ["*", prefix, ...] when frozen: only parameters under a prefix train
        self.frozen_prefixes: list[str] = []

    @staticmethod
    def inject_data_config(config: dict, dataset) -> dict:
        """Copy dataset-derived fields into the model config."""
        return config

    def freeze(self, exception_list: list[str] | None = None) -> None:
        """Freeze every parameter but those whose name starts with an entry
        of ``exception_list`` (empty: train everything)."""
        exception_list = list(exception_list or [])
        self.frozen_prefixes = ["*"] + [str(p) for p in exception_list] if exception_list else []

    def is_trainable(self, name: str) -> bool:
        """Prefix match of the JAX flat name (or the port's: the prefixes
        are module paths, the same in both)."""
        if not self.frozen_prefixes:
            return True
        return any(name.startswith(e) for e in self.frozen_prefixes[1:])

    def jax_names(self) -> dict[str, tuple[str, bool | tuple]]:
        """Port state name -> (JAX flat name, its layout there:
        :func:`~isp_tts_tpu_torch.training.optimizers.to_jax_array`)."""
        from ..training.optimizers import jax_param_name

        params = dict(self.named_parameters())
        return {n: (jax_param_name(self, n) if n in params else (n, False))
                for n in self.state_dict()}

    def jax_state(self) -> dict[str, np.ndarray]:
        """Parameters and buffers as the JAX package's flat state: its
        names, its layouts, float32."""
        from ..training.optimizers import to_jax_array

        own = self.state_dict()
        out = {}
        for name, (jname, layout) in self.jax_names().items():
            arr = own[name].detach().cpu()
            arr = (arr.float() if arr.is_floating_point() else arr).numpy()
            out[jname] = np.array(to_jax_array(arr, layout), order="C")
        return out

    def load_params(self, flat: dict[str, np.ndarray], ignore_layers: list[str] | None = None,
                    ignore_mismatched: bool = True) -> None:
        """Load a JAX flat state partially, as ``Model.load_params`` there:
        keys holding an ``ignore_layers`` substring are skipped, unknown keys
        warned about, shape-mismatched ones skipped (or raised on), and
        tensors not given keep their values."""
        from ..training.optimizers import from_jax_array

        names = {jname: (name, rev) for name, (jname, rev) in self.jax_names().items()}
        own = self.state_dict()
        accepted = {}
        for key, value in flat.items():
            if ignore_layers and any(il in key for il in ignore_layers):
                logger.info("load_params: ignoring %s (ignore_layers)", key)
                continue
            if key not in names:
                logger.warning("load_params: unexpected key %s", key)
                continue
            name, rev = names[key]
            arr = from_jax_array(np.asarray(value), rev)
            if tuple(arr.shape) != tuple(own[name].shape):
                if ignore_mismatched:
                    logger.warning("load_params: shape mismatch for %s: ckpt %s vs model %s "
                                   "- skipped", key, np.shape(value), tuple(own[name].shape))
                    continue
                raise ValueError(f"shape mismatch for {key}")
            accepted[name] = torch.from_numpy(np.array(arr)).to(own[name].dtype)
        if len(accepted) < len(own):
            logger.info("load_params: %d keys kept at their values", len(own) - len(accepted))
        self.load_state_dict(accepted, strict=False)

    def save_pretrained(self, path: str | Path, extra: dict | None = None) -> None:
        save_checkpoint(path, {"format": "isp_tts_tpu.v1",
                               "model": {"class": type(self).__name__,
                                         "config": config_to_dict(self.config),
                                         "state": self.jax_state()},
                               **(extra or {})})

    def load_jax_state(self, flat: dict[str, np.ndarray]) -> None:
        """Load the JAX package's flat parameters, strictly: every port
        tensor must be given with its shape, and every given tensor must be
        used."""
        from ..training.optimizers import from_jax_array

        own = self.state_dict()
        names = {jname: (name, layout) for name, (jname, layout) in self.jax_names().items()}
        mapped: dict[str, torch.Tensor] = {}
        unexpected = []
        for key, value in flat.items():
            if key not in names:
                unexpected.append(key)
                continue
            name, layout = names[key]
            arr = from_jax_array(np.asarray(value), layout)
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
