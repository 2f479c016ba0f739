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
warm start; both loads move a transformer's layer stack between the
per-layer (``layers.<i>.*``) and the stacked (``stack.*``, ``pipeline:
true``) layouts (:func:`translate_layer_stacking`);
:meth:`Model.from_pretrained` also reads a reference ``.pt``
through the class's ``convert_torch_checkpoint``; :meth:`Model.freeze` records the fine-tuning prefixes the
trainer's freeze mask reads.
"""

from __future__ import annotations

import logging
import re
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


def translate_layer_stacking(flat: dict, current: dict) -> dict:
    """``flat`` (a checkpoint's flat state) with a transformer's layer stack
    moved to the layout of ``current`` (the live model's flat state, or
    arrays of its shapes): per-layer ``X.layers.<i>.Y`` stacked into
    ``X.stack.Y`` (a leading depth axis) or stacked ones cut into layers.
    Only keys the model expects and the checkpoint lacks are made, and the
    source keys used are dropped. The port of
    ``isp_tts_tpu/models/base.py:_translate_layer_stacking``, on either
    package's flat names."""
    out = dict(flat)
    consumed: set[str] = set()
    for key, cur in current.items():
        if key in out:
            continue
        if ".stack." in key:
            prefix, suffix = key.split(".stack.", 1)
            depth = int(np.shape(cur)[0])
            sources = [f"{prefix}.layers.{i}.{suffix}" for i in range(depth)]
            if all(s in out for s in sources):
                out[key] = np.stack([np.asarray(out[s]) for s in sources])
                consumed.update(sources)
            continue
        m = re.match(r"(.*)\.layers\.(\d+)\.(.*)", key)
        if m:
            src = f"{m.group(1)}.stack.{m.group(3)}"
            i = int(m.group(2))
            if (src in out and np.ndim(out[src]) == np.ndim(cur) + 1
                    and i < np.shape(out[src])[0]):
                out[key] = np.asarray(out[src])[i]
                consumed.add(src)
    for s in consumed:
        out.pop(s, None)
    if consumed:
        logger.info("load_params: translated %d transformer layer-stack tensors between "
                    "per-layer and stacked layouts", len(consumed))
    return out


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

    def jax_shapes(self) -> dict[str, np.ndarray]:
        """Arrays of the JAX flat state's shapes (zero-stride views, no
        copies), for :func:`translate_layer_stacking`."""
        from ..training.optimizers import to_jax_array

        own = self.state_dict()
        return {jname: to_jax_array(np.broadcast_to(np.float32(0), tuple(own[name].shape)),
                                    layout)
                for name, (jname, layout) in self.jax_names().items()}

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
                    ignore_mismatched: bool = True, port_names: bool = False) -> None:
        """Load a JAX flat state partially, as ``Model.load_params`` there:
        keys holding an ``ignore_layers`` substring are skipped, unknown keys
        warned about, shape-mismatched ones skipped (or raised on), and
        tensors not given keep their values. With ``port_names`` the keys
        and layouts are the port's own (a converted reference ``.pt``)."""
        from ..training.optimizers import from_jax_array

        own = self.state_dict()
        if not port_names:
            flat = translate_layer_stacking(flat, self.jax_shapes())
        names = ({name: (name, False) for name in own} if port_names else
                 {jname: (name, rev) for name, (jname, rev) in self.jax_names().items()})
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

        names = {jname: (name, layout) for name, (jname, layout) in self.jax_names().items()}
        flat = translate_layer_stacking(flat, self.jax_shapes())
        unexpected = sorted(set(flat) - set(names))
        if unexpected:
            raise KeyError(f"unexpected JAX tensors {unexpected}")
        self.load_port_state({names[key][0]: from_jax_array(np.asarray(value), names[key][1])
                              for key, value in flat.items()})

    def load_port_state(self, state: dict[str, np.ndarray]) -> None:
        """Load every tensor by the port's own names and layouts, strictly,
        cast to each tensor's dtype."""
        own = self.state_dict()
        missing, unexpected = sorted(set(own) - set(state)), sorted(set(state) - set(own))
        if missing or unexpected:
            raise KeyError(f"unexpected tensors {unexpected}; port tensors not given {missing}")
        mapped = {}
        for name, value in state.items():
            t = torch.from_numpy(np.array(value))
            if tuple(t.shape) != tuple(own[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} does not fit "
                                 f"{tuple(own[name].shape)}")
            mapped[name] = t.to(own[name].dtype)
        self.load_state_dict(mapped, strict=True)

    @classmethod
    def convert_torch_checkpoint(cls, config: dict, state: dict) -> tuple[dict, dict]:
        """A reference torch checkpoint's (config, state) in this class's
        schema and the port's tensor names. Classes with a torch interop
        override it; the base refuses rather than build a model from
        unconverted names."""
        raise NotImplementedError(f"{cls.__name__} has no torch-checkpoint converter; load "
                                  "a .ckpt or implement convert_torch_checkpoint")

    @classmethod
    def from_pretrained(cls, path: str | Path, device: str | torch.device | None = None):
        """Rebuild the model from a ``.ckpt`` file's embedded config and
        weights, or from a reference ``.pt`` through
        :meth:`convert_torch_checkpoint`, in eval mode, on ``device`` (CUDA
        unless named)."""
        dev = resolve_device(device)
        ckpt = load_checkpoint(path)
        blob = ckpt["model"]
        if ckpt.get("format") == "torch":
            config, state = cls.convert_torch_checkpoint(blob["config"], blob["state"])
            model = cls(build_config(cls.Config, config))
            model.load_port_state(state)
        else:
            model = cls(build_config(cls.Config, blob["config"]))
            model.load_jax_state(blob["state"])
        return model.to(dev).eval()
