"""Activation factory (counterpart of ``isp_tts_tpu/nn/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    # "gelu" is the tanh approximation, as in the JAX package; "gelu_exact"
    # is erf GELU
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "swish": F.silu,
    "mish": F.mish,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}


def choose_activation(name: str):
    if name not in ACTIVATIONS:
        raise KeyError(f"Unknown activation {name!r}; known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
