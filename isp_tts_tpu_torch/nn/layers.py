"""Activation factory and dropout (counterpart of ``isp_tts_tpu/nn/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.flash_attention import drop_params

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


class FastDropout(torch.nn.Module):
    """Dropout with the JAX package's 8-bit keep quantisation
    (``isp_tts_tpu/nn/layers.py:_keep_mask``): keep iff a uniform byte is
    below round((1 - rate) * 256), kept values scaled by 1 / (1 - rate).

    The bytes are drawn from ``generator`` (a ``torch.Generator`` on the
    input's device; the default generator when None), which
    :func:`set_dropout_generator` hands to every dropout of a model. Active
    in train mode only; a rate that quantises to keep-everything is a
    no-op, as there. Attention layers hold one to draw their kernel seed.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = drop_params(self.rate) if self.training else None
        if drop is None:
            return x
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                             generator=self.generator)
        return torch.where(bits < drop[0], x * drop[1], torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))

    def draw_seed(self, device) -> torch.Tensor:
        """A (1,) int32 seed in [0, 2**31 - 1) for an in-kernel dropout mask."""
        return torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32, device=device,
                             generator=self.generator)


def set_dropout_generator(module: torch.nn.Module,
                          generator: torch.Generator | None) -> None:
    """Give every :class:`FastDropout` under ``module`` the same generator."""
    for m in module.modules():
        if isinstance(m, FastDropout):
            m.generator = generator
