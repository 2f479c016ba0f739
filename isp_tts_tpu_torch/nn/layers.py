"""Activation and normalization factories, and dropout (counterpart of
``isp_tts_tpu/nn/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.flash_attention import drop_params
from ..parallel.context import data_rows

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


def choose_normalization(name: str | None):
    """The masked normalization class of ``name`` for (B, T, C) sequences:
    "batch" or "instance"; None for None."""
    if name is None:
        return None
    from .norms import MaskedBatchNorm1d, MaskedInstanceNorm1d

    table = {"batch": MaskedBatchNorm1d, "instance": MaskedInstanceNorm1d}
    if name not in table:
        raise KeyError(f"Unknown normalization {name!r}; known: {sorted(table)}")
    return table[name]


class FastDropout(torch.nn.Module):
    """Dropout with the JAX package's 8-bit keep quantisation
    (``isp_tts_tpu/nn/layers.py:_keep_mask``): keep iff a uniform byte is
    below round((1 - rate) * 256), kept values scaled by 1 / (1 - rate).

    The bytes are drawn from ``generator`` (a ``torch.Generator`` on the
    input's device; the default generator when None), which
    :func:`set_dropout_generator` hands to every dropout of a model. Active
    in train mode only; a rate that quantises to keep-everything is a
    no-op, as there. Attention layers hold one to draw their kernel seed.

    Under a data split (the live
    :class:`~isp_tts_tpu_torch.parallel.context.ParallelContext`) the bytes
    are drawn for the global batch and this rank keeps its rows; a dropout
    inside a model-split layer (``split_last``: its rank and the rank
    count, set by :func:`~isp_tts_tpu_torch.parallel.mesh.shard_params`)
    draws the global last dim and keeps its share. So every rank drops
    what one rank drops at those positions.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None
        self.split_last: tuple[int, int] | None = None

    def _bits(self, shape, device) -> torch.Tensor:
        def draw(batch):
            full = list(shape)
            full[0] = batch
            if self.split_last is not None:
                full[-1] *= self.split_last[1]
            bits = torch.randint(0, 256, full, dtype=torch.uint8, device=device,
                                 generator=self.generator)
            if self.split_last is not None:
                bits = bits.chunk(self.split_last[1], dim=-1)[self.split_last[0]]
            return bits

        return data_rows(draw, shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = drop_params(self.rate) if self.training else None
        if drop is None:
            return x
        bits = self._bits(x.shape, x.device)
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

