"""Run a function with autocast off, so its math stays in float32."""

from __future__ import annotations

import functools

import torch


def no_autocast(fn):
    """Decorator: run ``fn`` with autocast disabled on the device of its
    first tensor argument (the plain versions of the kernels and the
    losses compute in float32 under a bf16 training step)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dev = next(a.device.type for a in (*args, *kwargs.values())
                   if isinstance(a, torch.Tensor))
        with torch.autocast(dev, enabled=False):
            return fn(*args, **kwargs)

    return wrapper
