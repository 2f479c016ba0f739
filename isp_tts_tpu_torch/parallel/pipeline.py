"""Pipeline parallelism: the GPipe schedule over the stage group.

Counterpart of ``isp_tts_tpu/parallel/pipeline.py`` (``pipeline_apply``,
``microbatch``). A stacked layer stack's layers are cut over the S ranks of
the stage group (each holds ``depth / S`` of them); microbatches stream
through the stages over ``n_micro + S - 1`` ticks with one
:func:`~isp_tts_tpu_torch.parallel.mesh.rotate` (JAX's ``ppermute``) a
tick: stage 0 ingests microbatch t, stage s applies its layers to
microbatch t - s, and the last stage emits microbatch t - (S - 1).

The input enters with an identity forward and a sum over the stage group
backward (``copy_to``: only stage 0 reads it, and every stage needs its
gradient upstream); the outputs are replicated to every stage with a sum
forward and an identity backward (``reduce_from``, JAX's ``psum`` to
``P()``: the other stages contribute zeros). Autograd runs through the
whole schedule.

Bubble ticks skip their compute (JAX computes on zeros there): a stage
only runs its layers on a tick that holds a live microbatch. Every
rotation's result is tied into the output with weight zero (stage 0's
received value where it ingests, each stage's last activation), so every
rank runs the backward of every rotation and each send in the backward
meets its receive. ``remat`` recomputes each tick's layers in the backward
(``torch.utils.checkpoint``).

:func:`pipeline_apply_virtual` runs every stage of an S-stage schedule in
one process (the tests' virtual schedule); it shares :func:`_schedule`
with :func:`pipeline_apply` and differs only in the hop.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .mesh import copy_to, reduce_from, rotate


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B / n_micro, ...)."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def _run(fn, h, mb, remat):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, h, mb, use_reentrant=False)
    return fn(h, mb)


def _schedule(fns: list[Callable], stages: list[int], S: int, x: torch.Tensor, hop,
              remat: bool) -> list[torch.Tensor]:
    """The GPipe ticks of the ``stages`` this process runs (``fns[i]`` is
    stage ``stages[i]``'s ``fn(h, mb) -> h``); ``hop`` hands each stage's
    activation to the next. Returns each stage's (n_micro, ...) output:
    the last stage's emitted microbatches, zeros on the others."""
    n_micro = x.shape[0]
    ticks = n_micro + S - 1
    h = [x[0] * 0 for _ in stages]
    outs: list[list[torch.Tensor]] = [[] for _ in stages]
    for t in range(ticks):
        for i, s in enumerate(stages):
            if s == 0 and t < n_micro:
                # the wrap edge (S - 1 -> 0) carries no live data
                h[i] = x[t] + h[i] * 0
            mb = t - s
            if 0 <= mb < n_micro:
                h[i] = _run(fns[i], h[i], mb, remat).to(x.dtype)
                if s == S - 1:
                    outs[i].append(h[i])
        if t < ticks - 1:  # the last tick's activation goes nowhere
            h = hop(h)
    results = []
    for i, s in enumerate(stages):
        tail = h[i].sum() * 0
        out = torch.stack(outs[i]) if s == S - 1 else h[i].new_zeros((n_micro,) + h[i].shape)
        results.append(out + tail)
    return results


def pipeline_apply(stage_fn: Callable, x: torch.Tensor, *, group=None,
                   remat: bool = True) -> torch.Tensor:
    """Run this rank's stage of a layer stack over the stage ``group``.

    ``stage_fn(h, mb) -> h`` applies this stage's layers to microbatch
    ``mb`` (its index picks per-microbatch side inputs such as the padding
    mask); ``x`` (n_micro, B_micro, ...) is the microbatched input, the same
    on every stage. Returns the last stage's (n_micro, B_micro, ...) outputs
    on every stage. With ``group`` None this process is the only stage."""
    if group is None:
        S, s = 1, 0
    else:
        S, s = dist.get_world_size(group), dist.get_rank(group)
    x = copy_to(x, group)
    out = _schedule([stage_fn], [s], S, x, lambda h: [rotate(h[0], group)], remat)[0]
    return reduce_from(out, group)


def pipeline_apply_virtual(stage_fns: list[Callable], x: torch.Tensor, *,
                           remat: bool = True) -> torch.Tensor:
    """Every stage of an S-stage schedule in this process (``stage_fns[s]``
    is stage s's ``fn(h, mb)``); the last stage's outputs."""
    S = len(stage_fns)
    outs = _schedule(list(stage_fns), list(range(S)), S, x,
                     lambda h: [h[(i - 1) % S] for i in range(S)], remat)
    return outs[-1] + sum(o for o in outs[:-1])
