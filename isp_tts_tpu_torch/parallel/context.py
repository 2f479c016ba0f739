"""The live parallel layout: which rank this process is, the process groups
of its mesh axes, and the data and model coordinates the modules read.

Counterpart of ``isp_tts_tpu/parallel/context.py``. There the context
holds a ``jax.sharding.Mesh`` that modules read at trace time; here one
process drives one card, and :class:`ParallelContext` holds the rank
layout (:class:`~isp_tts_tpu_torch.parallel.mesh.RankMesh`), this
process's rank, and one ``torch.distributed`` process group per mesh
axis it takes part in. Modules read it while they run:

- the attention layers fold this rank's first batch row into the
  in-kernel dropout hash, so every rank's keep mask is the slice one rank
  would draw for its rows;
- :class:`~isp_tts_tpu_torch.nn.layers.FastDropout` and the flow
  predictor's noise draw at the global batch's shape from the generator
  that every rank seeds alike, and keep this rank's rows;
- the binarization loss sums its denominator over the data group.

The trainer activates its context only around the work that runs under
it (``train()`` / ``evaluate()``) and restores the previous one on exit,
so a trainer never leaks its layout into other work in the same process;
``parallel_context`` scopes an override for tests and tools. The seq and
stage axes (the JAX context's ``seq_axis``, ``stage_axis``, ``n_micro``)
are not ported yet (ROADMAP Queue 1 item 5, second half): a layout with
either above 1 raises.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Any

#: what a seq or stage axis above 1 raises with
SEQ_STAGE_NOT_PORTED = ("the seq and stage mesh axes (ring attention, the pipeline "
                        "schedule) are not ported yet: ROADMAP Queue 1 item 5, second half")


@dataclass(frozen=True)
class ParallelContext:
    #: the ranks' (data, model, seq, stage) grid (None: one process)
    layout: Any = None
    #: this process's global rank
    rank: int = 0
    #: axis name -> the process group of the ranks that differ from this
    #: one along that axis alone (absent: one process)
    groups: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.layout is not None and (self.layout.shape["seq"] > 1
                                        or self.layout.shape["stage"] > 1):
            raise NotImplementedError(SEQ_STAGE_NOT_PORTED)

    def size(self, axis: str) -> int:
        return 1 if self.layout is None else int(self.layout.shape[axis])

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return 0 if self.layout is None else int(self.layout.coords(self.rank)[axis])

    @property
    def data_size(self) -> int:
        return self.size("data")

    @property
    def data_rank(self) -> int:
        return self.index("data")

    @property
    def model_size(self) -> int:
        return self.size("model")

    @property
    def model_rank(self) -> int:
        return self.index("model")

    def group(self, axis: str):
        """The process group of ``axis`` (None when no process group runs)."""
        return self.groups.get(axis)


_context = ParallelContext()


def get_parallel_context() -> ParallelContext:
    return _context


@contextmanager
def activated(ctx: ParallelContext):
    """Make ``ctx`` the live context for the block, restoring whatever was
    live before on exit (re-entrant: an evaluation in mid-training
    re-activates the same trainer's context)."""
    global _context
    prev = _context
    _context = ctx
    try:
        yield ctx
    finally:
        _context = prev


@contextmanager
def parallel_context(**kwargs):
    """Temporarily override the parallel context (tests, tools)."""
    global _context
    prev = _context
    _context = replace(ParallelContext(), **kwargs)
    try:
        yield _context
    finally:
        _context = prev


def data_rows(draw, batch: int):
    """``draw(global_batch)`` cut to this data rank's rows: a random draw
    whose leading axis is the batch, made at the global batch's size from
    a generator that every rank seeds alike, so each rank keeps the rows
    one rank would have drawn for them. The identity with one data rank."""
    ctx = _context
    n = ctx.data_size
    if n == 1:
        return draw(batch)
    r = ctx.data_rank
    return draw(batch * n)[r * batch:(r + 1) * batch]
