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
- the binarization loss sums its denominator over the data group;
- ``Attention(flash="ring")`` rings over the seq group when the context
  names a seq axis (``seq_axis``; one of size 1 in one process rings
  alone, as the JAX tests' ``parallel_context(mesh=single,
  seq_axis="seq")``), and a stacked ``Transformer(pipeline=True)`` streams
  ``n_micro`` microbatches through the stage group when ``stage_axis`` is
  named (the JAX context's ``seq_axis``, ``stage_axis``, ``n_micro``).

Ranks that differ only along the seq or stage axis share a data
coordinate: they read the same rows and draw the same dropout bits, and
every draw is placed by the data rank (and, inside a stacked layer stack,
by :func:`row_window`), never by the global rank.

The trainer activates its context only around the work that runs under
it (``train()`` / ``evaluate()``) and restores the previous one on exit,
so a trainer never leaks its layout into other work in the same process;
``parallel_context`` scopes an override for tests and tools.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class ParallelContext:
    #: the ranks' (data, model, seq, stage) grid (None: one process)
    layout: Any = None
    #: this process's global rank
    rank: int = 0
    #: axis name -> the process group of the ranks that differ from this
    #: one along that axis alone (absent: one process)
    groups: dict = field(default_factory=dict)
    #: "seq" when ring attention runs over the seq group (of size 1 without
    #: one); None: ``flash="ring"`` runs the local kernels
    seq_axis: str | None = None
    #: "stage" when stacked layer stacks run the GPipe schedule over the
    #: stage group (of size 1 without one); None: they run locally
    stage_axis: str | None = None
    #: microbatches a stacked layer stack streams per step
    n_micro: int = 4

    def __post_init__(self):
        for axis in ("seq", "stage"):
            named = getattr(self, f"{axis}_axis")
            if named not in (None, axis):
                raise ValueError(f"{axis}_axis must be None or {axis!r}, not {named!r}")
            if self.size(axis) > 1 and named is None:
                raise ValueError(f"a layout with {axis} {self.size(axis)} must name its "
                                 f"{axis} axis")
            if named is not None and self.size(axis) > 1 and axis not in self.groups \
                    and self.layout.size > 1:
                raise ValueError(f"the {axis} axis of {self.size(axis)} ranks has no "
                                 "process group")

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

    @property
    def seq_size(self) -> int:
        return self.size("seq")

    @property
    def seq_rank(self) -> int:
        return self.index("seq")

    @property
    def stage_size(self) -> int:
        return self.size("stage")

    @property
    def stage_rank(self) -> int:
        return self.index("stage")

    def group(self, axis: str):
        """The process group of ``axis`` (None when no process group runs)."""
        return self.groups.get(axis)

    def axis_group(self, axis: str):
        """The process group of a named seq or stage axis: None at size 1
        (the axis runs alone); raises when the layout splits the axis and
        no group was made for it."""
        if self.size(axis) == 1:
            return None
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(f"the {axis} axis of {self.size(axis)} ranks has no process "
                               "group (parallel.mesh.make_context makes it)")
        return group


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


#: (global rows, first row) of the batch slice now running, set by a
#: stacked layer stack around each microbatch (None: this data rank's rows)
_window: tuple[int, int] | None = None


@contextmanager
def row_window(total: int, first: int):
    """Within the block the batch being computed is rows [first, first +
    batch) of a global batch of ``total`` rows: random draws are made at
    ``total`` rows and cut to those (:func:`data_rows`), and the attention
    layers place their dropout hash at ``first`` (:func:`batch_origin`). A
    stacked layer stack sets it around each microbatch, so its draws do not
    depend on the microbatch count, the stage count or the data split."""
    global _window
    prev = _window
    _window = (int(total), int(first))
    try:
        yield
    finally:
        _window = prev


def data_rows(draw, batch: int):
    """``draw(global_batch)`` cut to this data rank's rows: a random draw
    whose leading axis is the batch, made at the global batch's size from
    a generator that every rank seeds alike, so each rank keeps the rows
    one rank would have drawn for them. The identity with one data rank
    (and no :func:`row_window`)."""
    if _window is not None:
        total, first = _window
        return draw(total)[first:first + batch]
    ctx = _context
    n = ctx.data_size
    if n == 1:
        return draw(batch)
    r = ctx.data_rank
    return draw(batch * n)[r * batch:(r + 1) * batch]


def batch_origin(batch: int) -> int:
    """The global index of the first row of a ``batch``-row call: the
    :func:`row_window`'s, else this data rank's first row."""
    if _window is not None:
        return _window[1]
    return _context.data_rank * batch
