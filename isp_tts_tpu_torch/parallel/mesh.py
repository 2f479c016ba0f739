"""Rank mesh, process groups, batch and tensor-parallel sharding.

Counterpart of ``isp_tts_tpu/parallel/mesh.py``. There one process drives
every chip through a ``jax.sharding.Mesh`` and XLA derives the
collectives from sharding annotations. Here one process drives one card
(``torch.distributed``: NCCL on the card, gloo on the CPU, the backend
named by the caller), and the collectives are explicit:

- :func:`make_mesh` lays the ranks out as data × model × seq × stage
  (``data=-1``: every remaining rank) and :func:`make_context` builds one
  process group per axis and per line of ranks along it;
- the collectives with a gradient that the seq and stage axes run on:
  :func:`rotate` (``ppermute`` with ``perm = [(i, i + shift mod S)]``; its
  backward rotates the gradient back), :func:`split_seq` /
  :func:`gather_seq` (keep this rank's rows, all-gather the gradient; and
  the reverse), :func:`copy_to` / :func:`reduce_from` (identity forward
  and a sum over the group backward; and the reverse), for any group;
  :func:`shard_stages` keeps this stage's layers of every stacked layer
  stack;
- :func:`shard_batch` keeps this data rank's contiguous rows of a global
  batch (padded to the global batch's lengths, so every rank runs one
  shape and the dropout hash sees the global N and M);
- :data:`DEFAULT_TP_RULES` and :func:`shard_params` split the feed-forward
  inner dim and the attention heads over the model axis, Megatron-style:
  ``fc1`` and ``to_q`` by output rows (a GLU's value and gate halves split
  alike), ``fc2`` and ``to_out`` by input columns with a sum over the model
  group after them (:func:`reduce_from`); the module's input enters
  through :func:`copy_to`, whose backward sums the input gradient.
  The one-KV-head ``to_kv`` and the ALiBi slopes stay replicated: inside a
  split layer each rank's gradient of them is partial, and
  :func:`reduce_gradients` sums it over the model group before the data
  mean. A stacked layer stack (``stack.*``, a leading depth axis) splits by
  the same rules one dim further right, as the JAX rules shift their specs,
  and its layer runs split on each depth slice; beside a stage axis its
  tensors are both split over the model ranks and cut over the stages;
- :func:`reduce_gradients` and :func:`global_grad_norm`: the data mean of
  every gradient in a few flat buckets, and the global norm that counts a
  split tensor once from all its shards (a stage's layers once across the
  stage group, a stage's model shards once across both groups, a
  replicated tensor once, never summed over seq peers, whose gradients are
  identical);
- :func:`full_parameters` / :func:`gather_split` / :func:`slice_split`:
  split tensors (model shards, a stage's layers, both) gathered for a
  checkpoint (a file equal to one rank's) and sliced again on load;
- :func:`barrier`, :func:`gather_to_host`, :func:`init_distributed`,
  :func:`process_local_mesh_info`.

The JAX module's ``check_gloo_clique`` and ``_align_for_collective`` work
around XLA:CPU's Gloo collectives (a second communicator clique deadlocks,
a fixed ~30 s rendezvous deadline); torch's gloo groups have neither
fault, and their deadline is ``init_distributed``'s ``timeout_s``.
"""

from __future__ import annotations

import datetime
import os
import re
import socket
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .context import ParallelContext, get_parallel_context

AXES = ("data", "model", "seq", "stage")
#: elements of one flat all-reduce bucket (64 MB of f32)
BUCKET_ELEMENTS = 1 << 24


# -- the rank mesh -----------------------------------------------------------------


@dataclass(frozen=True)
class RankMesh:
    """Global ranks laid out as a (data, model, seq, stage) grid."""

    ranks: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, (int(s) for s in self.ranks.shape)))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: int) -> dict[str, int]:
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return dict(zip(AXES, (int(i) for i in where[0])))

    def lines(self, axis: str) -> list[list[int]]:
        """Every line of ranks along ``axis`` (the others fixed), in a
        fixed order: the process groups of that axis."""
        a = AXES.index(axis)
        moved = np.moveaxis(self.ranks, a, -1).reshape(-1, self.ranks.shape[a])
        return [[int(r) for r in line] for line in moved]


def make_mesh(data: int = -1, model: int = 1, seq: int = 1, stage: int = 1,
              world_size: int | None = None) -> RankMesh:
    """Lay ``world_size`` ranks (default: the process group's, 1 without
    one) out as data × model × seq × stage, the stage index fastest.

    ``data=-1`` takes every remaining rank. The errors are the JAX
    package's: a world that the other axes do not divide, or axes whose
    product is not the world.
    """
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    n = int(world_size)
    per_data = model * seq * stage
    if data == -1:
        if n % per_data != 0:
            raise ValueError(f"{n} devices not divisible by model*seq*stage={per_data}")
        data = n // per_data
    if data * per_data != n:
        raise ValueError(f"mesh {data}x{model}x{seq}x{stage} != {n} devices")
    return RankMesh(np.arange(n).reshape(data, model, seq, stage))


def make_context(mesh: RankMesh, n_micro: int = 4) -> ParallelContext:
    """This process's :class:`ParallelContext` over ``mesh``: one process
    group per line of ranks along each axis of size above 1 (and along the
    data axis always, so a one-rank run still reduces through its group);
    a seq or stage axis above 1 is named (``seq_axis``, ``stage_axis``),
    and ``n_micro`` is the stacked layer stacks' microbatch count. Every
    rank must call it, in the same order, since each group is made by all
    ranks. Without a process group the mesh must be one rank."""
    named = {f"{axis}_axis": axis for axis in ("seq", "stage") if mesh.shape[axis] > 1}
    if not dist.is_initialized():
        if mesh.size != 1:
            raise RuntimeError(f"a mesh of {mesh.size} ranks needs torch.distributed "
                               "initialized (init_distributed)")
        return ParallelContext(layout=mesh, rank=0, groups={}, n_micro=n_micro)
    if mesh.size != dist.get_world_size():
        raise ValueError(f"mesh of {mesh.size} ranks, process group of "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    groups = {}
    for axis in AXES:
        if axis != "data" and mesh.shape[axis] == 1:
            continue
        for line in mesh.lines(axis):
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return ParallelContext(layout=mesh, rank=rank, groups=groups, n_micro=n_micro, **named)


def process_local_mesh_info() -> tuple[int, int]:
    """(number of processes, this process's global rank): who writes a
    file once. Loaders shard by the data coordinate
    (:attr:`ParallelContext.data_rank`), never by this rank, since ranks
    that differ along the model, seq or stage axes read the same rows."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


# -- batches -------------------------------------------------------------------------


def batch_sharding(batch_size: int, ctx: ParallelContext | None = None) -> slice:
    """The rows of a global batch of ``batch_size`` this data rank holds."""
    ctx = ctx or get_parallel_context()
    n = ctx.data_size
    if batch_size % n:
        raise ValueError(f"batch of {batch_size} rows does not split over {n} data ranks")
    per = batch_size // n
    return slice(ctx.data_rank * per, (ctx.data_rank + 1) * per)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to rank 0's, over the
    default group (replicas built from one seed already agree; a module
    built otherwise is made to). A no-op without a process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def shard_batch(batch: dict, ctx: ParallelContext | None = None,
                stacked: bool = False) -> dict:
    """This data rank's contiguous rows of a global host batch: rows
    [r * B/n, (r + 1) * B/n) of every array (``stacked``: the arrays lead
    with a K steps-per-call axis and the batch is the second), and of every
    per-row list. The rows keep the global batch's padded lengths. Other
    entries pass through. The identity with one data rank."""
    ctx = ctx or get_parallel_context()
    if ctx.data_size == 1:
        return dict(batch)
    axis = 1 if stacked else 0
    sizes = {v.shape[axis] for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > axis}
    if len(sizes) != 1:
        raise ValueError(f"batch arrays disagree on the batch size: {sorted(sizes)}")
    B = sizes.pop()
    rows = batch_sharding(B, ctx)
    out = {}
    for key, value in batch.items():
        if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim > axis:
            out[key] = value[:, rows] if stacked else value[rows]
        elif isinstance(value, list) and len(value) == B and not stacked:
            out[key] = value[rows]
        else:
            out[key] = value
    return out


# -- tensor parallelism ---------------------------------------------------------------

#: (regex over the port's parameter names, the split dim of the torch
#: layout): the JAX package's rules with a Dense kernel (in, out) read as
#: the Linear weight (out, in). ``fc1`` (the feed-forward's and the flow
#: time embedding's) and ``to_q`` split by output rows, ``fc2`` and
#: ``to_out`` by input columns; biases after a row split stay replicated
DEFAULT_TP_RULES: list[tuple[str, int]] = [
    (r"\.fc1\.weight$", 0),
    (r"\.fc1\.bias$", 0),
    (r"\.fc2\.weight$", 1),
    (r"\.to_q\.weight$", 0),
    (r"\.to_out\.weight$", 1),
]


@dataclass(frozen=True)
class TensorSplit:
    """A module's share of a model-axis split: its rank and the group."""

    rank: int
    size: int
    group: object


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the
    group (each of its ranks holds part of it: a model split's heads, a
    seq split's rows, the pipeline's first stage)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward (after a column-split product, or the
    pipeline's last stage's output against the others' zeros); identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, the gradient summed over ``group`` backward (the
    identity when ``group`` is None: one rank)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward, identity backward (the identity
    when ``group`` is None)."""
    return x if group is None else _ReduceFrom.apply(x, group)


# -- the seq and stage axes' collectives ------------------------------------------------


def _peers(group) -> list[int]:
    return dist.get_process_group_ranks(group)


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on along ``group``, receive
    from the rank as far back (a ring of the group's ranks)."""
    peers = _peers(group)
    size = len(peers)
    if size == 1 or shift % size == 0:
        return x
    me = peers.index(dist.get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peers[(me + shift) % size], group),
           dist.P2POp(dist.irecv, out, peers[(me - shift) % size], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _rotate(grad, ctx.group, -ctx.shift), None, None, None


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``perm = [(i, (i + shift) % S)]`` over
    ``group`` (S ranks, in the group's order): every rank sends ``x`` on
    and receives its predecessor's, over ``dist.batch_isend_irecv`` (NCCL
    on the card, gloo on the CPU). The backward rotates the gradient the
    other way. While autograd records, the result always requires a
    gradient, so every rank's rotation has a backward and every send in
    the backward meets its receive. The identity when ``group`` is None."""
    if group is None:
        return x
    token = (torch.ones((), requires_grad=True) if torch.is_grad_enabled()
             and not x.requires_grad else None)
    return _Rotate.apply(x, token, group, shift)


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        size, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(size, dim=ctx.dim)[rank].contiguous(), None, None


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def split_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous share of ``x`` along ``dim`` (rank i of S holds
    rows [i N/S, (i + 1) N/S)); the backward all-gathers the gradient, so
    every rank holds the whole one. The identity when ``group`` is None."""
    return x if group is None else _SplitSeq.apply(x, group, dim)


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's share of ``dim`` gathered in rank order; the backward
    keeps this rank's slice of the (replicated) gradient. The identity
    when ``group`` is None."""
    return x if group is None else _GatherSeq.apply(x, group, dim)


def _split_units(module) -> dict[str, tuple[int, int]] | None:
    """The parameters of a module the model axis can split, each with
    (granule rows, halves), or None for a module that does not run split:
    attention splits whole heads, a GLU's ``fc1`` splits its two halves."""
    from ..nn.attention import Attention
    from ..nn.embeddings import TimePositionalEmbedding
    from ..nn.feedforward import FeedForward

    if isinstance(module, Attention):
        return {"to_q.weight": (module.head_dim, 1), "to_out.weight": (module.head_dim, 1)}
    if isinstance(module, (FeedForward, TimePositionalEmbedding)):
        halves = 2 if getattr(module, "glu", False) else 1
        return {"fc1.weight": (1, halves), "fc1.bias": (1, halves), "fc2.weight": (1, 1)}
    return None


def slice_split(full: torch.Tensor, dim: int, halves: int, rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full``: its contiguous share of each of
    the ``halves`` equal parts of dim ``dim``."""
    parts = full.chunk(halves, dim=dim)
    return torch.cat([p.chunk(size, dim=dim)[rank] for p in parts], dim=dim).contiguous()


def join_split(shards: list[torch.Tensor], dim: int, halves: int) -> torch.Tensor:
    """The inverse of :func:`slice_split` over every rank's shard."""
    pieces = [s.chunk(halves, dim=dim) for s in shards]
    return torch.cat([pieces[r][h] for h in range(halves) for r in range(len(shards))],
                     dim=dim)


def shard_params(model: torch.nn.Module, ctx: ParallelContext | None = None,
                 rules: list[tuple[str, int]] | None = None) -> dict[str, tuple[int, int]]:
    """Split ``model``'s parameters over the model axis in place by
    ``rules``; return {parameter name: (dim, halves)} of the split ones.

    A module runs split when every one of its parameters that a rule
    matches divides into whole granules (heads for attention) over the
    model ranks; otherwise all of them stay replicated, as the JAX rules
    replicate an indivisible tensor. Inside a stacked layer stack (``stack``
    in the module's path) every parameter leads with the depth axis, so the
    split dim is the rule's plus one (JAX's specs shifted right by one,
    whatever the stage count); each depth slice is then one layer's share.
    A split parameter carries ``tp_split = (dim, halves)``; inside a split
    attention layer the replicated ``to_kv`` and slopes carry
    ``tp_partial`` (their gradient is summed over the model group). With
    one model rank nothing changes.
    """
    from ..nn.feedforward import FeedForward

    ctx = ctx or get_parallel_context()
    size = ctx.model_size
    rules = DEFAULT_TP_RULES if rules is None else rules
    out: dict[str, tuple[int, int]] = {}
    if size == 1:
        return out
    tp = TensorSplit(ctx.model_rank, size, ctx.group("model"))
    for mname, mod in model.named_modules():
        units = _split_units(mod)
        if units is None:
            continue
        lead = int("stack" in mname.split("."))  # a stacked stack's depth axis
        params = dict(mod.named_parameters())
        plan = {}
        for pname, (granule, halves) in units.items():
            if pname not in params:
                continue
            full = f"{mname}.{pname}" if mname else pname
            dim = next((d for pattern, d in rules if re.search(pattern, "." + full)), None)
            if dim is None:
                continue
            plan[pname] = (full, dim + lead, granule, halves)
        if not plan or any(params[p].shape[d] % (h * g * size)
                           for p, (_, d, g, h) in plan.items()):
            continue
        with torch.no_grad():
            for pname, (full, dim, _, halves) in plan.items():
                p = params[pname]
                p.data = slice_split(p.data, dim, halves, tp.rank, size)
                p.tp_split = (dim, halves)
                out[full] = (dim, halves)
        mod.tp = tp
        if isinstance(mod, FeedForward):
            mod.dropout.split_last = (tp.rank, size)  # its inner dim
        for pname, p in params.items():
            if pname.startswith(("to_kv.", "rel_pos.")):  # attention's replicated ones
                p.tp_partial = True
    return out


def gather_split(t: torch.Tensor, split: tuple[int, int],
                 ctx: ParallelContext | None = None) -> torch.Tensor:
    """The full tensor of a split one (collective over the model group)."""
    ctx = ctx or get_parallel_context()
    shards = [torch.empty_like(t) for _ in range(ctx.model_size)]
    dist.all_gather(shards, t.contiguous(), group=ctx.group("model"))
    return join_split(shards, *split)


def shard_stages(model: torch.nn.Module, ctx: ParallelContext | None = None) -> list[str]:
    """Keep this stage's layers of every stacked layer stack of ``model``
    (each ``Transformer(pipeline=True)``'s ``stack`` parameters, whose
    leading axis is the depth) in place; return the names cut. A cut
    parameter carries ``stage_split`` (the stage count). Depth not
    divisible by the stage count raises. With one stage nothing changes."""
    from ..nn.transformer import Transformer

    ctx = ctx or get_parallel_context()
    S, s = ctx.stage_size, ctx.stage_rank
    cut: list[str] = []
    if S == 1:
        return cut
    for mname, mod in model.named_modules():
        if not isinstance(mod, Transformer) or mod.stack is None:
            continue
        if mod.depth % S:
            raise ValueError(f"{mname}: depth {mod.depth} not divisible by stage axis {S}")
        per = mod.depth // S
        with torch.no_grad():
            for pname, p in mod.stack.named_parameters():
                p.data = p.data[s * per:(s + 1) * per].contiguous()
                p.stage_split = S
                cut.append(f"{mname}.stack.{pname}")
        mod.stage_layers = (s * per, per)
    return cut


def gather_stages(t: torch.Tensor, ctx: ParallelContext | None = None) -> torch.Tensor:
    """Every stage's layers of a stage-cut tensor, in stage order
    (collective over the stage group)."""
    ctx = ctx or get_parallel_context()
    return _all_gather(t, ctx.group("stage"), 0)


def local_part(param: torch.Tensor, full: torch.Tensor,
               ctx: ParallelContext | None = None) -> torch.Tensor:
    """This rank's part of a parameter-shaped full tensor: its stage's
    layers, its model shard of them (the full tensor when ``param`` is
    whole)."""
    ctx = ctx or get_parallel_context()
    if getattr(param, "stage_split", None):
        per = full.shape[0] // ctx.stage_size
        full = full[ctx.stage_rank * per:(ctx.stage_rank + 1) * per]
    split = getattr(param, "tp_split", None)
    if split is not None:
        full = slice_split(full, *split, ctx.model_rank, ctx.model_size)
    return full


def full_part(param: torch.Tensor, local: torch.Tensor,
              ctx: ParallelContext | None = None) -> torch.Tensor:
    """The full tensor of a parameter-shaped part (every rank of the split
    calls it: a collective over the model group, then over the stage
    group)."""
    ctx = ctx or get_parallel_context()
    split = getattr(param, "tp_split", None)
    if split is not None:
        local = gather_split(local, split, ctx)
    if getattr(param, "stage_split", None):
        local = gather_stages(local, ctx)
    return local


@contextmanager
def full_parameters(model: torch.nn.Module, ctx: ParallelContext | None = None):
    """Within the block every split parameter of ``model`` (a model shard,
    a stage's layers) holds its full tensor (gathered on every rank), so a
    checkpoint written there is one rank's; the parts come back on exit."""
    ctx = ctx or get_parallel_context()
    saved = []
    try:
        for p in model.parameters():
            if getattr(p, "tp_split", None) is not None or getattr(p, "stage_split", None):
                saved.append((p, p.data))
                p.data = full_part(p, p.data, ctx)
        yield model
    finally:
        for p, data in saved:
            p.data = data


# -- gradients -------------------------------------------------------------------------


def _bucketed_all_reduce(tensors: list[torch.Tensor], group) -> None:
    """Sum ``tensors`` in place over ``group``, flattened into buckets of at
    most :data:`BUCKET_ELEMENTS` elements of one dtype and device."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for chunk_list in by_kind.values():
        bucket, count = [], 0
        for t in chunk_list + [None]:
            if t is not None and (count + t.numel() <= BUCKET_ELEMENTS or not bucket):
                bucket.append(t)
                count += t.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            torch._foreach_copy_(bucket, [v.view_as(b) for v, b in zip(
                flat.split([b.numel() for b in bucket]), bucket)])
            if t is not None:
                bucket, count = [t], t.numel()


def reduce_gradients(grads: list[torch.Tensor], params: list[torch.nn.Parameter],
                     ctx: ParallelContext | None = None) -> None:
    """In place, ``grads`` of ``params``: the model-partial ones
    (``tp_partial``) summed over the model group, then every one's mean
    over the data group, in a few flat buckets. A no-op without process
    groups."""
    ctx = ctx or get_parallel_context()
    if ctx.model_size > 1:
        partial = [g for g, p in zip(grads, params) if getattr(p, "tp_partial", False)]
        if partial:
            _bucketed_all_reduce(partial, ctx.group("model"))
    group = ctx.group("data")
    if group is None:
        return
    _bucketed_all_reduce(grads, group)
    if ctx.data_size > 1:
        torch._foreach_div_(grads, float(ctx.data_size))


def global_grad_norm(grads: list[torch.Tensor], params: list[torch.nn.Parameter],
                     ctx: ParallelContext | None = None) -> torch.Tensor:
    """optax.global_norm of the full model's gradients: a model-split
    tensor counts once, from all its shards (their squares summed over the
    model group), a stage's layers once (their squares summed over the
    stage group), a replicated tensor once (never summed over the seq or
    stage peers, which hold the same gradient). With every tensor whole,
    :func:`~isp_tts_tpu_torch.training.optimizers.grad_norm` itself."""
    from ..training.optimizers import grad_norm

    ctx = ctx or get_parallel_context()
    #: (model-split, stage-cut) -> the gradients of that kind
    kinds: dict[tuple[bool, bool], list[torch.Tensor]] = {}
    for g, p in zip(grads, params):
        kind = (getattr(p, "tp_split", None) is not None,
                bool(getattr(p, "stage_split", None)))
        kinds.setdefault(kind, []).append(g)
    if set(kinds) <= {(False, False)}:
        return grad_norm(grads)
    sq = 0.0
    for (split, cut) in sorted(kinds):  # every rank reduces in one order
        part = grad_norm(kinds[(split, cut)]).square()
        if split:
            dist.all_reduce(part, group=ctx.group("model"))
        if cut:
            dist.all_reduce(part, group=ctx.group("stage"))
        sq = sq + part
    return sq.sqrt()


def all_reduce_mean(values: dict, ctx: ParallelContext | None = None) -> dict:
    """Scalar metrics (0-dim tensors) averaged over the data group in one
    collective; other entries pass through."""
    ctx = ctx or get_parallel_context()
    group = ctx.group("data")
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor) and v.dim() == 0]
    if group is None or ctx.data_size == 1 or not keys:
        return values
    flat = torch.stack([values[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= ctx.data_size
    out = dict(values)
    out.update(zip(keys, flat.unbind()))
    return out


def data_sum(x: torch.Tensor, ctx: ParallelContext | None = None) -> torch.Tensor:
    """``x`` summed over the data group, out of autograd: a batch-wide
    denominator of the global batch. The identity with one data rank."""
    ctx = ctx or get_parallel_context()
    if ctx.data_size == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=ctx.group("data"))
    return x


# -- processes ------------------------------------------------------------------------


def barrier(name: str = "") -> None:
    """Every rank waits here (the reference's ``wait_for_everyone``); the
    name says where, for a reader of a hung run's traceback. A no-op
    without a process group; its deadline is the group's timeout."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def gather_to_host(tree):
    """Tensors (and arrays) of a dict/list/tuple tree as host numpy arrays.
    Split parameters are gathered by :func:`full_parameters`."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tree)


def _card_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}|{getattr(props, 'uuid', device.index)}"


def init_distributed(backend: str, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     local_rank: int | None = None, timeout_s: float = 300.0
                     ) -> torch.device:
    """Start the default process group and return this rank's device.

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    explicit arguments (``init_method`` such as ``tcp://localhost:PORT`` or
    ``file:///path``) override it. ``backend`` is the caller's: "nccl" binds
    ``cuda:LOCAL_RANK`` and raises, before any collective, when that card
    is missing or another rank holds it; "gloo" runs on the CPU. There is
    no fallback from one to the other.
    """
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    init_method = init_method or "env://"
    if backend == "nccl":
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(f"rank {rank} wants cuda:{local_rank}, but this host has "
                               f"{count} card(s): one NCCL rank a card")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unknown backend {backend!r}: nccl (the card) or gloo (the CPU)")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl" and world_size > 1:
        # NCCL cannot run two ranks on one card: say so before a collective
        # would hang or fail
        check = dist.new_group(backend="gloo")
        cards: list = [None] * world_size
        dist.all_gather_object(cards, _card_identity(device), group=check)
        dist.destroy_process_group(check)
        if len(set(cards)) != len(cards):
            dist.destroy_process_group()
            raise RuntimeError(f"two NCCL ranks share one card ({cards}): run one rank a "
                               "card (torchrun --nproc_per_node at most the card count)")
    return device
