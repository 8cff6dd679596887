"""The layout of the processes (port of edm_tts_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``Mesh`` with axes (data, fsdp,
model[, sequence]) and lets XLA insert the collectives. Here one process
drives one device, and a ``Mesh`` is the same layout over the ranks of the
process group, with JAX's axis order: model and sequence innermost, so
rank = ((data * n_fsdp + fsdp) * n_model + model) * n_seq + sequence. For
each axis it holds the group of the ranks that differ only along it
(``group(axis)``), and ``group("batch")`` spans data x fsdp, the ranks that
split the batch:

- ``data`` x ``fsdp``: each holds a contiguous slice of the global batch
  (``local_rows``, JAX's ``batch_sharding``); the gradient is
  reduce-scattered over fsdp and all-reduced over data, and each fsdp rank
  keeps the optimizer state of its slice of the parameters (ZeRO-2,
  ``train/optim.py::AdamW``);
- ``model``: Megatron tensor parallelism of the Conformer blocks
  (``parallel/tensor.py``, JAX's ``param_shardings``);
- ``sequence``: the ring of ``ops/ring_attention.py`` (present only when
  ``n_seq > 1``, as in JAX);
- ``pipe``: the GPipe stages of ``parallel/pipeline.py``, outermost
  (``make_pipe_mesh``: (pipe, data, fsdp, model) with fsdp 1, JAX's
  (pipe[, data][, model]) order), so the batch span and its groups are the
  same as in every other layout.

A group whose axis spans the whole world is the default group; an axis of
size 1 has none (its collectives are skipped). A ``Mesh`` is also the
context that ``mha(implementation="ring")`` reads its ring from:
``with mesh:`` makes it ``ambient_mesh()``, as JAX resolves the mesh of the
enclosing ``with mesh:``.
"""

from __future__ import annotations

import itertools
import math
from typing import Mapping

import torch
import torch.distributed as dist

from edm_tts_tpu_torch.parallel.dist import is_distributed, process_info

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"  # tensor parallelism (attention heads / FF hidden)
SEQUENCE_AXIS = "sequence"  # the ring of ring attention
PIPE_AXIS = "pipe"  # the GPipe stages
BATCH = "batch"  # data x fsdp: the ranks that split the batch

_AMBIENT: list["Mesh"] = []


class Mesh:
    """The (data, fsdp, model[, sequence]) layout of the ranks and the
    process groups along its axes."""

    def __init__(self, shape: Mapping[str, int], *, local: bool = False):
        """``local``: this process alone (world 1, no groups), even inside a
        process group: how a rank runs the one-process path beside it (a
        local pipe mesh runs all its stages in this process). The layout
        takes the first ``prod(shape)`` ranks; ``member`` is False on the
        others, which only take part in making the groups."""
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank, self.world = (0, 1) if local else process_info()
        self.distributed = not local and is_distributed()
        sizes = [self.shape[a] for a in self.axis_names]
        self.member = local or self.rank < math.prod(sizes)
        coords, r = [], self.rank
        for size in reversed(sizes):
            coords.append(r % size)
            r //= size
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        self._groups: dict[str, object] = {}
        spans = {a: (a,) for a in self.axis_names}
        spans[BATCH] = (DATA_AXIS, FSDP_AXIS)
        for name, axes in spans.items():
            self._groups[name] = self._make_group(axes)

    def _ranks_of(self, coords: Mapping[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _make_group(self, axes: tuple[str, ...]):
        """This rank's group along ``axes``: every rank creates every group
        of the layout, in the same order, as ``new_group`` requires."""
        size = 1
        for a in axes:
            size *= self.shape[a]
        if not self.distributed or size == 1 and self.world > 1:
            return None
        if size == self.world:
            return dist.group.WORLD
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            ranks = []
            for moving in itertools.product(*(range(self.shape[a]) for a in axes)):
                ranks.append(self._ranks_of({**dict(zip(others, fixed)),
                                             **dict(zip(axes, moving))}))
            group = dist.new_group(sorted(ranks))
            if self.rank in ranks:
                mine = group
        return mine

    # -- the layout ------------------------------------------------------
    def size(self, axis: str) -> int:
        if axis == BATCH:
            return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``"batch"``: data * n_fsdp + fsdp)."""
        if axis == BATCH:
            return self.coords[DATA_AXIS] * self.shape[FSDP_AXIS] + self.coords[FSDP_AXIS]
        return self.coords.get(axis, 0)

    def peer(self, axis: str, index: int) -> int:
        """The rank at ``index`` along ``axis`` with this rank's other
        coordinates (a global rank, as point-to-point ops take)."""
        return self._ranks_of({**self.coords, axis: index})

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``, or
        None when it holds this rank alone (nothing to communicate)."""
        return self._groups.get(axis)

    def local_rows(self, batch: Mapping) -> dict:
        """This rank's contiguous slice of a global batch along data x fsdp
        (dim 0 of every entry; JAX's ``batch_sharding``)."""
        n, i = self.size(BATCH), self.index(BATCH)
        out = {}
        for k, v in batch.items():
            rows = v.shape[0]
            if rows % n:
                raise ValueError(f"batch of {rows} rows does not split over {n} data x fsdp "
                                 "ranks")
            out[k] = v[i * rows // n:(i + 1) * rows // n]
        return out

    # -- the ambient mesh --------------------------------------------------
    def __enter__(self) -> "Mesh":
        _AMBIENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.pop()


def ambient_mesh() -> Mesh | None:
    """The mesh of the innermost enclosing ``with mesh:`` block, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def make_mesh(n_data: int | None = None, n_fsdp: int = 1, n_model: int = 1, *,
              n_seq: int = 1) -> Mesh:
    """The (data, fsdp, model[, sequence]) layout over the process group's
    ranks (one rank without a group). ``n_data`` defaults to what the other
    axes leave; a ``sequence`` axis exists only when ``n_seq > 1``. Raises
    ValueError when the sizes do not multiply to the world size."""
    _, world = process_info()
    if n_data is None:
        n_data = max(world // (n_fsdp * n_model * n_seq), 1)
    if n_data * n_fsdp * n_model * n_seq != world:
        raise ValueError(f"{n_data}x{n_fsdp}x{n_model}x{n_seq} != {world} processes")
    shape = {DATA_AXIS: n_data, FSDP_AXIS: n_fsdp, MODEL_AXIS: n_model}
    if n_seq > 1:
        shape[SEQUENCE_AXIS] = n_seq
    return Mesh(shape)


def local_mesh() -> Mesh:
    """The layout of this process alone (``Mesh(..., local=True)``)."""
    return Mesh({DATA_AXIS: 1, FSDP_AXIS: 1, MODEL_AXIS: 1}, local=True)


def make_hybrid_mesh(n_slices: int, n_fsdp: int = 1) -> Mesh:
    """The (data, fsdp) layout of JAX's multi-slice mesh: fsdp within a
    slice, data across slices. JAX orders the devices by their slice
    topology; the ranks of one node have none, so this is the plain
    slice-major layout, with JAX's checks."""
    _, world = process_info()
    if world % n_slices:
        raise ValueError(f"{world} processes not divisible by {n_slices} slices")
    per_slice = world // n_slices
    if per_slice % n_fsdp:
        raise ValueError(f"fsdp={n_fsdp} must divide the {per_slice} processes of one slice")
    return make_mesh(world // n_fsdp, n_fsdp)


def make_pipe_mesh(n_pipe: int, n_data: int = 1, n_model: int = 1, *,
                   local: bool = False) -> Mesh | None:
    """The (pipe, data, fsdp 1, model) layout of JAX's ``make_pipe_mesh``:
    ``pipe`` outermost, so one stage's data replicas and model shards are
    adjacent ranks, ``model`` innermost. It takes the first ``n_pipe *
    n_data * n_model`` ranks (JAX's ``devices[:n]``); every process must
    call it, and it returns None on the ranks it leaves out. ``local``: all
    the stages in this process (no data or model ranks)."""
    shape = {PIPE_AXIS: n_pipe, DATA_AXIS: n_data, FSDP_AXIS: 1, MODEL_AXIS: n_model}
    if local:
        if n_data * n_model != 1:
            raise ValueError("a local pipe mesh has no data or model ranks")
        return Mesh(shape, local=True)
    _, world = process_info()
    if n_pipe * n_data * n_model > world:
        raise ValueError(f"{n_pipe}x{n_data}x{n_model} > {world} processes")
    mesh = Mesh(shape)
    return mesh if mesh.member else None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` in place over ``group`` (nothing for None)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_parts(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' parts ``x`` summed over ``group``, out of place (``x`` for
    None). Its backward passes the gradient through unchanged: every rank
    backpropagates the same value downstream, so its own part's gradient is
    that value's (Megatron's reduce-from-model)."""
    return x if group is None else _SumParts.apply(x, group)
