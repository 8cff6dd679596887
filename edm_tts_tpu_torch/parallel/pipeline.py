"""GPipe pipeline parallelism over a ``pipe`` axis (port of
edm_tts_tpu/parallel/pipeline.py).

A stack of identical blocks is split into S stages along the mesh's
``pipe`` axis (``make_pipe_mesh``), and M microbatches stream through
them: at tick t, stage s runs microbatch t - s when 0 <= t - s < M, then
hands its output to stage s + 1. JAX writes this as one SPMD ``lax.scan``
of M + S - 1 ticks in which every stage computes every tick and throws the
bubble ticks away; here each process runs its own stages' ticks only, so
each block runs exactly once per microbatch, forward and backward.

- **Hops.** Every tensor of a stage's output dict goes to the next stage.
  Between two processes that is a point-to-point send and receive, all of
  a tick's ops posted together (``dist.batch_isend_irecv``: a blocking
  send before a receive deadlocks on gloo); between two stages of one
  process it is a move between their buffers, in the same tick loop. A
  local mesh (``make_pipe_mesh(S, local=True)``) holds every stage in one
  process: that is how one card runs S stages.
- **Side inputs** (per-microbatch data that inner stages need, such as
  injected features) reach each stage for the microbatch it runs and never
  hop.
- **Outputs.** The last stage's outputs are broadcast over the pipe group,
  so every pipe rank returns them (exact for every dtype, as JAX's masked
  ``psum``).
- **Gradients.** PyTorch has no autograd through ``send``/``recv``, so the
  reverse schedule is written out: the forward keeps each (stage,
  microbatch) graph from detached inputs, and the backward of the returned
  outputs runs the microbatches in reverse through the stages, sending
  each stage's input gradient to the stage before. The gradient of the
  replicated outputs enters the last stage once; the stages' gradients of
  the side inputs are summed over the pipe group and stage 0's input
  gradient is broadcast over it, so the parameters outside the pipe get
  their whole gradient on every pipe rank. The blocks' parameter gradients
  accumulate into ``.grad`` during that backward (``loss.backward()``, not
  ``torch.autograd.grad``).
- **Data and model axes.** Each data rank takes the data-th slice of every
  microbatch (``micro_rows``; JAX's ``micro_spec=P(None, "data")``), the
  masked loss sums are reduced over data (``mesh.sum_parts``) and every gradient
  summed over it after the backward (``reduce_gradients``). Over ``model``
  the stage's blocks are narrowed by ``parallel/tensor.py``
  (``tensor_parallel``), whose hooks add their own collectives.
- **Where the weights live.** ``split_stages`` keeps on each process only
  its stages' blocks (the others become ``Elsewhere`` placeholders, the
  names of the rest unchanged), as JAX shards the stacked stage weights
  over ``pipe``; ``PipelinePlan.gather_state`` gathers whole states by name.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from edm_tts_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, all_reduce

Tensors = dict[str, torch.Tensor]


def local_stages(mesh) -> list[int]:
    """The stages this process runs: all of them on a local mesh, its pipe
    coordinate on a distributed one."""
    if not mesh.distributed:
        return list(range(mesh.size(PIPE_AXIS)))
    return [mesh.index(PIPE_AXIS)]


class Elsewhere(nn.Module):
    """The place of a block that another process's stage holds: no
    parameters, and calling it raises."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this block belongs to pipe stage {self.stage}, held by another rank")


class PipelinePlan:
    """Which blocks each stage runs, and the whole state gathered by name."""

    def __init__(self, mesh, depth: int, prefix: str = ""):
        n = mesh.size(PIPE_AXIS)
        if depth % n:
            raise ValueError(f"depth {depth} not divisible by {n} stages")
        self.mesh, self.depth, self.per_stage = mesh, depth, depth // n
        self.stages = local_stages(mesh)
        self.prefix = f"{prefix}." if prefix else ""

    def layers(self, stage: int) -> range:
        """The global ids of ``stage``'s blocks."""
        return range(stage * self.per_stage, (stage + 1) * self.per_stage)

    def gather_state(self, state: dict) -> dict:
        """The whole state from every pipe rank's blocks (a collective over
        the pipe group: every pipe rank calls it); tensors come back on the
        CPU, this rank's own entries as they are."""
        group = self.mesh.group(PIPE_AXIS)
        if group is None or not self.mesh.distributed:
            return dict(state)
        mine = tuple(f"{self.prefix}{g}." for s in self.stages for g in self.layers(s))
        own = {k: v.detach().cpu() for k, v in state.items() if k.startswith(mine)}
        parts: list = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, own, group=group)
        out = dict(state)
        for part in parts:
            for k, v in part.items():
                out.setdefault(k, v)
        return out


def split_stages(blocks: nn.ModuleList, mesh, prefix: str = "") -> PipelinePlan:
    """Split ``blocks`` (identical blocks, in order) into the mesh's stages
    (the counterpart of JAX's ``stack_stage_params``): this process keeps
    its stages' blocks and the others become ``Elsewhere`` (in place; the
    kept blocks keep their names). ``prefix`` is the blocks' state-dict
    name (``"encoder.layers"``), for ``gather_state``."""
    plan = PipelinePlan(mesh, len(blocks), prefix)
    keep = {g for s in plan.stages for g in plan.layers(s)}
    for g in range(len(blocks)):
        if g not in keep:
            blocks[g] = Elsewhere(g // plan.per_stage)
    return plan


def micro_rows(n_rows: int, n_micro: int, mesh) -> torch.Tensor:
    """This rank's rows of a global batch of ``n_rows`` in ``n_micro``
    microbatches: the data-th slice of every microbatch, in microbatch
    order (not ``Mesh.local_rows``'s contiguous slice)."""
    if n_rows % n_micro:
        raise ValueError(f"batch {n_rows} not divisible by {n_micro} microbatches")
    size, n_data, d = n_rows // n_micro, mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    if size % n_data:
        raise ValueError(f"microbatch of {size} rows does not split over {n_data} data ranks")
    per = size // n_data
    return torch.cat([torch.arange(m * size + d * per, m * size + (d + 1) * per)
                      for m in range(n_micro)])


def reduce_gradients(module: nn.Module, mesh) -> None:
    """Sum every parameter gradient of ``module`` over the data ranks."""
    group = mesh.group(DATA_AXIS)
    for p in module.parameters():
        if p.grad is not None:
            all_reduce(p.grad, group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """What a tensor travels as (gloo has no bool)."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


class _Schedule:
    """One pipelined call: the forward ticks, the graphs they keep and the
    reverse ticks that backpropagate through them."""

    def __init__(self, stage_fn: Callable, mesh, n_micro: int, templates: Tensors):
        self.stage_fn, self.mesh, self.n_micro = stage_fn, mesh, n_micro
        self.n_stages = mesh.size(PIPE_AXIS)
        self.mine = local_stages(mesh)
        self.group = mesh.group(PIPE_AXIS) if mesh.distributed else None
        # one microbatch's names, shapes and dtypes: every stage's input and output
        self.templates = {k: (v.shape[1:], v.dtype) for k, v in templates.items()}
        self.device = next(iter(templates.values())).device
        self.saved: dict[tuple[int, int], tuple] = {}

    def _rank(self, stage: int) -> int:
        return self.mesh.peer(PIPE_AXIS, stage)

    def _empty(self, names) -> Tensors:
        return {k: torch.empty(self.templates[k][0], dtype=self.templates[k][1],
                               device=self.device) for k in names}

    def _hop(self, out: dict[int, Tensors], recv: dict[int, int], names) -> dict[int, Tensors]:
        """Deliver each message of ``out`` (destination stage -> tensors) and
        receive, for each stage of ``recv`` (stage -> source stage), the
        message of ``names`` from its neighbour: a move between this
        process's stages, or point-to-point ops all posted together."""
        got, ops, bufs = {}, [], {}
        for stage, msg in out.items():
            if stage in self.mine:
                got[stage] = msg
                continue
            for tag, k in enumerate(names):
                ops.append(dist.P2POp(dist.isend, _wire(msg[k]), self._rank(stage), self.group,
                                      tag))
        for stage, source in recv.items():
            bufs[stage] = {k: _wire(v) for k, v in self._empty(names).items()}
            for tag, k in enumerate(names):
                ops.append(dist.P2POp(dist.irecv, bufs[stage][k], self._rank(source), self.group,
                                      tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for stage, buf in bufs.items():
            got[stage] = {k: v.to(self.templates[k][1]) for k, v in buf.items()}
        return got

    def _active(self, stage: int, tick: int) -> bool:
        return 0 <= tick - stage < self.n_micro

    def forward(self, feed: Tensors, side: Tensors | None, grad: bool) -> Tensors:
        n, m_all, names = self.n_stages, self.n_micro, list(self.templates)
        if self.group is not None:
            # NCCL wants every rank of a group in its first call on it; a
            # tick's hops involve only some
            dist.barrier(group=self.group)
        inbox: dict[int, Tensors] = {}
        outputs: list[Tensors | None] = [None] * m_all
        for tick in range(m_all + n - 1):
            out = {}
            for stage in self.mine:
                if not self._active(stage, tick):
                    continue
                m = tick - stage
                src = {k: v[m] for k, v in feed.items()} if stage == 0 else inbox.pop(stage)
                x = {k: _leaf(v, grad) for k, v in src.items()}
                s_in = None if side is None else {k: _leaf(v[m], grad) for k, v in side.items()}
                with torch.set_grad_enabled(grad):
                    y = self.stage_fn(stage, x, s_in)
                for k in names:
                    if y[k].shape != self.templates[k][0] or y[k].dtype != self.templates[k][1]:
                        raise ValueError(f"stage {stage} changed {k!r} to {tuple(y[k].shape)} "
                                         f"{y[k].dtype}; a stage's output must match its input")
                if grad:
                    self.saved[(stage, m)] = (x, s_in, y)
                y = {k: y[k].detach() for k in names}
                if stage == n - 1:
                    outputs[m] = y
                else:
                    out[stage + 1] = y
            recv = {s: s - 1 for s in self.mine
                    if s > 0 and s - 1 not in self.mine and self._active(s - 1, tick)}
            inbox.update(self._hop(out, recv, names))
        if n - 1 in self.mine:
            result = {k: torch.stack([o[k] for o in outputs]) for k in names}
        else:
            result = {k: torch.empty((m_all, *self.templates[k][0]), dtype=self.templates[k][1],
                                     device=self.device) for k in names}
        if self.group is not None:
            for k in names:
                buf = _wire(result[k])
                dist.broadcast(buf, self._rank(n - 1), group=self.group)
                result[k] = buf.to(self.templates[k][1])
        return result

    def backward(self, grads: Tensors, side: Tensors | None) -> tuple[Tensors, Tensors]:
        """The reverse ticks: stage s runs microbatch M-1-j at tick
        j + (S-1-s). Returns the feed's and the side inputs' gradients, the
        same on every pipe rank."""
        n, m_all = self.n_stages, self.n_micro
        diff = [k for k, (_, dtype) in self.templates.items() if dtype.is_floating_point]
        inbox: dict[int, Tensors] = {}
        feed_grads: list[Tensors | None] = [None] * m_all
        side_grads = None if side is None else {k: torch.zeros_like(v) for k, v in side.items()}
        for tick in range(m_all + n - 1):
            out = {}
            for stage in reversed(self.mine):
                if not 0 <= tick - (n - 1 - stage) < m_all:
                    continue
                m = m_all - 1 - (tick - (n - 1 - stage))
                x, s_in, y = self.saved.pop((stage, m))
                g = {k: grads[k][m] for k in diff} if stage == n - 1 else inbox.pop(stage)
                pairs = [(y[k], g[k]) for k in diff if y[k].requires_grad and g.get(k) is not None]
                if pairs:
                    torch.autograd.backward([p[0] for p in pairs], [p[1] for p in pairs])
                gx = {k: x[k].grad if x[k].grad is not None else torch.zeros_like(x[k])
                      for k in diff}
                if s_in is not None:
                    for k, v in s_in.items():
                        if v.grad is not None:
                            side_grads[k][m] += v.grad
                if stage == 0:
                    feed_grads[m] = gx
                else:
                    out[stage - 1] = gx
            recv = {s: s + 1 for s in self.mine if s < n - 1 and s + 1 not in self.mine
                    and 0 <= tick - (n - 2 - s) < m_all}
            inbox.update(self._hop(out, recv, diff))
        if 0 in self.mine:
            feed_g = {k: torch.stack([f[k] for f in feed_grads]) for k in diff}
        else:
            feed_g = {k: torch.empty((m_all, *self.templates[k][0]), dtype=self.templates[k][1],
                                     device=self.device) for k in diff}
        if self.group is not None:
            for k in diff:
                dist.broadcast(feed_g[k], self._rank(0), group=self.group)
            for v in (side_grads or {}).values():
                dist.all_reduce(v, group=self.group)
        return feed_g, side_grads


def _leaf(x: torch.Tensor, grad: bool) -> torch.Tensor:
    """A stage's own input: cut from whatever made it, and a leaf that
    collects its gradient when ``grad`` and ``x`` is floating."""
    x = x.detach()
    return x.requires_grad_() if grad and x.dtype.is_floating_point else x


class _Pipe(torch.autograd.Function):
    """The pipelined call as one autograd node: its backward is the
    schedule's reverse ticks."""

    @staticmethod
    def forward(ctx, schedule, feed_names, side_names, *tensors):
        feed = dict(zip(feed_names, tensors[:len(feed_names)]))
        side = (dict(zip(side_names, tensors[len(feed_names):len(feed_names) + len(side_names)]))
                if side_names else None)
        out = schedule.forward(feed, side, grad=True)
        ctx.schedule, ctx.feed_names, ctx.side, ctx.names = schedule, feed_names, side, list(out)
        ctx.mark_non_differentiable(*[v for v in out.values() if not v.dtype.is_floating_point])
        return tuple(out.values())

    @staticmethod
    def backward(ctx, *grads):
        grads = dict(zip(ctx.names, grads))
        feed_g, side_g = ctx.schedule.backward(grads, ctx.side)
        return (None, None, None, *[feed_g.get(k) for k in ctx.feed_names],
                *([] if ctx.side is None else list(side_g.values())), None)


def pipeline_apply(stage_fn: Callable[[int, Tensors, Tensors | None], Tensors],
                   micro_inputs: Tensors, mesh, *, side_inputs: Tensors | None = None
                   ) -> Tensors:
    """Run M microbatches through the mesh's S pipeline stages.

    ``stage_fn(stage, x, side) -> y`` applies the blocks of ``stage`` (its
    global index) to one microbatch: ``x`` a dict of tensors, ``y`` a dict
    of the same names, shapes and dtypes (pass-through fields ride along).
    ``micro_inputs``: name -> ``(M, ...)`` tensors, this rank's rows of
    each microbatch (``micro_rows``); only stage 0 reads them.
    ``side_inputs``: name -> ``(M, ...)``, given to every stage as ``side``
    for the microbatch it runs (None: ``side`` is None).

    Returns the last stage's outputs, ``(M, ...)`` per name, on every pipe
    rank. While autograd records, the call is differentiable in
    ``micro_inputs`` and ``side_inputs``, and its backward accumulates the
    stages' parameter gradients into ``.grad``.
    """
    n_micro = next(iter(micro_inputs.values())).shape[0]
    if any(v.shape[0] != n_micro for v in (side_inputs or {}).values()):
        raise ValueError("side inputs must have the microbatches' leading dim")
    schedule = _Schedule(stage_fn, mesh, n_micro, micro_inputs)
    if not torch.is_grad_enabled():
        return schedule.forward(micro_inputs, side_inputs, grad=False)
    feed_names, side_names = list(micro_inputs), list(side_inputs or {})
    # the stages' parameters are not inputs of the node: an input that needs
    # a gradient makes autograd call its backward even when no other does
    anchor = torch.zeros((), device=schedule.device, requires_grad=True)
    outs = _Pipe.apply(schedule, feed_names, side_names, *micro_inputs.values(),
                       *(side_inputs or {}).values(), anchor)
    return dict(zip(micro_inputs, outs))
