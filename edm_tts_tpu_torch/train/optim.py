"""Optimizer and learning-rate schedules of the trainings (port of
edm_tts_tpu/train/optim.py): the s2a/t2s warmup-cosine schedule and the
codec GAN's per-step exponential one.

``AdamW`` is ``optax.chain(clip_by_global_norm, adamw)`` written out over
the trainable parameters only, the set the JAX package's masked optax
chain sees: the frozen codec (``freeze_submodule``, the JAX
``freeze_subtree_mask``) has ``requires_grad=False`` and is not touched.
It is written by hand rather than taken from ``torch.optim`` so that the
arithmetic and the step count follow optax's: the schedule is read at the
count of updates made so far (0 for the first update), and a skipped
update still advances the count. The same update runs on several ranks
with the moments sharded over fsdp (ZeRO-2); one process is a group of one.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from edm_tts_tpu_torch.parallel.mesh import BATCH, DATA_AXIS, FSDP_AXIS, MODEL_AXIS, local_mesh

Schedule = Callable[[int], float]


def exponential_schedule(base_lr: float, gamma: float) -> Schedule:
    """``base_lr * gamma ** count``: torch's ExponentialLR stepped every
    batch, as the codec GAN's two optimizers run it."""

    def schedule(count: int) -> float:
        return base_lr * gamma ** count

    return schedule


def warmup_cosine_schedule(
    base_lr: float, warmup_steps: int, total_steps: int, final_ratio: float = 0.0
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, warmup + 1), base_lr * final_ratio)``: linear warmup from 0,
    then cosine decay to ``final_ratio * base_lr``."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    end = base_lr * final_ratio

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        frac = min(count - warmup, decay) / decay
        return end + (base_lr - end) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def freeze_submodule(model: nn.Module, name: str) -> None:
    """Freeze every parameter under ``model.<name>`` (the embedded codec)."""
    for p in model.get_submodule(name).parameters():
        p.requires_grad_(False)


def _reduce_scatter(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, flat, group=group)


def _all_gather(out: torch.Tensor, piece: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, piece, group=group)


class AdamW:
    """Global-norm clipping and AdamW over the trainable parameters, with the
    moments sharded over the fsdp ranks (ZeRO-2, what the reference runs
    through DeepSpeed, ``configs/ds_config.json``).

    ``named_params``: ``(name, parameter)`` pairs; those that do not require
    grad are left out. ``mesh`` (``parallel.mesh``; default ``local_mesh()``,
    this process alone) lays the ranks out. The trainable parameters are
    laid end to end in one f32 buffer, padded to a multiple of n_fsdp; the
    rank at fsdp index f owns the f-th contiguous slice and keeps
    ``mu``/``nu`` for it alone (the whole buffer in one process).
    ``reduce_gradients`` sums the parameters' ``.grad`` over the ranks of the
    batch (reduce-scattered over fsdp, all-reduced over data) and divides;
    ``apply`` takes the global norm (the all-reduced sum of the slices'
    squares), clips and updates the slice elementwise in optax's order and
    all-gathers the updated slices into the parameters. Every rank sees the
    same norm, so ``skip_nonfinite`` skips on all of them. In a group of one
    the collectives are skipped and the parameters are updated in place.

    With tensor parallelism (``plan``, ``parallel.tensor.TensorParallelPlan``)
    the parameters are this rank's model shard; the buffer holds the sharded
    ones first, and their squares are summed over the model ranks too.
    ``state_dict`` / ``load_state_dict`` hold whole per-name moments, so a
    checkpoint moves between topologies.
    """

    def __init__(self, named_params, schedule: Schedule, *, mesh=None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: float | None = None, plan=None):
        self.named = [(n, p) for n, p in named_params if p.requires_grad]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.mesh = mesh if mesh is not None else local_mesh()
        self.plan = plan
        self.fsdp = self.mesh.group(FSDP_AXIS)
        self.data = self.mesh.group(DATA_AXIS)
        self.model = self.mesh.group(MODEL_AXIS)
        self.n_batch = self.mesh.size(BATCH)
        sharded = plan.sharded if plan is not None else frozenset()
        # the model-sharded parameters first, the replicated ones after
        self.order = sorted(range(len(self.named)), key=lambda i: self.named[i][0] not in sharded)
        self.sizes = [self.named[i][1].numel() for i in self.order]
        self.n_sharded = sum(s for i, s in zip(self.order, self.sizes)
                             if self.named[i][0] in sharded)
        n_fsdp = self.mesh.size(FSDP_AXIS)
        self.shard = -(-sum(self.sizes) // n_fsdp)
        self.padded = self.shard * n_fsdp
        self.lo = self.mesh.index(FSDP_AXIS) * self.shard
        self.own = self._pieces(self.lo, self.lo + self.shard)
        device = self.named[0][1].device
        self.mu = torch.zeros(self.shard, dtype=torch.float32, device=device)
        self.nu = torch.zeros(self.shard, dtype=torch.float32, device=device)
        self.count = 0  # updates made, skipped ones included
        # with fsdp, ``reduce_gradients`` also gathers the whole reduced
        # gradient into each ``.grad`` (for per-tensor norms, as the codec
        # GAN's ``watch`` reads them); without, ``.grad`` always views it
        self.write_grads = False

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.named]

    def _pieces(self, lo: int, hi: int) -> list[tuple[int, int, int, int, int]]:
        """``(parameter index, start, end within the parameter, start, end
        within [lo, hi))`` for each parameter that meets [lo, hi) of the buffer."""
        out, off = [], 0
        for i, size in zip(self.order, self.sizes):
            a, b = max(off, lo), min(off + size, hi)
            if a < b:
                out.append((i, a - off, b - off, a - lo, b - lo))
            off += size
        return out

    def _pack(self, tensors: list[torch.Tensor | None], lo: int, hi: int) -> torch.Tensor:
        """[lo, hi) of the f32 buffer of ``tensors`` (in parameter order; None
        is zeros), copied piece by piece."""
        out = torch.zeros(hi - lo, dtype=torch.float32, device=self.mu.device)
        for i, a, b, sa, sb in self._pieces(lo, hi):
            if tensors[i] is not None:
                out[sa:sb] = tensors[i].reshape(-1)[a:b]
        return out

    def _unflat(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """The whole buffer ``flat`` as views, per name in parameter order."""
        views, off = {}, 0
        for i, size in zip(self.order, self.sizes):
            views[i] = flat[off:off + size].view(self.named[i][1].shape)
            off += size
        return {self.named[i][0]: views[i] for i in range(len(self.named))}

    def _gather(self, piece: torch.Tensor) -> torch.Tensor:
        if self.fsdp is None:
            return piece
        flat = torch.empty(self.padded, dtype=piece.dtype, device=piece.device)
        _all_gather(flat, piece.contiguous(), self.fsdp)
        return flat

    @torch.no_grad()
    def reduce_gradients(self, grad_divisor=None) -> torch.Tensor:
        """This rank's slice of the global gradient: the parameters' ``.grad``
        summed over data x fsdp, divided by ``grad_divisor`` (default: the
        ranks of the batch, a mean). Afterwards each ``.grad`` is its part of
        the reduced gradient (a view; gathered with fsdp under
        ``write_grads``, else None)."""
        flat = torch.zeros(self.padded, dtype=torch.float32, device=self.mu.device)
        for i, _, _, a, b in self._pieces(0, self.padded):
            p = self.named[i][1]
            if p.grad is not None:
                flat[a:b] = p.grad.reshape(-1)
            p.grad = None  # freed as soon as it is copied
        if self.fsdp is None:
            g = flat
        else:
            g = torch.empty(self.shard, dtype=torch.float32, device=flat.device)
            _reduce_scatter(g, flat, self.fsdp)
            del flat
        if self.data is not None:
            dist.all_reduce(g, group=self.data)
        g.div_(self.n_batch if grad_divisor is None else grad_divisor)
        if self.fsdp is None or self.write_grads:
            for (_, p), full in zip(self.named, self.full_gradients(g).values()):
                p.grad = full if full.dtype == p.dtype else full.to(p.dtype)
        return g

    @torch.no_grad()
    def full_gradients(self, g: torch.Tensor) -> dict[str, torch.Tensor]:
        """The whole reduced gradient per name (all-gathered), this rank's
        model shard of it under tensor parallelism."""
        return self._unflat(self._gather(g))

    @torch.no_grad()
    def global_norm(self, g: torch.Tensor) -> torch.Tensor:
        cut = min(max(self.n_sharded - self.lo, 0), self.shard)
        sq_sharded = torch.linalg.vector_norm(g[:cut]).square()
        if self.model is not None:
            dist.all_reduce(sq_sharded, group=self.model)
        sq = sq_sharded + torch.linalg.vector_norm(g[cut:]).square()
        if self.fsdp is not None:
            dist.all_reduce(sq, group=self.fsdp)
        return sq.sqrt()

    @torch.no_grad()
    def apply(self, g: torch.Tensor, *, skip_nonfinite: bool = False) -> dict[str, torch.Tensor]:
        """One update from the reduced gradient slice ``g``. Returns
        ``grad_norm`` (before clipping) and ``lr``; with ``skip_nonfinite`` a
        non-finite norm leaves parameters and moments as they are and reports
        ``skipped_nonfinite`` 1 (the count still advances)."""
        norm = self.global_norm(g)
        lr = self.schedule(self.count)
        self.count += 1
        out = {"grad_norm": norm, "lr": torch.tensor(lr)}
        if skip_nonfinite:
            finite = bool(torch.isfinite(norm))
            out["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0)
            if not finite:
                return out
        clip = self.max_grad_norm is not None and not bool(norm < self.max_grad_norm)
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        # piece by piece, straight from and (in a group of one) into the
        # parameters: no whole-size temporaries
        piece = None if self.fsdp is None else torch.zeros_like(self.mu)
        for i, a, b, sa, sb in self.own:
            param = self.named[i][1].view(-1)[a:b]
            gs, m, v = g[sa:sb], self.mu[sa:sb], self.nu[sa:sb]
            if clip:
                gs = gs / norm * self.max_grad_norm  # as optax orders it
            m.mul_(self.b1).add_(gs, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(gs, gs, value=1.0 - self.b2)
            update = (m / c1) / ((v / c2).sqrt() + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * param
            if piece is None:
                param.add_(update, alpha=-lr)
            else:
                torch.add(param, update, alpha=-lr, out=piece[sa:sb])
        if piece is not None:
            for (_, param), new in zip(self.named, self._unflat(self._gather(piece)).values()):
                param.copy_(new)
        return out

    def step(self, *, skip_nonfinite: bool = False, grad_divisor=None) -> dict[str, torch.Tensor]:
        """``apply(reduce_gradients(grad_divisor))``."""
        return self.apply(self.reduce_gradients(grad_divisor), skip_nonfinite=skip_nonfinite)

    # -- checkpoints: whole per-name moments ---------------------------------
    def _full(self, piece: torch.Tensor) -> dict[str, torch.Tensor]:
        by_name = self._unflat(self._gather(piece))
        if self.plan is not None:
            by_name = self.plan.gather_state(by_name)
        return by_name

    def state_dict(self) -> dict:
        """The count and the moments of every parameter in full (gathered
        over fsdp, and over model under tensor parallelism). A collective:
        every rank calls it."""
        return {"count": self.count, "mu": self._full(self.mu), "nu": self._full(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        """Each rank takes its slice of whole per-name moments, whatever
        topology wrote them."""
        self.count = int(state["count"])
        for name, buf in (("mu", self.mu), ("nu", self.nu)):
            full = state[name]
            if self.plan is not None:
                full = self.plan.shard_state(full)
            buf.copy_(self._pack([full[n].to(buf.device) for n, _ in self.named],
                                 self.lo, self.lo + self.shard))
