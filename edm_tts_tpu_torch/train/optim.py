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
update still advances the count.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

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


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """l2 norm over all elements of ``tensors`` (f32 scalar)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class AdamW:
    """Global-norm clipping and AdamW over the trainable parameters.

    ``named_params``: ``(name, parameter)`` pairs; those that do not require
    grad are left out. The moments are f32 tensors shaped like the
    parameters. ``step`` reads each parameter's ``.grad``.
    """

    def __init__(self, named_params, schedule: Schedule, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: float | None = None):
        self.named = [(n, p) for n, p in named_params if p.requires_grad]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for _, p in self.named]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for _, p in self.named]
        self.count = 0  # updates made, skipped ones included

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.named]

    @torch.no_grad()
    def step(self, *, skip_nonfinite: bool = False) -> dict[str, torch.Tensor]:
        """One update from the parameters' gradients. Returns ``grad_norm``
        (before clipping) and ``lr``; with ``skip_nonfinite`` a non-finite
        norm leaves parameters and moments as they are and reports
        ``skipped_nonfinite`` 1 (the count still advances)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = global_norm(grads)
        lr = self.schedule(self.count)
        self.count += 1
        out = {"grad_norm": norm, "lr": torch.tensor(lr)}
        if skip_nonfinite:
            finite = bool(torch.isfinite(norm))
            out["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0)
            if not finite:
                return out
        if self.max_grad_norm is not None and not bool(norm < self.max_grad_norm):
            grads = [g / norm * self.max_grad_norm for g in grads]  # as optax orders it
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (m / c1) / ((v / c2).sqrt() + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(update, alpha=-lr)
        return out

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": {n: m for (n, _), m in zip(self.named, self.mu)},
                "nu": {n: v for (n, _), v in zip(self.named, self.nu)}}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for (n, _), m, v in zip(self.named, self.mu, self.nu):
            m.copy_(state["mu"][n])
            v.copy_(state["nu"][n])
