"""The training cell's comparison with the reference.

The program's trainer runs the recipe's first three optimizer steps in
set-up on batches that all differ; ``Readings`` keeps what they gave: each
step's loss, each leaf's norm of the first gradient as the optimizer got it
(``mu / (1 - b1)`` after one step: the clipped gradient) and each leaf's
norm of its change over the three steps. ``reference_readings`` computes
the same with the reference (f32, or fp8 for the control): the recipe's
loss on the same batches and masks, micro-batches weighted by their masked
counts, global-norm clipping and AdamW with the warmup-cosine schedule read
at the count of updates made.

Numbers compared:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the worst leaf's gap of first-gradient norms, over the larger
  of the reference leaf's norm and the median leaf's;
- ``update``: the same for the change over three steps, leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's (they move under Adam by round-off alone).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import model as ref


@dataclasses.dataclass
class Readings:
    losses: list
    grad_norms: dict  # leaf -> norm of the first (clipped) gradient
    change_norms: dict  # leaf -> norm of the change over the steps


def trainable(name: str) -> bool:
    return not name.startswith("acoustic_model.")


def lr_at(rc: dict, count: int) -> float:
    """Linear warmup from 0, then cosine decay to 0 (read at the count of
    updates made before this one)."""
    warm = max(rc["warmup_steps"], 1)
    decay = max(rc["max_steps"], rc["warmup_steps"] + 1) - warm
    if count < warm:
        return rc["learning_rate"] * count / warm
    frac = min(count - warm, decay) / decay
    return rc["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * frac))


def reference_readings(cfg: dict, state: dict, batches: list, *, precision: str = "f32"
                       ) -> Readings:
    """The recipe's steps on ``batches`` in the reference."""
    rc, s2c, codec = cfg["recipe"], cfg["s2a"], cfg["codec"]
    params = {n: t.detach().float().clone().requires_grad_(trainable(n)) for n, t in state.items()}
    start = {n: p.detach().clone() for n, p in params.items() if trainable(n)}
    leaves = list(start)
    p = ref.Params(params, precision=precision)
    m = {n: torch.zeros_like(start[n]) for n in leaves}
    v = {n: torch.zeros_like(start[n]) for n in leaves}
    b1, b2 = rc["adam_beta1"], rc["adam_beta2"]
    losses, grad_norms = [], {}
    for count, batch in enumerate(batches):
        for n in leaves:
            params[n].grad = None
        total = weight = 0.0
        for chunk in zip(*(batch[k].chunk(rc["micro_batches"]) for k in
                           ("acoustic_tokens", "semantic_tokens", "mask"))):
            loss, n_masked = ref.s2a_train_loss(p, s2c, codec, *chunk)
            w = n_masked.float()
            (loss * w).backward()
            total = total + loss.detach() * w
            weight = weight + w
        losses.append(float(total / weight))
        with torch.no_grad():
            grads = {n: params[n].grad / weight for n in leaves}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = rc["max_grad_norm"] / norm if norm >= rc["max_grad_norm"] else 1.0
            lr = lr_at(rc, count)
            c1, c2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
            for n in leaves:
                g = grads[n] * scale
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                update = (m[n] / c1) / ((v[n] / c2).sqrt() + rc["adam_epsilon"])
                if rc["weight_decay"]:
                    update = update + rc["weight_decay"] * params[n]
                params[n].add_(update, alpha=-lr)
            if count == 0:
                grad_norms = {n: float(m[n].norm()) / (1.0 - b1) for n in leaves}
    with torch.no_grad():
        change = {n: float((params[n] - start[n]).norm()) for n in leaves}
    return Readings(losses, grad_norms, change)


def compare(prog: Readings, refr: Readings) -> dict[str, float]:
    """The three numbers compared (see the module's docstring)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog.losses, refr.losses))
    g_med = sorted(refr.grad_norms.values())[len(refr.grad_norms) // 2]
    grad = max(abs(prog.grad_norms[n] - r) / max(r, g_med) for n, r in refr.grad_norms.items())
    moved = [n for n, g in refr.grad_norms.items() if g >= 1e-3 * g_med]
    c_med = sorted(refr.change_norms[n] for n in moved)[len(moved) // 2]
    update = max(abs(prog.change_norms[n] - refr.change_norms[n])
                 / max(refr.change_norms[n], c_med) for n in moved)
    return {"loss": loss, "grad": grad, "update": update}


def worst_leaves(prog: Readings, refr: Readings, k: int = 3) -> list:
    """The ``k`` leaves with the largest gradient-norm gap (for the log)."""
    g_med = sorted(refr.grad_norms.values())[len(refr.grad_norms) // 2]
    gaps = sorted(((abs(prog.grad_norms[n] - r) / max(r, g_med), n)
                   for n, r in refr.grad_norms.items()), reverse=True)
    return gaps[:k]
