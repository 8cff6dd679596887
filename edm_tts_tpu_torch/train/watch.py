"""Per-tensor gradient and parameter watching (port of
edm_tts_tpu/train/watch.py, the ``wandb.watch`` analog).

``WANDB_WATCH`` (or the recipe's ``watch``) makes the trainer log the L2
norm of each trainable tensor's gradient and value every ``logging_steps``:
``watch/grad_norm/<name>`` and ``watch/param_norm/<name>``, ``<name>`` the
parameter's name in the model (the reference's ``state_dict`` key). As in
the JAX trainer they are taken on the device after the accumulated backward
(the gradient before clipping, the parameters before the update), as one
multi-tensor reduction per kind, and fetched only when the loop logs.

Modes mirror wandb's: ``"gradients"`` logs grad norms, ``"parameters"``
param norms, ``"all"`` both (WANDB_WATCH vocabulary, minus "false").
"""

from __future__ import annotations

from typing import Mapping

import torch

WATCH_MODES = ("gradients", "parameters", "all")


def _norms(tensors: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    if not tensors:
        return {}
    values = torch._foreach_norm([t.detach().float() for t in tensors.values()], 2)
    return {f"{prefix}{name}": v for name, v in zip(tensors, values)}


def watch_metrics(
    mode: str | None,
    grads: Mapping[str, torch.Tensor] | None = None,
    params: Mapping[str, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """Per-tensor L2 norms (f32 device scalars) to merge into a train step's
    metrics dict.

    Keys: ``watch/grad_norm/<name>`` and ``watch/param_norm/<name>``.
    ``mode`` None/"false" returns {} so call sites can pass the arg through
    unconditionally.
    """
    if not mode or mode == "false":
        return {}
    if mode not in WATCH_MODES:
        raise ValueError(f"watch mode {mode!r} not in {WATCH_MODES}")
    out: dict[str, torch.Tensor] = {}
    if grads is not None and mode in ("gradients", "all"):
        out.update(_norms(grads, "watch/grad_norm/"))
    if params is not None and mode in ("parameters", "all"):
        out.update(_norms(params, "watch/param_norm/"))
    return out
