"""Process-group initialization and host-level collectives (port of
edm_tts_tpu/parallel/dist.py).

One process per device, launched by ``torchrun`` (``torchrun
--nproc_per_node N -m edm_tts_tpu_torch.train.run_s2a recipe.yaml``):
``initialize`` reads the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and joins the group, NCCL
when the process's device is the card and gloo on the CPU. Without that
environment it does nothing and the run is one process, as the JAX
``initialize`` is a no-op on one host. A failed NCCL start raises: nothing
falls back to gloo or the CPU. The other helpers are the ones the trainers
and the dump job need: the rank, a barrier, and the gather and weighted
global mean of host metrics.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(device: str | torch.device = "cuda") -> torch.device:
    """Join the process group ``torchrun`` describes and return this
    process's device: ``cuda:LOCAL_RANK`` (set as the current device, NCCL)
    for a CUDA ``device``, the CPU (gloo) otherwise. Without ``RANK`` and
    ``WORLD_SIZE`` in the environment, or when the group already exists,
    it starts nothing and returns ``device``."""
    device = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not is_distributed():
        if device.type == "cuda":
            dist.init_process_group("nccl", init_method="env://", device_id=device)
        else:
            dist.init_process_group("gloo", init_method="env://")
    return device


def process_info() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the current
    card under NCCL, the CPU under gloo."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Wait for every process (the reference's ``wait_for_everyone``)."""
    if is_distributed():
        dist.barrier()


def all_gather_metrics(value: float) -> np.ndarray:
    """One host scalar from every process, in rank order."""
    if not is_distributed():
        return np.asarray([float(value)])
    x = torch.tensor([float(value)], dtype=torch.float64, device=collective_device())
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return torch.cat(out).cpu().numpy()


def global_mean_metrics(totals: dict, count: int) -> dict:
    """The weighted mean over every process of per-process metric sums.

    Each process passes its metric SUMS and its batch count; every process
    gets the mean over all batches of all processes, so they report the
    same eval metrics and make the same best-model decisions. One process:
    ``totals / count``."""
    if not is_distributed():
        return {k: v / max(count, 1) for k, v in totals.items()}
    keys = sorted(totals)
    vec = torch.tensor([float(totals[k]) for k in keys] + [float(count)],
                       dtype=torch.float64, device=collective_device())
    dist.all_reduce(vec)
    sums = vec.cpu().tolist()
    n = max(sums[-1], 1.0)
    return {k: sums[i] / n for i, k in enumerate(keys)}


def any_rank(*flags: bool) -> list[bool]:
    """Each flag, set if it is set on any process (so that all stop at the
    same step)."""
    if not is_distributed():
        return list(flags)
    x = torch.tensor([float(f) for f in flags], device=collective_device())
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return [bool(v) for v in x.tolist()]
