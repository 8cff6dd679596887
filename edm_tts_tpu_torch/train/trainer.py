"""The generic masked-LM trainer (port of edm_tts_tpu/train/trainer.py).

The loop of the JAX ``Trainer``: AdamW with linear warmup and cosine decay,
global-norm clipping, gradient accumulation over micro-batches weighted by
their masked-token counts, optional skipping of non-finite updates,
logging, held-out evaluation, a wall-clock limit, checkpoints every
``save_steps`` with ``save_total_limit`` kept, automatic resume and a
checkpoint on SIGTERM. Weights, gradients and the Adam moments are f32;
the loss function chooses the compute dtype (``run_s2a`` runs the forward
under bf16 autocast, as the JAX package builds its modules with
``dtype=bf16``, or in f32 with ``bf16: false``). ``watch`` adds per-tensor
norms to the logged metrics (``train/watch.py``), ``trackers`` names remote
trackers that receive every logged record (``utils/logging.py``).

Spans (``utils.profiling``, while it records; each a named range in a
``utils.profiling.trace``, as the JAX loop's ``StepTraceAnnotation``):
``train.step`` around ``train_step``; inside it, per micro-batch,
``train.forward`` (the loss function) and ``train.backward``, then
``train.reduce`` (the all-reduce of the sums and ``reduce_gradients``) and
``train.optimizer`` (``watch`` when on and ``AdamW.apply``, whose clipping
test waits for the gradient norm, so the span also holds the device's
backlog of the step).

Randomness: each step's generator is seeded from ``(seed, step)`` (and
each micro-batch's from that and its index), as the JAX loop folds the step
into its key, so a resumed run draws what an unbroken one would.

Several devices: one process per device (``torchrun``; ``parallel.dist.
initialize``), laid out by ``parallel.mesh.make_mesh(n_fsdp=, n_model=,
n_seq=)`` (ValueError when they do not multiply to the world size, as the
JAX assert). ``per_device_train_batch_size`` is the global batch, as the
JAX trainer shards one over its mesh: each data x fsdp rank takes its
contiguous rows, and its micro-batch i is the global micro-batch
c = rank * micro_batches + i with the generator of ``(step seed, c)``, so an
N-rank step is the one-process step with N * micro_batches micro-batches.
The weighted gradient sums and weights are reduced over the ranks (the
global masked-mean gradient, not a mean of per-rank means) by
``AdamW`` (ZeRO-2: each fsdp rank keeps the moments of its slice of
the parameters); ``n_model`` splits the Conformer blocks
(``parallel.tensor``), and ``n_seq`` runs a model built with
``attn_implementation="ring"`` on the mesh's ring. The metrics are global
means on every rank; rank 0 alone writes logs, trackers and checkpoints,
which hold whole tensors and so load on any number of ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, Mapping

import torch
from torch import nn

from edm_tts_tpu_torch.parallel.dist import any_rank, barrier, global_mean_metrics
from edm_tts_tpu_torch.parallel.mesh import BATCH, all_reduce, make_mesh
from edm_tts_tpu_torch.train.checkpoint import CheckpointManager, detect_last_checkpoint
from edm_tts_tpu_torch.train.optim import AdamW, warmup_cosine_schedule
from edm_tts_tpu_torch.train.preemption import PreemptionGuard
from edm_tts_tpu_torch.train.watch import watch_metrics
from edm_tts_tpu_torch.utils.logging import MetricLogger, logger
from edm_tts_tpu_torch.utils.profiling import span

_MIX = 0x9E3779B97F4A7C15  # 2^64 / golden ratio


@dataclasses.dataclass
class TrainingArguments:
    output_dir: str
    seed: int = 42
    per_device_train_batch_size: int = 32
    max_steps: int = 100_000
    learning_rate: float = 3e-4
    warmup_steps: int = 4000
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 0.5
    logging_steps: int = 100
    eval_steps: int = 1000
    save_steps: int = 10_000
    save_total_limit: int = 2
    time_limit: str | None = None  # "hh:mm" wall clock
    overwrite_output_dir: bool = False
    resume_from_checkpoint: str | None = None
    n_fsdp: int = 1
    # split each batch into this many micro-batches and accumulate
    # sum_i(w_i g_i) / sum_i(w_i), w_i = the loss function's "loss_weight"
    # (the masked-token count): the full-batch masked-mean gradient
    micro_batches: int = 1
    n_model: int = 1
    n_seq: int = 1
    trackers: tuple[str, ...] = ()
    # skip the update when the gradient norm is not finite (the step count
    # still advances, so the schedule stays on time)
    skip_nonfinite_updates: bool = False
    watch: str | None = None

    def time_limit_seconds(self) -> float | None:
        if not self.time_limit:
            return None
        hh, mm = self.time_limit.split(":")
        return int(hh) * 3600 + int(mm) * 60


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (``jax.random.fold_in``'s
    role: distinct, reproducible streams per step and micro-batch)."""
    x = (seed * _MIX + data + 1) & (2 ** 64 - 1)
    x ^= x >> 31
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x ^= x >> 29
    return x & (2 ** 63 - 1)


LossFn = Callable[[Mapping[str, torch.Tensor], torch.Generator],
                  tuple[torch.Tensor, dict[str, torch.Tensor]]]


class Trainer:
    """Trains ``model``'s parameters that require grad.

    ``loss_fn(batch, generator) -> (loss, metrics)`` closes over the model;
    ``metrics["loss_weight"]`` (optional) weights its micro-batch.
    ``eval_fn(batch) -> {name: scalar}`` runs without gradients. Batches
    are dicts of arrays or tensors with the batch on dim 0; they are moved
    to ``device``.
    """

    def __init__(self, args: TrainingArguments, model: nn.Module, loss_fn: LossFn, *,
                 eval_fn: Callable | None = None, device="cuda", mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh(
            n_fsdp=args.n_fsdp, n_model=args.n_model, n_seq=args.n_seq)
        if args.per_device_train_batch_size % (self.mesh.size(BATCH) * max(1, args.micro_batches)):
            raise ValueError("per_device_train_batch_size must be a multiple of micro_batches "
                             "times the data x fsdp ranks")
        self.args = args
        self.model = model
        self.device = torch.device(device)
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.plan = None
        if self.mesh.size("model") > 1:
            from edm_tts_tpu_torch.parallel.tensor import tensor_parallel

            self.plan = tensor_parallel(model, self.mesh)
        opt = dict(b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
                   weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm)
        schedule = warmup_cosine_schedule(args.learning_rate, args.warmup_steps, args.max_steps)
        self.optimizer = AdamW(model.named_parameters(), schedule, mesh=self.mesh,
                               plan=self.plan, **opt)
        # the overwrite guard runs before anything is written to output_dir
        detect_last_checkpoint(args.output_dir, args.overwrite_output_dir)
        if self.mesh.distributed:
            barrier()
        self.ckpt = CheckpointManager(args.output_dir, args.save_total_limit)
        self.metrics = (MetricLogger(args.output_dir, trackers=args.trackers)
                        if self.mesh.rank == 0 else SilentMetricLogger())
        self.history: list[dict] = []  # every record logged, train and eval
        self.last_save: dict | None = None

    # -- one optimizer step --------------------------------------------------
    def _to_device(self, batch: Mapping) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, batch: Mapping, step: int) -> dict[str, torch.Tensor]:
        """Gradient of ``batch`` (the global batch) and one update, whatever
        the caller's grad mode. This rank's rows are micro-batches
        ``rank * micro_batches + i`` of the global batch; their weighted
        sums are reduced over data x fsdp, and the optimizer takes the global
        masked-mean gradient. Returns the step's metrics as device scalars."""
        with span("train.step"):
            for p in self.optimizer.params:
                p.grad = None
            n_micro = max(1, self.args.micro_batches)
            batch = self._to_device(self.mesh.local_rows(batch))
            with torch.enable_grad(), self.mesh:
                sums, w_sum = self._weighted_sums(batch, fold_in(self.args.seed, step), n_micro,
                                                  self.mesh.index(BATCH) * n_micro)
            with span("train.reduce"):
                keys = list(sums)
                vec = all_reduce(torch.stack([w_sum] + [sums[k] for k in keys]),
                                 self.mesh.group(BATCH))
                metrics = {k: vec[i + 1] / vec[0] for i, k in enumerate(keys)}
                g = self.optimizer.reduce_gradients(vec[0])
            with span("train.optimizer"):
                if self.args.watch:  # the gradient before clipping, the parameters before it
                    metrics.update(watch_metrics(
                        self.args.watch, grads=self._whole(self.optimizer.full_gradients(g)),
                        params=self._whole(dict(self.optimizer.named))))
                metrics.update(self.optimizer.apply(
                    g, skip_nonfinite=self.args.skip_nonfinite_updates))
            return metrics

    def _whole(self, state: dict) -> dict:
        """Whole tensors from this rank's model shards (a collective under
        tensor parallelism)."""
        return state if self.plan is None else self.plan.gather_state(state)

    def _weighted_sums(self, batch: Mapping, step_seed: int, n_micro: int, first: int):
        """Backward of sum_i(w_i loss_i) over the micro-batches into p.grad
        (micro-batch i draws from ``(step_seed, first + i)``); returns the
        metrics' weighted sums and sum_i(w_i). A step of one micro-batch in
        all takes w = 1 (the plain gradient, as the JAX step without
        accumulation)."""
        chunks = {k: v.chunk(n_micro) for k, v in batch.items()}
        alone = n_micro * self.mesh.size(BATCH) == 1
        sums: dict[str, torch.Tensor] = {}
        w_sum = torch.zeros((), device=self.device)
        for i in range(n_micro):
            micro = {k: c[i] for k, c in chunks.items()}
            with span("train.forward"):
                loss, metrics = self.loss_fn(micro, self._generator(fold_in(step_seed, first + i)))
            metrics = dict(metrics)
            w = metrics.pop("loss_weight", 1.0)
            w = torch.as_tensor(1.0 if alone else w, dtype=torch.float32, device=self.device)
            with span("train.backward"):
                # d(loss * w)/dp = w g: the weighted term, summed in p.grad
                (loss if alone else loss * w).backward()
            metrics["loss"] = loss.detach()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + w * v.detach().float()
            w_sum = w_sum + w
        return sums, w_sum

    # -- checkpoints ---------------------------------------------------------
    def model_state(self) -> dict:
        """The model's state dict with whole tensors (gathered over the model
        ranks under tensor parallelism: a collective)."""
        return self._whole(self.model.state_dict())

    def save(self, step: int) -> str | None:
        """Checkpoint the train state at ``step`` (once per step); the last
        save's path and seconds are kept in ``last_save``. Every rank takes
        part (the sharded state is gathered whole), rank 0 writes, and all
        meet at a barrier."""
        t0 = time.perf_counter()
        state = {"model": self.model_state(), "optimizer": self.optimizer.state_dict(),
                 "step": step}
        path = self.ckpt.save(step, state, {"step": step}) if self.mesh.rank == 0 else None
        if self.mesh.distributed:
            barrier()
        if path is not None:
            self.last_save = {"step": step, "path": path, "seconds": time.perf_counter() - t0}
            logger.info("saved %s in %.2f s", path, self.last_save["seconds"])
        return path

    def maybe_resume(self) -> int:
        """Restore the explicit ``resume_from_checkpoint`` or the latest
        checkpoint of ``output_dir`` (unless overwriting); returns the step.
        Each rank takes its part of the whole tensors, whatever number of
        ranks wrote them."""
        args = self.args
        if args.resume_from_checkpoint:
            mgr = CheckpointManager(args.resume_from_checkpoint, None)
        elif not args.overwrite_output_dir and self.ckpt.latest_step() is not None:
            mgr = self.ckpt
        else:
            return 0
        state, meta = mgr.restore(map_location=self.device)
        model_state = state["model"]
        if self.plan is not None:
            model_state = self.plan.shard_state(model_state)
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(state["optimizer"])
        logger.info("resumed from checkpoint step %s", meta["step"])
        return int(meta["step"])

    # -- main loop -----------------------------------------------------------
    def train(self, train_iter: Iterator, eval_iter: Iterable | None = None) -> nn.Module:
        with PreemptionGuard() as guard:
            self.guard = guard
            return self._train_loop(train_iter, eval_iter, guard)

    def _log(self, step: int, metrics: Mapping, prefix: str) -> dict:
        record = self.metrics.log(step, metrics, prefix=prefix)
        self.history.append(record)
        return record

    def _train_loop(self, train_iter, eval_iter, guard) -> nn.Module:
        args = self.args
        start_step = self.maybe_resume()
        t_start = time.time()
        t_limit = args.time_limit_seconds()
        last_log = time.time()
        step = start_step
        for step in range(start_step, args.max_steps):
            batch = next(train_iter)
            metrics = self.train_step(batch, step)
            if (step + 1) % args.logging_steps == 0:
                # one transfer for every scalar; it waits for the step
                values = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(self.device)
                                      for v in metrics.values()]).tolist()
                metrics = dict(zip(metrics, values))
                dt = time.time() - last_log
                last_log = time.time()
                metrics["steps_per_sec"] = args.logging_steps / dt
                self._log(step + 1, metrics, "train/")
                logger.info("step %d loss %.4f (%.2f steps/s)", step + 1, metrics["loss"],
                            metrics["steps_per_sec"])
            if self.eval_fn and eval_iter and (step + 1) % args.eval_steps == 0:
                self._log(step + 1, self.evaluate(eval_iter), "eval/")
                last_log = time.time()
            if (step + 1) % args.save_steps == 0:
                self.save(step + 1)
            preempted, timed_out = guard.triggered, (t_limit is not None
                                                     and time.time() - t_start > t_limit)
            if self.mesh.distributed:  # every rank stops at the same step
                preempted, timed_out = any_rank(preempted, timed_out)
            if preempted:
                logger.warning("preemption signal: checkpointing at step %d and stopping "
                               "(resume picks this up)", step + 1)
                self.save(step + 1)
                break
            if timed_out:
                logger.info("time limit reached at step %d; saving and stopping", step + 1)
                self.save(step + 1)
                break
        else:
            step = args.max_steps - 1
        self.save(step + 1)
        return self.model

    @torch.no_grad()
    def evaluate(self, eval_iter: Iterable) -> dict[str, float]:
        """The mean of ``eval_fn`` over the batches; with several ranks each
        takes its rows of every batch and the mean is global
        (``global_mean_metrics``), the same on every rank."""
        totals: dict[str, float] = {}
        n = 0
        for batch in eval_iter:
            if self.mesh.distributed:
                batch = self.mesh.local_rows(batch)
            with self.mesh:
                out = self.eval_fn(self._to_device(batch))
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        if self.mesh.distributed:
            return global_mean_metrics(totals, n)
        return {k: v / max(n, 1) for k, v in totals.items()}


class SilentMetricLogger:
    """What a rank other than 0 logs: the record ``MetricLogger.log``
    returns, written nowhere."""

    trackers: list = []

    def log(self, step: int, metrics: Mapping, prefix: str = "") -> dict:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                record[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        return record

    def log_audio(self, *args) -> None:
        pass
