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
trackers that receive every logged record (``utils/logging.py``), and each
step runs inside a ``step_annotation`` range, as the JAX loop's
``StepTraceAnnotation``, so a ``utils.profiling.trace`` names its steps.

Randomness: each step's generator is seeded from ``(seed, step)`` (and
each micro-batch's from that and its index), as the JAX loop folds the step
into its key, so a resumed run draws what an unbroken one would.

One device only: ``n_fsdp``, ``n_model`` and ``n_seq`` above 1 raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator, Mapping

import torch
from torch import nn

from edm_tts_tpu_torch.train.checkpoint import CheckpointManager, detect_last_checkpoint
from edm_tts_tpu_torch.train.optim import AdamW, warmup_cosine_schedule
from edm_tts_tpu_torch.train.preemption import PreemptionGuard
from edm_tts_tpu_torch.train.watch import watch_metrics
from edm_tts_tpu_torch.utils.logging import MetricLogger, logger
from edm_tts_tpu_torch.utils.profiling import step_annotation

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
                 eval_fn: Callable | None = None, device="cuda"):
        for name in ("n_fsdp", "n_model", "n_seq"):
            if getattr(args, name) > 1:
                raise NotImplementedError(f"{name}={getattr(args, name)}: the port trains "
                                          "on one device (multi-device is not ported)")
        if args.per_device_train_batch_size % max(1, args.micro_batches):
            raise ValueError("per_device_train_batch_size must be a multiple of micro_batches")
        self.args = args
        self.model = model
        self.device = torch.device(device)
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.optimizer = AdamW(
            model.named_parameters(),
            warmup_cosine_schedule(args.learning_rate, args.warmup_steps, args.max_steps),
            b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
            weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm)
        # the overwrite guard runs before anything is written to output_dir
        detect_last_checkpoint(args.output_dir, args.overwrite_output_dir)
        self.ckpt = CheckpointManager(args.output_dir, args.save_total_limit)
        self.metrics = MetricLogger(args.output_dir, trackers=args.trackers)
        self.history: list[dict] = []  # every record logged, train and eval
        self.last_save: dict | None = None

    # -- one optimizer step --------------------------------------------------
    def _to_device(self, batch: Mapping) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, batch: Mapping, step: int) -> dict[str, torch.Tensor]:
        """Gradient of ``batch`` (accumulated over micro-batches) and one
        update, whatever the caller's grad mode. Returns the step's metrics
        as device scalars."""
        params = self.optimizer.params
        for p in params:
            p.grad = None
        step_seed = fold_in(self.args.seed, step)
        n_micro = max(1, self.args.micro_batches)
        with torch.enable_grad():
            if n_micro == 1:
                loss, metrics = self.loss_fn(batch, self._generator(step_seed))
                metrics = dict(metrics)
                metrics.pop("loss_weight", None)
                loss.backward()
                metrics["loss"] = loss.detach()
            else:
                metrics = self._accumulate(batch, step_seed, n_micro)
        if self.args.watch:  # the gradient before clipping, the parameters before the update
            named = self.optimizer.named
            metrics.update(watch_metrics(
                self.args.watch, grads={n: p.grad for n, p in named if p.grad is not None},
                params=dict(named)))
        metrics.update(self.optimizer.step(skip_nonfinite=self.args.skip_nonfinite_updates))
        return metrics

    def _accumulate(self, batch: Mapping, step_seed: int, n_micro: int) -> dict:
        """p.grad = sum_i(w_i g_i) / sum_i(w_i) over the micro-batches; the
        metrics are weighted the same way."""
        chunks = {k: v.chunk(n_micro) for k, v in batch.items()}
        sums: dict[str, torch.Tensor] = {}
        w_sum = torch.zeros((), device=self.device)
        for i in range(n_micro):
            micro = {k: c[i] for k, c in chunks.items()}
            loss, metrics = self.loss_fn(micro, self._generator(fold_in(step_seed, i)))
            metrics = dict(metrics)
            w = torch.as_tensor(metrics.pop("loss_weight", 1.0),
                                dtype=torch.float32, device=self.device)
            # d(loss * w)/dp = w g: the weighted term, summed in p.grad
            (loss * w).backward()
            metrics["loss"] = loss.detach()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + w * v.detach().float()
            w_sum = w_sum + w
        for p in self.optimizer.params:
            if p.grad is not None:
                p.grad.div_(w_sum)
        return {k: v / w_sum for k, v in sums.items()}

    # -- checkpoints ---------------------------------------------------------
    def save(self, step: int) -> str | None:
        """Checkpoint the train state at ``step`` (once per step); the last
        save's path and seconds are kept in ``last_save``."""
        t0 = time.perf_counter()
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": step}
        path = self.ckpt.save(step, state, {"step": step})
        if path is not None:
            self.last_save = {"step": step, "path": path, "seconds": time.perf_counter() - t0}
            logger.info("saved %s in %.2f s", path, self.last_save["seconds"])
        return path

    def maybe_resume(self) -> int:
        """Restore the explicit ``resume_from_checkpoint`` or the latest
        checkpoint of ``output_dir`` (unless overwriting); returns the step."""
        args = self.args
        if args.resume_from_checkpoint:
            mgr = CheckpointManager(args.resume_from_checkpoint, None)
        elif not args.overwrite_output_dir and self.ckpt.latest_step() is not None:
            mgr = self.ckpt
        else:
            return 0
        state, meta = mgr.restore(map_location=self.device)
        self.model.load_state_dict(state["model"])
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
            batch = self._to_device(next(train_iter))
            with step_annotation("train", step):
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
            if guard.triggered:
                logger.warning("preemption signal: checkpointing at step %d and stopping "
                               "(resume picks this up)", step + 1)
                self.save(step + 1)
                break
            if t_limit is not None and time.time() - t_start > t_limit:
                logger.info("time limit reached at step %d; saving and stopping", step + 1)
                self.save(step + 1)
                break
        else:
            step = args.max_steps - 1
        self.save(step + 1)
        return self.model

    @torch.no_grad()
    def evaluate(self, eval_iter: Iterable) -> dict[str, float]:
        totals: dict[str, float] = {}
        n = 0
        for batch in eval_iter:
            for k, v in self.eval_fn(self._to_device(batch)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in totals.items()}
