"""The host loop of codec GAN training (port of
edm_tts_tpu/train/gan_trainer.py).

Per batch one G+D update (``gan.gan_train_step``) with two AdamW optimizers
(betas (0.8, 0.99), weight decay 0.01 on every parameter) on per-step
exponential schedules (gamma 0.999996); every ``eval_steps`` the mel loss of
the held-out reconstructions, the last eval batch's first
``num_samples_to_log`` reconstructions and originals written as WAVs (and
sent to the trackers), and, when the mel loss is the best so far, the
generator exported in the reference format (``best_model``: config.json +
model.safetensors with its trained weight-norm pairs, what
``utils.hub.load_codec`` reads); full-state checkpoints (both models'
parameters, both optimizers, the step and the best loss) every
``save_steps`` and at the end, the newest ``save_total_limit`` kept;
automatic resume from the newest; a wall-clock limit; a checkpoint on
SIGTERM.

Randomness: each step's quantizer-dropout draw comes from a generator
seeded with ``(seed, step)``, as the JAX loop folds the step into its key,
so a resumed run draws what an unbroken one would. Each logged record also
carries ``time/<phase>``: the seconds of each part of the last step
(``gan.PHASES``), from CUDA events on the card.

Several devices (one process each, ``torchrun``): the global batch is split
over the mesh's data x fsdp ranks (``parallel.mesh``, by default every rank
on data), the quantizer-dropout thresholds are drawn for the global batch
and sliced, and both optimizers average the gradients over the ranks
before each of the two updates (``AdamW``; with fsdp the moments sharded,
ZeRO-2). Logged train metrics and eval are global means;
rank 0 alone writes logs, samples, checkpoints (whole tensors: they load on
any number of ranks) and the best model.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from edm_tts_tpu_torch.data.audio_io import save_wav
from edm_tts_tpu_torch.models.codec.losses import ReconstructionLoss
from edm_tts_tpu_torch.parallel.dist import any_rank, barrier, global_mean_metrics
from edm_tts_tpu_torch.parallel.mesh import BATCH, all_reduce, make_mesh
from edm_tts_tpu_torch.train.checkpoint import CheckpointManager, detect_last_checkpoint
from edm_tts_tpu_torch.train.gan import gan_eval_step, gan_train_step
from edm_tts_tpu_torch.train.optim import AdamW, exponential_schedule
from edm_tts_tpu_torch.train.preemption import PreemptionGuard
from edm_tts_tpu_torch.train.trainer import SilentMetricLogger, fold_in
from edm_tts_tpu_torch.utils import hub
from edm_tts_tpu_torch.utils.logging import MetricLogger, logger
from edm_tts_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class GANTrainingArguments:
    output_dir: str
    seed: int = 42
    max_steps: int = 100_000
    logging_steps: int = 100
    eval_steps: int = 1000
    save_steps: int = 10_000
    save_total_limit: int = 2
    gen_lr: float = 1e-4
    disc_lr: float = 1e-4
    gen_betas: tuple[float, float] = (0.8, 0.99)
    disc_betas: tuple[float, float] = (0.8, 0.99)
    scheduler_gamma: float = 0.999996
    time_limit: str | None = None  # "hh:mm" wall clock
    overwrite_output_dir: bool = False
    num_samples_to_log: int = 4
    trackers: tuple[str, ...] = ()
    # fence both updates on finite gradient norms (off for recipe parity)
    skip_nonfinite_updates: bool = False
    # per-tensor grad/param norms ("gradients" | "parameters" | "all")
    watch: str | None = None


class PhaseClock:
    """The ends of a step's phases: CUDA events on the card (read back when
    the loop logs, so nothing waits for them), host time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self) -> None:
        self.marks = [("start", self._now())]

    def __call__(self, phase: str) -> None:
        self.marks.append((phase, self._now()))

    def seconds(self) -> dict[str, float]:
        """``{"time/<phase>": seconds}`` of the last step."""
        out = {}
        for (_, a), (phase, b) in zip(self.marks, self.marks[1:]):
            out[f"time/{phase}"] = a.elapsed_time(b) / 1e3 if self.cuda else b - a
        return out


class GANTrainer:
    """Trains ``codec`` (the generator) and ``disc`` on batches ``(B, T, 1)``
    of f32 audio, both on ``device``."""

    def __init__(self, args: GANTrainingArguments, codec: nn.Module, disc: nn.Module,
                 recon_loss: ReconstructionLoss, lambdas: Mapping[str, float] | None = None,
                 *, device="cuda", mesh=None):
        self.args = args
        self.codec, self.disc = codec, disc
        self.recon_loss = recon_loss
        self.lambdas = dict(lambdas) if lambdas else None
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.g_opt = AdamW(codec.named_parameters(),
                           exponential_schedule(args.gen_lr, args.scheduler_gamma),
                           b1=args.gen_betas[0], b2=args.gen_betas[1], weight_decay=0.01,
                           mesh=self.mesh)
        self.d_opt = AdamW(disc.named_parameters(),
                           exponential_schedule(args.disc_lr, args.scheduler_gamma),
                           b1=args.disc_betas[0], b2=args.disc_betas[1], weight_decay=0.01,
                           mesh=self.mesh)
        # gan_train_step's ``watch`` reads the reduced gradients from ``.grad``
        self.g_opt.write_grads = self.d_opt.write_grads = bool(args.watch)
        # the overwrite guard runs before anything is written to output_dir
        detect_last_checkpoint(args.output_dir, args.overwrite_output_dir)
        if self.mesh.distributed:
            barrier()
        self.ckpt = CheckpointManager(args.output_dir, args.save_total_limit)
        self.metrics = (MetricLogger(args.output_dir, trackers=args.trackers)
                        if self.mesh.rank == 0 else SilentMetricLogger())
        self.best_val_loss = math.inf
        self.history: list[dict] = []  # every record logged, train and eval
        self.clock = PhaseClock(self.device)

    # -- checkpoints ---------------------------------------------------------
    def state(self) -> dict:
        return {"generator": self.codec.state_dict(), "discriminator": self.disc.state_dict(),
                "gen_optimizer": self.g_opt.state_dict(),
                "disc_optimizer": self.d_opt.state_dict()}

    def save(self, step: int) -> str | None:
        """Every rank gathers the state, rank 0 writes it, all meet at a barrier."""
        state = self.state()
        path = None
        if self.mesh.rank == 0:
            path = self.ckpt.save(step, state, {"step": step, "best_val_loss": self.best_val_loss})
        if self.mesh.distributed:
            barrier()
        return path

    def _restore(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None or self.args.overwrite_output_dir:
            return 0
        state, meta = self.ckpt.restore(latest, map_location=self.device)
        self.codec.load_state_dict(state["generator"])
        self.disc.load_state_dict(state["discriminator"])
        self.g_opt.load_state_dict(state["gen_optimizer"])
        self.d_opt.load_state_dict(state["disc_optimizer"])
        self.codec.pack()
        self.best_val_loss = meta.get("best_val_loss", math.inf)
        logger.info("resumed GAN training from step %s", meta.get("step", latest))
        return int(meta.get("step", latest))

    def export_best(self) -> None:
        if self.mesh.rank != 0:
            return
        hub.save_reference(os.path.join(self.args.output_dir, "best_model"), self.codec)

    # -- the loop ------------------------------------------------------------
    def _log(self, step: int, metrics: Mapping, prefix: str) -> dict:
        record = self.metrics.log(step, metrics, prefix=prefix)
        self.history.append(record)
        return record

    def train(self, train_iter: Iterator, eval_iter: Iterable | None = None):
        with PreemptionGuard() as guard:
            self.guard = guard
            return self._train_loop(train_iter, eval_iter, guard)

    def _train_loop(self, train_iter, eval_iter, guard):
        args = self.args
        start = self._restore()
        step = start
        t0 = time.time()
        t_limit = None
        if args.time_limit:
            hh, mm = args.time_limit.split(":")
            t_limit = int(hh) * 3600 + int(mm) * 60
        last_log = time.time()
        for step in range(start, args.max_steps):
            audio = torch.as_tensor(next(train_iter))
            gen = torch.Generator(device=self.device).manual_seed(fold_in(args.seed, step))
            thresholds = None
            if self.mesh.distributed:
                if self.codec.quantizer.quantizer_dropout > 0.0:  # drawn for the global batch
                    thresholds = self.codec.quantizer.active_level_thresholds(
                        audio.shape[0], train=True, generator=gen, device=self.device)
                    thresholds = self.mesh.local_rows({"t": thresholds})["t"]
                audio = self.mesh.local_rows({"a": audio})["a"]
            audio = audio.to(self.device)
            self.clock.start()
            with span("gan.step"):
                metrics = gan_train_step(
                    self.codec, self.disc, self.recon_loss, self.g_opt, self.d_opt, audio,
                    generator=gen, thresholds=thresholds, lambdas=self.lambdas,
                    skip_nonfinite=args.skip_nonfinite_updates, watch=args.watch,
                    clock=self.clock)
            if (step + 1) % args.logging_steps == 0:
                # one transfer for every scalar; it waits for the step
                values = torch.stack(list(metrics.values()))
                if self.mesh.distributed:  # the mean over the ranks' equal parts of the batch
                    values = all_reduce(values, self.mesh.group(BATCH)) / self.mesh.size(BATCH)
                m = dict(zip(metrics, values.tolist()))
                dt = time.time() - last_log
                last_log = time.time()
                m["steps_per_sec"] = args.logging_steps / dt
                m.update(self.clock.seconds())
                self._log(step + 1, m, "train/")
                logger.info("step %d G %.4f D %.4f", step + 1, m.get("loss", 0.0),
                            m.get("adv/disc_loss", 0.0))
            if eval_iter is not None and (step + 1) % args.eval_steps == 0:
                val = self.evaluate(eval_iter, log_audio_step=step + 1)
                self._log(step + 1, val, "eval/")
                if val["mel_loss"] < self.best_val_loss:
                    self.best_val_loss = val["mel_loss"]
                    self.export_best()
            if (step + 1) % args.save_steps == 0:
                self.save(step + 1)
            preempted, timed_out = any_rank(
                guard.triggered, t_limit is not None and time.time() - t0 > t_limit)
            if preempted:
                logger.warning("preemption signal; saving at step %d", step + 1)
                break
            if timed_out:
                logger.info("time limit; saving at step %d", step + 1)
                break
        self.save(min(step + 1, args.max_steps))
        return self.codec, self.disc

    def evaluate(self, eval_iter: Iterable, log_audio_step: int | None = None) -> dict:
        """The mean mel loss over ``eval_iter`` (a zero-argument factory gives
        a fresh pass per eval; a bare generator would be used up by the
        first); with several ranks each takes its rows of every batch and
        the mean is global (``global_mean_metrics``), the same on every
        rank."""
        if callable(eval_iter):
            eval_iter = eval_iter()
        losses = []
        last = None
        for audio in eval_iter:
            if self.mesh.distributed:
                audio = self.mesh.local_rows({"a": audio})["a"]
            audio = torch.as_tensor(audio).to(self.device)
            mel, recon = gan_eval_step(self.codec, self.recon_loss, audio)
            losses.append(float(mel))
            last = audio, recon
        if log_audio_step is not None and last is not None and self.mesh.rank == 0:
            self._log_audio_samples(log_audio_step, *last)
        if not any_rank(bool(losses))[0]:
            return {"mel_loss": float("nan")}
        return global_mean_metrics({"mel_loss": float(np.sum(losses))}, len(losses))

    def _log_audio_samples(self, step: int, real: torch.Tensor, recon: torch.Tensor) -> None:
        """The last eval batch's first reconstructions and originals as WAVs
        under ``samples/step_<step>``, and the reconstructions to the
        trackers."""
        out_dir = os.path.join(self.args.output_dir, "samples", f"step_{step}")
        os.makedirs(out_dir, exist_ok=True)
        recon_np = recon.float().cpu().numpy()
        real_np = real.float().cpu().numpy()
        sr = self.codec.config.sample_rate
        for i in range(min(self.args.num_samples_to_log, recon_np.shape[0])):
            save_wav(os.path.join(out_dir, f"recon_{i}.wav"), recon_np[i, :, 0], sr)
            save_wav(os.path.join(out_dir, f"real_{i}.wav"), real_np[i, :, 0], sr)
            self.metrics.log_audio(step, f"recon_{i}", recon_np[i, :, 0], sr)

