"""One G+D update of codec GAN training (port of edm_tts_tpu/train/gan.py).

The reference's per-batch sequence: the generator's forward (once; quantizer
dropout drawn once, so the discriminator step and the generator step see the
same fake), the discriminator's LSGAN loss on the detached fake and the real
audio, its backward and update; then the reconstruction, adversarial and
feature-matching losses against the *updated* discriminator, weighted by the
YAML lambdas (mel 15, feat 2, gen 1, commit 0.25, codebook 1), the
generator's backward and update. The generator's gradient is taken for its
own parameters only: the discriminator's weights get none from it.

``skip_nonfinite`` fences both updates on their gradient norms being finite
(the float state is kept while the step counts, and so the schedules,
advance; ``skipped_nonfinite`` in the metrics). ``watch`` adds per-tensor
norms of both models, keyed ``watch/gen/...`` and ``watch/disc/...``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.losses import (
    ReconstructionLoss,
    discriminator_loss,
    generator_adversarial_losses,
)
from edm_tts_tpu_torch.train.optim import AdamW
from edm_tts_tpu_torch.train.watch import watch_metrics

DEFAULT_LAMBDAS: Mapping[str, float] = {
    "mel/loss": 15.0,
    "adv/feat_loss": 2.0,
    "adv/gen_loss": 1.0,
    "vq/commitment_loss": 0.25,
    "vq/codebook_loss": 1.0,
}
# the parts of a step that ``clock`` is told the end of, in order
PHASES = ("g_forward", "d_step", "d_optim", "g_step", "g_optim")


def gan_train_step(codec: nn.Module, disc: nn.Module, recon_loss: ReconstructionLoss,
                   g_opt: AdamW, d_opt: AdamW, audio: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   thresholds: torch.Tensor | None = None,
                   lambdas: Mapping[str, float] | None = None, skip_nonfinite: bool = False,
                   watch: str | None = None,
                   clock: Callable[[str], None] | None = None) -> dict[str, torch.Tensor]:
    """One G+D update on ``audio`` ``(B, T, 1)``; the optimizers hold the
    models' parameters. Quantizer dropout is drawn from ``generator`` or
    given as ``thresholds``. ``clock(phase)`` is called at the end of each
    of ``PHASES``. Returns the metrics as device scalars."""
    lambdas = dict(lambdas or DEFAULT_LAMBDAS)
    tick = clock or (lambda phase: None)
    with torch.enable_grad():
        out = codec(audio, train=True, generator=generator, thresholds=thresholds)
        fake = out["audio"]
        tick("g_forward")

        # the discriminator step, on the detached fake
        for p in d_opt.params:
            p.grad = None
        d_loss = discriminator_loss(disc(fake.detach()), disc(audio))
        d_loss.backward()
        tick("d_step")
        d_out = d_opt.step(skip_nonfinite=skip_nonfinite)
        tick("d_optim")

        # the generator step, against the updated discriminator
        losses = dict(recon_loss(fake, audio))
        d_fake = disc(fake)
        with torch.no_grad():
            d_real = disc(audio)
        losses["adv/gen_loss"], losses["adv/feat_loss"] = generator_adversarial_losses(
            d_fake, d_real)
        losses["vq/commitment_loss"] = out["vq/commitment_loss"]
        losses["vq/codebook_loss"] = out["vq/codebook_loss"]
        total = sum(w * losses[k] for k, w in lambdas.items() if k in losses)
        losses["loss"] = total
        grads = torch.autograd.grad(total, g_opt.params, allow_unused=True)
        for p, g in zip(g_opt.params, grads):
            p.grad = g
        tick("g_step")
    g_out = g_opt.step(skip_nonfinite=skip_nonfinite)
    tick("g_optim")

    metrics = {k: torch.as_tensor(v).detach() for k, v in losses.items()}
    if skip_nonfinite:
        metrics["skipped_nonfinite"] = torch.maximum(d_out["skipped_nonfinite"],
                                                     g_out["skipped_nonfinite"])
    metrics["adv/disc_loss"] = d_loss.detach()
    if watch:
        for prefix, opt in (("gen/", g_opt), ("disc/", d_opt)):
            named = opt.named
            norms = watch_metrics(watch, grads={n: p.grad for n, p in named if p.grad is not None},
                                  params=dict(named))
            metrics.update({k.replace("watch/", "watch/" + prefix, 1): v for k, v in norms.items()})
    return metrics


@torch.no_grad()
def gan_eval_step(codec: nn.Module, recon_loss: ReconstructionLoss,
                  audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The mel loss of the reconstruction of ``audio`` (no dropout, every
    level) and the reconstruction."""
    recon = codec(audio)["audio"]
    return recon_loss(recon, audio)["mel/loss"], recon
