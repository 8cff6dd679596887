"""Codec training losses: multi-scale mel/STFT, waveform, SI-SDR, LSGAN
(port of edm_tts_tpu/models/codec/losses.py, on ``ops.spectral``).

- multi-scale mel loss: 7 scales (n_mels 5..320, windows 32..2048), log-L1
  with clamp eps 1e-5, mag_weight 0 (configs/dac/train_config.yaml). The
  mels are of the POWER spectrogram (torchaudio's MelSpectrogram default
  2.0, which the reference keeps); ``power`` is the exponent applied before
  log10 (1.0 in the recipe) and does not feed the spectrogram;
- multi-scale STFT loss (window list, log + magnitude L1);
- LSGAN: discriminator ``E[D(fake)^2] + E[(1 - D(real))^2]``, generator
  ``E[(1 - D(fake))^2]`` plus L1 feature matching over every feature map
  but the last, the real maps detached.

f32 throughout.
"""

from __future__ import annotations

from typing import Sequence

import torch

from edm_tts_tpu_torch.ops.spectral import mel_spectrogram, spectrogram


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def waveform_l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain L1 between waveforms (the reference's L1Loss)."""
    return l1(x, y)


def _squeeze(x: torch.Tensor) -> torch.Tensor:
    return x.squeeze(-1) if x.shape[-1] == 1 else x


def _log_l1(xm, ym, clamp_eps: float, power: float) -> torch.Tensor:
    return l1(torch.log10(xm.clamp(min=clamp_eps) ** power),
              torch.log10(ym.clamp(min=clamp_eps) ** power))


def multi_scale_stft_loss(x: torch.Tensor, y: torch.Tensor, *,
                          window_lengths: Sequence[int] = (2048, 512), clamp_eps: float = 1e-5,
                          mag_weight: float = 1.0, log_weight: float = 1.0,
                          power: float = 2.0) -> torch.Tensor:
    """Sum over scales of log-magnitude L1 + magnitude L1."""
    x, y = _squeeze(x), _squeeze(y)
    loss = 0.0
    for w in window_lengths:
        xm = spectrogram(x, w, w // 4, power=1.0)
        ym = spectrogram(y, w, w // 4, power=1.0)
        loss = loss + log_weight * _log_l1(xm, ym, clamp_eps, power)
        loss = loss + mag_weight * l1(xm, ym)
    return loss


def multi_scale_mel_loss(x: torch.Tensor, y: torch.Tensor, *, sample_rate: int,
                         n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
                         window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
                         mel_fmin: Sequence[float] = (0.0,) * 7,
                         mel_fmax: Sequence[float | None] = (None,) * 7,
                         clamp_eps: float = 1e-5, mag_weight: float = 0.0,
                         log_weight: float = 1.0, power: float = 1.0) -> torch.Tensor:
    """Multi-scale mel distance; the mels at power 2.0 whatever ``power``
    says (``power`` is the pre-log10 exponent)."""
    x, y = _squeeze(x), _squeeze(y)
    loss = 0.0
    for w, m, lo, hi in zip(window_lengths, n_mels, mel_fmin, mel_fmax):
        xm = mel_spectrogram(x, sample_rate, w, m, w // 4, fmin=lo, fmax=hi, power=2.0)
        ym = mel_spectrogram(y, sample_rate, w, m, w // 4, fmin=lo, fmax=hi, power=2.0)
        loss = loss + log_weight * _log_l1(xm, ym, clamp_eps, power)
        loss = loss + mag_weight * l1(xm, ym)
    return loss


def sisdr_loss(references: torch.Tensor, estimates: torch.Tensor, *, scaling: bool = True,
               zero_mean: bool = True, clip_min: float | None = None) -> torch.Tensor:
    """Negative scale-invariant SDR of ``(B, T, 1)`` signals."""
    eps = 1e-8
    r = references.reshape(references.shape[0], -1).float()
    e = estimates.reshape(estimates.shape[0], -1).float()
    if zero_mean:
        r = r - r.mean(-1, keepdim=True)
        e = e - e.mean(-1, keepdim=True)
    r_proj = (r * r).sum(-1) + eps
    r_on_e = (e * r).sum(-1) + eps
    scale = (r_on_e / r_proj)[:, None] if scaling else 1.0
    e_true = scale * r
    e_res = e - e_true
    sdr = -10.0 * torch.log10(e_true.square().sum(-1) / e_res.square().sum(-1) + eps)
    if clip_min is not None:
        sdr = sdr.clamp(min=clip_min)
    return sdr.mean()


class ReconstructionLoss:
    """The configured reconstruction terms: ``waveform/loss`` and
    ``stft/loss`` when their args are given, ``mel/loss`` always."""

    def __init__(self, sample_rate: int, waveform_args: dict | None = None,
                 multi_scale_stft_args: dict | None = None,
                 mel_spectrogram_args: dict | None = None):
        self.sample_rate = sample_rate
        self.waveform_args = waveform_args
        self.stft_args = multi_scale_stft_args
        self.mel_args = self._map_mel_args(mel_spectrogram_args or {})

    @staticmethod
    def _map_mel_args(args: dict) -> dict:
        args = dict(args)
        args.pop("weight", None)
        if "pow" in args:
            args["power"] = args.pop("pow")
        return args

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        if self.waveform_args is not None:
            out["waveform/loss"] = waveform_l1_loss(x, y)
        if self.stft_args is not None:
            stft_args = {k: v for k, v in self.stft_args.items() if k != "weight"}
            out["stft/loss"] = multi_scale_stft_loss(x, y, **stft_args)
        mel_args = {k: tuple(v) if isinstance(v, list) else v for k, v in self.mel_args.items()}
        out["mel/loss"] = multi_scale_mel_loss(x, y, sample_rate=self.sample_rate, **mel_args)
        return out


# -- GAN losses (over the discriminator ensemble's feature-map lists) --------

FMaps = Sequence[Sequence[torch.Tensor]]


def discriminator_loss(d_fake: FMaps, d_real: FMaps) -> torch.Tensor:
    """LSGAN discriminator objective over the last map of each discriminator."""
    loss = 0.0
    for f, r in zip(d_fake, d_real):
        loss = loss + f[-1].float().square().mean()
        loss = loss + (1.0 - r[-1].float()).square().mean()
    return loss


def generator_adversarial_losses(d_fake: FMaps,
                                 d_real: FMaps) -> tuple[torch.Tensor, torch.Tensor]:
    """(generator LSGAN loss, L1 feature matching over every map but the
    last, the real maps detached)."""
    loss_g = 0.0
    for f in d_fake:
        loss_g = loss_g + (1.0 - f[-1].float()).square().mean()
    loss_feat = 0.0
    for f_list, r_list in zip(d_fake, d_real):
        for f, r in zip(f_list[:-1], r_list[:-1]):
            loss_feat = loss_feat + l1(f.float(), r.detach().float())
    return loss_g, loss_feat
