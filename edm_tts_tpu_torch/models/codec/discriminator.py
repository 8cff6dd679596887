"""The GAN discriminator ensemble of codec training (port of
edm_tts_tpu/models/codec/discriminator.py): MPD (period-folded 2D), MRD
(multi-band complex STFT 2D) and MSD (resampled 1D; off in the recipe).

torch's NCHW / NCT layouts, as the reference DAC's discriminators hold them,
with its module names (``discriminators.{i}`` ordered MPDs, MSDs, MRDs; a
conv with an activation sits behind ``Sequential(conv, LeakyReLU)`` as
``.0``), so the state dict is the one
edm_tts_tpu/models/codec/convert.py::discriminator_to_torch_state_dict
emits. Structure and padding arithmetic as in the JAX package:

- MPD x5 (periods 2, 3, 5, 7, 11): reflect-pad T to a period multiple (a
  full extra period when already aligned, as the reference), fold to
  (L/p, p), 2D convs k (5, 1) stride (3, 1);
- MRD x3 (n_fft 2048, 1024, 512): match-stride reflect padding, complex
  spectrogram trimmed by 2 frames each side, 5 frequency bands, per-band
  (3, 9) conv stacks with stride (1, 2) over frequency;
- MSD: the signal resampled to sr / rate, grouped 1D convs;
- input conditioning: DC removal and 0.8 peak normalization;
- every conv is weight-normed (trainable ``weight_v`` / ``weight_g``, as
  the codec's) and followed by LeakyReLU(0.1), except the posts.

Each discriminator returns its list of feature maps (the last one is the
logits map).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edm_tts_tpu_torch.models.codec.layers import WeightNormed
from edm_tts_tpu_torch.ops.resample import resample
from edm_tts_tpu_torch.ops.spectral import stft

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    sample_rate: int = 16000
    rates: Tuple[int, ...] = ()
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    fft_sizes: Tuple[int, ...] = (2048, 1024, 512)
    bands: Tuple[Tuple[float, float], ...] = BANDS

    @classmethod
    def from_dict(cls, d: dict) -> "DiscriminatorConfig":
        d = {k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}}
        for k in ("rates", "periods", "fft_sizes"):
            if k in d:
                d[k] = tuple(d[k])
        if "bands" in d:
            d["bands"] = tuple(tuple(b) for b in d["bands"])
        return cls(**d)


class WNConv2d(WeightNormed):
    """Weight-normed Conv2d, ``weight_v`` ``(C_out, C_in, kh, kw)``."""

    def __init__(self, cin: int, cout: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 *, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._weight_norm((cout, cin, *kernel_size), device, torch.float32)
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


class WNConv1dGroups(WeightNormed):
    """Weight-normed grouped Conv1d on ``(B, C, T)``, ``weight_v``
    ``(C_out, C_in/groups, K)`` (the MSD stack)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, *, device=None):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self._weight_norm((cout, cin // groups, kernel_size), device, torch.float32)
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight, self.bias, stride=self.stride, padding=self.padding,
                        groups=self.groups)


def _act(conv: nn.Module) -> nn.Sequential:
    return nn.Sequential(conv, nn.LeakyReLU(0.1))


class MPD(nn.Module):
    """Multi-period discriminator: audio folded by ``period``, 2D convs."""

    def __init__(self, period: int, *, device=None):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024, 1024)
        strides = ((3, 1),) * 4 + ((1, 1),)
        self.convs = nn.ModuleList(
            _act(WNConv2d(cin, cout, (5, 1), s, (2, 0), device=device))
            for cin, cout, s in zip(chans, chans[1:], strides))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0), device=device)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``(B, 1, T)`` -> feature maps ``(B, C, L, P)``."""
        b, _, t = x.shape
        x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
        x = x.reshape(b, 1, -1, self.period)
        fmap = []
        for layer in self.convs:
            x = layer(x)
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class MRD(nn.Module):
    """Multi-resolution complex-spectrogram discriminator, 5 frequency bands."""

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands=BANDS, *, device=None):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        n_fft = window_length // 2 + 1
        self.bands = [(int(lo * n_fft), int(hi * n_fft)) for lo, hi in bands]
        ch = 32
        specs = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
                 ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1)))
        self.band_convs = nn.ModuleList(
            nn.ModuleList(_act(WNConv2d(2 if i == 0 else ch, ch, k, s, p, device=device))
                          for i, (k, s, p) in enumerate(specs))
            for _ in self.bands)
        self.conv_post = WNConv2d(ch, 1, (3, 3), (1, 1), (1, 1), device=device)

    def spectrogram_bands(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``(B, 1, T)`` -> per band ``(B, 2, T', F_band)`` real/imag slices."""
        w, hop = self.window_length, self.hop
        length = x.shape[-1]
        # match-stride padding (the reference's pad_signal_for_stft)
        right_pad = math.ceil(length / hop) * hop - length
        x = F.pad(x, ((w - hop) // 2, right_pad), mode="reflect")
        spec = stft(x[:, 0], w, hop)[..., 2:-2]  # (B, F, T'), center=True
        ri = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)  # (B, 2, T', F)
        return [ri[..., lo:hi] for lo, hi in self.bands]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        fmap, outs = [], []
        for band, stack in zip(self.spectrogram_bands(x), self.band_convs):
            h = band
            for layer in stack:
                h = layer(h)
                fmap.append(h)
            outs.append(h)
        fmap.append(self.conv_post(torch.cat(outs, dim=-1)))  # bands joined over frequency
        return fmap


class MSD(nn.Module):
    """Multi-scale (resampled) 1D discriminator. Off in the recipe
    (``rates: []``) but provided as the JAX package provides it."""

    def __init__(self, rate: int = 1, sample_rate: int = 16000, *, device=None):
        super().__init__()
        self.rate, self.sample_rate = rate, sample_rate
        specs = ((1, 16, 15, 1, 7, 1), (16, 64, 41, 4, 20, 4), (64, 256, 41, 4, 20, 16),
                 (256, 1024, 41, 4, 20, 64), (1024, 1024, 41, 4, 20, 256),
                 (1024, 1024, 5, 1, 2, 1))
        self.convs = nn.ModuleList(
            _act(WNConv1dGroups(cin, cout, k, s, p, g, device=device))
            for cin, cout, k, s, p, g in specs)
        self.conv_post = WNConv1dGroups(1024, 1, 3, 1, 1, device=device)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``(B, 1, T)`` -> feature maps ``(B, C, T')``."""
        if self.rate > 1:
            x = resample(x, self.sample_rate, self.sample_rate // self.rate)
        fmap = []
        for layer in self.convs:
            x = layer(x)
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class Discriminator(nn.Module):
    """The ensemble (the reference's DACDiscriminator), f32."""

    def __init__(self, config: DiscriminatorConfig, *, device=None):
        super().__init__()
        self.config = config
        self.discriminators = nn.ModuleList(
            [MPD(p, device=device) for p in config.periods]
            + [MSD(r, config.sample_rate, device=device) for r in config.rates]
            + [MRD(f, bands=config.bands, device=device) for f in config.fft_sizes])

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        """``(B, T, 1)`` waveform -> one feature-map list per discriminator."""
        x = x.float().transpose(1, 2)  # (B, 1, T)
        x = x - x.mean(dim=-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)
        return [d(x) for d in self.discriminators]
