"""HiFi-GAN's discriminators and GAN losses, for fine-tuning the vocoder.

Counterpart of the JAX package's
``silent_speech_tpu/models/hifigan_discriminators.py`` (arXiv:2010.05646):

- **MPD** (multi-period): per period p, the waveform reflect-padded to a
  multiple of p and viewed as (T/p, p), then strided (5, 1) 2-D convs over
  the time axis;
- **MSD** (multi-scale): on the waveform and its ×2 and ×4 average-pooled
  versions, a stack of large grouped 1-D convs.

Each sub-discriminator returns its score, flattened, and its feature maps
(after each lrelu and after ``conv_post``) for the feature-matching loss.
As in JAX there is no weight or spectral norm. ``width_div`` > 1 shrinks the
channels (tests only). Parameter names are the Flax module names
(``mpd_{p}.conv{i}``, ``msd_{i}.conv{i}``, ``….conv_post``), so
``models.convert.discriminator_params_to_torch`` maps a JAX tree.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.mel import reflect_pad

LRELU_SLOPE = 0.1

# (channels, kernel, stride, groups) of the scale discriminator's convs
MSD_LAYERS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
              (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
              (1024, 5, 1, 1))

Scores = List[torch.Tensor]
FeatureMaps = List[List[torch.Tensor]]


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, width_div: int = 1):
        super().__init__()
        self.period = period
        chans = [max(c // width_div, 1) for c in (32, 128, 512, 1024)]
        cin = 1
        for i, ch in enumerate(chans):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, (5, 1), (3, 1),
                                                padding=(2, 0)))
            cin = ch
        self.conv4 = nn.Conv2d(cin, max(1024 // width_div, 1), (5, 1),
                               padding=(2, 0))
        self.conv_post = nn.Conv2d(max(1024 // width_div, 1), 1, (3, 1),
                                   padding=(1, 0))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, T) → (score (B, T'), feature maps)."""
        b, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = reflect_pad(x, 0, pad) if t > 1 else F.pad(x, (0, pad))
        x = x.reshape(b, 1, (t + pad) // self.period, self.period)
        fmaps = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


class ScaleDiscriminator(nn.Module):
    def __init__(self, width_div: int = 1):
        super().__init__()
        cin = 1
        for i, (ch, k, s, g) in enumerate(MSD_LAYERS):
            ch = max(ch // width_div, g)   # divisible by the group count
            setattr(self, f"conv{i}", nn.Conv1d(cin, ch, k, s,
                                                padding=k // 2, groups=g))
            cin = ch
        self.conv_post = nn.Conv1d(cin, 1, 3, padding=1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, T) → (score (B, T'), feature maps)."""
        h = x[:, None]
        fmaps = []
        for i in range(len(MSD_LAYERS)):
            h = F.leaky_relu(getattr(self, f"conv{i}")(h), LRELU_SLOPE)
            fmaps.append(h)
        h = self.conv_post(h)
        fmaps.append(h)
        return h.reshape(x.shape[0], -1), fmaps


class HiFiGANDiscriminators(nn.Module):
    """MPD over ``periods`` + MSD over ``n_scales`` scales (the published
    V1: periods 2, 3, 5, 7, 11 and 3 scales)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 n_scales: int = 3, width_div: int = 1):
        super().__init__()
        self.periods, self.n_scales = tuple(periods), n_scales
        for p in self.periods:
            self.add_module(f"mpd_{p}", PeriodDiscriminator(p, width_div))
        for i in range(n_scales):
            self.add_module(f"msd_{i}", ScaleDiscriminator(width_div))

    def init_weights(self, generator: torch.Generator
                     ) -> "HiFiGANDiscriminators":
        """Kernels from N(0, 1/fan_in) (Flax's LeCun normal, untruncated),
        zero biases; drawn on the CPU from ``generator``."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight"):
                    fan_in = math.prod(p.shape[1:])
                    p.copy_(torch.randn(p.shape, generator=generator)
                            / math.sqrt(fan_in))
                else:
                    p.zero_()
        return self

    def forward(self, audio: torch.Tensor) -> Tuple[Scores, FeatureMaps]:
        """audio (B, T) → (scores, feature-map lists), MPD first."""
        scores, fmaps = [], []
        for p in self.periods:
            s, f = getattr(self, f"mpd_{p}")(audio)
            scores.append(s)
            fmaps.append(f)
        x = audio
        for i in range(self.n_scales):
            if i:
                # Flax's avg_pool counts the zero padding in the mean
                x = F.avg_pool1d(x[:, None], 4, 2, padding=2,
                                 count_include_pad=True)[:, 0]
            s, f = getattr(self, f"msd_{i}")(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


def discriminator_loss(real_scores: Scores, fake_scores: Scores
                       ) -> torch.Tensor:
    """LSGAN: Σ mean((1 − D(y))²) + mean(D(ŷ)²) over sub-discriminators."""
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2)
               for r, f in zip(real_scores, fake_scores))


def generator_adversarial_loss(fake_scores: Scores) -> torch.Tensor:
    """LSGAN, the generator's side: Σ mean((1 − D(ŷ))²)."""
    return sum(torch.mean((1.0 - f) ** 2) for f in fake_scores)


def feature_matching_loss(real_fmaps: FeatureMaps, fake_fmaps: FeatureMaps
                          ) -> torch.Tensor:
    """Σ mean |real − fake| over matched feature maps."""
    return sum(torch.mean(torch.abs(r - f))
               for rf, ff in zip(real_fmaps, fake_fmaps)
               for r, f in zip(rf, ff))
