"""The HiFi-GAN generator (the vocoder): log-mel frames → waveform.

Counterpart of the JAX package's ``silent_speech_tpu/models/hifigan.py``
(reference ``vocoder.py:8-36``, arXiv:2010.05646): conv_pre, then per
upsampling stage [lrelu → transposed conv → the mean over the
multi-receptive-field resblocks], lrelu, conv_post, tanh. The modules are
channels-first ``(B, C, T)`` inside; ``Generator.forward`` takes the JAX
layout ``(B, T, num_mels)`` and returns ``(B, T·hop)``.

Parameter names are the official checkpoint's (``conv_pre``, ``ups.{i}``,
``resblocks.{r}.convs1.{d}``/``convs2.{d}`` or ``convs.{d}``,
``conv_post``, with ``r = i·len(resblock_kernel_sizes) + j``), so a released
``generator`` state dict loads with ``strict=True`` once its weight-norm
pairs are folded (``fold_weight_norm``). The convolutions are cuDNN's on
the card: in the JAX package they are ``lax`` convolutions under XLA, not
Pallas kernels.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    """The fields of the released ``config.json`` (V1 universal)."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))

    @staticmethod
    def from_json(path: str) -> "HiFiGANConfig":
        with open(path) as f:
            return HiFiGANConfig.from_dict(json.load(f))

    @staticmethod
    def from_dict(h: dict) -> "HiFiGANConfig":
        return HiFiGANConfig(
            resblock=str(h["resblock"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]),
            num_mels=h.get("num_mels", 80),
            sampling_rate=h.get("sampling_rate", 22050),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=1)


class ResBlock1(nn.Module):
    """Per dilation d: x + conv2(lrelu(conv1_d(lrelu(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size,
                      padding=(kernel_size - 1) // 2)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(h, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """Per dilation d: x + conv_d(lrelu(x))."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size * d - d) // 2)
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, k) in enumerate(zip(cfg.upsample_rates,
                                          cfg.upsample_kernel_sizes)):
            cout = ch // 2 ** (i + 1)
            # output length (T−1)·rate − 2p + k = T·rate: the JAX
            # conv_transpose's explicit (k−1−p, k−1−p) padding
            self.ups.append(nn.ConvTranspose1d(ch // 2 ** i, cout, k,
                                               stride=rate,
                                               padding=(k - rate) // 2))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(block(cout, rk, rd))
        self.conv_post = nn.Conv1d(ch // 2 ** len(cfg.upsample_rates), 1, 7,
                                   padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, num_mels) → waveform (B, T·hop) in [−1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        nk = len(self.cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(nk):
                h = self.resblocks[i * nk + j](x)
                acc = h if acc is None else acc + h
            x = acc / nk
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)[:, 0]


def init_generator(cfg: HiFiGANConfig, generator: torch.Generator
                   ) -> Generator:
    """A generator with every kernel drawn from N(0, 0.01²) (the official
    ``init_weights``) and zero biases, on the CPU, from ``generator``."""
    model = Generator(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.01)
            else:
                p.zero_()
    return model


def fold_weight_norm(state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``X.weight_g``/``X.weight_v`` pairs → ``X.weight = v·g/‖v‖``, the
    norm over every dim but 0 (torch's ``remove_weight_norm``); other
    entries pass through."""
    out = {}
    for key, val in state.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            v = val.float()
            g = state[base + ".weight_g"].float()
            norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)),
                                keepdim=True).sqrt()
            out[base + ".weight"] = v * (g / norm)
        else:
            out[key] = val
    return out


def weight_norm_state(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of ``fold_weight_norm``: every conv ``X.weight`` as the
    pair ``X.weight_g = ‖w‖`` (over every dim but 0), ``X.weight_v = w``,
    the layout of an official training checkpoint."""
    out = {}
    for key, val in state.items():
        if key.endswith(".weight") and val.ndim >= 2:
            base = key[: -len(".weight")]
            out[base + ".weight_g"] = val.pow(2).sum(
                dim=tuple(range(1, val.ndim)), keepdim=True).sqrt()
            out[base + ".weight_v"] = val.clone()
        else:
            out[key] = val
    return out


def load_generator_state(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's generator state dict, weight norm folded: the file
    holds ``{'generator': state}`` or the bare state."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["generator"] if "generator" in ckpt else ckpt
    return fold_weight_norm(state)


class Vocoder:
    """The reference's ``Vocoder`` wrapper (``vocoder.py:16-36``): loads a
    checkpoint and its sibling ``config.json`` (the V1 config when there is
    none) onto ``device`` (``cuda`` unless told otherwise) and maps a
    ``(T, num_mels)`` log-mel to a ``(T·hop,)`` waveform in float32. The
    JAX class caches the converted weights as an orbax tree so that JAX
    need not import torch; the port reads the torch checkpoint itself and
    writes no cache."""

    def __init__(self, checkpoint_path: str,
                 config_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        config_path = config_path or os.path.join(
            os.path.dirname(checkpoint_path), "config.json")
        self.cfg = (HiFiGANConfig.from_json(config_path)
                    if os.path.exists(config_path) else HiFiGANConfig())
        self.generator = Generator(self.cfg)
        self.generator.load_state_dict(load_generator_state(checkpoint_path),
                                       strict=True)
        self.generator.to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, mel: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(mel, np.float32)).to(self.device)
        return self.generator(x[None])[0].cpu().numpy()
