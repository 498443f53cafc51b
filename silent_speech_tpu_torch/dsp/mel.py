"""HiFi-GAN log-mel spectrogram: numpy on the host, torch on a device.

Own copy of the JAX package's ``silent_speech_tpu/dsp/mel.py`` (reference
``data_utils.py:29-83``):
reflect-pad by ``(n_fft − hop)/2``, an STFT with a periodic Hann window and
``center=False``, magnitude ``sqrt(re² + im² + 1e-9)``, a Slaney-normalized
mel filterbank (librosa's ``htk=False, norm='slaney'``), then
``log(clamp(x, 1e-5))``. HiFi-GAN's checkpoints were trained on exactly
these numbers.

``torch_log_mel_spectrogram`` is the counterpart of
``jax_log_mel_spectrogram``: batched, differentiable (the vocoder's mel
loss), and with the DFT as two matrix products as in JAX, whose numerics it
follows.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MelConfig:
    """The HiFi-GAN universal config (``data_utils.py:79``)."""

    n_fft: int = 1024
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float = 8000.0


# Slaney mel scale: linear below 1 kHz, logarithmic above
_F_SP = 200.0 / 3          # linear region: Hz per mel
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ)
        / _LOGSTEP,
        f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(
        m >= _MIN_LOG_MEL,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL)
                                         - _MIN_LOG_MEL)),
        m * _F_SP)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
                   ) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank, Slaney-normalized."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann (``torch.hann_window``'s default)."""
    n = np.arange(win_size)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_size))).astype(
        np.float32)


def stft_magnitude(audio: np.ndarray, n_fft: int, hop_size: int,
                   win_size: int, window: np.ndarray,
                   center: bool = False) -> np.ndarray:
    """|STFT| with the reference's floor, sqrt(power + 1e-9), as
    (1 + n_fft//2, n_frames); frame t covers samples
    [t·hop, t·hop + n_fft) when ``center=False``."""
    if center:
        pad = n_fft // 2
        audio = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(audio) - n_fft) // hop_size
    idx = (np.arange(n_fft)[None, :]
           + hop_size * np.arange(n_frames)[:, None])
    spec = np.fft.rfft(audio[idx] * window[None, :], n=n_fft, axis=1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.T.astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, cfg: MelConfig = MelConfig()
                        ) -> np.ndarray:
    """(T, num_mels) log-mel in the HiFi-GAN convention; a hop-multiple
    input of n samples gives n // hop frames."""
    audio = np.asarray(audio, dtype=np.float64)
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    audio = np.pad(audio, (pad, pad), mode="reflect")
    window = hann_window(cfg.win_size).astype(np.float64)
    mag = stft_magnitude(audio, cfg.n_fft, cfg.hop_size, cfg.win_size,
                         window, center=False)
    basis = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels,
                           cfg.fmin, cfg.fmax)
    return np.log(np.clip(basis @ mag, 1e-5, None)).T.astype(np.float32)


# ---------------------------------------------------------------------------
# torch, on any device
# ---------------------------------------------------------------------------

def _dft_matrices(n_fft: int):
    """Real and imaginary rDFT bases, (n_fft, 1 + n_fft//2) float32."""
    k = np.arange(1 + n_fft // 2)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return (np.cos(ang).astype(np.float32),
            -np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _mel_constants(cfg: MelConfig, device: torch.device):
    """The window, the two DFT bases and the transposed mel basis of
    ``cfg`` on ``device``, made once."""
    cos_m, sin_m = _dft_matrices(cfg.n_fft)
    basis = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels,
                           cfg.fmin, cfg.fmax)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (hann_window(cfg.win_size), cos_m, sin_m, basis.T))


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """numpy's ``reflect`` padding of the last axis, for any widths (a pad
    longer than the signal reflects again). Built from a flip and copies,
    so that its backward sums in a fixed order: ``F.pad``'s reflect
    backward adds with atomics on the card."""
    t = x.shape[-1]
    if t < 2:
        raise ValueError("reflect padding needs at least 2 samples")
    period = 2 * (t - 1)   # one period of the reflected signal
    ext = torch.cat([x, x.flip(-1)[..., 1:-1]], dim=-1)
    start = (-left) % period
    n = left + t + right
    reps = -(-(start + n) // period)
    if reps > 1:
        ext = torch.cat([ext] * reps, dim=-1)
    return ext[..., start: start + n]


def torch_log_mel_spectrogram(audio: torch.Tensor,
                              cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """audio (B, T) → (B, F, num_mels) log-mel on ``audio``'s device, in
    the steps of ``jax_log_mel_spectrogram``: reflect-pad by
    ``(n_fft − hop)/2``, frames of ``n_fft`` every ``hop`` samples times the
    Hann window, the DFT as two products, ``sqrt(re² + im² + 1e-9)``, the
    mel basis, ``log(clamp(·, 1e-5))``. Differentiable."""
    window, cos_m, sin_m, basis_t = _mel_constants(cfg, audio.device)
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    frames = reflect_pad(audio, pad, pad).unfold(-1, cfg.n_fft,
                                                 cfg.hop_size) * window
    re = frames @ cos_m
    im = frames @ sin_m
    mag = torch.sqrt(re * re + im * im + 1e-9)
    return torch.log(torch.clamp(mag @ basis_t, min=1e-5))
