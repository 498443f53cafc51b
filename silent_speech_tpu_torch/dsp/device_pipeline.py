"""Utterance featurization on tensors, on any device.

Counterpart of the JAX package's ``silent_speech_tpu/dsp/jax_pipeline.py``
(reference host pipeline ``read_emg.py:52-88``): the zero-phase cleaning
chain (seven notches at the mains frequency and its harmonics, Q = 30,
then a 2 Hz 3rd-order Butterworth high-pass) through ``ops/filtfilt.py``,
linear-interpolation resampling to the raw and feature rates, the 112 EMG
frame features, and the HiFi-GAN log-mel target. Filter design stays on
the host (scipy, once per rate); filtering runs on the tensor's device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.filtfilt import filtfilt_chain
from .emg_features import FRAME_LENGTH, HOP_LENGTH
from .filters import butter_highpass
from .mel import MelConfig, _dft_matrices, hann_window, \
    torch_log_mel_spectrogram

CAPTURE_RATE = 1000.0
RAW_RATE = 689.06
FEAT_RATE = 516.79


@functools.lru_cache(maxsize=None)
def filter_coeffs(fs: float = CAPTURE_RATE, mains_hz: float = 60.0):
    """The cleaning chain's (b, a) pairs, in order: notches at
    ``mains_hz`` × 1..7 (Q = 30), then the 2 Hz high-pass."""
    import scipy.signal

    coeffs = []
    for harmonic in range(1, 8):
        b, a = scipy.signal.iirnotch(mains_hz * harmonic, 30, fs)
        coeffs.append((tuple(b.tolist()), tuple(a.tolist())))
    b, a = butter_highpass(2.0, fs)
    coeffs.append((tuple(b.tolist()), tuple(a.tolist())))
    return tuple(coeffs)


def clean_emg(raw: torch.Tensor, lengths: Optional[torch.Tensor] = None,
              fs: float = CAPTURE_RATE, mains_hz: float = 60.0
              ) -> torch.Tensor:
    """The cleaning chain over (T, C), or over (B, T_pad, C) valid in rows
    [0, lengths[b]) (rows past come out as 0), float32. One kernel launch
    on the card."""
    coeffs = filter_coeffs(fs, mains_hz)
    if raw.dim() == 2:
        return filtfilt_chain(raw[None], torch.tensor([raw.shape[0]]),
                              coeffs)[0]
    return filtfilt_chain(raw, lengths, coeffs)


def subsample(signal: torch.Tensor, new_freq: float, old_freq: float
              ) -> torch.Tensor:
    """Linear-interpolation resample along axis 0 in float32, as
    ``jax_subsample`` computes it (``np.interp`` on a uniform grid)."""
    n = signal.shape[0]
    m = int(np.ceil((n - 1) / old_freq * new_freq - 1e-9))
    dev = signal.device
    sample_times = (torch.arange(m, device=dev, dtype=torch.float32)
                    / torch.tensor(new_freq, dtype=torch.float32,
                                   device=dev))
    pos = sample_times * torch.tensor(old_freq, dtype=torch.float32,
                                      device=dev)
    lo = pos.floor().to(torch.int64).clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    frac = (pos - lo.to(torch.float32))[:, None]
    return signal[lo] * (1 - frac) + signal[hi] * frac


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(C, T) → (C, n_frames, 16) frames at hop 6."""
    return x.unfold(-1, FRAME_LENGTH, HOP_LENGTH)


def get_emg_features(emg_data: torch.Tensor) -> torch.Tensor:
    """(T, C) cleaned EMG → (n_frames, 14·C) float32, the counterpart of
    ``jax_get_emg_features``: per channel the mean and RMS of the envelope
    w (two 9-tap moving averages), the RMS of r = |x − w|, the
    zero-crossing rate of x − w, the mean of r, then the 9 |DFT| bins of
    the Hann-windowed frame."""
    xs = (emg_data - emg_data.mean(0, keepdim=True)).T.contiguous()
    c = xs.shape[0]
    box = torch.full((1, 1, 9), 1.0 / 9.0, dtype=xs.dtype, device=xs.device)

    def average(v):         # 'same'-mode 9-tap moving average a channel
        return F.conv1d(v[:, None], box, padding=4)[:, 0]

    w = average(average(xs))
    p = xs - w
    r = p.abs()
    fw, fr, fp, fx = _frames(w), _frames(r), _frames(p), _frames(xs)
    clamped = torch.where(fp.abs() <= 1e-10, 0.0, fp)
    sb = torch.signbit(clamped)
    crossings = sb[..., 1:] != sb[..., :-1]
    crossings = torch.cat([crossings[..., :1], crossings], -1)
    scalars = torch.stack([
        fw.mean(-1), torch.sqrt((fw * fw).mean(-1)),
        torch.sqrt((fr * fr).mean(-1)),
        crossings.to(torch.float32).mean(-1), fr.mean(-1)], -1)
    cos_m, sin_m = (torch.from_numpy(m).to(xs.device)
                    for m in _dft_matrices(FRAME_LENGTH))
    windowed = fx * torch.from_numpy(hann_window(FRAME_LENGTH)).to(xs.device)
    re, im = windowed @ cos_m, windowed @ sin_m
    spec = torch.sqrt(re * re + im * im)
    feats = torch.cat([scalars, spec], -1)           # (C, n_frames, 14)
    return feats.permute(1, 0, 2).reshape(feats.shape[1], 14 * c)


def featurize_utterance(raw_emg: torch.Tensor,
                        audio: Optional[torch.Tensor] = None,
                        mel_cfg: MelConfig = MelConfig()
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """(T_capture, C) raw EMG [+ 22.05 kHz audio] → (raw model input
    (8T', C), EMG features (T', 14·C), log-mel (T_mel, 80) or None), the
    steps of ``featurize_utterance_jax``: the neighbour context and the
    cross-trimming of lengths are the dataset's business."""
    x = clean_emg(raw_emg.to(torch.float32))
    emg_orig = subsample(x, RAW_RATE, CAPTURE_RATE)
    feats = get_emg_features(subsample(x, FEAT_RATE, CAPTURE_RATE))
    t = feats.shape[0]
    mel = None
    if audio is not None:
        mel = torch_log_mel_spectrogram(audio.to(torch.float32)[None],
                                        mel_cfg)[0]
        t = min(t, mel.shape[0])
    return emg_orig[8: 8 + 8 * t], feats[:t], mel
