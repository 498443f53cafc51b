"""The 112 EMG frame features (numpy, host side).

Own copy of the numpy half of the JAX package's
``silent_speech_tpu/dsp/emg_features.py`` (reference
``data_utils.py:85-136``). For each of 8 channels the mean-centred signal
x splits into a low-frequency envelope ``w = double_average(x)`` and a
residual ``p = x − w`` with ``r = |p|``; frames of 16 samples at hop 6
give five scalars (the mean and RMS of w, the RMS of r, p's zero-crossing
rate, the mean of r) and the 9 bins of x's |STFT| (n_fft 16): 14 features
× 8 channels, about 86 frames a second.
"""

from __future__ import annotations

import numpy as np

from .mel import hann_window

FRAME_LENGTH = 16
HOP_LENGTH = 6
FEATS_PER_CHANNEL = 14  # 5 scalars + 9 STFT bins


def double_average(x: np.ndarray) -> np.ndarray:
    """Two passes of a centred 9-tap moving average ('same' mode) over
    (time,) or each channel of (time, channels)."""
    f = np.ones(9) / 9.0
    if x.ndim == 1:
        return np.convolve(np.convolve(x, f, mode="same"), f, mode="same")
    return np.stack([double_average(x[:, i]) for i in range(x.shape[1])],
                    axis=1)


def frame_signal(x: np.ndarray, frame_length: int = FRAME_LENGTH,
                 hop_length: int = HOP_LENGTH) -> np.ndarray:
    """(n_frames, frame_length) frames of a 1-D signal, librosa's order."""
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    return x[idx]


def _rms(frames: np.ndarray) -> np.ndarray:
    return np.sqrt(np.mean(frames ** 2, axis=1))


def _zero_crossing_rate(p: np.ndarray, threshold: float = 1e-10
                        ) -> np.ndarray:
    """librosa's ``zero_crossing_rate`` with ``center=False``: values with
    |p| <= threshold count as zero, a crossing is a sign-bit change between
    neighbours, and the first sample copies the second's."""
    frames = frame_signal(p)
    sb = np.signbit(np.where(np.abs(frames) <= threshold, 0.0, frames))
    crossings = np.diff(sb, axis=1) != 0
    crossings = np.concatenate([crossings[:, :1], crossings], axis=1)
    return np.mean(crossings, axis=1)


def get_emg_features(emg_data: np.ndarray) -> np.ndarray:
    """(time, channels) cleaned EMG → (n_frames, 14·channels) float32, per
    channel [w_h, p_w, p_r, z_p, r_h] then the 9 STFT bins."""
    xs = emg_data - emg_data.mean(axis=0, keepdims=True)
    window = hann_window(FRAME_LENGTH).astype(np.float64)
    outs = []
    for i in range(emg_data.shape[1]):
        x = xs[:, i]
        w = double_average(x)
        p = x - w
        r = np.abs(p)
        fw, fr = frame_signal(w), frame_signal(r)
        scalars = np.stack([fw.mean(axis=1), _rms(fw), _rms(fr),
                            _zero_crossing_rate(p), fr.mean(axis=1)],
                           axis=1)
        frames = frame_signal(x) * window[None, :]
        outs.append(scalars)
        outs.append(np.abs(np.fft.rfft(frames, n=FRAME_LENGTH, axis=1)))
    return np.concatenate(outs, axis=1).astype(np.float32)
