"""Stationary-noise spectral gating (host side, numpy).

Own copy of the JAX package's ``silent_speech_tpu/dsp/denoise.py``, which
stands in for the reference's ``noisereduce`` stationary mode against a
silence profile clip (``data_collection/clean_audio.py:53``): per-frequency
noise statistics from the profile, a smoothed soft mask over the signal's
STFT, below-threshold bins attenuated, and overlap-add back to a waveform.
"""

from __future__ import annotations

import numpy as np

from .mel import hann_window


def _stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    window = hann_window(n_fft).astype(np.float64)
    return np.fft.rfft(x[idx] * window[None, :], axis=1)  # (T, F)


def _istft(spec: np.ndarray, n_fft: int, hop: int, length: int
           ) -> np.ndarray:
    window = hann_window(n_fft).astype(np.float64)
    frames = np.fft.irfft(spec, n=n_fft, axis=1) * window[None, :]
    out = np.zeros(hop * (spec.shape[0] - 1) + n_fft)
    wsum = np.zeros_like(out)
    for t in range(spec.shape[0]):
        out[t * hop: t * hop + n_fft] += frames[t]
        wsum[t * hop: t * hop + n_fft] += window ** 2
    out = out / np.maximum(wsum, 1e-8)
    pad = n_fft // 2
    return out[pad: pad + length]


def spectral_gate(audio: np.ndarray, noise_clip: np.ndarray,
                  sample_rate: int = 16000, n_fft: int = 1024,
                  hop: int = 256, n_std_thresh: float = 1.5,
                  prop_decrease: float = 1.0,
                  freq_smooth_bins: int = 4,
                  time_smooth_frames: int = 4) -> np.ndarray:
    """Suppress stationary noise in ``audio`` given a noise-only clip
    (float64 out, the length of ``audio``). ``sample_rate`` is accepted
    for the JAX signature and not used."""
    audio = np.asarray(audio, dtype=np.float64)
    noise = np.asarray(noise_clip, dtype=np.float64)
    if len(noise) < n_fft * 2:
        noise = np.pad(noise, (0, n_fft * 2 - len(noise)), mode="wrap") \
            if len(noise) else np.zeros(n_fft * 2)

    noise_spec = np.abs(_stft(noise, n_fft, hop))
    noise_db = 20 * np.log10(noise_spec + 1e-12)
    thresh_db = noise_db.mean(axis=0) + n_std_thresh * noise_db.std(axis=0)

    spec = _stft(audio, n_fft, hop)
    sig_db = 20 * np.log10(np.abs(spec) + 1e-12)

    mask = (sig_db > thresh_db[None, :]).astype(np.float64)
    # smooth the binary gate over time and frequency for fewer artifacts
    if freq_smooth_bins > 1:
        k = np.ones(freq_smooth_bins) / freq_smooth_bins
        mask = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, mask)
    if time_smooth_frames > 1:
        k = np.ones(time_smooth_frames) / time_smooth_frames
        mask = np.apply_along_axis(
            lambda c: np.convolve(c, k, mode="same"), 0, mask)

    gain = 1.0 - prop_decrease * (1.0 - mask)
    return _istft(spec * gain, n_fft, hop, len(audio))
