"""Sample-rate conversion (numpy/scipy, host side).

Own copy of the JAX package's ``silent_speech_tpu/dsp/resample.py``:
``subsample`` is the reference's linear-interpolation resampling of EMG
(``read_emg.py:40-44``, ``np.interp`` over a uniform grid);
``resample_poly_audio`` is scipy's polyphase resampler, which the JAX
package puts in place of ``librosa.resample`` (``data_utils.py:75``).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import scipy.signal


def subsample(signal: np.ndarray, new_freq: float, old_freq: float
              ) -> np.ndarray:
    """Linear-interpolation resample along axis 0, each channel on the
    same sample times."""
    times = np.arange(signal.shape[0]) / old_freq
    sample_times = np.arange(0, times[-1], 1 / new_freq)
    if signal.ndim == 1:
        return np.interp(sample_times, times, signal)
    return np.stack([np.interp(sample_times, times, signal[:, i])
                     for i in range(signal.shape[1])], axis=1)


def resample_poly_audio(audio: np.ndarray, orig_sr: int, target_sr: int
                        ) -> np.ndarray:
    """Polyphase resample with scipy's Kaiser-windowed filter, clipped to
    [-1, 1]."""
    if orig_sr == target_sr:
        return audio
    frac = Fraction(target_sr, orig_sr)
    out = scipy.signal.resample_poly(audio, frac.numerator, frac.denominator)
    return np.clip(out, -1.0, 1.0)
