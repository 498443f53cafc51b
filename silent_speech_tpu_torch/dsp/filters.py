"""EMG signal cleaning filters (numpy/scipy, host side).

Own copy of the JAX package's ``silent_speech_tpu/dsp/filters.py``
(reference ``read_emg.py:27-38``): IIR notches (Q=30) at 60 Hz and its
harmonics 2..7 remove mains hum, then a 3rd-order Butterworth highpass at
2 Hz removes electrode drift; every filter runs zero-phase with
``filtfilt`` over the time axis.
"""

from __future__ import annotations

import numpy as np
import scipy.signal


def butter_highpass(cutoff_hz: float, fs: float, order: int = 3):
    """Butterworth highpass coefficients (``read_emg.py:28``)."""
    return scipy.signal.butter(order, cutoff_hz, "highpass", fs=fs)


def remove_drift(signal: np.ndarray, fs: float) -> np.ndarray:
    """Zero-phase 2 Hz highpass over the first axis."""
    b, a = butter_highpass(2.0, fs)
    return scipy.signal.filtfilt(b, a, signal, axis=0)


def notch(signal: np.ndarray, freq: float, sample_frequency: float
          ) -> np.ndarray:
    """Zero-phase IIR notch, Q=30."""
    b, a = scipy.signal.iirnotch(freq, 30, sample_frequency)
    return scipy.signal.filtfilt(b, a, signal, axis=0)


def notch_harmonics(signal: np.ndarray, freq: float, sample_frequency: float
                    ) -> np.ndarray:
    """Notch at ``freq`` × 1..7."""
    for harmonic in range(1, 8):
        signal = notch(signal, freq * harmonic, sample_frequency)
    return signal


def clean_emg(raw: np.ndarray, fs: float = 1000.0,
              mains_hz: float = 60.0) -> np.ndarray:
    """The cleaning chain over a (time, channels) EMG array, all channels
    at once (``read_emg.py:66-68``): notch harmonics, then drift removal."""
    return remove_drift(notch_harmonics(raw, mains_hz, fs), fs)
