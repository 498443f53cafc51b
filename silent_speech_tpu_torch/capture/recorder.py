"""A synthetic EMG board.

Own copy of ``SyntheticBoard`` from the JAX package's
``silent_speech_tpu/capture/recorder.py`` (the reference's ``debug=True``
backend, ``data_collection/record_data.py:63-65``): 1 kHz, 8 channels of
shaped noise with mains hum, and a button channel, in wall-clock time, so
that the streaming demo runs without hardware. numpy only; the noise comes
from the seed.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

EMG_CHANNELS = 8


class SyntheticBoard:
    """Fake EMG board: ``get_board_data`` returns the samples due since the
    last call, (channels + 1, n): the EMG rows, then the button row."""

    def __init__(self, sampling_rate: int = 1000, seed: int = 0):
        self.sampling_rate = sampling_rate
        self._rng = np.random.default_rng(seed)
        self._t0: Optional[float] = None
        self._consumed = 0

    def start_stream(self) -> None:
        self._t0 = time.monotonic()
        self._consumed = 0

    def stop_stream(self) -> None:
        self._t0 = None

    def get_board_data(self) -> np.ndarray:
        if self._t0 is None:
            raise RuntimeError("stream not started")
        avail = int((time.monotonic() - self._t0) * self.sampling_rate)
        n = max(avail - self._consumed, 0)
        self._consumed += n
        # the hum's phase counts from the new total, as the JAX board's does
        t = (np.arange(n) + self._consumed) / self.sampling_rate
        emg = self._rng.normal(size=(EMG_CHANNELS, n)) * 30
        emg += 5 * np.sin(2 * np.pi * 60 * t)[None, :]
        return np.concatenate([emg, np.zeros((1, n))], axis=0)
