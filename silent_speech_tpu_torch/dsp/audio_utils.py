"""Waveform utilities: volume normalization and chunk splicing.

Own copy of the JAX package's ``silent_speech_tpu/dsp/audio_utils.py``.
Reference equivalents: ``normalize_volume`` (``data_utils.py:19-27``: scale
to a 0.2 peak-frame-RMS target with clip protection) and ``splice_audio``
(``data_utils.py:180-202``: overlap-add with linear crossfade ramps).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def frame_rms(audio: np.ndarray, frame_length: int = 2048,
              hop_length: int = 512, center: bool = True) -> np.ndarray:
    """Per-frame RMS (librosa.feature.rms semantics)."""
    x = np.asarray(audio, dtype=np.float64)
    if center:
        pad = frame_length // 2
        x = np.pad(x, (pad, pad))
    if len(x) < frame_length:
        x = np.pad(x, (0, frame_length - len(x)))
    n = 1 + (len(x) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * \
        np.arange(n)[:, None]
    return np.sqrt((x[idx] ** 2).mean(axis=1))


def normalize_volume(audio: np.ndarray, target_rms: float = 0.2
                     ) -> np.ndarray:
    """Scale so the loudest frame RMS hits ``target_rms``; re-clip if the
    waveform would exceed ±1 (``data_utils.py:19-27``)."""
    max_rms = frame_rms(audio).max() + 0.01
    audio = audio * (target_rms / max_rms)
    max_val = np.abs(audio).max()
    if max_val > 1.0:
        audio = audio / max_val
    return audio


def splice_audio(chunks: Sequence[np.ndarray], overlap: int) -> np.ndarray:
    """Overlap-add chunks with linear crossfade ramps
    (``data_utils.py:180-202``; note it also fades the result's edges)."""
    chunks = [np.array(c, dtype=np.float64) for c in chunks]
    if any(c.shape[0] < overlap for c in chunks):
        raise ValueError(f"every chunk needs at least {overlap} samples, "
                         f"the overlap")

    result_len = sum(c.shape[0] for c in chunks) - overlap * (len(chunks) - 1)
    result = np.zeros(result_len, dtype=chunks[0].dtype)

    ramp_up = np.linspace(0, 1, overlap)
    ramp_down = np.linspace(1, 0, overlap)

    i = 0
    for chunk in chunks:
        n = chunk.shape[0]
        chunk[:overlap] *= ramp_up
        chunk[-overlap:] *= ramp_down
        result[i: i + n] += chunk
        i += n - overlap
    return result
