"""WAV reading and writing, and ``read_audio``.

Own copy of the JAX package's ``silent_speech_tpu/utils/audio_io.py``:
PCM16/32, 8-bit and float WAV in, PCM16 out (``sf.write``'s default
subtype, which the reference's eval wavs use), and FLAC in through the
port's own decoder (``utils/flac.py``). ``read_audio`` reads a sibling
``.wav`` or ``.flac`` when the path it is given does not exist.
"""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np

from .flac import read_flac


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A wav file → (float32 samples in [-1, 1], (frames, channels) or
    (frames,); sample rate)."""
    import scipy.io.wavfile as siw

    rate, data = siw.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Float audio (clipped to [-1, 1]) or integers as PCM16 wav."""
    audio = np.asarray(audio)
    if audio.dtype.kind == "f":
        pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    else:
        pcm = audio.astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_audio(path: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a wav or flac; for a path that does not exist, its sibling
    ``.wav`` or ``.flac``. With ``mono``, the first channel of a multi-channel file
    (reference ``data_utils.py:67-68``)."""
    base, ext = os.path.splitext(path)
    if not os.path.exists(path):
        for alt_ext in (".wav", ".flac"):
            alt = base + alt_ext
            if alt != path and os.path.exists(alt):
                path, ext = alt, alt_ext
                break
    ext = ext.lower()
    if ext == ".flac":
        audio, rate = read_flac(path)
    elif ext == ".wav":
        audio, rate = read_wav(path)
    else:
        raise ValueError(f"unsupported audio format: {path}")
    if mono and audio.ndim > 1:
        audio = audio[:, 0]
    return audio, rate
