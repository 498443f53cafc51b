"""Offline audio cleaning of a recorded session: denoise, resample, and
normalize the volume.

Own copy of the JAX package's ``silent_speech_tpu/capture/clean_audio.py``
(reference ``data_collection/clean_audio.py``): every clip of a session is
denoised against the session's silence profile (clip 0), resampled to
22.05 kHz, scaled by a gain smoothed over neighbouring clips, guarded
against peaks above 1, and written as ``{i}_audio_clean.flac``, the file
the datasets read. It runs on the host and touches no device::

    python -m silent_speech_tpu_torch.capture.clean_audio SESSION_DIR... \\
        [--no_denoise]
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from ..dsp.denoise import spectral_gate
from ..dsp.resample import resample_poly_audio
from ..utils.audio_io import read_audio
from ..utils.flac import write_flac

TARGET_RMS = 0.2
CLEAN_RATE = 22050


def _clip_rms(audio: np.ndarray, frame: int = 2048, hop: int = 512
              ) -> float:
    """The peak frame RMS (the scale ``normalize_volume`` keys on,
    ``data_utils.py:19-27``), uncentred."""
    if len(audio) < frame:
        return float(np.sqrt(np.mean(audio ** 2) + 1e-12))
    n = 1 + (len(audio) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return float(np.sqrt((audio[idx] ** 2).mean(axis=1)).max())


def clean_session(session_dir: str, noise_clip_index: int = 0,
                  smooth_neighbors: int = 2,
                  denoise: bool = True) -> List[str]:
    """Clean every ``{i}_audio.flac`` (or ``.wav``) of a session
    directory; returns the paths written."""
    indices = sorted(
        int(m.group(1)) for f in os.listdir(session_dir)
        if (m := re.match(r"(\d+)_audio\.(flac|wav)$", f)))
    if not indices:
        raise FileNotFoundError(f"no raw audio clips in {session_dir}")

    clips, rates = {}, {}
    for i in indices:
        audio, rate = read_audio(os.path.join(session_dir,
                                              f"{i}_audio.flac"))
        clips[i], rates[i] = np.asarray(audio, dtype=np.float64), rate

    noise = clips.get(noise_clip_index, next(iter(clips.values())))

    for i in indices:
        audio = clips[i]
        if denoise:
            audio = spectral_gate(audio, noise, sample_rate=rates[i])
        if rates[i] != CLEAN_RATE:
            audio = resample_poly_audio(audio, rates[i], CLEAN_RATE)
        clips[i] = np.clip(audio, -1, 1)

    # one gain a clip, smoothed over its neighbours
    rms = np.array([_clip_rms(clips[i]) for i in indices])
    gains = TARGET_RMS / (rms + 0.01)
    if smooth_neighbors > 0 and len(indices) > 1:
        k = np.ones(2 * smooth_neighbors + 1)
        k /= k.sum()
        gains = np.convolve(np.pad(gains, smooth_neighbors, mode="edge"),
                            k, mode="valid")

    written = []
    for gi, i in enumerate(indices):
        audio = clips[i] * gains[gi]
        peak = np.abs(audio).max()
        if peak > 1.0:
            audio = audio / peak
        out = os.path.join(session_dir, f"{i}_audio_clean.flac")
        write_flac(out, audio.astype(np.float32), CLEAN_RATE)
        written.append(out)
    return written


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(
        description="Denoise, resample and volume-normalize the audio of "
                    "recorded sessions (host side).")
    p.add_argument("session_dirs", nargs="+")
    p.add_argument("--no_denoise", action="store_true")
    args = p.parse_args(argv)
    written = []
    for d in args.session_dirs:
        paths = clean_session(d, denoise=not args.no_denoise)
        print(f"{d}: wrote {len(paths)} cleaned clips")
        written += paths
    return written


if __name__ == "__main__":
    main()
