"""Synthetic on-disk corpus generator in the reference dataset schema.

Own copy of the JAX package's ``silent_speech_tpu/data/synthetic.py``:
the same seed writes the same files, byte for byte but for the pickled
normalizers, whose class is the port's (their arrays are equal). The real
EMG corpus is distributed separately; for tests, benchmarks, and CI
this module fabricates a corpus with the exact on-disk layout the loaders
expect (the schema defined by the reference capture tool,
``data_collection/record_reading.py:30-52``):

    <root>/emg_data/{silent_parallel_data,voiced_parallel_data,
                     nonparallel_data}/<session>/
        {i}_emg.npy          (T_emg, 8) float, 1 kHz
        {i}_audio_clean.wav  22.05 kHz mono (flac also supported)
        {i}_info.json        {text, book, sentence_index, chunks}
    <root>/text_alignments/<session>/<session>_{i}_audio.TextGrid
    <root>/testset.json      {dev: [[book, idx]...], test: [...]}
    <root>/normalizers.pkl

``learnable=True`` derives EMG and audio from the text (a fixed
character-to-muscle code), so that a model can generalize to held-out
sentences and a validation WER can fall.

Silent sessions reuse the voiced sessions' (book, sentence_index) keys so
the silent↔voiced pairing logic is exercised.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

import numpy as np

from ..config import DataConfig
from ..phonemes import PHONEME_INVENTORY
from ..utils.audio_io import write_wav
from ..utils import flac as flac_mod

_WORDS = ("the quick brown fox jumps over a lazy dog and then runs back "
          "home to rest while birds sing in tall green trees near water").split()


def _sentence(rng: random.Random, n_words: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n_words))


def _synth_audio(rng: np.random.Generator, seconds: float,
                 voiced: bool = True, sr: int = 22050) -> np.ndarray:
    n = int(seconds * sr)
    t = np.arange(n) / sr
    if not voiced:
        return (0.0005 * rng.normal(size=n)).astype(np.float32)
    f0 = rng.uniform(90, 220)
    env = 0.25 * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 3) * t))
    sig = np.zeros(n)
    for h in range(1, 6):
        sig += np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h
    sig = env * sig / np.abs(sig).max()
    sig += 0.002 * rng.normal(size=n)
    return sig.astype(np.float32)


def _char_code(ch: str) -> int:
    """Stable small integer per character (a-z + space + punctuation)."""
    return ord(ch) % 64


def _char_patterns(n_channels: int = 8) -> np.ndarray:
    """Fixed (64, n_channels) per-character EMG amplitude patterns.

    Seeded independently of the corpus rng so every corpus shares the same
    character→muscle-activation code (a model trained on one learnable
    corpus transfers to another, like a real articulation code)."""
    prng = np.random.default_rng(1234)
    pat = prng.uniform(0.2, 1.0, size=(64, n_channels))
    # orthogonalish: each char gets 2 dominant channels
    for c in range(64):
        hot = prng.permutation(n_channels)[:2]
        pat[c, hot] *= 3.0
    return pat


_CHAR_PATTERNS = _char_patterns()


def _synth_emg_learnable(rng: np.random.Generator, seconds: float,
                         text: str, fs: int = 1000) -> np.ndarray:
    """8-channel EMG whose burst amplitudes encode the character sequence.

    The utterance timeline is split evenly over the characters; during a
    character's segment each channel's bandlimited-noise burst is scaled
    by that character's fixed pattern (``_CHAR_PATTERNS``). The mapping
    EMG→text is therefore deterministic (plus noise), so a model can
    GENERALIZE to held-out sentences — unlike the default pure-noise EMG
    where dev-set metrics are chance."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    chars = list(text) if text else [" "]
    seg = np.minimum((np.arange(n) * len(chars)) // max(n, 1),
                     len(chars) - 1)
    amp = np.stack([_CHAR_PATTERNS[_char_code(chars[s])] for s in
                    np.arange(len(chars))])  # (n_chars, 8)
    env = amp[seg]  # (n, 8)
    noise = rng.normal(size=(n, 8))
    hf = np.diff(noise, axis=0, prepend=np.zeros((1, 8)))
    out = 60 * env * hf
    out += 5 * np.sin(2 * np.pi * 60 * t)[:, None]
    out += 8 * np.sin(2 * np.pi * 0.2 * t[:, None] + np.arange(8))
    out += 1 * rng.normal(size=(n, 8))
    return out


def _synth_audio_learnable(rng: np.random.Generator, seconds: float,
                           text: str, voiced: bool = True,
                           sr: int = 22050) -> np.ndarray:
    """Harmonic audio whose f0/harmonic mix encodes the character
    sequence (same even segmentation as :func:`_synth_emg_learnable`),
    so EMG→mel is a learnable mapping."""
    n = int(seconds * sr)
    if not voiced:
        return (0.0005 * rng.normal(size=n)).astype(np.float32)
    chars = list(text) if text else [" "]
    seg = np.minimum((np.arange(n) * len(chars)) // max(n, 1),
                     len(chars) - 1)
    codes = np.array([_char_code(c) for c in chars])
    f0 = 90.0 + 6.0 * (codes % 20)  # per-char fundamental
    inst_f0 = f0[seg]
    phase = 2 * np.pi * np.cumsum(inst_f0) / sr
    sig = np.zeros(n)
    for h in range(1, 6):
        # per-char harmonic tilt
        w = 1.0 / h + 0.3 * (((codes[seg] >> (h - 1)) & 1))
        sig += w * np.sin(h * phase)
    sig = 0.25 * sig / max(np.abs(sig).max(), 1e-6)
    sig += 0.002 * rng.normal(size=n)
    return sig.astype(np.float32)


def _synth_emg(rng: np.random.Generator, seconds: float,
               fs: int = 1000) -> np.ndarray:
    """8-channel EMG-like signal: bandlimited noise bursts + mains hum +
    drift, in a raw-unit scale similar to real recordings (~±100s)."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    out = np.zeros((n, 8))
    for c in range(8):
        burst_env = np.clip(
            np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t
                   + rng.uniform(0, 6.28)), 0, None)
        noise = rng.normal(size=n)
        # crude bandpass shaping via double differencing + smoothing
        hf = np.diff(noise, prepend=0.0)
        out[:, c] = 40 * burst_env * hf + 5 * np.sin(2 * np.pi * 60 * t) \
            + 20 * np.sin(2 * np.pi * 0.2 * t + c)
    return out


def _write_textgrid(path: str, seconds: float, rng: random.Random) -> None:
    n_phones = max(2, int(seconds * 4))
    bounds = np.linspace(0.0, seconds, n_phones + 1)
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        '',
        'xmin = 0',
        f'xmax = {seconds}',
        'tiers? <exists>',
        'size = 1',
        'item []:',
        '    item [1]:',
        '        class = "IntervalTier"',
        '        name = "phones"',
        '        xmin = 0',
        f'        xmax = {seconds}',
        f'        intervals: size = {n_phones}',
    ]
    for k in range(n_phones):
        phone = rng.choice(PHONEME_INVENTORY[:-1]).upper()
        if rng.random() < 0.2:
            phone = 'sp'
        lines += [
            f'        intervals [{k + 1}]:',
            f'            xmin = {bounds[k]}',
            f'            xmax = {bounds[k + 1]}',
            f'            text = "{phone}"',
        ]
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def generate_corpus(root: str, n_voiced_sessions: int = 1,
                    n_silent_sessions: int = 1,
                    utterances_per_session: int = 8,
                    n_nonparallel: int = 0,
                    min_seconds: float = 0.8, max_seconds: float = 2.0,
                    seed: int = 0, audio_format: str = "wav",
                    with_textgrids: bool = True,
                    dev_fraction: float = 0.25,
                    test_fraction: float = 0.125,
                    learnable: bool = False) -> DataConfig:
    """Create a corpus under ``root``; returns a DataConfig pointing at it.

    ``learnable=True`` derives both EMG and audio deterministically from
    the character sequence (see ``_synth_emg_learnable``), making dev-set
    generalization possible — the default signals are text-independent
    noise, where only held-in (memorization) metrics are meaningful."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)

    voiced_root = os.path.join(root, "emg_data", "voiced_parallel_data")
    silent_root = os.path.join(root, "emg_data", "silent_parallel_data")
    nonpar_root = os.path.join(root, "emg_data", "nonparallel_data")
    align_root = os.path.join(root, "text_alignments")
    for p in (voiced_root, silent_root, nonpar_root, align_root):
        os.makedirs(p, exist_ok=True)

    def write_utt(session_dir: str, session: str, i: int, text: str,
                  book: str, sentence_index: int, seconds: float,
                  voiced: bool) -> None:
        if learnable:
            # pace the utterance by its text so every character spans
            # enough feature frames (~10 chars/s → ~8.6 frames/char at
            # the 86.13 fps feature rate) — CTC on a 0.8 s 30-char
            # sentence is alignment-starved regardless of the model
            seconds = max(seconds, len(text) / 10.0)
        if learnable:
            emg = _synth_emg_learnable(nrng, seconds, text)
            audio = _synth_audio_learnable(nrng, seconds, text,
                                           voiced=voiced)
        else:
            emg = _synth_emg(nrng, seconds)
            audio = _synth_audio(nrng, seconds, voiced=voiced)
        np.save(os.path.join(session_dir, f"{i}_emg.npy"), emg)
        if audio_format == "flac":
            flac_mod.write_flac(
                os.path.join(session_dir, f"{i}_audio_clean.flac"),
                audio, 22050)
        else:
            write_wav(os.path.join(session_dir, f"{i}_audio_clean.wav"),
                      audio, 22050)
        info = {
            "text": text,
            "book": book,
            "sentence_index": sentence_index,
            "chunks": [[emg.shape[0], audio.shape[0], 0]],
        }
        with open(os.path.join(session_dir, f"{i}_info.json"), "w") as f:
            json.dump(info, f)
        if voiced and with_textgrids:
            sdir = os.path.join(align_root, session)
            os.makedirs(sdir, exist_ok=True)
            _write_textgrid(
                os.path.join(sdir, f"{session}_{i}_audio.TextGrid"),
                seconds, rng)

    sentences: List[tuple] = []
    for s in range(n_voiced_sessions):
        session = f"voiced_{s}"
        sdir = os.path.join(voiced_root, session)
        os.makedirs(sdir, exist_ok=True)
        for i in range(utterances_per_session):
            text = _sentence(rng, rng.randint(3, 7))
            seconds = rng.uniform(min_seconds, max_seconds)
            sent_idx = s * utterances_per_session + i
            sentences.append(("synthbook", sent_idx, text, seconds))
            write_utt(sdir, session, i, text, "synthbook", sent_idx,
                      seconds, voiced=True)

    for s in range(n_silent_sessions):
        session = f"silent_{s}"
        sdir = os.path.join(silent_root, session)
        os.makedirs(sdir, exist_ok=True)
        for i in range(utterances_per_session):
            book, sent_idx, text, seconds = sentences[
                (s * utterances_per_session + i) % len(sentences)]
            # silent recordings run a bit shorter/longer than voiced
            sil_seconds = seconds * rng.uniform(0.8, 1.2)
            write_utt(sdir, session, i, text, book, sent_idx, sil_seconds,
                      voiced=False)

    for s in range(n_nonparallel):
        session = f"nonpar_{s}"
        sdir = os.path.join(nonpar_root, session)
        os.makedirs(sdir, exist_ok=True)
        for i in range(utterances_per_session):
            text = _sentence(rng, rng.randint(3, 7))
            seconds = rng.uniform(min_seconds, max_seconds)
            sent_idx = 10000 + s * utterances_per_session + i
            write_utt(sdir, session, i, text, "otherbook", sent_idx,
                      seconds, voiced=True)

    # split file: every Nth sentence to dev / test
    dev, test = [], []
    for j, (book, sent_idx, _, _) in enumerate(sentences):
        r = j / max(len(sentences), 1)
        if r < dev_fraction:
            dev.append([book, sent_idx])
        elif r < dev_fraction + test_fraction:
            test.append([book, sent_idx])
    testset_file = os.path.join(root, "testset.json")
    with open(testset_file, "w") as f:
        json.dump({"dev": dev, "test": test}, f)

    cfg = DataConfig(
        silent_data_directories=[silent_root],
        voiced_data_directories=[voiced_root, nonpar_root]
        if n_nonparallel else [voiced_root],
        testset_file=testset_file,
        text_align_directory=align_root,
        normalizers_file=os.path.join(root, "normalizers.pkl"),
    )

    from .dataset import make_normalizers_file

    make_normalizers_file(cfg, n_samples=8)
    return cfg
