"""Datasets: the corpus on disk (``EMGDataset``) and example dicts in
memory (``ExampleList``).

Own copy of the JAX package's ``silent_speech_tpu/data/dataset.py``
(reference ``read_emg.py``):

- sessions are directories of ``{i}_emg.npy``, ``{i}_audio_clean.flac``
  (or a sibling ``.wav``) and ``{i}_info.json``, with MFA TextGrids under
  ``text_align_directory``;
- the split follows ``[book, sentence_index]`` membership in the testset
  JSON (``read_emg.py:179-184``); voiced sessions are left out of dev and
  test when silent data exists (``read_emg.py:164-167``);
- a silent utterance is paired with the voiced recording of its sentence
  (``read_emg.py:186-188``);
- loading filters each utterance with its neighbour files as context,
  resamples to 689.06 Hz (raw) and 516.79 Hz (features), computes the 112
  features, trims to the target mel's length, soft-clips and z-normalizes
  (``read_emg.py:52-100``, ``read_emg.py:224-259``);
- examples are shuffled with seed 0.

Examples are cached in memory, and the sampler's metadata is read once.
``make_normalizers_file`` writes ``normalizers.pkl`` from the training
split. Run as a module, it is the input pipeline's smoke test (reference
``read_emg.py:311-315``)::

    python -m silent_speech_tpu_torch.data.dataset \\
        --silent_data_directories DIR --voiced_data_directories DIR \\
        --testset_file F --text_align_directory DIR --normalizers_file F \\
        [--make_normalizers] [--smoke_items N]

It loads ``N`` training examples (1000 by default) and prints the time,
or with ``--make_normalizers`` writes the normalizers and exits. It
touches no device.
"""

from __future__ import annotations

import copy
import json
import os
import random
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DataConfig
from ..dsp.audio_utils import normalize_volume
from ..dsp.emg_features import get_emg_features
from ..dsp.filters import clean_emg
from ..dsp.mel import MelConfig, log_mel_spectrogram
from ..dsp.resample import resample_poly_audio, subsample
from ..phonemes import SIL_ID, read_phonemes
from ..text import TextTransform
from ..utils.audio_io import read_audio
from .normalizers import load_normalizers, make_normalizers, save_normalizers

RAW_RATE = 689.06      # raw-EMG model input rate (read_emg.py:70)
FEAT_RATE = 516.79     # featurization input rate (read_emg.py:71)
CAPTURE_RATE = 1000.0  # on-disk recording rate


@dataclass
class SessionDir:
    session_index: int
    directory: str
    silent: bool
    exclude_from_testset: bool = False


def load_audio_features(path: str, max_frames: Optional[int] = None,
                        renormalize_volume: bool = False) -> np.ndarray:
    """flac/wav → (T, 80) HiFi-GAN log-mel (``data_utils.py:64-83``);
    ``renormalize_volume`` scales the waveform to the reference's peak
    frame RMS first (``normalize_volume``)."""
    audio, rate = read_audio(path)
    if renormalize_volume:
        audio = normalize_volume(audio)
    if rate != 22050:
        audio = resample_poly_audio(audio, rate, 22050)
    audio = np.clip(audio, -1, 1)
    mspec = log_mel_spectrogram(audio.astype(np.float32), MelConfig())
    if max_frames is not None and mspec.shape[0] > max_frames:
        mspec = mspec[:max_frames]
    return mspec


def load_neighbor_context_emg(base_dir: str, index: int):
    """Raw EMG for utterance ``index`` with its neighbor files
    prepended/appended (so zero-phase filters see real context at the
    clip edges; reference ``read_emg.py:52-61``). Returns
    ``(concat, before_len, main_len)`` — the shared IO for the host and
    on-device featurization paths."""
    raw_emg = np.load(os.path.join(base_dir, f'{index}_emg.npy'))
    before_path = os.path.join(base_dir, f'{index - 1}_emg.npy')
    after_path = os.path.join(base_dir, f'{index + 1}_emg.npy')
    before = np.load(before_path) if os.path.exists(before_path) \
        else np.zeros((0, raw_emg.shape[1]))
    after = np.load(after_path) if os.path.exists(after_path) \
        else np.zeros((0, raw_emg.shape[1]))
    x = np.concatenate([before, raw_emg, after], axis=0)
    return x, before.shape[0], raw_emg.shape[0]


def load_utterance(base_dir: str, index: int, limit_length: bool = False,
                   text_align_directory: Optional[str] = None,
                   remove_channels: Tuple[int, ...] = ()) -> dict:
    """Load and featurize one utterance (reference ``read_emg.py:52-100``).

    Neighboring files are prepended/appended before filtering so the
    zero-phase filters see real context at the clip edges, then cropped.
    """
    x, n_before, n_main = load_neighbor_context_emg(base_dir, index)
    x = clean_emg(x, fs=CAPTURE_RATE)
    x = x[n_before: n_before + n_main]

    emg_orig = subsample(x, RAW_RATE, CAPTURE_RATE)
    emg = subsample(x, FEAT_RATE, CAPTURE_RATE)

    for c in remove_channels:
        emg[:, int(c)] = 0
        emg_orig[:, int(c)] = 0

    emg_features = get_emg_features(emg)

    audio_path = os.path.join(base_dir, f'{index}_audio_clean.flac')
    max_frames = min(emg_features.shape[0], 800) if limit_length \
        else emg_features.shape[0]
    mfccs = load_audio_features(audio_path, max_frames=max_frames)

    if emg_features.shape[0] > mfccs.shape[0]:
        emg_features = emg_features[: mfccs.shape[0]]
    # trim the time-domain signals to exact hop alignment with the frames
    emg = emg[6: 6 + 6 * emg_features.shape[0]]
    emg_orig = emg_orig[8: 8 + 8 * emg_features.shape[0]]
    if not (emg_features.shape[0] == mfccs.shape[0]
            and emg.shape[0] == emg_features.shape[0] * 6):
        raise ValueError(
            f"{base_dir} utterance {index}: {emg_features.shape[0]} EMG "
            f"feature frames, {mfccs.shape[0]} audio frames and "
            f"{emg.shape[0]} EMG samples do not line up (the audio is "
            f"shorter than the EMG, or the EMG is too short)")

    with open(os.path.join(base_dir, f'{index}_info.json')) as f:
        info = json.load(f)

    sess = os.path.basename(base_dir)
    phonemes = None
    if text_align_directory is not None:
        tg = os.path.join(text_align_directory, sess,
                          f'{sess}_{index}_audio.TextGrid')
        if os.path.exists(tg):
            phonemes = read_phonemes(tg, mfccs.shape[0])
    if phonemes is None:
        phonemes = np.full(mfccs.shape[0], SIL_ID, dtype=np.int64)

    return {
        'audio_features': mfccs,
        'emg_features': emg_features,
        'text': info['text'],
        'book_location': (info['book'], info['sentence_index']),
        'phonemes': phonemes,
        'raw_emg': emg_orig.astype(np.float32),
    }


class EMGDataset:
    """Drop-in equivalent of the reference ``EMGDataset``
    (``read_emg.py:142-296``) with dict examples in the same schema."""

    def __init__(self, cfg: DataConfig = None, base_dir: Optional[str] = None,
                 limit_length: bool = False, dev: bool = False,
                 test: bool = False, no_testset: bool = False,
                 no_normalizers: bool = False, cache: bool = True):
        self.cfg = cfg or DataConfig()
        self.limit_length = limit_length
        self._cache: Optional[Dict[int, dict]] = {} if cache else None
        self._meta_cache: Dict[int, dict] = {}

        if no_testset:
            devset, testset = [], []
        else:
            with open(self.cfg.testset_file) as f:
                testset_json = json.load(f)
            devset = testset_json['dev']
            testset = testset_json['test']

        directories: List[SessionDir] = []
        if base_dir is not None:
            directories.append(SessionDir(0, base_dir, False))
        else:
            for sd in self.cfg.silent_data_directories:
                for session_dir in sorted(os.listdir(sd)):
                    directories.append(SessionDir(
                        len(directories), os.path.join(sd, session_dir),
                        True))
            has_silent = len(self.cfg.silent_data_directories) > 0
            for vd in self.cfg.voiced_data_directories:
                for session_dir in sorted(os.listdir(vd)):
                    directories.append(SessionDir(
                        len(directories), os.path.join(vd, session_dir),
                        False, exclude_from_testset=has_silent))

        self.example_indices: List[Tuple[SessionDir, int]] = []
        self.voiced_data_locations: Dict[Tuple, Tuple[SessionDir, int]] = {}
        for d in directories:
            for fname in os.listdir(d.directory):
                m = re.match(r'(\d+)_info.json', fname)
                if m is None:
                    continue
                idx = int(m.group(1))
                with open(os.path.join(d.directory, fname)) as f:
                    info = json.load(f)
                if info['sentence_index'] < 0:
                    continue  # boundary silence clips are marked -1
                loc = [info['book'], info['sentence_index']]
                in_test = loc in testset
                in_dev = loc in devset
                selected = (
                    (test and in_test and not d.exclude_from_testset)
                    or (dev and in_dev and not d.exclude_from_testset)
                    or (not test and not dev and not in_test and not in_dev))
                if selected:
                    self.example_indices.append((d, idx))
                if not d.silent:
                    self.voiced_data_locations[tuple(loc)] = (d, idx)

        self.example_indices.sort(
            key=lambda e: (e[0].session_index, e[1]))
        rng = random.Random(0)
        rng.shuffle(self.example_indices)

        self.no_normalizers = no_normalizers
        if not no_normalizers:
            self.mfcc_norm, self.emg_norm = load_normalizers(
                self.cfg.normalizers_file)

        probe = load_utterance(
            self.example_indices[0][0].directory, self.example_indices[0][1],
            remove_channels=tuple(self.cfg.remove_channels))
        self.num_speech_features = probe['audio_features'].shape[1]
        self.num_features = probe['emg_features'].shape[1]
        self.num_sessions = len(directories)
        self.text_transform = TextTransform()

    # -- reference-compatible views ------------------------------------
    def silent_subset(self) -> "EMGDataset":
        result = copy.copy(self)
        result.example_indices = [e for e in self.example_indices
                                  if e[0].silent]
        result._cache = {} if self._cache is not None else None
        result._meta_cache = {}
        return result

    def subset(self, fraction: float) -> "EMGDataset":
        result = copy.copy(self)
        result.example_indices = self.example_indices[
            : int(fraction * len(self.example_indices))]
        result._cache = {} if self._cache is not None else None
        result._meta_cache = {}
        return result

    def __len__(self) -> int:
        return len(self.example_indices)

    def example_meta(self, i: int) -> dict:
        """Sampler metadata: text + total EMG length from ``info['chunks']``
        (``read_emg.py:127-131``), cached across epochs."""
        meta = self._meta_cache.get(i)
        if meta is None:
            d, idx = self.example_indices[i]
            with open(os.path.join(d.directory, f'{idx}_info.json')) as f:
                info = json.load(f)
            meta = {
                'text': info['text'],
                'emg_length': sum(c[0] for c in info['chunks']),
            }
            self._meta_cache[i] = meta
        return meta

    def _load_normalized(self, d: SessionDir, idx: int,
                         limit_length: bool) -> dict:
        utt = load_utterance(
            d.directory, idx, limit_length,
            text_align_directory=self.cfg.text_align_directory,
            remove_channels=tuple(self.cfg.remove_channels))
        raw = utt['raw_emg'] / 20.0
        raw = 50.0 * np.tanh(raw / 50.0)
        emg = utt['emg_features']
        mfccs = utt['audio_features']
        if not self.no_normalizers:
            mfccs = self.mfcc_norm.normalize(mfccs)
            emg = self.emg_norm.normalize(emg)
            emg = 8.0 * np.tanh(emg / 8.0)
        utt['raw_emg'] = raw.astype(np.float32)
        utt['emg_features'] = emg.astype(np.float32)
        utt['audio_features'] = mfccs.astype(np.float32)
        return utt

    def __getitem__(self, i: int) -> dict:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        d, idx = self.example_indices[i]
        utt = self._load_normalized(d, idx, self.limit_length)

        result = {
            'audio_features': utt['audio_features'],
            'emg': utt['emg_features'],
            'raw_emg': utt['raw_emg'],
            'text': utt['text'],
            'text_int': np.array(
                self.text_transform.text_to_int(utt['text']),
                dtype=np.int64),
            'file_label': idx,
            'session_ids': np.full(utt['emg_features'].shape[0],
                                   d.session_index, dtype=np.int64),
            'book_location': utt['book_location'],
            'silent': d.silent,
            'phonemes': utt['phonemes'],
            'audio_file': os.path.join(d.directory,
                                       f'{idx}_audio_clean.flac'),
        }

        if d.silent:
            vd, vidx = self.voiced_data_locations[utt['book_location']]
            voiced = self._load_normalized(vd, vidx, limit_length=False)
            result['parallel_voiced_audio_features'] = \
                voiced['audio_features']
            result['parallel_voiced_emg'] = voiced['emg_features']
            result['phonemes'] = voiced['phonemes']
            result['audio_file'] = os.path.join(
                vd.directory, f'{vidx}_audio_clean.flac')

        if self._cache is not None:
            self._cache[i] = result
        return result

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class ExampleList:
    """Example dicts in memory, in the ``EMGDataset.__getitem__`` schema,
    as a dataset for ``TransductionTrainer.fit``. The sampler's
    ``emg_length`` is the raw capture length a T-frame utterance has (T
    frames at hop 6 of 516.79 Hz, captured at 1 kHz)."""

    def __init__(self, examples: Sequence[dict]):
        self.examples = list(examples)

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int) -> dict:
        return self.examples[i]

    def __iter__(self):
        return iter(self.examples)

    def example_meta(self, i: int) -> dict:
        ex = self.examples[i]
        frames = ex["emg"].shape[0]
        return {"text": ex["text"],
                "emg_length": int(round(frames * 6 * CAPTURE_RATE
                                        / FEAT_RATE))}

    def subset(self, fraction: float) -> "ExampleList":
        return ExampleList(self.examples[: int(fraction * len(self))])


def make_normalizers_file(cfg: DataConfig, n_samples: int = 51):
    """Build the normalizers from the training split's first ``n_samples``
    examples, pickle them to the config's ``normalizers_file`` (reference
    ``read_emg.py:298-309``) and return them."""
    dataset = EMGDataset(cfg, no_normalizers=True)
    mfcc_norm, emg_norm = make_normalizers(dataset, n_samples)
    save_normalizers(cfg.normalizers_file, mfcc_norm, emg_norm)
    return mfcc_norm, emg_norm


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The smoke run: the number of examples loaded."""
    import argparse
    import functools
    import time

    from ..flags import _bool, add_data_flags, add_flag, data_config_from_args

    ap = argparse.ArgumentParser(description="Load the training split "
                                 "(PyTorch port's input pipeline smoke "
                                 "test), or build its normalizers.")
    flag = functools.partial(add_flag, ap)
    add_data_flags(flag)
    flag("make_normalizers", False, "build normalizers.pkl and exit", _bool)
    flag("smoke_items", 1000, "items to load")
    args = ap.parse_args(argv)
    cfg = data_config_from_args(args)
    if args.make_normalizers:
        make_normalizers_file(cfg)
        print(f"wrote {cfg.normalizers_file}")
        return 0
    d = EMGDataset(cfg)
    t0 = time.time()
    n = min(args.smoke_items, len(d))
    for i in range(n):
        d[i]
    print(f"loaded {n} examples in {time.time() - t0:.1f}s "
          f"({len(d)} total)")
    return n


if __name__ == "__main__":
    main()
