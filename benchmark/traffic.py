"""Traffic: the synthetic training corpus and the order of its batches.

One general generator reads a traffic file (``benchmark/workloads/
<traffic>.json``). Its law is a frozen copy of the one in
``silent_speech_tpu_torch/bench.py`` (``build_examples``): utterances of
``int(uniform(lo, hi))`` feature frames, raw EMG of ``raw_per_frame``
samples a frame on ``raw_channels`` electrodes, a silent share whose
utterances carry a voiced recording ``int(T · uniform(r0, r1))`` frames
long as their target, mel targets and target-timeline phonemes, and
``text_ids`` character ids a text. All values are standard normal or
uniform integers.

Sizes come from the file's ``size_seed``, not from the run's seed, so every
seed trains the same multiset of utterance lengths and silent pairs, in
another order and with other values: the seed changes what is computed,
not how much.

The batches follow a frozen copy of ``SizeAwareSampler``
(``silent_speech_tpu_torch/data/sampler.py``; reference
``read_emg.py:115-140``): each epoch shuffles the indices with
``random.Random(seed · 1000003 + epoch)`` and fills a batch greedily while
the summed capture length (``round(T · 6 · 1000 / 516.79)`` samples at 1
kHz) stays within the configuration's ``max_batch_len``; the last partial
batch of an epoch is kept. Every utterance's text has letters, so the
sampler's filter on them drops nothing and is left out.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

FEAT_RATE = 516.79      # Hz, the featurization's input rate
CAPTURE_RATE = 1000.0   # Hz, the recording's rate
FRAME_HOP = 6


def seed_words(seed: int, tag: str) -> List[int]:
    """Entropy words for numpy's ``SeedSequence`` from a run seed of any
    size and a tag naming the stream."""
    if seed < 0:
        raise ValueError(f"seeds are non-negative, got {seed}")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    return words + [sum(ord(c) << (8 * (i % 4)) for i, c in enumerate(tag))]


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed``, one per tag."""
    ss = np.random.SeedSequence(seed_words(seed, tag))
    return int(ss.generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


def capture_length(frames: int) -> int:
    """Raw capture samples at 1 kHz of a ``frames``-frame utterance."""
    return int(round(frames * FRAME_HOP * CAPTURE_RATE / FEAT_RATE))


@dataclass
class Corpus:
    """The utterances as example dicts of the program's schema (the keys
    that ``DeviceCorpus.build`` reads), views into a few flat arrays."""

    examples: List[Dict]
    frames: np.ndarray        # (E,) feature frames of each utterance
    silent: np.ndarray        # (E,) bool
    target_frames: np.ndarray  # (E,) frames of each target


def sizes(traffic: dict):
    """(frames, silent, target frames) of every utterance, from the file's
    ``size_seed`` alone."""
    rng = np.random.default_rng(int(traffic["size_seed"]))
    n = int(traffic["utterances"])
    lo, hi = traffic["frames"]
    frames = rng.uniform(lo, hi, size=n).astype(np.int64)
    silent = rng.uniform(size=n) < float(traffic["silent_share"])
    r0, r1 = traffic["voiced_ratio"]
    ratio = rng.uniform(r0, r1, size=n)
    target = np.where(silent, (frames * ratio).astype(np.int64), frames)
    return frames, silent, target


def make_corpus(traffic: dict, seed: int) -> Corpus:
    """The corpus of one run: the file's sizes in the seed's order, with
    values drawn from the seed in a few bulk calls."""
    frames, silent, target = sizes(traffic)
    rng = np.random.default_rng(seed_words(seed, "corpus"))
    order = rng.permutation(len(frames))
    frames, silent, target = frames[order], silent[order], target[order]
    per_frame = int(traffic["raw_per_frame"])
    channels = int(traffic["raw_channels"])
    mels = int(traffic["mel_bins"])
    raw = rng.standard_normal(int(frames.sum()) * per_frame * channels,
                              dtype=np.float32)
    tgt = rng.standard_normal((int(target.sum()), mels), dtype=np.float32)
    phon = rng.integers(0, int(traffic["phoneme_classes"]),
                        size=int(target.sum())).astype(np.int32)
    text = rng.integers(0, int(traffic["text_vocab"]),
                        size=(len(frames), int(traffic["text_ids"])))
    raw_at = np.concatenate([[0], np.cumsum(frames * per_frame * channels)])
    tgt_at = np.concatenate([[0], np.cumsum(target)])
    examples = []
    for i in range(len(frames)):
        ex = {"raw_emg": raw[raw_at[i]: raw_at[i + 1]].reshape(-1, channels),
              "silent": bool(silent[i]),
              "text": "benchmark",
              "text_int": text[i],
              "phonemes": phon[tgt_at[i]: tgt_at[i + 1]]}
        key = "parallel_voiced_audio_features" if silent[i] \
            else "audio_features"
        ex[key] = tgt[tgt_at[i]: tgt_at[i + 1]]
        examples.append(ex)
    return Corpus(examples, frames, silent, target)


def batches(frames: np.ndarray, max_len: int, seed: int
            ) -> Iterator[List[int]]:
    """The sampler's batches of utterance indices, epoch after epoch,
    without end."""
    lengths = [capture_length(int(t)) for t in frames]
    epoch = 0
    while True:
        indices = list(range(len(lengths)))
        random.Random(seed * 1000003 + epoch).shuffle(indices)
        epoch += 1
        batch: List[int] = []
        batch_length = 0
        for idx in indices:
            if lengths[idx] + batch_length > max_len and batch:
                yield batch
                batch, batch_length = [], 0
            batch.append(idx)
            batch_length += lengths[idx]
        if batch:
            yield batch
