"""The traffic generator: the same seed gives the same inputs, every seed
the same multiset of sizes; the sampler's batches cover each epoch once
within the batch capacity."""

from __future__ import annotations

import itertools

import numpy as np

from benchmark import traffic
from benchmark.tests import tiny

BIG_SEED = 2 ** 33 + 12345


def _mix():
    return tiny.cell("transduction-train").traffic


def test_same_seed_same_inputs():
    a = traffic.make_corpus(_mix(), BIG_SEED)
    b = traffic.make_corpus(_mix(), BIG_SEED)
    for x, y in zip(a.examples, b.examples):
        assert x.keys() == y.keys()
        for key in x:
            assert np.array_equal(np.asarray(x[key]), np.asarray(y[key]))


def test_seeds_share_the_sizes_not_the_values():
    a = traffic.make_corpus(_mix(), 1)
    b = traffic.make_corpus(_mix(), BIG_SEED)
    pairs = sorted(zip(a.frames, a.silent, a.target_frames))
    assert pairs == sorted(zip(b.frames, b.silent, b.target_frames))
    assert not np.array_equal(a.examples[0]["raw_emg"][:4],
                              b.examples[0]["raw_emg"][:4])
    for ex, t, tt in zip(a.examples, a.frames, a.target_frames):
        assert ex["raw_emg"].shape == (8 * t, 8)
        key = "parallel_voiced_audio_features" if ex["silent"] \
            else "audio_features"
        assert ex[key].shape == (tt, 80) and ex["phonemes"].shape == (tt,)


def test_batches_cover_each_epoch_within_capacity():
    corpus = traffic.make_corpus(_mix(), 3)
    cap = 3000
    seen = []
    for batch in itertools.islice(traffic.batches(corpus.frames, cap, 9),
                                  60):
        assert sum(traffic.capture_length(int(corpus.frames[i]))
                   for i in batch) <= cap
        seen.extend(batch)
    n = len(corpus.frames)
    assert sorted(seen[:n]) == list(range(n))


def test_derived_seeds_differ_by_tag_and_take_large_seeds():
    assert traffic.derived_seed(BIG_SEED, "a") != \
        traffic.derived_seed(BIG_SEED, "b")
    assert 0 <= traffic.derived_seed(2 ** 64 + 3, "a") < 2 ** 63
