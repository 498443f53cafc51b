"""The port's ``EMGDataset`` against the JAX package's on a synthetic
corpus from the port's ``data/synthetic.generate_corpus`` (which writes
the JAX generator's files, ``test_torch_synthetic.py``): the splits, the
order,
``example_meta`` and every field of every example. The port runs the same
numpy/scipy code on the same files, so every array is equal bit for bit."""

import dataclasses

import numpy as np
import pytest

from silent_speech_tpu.config import DataConfig as JaxDataConfig
from silent_speech_tpu.data.dataset import EMGDataset as JaxDataset
from silent_speech_tpu_torch.data.dataset import EMGDataset
from silent_speech_tpu_torch.data.synthetic import generate_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ours = generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                           n_voiced_sessions=1, n_silent_sessions=1,
                           utterances_per_session=6, seed=5)
    fields = {f.name for f in dataclasses.fields(JaxDataConfig)}
    ref = JaxDataConfig(**{k: v for k, v in dataclasses.asdict(ours).items()
                           if k in fields})
    return ours, ref


def _same(a, b, key):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    else:
        assert a == b, key


@pytest.mark.parametrize("split", [dict(), dict(dev=True), dict(test=True)])
def test_examples_match_jax(corpus, split):
    ours_cfg, jax_cfg = corpus
    ours, ref = EMGDataset(ours_cfg, **split), JaxDataset(jax_cfg, **split)
    assert len(ours) == len(ref) > 0
    assert [(d.directory, d.silent, i) for d, i in ours.example_indices] \
        == [(d.directory, d.silent, i) for d, i in ref.example_indices]
    assert ours.num_features == ref.num_features == 112
    for i in range(len(ref)):
        assert ours.example_meta(i) == ref.example_meta(i)
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for key in b:
            _same(a[key], b[key], key)


def test_silent_subset_and_subset_match_jax(corpus):
    ours_cfg, jax_cfg = corpus
    ours, ref = EMGDataset(ours_cfg), JaxDataset(jax_cfg)
    for a, b in ((ours.silent_subset(), ref.silent_subset()),
                 (ours.subset(0.5), ref.subset(0.5))):
        assert [i for _, i in a.example_indices] == \
            [i for _, i in b.example_indices]
        _same(a[0]["raw_emg"], b[0]["raw_emg"], "raw_emg")
