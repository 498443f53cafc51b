"""The port's synthetic corpus generator against the JAX package's: the
same seed writes the same files, byte for byte (``.npy`` EMG, WAV or FLAC
audio, ``_info.json``, TextGrids and ``testset.json``), with and without
``learnable``; the pickled normalizers hold the port's own class, so they
are compared as arrays, and must be equal."""

import os

import numpy as np
import pytest

from silent_speech_tpu.data.synthetic import generate_corpus as jax_corpus
from silent_speech_tpu_torch.data.normalizers import load_normalizers
from silent_speech_tpu_torch.data.synthetic import generate_corpus

from torch_port_util import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("audio_format", ["wav", "flac"])
def test_the_same_seed_writes_the_same_corpus(tmp_path, audio_format,
                                              learnable):
    kw = dict(n_voiced_sessions=1, n_silent_sessions=1,
              utterances_per_session=3, n_nonparallel=1, seed=3,
              audio_format=audio_format, learnable=learnable)
    ref_root, root = str(tmp_path / "jax"), str(tmp_path / "port")
    ref_cfg = jax_corpus(ref_root, **kw)
    cfg = generate_corpus(root, **kw)
    files = _files(root)
    assert files == _files(ref_root)
    assert f"emg_data/silent_parallel_data/silent_0/2_audio_clean." \
           f"{audio_format}" in files
    assert sum(f.endswith(".TextGrid") for f in files) == 6
    for f in files:
        if f == "normalizers.pkl":
            continue
        with open(os.path.join(root, f), "rb") as a, \
                open(os.path.join(ref_root, f), "rb") as b:
            assert a.read() == b.read(), f
    for ours, ref in zip(load_normalizers(cfg.normalizers_file),
                         load_normalizers(ref_cfg.normalizers_file)):
        assert np.array_equal(ours.feature_means, ref.feature_means)
        assert np.array_equal(ours.feature_stddevs, ref.feature_stddevs)
    for name in ("silent_data_directories", "voiced_data_directories",
                 "testset_file", "text_align_directory", "normalizers_file"):
        ours, ref = getattr(cfg, name), getattr(ref_cfg, name)
        if not isinstance(ours, list):
            ours, ref = [ours], [ref]
        assert [os.path.relpath(p, root) for p in ours] == \
            [os.path.relpath(p, ref_root) for p in ref]


def test_learnable_signals_follow_the_text():
    # two utterances of one text share their EMG envelope's character code:
    # the per-character channel pattern, not the noise
    from silent_speech_tpu_torch.data import synthetic

    rng = np.random.default_rng(0)
    a = synthetic._synth_emg_learnable(rng, 2.0, "ab")
    b = synthetic._synth_emg_learnable(rng, 2.0, "ab")
    c = synthetic._synth_emg_learnable(rng, 2.0, "ba")
    assert a.shape == (2000, 8)

    def halves(x):
        return [np.abs(np.diff(h, axis=0)).mean(0) for h in (x[:1000],
                                                               x[1000:])]

    ha, hb, hc = halves(a), halves(b), halves(c)
    assert np.corrcoef(ha[0], hb[0])[0, 1] > 0.9
    assert np.corrcoef(ha[0], hc[1])[0, 1] > 0.9
    assert np.corrcoef(ha[0], hc[0])[0, 1] < 0.9
