"""The port's corpus featurization (``data/device_featurize.py``) against
the JAX package's ``featurize_on_device`` and against the host
``EMGDataset`` path, on one synthetic corpus on disk, on the CPU (the
filter chain through its plain version); and ``fit()`` building its corpus
that way.

Tolerances, from a measured gap (the corpus below):
- metadata (lengths, text, phonemes, session ids, pairing): exact;
- against JAX: both float32, but the 2 Hz high-pass drifts differently in
  the two (``test_torch_device_filters.py``): ``raw_emg`` 0.040 at
  max 7.3 measured, bound 1e-2 · max|raw| with a correlation above 0.9999;
  ``audio_features`` 6.2e-5 measured, bound 1e-3;
- against the host path (float64 scipy): the JAX package's own bounds
  (``tests/test_jax_featurize.py:72-83``): ``raw_emg`` atol 5e-2 (0.047
  measured) with a correlation above 0.999, ``audio_features`` atol 2e-2.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from silent_speech_tpu.config import DataConfig as JaxDataConfig
from silent_speech_tpu.data import jax_featurize
from silent_speech_tpu.data.dataset import EMGDataset as JaxDataset
from silent_speech_tpu_torch.config import (DataConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data import device_featurize
from silent_speech_tpu_torch.data.dataset import EMGDataset
from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
from silent_speech_tpu_torch.data.device_featurize import (
    build_device_corpus, featurize_on_device)
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.dsp.mel import log_mel_spectrogram
from silent_speech_tpu_torch.dsp.resample import subsample
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import one_torch_thread, record_calls, tiny_config

JAX_RAW_REL = 1e-2
JAX_MEL_ATOL = 1e-3
MIN_CORR_JAX = 0.9999
HOST_RAW_ATOL = 5e-2
HOST_MEL_ATOL = 2e-2
MIN_CORR_HOST = 0.999


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                           n_voiced_sessions=1, n_silent_sessions=1,
                           utterances_per_session=4, seed=21)


@pytest.fixture(scope="module")
def dataset(corpus):
    return EMGDataset(corpus, dev=False, test=False, limit_length=True)


@pytest.fixture(scope="module")
def ours(dataset):
    return featurize_on_device(dataset, device="cpu")


def _meta_equal(got, want):
    assert got["raw_emg"].shape == want["raw_emg"].shape
    assert got["audio_features"].shape == want["audio_features"].shape
    for key in ("silent", "text", "book_location", "audio_file",
                "file_label"):
        assert got[key] == want[key], key
    for key in ("text_int", "session_ids", "phonemes"):
        np.testing.assert_array_equal(got[key], want[key])
    assert ("parallel_voiced_audio_features" in got) == got["silent"]
    if got["silent"]:
        assert (got["parallel_voiced_audio_features"].shape
                == want["parallel_voiced_audio_features"].shape)


def test_length_arithmetic_is_jax_s_and_the_host_path_s():
    rng = np.random.default_rng(0)
    for n in (777, 1000, 1503, 2048, 4001):
        sig = rng.normal(size=(n, 2))
        for rate in (516.79, 689.06):
            assert (device_featurize.subsample_len(n, rate)
                    == jax_featurize.subsample_len(n, rate)
                    == subsample(sig, rate, 1000.0).shape[0])
        assert (device_featurize.emg_frame_count(n)
                == jax_featurize.emg_frame_count(n))
    for n in (25600, 44100, 100001):
        assert (device_featurize.mel_frames_len(n)
                == jax_featurize.mel_frames_len(n)
                == log_mel_spectrogram(rng.normal(size=n) * 0.1).shape[0])


def test_featurize_on_device_matches_jax(corpus, dataset, ours):
    fields = {f.name for f in dataclasses.fields(JaxDataConfig)}
    jax_cfg = JaxDataConfig(**{k: v for k, v in
                               dataclasses.asdict(corpus).items()
                               if k in fields})
    jax_set = JaxDataset(jax_cfg, dev=False, test=False, limit_length=True)
    theirs = jax_featurize.featurize_on_device(jax_set)
    assert len(ours) == len(theirs) == len(dataset)
    for got, want in zip(ours, theirs):
        _meta_equal(got, want)
        scale = np.abs(want["raw_emg"]).max()
        assert np.abs(got["raw_emg"] - want["raw_emg"]).max() \
            <= JAX_RAW_REL * scale
        assert np.corrcoef(got["raw_emg"].ravel(),
                           want["raw_emg"].ravel())[0, 1] > MIN_CORR_JAX
        for key in ("audio_features", "parallel_voiced_audio_features"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=JAX_MEL_ATOL)


def test_featurize_on_device_matches_the_host_path(dataset, ours):
    assert any(e["silent"] for e in ours) and not all(
        e["silent"] for e in ours)
    for i, got in enumerate(ours):
        want = dataset[i]
        _meta_equal(got, want)
        np.testing.assert_allclose(got["raw_emg"], want["raw_emg"], rtol=0,
                                   atol=HOST_RAW_ATOL)
        assert np.corrcoef(got["raw_emg"].ravel(),
                           want["raw_emg"].ravel())[0, 1] > MIN_CORR_HOST
        for key in ("audio_features", "parallel_voiced_audio_features"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=HOST_MEL_ATOL)


def test_a_subset_of_ids_gives_the_same_examples(dataset, ours):
    ids = [len(dataset) - 1, 0]
    got = featurize_on_device(dataset, ids=ids, device="cpu")
    for g, i in zip(got, ids):
        _meta_equal(g, ours[i])
        np.testing.assert_array_equal(g["raw_emg"], ours[i]["raw_emg"])


def test_the_corpus_layout_is_the_host_path_s(dataset):
    dev = build_device_corpus(dataset, device="cpu", featurize="device")
    host = build_device_corpus(dataset, device="cpu", featurize="host")
    assert dev.num_examples == host.num_examples == len(dataset)
    for f in ("feat_len_host", "tgt_len_host", "text_len_host",
              "silent_mask"):
        np.testing.assert_array_equal(getattr(dev, f), getattr(host, f))
    a, b = dev.arrays, host.arrays
    for f in ("text_flat", "phon_flat", "feat_len", "raw_off", "tgt_off",
              "tgt_len", "text_off", "text_len", "silent"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    torch.testing.assert_close(a.raw_frames, b.raw_frames, rtol=0,
                               atol=HOST_RAW_ATOL)
    torch.testing.assert_close(a.tgt_flat, b.tgt_flat, rtol=0,
                               atol=HOST_MEL_ATOL)
    with pytest.raises(ValueError, match="'device' or 'host'"):
        build_device_corpus(dataset, device="cpu", featurize="jax")


def test_fit_builds_its_corpus_on_the_device_by_default(corpus, tmp_path,
                                                        caplog):
    assert DataConfig().cache_featurize == "device"
    data_cfg = dataclasses.replace(corpus, t_cap=256, utt_cap=8,
                                   chunk_bucket=1)
    trainer = TransductionTrainer(
        tiny_config(), data_cfg,
        TransductionTrainConfig(max_batch_len=8000,
                                output_directory=str(tmp_path)),
        device="cpu")
    corpora, steps = [], []
    record_calls(trainer, "build_corpus", corpora)
    record_calls(trainer, "train_step_ids", steps)
    trainset = EMGDataset(data_cfg, dev=False, test=False)
    with caplog.at_level(logging.INFO):
        trainer.fit(trainset, EMGDataset(data_cfg, dev=True), epochs=1)
    assert "building the device corpus (%d examples, device "\
        "featurization)" % len(trainset) in caplog.text
    corpus_built = corpora[0]
    assert isinstance(corpus_built, DeviceCorpus)
    assert corpus_built.num_examples == len(trainset)
    assert steps and all(s is not None for s in steps)
    assert np.isfinite([float(s.loss) for s in steps]).all()
    assert "finished epoch 1 - validation loss: " in caplog.text
