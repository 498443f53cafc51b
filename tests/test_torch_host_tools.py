"""The port's host-side data tools against the JAX package's on a corpus
from the port's generator: ``make_normalizers`` (function and CLI),
``make_testset`` (discovery, the seeded split, the CLI) and the dataset's
smoke run with and without ``--make_normalizers``. None of them touches a
device."""

import dataclasses
import json

import numpy as np
import pytest

import make_testset as jax_make_testset
from silent_speech_tpu.config import DataConfig as JaxDataConfig
from silent_speech_tpu.data.dataset import EMGDataset as JaxDataset
from silent_speech_tpu.data.dataset import \
    make_normalizers_file as jax_make_normalizers_file
from silent_speech_tpu.data.normalizers import \
    make_normalizers as jax_make_normalizers
from silent_speech_tpu_torch import make_normalizers as normalizers_cli
from silent_speech_tpu_torch import make_testset
from silent_speech_tpu_torch.data import dataset as dataset_module
from silent_speech_tpu_torch.data.dataset import EMGDataset
from silent_speech_tpu_torch.data.normalizers import (load_normalizers,
                                                      make_normalizers)
from silent_speech_tpu_torch.data.synthetic import generate_corpus

from torch_port_util import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ours = generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                           n_voiced_sessions=1, n_silent_sessions=1,
                           n_nonparallel=1, utterances_per_session=4,
                           seed=7)
    fields = {f.name for f in dataclasses.fields(JaxDataConfig)}
    ref = JaxDataConfig(**{k: v for k, v in dataclasses.asdict(ours).items()
                           if k in fields})
    return ours, ref


def _args(cfg, normalizers_file=None):
    return ["--silent_data_directories",
            ",".join(cfg.silent_data_directories),
            "--voiced_data_directories",
            ",".join(cfg.voiced_data_directories),
            "--testset_file", cfg.testset_file,
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", normalizers_file or cfg.normalizers_file]


def _assert_same_normalizers(ours, ref):
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.feature_means, b.feature_means)
        np.testing.assert_array_equal(a.feature_stddevs, b.feature_stddevs)


@pytest.mark.parametrize("n_samples", [3, 51])
def test_make_normalizers_matches_jax(corpus, n_samples):
    ours_cfg, ref_cfg = corpus
    ours = make_normalizers(EMGDataset(ours_cfg, no_normalizers=True),
                            n_samples)
    ref = jax_make_normalizers(JaxDataset(ref_cfg, no_normalizers=True),
                               n_samples)
    _assert_same_normalizers(ours, ref)
    mfcc, emg = ours
    assert mfcc.feature_means.shape == (1, 80)
    assert np.ndim(mfcc.feature_stddevs) == 0      # one shared std
    assert emg.feature_means.shape == emg.feature_stddevs.shape == (1, 112)


def test_make_normalizers_cli_matches_jax(corpus, tmp_path, capsys):
    ours_cfg, ref_cfg = corpus
    path, ref_path = str(tmp_path / "ours.pkl"), str(tmp_path / "jax.pkl")
    normalizers_cli.main(_args(ours_cfg, path))
    assert f"wrote {path}" in capsys.readouterr().out
    jax_make_normalizers_file(ref_cfg, ref_path)
    _assert_same_normalizers(load_normalizers(path),
                             load_normalizers(ref_path))


def test_make_testset_matches_jax(corpus, tmp_path, capsys):
    ours_cfg, _ = corpus
    dirs = ours_cfg.silent_data_directories + \
        ours_cfg.voiced_data_directories
    locations = make_testset.discover_locations(dirs)
    assert locations == jax_make_testset.discover_locations(dirs)
    assert len(locations) == 8     # 4 parallel sentences + 4 nonparallel
    for seed in (0, 1):
        assert make_testset.make_split(locations, 3, 2, seed) == \
            jax_make_testset.make_split(locations, 3, 2, seed)
    out = tmp_path / "split.json"
    args = _args(ours_cfg)
    args[args.index("--testset_file") + 1] = str(out)
    split = make_testset.main(args + ["--dev_size", "3", "--test_size", "2",
                                      "--split_seed", "1"])
    assert json.loads(out.read_text()) == split == \
        jax_make_testset.make_split(locations, 3, 2, 1)
    assert "3 dev / 2 test of 8 locations" in capsys.readouterr().out
    make_testset.main(args + ["--dev_size", "6", "--test_size", "6"])
    assert "WARNING: only 8 locations" in capsys.readouterr().err


def test_the_dataset_smoke_run(corpus, tmp_path, capsys):
    ours_cfg, ref_cfg = corpus
    n = dataset_module.main(_args(ours_cfg) + ["--smoke_items", "3"])
    assert n == 3 and "loaded 3 examples in " in capsys.readouterr().out
    path, ref_path = str(tmp_path / "ours.pkl"), str(tmp_path / "jax.pkl")
    dataset_module.main(_args(ours_cfg, path) + ["--make_normalizers"])
    assert f"wrote {path}" in capsys.readouterr().out
    jax_make_normalizers_file(ref_cfg, ref_path)
    _assert_same_normalizers(load_normalizers(path),
                             load_normalizers(ref_path))
