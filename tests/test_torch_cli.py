"""The port's transduction CLI end to end on the CPU, on a tiny synthetic
corpus: it trains, validates, writes ``log.txt``, ``model.pt`` and a
checkpoint, and ``--resume`` continues from the checkpoint."""

import os
import subprocess
import sys

import pytest
import torch

from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.transduction_model import (build_parser,
                                                        configs_from_args)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus_args(tmp_path_factory):
    cfg = generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                          n_voiced_sessions=1, n_silent_sessions=1,
                          utterances_per_session=6, seed=5)
    return ["--silent_data_directories",
            ",".join(cfg.silent_data_directories),
            "--voiced_data_directories",
            ",".join(cfg.voiced_data_directories),
            "--testset_file", cfg.testset_file,
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", cfg.normalizers_file,
            "--model_size", "64", "--num_layers", "2", "--dropout", "0.0",
            "--max_batch_len", "8000", "--t_cap", "256", "--utt_cap", "8",
            "--device", "cpu"]


def _run(args):
    # one thread: the tiny model gains nothing from more, and the tier-1
    # run's workers share the cores
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.transduction_model",
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_cli_trains_validates_and_resumes(corpus_args, tmp_path):
    run = str(tmp_path / "run")
    _run(corpus_args + ["--output_directory", run, "--epochs", "1"])
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    assert "train / dev split: " in log and "device: cpu" in log
    assert "building the device corpus" in log
    assert "finished epoch 1 - validation loss: " in log
    state = torch.load(os.path.join(run, "model.pt"), weights_only=True)
    model = EMGEncoder(80, 48, ModelConfig(model_size=64, num_layers=2))
    model.load_state_dict(state, strict=True)
    assert os.path.isfile(os.path.join(run, "checkpoint.pt"))

    _run(corpus_args + ["--output_directory", run, "--epochs", "2",
                        "--resume"])
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    lines = log.splitlines()
    assert "resumed from epoch 1 (step 1)" in lines
    assert any(line.startswith("finished epoch 2 - validation loss: ")
               for line in lines)
    assert not any(line.startswith("finished epoch 1 ") for line in lines)


def test_flags_keep_the_jax_names_and_defaults():
    args = build_parser().parse_args(
        ["--noresume", "--fixed_shapes=false", "--remove_channels", "1,3",
         "--max_batch_len", "0"])
    model, data, train = configs_from_args(args)
    assert not args.resume and not data.fixed_shapes
    assert data.remove_channels == [1, 3]
    assert train.max_batch_len == 256000 and train.epochs == 80
    assert model.model_size == 768 and model.compute_dtype == "bfloat16"
    assert data.testset_file == "testset_largedev.json"
    assert build_parser().parse_args(["--resume"]).resume is True
    assert build_parser().parse_args([]).device == "cuda"
