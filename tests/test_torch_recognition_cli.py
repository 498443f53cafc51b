"""The port's recognition CLI end to end on the CPU, on a tiny synthetic
corpus with an ARPA LM: it trains, reports the validation WER in
``log.txt``, writes ``model.pt`` and a checkpoint, ``--resume`` continues,
and ``--evaluate_saved`` scores the test set from ``model.pt`` and from
the checkpoint's directory; the exported ``model.pt`` makes a recognition
serving bundle."""

import os
import re
import subprocess
import sys

import pytest

from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.eval import export
from silent_speech_tpu_torch.recognition_model import (build_parser,
                                                       configs_from_args)

from test_kenlm_binary import ARPA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus_args(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_rec")
    cfg = generate_corpus(str(root), n_voiced_sessions=1,
                          n_silent_sessions=1, utterances_per_session=6,
                          seed=3)
    (root / "lm.arpa").write_text(ARPA)
    return ["--silent_data_directories",
            ",".join(cfg.silent_data_directories),
            "--voiced_data_directories",
            ",".join(cfg.voiced_data_directories),
            "--testset_file", cfg.testset_file,
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", cfg.normalizers_file,
            "--model_size", "64", "--num_layers", "2", "--dropout", "0.0",
            "--max_batch_len", "8000", "--t_cap", "256", "--utt_cap", "8",
            "--lm_path", str(root / "lm.arpa"), "--beam_width", "4",
            "--device", "cpu"]


def _run(args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "silent_speech_tpu_torch.recognition_model",
         *args], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_cli_trains_resumes_and_evaluates(corpus_args, tmp_path):
    run = str(tmp_path / "run")
    _run(corpus_args + ["--output_directory", run, "--epochs", "1"])
    with open(os.path.join(run, "log.txt")) as f:
        lines = f.read().splitlines()
    assert "device: cpu (cpu)" in lines
    assert any(line.startswith("loaded ArpaLM LM from ") for line in lines)
    assert any(re.fullmatch(r"finished epoch 1 - training loss: [0-9.]+ "
                            r"validation WER: [0-9.]+", line)
               for line in lines)
    assert os.path.isfile(os.path.join(run, "checkpoint.pt"))

    _run(corpus_args + ["--output_directory", run, "--epochs", "2",
                        "--resume"])
    with open(os.path.join(run, "log.txt")) as f:
        lines = f.read().splitlines()
    assert any(line.startswith("resumed from epoch 1 ") for line in lines)
    assert any(line.startswith("finished epoch 2 - training loss: ")
               for line in lines)

    scores = []
    for saved in (os.path.join(run, "model.pt"), run):
        out = _run(corpus_args + ["--evaluate_saved", saved])
        line = out.stdout.strip().splitlines()[-1]
        assert line.startswith("WER: ")
        scores.append(float(line.split()[1]))
    # model.pt and the checkpoint hold the same weights
    assert scores[0] == scores[1] >= 0

    bundle = export.main(["--models", os.path.join(run, "model.pt"),
                          "--output_directory", str(tmp_path / "serving"),
                          "--recognition"])
    assert os.path.isfile(os.path.join(bundle, "manifest.json"))


def test_flags_keep_the_jax_names_and_the_recognition_defaults():
    args = build_parser().parse_args(["--noresume", "--fixed_shapes=false",
                                      "--max_batch_len", "0"])
    model, data, train = configs_from_args(args)
    assert not args.resume and not data.fixed_shapes
    assert (train.learning_rate, train.learning_rate_warmup, train.l2,
            train.epochs, train.max_batch_len, train.grad_accum) == (
        3e-4, 1000, 0.0, 200, 128000, 2)
    assert (train.lm_path, train.beam_width, train.lm_alpha,
            train.lm_beta) == ("lm.binary", 100, 1.5, 1.85)
    assert args.device == "cuda" and model.model_size == 768
