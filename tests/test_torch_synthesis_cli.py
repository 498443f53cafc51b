"""The port's CLIs with ``--hifigan_checkpoint``, end to end on the CPU on
a tiny synthetic corpus and a small HiFi-GAN checkpoint: the transduction
CLI writes each epoch's audio and every dev utterance's, ``evaluate`` every
test utterance's, and both finish with rc 0 when the DeepSpeech judge is
not installed (``ROADMAP.md`` fault 13: the JAX ``evaluate.py`` skips the
judge with a warning, the JAX ``transduction_model.py`` ends with the
``ImportError``; the port's two CLIs both skip it).

The wavs are held to the port's own ``vocode(inverse(predict))`` of the
same utterance within ``WAV_ATOL``: PCM16 truncates x·32767 and reads back
over 32768."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import DataConfig, ModelConfig
from silent_speech_tpu_torch.data.dataset import EMGDataset
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.eval.synthesis import EnsemblePredictor
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.models.hifigan import HiFiGANConfig, Vocoder
from silent_speech_tpu_torch.train.transduction import TransductionTrainer
from silent_speech_tpu_torch.utils.audio_io import read_audio

from hifigan_util import write_tiny_checkpoint
from torch_port_util import one_torch_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV_ATOL = 2.0 / 32767
VOCODER = HiFiGANConfig(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                        upsample_initial_channel=32,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 2),))
MODEL = ModelConfig(model_size=64, num_layers=2, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")),
                           n_voiced_sessions=1, n_silent_sessions=1,
                           utterances_per_session=4, seed=5,
                           dev_fraction=0.5)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("voc")),
                                 VOCODER)


def _data_args(cfg: DataConfig):
    return ["--silent_data_directories",
            ",".join(cfg.silent_data_directories),
            "--voiced_data_directories",
            ",".join(cfg.voiced_data_directories),
            "--testset_file", cfg.testset_file,
            "--text_align_directory", cfg.text_align_directory,
            "--normalizers_file", cfg.normalizers_file,
            "--model_size", "64", "--num_layers", "2",
            "--compute_dtype", "float32", "--device", "cpu"]


def _run(module, args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def _vocoded(predictor, example, norm, vocoder):
    return np.clip(vocoder(norm.inverse(predictor.predict(example))), -1, 1)


def test_transduction_cli_vocodes_each_epoch_and_the_dev_set(
        corpus, checkpoint, tmp_path):
    run = tmp_path / "run"
    _run("silent_speech_tpu_torch.transduction_model", _data_args(corpus) + [
        "--output_directory", str(run), "--epochs", "1", "--dropout", "0.0",
        "--max_batch_len", "8000", "--t_cap", "256", "--utt_cap", "8",
        "--hifigan_checkpoint", checkpoint])
    log = (run / "log.txt").read_text()
    assert "finished epoch 1 - validation loss: " in log
    assert "device featurization" in log
    assert "ASR WER skipped" in log and "deepspeech" in log
    devset = EMGDataset(corpus, dev=True)
    trainer = TransductionTrainer(MODEL, device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(torch.load(run / "model.pt",
                                             weights_only=True))
    vocoder = Vocoder(checkpoint, device="cpu")
    epoch0, rate = read_audio(str(run / "epoch_0_output.wav"))
    assert rate == 22050
    np.testing.assert_allclose(
        epoch0, _vocoded(trainer, devset[0], devset.mfcc_norm, vocoder),
        rtol=0, atol=WAV_ATOL)
    assert len(devset) >= 2
    for i in range(len(devset)):
        wav, _ = read_audio(str(run / f"example_output_{i}.wav"))
        np.testing.assert_allclose(
            wav, _vocoded(trainer, devset[i], devset.mfcc_norm, vocoder),
            rtol=0, atol=WAV_ATOL)
    assert not (run / f"example_output_{len(devset)}.wav").exists()


def test_evaluate_cli_vocodes_every_test_utterance(corpus, checkpoint,
                                                   tmp_path):
    model = EMGEncoder(80, 48, MODEL).init_weights(
        torch.Generator().manual_seed(2))
    torch.save(model.state_dict(), tmp_path / "m.pt")
    out = tmp_path / "eval"
    _run("silent_speech_tpu_torch.evaluate", _data_args(corpus) + [
        "--fixed_shapes=false", "--output_directory", str(out), "--models",
        str(tmp_path / "m.pt"), "--hifigan_checkpoint", checkpoint])
    log = (out / "eval_log.txt").read_text()
    assert "loss: " in log and "ASR WER skipped" in log
    testset = EMGDataset(corpus, test=True)
    ensemble = EnsemblePredictor(
        TransductionTrainer(MODEL, device="cpu"), [model])
    vocoder = Vocoder(checkpoint, device="cpu")
    assert len(testset) >= 1
    for i in range(len(testset)):
        wav, rate = read_audio(str(out / f"example_output_{i}.wav"))
        assert rate == 22050
        want = _vocoded(ensemble, testset[i], testset.mfcc_norm, vocoder)
        assert wav.shape == want.shape == (
            testset[i]["emg"].shape[0] * VOCODER.hop_length,)
        np.testing.assert_allclose(wav, want, rtol=0, atol=WAV_ATOL)


def _calls_inside_try(path, name):
    """For each call of ``name`` in the file: whether a ``try`` whose
    handlers catch ``ImportError`` encloses it."""
    tree = ast.parse(open(path).read())
    found = []

    def visit(node, guarded):
        if isinstance(node, ast.Try):
            catches = any(
                h.type is not None and "ImportError" in ast.unparse(h.type)
                for h in node.handlers)
            for child in node.body:
                visit(child, guarded or catches)
            for child in node.handlers + node.orelse + node.finalbody:
                visit(child, guarded)
            return
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == name):
            found.append(guarded)
        for child in ast.iter_child_nodes(node):
            visit(child, guarded)

    visit(tree, False)
    return found


def test_the_jax_clis_part_on_a_missing_judge():
    # fault 13, cited from the sources: the JAX transduction CLI calls the
    # judge unguarded (transduction_model.py:55; its run ends with the
    # ImportError after the wavs are written), the JAX evaluate CLI
    # catches it (evaluate.py:73-80). A run of the JAX CLI takes ~50 s
    # on the CPU, so the test reads the lines instead.
    assert _calls_inside_try(os.path.join(ROOT, "transduction_model.py"),
                             "evaluate") == [False]
    assert _calls_inside_try(os.path.join(ROOT, "evaluate.py"),
                             "evaluate") == [True]
    port = os.path.join(ROOT, "silent_speech_tpu_torch")
    for cli in ("transduction_model.py", "evaluate.py"):
        assert _calls_inside_try(os.path.join(port, cli),
                                 "evaluate_if_installed") == [False]
