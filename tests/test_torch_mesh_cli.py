"""The port's CLIs under ``torchrun --standalone --nproc_per_node=2`` on
the CPU (gloo): the transduction CLI on a 1×2 mesh (``--model_parallel
2``) trains an epoch, rank 0 alone writing ``log.txt`` (with the mesh's
shape), the checkpoint and a ``model.pt`` of the full model; the GAN
fine-tuning CLI takes a data-parallel step on two ranks and rank 0 writes
its state and the generator."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.models.hifigan import (HiFiGANConfig,
                                                    init_generator)
from silent_speech_tpu_torch.utils.audio_io import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a hop-256 generator small enough for the CLI on the CPU
CLI_GEN = dict(resblock="1", upsample_rates=(16, 16),
               upsample_kernel_sizes=(32, 32), upsample_initial_channel=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
               num_mels=80)


def _torchrun(module, args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", module, *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def test_transduction_cli_on_a_one_by_two_mesh(tmp_path):
    cfg = generate_corpus(str(tmp_path / "corpus"), n_voiced_sessions=1,
                          n_silent_sessions=1, utterances_per_session=3,
                          seed=5)
    run = tmp_path / "run"
    _torchrun("silent_speech_tpu_torch.transduction_model", [
        "--silent_data_directories", ",".join(cfg.silent_data_directories),
        "--voiced_data_directories", ",".join(cfg.voiced_data_directories),
        "--testset_file", cfg.testset_file,
        "--text_align_directory", cfg.text_align_directory,
        "--normalizers_file", cfg.normalizers_file,
        "--model_size", "64", "--num_layers", "2", "--dropout", "0.0",
        "--compute_dtype", "float32", "--max_batch_len", "8000",
        "--t_cap", "256", "--utt_cap", "8", "--device", "cpu",
        "--model_parallel", "2", "--epochs", "1",
        "--output_directory", str(run)])
    log = (run / "log.txt").read_text().splitlines()
    assert log[0] == "mesh: {'data': 1, 'model': 2}"
    assert any(line.startswith("finished epoch 1 - validation loss: ")
               for line in log)
    assert sorted(p.name for p in run.iterdir()) == [
        "checkpoint.pt", "log.txt", "model.pt"]
    model = EMGEncoder(80, 48, ModelConfig(model_size=64, num_layers=2))
    model.load_state_dict(torch.load(run / "model.pt", weights_only=True),
                          strict=True)
    saved = torch.load(run / "checkpoint.pt", weights_only=True)
    assert saved["mu"][0].shape == model.conv_blocks[0].conv1.weight.shape


def test_finetune_cli_data_parallel_on_two_ranks(tmp_path):
    rng = np.random.default_rng(1)
    data = tmp_path / "wavs"
    data.mkdir()
    for i in range(3):
        write_wav(str(data / f"{i}.wav"),
                  (0.3 * rng.normal(size=22050)).astype(np.float32), 22050)
    gen_cfg = HiFiGANConfig(**CLI_GEN)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"generator": init_generator(
        gen_cfg, torch.Generator().manual_seed(0)).state_dict()},
        ckpt / "g.pt")
    (ckpt / "config.json").write_text(json.dumps(
        {k: list(v) if isinstance(v, tuple) else v
         for k, v in vars(gen_cfg).items()}))
    out = tmp_path / "out"
    _torchrun("silent_speech_tpu_torch.finetune_vocoder", [
        "--data_directory", str(data), "--hifigan_checkpoint",
        str(ckpt / "g.pt"), "--output_directory", str(out), "--steps", "1",
        "--vocoder_batch_size", "2", "--vocoder_segment_frames", "8",
        "--vocoder_disc_periods", "2", "--device", "cpu"])
    log = (out / "log.txt").read_text().splitlines()
    assert log[0] == "mesh: {'data': 2, 'model': 1}"
    assert any(line.startswith("finetune done: 1 new steps") for line in log)
    assert sorted(p.name for p in out.iterdir()) == [
        "generator_finetuned.pt", "log.txt", "vocoder_state.pt"]
    assert torch.load(out / "vocoder_state.pt",
                      weights_only=True)["step"] == 1
