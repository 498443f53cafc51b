"""The port's ``make_vocoder_trainset`` CLI on a corpus from the port's
own generator, at a tiny encoder width, against the JAX trainer's
``get_aligned_prediction`` from the same ``model.pt`` (what the JAX CLI
saves). In its own file: the JAX trainer switches the process to the
``rbg`` PRNG."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import torch

from silent_speech_tpu.config import Config
from silent_speech_tpu.config import DataConfig as JaxDataConfig
from silent_speech_tpu.data.dataset import EMGDataset as JaxDataset
from silent_speech_tpu.parallel.mesh import make_mesh
from silent_speech_tpu.train.checkpoint import (load_params_into_state,
                                                load_reference_checkpoint)
from silent_speech_tpu.train.transduction import \
    TransductionTrainer as JaxTrainer
from silent_speech_tpu.utils.audio_io import read_audio as jax_read_audio
from silent_speech_tpu_torch import make_vocoder_trainset
from silent_speech_tpu_torch.config import ModelConfig
from silent_speech_tpu_torch.data.synthetic import generate_corpus
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.utils.audio_io import read_wav

from torch_port_util import jax_prng_impl_restored, one_torch_thread

WIDTH = dict(model_size=64, num_layers=2)
# f32 forwards, XLA's against torch's, of the same model.pt (the serving
# tests' tolerance), relative to the largest denormalized value
PRED_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvt")
    cfg = generate_corpus(str(root / "corpus"), n_voiced_sessions=1,
                          n_silent_sessions=1, utterances_per_session=4,
                          seed=12, dev_fraction=0.5, test_fraction=0.0)
    model = EMGEncoder(80, 48, ModelConfig(**WIDTH,
                                           compute_dtype="float32"))
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), root / "model.pt")
    out = str(root / "voc")
    n = make_vocoder_trainset.main([
        "--silent_data_directories", ",".join(cfg.silent_data_directories),
        "--voiced_data_directories", ",".join(cfg.voiced_data_directories),
        "--testset_file", cfg.testset_file,
        "--text_align_directory", cfg.text_align_directory,
        "--normalizers_file", cfg.normalizers_file,
        "--model", str(root / "model.pt"), "--output_directory", out,
        "--model_size", "64", "--num_layers", "2",
        "--compute_dtype", "float32", "--device", "cpu"])
    return cfg, str(root / "model.pt"), out, n


@pytest.fixture(scope="module")
def jax_side(written):
    """The JAX trainer as the JAX CLI builds it, with the same model.pt,
    and the JAX datasets of the same corpus."""
    cfg, model_pt, _, _ = written
    fields = {f.name for f in dataclasses.fields(JaxDataConfig)}
    ref_cfg = JaxDataConfig(**{k: v for k, v in
                               dataclasses.asdict(cfg).items()
                               if k in fields})
    c = Config()
    c.model.model_size, c.model.num_layers = WIDTH["model_size"], \
        WIDTH["num_layers"]
    c.model.compute_dtype, c.model.fused_attention = "float32", False
    c.data = ref_cfg
    sets = {"train": JaxDataset(ref_cfg, dev=False, test=False),
            "dev": JaxDataset(ref_cfg, dev=True)}
    trainer = JaxTrainer(c, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    trainer.init_state(trainer._pack([sets["dev"][0]]), seed=0)
    params, stats = load_reference_checkpoint(model_pt,
                                              num_layers=WIDTH["num_layers"])
    trainer.state = load_params_into_state(trainer.state, params, stats)
    return trainer, sets


def test_files_names_shapes_and_dtypes(written, jax_side):
    _, _, out, n = written
    _, sets = jax_side
    total = 0
    for prefix, ds in sets.items():
        with open(os.path.join(out, f"{prefix}_filelist.txt")) as f:
            names = f.read().split()
        assert names == [f"{prefix}_output_{i}" for i in range(len(ds))]
        for i, name in enumerate(names):
            mel = np.load(os.path.join(out, "mels", f"{name}.npy"))
            ex = ds[i]
            frames = (ex["parallel_voiced_audio_features"] if ex["silent"]
                      else ex["audio_features"]).shape[0]
            assert mel.shape == (1, 80, frames) and mel.dtype == np.float32
            audio, rate = read_wav(os.path.join(out, "wavs", f"{name}.wav"))
            ref, ref_rate = jax_read_audio(ex["audio_file"])
            assert rate == ref_rate == 22050
            # PCM16 of the clipped source audio
            np.testing.assert_allclose(audio, np.clip(ref, -1, 1),
                                       atol=1 / 32767, rtol=0)
        total += len(names)
    assert total == n > 0 and any(sets["train"][i]["silent"]
                                  for i in range(len(sets["train"])))


@pytest.mark.parametrize("prefix", ["train", "dev"])
def test_mels_are_jax_s_aligned_predictions(written, jax_side, prefix):
    # a silent item's mel is the prediction warped onto its voiced
    # target's timeline by the DTW; a voiced item's is the prediction
    _, _, out, _ = written
    trainer, sets = jax_side
    ds = sets[prefix]
    picked = {}
    for i in range(len(ds)):
        picked.setdefault(bool(ds[i]["silent"]), i)
    assert True in picked
    for silent, i in picked.items():
        ref = np.asarray(trainer.get_aligned_prediction(ds[i],
                                                        ds.mfcc_norm))
        mel = np.load(os.path.join(out, "mels",
                                   f"{prefix}_output_{i}.npy"))[0].T
        assert mel.shape == ref.shape
        np.testing.assert_allclose(mel, ref, rtol=0,
                                   atol=PRED_ATOL * np.abs(ref).max())
