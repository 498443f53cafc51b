"""The port's vocoder fine-tuning (``train/vocoder.py``) against the JAX
package's: the data source's segments for one seed, one GAN step from the
same converted weights, exact resumes, the exported generator read back by
JAX's converter, and the ``finetune_vocoder`` CLI with a resume."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.dsp.mel import MelConfig as JaxMelConfig
from silent_speech_tpu.models.hifigan import HiFiGANConfig as JaxConfig
from silent_speech_tpu.models.hifigan import (generator_apply,
                                              hifigan_torch_to_params)
from silent_speech_tpu.train.vocoder import \
    VocoderDataSource as JaxDataSource
from silent_speech_tpu.train.vocoder import VocoderTrainer as JaxTrainer
from silent_speech_tpu_torch import finetune_vocoder
from silent_speech_tpu_torch.dsp.mel import MelConfig
from silent_speech_tpu_torch.models.convert import (
    discriminator_params_to_torch, hifigan_params_to_torch)
from silent_speech_tpu_torch.models.hifigan import (HiFiGANConfig, Vocoder,
                                                    init_generator)
from silent_speech_tpu_torch.train.vocoder import (VocoderDataSource,
                                                   VocoderTrainer)
from silent_speech_tpu_torch.utils.audio_io import write_wav

from torch_port_util import one_torch_thread

# tests/test_vocoder_train.py's tiny geometry, with its smallest
# discriminators
TINY_GEN = dict(resblock="1", upsample_rates=(4, 2),
                upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                num_mels=80)
TINY_MEL = dict(n_fft=64, num_mels=80, hop_size=8, win_size=64, fmax=8000.0)
TINY_DISC = dict(disc_periods=(2,), disc_scales=1, disc_width_div=8)
# a hop-256 generator small enough for the CLI on the CPU
CLI_GEN = dict(resblock="1", upsample_rates=(16, 16),
               upsample_kernel_sizes=(32, 32), upsample_initial_channel=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
               num_mels=80)

# one GAN step, the port against JAX from the same weights: the metrics
# measured within 3e-7 relative, the updated weights within 8.4e-7
METRIC_RTOL = 1e-5
WEIGHT_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Three 1 s sines with noise at 22.05 kHz (tests/test_vocoder_train's
    fixture)."""
    rng = np.random.default_rng(1)
    d = str(tmp_path_factory.mktemp("wavs"))
    for i in range(3):
        t = np.arange(22050) / 22050
        audio = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) \
            + 0.02 * rng.normal(size=22050)
        write_wav(os.path.join(d, f"{i}.wav"), audio.astype(np.float32),
                  22050)
    return d


@pytest.fixture(scope="module")
def filelist_dir(tmp_path_factory):
    """A make_vocoder_trainset layout: predicted mels (1, 80, T), wavs and
    a filelist, with one item shorter than a segment."""
    rng = np.random.default_rng(2)
    d = str(tmp_path_factory.mktemp("voc_data"))
    os.makedirs(os.path.join(d, "mels"))
    os.makedirs(os.path.join(d, "wavs"))
    names = []
    for i, frames in enumerate((40, 12, 30)):
        name = f"train_output_{i}"
        np.save(os.path.join(d, "mels", f"{name}.npy"),
                rng.normal(size=(1, 80, frames)).astype(np.float32))
        write_wav(os.path.join(d, "wavs", f"{name}.wav"),
                  (0.3 * rng.normal(size=frames * 256 + 100)).astype(
                      np.float32), 22050)
        names.append(name)
    with open(os.path.join(d, "train_filelist.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return d


@pytest.mark.parametrize("kind", ["gold", "filelist"])
def test_data_source_draws_jax_s_segments(kind, wav_dir, filelist_dir):
    directory = wav_dir if kind == "gold" else filelist_dir
    ours = VocoderDataSource(directory, seed=7).batches(3, 16)
    ref = JaxDataSource(directory, seed=7).batches(3, 16)
    for _ in range(3):
        (m, a), (rm, ra) = next(ours), next(ref)
        assert m.shape == (3, 16, 80) and a.shape == (3, 16 * 256)
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(m, rm)
    with pytest.raises(ValueError, match="hop"):
        VocoderDataSource(directory, hop=64)


def _trainers():
    """The JAX trainer at the tiny geometry and the port's on the CPU with
    its weights."""
    jt = JaxTrainer(gen_cfg=JaxConfig(**TINY_GEN),
                    mel_cfg=JaxMelConfig(**TINY_MEL), learning_rate=1e-3,
                    seed=0, **TINY_DISC)
    ours = VocoderTrainer(gen_cfg=HiFiGANConfig(**TINY_GEN),
                          mel_cfg=MelConfig(**TINY_MEL), learning_rate=1e-3,
                          seed=0, device="cpu", **TINY_DISC)
    ours.generator.load_state_dict(hifigan_params_to_torch(
        jax.device_get(jt.gen_params), ours.gen_cfg), strict=True)
    ours.disc.load_state_dict(discriminator_params_to_torch(
        jax.device_get(jt.disc_params)), strict=True)
    return jt, ours


def test_gan_step_matches_jax():
    jt, ours = _trainers()
    rng = np.random.default_rng(2)
    mels = (0.1 * rng.normal(size=(2, 16, 80))).astype(np.float32)
    audio = (0.3 * rng.normal(size=(2, 16 * 8))).astype(np.float32)
    lr = np.float32(1e-3)
    *state, ref = jt._step(jt.gen_params, jt.disc_params, jt.gen_opt,
                           jt.disc_opt, jnp.asarray(mels),
                           jnp.asarray(audio), lr)
    out = ours.train_step(mels, audio, float(lr))
    assert set(out) == set(ref) == {"d_loss", "g_loss", "adv", "fm",
                                    "mel_l1"}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(ref[k]),
                                   rtol=METRIC_RTOL, err_msg=k)
    gen_ref = hifigan_params_to_torch(jax.device_get(state[0]),
                                      ours.gen_cfg)
    disc_ref = discriminator_params_to_torch(jax.device_get(state[1]))
    for module, ref_state in ((ours.generator, gen_ref),
                              (ours.disc, disc_ref)):
        got = module.state_dict()
        assert got.keys() == ref_state.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), ref_state[k].numpy(),
                                       atol=WEIGHT_ATOL, rtol=0, err_msg=k)
    # the optimizers counted one step each
    assert ours.gen_opt.count == ours.disc_opt.count == 1


def _steps(trainer, directory, n, start):
    src = VocoderDataSource(directory, hop=8, mel_cfg=MelConfig(**TINY_MEL))
    out = []
    trainer.train(src, steps=n, batch_size=2, log_every=0, segment_frames=16,
                  start_step=start, steps_per_epoch=3,
                  on_step=lambda i, m: out.append(m))
    return out


def test_save_and_load_state_resume_exactly(wav_dir, tmp_path):
    def trainer(seed):
        return VocoderTrainer(gen_cfg=HiFiGANConfig(**TINY_GEN),
                              mel_cfg=MelConfig(**TINY_MEL),
                              learning_rate=1e-3, seed=seed, device="cpu",
                              **TINY_DISC)

    t1 = trainer(0)
    _steps(t1, wav_dir, 2, 0)
    t1.save_state(str(tmp_path), step=2)
    ref = _steps(t1, wav_dir, 2, 2)
    t2 = trainer(99)
    assert VocoderTrainer.state_exists(str(tmp_path))
    assert t2.load_state(str(tmp_path)) == 2
    assert _steps(t2, wav_dir, 2, 2) == ref
    for a, b in ((t1.generator, t2.generator), (t1.disc, t2.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # the learning rate decays by epoch (3 steps here), as in JAX
    assert t1.learning_rate(5, 3) == float(np.float32(1e-3 * 0.999))


def test_export_torch_round_trips_through_jax(tmp_path):
    trainer = VocoderTrainer(gen_cfg=HiFiGANConfig(**TINY_GEN),
                             mel_cfg=MelConfig(**TINY_MEL), seed=3,
                             device="cpu", **TINY_DISC)
    path = str(tmp_path / "g.pt")
    trainer.export_torch(path)
    state = torch.load(path, weights_only=True)["generator"]
    jcfg = JaxConfig(**TINY_GEN)
    params = hifigan_torch_to_params({k: v.numpy() for k, v in state.items()},
                                     jcfg)
    mel = np.random.default_rng(4).normal(size=(1, 10, 80)).astype(
        np.float32)
    ref = generator_apply(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(mel), jcfg)
    with torch.no_grad():
        out = trainer.generator(torch.from_numpy(mel))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_finetune_cli_runs_and_resumes(filelist_dir, tmp_path):
    cfg = HiFiGANConfig(**CLI_GEN)
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    gen = init_generator(cfg, torch.Generator().manual_seed(0))
    torch.save({"generator": gen.state_dict()}, ckpt_dir / "g.pt")
    with open(ckpt_dir / "config.json", "w") as f:
        json.dump({k: list(v) if isinstance(v, tuple) else v
                   for k, v in vars(cfg).items()}, f)
    out_dir = str(tmp_path / "out")
    args = ["--data_directory", filelist_dir, "--hifigan_checkpoint",
            str(ckpt_dir / "g.pt"), "--output_directory", out_dir,
            "--vocoder_batch_size", "2", "--vocoder_segment_frames", "8",
            "--vocoder_disc_periods", "2", "--device", "cpu"]
    first = finetune_vocoder.main(args + ["--steps", "2"])
    assert np.isfinite(list(first.values())).all()
    final = finetune_vocoder.main(args + ["--steps", "1", "--resume"])
    assert np.isfinite(list(final.values())).all()
    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    assert "resumed vocoder state at step 2" in log
    assert "finetune done: 1 new steps (at 3 total)" in log
    assert torch.load(os.path.join(out_dir, "vocoder_state.pt"),
                      weights_only=True)["step"] == 3
    # the exported generator loads with the checkpoint's config
    path = os.path.join(out_dir, "generator_finetuned.pt")
    vocoder = Vocoder(path, config_path=str(ckpt_dir / "config.json"),
                      device="cpu")
    assert vocoder(np.zeros((3, 80), np.float32)).shape == (3 * 256,)
    assert not all(torch.equal(a, b) for a, b in zip(
        gen.state_dict().values(), vocoder.generator.state_dict().values()))
