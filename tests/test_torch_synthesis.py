"""The port's ``save_output``, ``dump_all_outputs`` and ``fit()``'s
per-epoch audio against the JAX package's, at the tiny geometry in float32:
the encoder's weights carried over with ``jax_to_torch``, one small HiFi-GAN
checkpoint (hop 256) read by both packages' ``Vocoder`` (the JAX one
converts it with ``hifigan_torch_to_params``, the inverse of the port's
``hifigan_params_to_torch``). In its own file: the JAX trainer switches the
process to the ``rbg`` PRNG.

Tolerances: the mel prediction agrees to 1e-4 (``test_torch_predict.py``);
through the denormalizer and the generator the audio agrees to
``AUDIO_ATOL`` (4.4e-8 measured, at samples of ~0.04), and the PCM16
wavs read back within two steps of 2^-15 (PCM16 truncates x·32767, and
reads back over 32768).
"""

import numpy as np
import pytest

import jax

from silent_speech_tpu.config import Config
from silent_speech_tpu.data.normalizers import \
    FeatureNormalizer as JaxNormalizer
from silent_speech_tpu.eval import synthesis as jax_synthesis
from silent_speech_tpu.models.hifigan import Vocoder as JaxVocoder
from silent_speech_tpu.parallel.mesh import make_mesh
from silent_speech_tpu.train.transduction import \
    TransductionTrainer as JaxTrainer
from silent_speech_tpu_torch.config import (DataConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data.dataset import ExampleList
from silent_speech_tpu_torch.data.normalizers import FeatureNormalizer
from silent_speech_tpu_torch.eval.synthesis import (dump_all_outputs,
                                                    save_output)
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.models.hifigan import HiFiGANConfig, Vocoder
from silent_speech_tpu_torch.train.transduction import TransductionTrainer
from silent_speech_tpu_torch.utils.audio_io import read_audio

from hifigan_util import write_tiny_checkpoint
from torch_port_util import (example_dict, jax_encoder,
                             jax_prng_impl_restored, one_torch_thread,
                             random_variables, tiny_config)

AUDIO_ATOL = 1e-6
WAV_ATOL = 2.0 / 32767
# hop 256 as in V1, narrow
VOCODER = HiFiGANConfig(upsample_rates=(8, 8, 2, 2),
                        upsample_kernel_sizes=(16, 16, 4, 4),
                        upsample_initial_channel=16,
                        resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 3, 5),))


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


@pytest.fixture(scope="module")
def trainers():
    variables = random_variables(jax_encoder(80, 48), seed=5)
    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype = 0.0, "float32"
    jt = JaxTrainer(cfg, mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jt.init_state(jt._pack([example_dict(np.random.default_rng(0), 40,
                                         False)]), seed=0)
    jt.state = jt.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    ours = TransductionTrainer(tiny_config(), device="cpu")
    ours.init_state(0)
    ours.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    return ours, jt


@pytest.fixture(scope="module")
def vocoders(tmp_path_factory):
    path = write_tiny_checkpoint(str(tmp_path_factory.mktemp("voc")),
                                 VOCODER)
    return Vocoder(path, device="cpu"), JaxVocoder(path)


@pytest.fixture(scope="module")
def normalizers():
    rng = np.random.default_rng(9)
    means = (rng.normal(size=(1, 80)) - 4).astype(np.float32)
    out = []
    for cls in (FeatureNormalizer, JaxNormalizer):
        n = cls()
        n.feature_means, n.feature_stddevs = means, np.float32(1.7)
        out.append(n)
    return out


def _examples(n, seed=1):
    rng = np.random.default_rng(seed)
    return [example_dict(rng, t, False) for t in (37, 64, 21)[:n]]


def test_save_output_matches_jax(trainers, vocoders, normalizers,
                                 tmp_path):
    ex = _examples(1)[0]
    ours = save_output(trainers[0], ex, str(tmp_path / "ours.wav"),
                       normalizers[0], vocoders[0])
    theirs = np.asarray(jax_synthesis.save_output(
        trainers[1], ex, str(tmp_path / "jax.wav"), normalizers[1],
        vocoders[1]))
    assert ours.shape == theirs.shape == (37 * 256,)
    assert np.abs(ours).max() > 1e-3       # not silence
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=AUDIO_ATOL)
    a, rate = read_audio(str(tmp_path / "ours.wav"))
    b, rate_jax = read_audio(str(tmp_path / "jax.wav"))
    assert rate == rate_jax == 22050
    np.testing.assert_allclose(a, b, rtol=0, atol=WAV_ATOL)
    np.testing.assert_allclose(a, np.clip(ours, -1, 1), rtol=0,
                               atol=WAV_ATOL)


def test_dump_all_outputs_matches_jax(trainers, vocoders, normalizers,
                                      tmp_path):
    data = _examples(3, seed=2)
    ours = dump_all_outputs(trainers[0], data, str(tmp_path / "o"),
                            normalizers[0], vocoders[0])
    theirs = jax_synthesis.dump_all_outputs(
        trainers[1], data, str(tmp_path / "j"), normalizers[1],
        vocoders[1])
    assert [p.split("/")[-1] for p in ours] == \
        [p.split("/")[-1] for p in theirs] == \
        [f"example_output_{i}.wav" for i in range(3)]
    for a, b, ex in zip(ours, theirs, data):
        wa, _ = read_audio(a)
        wb, _ = read_audio(b)
        assert wa.shape == (ex["emg"].shape[0] * 256,)
        np.testing.assert_allclose(wa, wb, rtol=0, atol=WAV_ATOL)


def test_fit_writes_each_epoch_s_audio(vocoders, normalizers, tmp_path):
    rng = np.random.default_rng(3)
    train = ExampleList([example_dict(rng, t, False) for t in (30, 26)])
    dev = ExampleList([example_dict(rng, t, False) for t in (24, 33)])
    dev.mfcc_norm = normalizers[0]
    trainer = TransductionTrainer(
        tiny_config(), DataConfig(seq_len=16, chunk_bucket=1,
                                  fixed_shapes=False),
        TransductionTrainConfig(output_directory=str(tmp_path)),
        device="cpu")
    trainer.fit(train, dev, epochs=2, vocoder=vocoders[0],
                save_sound_outputs=True)
    for epoch in (0, 1):
        wav, rate = read_audio(str(tmp_path / f"epoch_{epoch}_output.wav"))
        assert rate == 22050 and wav.shape == (24 * 256,)
    want = save_output(trainer, dev[0], str(tmp_path / "again.wav"),
                       normalizers[0], vocoders[0])
    last, _ = read_audio(str(tmp_path / "epoch_1_output.wav"))
    np.testing.assert_allclose(last, np.clip(want, -1, 1), rtol=0,
                               atol=WAV_ATOL)
    # without the flag, or without a vocoder, no audio
    out2 = tmp_path / "quiet"
    trainer.train_cfg.output_directory = str(out2)
    trainer.fit(train, dev, epochs=1, vocoder=vocoders[0])
    assert not list(out2.glob("*.wav"))
