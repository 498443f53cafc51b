"""The port's ``StreamingSynthesizer`` (``eval/streaming.py``) against the
JAX package's, at the tiny geometry in float32 from the same converted
weights and one small HiFi-GAN checkpoint (hop 256) that both packages'
``Vocoder`` read, on the CPU. In its own file: the JAX trainer switches
the process to the ``rbg`` PRNG.

Compared: the streamed audio after every hop against JAX's to
``AUDIO_ATOL`` (the vocoded prediction, ``test_torch_synthesis.py``: 4.4e-8
measured there), and the final audio against the port's offline
``vocode(inverse(predict(featurize_raw_window(samples))))`` exactly.
"""

import numpy as np
import pytest

import jax

from silent_speech_tpu.config import Config
from silent_speech_tpu.data.normalizers import \
    FeatureNormalizer as JaxNormalizer
from silent_speech_tpu.eval import streaming as jax_streaming
from silent_speech_tpu.models.hifigan import Vocoder as JaxVocoder
from silent_speech_tpu.parallel.mesh import make_mesh
from silent_speech_tpu_torch.data.normalizers import FeatureNormalizer
from silent_speech_tpu_torch.eval import streaming
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.models.hifigan import HiFiGANConfig, Vocoder
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from hifigan_util import write_tiny_checkpoint
from torch_port_util import (jax_encoder, jax_prng_impl_restored,
                             one_torch_thread, random_variables,
                             tiny_config)

AUDIO_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


def _jax_config():
    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype = 0.0, "float32"
    return cfg


def _warm_example():
    warm = streaming.featurize_raw_window(
        np.random.default_rng(0).normal(size=(2000, 8)))
    n = warm["emg"].shape[0]
    return {**warm, "text_int": np.array([1, 2], np.int64), "silent": False,
            "text": "hi", "phonemes": np.zeros(n, np.int64),
            "audio_features": np.zeros((n, 80), np.float32)}


@pytest.fixture(scope="module")
def synthesizers(tmp_path_factory):
    from silent_speech_tpu.train.transduction import \
        TransductionTrainer as JaxTrainer

    variables = random_variables(jax_encoder(80, 48), seed=7)
    jt = JaxTrainer(_jax_config(),
                    mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jt.init_state(jt._pack([_warm_example()]), seed=0)
    jt.state = jt.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    ours = TransductionTrainer(tiny_config(), device="cpu")
    ours.init_state(0)
    ours.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    path = write_tiny_checkpoint(
        str(tmp_path_factory.mktemp("voc")),
        HiFiGANConfig(upsample_rates=(8, 8, 2, 2),
                      upsample_kernel_sizes=(16, 16, 4, 4),
                      upsample_initial_channel=16,
                      resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1, 3, 5),)))
    means = np.random.default_rng(4).normal(size=(1, 80)).astype(np.float32)
    norms = []
    for cls in (FeatureNormalizer, JaxNormalizer):
        n = cls()
        n.feature_means, n.feature_stddevs = means - 4, np.float32(1.3)
        norms.append(n)
    return ((ours, norms[0], Vocoder(path, device="cpu")),
            (jt, norms[1], JaxVocoder(path)))


def _chunks(x, seed, lo, hi):
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(x):
        n = int(rng.uniform(lo, hi))
        yield x[pos: pos + n]
        pos += n


def test_streaming_synthesizer_matches_jax_and_offline(synthesizers):
    (ours, norm, voc), (jt, jnorm, jvoc) = synthesizers
    x = np.random.default_rng(3).normal(size=(2500, 8)) * 30
    ours_stream = streaming.StreamingSynthesizer(ours, norm, voc,
                                                 hop_s=0.5)
    jax_stream = jax_streaming.StreamingSynthesizer(jt, jnorm, jvoc,
                                                    hop_s=0.5)
    for chunk in _chunks(x, 4, 300, 1100):
        ours_stream.feed(chunk)
        jax_stream.feed(chunk)
        np.testing.assert_allclose(ours_stream.audio(), jax_stream.audio(),
                                   rtol=0, atol=AUDIO_ATOL)
    streamed = ours_stream.audio(force=True)
    np.testing.assert_allclose(streamed, jax_stream.audio(force=True),
                               rtol=0, atol=AUDIO_ATOL)
    ex = streaming.featurize_raw_window(x)
    offline = np.asarray(voc(norm.inverse(ours.predict(ex))),
                         np.float32).reshape(-1)
    np.testing.assert_array_equal(streamed, offline)
    assert streamed.shape == (ex["emg"].shape[0] * 256,)
