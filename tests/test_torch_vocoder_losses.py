"""The port's HiFi-GAN discriminators, GAN losses and differentiable
log-mel against the JAX package's: ``models/hifigan_discriminators.py``
(Flax modules on converted weights) and ``jax_log_mel_spectrogram``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from flax import linen as nn

from silent_speech_tpu.dsp.mel import MelConfig as JaxMelConfig
from silent_speech_tpu.dsp.mel import jax_log_mel_spectrogram
from silent_speech_tpu.models import hifigan_discriminators as jd
from silent_speech_tpu_torch.dsp.mel import (MelConfig, reflect_pad,
                                             torch_log_mel_spectrogram)
from silent_speech_tpu_torch.models import hifigan_discriminators as pd
from silent_speech_tpu_torch.models.convert import \
    discriminator_params_to_torch

from torch_port_util import one_torch_thread

# f32 convolutions, XLA's against torch's, on the CPU: measured ≤ 3e-7
# absolute at scores of order 1
DISC_ATOL = 2e-6
# tests/test_vocoder_train.py's TINY_MEL
TINY_MEL = dict(n_fft=64, num_mels=80, hop_size=8, win_size=64, fmax=8000.0)


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _nhwc(x):
    """A port feature map (channels-first) in Flax's channels-last."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


def _pair(periods, n_scales, t, seed=0):
    audio = np.random.default_rng(seed).normal(size=(2, t)).astype(
        np.float32)
    flax_disc = jd.HiFiGANDiscriminators(periods=periods, n_scales=n_scales,
                                         width_div=8)
    params = jax.device_get(flax_disc.init(jax.random.PRNGKey(seed),
                                           jnp.asarray(audio))["params"])
    ours = pd.HiFiGANDiscriminators(periods, n_scales, width_div=8)
    ours.load_state_dict(discriminator_params_to_torch(params), strict=True)
    return audio, flax_disc, params, ours


@pytest.mark.parametrize("t", [1024, 1023], ids=["even", "odd"])
def test_discriminators_match_flax(t):
    audio, flax_disc, params, ours = _pair((2, 3), 3, t)
    ref_s, ref_f = flax_disc.apply({"params": params}, jnp.asarray(audio))
    with torch.no_grad():
        out_s, out_f = ours(torch.from_numpy(audio))
    assert len(out_s) == len(ref_s) == 5
    for r, o in zip(ref_s, out_s):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=DISC_ATOL,
                                   rtol=0)
    for rf, of in zip(ref_f, out_f):
        assert len(of) == len(rf)
        for r, o in zip(rf, of):
            assert _nhwc(o).shape == r.shape
            np.testing.assert_allclose(_nhwc(o), np.asarray(r),
                                       atol=DISC_ATOL, rtol=0)


@pytest.mark.parametrize("t", [1, 2, 4, 9, 15])
def test_period_padding_matches_flax_at_the_edges(t):
    # T % p == 0 (no padding), T = 1 (constant padding) and T < p (the
    # reflection runs past the signal)
    audio, flax_disc, params, ours = _pair((2, 3, 5), 0, t, seed=t)
    ref_s, _ = flax_disc.apply({"params": params}, jnp.asarray(audio))
    with torch.no_grad():
        out_s, _ = ours(torch.from_numpy(audio))
    for r, o in zip(ref_s, out_s):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=DISC_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("t", [10, 11, 1023, 1024])
def test_avg_pool_counts_the_padding_as_flax_does(t):
    x = np.random.default_rng(t).normal(size=(2, t)).astype(np.float32)
    ref = nn.avg_pool(jnp.asarray(x)[:, :, None], window_shape=(4,),
                      strides=(2,), padding=[(2, 2)])[:, :, 0]
    out = F.avg_pool1d(torch.from_numpy(x)[:, None], 4, 2, padding=2,
                       count_include_pad=True)[:, 0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7,
                               rtol=0)


@pytest.mark.parametrize("t,left,right", [(2, 0, 9), (3, 4, 4), (5, 7, 0),
                                          (8192, 384, 384)])
def test_reflect_pad_is_numpy_s(t, left, right):
    x = np.random.default_rng(t).normal(size=(2, t))
    out = reflect_pad(torch.from_numpy(x), left, right).numpy()
    np.testing.assert_array_equal(
        out, np.pad(x, ((0, 0), (left, right)), mode="reflect"))


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    real = [rng.normal(size=(2, n)).astype(np.float32) for n in (7, 5, 3)]
    fake = [rng.normal(size=(2, n)).astype(np.float32) for n in (7, 5, 3)]
    real_f = [[rng.normal(size=(2, 4, n)).astype(np.float32)
               for n in (9, 6)] for _ in range(3)]
    fake_f = [[rng.normal(size=(2, 4, n)).astype(np.float32)
               for n in (9, 6)] for _ in range(3)]

    def t(xs):
        return [torch.from_numpy(x) if isinstance(x, np.ndarray) else t(x)
                for x in xs]

    def j(xs):
        return [jnp.asarray(x) if isinstance(x, np.ndarray) else j(x)
                for x in xs]

    for ours, ref in (
            (pd.discriminator_loss(t(real), t(fake)),
             jd.discriminator_loss(j(real), j(fake))),
            (pd.generator_adversarial_loss(t(fake)),
             jd.generator_adversarial_loss(j(fake))),
            (pd.feature_matching_loss(t(real_f), t(fake_f)),
             jd.feature_matching_loss(j(real_f), j(fake_f)))):
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    assert float(pd.feature_matching_loss(t(real_f), t(real_f))) == 0.0


@pytest.mark.parametrize("mel_cfg", [TINY_MEL, {}], ids=["tiny", "default"])
def test_log_mel_matches_jax_in_value_and_gradient(mel_cfg):
    # 8,192 samples: a training segment of 32 frames at hop 256
    audio = (0.3 * np.random.default_rng(4).normal(size=(2, 8192))).astype(
        np.float32)
    jcfg, cfg = JaxMelConfig(**mel_cfg), MelConfig(**mel_cfg)
    ref = np.stack([np.asarray(jax_log_mel_spectrogram(jnp.asarray(a),
                                                       jcfg))
                    for a in audio])
    assert ref.shape == (2, 8192 // cfg.hop_size, 80)
    weights = np.random.default_rng(5).normal(size=ref.shape).astype(
        np.float32)

    def jax_scalar(a):
        mel = jax.vmap(lambda x: jax_log_mel_spectrogram(x, jcfg))(a)
        return jnp.sum(mel * weights)

    ref_grad = np.asarray(jax.grad(jax_scalar)(jnp.asarray(audio)))
    x = torch.from_numpy(audio).requires_grad_(True)
    mel = torch_log_mel_spectrogram(x, cfg)
    (mel * torch.from_numpy(weights)).sum().backward()
    # f32 DFT products of 1,024 terms: measured 1.0e-5 on log-mels of
    # order 10 (default) and 1e-6 (tiny)
    np.testing.assert_allclose(mel.detach().numpy(), ref, atol=5e-5,
                               rtol=0)
    scale = np.abs(ref_grad).max()
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, atol=1e-4 * scale,
                               rtol=0)
