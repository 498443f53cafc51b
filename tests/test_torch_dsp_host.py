"""The port's copies of the host DSP (numpy/scipy) against the JAX
package's: EMG cleaning, resampling, the log-mel spectrogram and the 112
EMG features. The same numpy code on the same inputs: equal bit for bit."""

import numpy as np
import pytest

from silent_speech_tpu.dsp import emg_features as jax_feats
from silent_speech_tpu.dsp import filters as jax_filters
from silent_speech_tpu.dsp import mel as jax_mel
from silent_speech_tpu.dsp import resample as jax_resample
from silent_speech_tpu_torch.dsp import emg_features, filters, mel, resample

RNG = np.random.default_rng(0)
EMG = RNG.normal(size=(3000, 8)) * 50 + np.sin(np.arange(3000) / 40)[:, None]
AUDIO = RNG.uniform(-0.5, 0.5, size=16000).astype(np.float32)


def test_clean_emg_matches_jax():
    np.testing.assert_array_equal(filters.clean_emg(EMG),
                                  jax_filters.clean_emg(EMG))
    np.testing.assert_array_equal(filters.notch(EMG, 60, 1000),
                                  jax_filters.notch(EMG, 60, 1000))


@pytest.mark.parametrize("rate", [689.06, 516.79])
def test_subsample_matches_jax(rate):
    np.testing.assert_array_equal(resample.subsample(EMG, rate, 1000.0),
                                  jax_resample.subsample(EMG, rate, 1000.0))
    np.testing.assert_array_equal(
        resample.subsample(EMG[:, 0], rate, 1000.0),
        jax_resample.subsample(EMG[:, 0], rate, 1000.0))


@pytest.mark.parametrize("orig", [16000, 22050, 44100])
def test_resample_poly_audio_matches_jax(orig):
    np.testing.assert_array_equal(
        resample.resample_poly_audio(AUDIO, orig, 22050),
        jax_resample.resample_poly_audio(AUDIO, orig, 22050))


def test_log_mel_matches_jax():
    np.testing.assert_array_equal(
        mel.mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
        jax_mel.mel_filterbank(22050, 1024, 80, 0.0, 8000.0))
    ours = mel.log_mel_spectrogram(AUDIO)
    assert ours.shape == (16000 // 256, 80)
    np.testing.assert_array_equal(ours, jax_mel.log_mel_spectrogram(AUDIO))


def test_emg_features_match_jax():
    x = resample.subsample(filters.clean_emg(EMG), 516.79, 1000.0)
    ours = emg_features.get_emg_features(x)
    assert ours.shape == ((x.shape[0] - 16) // 6 + 1, 112)
    np.testing.assert_array_equal(ours, jax_feats.get_emg_features(x))
