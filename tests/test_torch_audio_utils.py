"""The port's waveform utilities against the JAX package's: frame RMS,
volume normalization (with and without its clip guard), chunk splicing,
and ``load_audio_features`` with ``renormalize_volume``."""

import numpy as np
import pytest

from silent_speech_tpu.data.dataset import \
    load_audio_features as jax_audio_features
from silent_speech_tpu.dsp import audio_utils as jax_au
from silent_speech_tpu_torch.data.dataset import load_audio_features
from silent_speech_tpu_torch.dsp import audio_utils
from silent_speech_tpu_torch.utils.audio_io import write_wav


def _audio(seed, n=30000, scale=0.1):
    rng = np.random.default_rng(seed)
    return scale * rng.normal(size=n)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n", [100, 30000])
def test_frame_rms_matches_jax(n, center):
    x = _audio(n, n)
    np.testing.assert_array_equal(audio_utils.frame_rms(x, center=center),
                                  jax_au.frame_rms(x, center=center))


@pytest.mark.parametrize("scale", [0.01, 0.1, 3.0])
def test_normalize_volume_matches_jax(scale):
    x = _audio(1, scale=scale)
    # a spike: at scale 3 the guard rescales the clipped waveform to ±1
    x[100] = 10 * scale
    ours = audio_utils.normalize_volume(x)
    np.testing.assert_array_equal(ours, jax_au.normalize_volume(x))
    assert np.abs(ours).max() <= 1.0


def test_splice_audio_matches_jax():
    rng = np.random.default_rng(2)
    chunks = [rng.normal(size=n) for n in (500, 300, 800)]
    np.testing.assert_array_equal(audio_utils.splice_audio(chunks, 100),
                                  jax_au.splice_audio(chunks, 100))
    with pytest.raises(ValueError, match="overlap"):
        audio_utils.splice_audio([np.zeros(50), np.zeros(500)], 100)


@pytest.mark.parametrize("renormalize", [False, True])
def test_audio_features_match_jax(tmp_path, renormalize):
    path = str(tmp_path / "a.wav")
    write_wav(path, _audio(3, 22050, scale=0.02).astype(np.float32), 22050)
    ours = load_audio_features(path, renormalize_volume=renormalize)
    ref = jax_audio_features(path, renormalize_volume=renormalize)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    if renormalize:
        plain = load_audio_features(path)
        assert ours.mean() > plain.mean() + 1   # louder: larger log-mels
