"""The port's FLAC decoder against the JAX package's, on files written with
the JAX package's own FLAC writer: mono and stereo, 16 and 24 bits, bit
for bit; and ``read_audio`` of a ``.flac`` with no sibling ``.wav``."""

import numpy as np
import pytest

from silent_speech_tpu.utils import audio_io as jax_audio
from silent_speech_tpu.utils.flac import read_flac_bytes, write_flac
from silent_speech_tpu_torch.utils import audio_io
from silent_speech_tpu_torch.utils.flac import read_flac


def _audio(channels, seed=0, n=5000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tone = 0.4 * np.sin(2 * np.pi * 440 * t)[:, None]
    audio = tone + 0.05 * rng.normal(size=(n, channels))
    return audio[:, 0] if channels == 1 else audio


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bps", [16, 24])
def test_read_flac_matches_jax(tmp_path, channels, bps):
    path = str(tmp_path / "a.flac")
    # several blocks, the last one short
    write_flac(path, _audio(channels), 16000, bps=bps, blocksize=1152)
    ours, rate = read_flac(path)
    with open(path, "rb") as f:
        ref, ref_rate = read_flac_bytes(f.read())
    assert rate == ref_rate == 16000
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    # and the samples are the audio, to two quantization steps (the writer
    # scales by 2^(bps-1) - 1 and rounds, the reader divides by 2^(bps-1))
    np.testing.assert_allclose(ours, _audio(channels), rtol=0,
                               atol=2.0 / (1 << (bps - 1)))


def test_read_audio_decodes_a_flac_without_a_wav(tmp_path):
    path = str(tmp_path / "b.flac")
    write_flac(path, _audio(2, seed=1), 16000)
    ours, rate = audio_io.read_audio(path)
    ref, ref_rate = jax_audio.read_audio(path)
    assert rate == ref_rate and ours.ndim == 1   # mono: the first channel
    np.testing.assert_array_equal(ours, ref)
    stereo, _ = audio_io.read_audio(path, mono=False)
    assert stereo.shape == (5000, 2)
