"""The port's FLAC encoder against the JAX package's: the same bytes for
mono and stereo, float and integer input, 16 and 24 bits, several blocks
and a short last block (verbatim subframes); and a round trip through
the port's own decoder."""

import numpy as np
import pytest

from silent_speech_tpu.utils.flac import write_flac as jax_write_flac
from silent_speech_tpu_torch.utils.flac import (BitWriter, read_flac,
                                                write_flac)

CASES = {
    "mono_float": (lambda r: 0.5 * np.sin(np.arange(9000) / 7.0)
                   + 0.01 * r.normal(size=9000), 16, 4096),
    "stereo_int16": (lambda r: r.integers(-2000, 2000, size=(5000, 2))
                     .astype(np.int16), 16, 4096),
    "short_last_block": (lambda r: r.uniform(-1, 1, size=4096 * 2 + 3),
                         16, 4096),
    "bits_24": (lambda r: 0.3 * r.normal(size=3000).clip(-3, 3), 24, 1024),
    "clipped": (lambda r: 2.0 * r.normal(size=2000), 16, 512),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bytes_equal_jax_and_round_trip(tmp_path, case):
    make, bps, blocksize = CASES[case]
    audio = make(np.random.default_rng(len(case)))
    ours, ref = tmp_path / "port.flac", tmp_path / "jax.flac"
    write_flac(str(ours), audio, 22050, bps=bps, blocksize=blocksize)
    jax_write_flac(str(ref), audio, 22050, bps=bps, blocksize=blocksize)
    assert ours.read_bytes() == ref.read_bytes()
    decoded, rate = read_flac(str(ours))
    assert rate == 22050
    full = (1 << (bps - 1)) - 1
    if audio.dtype.kind == "f":
        pcm = np.round(np.clip(audio, -1, 1) * full)
    else:
        pcm = audio.astype(np.float64)
    np.testing.assert_array_equal(decoded * (1 << (bps - 1)), pcm)


def test_an_unaligned_bit_writer_raises():
    bw = BitWriter()
    bw.write_bits(5, 3)
    with pytest.raises(ValueError, match="align"):
        bw.getvalue()
    bw.align()
    assert bw.getvalue() == bytes([0b10100000])
