"""The port's native FLAC decoder (``native/flac_codec.cc`` through
``utils/native.read_flac``) against the JAX package's pure-Python
``read_flac_bytes``, bit for bit: mono and stereo, 16 and 24 bits, block
sizes 1152 and 4096 with a short last block, and left/side, right/side and
mid/side stereo (written here, since the JAX writer only writes independent
channels). A stream cut short raises ``ValueError`` in the native decoder
and in the port's plain one; so do bytes that are not FLAC. ``read_audio``
of a ``.flac`` goes through the native decoder. Nothing here builds the
JAX package's ``cpp/``: its reads are the pure-Python ones."""

import numpy as np
import pytest

from silent_speech_tpu.utils.flac import (BitWriter, _crc8, _crc16,
                                          _utf8_number, read_flac_bytes,
                                          write_flac)
from silent_speech_tpu_torch.utils import audio_io, flac, native

RATE = 16000


def _audio(channels, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    tone = 0.4 * np.sin(2 * np.pi * 440 * t)[:, None]
    audio = tone + 0.05 * rng.normal(size=(n, channels))
    return audio[:, 0] if channels == 1 else audio


def _write_decorrelated(path, pcm, assignment, bps=16, blocksize=1152):
    """A stereo FLAC of int ``pcm`` (n, 2) whose frames carry channel
    assignment 8 (left/side), 9 (right/side) or 10 (mid/side), each
    subframe verbatim; the side channel takes bps + 1 bits."""
    left, right = pcm[:, 0], pcm[:, 1]
    side = left - right
    chans = {8: [(left, bps), (side, bps + 1)],
             9: [(side, bps + 1), (right, bps)],
             10: [((left + right) >> 1, bps), (side, bps + 1)]}[assignment]
    si = BitWriter()
    for value, bits in ((blocksize, 16), (blocksize, 16), (0, 24), (0, 24),
                        (RATE, 20), (1, 3), (bps - 1, 5), (len(pcm), 36)):
        si.write_bits(value, bits)
    body = si.getvalue() + b"\x00" * 16
    out = bytearray(b"fLaC") + bytes([0x80]) + len(body).to_bytes(3, "big")
    out += body
    for frame_no, start in enumerate(range(0, len(pcm), blocksize)):
        stop = min(start + blocksize, len(pcm))
        bw = BitWriter()
        bw.write_bits(0b11111111111110, 14)
        bw.write_bits(0, 2)
        bw.write_bits(7, 4)            # block size: 16 bits follow
        bw.write_bits(0, 4)            # sample rate from STREAMINFO
        bw.write_bits(assignment, 4)
        bw.write_bits({16: 4, 24: 6}[bps], 3)
        bw.write_bits(0, 1)
        for b in _utf8_number(frame_no):
            bw.write_bits(b, 8)
        bw.write_bits(stop - start - 1, 16)
        header = bw.getvalue()
        header += bytes([_crc8(header)])
        sub = BitWriter()
        for sig, bits in chans:
            sub.write_bits(0, 1)
            sub.write_bits(1, 6)       # VERBATIM
            sub.write_bits(0, 1)
            for v in sig[start:stop].tolist():
                sub.write_bits(int(v), bits)
        sub.align()
        frame = header + sub.getvalue()
        out += frame + _crc16(frame).to_bytes(2, "big")
    path.write_bytes(bytes(out))


def _held_to_jax(path):
    ours, rate = native.read_flac(str(path))
    ref, ref_rate = read_flac_bytes(path.read_bytes())
    assert rate == ref_rate == RATE
    assert ours.dtype == ref.dtype == np.float64
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    return ours


@pytest.mark.parametrize("blocksize", [1152, 4096])
@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("channels", [1, 2])
def test_native_decode_is_bit_equal_to_jax(tmp_path, channels, bps,
                                           blocksize):
    # 3 blocks and a short last one
    n = 3 * blocksize + 517
    audio = _audio(channels, n)
    path = tmp_path / "a.flac"
    write_flac(str(path), audio, RATE, bps=bps, blocksize=blocksize)
    ours = _held_to_jax(path)
    assert ours.shape == ((n,) if channels == 1 else (n, channels))
    # the writer scales by 2^(bps-1) - 1 and rounds, the reader divides by
    # 2^(bps-1): two quantization steps
    np.testing.assert_allclose(ours, audio, rtol=0,
                               atol=2.0 / (1 << (bps - 1)))
    # the port's plain decoder agrees too
    plain, _ = flac.read_flac_bytes(path.read_bytes())
    np.testing.assert_array_equal(plain, ours)


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("assignment", [8, 9, 10],
                         ids=["left_side", "right_side", "mid_side"])
def test_native_decodes_decorrelated_stereo(tmp_path, assignment, bps):
    rng = np.random.default_rng(assignment)
    top = 1 << (bps - 1)
    pcm = rng.integers(-top, top, size=(1152 + 300, 2))
    path = tmp_path / "s.flac"
    _write_decorrelated(path, pcm, assignment, bps=bps)
    ours = _held_to_jax(path)
    np.testing.assert_array_equal(ours * top, pcm)


def _stream(tmp_path):
    path = tmp_path / "whole.flac"
    write_flac(str(path), _audio(2, 3 * 1152 + 100, seed=3), RATE,
               blocksize=1152)
    return path.read_bytes()


FIRST_FRAME = 4 + 4 + 34               # magic, block header, STREAMINFO


def _second_frame(data):
    return flac._decode_frame(data, FIRST_FRAME, 16, 2, RATE)[1]


def _cuts(data):
    """Offsets to cut at: inside the metadata, right after it, inside the
    first frame's header and body, at the second frame's first byte, in
    the middle, and inside the last frame's CRC-16."""
    first, second = FIRST_FRAME, _second_frame(data)
    return {"magic": 4, "block_header": 6, "streaminfo": 20,
            "metadata_end": first, "frame_header": first + 3,
            "frame_body": first + 200, "frame_boundary": second,
            "middle": len(data) // 2, "crc16": len(data) - 1,
            "no_crc16": len(data) - 2}


CUTS = ["magic", "block_header", "streaminfo", "metadata_end",
        "frame_header", "frame_body", "frame_boundary", "middle", "crc16",
        "no_crc16"]


@pytest.mark.parametrize("cut", CUTS)
def test_a_cut_stream_raises_in_both_decoders(tmp_path, cut):
    data = _stream(tmp_path)
    offset = _cuts(data)[cut]
    path = tmp_path / "cut.flac"
    path.write_bytes(data[:offset])
    with pytest.raises(ValueError, match="truncated FLAC stream") as e:
        native.read_flac(str(path))
    assert str(path) in str(e.value)
    with pytest.raises(ValueError, match="truncated FLAC stream"):
        flac.read_flac_bytes(data[:offset])
    with pytest.raises(ValueError, match="truncated FLAC stream"):
        flac.read_flac(str(path))
    # the whole stream still decodes
    path.write_bytes(data)
    np.testing.assert_array_equal(native.read_flac(str(path))[0],
                                  read_flac_bytes(data)[0])


@pytest.mark.parametrize("kind", ["noise", "wav", "empty"])
def test_bytes_that_are_not_flac_raise(tmp_path, kind):
    path = tmp_path / "x.flac"
    if kind == "noise":
        path.write_bytes(np.random.default_rng(0).bytes(4000))
    elif kind == "wav":
        wav = tmp_path / "x.wav"
        audio_io.write_wav(str(wav), _audio(1, 1000), RATE)
        path.write_bytes(wav.read_bytes())
    else:
        path.write_bytes(b"")
    with pytest.raises(ValueError, match="not a FLAC stream"):
        native.read_flac(str(path))
    with pytest.raises(ValueError, match="not a FLAC file"):
        flac.read_flac_bytes(path.read_bytes())


def test_a_lost_frame_sync_raises_in_both_decoders(tmp_path):
    data = bytearray(_stream(tmp_path))
    second = _second_frame(bytes(data))
    data[second] = 0x00
    path = tmp_path / "sync.flac"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="lost frame sync"):
        native.read_flac(str(path))
    with pytest.raises(ValueError, match="bad frame sync"):
        flac.read_flac_bytes(bytes(data))


def test_read_audio_goes_through_the_native_decoder(tmp_path, monkeypatch):
    path = tmp_path / "c.flac"
    write_flac(str(path), _audio(2, 4000, seed=1), RATE)
    calls = []
    decode = native.read_flac

    def counted(p):
        calls.append(p)
        return decode(p)

    monkeypatch.setattr(native, "read_flac", counted)
    mono, rate = audio_io.read_audio(str(path))
    stereo, _ = audio_io.read_audio(str(tmp_path / "c.wav"), mono=False)
    assert calls == [str(path)] * 2   # the second through the sibling
    assert rate == RATE and mono.shape == (4000,)
    np.testing.assert_array_equal(stereo, read_flac_bytes(
        path.read_bytes())[0])
    np.testing.assert_array_equal(mono, stereo[:, 0])


def test_the_decoder_is_in_the_port_s_native_library():
    assert "flac_codec.cc" in native.SOURCES
    path = native.build()
    assert path.name.startswith("libssp_native-")
    assert path.parent == native.BUILD_DIR
    assert hasattr(native.get_lib(), "ssp_flac_decode")
