"""The port's text codec, TextGrid phonemes, WAV I/O and normalizers
against the JAX package's."""

import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from silent_speech_tpu import phonemes as jax_phonemes
from silent_speech_tpu import text as jax_text
from silent_speech_tpu.data import normalizers as jax_norm
from silent_speech_tpu.utils import audio_io as jax_audio
from silent_speech_tpu_torch import phonemes, text
from silent_speech_tpu_torch.data import normalizers
from silent_speech_tpu_torch.utils import audio_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LONG_TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 1.25
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 1.25
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 1.25
            text = "hello"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 1.25
        intervals: size = 4
        intervals [1]:
            xmin = 0
            xmax = 0.31
            text = ""
        intervals [2]:
            xmin = 0.31
            xmax = 0.52
            text = "HH"
        intervals [3]:
            xmin = 0.52
            xmax = 0.9
            text = "AH0"
        intervals [4]:
            xmin = 0.9
            xmax = 1.25
            text = "spn"
'''
SHORT_TEXTGRID = '''"ooTextFile"
"TextGrid"
0
0.8
<exists>
1
"IntervalTier"
"phones"
0
0.8
2
0
0.4
"sp"
0.4
0.8
"IY1"
'''


@pytest.mark.parametrize("grid", [LONG_TEXTGRID, SHORT_TEXTGRID])
@pytest.mark.parametrize("max_len", [None, 20])
def test_read_phonemes_matches_jax(grid, max_len):
    ours = phonemes.read_phonemes(grid, max_len, from_string=True)
    np.testing.assert_array_equal(
        ours, jax_phonemes.read_phonemes(grid, max_len, from_string=True))
    assert ours.dtype == np.int64 and ours[-1] == phonemes.SIL_ID


def test_read_phonemes_rejects_a_gap_and_a_short_grid():
    gap = SHORT_TEXTGRID.replace('0.4\n0.8\n"IY1"', '0.5\n0.8\n"IY1"')
    with pytest.raises(ValueError, match="missing aligned phones"):
        phonemes.read_phonemes(gap, from_string=True)
    with pytest.raises(ValueError, match="fewer than the 500"):
        phonemes.read_phonemes(SHORT_TEXTGRID, 500, from_string=True)


@pytest.mark.parametrize("sentence", [
    "Hello, World!", "Æsop’s “fables” — 1912 édition", "naïve café…"])
def test_text_transform_matches_jax(sentence):
    ours, ref = text.TextTransform(), jax_text.TextTransform()
    assert ours.clean_text(sentence) == ref.clean_text(sentence)
    ints = ours.text_to_int(sentence)
    assert ints == ref.text_to_int(sentence)
    assert ours.int_to_text(ints) == ref.int_to_text(ints)
    assert ours.chars == text.CHARS


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_wav_round_trip_matches_jax(tmp_path, dtype):
    audio = np.random.default_rng(0).uniform(-0.9, 0.9, 2205).astype(
        np.float32)
    if dtype == "int16":
        audio = (audio * 30000).astype(np.int16)
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, audio, 22050)
    ours, rate = audio_io.read_wav(path)
    ref, ref_rate = jax_audio.read_wav(path)
    assert rate == ref_rate == 22050
    np.testing.assert_array_equal(ours, ref)
    # a .flac path reads its sibling .wav
    flac_ours, _ = audio_io.read_audio(str(tmp_path / "a.flac"))
    np.testing.assert_array_equal(flac_ours,
                                  jax_audio.read_audio(
                                      str(tmp_path / "a.flac"))[0])


def test_a_flac_without_a_wav_raises(tmp_path):
    # no sibling .wav: the FLAC decoder reads the file, and a stream that
    # ends after its magic raises
    path = tmp_path / "b.flac"
    path.write_bytes(b"fLaC")
    with pytest.raises(ValueError, match="truncated FLAC"):
        audio_io.read_audio(str(path))


def _jax_normalizers(tmp_path):
    rng = np.random.default_rng(2)
    mfcc = jax_norm.FeatureNormalizer([rng.normal(size=(50, 80))],
                                      share_scale=True)
    emg = jax_norm.FeatureNormalizer([rng.normal(size=(50, 112))])
    path = str(tmp_path / "normalizers.pkl")
    jax_norm.save_normalizers(path, mfcc, emg)
    return path, mfcc, emg


def test_normalizers_written_by_jax_load(tmp_path):
    path, mfcc, emg = _jax_normalizers(tmp_path)
    ours = normalizers.load_normalizers(path)
    x = np.random.default_rng(3).normal(size=(7, 112))
    assert all(type(n) is normalizers.FeatureNormalizer for n in ours)
    np.testing.assert_array_equal(ours[1].normalize(x), emg.normalize(x))
    np.testing.assert_array_equal(ours[0].inverse(x[:, :80]),
                                  mfcc.inverse(x[:, :80]))
    # and the port's own files load in the JAX package
    normalizers.save_normalizers(str(tmp_path / "ours.pkl"), *ours)
    back = jax_norm.load_normalizers(str(tmp_path / "ours.pkl"))
    np.testing.assert_array_equal(back[1].feature_stddevs,
                                  emg.feature_stddevs)


def _reference_normalizers(path, mfcc, emg, monkeypatch):
    """Write (mfcc, emg) as the reference does: instances of
    ``data_utils.FeatureNormalizer``."""
    module = types.ModuleType("data_utils")

    class FeatureNormalizer:
        pass

    FeatureNormalizer.__module__ = "data_utils"
    FeatureNormalizer.__qualname__ = "FeatureNormalizer"
    module.FeatureNormalizer = FeatureNormalizer
    monkeypatch.setitem(sys.modules, "data_utils", module)
    objs = []
    for n in (mfcc, emg):
        obj = FeatureNormalizer()
        obj.__dict__.update(n.__dict__)
        objs.append(obj)
    with open(path, "wb") as f:
        pickle.dump(tuple(objs), f)


def test_normalizers_load_without_the_jax_package(tmp_path, monkeypatch):
    path, mfcc, emg = _jax_normalizers(tmp_path)
    ref_path = str(tmp_path / "reference.pkl")
    with monkeypatch.context() as m:
        _reference_normalizers(ref_path, mfcc, emg, m)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["silent_speech_tpu"] = None   # not importable
        sys.path.insert(0, {ROOT!r})
        from silent_speech_tpu_torch.data.normalizers import load_normalizers
        for p in ({path!r}, {ref_path!r}):
            mfcc, emg = load_normalizers(p)
            print(type(emg).__module__, float(emg.feature_stddevs.sum()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    want = f"silent_speech_tpu_torch.data.normalizers " \
           f"{float(emg.feature_stddevs.sum())}"
    assert out.stdout.split("\n")[:2] == [want, want]
    with open(ref_path, "rb") as f:
        with pytest.raises(ModuleNotFoundError):
            pickle.load(f)   # the default unpickler wants data_utils
