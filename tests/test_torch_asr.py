"""The port's ASR judge (``eval/asr.py``) against the JAX package's, with a
fake ``deepspeech`` module in ``sys.modules`` (the real 0.7.0 runtime and
its model files are not installable here) and stub Hugging Face objects.
Both sides must send DeepSpeech the same int16 samples, read the same
transcripts and give the same WER, exactly."""

import inspect
import logging
import sys
import types

import numpy as np
import pytest
import torch

from silent_speech_tpu.eval import asr as jax_asr
from silent_speech_tpu_torch.eval import asr
from silent_speech_tpu_torch.utils.audio_io import write_wav

TARGETS = ["Hello, world!", "the cat sat", "silent speech decoding",
           "Crème brûlée"]
# exact, one substitution, a case-only difference, an accent dropped
TRANSCRIPTS = ["hello world", "the dog sat", "Silent speech decoding",
               "creme brulee"]


class _FakeModel:
    def __init__(self, model_path):
        self.model_path = model_path
        self.scorer_path = None
        self.stt_calls = []

    def enableExternalScorer(self, scorer_path):
        self.scorer_path = scorer_path

    def sampleRate(self):
        return 16000

    def stt(self, audio_int16):
        self.stt_calls.append(audio_int16)
        return TRANSCRIPTS[(len(self.stt_calls) - 1) % len(TRANSCRIPTS)]


@pytest.fixture
def fake_deepspeech(monkeypatch):
    mod = types.ModuleType("deepspeech")
    mod.Model = _FakeModel
    monkeypatch.setitem(sys.modules, "deepspeech", mod)
    return mod


@pytest.fixture
def no_deepspeech(monkeypatch):
    # a None entry makes `import deepspeech` raise ImportError
    monkeypatch.setitem(sys.modules, "deepspeech", None)


@pytest.fixture
def wavs(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(len(TARGETS)):
        write_wav(str(tmp_path / f"example_output_{i}.wav"),
                  (0.1 * rng.standard_normal(22050 + 500 * i)).astype(
                      np.float32), 22050)
    return str(tmp_path), [{"text": t} for t in TARGETS]


def test_the_constructor_reads_the_model_and_an_existing_scorer(
        fake_deepspeech, tmp_path):
    scorer = tmp_path / "s.scorer"
    scorer.write_bytes(b"fake")
    judge = asr.DeepSpeechASR(model_path="some.pbmm",
                              scorer_path=str(scorer))
    assert judge.model.model_path == "some.pbmm"
    assert judge.model.scorer_path == str(scorer)
    judge = asr.DeepSpeechASR(model_path="m.pbmm",
                              scorer_path=str(tmp_path / "absent"))
    assert judge.model.scorer_path is None


@pytest.mark.parametrize("rate", [22050, 16000])
def test_transcribe_sends_jax_s_samples(fake_deepspeech, rate):
    t = np.arange(rate) / rate
    audio = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    ours = asr.DeepSpeechASR(model_path="m", scorer_path="")
    theirs = jax_asr.DeepSpeechASR(model_path="m", scorer_path="")
    assert ours.transcribe(audio, rate) == theirs.transcribe(audio, rate)
    (a,), (b,) = ours.model.stt_calls, theirs.model.stt_calls
    assert a.dtype == np.int16
    assert abs(len(a) - 16000) <= 2
    np.testing.assert_array_equal(a, b)


def test_evaluate_matches_jax(fake_deepspeech, wavs, caplog):
    directory, testset = wavs
    ours_judge = asr.DeepSpeechASR(model_path="m", scorer_path="")
    theirs_judge = jax_asr.DeepSpeechASR(model_path="m", scorer_path="")
    with caplog.at_level(logging.INFO):
        ours = asr.evaluate(testset, directory, asr=ours_judge)
    ours_log = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.INFO):
        theirs = jax_asr.evaluate(testset, directory, asr=theirs_judge)
    assert ours == theirs and 0.0 < ours < 0.5
    assert ours_log == [r.getMessage() for r in caplog.records]
    assert "predictions: ['hello world', 'the dog sat', 'silent speech " \
        "decoding', 'creme brulee']" in ours_log
    for a, b in zip(ours_judge.model.stt_calls, theirs_judge.model.stt_calls):
        np.testing.assert_array_equal(a, b)
    # the default judge is DeepSpeech's
    assert asr.evaluate(testset, directory) == ours


def test_a_missing_deepspeech_raises_jax_s_import_error(no_deepspeech):
    with pytest.raises(ImportError) as ours:
        asr.DeepSpeechASR()
    with pytest.raises(ImportError) as theirs:
        jax_asr.DeepSpeechASR()
    assert str(ours.value) == str(theirs.value)
    assert "deepspeech==0.7.0" in str(ours.value)


def test_evaluate_if_installed(no_deepspeech, wavs, caplog):
    directory, testset = wavs
    with caplog.at_level(logging.WARNING):
        assert asr.evaluate_if_installed(testset, directory) is None
    assert "ASR WER skipped" in caplog.text and directory in caplog.text


def test_evaluate_if_installed_returns_the_wer(fake_deepspeech, wavs):
    directory, testset = wavs
    assert asr.evaluate_if_installed(testset, directory) == \
        jax_asr.evaluate(testset, directory)


class _Processor:
    def __init__(self):
        self.calls = []

    def __call__(self, audio, sampling_rate, return_tensors):
        self.calls.append((np.asarray(audio), sampling_rate))
        return types.SimpleNamespace(
            input_values=torch.as_tensor(np.asarray(audio, np.float32))[None])

    def decode(self, ids):
        return "".join("AB"[int(i) % 2] for i in ids)


class _Model(torch.nn.Module):
    def forward(self, x):
        # 4 "frames" of 2 classes from the signal's sign pattern
        frames = x[:, : 4 * (x.shape[1] // 4)].reshape(1, 4, -1).mean(-1)
        return types.SimpleNamespace(
            logits=torch.stack([frames, -frames], -1))


def test_transformers_judge_with_stub_objects_matches_jax():
    rng = np.random.default_rng(1)
    audio = rng.normal(size=22050).astype(np.float32)
    p_ours, p_theirs = _Processor(), _Processor()
    ours = asr.TransformersASR(device="cpu", model=_Model(),
                               processor=p_ours)
    theirs = jax_asr.TransformersASR(device="cpu", model=_Model(),
                                     processor=p_theirs)
    text = ours.transcribe(audio, 22050)
    assert text == theirs.transcribe(audio, 22050)
    assert text == text.lower() and len(text) == 4
    np.testing.assert_array_equal(p_ours.calls[0][0], p_theirs.calls[0][0])
    assert p_ours.calls[0][1] == 16000
    # the port's judge runs on the card unless told otherwise
    assert inspect.signature(asr.TransformersASR).parameters[
        "device"].default == "cuda"
