"""The port's streaming surface (``eval/streaming.py``) and synthetic board
(``capture/recorder.py``) against the JAX package's, at the tiny geometry
in float32 from the same converted weights, on the CPU. In its own file:
the JAX trainer switches the process to the ``rbg`` PRNG. The
synthesizer's twin is ``test_torch_streaming_synthesis.py``.

Compared: ``featurize_raw_window`` bit for bit (the same float64 host
code); the streamed transcript exactly, against JAX's streamed transcript
and the offline greedy decode of the same samples; the log-probs of one
window to ``LOGPROB_ATOL`` (a padded f32 forward, XLA's segment mask
against the port's length mask: the serving tests' 1e-4); the synthetic
board's samples exactly, for one seed and one clock.
"""

import time

import numpy as np
import pytest

import jax

from silent_speech_tpu.capture.recorder import SyntheticBoard as JaxBoard
from silent_speech_tpu.config import Config
from silent_speech_tpu.data.normalizers import \
    FeatureNormalizer as JaxNormalizer
from silent_speech_tpu.eval import streaming as jax_streaming
from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
from silent_speech_tpu.parallel.mesh import make_mesh
from silent_speech_tpu_torch.capture.recorder import SyntheticBoard
from silent_speech_tpu_torch.data.normalizers import FeatureNormalizer
from silent_speech_tpu_torch.eval import streaming
from silent_speech_tpu_torch.eval.decode import greedy_ctc_decode
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer

from torch_port_util import (TINY, jax_prng_impl_restored, one_torch_thread,
                             random_variables, tiny_config)

LOGPROB_ATOL = 1e-4


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
def recognizers():
    from silent_speech_tpu.train.recognition import \
        RecognitionTrainer as JaxTrainer

    variables = random_variables(JaxEncoder(
        num_outs=38, num_aux_outs=None, dropout=0.0, fused_attention=False,
        shift_augment=False, **TINY), seed=6)
    jt = JaxTrainer(_jax_config(),
                    mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
    jt.init_state(jt._pack([_warm_example()]), seed=0)
    jt.state = jt.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    ours = RecognitionTrainer(tiny_config(), device="cpu")
    ours.init_state(0)
    ours.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    return ours, jt


def _chunks(x, seed, lo, hi):
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(x):
        n = int(rng.uniform(lo, hi))
        yield x[pos: pos + n]
        pos += n


@pytest.mark.parametrize("n,remove", [(3000, ()), (1234, (2, 5)),
                                      (40, ()), (57, ())])
def test_featurize_raw_window_is_jax_s(n, remove):
    x = np.random.default_rng(n).normal(size=(n, 8)) * 30
    norm = FeatureNormalizer([np.random.default_rng(1).normal(
        size=(50, 112))])
    jnorm = JaxNormalizer([np.random.default_rng(1).normal(size=(50, 112))])
    ours = streaming.featurize_raw_window(x, norm, 3, remove)
    theirs = jax_streaming.featurize_raw_window(x, jnorm, 3, remove)
    if theirs is None:
        assert ours is None
        return
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_streamed_transcript_matches_jax_and_the_offline_decode(
        recognizers):
    ours, jt = recognizers
    x = np.random.default_rng(2).normal(size=(2600, 8)) * 30
    ours_stream = streaming.StreamingRecognizer(ours, hop_s=0.5)
    jax_stream = jax_streaming.StreamingRecognizer(jt, hop_s=0.5)
    for chunk in _chunks(x, 3, 200, 900):
        ours_stream.feed(chunk)
        jax_stream.feed(chunk)
        assert ours_stream.transcript() == jax_stream.transcript()
    text = ours_stream.transcript(force=True)
    assert text == jax_stream.transcript(force=True)
    ex = streaming.featurize_raw_window(x)
    lp = ours.predict_logits(ex)
    np.testing.assert_allclose(lp, np.asarray(jt.predict_logits(ex)),
                               rtol=0, atol=LOGPROB_ATOL)
    assert text == ours.text_transform.int_to_text(
        greedy_ctc_decode(lp, ours.blank_id))
    assert text      # a random model still emits characters


def test_the_window_is_bounded(recognizers):
    ours, _ = recognizers
    stream = streaming.StreamingRecognizer(ours, hop_s=0.25,
                                           max_window_s=2.0)
    stream.feed(np.zeros((5000, 8)))
    assert stream.buffered_samples == 2000
    assert stream.transcript() == stream.transcript(force=True)
    x = np.random.default_rng(5).normal(size=(900, 8))
    stream.feed(x)
    np.testing.assert_array_equal(stream._buf[-900:], x)
    assert stream.buffered_samples == 2000


def test_a_recompute_waits_for_a_hop(recognizers):
    ours, _ = recognizers
    stream = streaming.StreamingRecognizer(ours, hop_s=0.5)
    calls = []
    stream.trainer = type("Spy", (), {
        "predict_logits": lambda self, ex: calls.append(ex) or
        ours.predict_logits(ex),
        "blank_id": ours.blank_id, "text_transform": ours.text_transform,
        "model": ours.model})()
    stream.feed(np.random.default_rng(6).normal(size=(499, 8)))
    stream.transcript()
    assert not calls                       # 499 < one hop of 500
    stream.feed(np.zeros((1, 8)))
    stream.transcript()
    stream.transcript()
    assert len(calls) == 1


def test_a_stream_needs_a_model():
    with pytest.raises(RuntimeError, match="no model"):
        streaming.StreamingRecognizer(
            RecognitionTrainer(tiny_config(), device="cpu"))


def test_the_synthetic_board_draws_jax_s_samples(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    ours, theirs = SyntheticBoard(seed=3), JaxBoard(seed=3)
    ours.start_stream()
    theirs.start_stream()
    for now in (100.3, 100.3, 100.75, 101.2049, 102.0):
        clock[0] = now
        a, b = ours.get_board_data(), theirs.get_board_data()
        assert a.shape == b.shape and a.shape[0] == 9
        np.testing.assert_array_equal(a, b)
    assert ours._consumed == 2000
    ours.stop_stream()
    with pytest.raises(RuntimeError, match="not started"):
        ours.get_board_data()


def test_the_demo_runs_on_the_cpu(capsys):
    text = streaming.main(["--seconds", "0.6", "--hop_s", "0.2",
                           "--device", "cpu"])
    assert isinstance(text, str)
    assert "s]" in capsys.readouterr().out


def test_the_demo_loads_a_full_width_model_strictly(tmp_path):
    import torch

    from silent_speech_tpu_torch.config import ModelConfig
    from silent_speech_tpu_torch.models.encoder import EMGEncoder

    small = EMGEncoder(38, None, tiny_config()).init_weights(
        torch.Generator().manual_seed(0))
    torch.save(small.state_dict(), tmp_path / "small.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        streaming.demo_trainer(str(tmp_path / "small.pt"), "cpu")
    trainer = streaming.demo_trainer("", "cpu")
    assert trainer.model_cfg.model_size == 64
    assert ModelConfig().model_size == 768
