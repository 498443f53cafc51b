"""The port's tensor featurization (``dsp/device_pipeline.py``) against the
JAX package's ``jax_pipeline``, on the CPU.

Tolerances, from a measured gap (numpy seed 0; 1500 × 8 raw samples of
σ = 100, 1.5 s of audio of σ = 0.1):
- ``subsample``: the same float32 steps, equal (measured 0);
- ``get_emg_features`` on one input: float32 sums in another order, 1.2e-4
  at values up to 750 measured; bound atol 1e-3, rtol 1e-5;
- ``featurize_utterance``: the high-pass's float32 drift (see
  ``test_torch_device_filters.py``) carries into everything after it: the
  raw output 1.85 at max 313 measured, bound 1e-2 · max|x| with a
  correlation above 0.9999; each feature column within 5e-2 of its
  largest value (2.3e-2 measured), correlation above 0.9999; the log-mel
  (no filter) 1.7e-6 measured, bound 1e-4; every shape equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from silent_speech_tpu.dsp.emg_features import jax_get_emg_features
from silent_speech_tpu.dsp.jax_pipeline import (featurize_utterance_jax,
                                                jax_subsample)
from silent_speech_tpu_torch.dsp.device_pipeline import (
    featurize_utterance, get_emg_features, subsample)

from torch_port_util import one_torch_thread

MIN_CORR = 0.9999


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return ((rng.normal(size=(1500, 8)) * 100).astype(np.float32),
            (rng.normal(size=33075) * 0.1).astype(np.float32))


@pytest.mark.parametrize("rate", [689.06, 516.79])
def test_subsample_is_jax_s(inputs, rate):
    raw, _ = inputs
    np.testing.assert_array_equal(
        subsample(torch.from_numpy(raw), rate, 1000.0).numpy(),
        np.asarray(jax_subsample(jnp.asarray(raw), rate, 1000.0)))


def test_emg_features_match_jax(inputs):
    raw, _ = inputs
    emg = np.asarray(jax_subsample(jnp.asarray(raw), 516.79, 1000.0))
    ours = get_emg_features(torch.from_numpy(emg.copy())).numpy()
    ref = np.asarray(jax_get_emg_features(jnp.asarray(emg)))
    assert ours.shape == ref.shape == (1 + (emg.shape[0] - 16) // 6, 112)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)


def test_featurize_utterance_matches_jax(inputs):
    raw, audio = inputs
    r, f, m = featurize_utterance(torch.from_numpy(raw),
                                  torch.from_numpy(audio))
    jr, jf, jm = map(np.asarray, featurize_utterance_jax(
        jnp.asarray(raw), jnp.asarray(audio)))
    r, f, m = r.numpy(), f.numpy(), m.numpy()
    assert (r.shape, f.shape, m.shape) == (jr.shape, jf.shape, jm.shape)
    assert np.abs(r - jr).max() <= 1e-2 * np.abs(raw).max()
    assert np.corrcoef(r.ravel(), jr.ravel())[0, 1] > MIN_CORR
    assert (np.abs(f - jf) <= 5e-2 * np.abs(jf).max(0)).all()
    assert np.corrcoef(f.ravel(), jf.ravel())[0, 1] > MIN_CORR
    np.testing.assert_allclose(m, jm, rtol=0, atol=1e-4)


def test_without_audio_there_is_no_mel(inputs):
    raw, _ = inputs
    r, f, m = featurize_utterance(torch.from_numpy(raw))
    assert m is None and r.shape == (8 * f.shape[0], 8)
