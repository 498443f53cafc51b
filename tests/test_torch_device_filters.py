"""The port's tensor ``filtfilt`` (``dsp/device_filters.py``) and the filter
chain (``ops/filtfilt.py``) against the JAX package's ``jax_filtfilt`` and
float64 scipy, on the CPU through the plain versions (the kernel is held to
them bit for bit on the card: ``test_torch_kernels_cuda.py``).

Tolerances, from a measured gap (numpy seed 0, 1500 × 8 samples of
σ = 100, max |x| ≈ 480):
- each notch, port vs JAX: the same float32 recurrence, but XLA's CPU code
  does not keep the scan's rounding: ≤ 1.8e-6 · max|x| measured, bound
  1e-5 · max|x|; vs float64 scipy ≤ 1.7e-6 · max|x|, the same bound;
- the 2 Hz high-pass has poles near 1, where float32 drifts: port vs JAX
  4.2e-3 · max|x|, vs scipy 4.8e-3 · max|x| measured, bound
  1e-2 · max|x| with a correlation above 0.9999;
- masked against unmasked on the valid prefix, and one launch against the
  same columns split: ``torch.equal`` (the same operations per column).
"""

import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

from silent_speech_tpu.dsp.jax_filters import jax_filtfilt, jax_filtfilt_masked
from silent_speech_tpu.dsp.jax_filters import lfilter_zi as jax_lfilter_zi
from silent_speech_tpu.dsp.jax_pipeline import _filter_coeffs, jax_clean_emg
from silent_speech_tpu_torch.dsp import device_filters
from silent_speech_tpu_torch.dsp.device_pipeline import clean_emg, \
    filter_coeffs
from silent_speech_tpu_torch.ops.filtfilt import (chain_padlen,
                                                  filtfilt_chain,
                                                  filtfilt_chain_plain)

from torch_port_util import one_torch_thread

COEFFS = filter_coeffs(1000.0, 60.0)
NOTCH_TOL = 1e-5      # × max|x|
HIGHPASS_TOL = 1e-2   # × max|x|
MIN_CORR = 0.9999


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def signal():
    return (np.random.default_rng(0).normal(size=(1500, 8))
            * 100).astype(np.float32)


def test_coefficients_are_jax_s():
    assert COEFFS == _filter_coeffs(1000.0, 60.0)
    assert [chain_padlen([c]) for c in COEFFS] == [9] * 7 + [12]


@pytest.mark.parametrize("k", range(8))
def test_lfilter_zi_matches_jax_and_scipy(k):
    b, a = COEFFS[k]
    np.testing.assert_array_equal(device_filters.lfilter_zi(b, a),
                                  jax_lfilter_zi(b, a))
    np.testing.assert_allclose(device_filters.lfilter_zi(b, a),
                               scipy.signal.lfilter_zi(b, a), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("k", range(8))
def test_filtfilt_matches_jax_and_scipy(signal, k):
    b, a = COEFFS[k]
    ours = device_filters.filtfilt(b, a, torch.from_numpy(signal)).numpy()
    jax = np.asarray(jax_filtfilt(b, a, jnp.asarray(signal)))
    ref = scipy.signal.filtfilt(b, a, signal.astype(np.float64), axis=0)
    scale = np.abs(signal).max()
    tol = (NOTCH_TOL if k < 7 else HIGHPASS_TOL) * scale
    assert np.abs(ours - jax).max() <= tol
    assert np.abs(ours - ref).max() <= tol
    if k == 7:
        assert np.corrcoef(ours.ravel(), jax.ravel())[0, 1] > MIN_CORR
        assert np.corrcoef(ours.ravel(), ref.ravel())[0, 1] > MIN_CORR


def test_one_dimensional_input(signal):
    b, a = COEFFS[0]
    x = torch.from_numpy(signal[:, 3].copy())
    torch.testing.assert_close(
        device_filters.filtfilt(b, a, x),
        device_filters.filtfilt(b, a, torch.from_numpy(signal))[:, 3],
        rtol=0, atol=0)


@pytest.mark.parametrize("k", [0, 7])
def test_masked_equals_unmasked_on_the_prefix(signal, k):
    b, a = COEFFS[k]
    lengths = torch.tensor([1500, 13, 700, 1001, 40, 1499, 512, 1500])
    buf = torch.zeros(1600, 8)
    for j, n in enumerate(lengths.tolist()):
        buf[:n, j] = torch.from_numpy(signal[:n, j])
    got = device_filters.filtfilt_masked_plain(b, a, buf, lengths)
    for j, n in enumerate(lengths.tolist()):
        want = device_filters.filtfilt_plain(b, a, buf[:n, j: j + 1])[:, 0]
        assert torch.equal(got[:n, j], want), (j, n)
        assert not got[n:, j].any()
    # JAX's masked filter over the same buffer at one of the lengths
    jax = np.asarray(jax_filtfilt_masked(b, a, jnp.asarray(buf.numpy()),
                                         700))
    scale = np.abs(signal).max()
    tol = (NOTCH_TOL if k < 7 else HIGHPASS_TOL) * scale
    assert np.abs(got[:700, 2].numpy() - jax[:700, 2]).max() <= tol


def test_the_chain_matches_jax_s_cleaning(signal):
    ours = clean_emg(torch.from_numpy(signal)).numpy()
    jax = np.asarray(jax_clean_emg(jnp.asarray(signal)))
    scale = np.abs(signal).max()
    assert np.abs(ours - jax).max() <= HIGHPASS_TOL * scale
    assert np.corrcoef(ours.ravel(), jax.ravel())[0, 1] > MIN_CORR


def test_the_chain_is_the_filters_in_turn_on_ragged_utterances(signal):
    lengths = torch.tensor([600, 13, 451])
    x = torch.zeros(3, 640, 8)
    for u, n in enumerate(lengths.tolist()):
        x[u, :n] = torch.from_numpy(signal[100 * u: 100 * u + n])
    got = filtfilt_chain(x, lengths, COEFFS)
    for u, n in enumerate(lengths.tolist()):
        want = x[u, :n]
        for b, a in COEFFS:
            want = device_filters.filtfilt_plain(b, a, want)
        assert torch.equal(got[u, :n], want), u
        assert not got[u, n:].any()


def test_results_do_not_depend_on_the_grouping(signal):
    lengths = torch.tensor([300, 13, 257, 100])
    x = torch.zeros(4, 320, 8)
    for u, n in enumerate(lengths.tolist()):
        x[u, :n] = torch.from_numpy(signal[200 * u: 200 * u + n])
    whole = filtfilt_chain(x, lengths, COEFFS)
    split = torch.cat([filtfilt_chain(x[:1], lengths[:1], COEFFS),
                       filtfilt_chain(x[1:], lengths[1:], COEFFS)])
    alone = filtfilt_chain(x[2:3, :257], lengths[2:3], COEFFS)
    assert torch.equal(whole, split)
    assert torch.equal(whole[2, :257], alone[0])
    assert torch.equal(whole, filtfilt_chain_plain(x, lengths, COEFFS))


def test_a_short_length_raises(signal):
    x = torch.from_numpy(signal[:100])[None]
    for n in (12, 0):      # the high-pass's padlen is 12
        with pytest.raises(ValueError, match="padlen 12"):
            filtfilt_chain(x, torch.tensor([n]), COEFFS)
    with pytest.raises(ValueError, match="padlen 9"):
        filtfilt_chain(x, torch.tensor([9]), COEFFS[:1])
    filtfilt_chain(x, torch.tensor([10]), COEFFS[:1])       # 3·3 + 1
    with pytest.raises(ValueError, match="at most T_pad"):
        filtfilt_chain(x, torch.tensor([101]), COEFFS)
    with pytest.raises(ValueError, match="more than 9 samples"):
        device_filters.filtfilt(*COEFFS[0], torch.zeros(9, 2))


def test_other_devices_and_dtypes_are_refused(signal):
    x = torch.from_numpy(signal[:100])[None]
    with pytest.raises(ValueError, match="float32"):
        filtfilt_chain(x.double(), torch.tensor([100]), COEFFS)
    with pytest.raises(ValueError, match="no filtfilt_chain for device"):
        filtfilt_chain(x.to("meta"), torch.tensor([100]), COEFFS)
