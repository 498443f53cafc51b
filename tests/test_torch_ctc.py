"""The port's CTC loss against the JAX package's ``ctc_loss``
(``optax.ctc_loss``) on seeded packed batches with padding utterances:
the loss, and its gradient at the packed logits (the log-softmax the
trainers take first included); and ``ops/ctc.py`` on its own: the plain
version's per-utterance NLL against optax's (padding rows, repeats, a last
label of 0, an infeasible row), and the plain mirror of the kernel's
explicit backward against autograd."""

from typing import NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from silent_speech_tpu.train.losses import ctc_loss as jax_ctc_loss
from silent_speech_tpu_torch.ops.ctc import (ctc_grad_plain, ctc_nll,
                                             ctc_nll_plain)
from silent_speech_tpu_torch.train.losses import ctc_loss

BLANK = 37
# float32 on both sides, the same recursion in another order. Measured
# on these batches: the loss within 1.0e-7 relative, the gradient within
# 6.1e-6 absolute (its largest entries 0.06-0.25)
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5


class Batch(NamedTuple):
    utt_gather_idx: object
    utt_len: object
    text_int: object
    text_len: object


def _batch(seed, n_chunks=4, seq_len=40, lens=(35, 50, 21, 40),
           n_pad=2, text_cap=32):
    """Logits of ``n_chunks`` packed chunks and the views of utterances of
    ``lens`` frames packed end to end, then ``n_pad`` padding rows."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n_chunks, seq_len, BLANK + 1)).astype(
        np.float32) * 2
    u = len(lens) + n_pad
    t_max = max(lens) + 4
    gather = np.zeros((u, t_max), np.int32)
    utt_len = np.zeros(u, np.int32)
    text = np.full((u, text_cap), -1, np.int32)
    text_len = np.zeros(u, np.int32)
    start = 0
    for i, t in enumerate(lens):
        gather[i] = np.minimum(start + np.arange(t_max),
                               n_chunks * seq_len - 1)
        utt_len[i] = t
        n = int(rng.integers(1, max(t // 3, 2)))   # room for repeats
        text[i, :n] = rng.integers(0, BLANK, size=n)
        text_len[i] = n
        start += t
    return logits, Batch(gather, utt_len, text, text_len)


def _jax(logits, batch):
    jb = Batch(*(jnp.asarray(x) for x in batch))

    def loss_fn(x):
        return jax_ctc_loss(jax.nn.log_softmax(x, axis=-1), jb, BLANK)

    loss, grad = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _port(logits, batch):
    x = torch.from_numpy(logits).requires_grad_()
    tb = Batch(*(torch.from_numpy(a) for a in batch))
    loss = ctc_loss(torch.log_softmax(x, dim=-1), tb, BLANK)
    loss.backward()
    return loss, x.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_matches_jax(seed):
    logits, batch = _batch(seed)
    ref, ref_grad = _jax(logits, batch)
    loss, grad = _port(logits, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert loss.item() == pytest.approx(ref, rel=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=GRAD_ATOL)


def test_padding_rows_do_not_count():
    logits, batch = _batch(3, n_pad=0)
    _, padded = _batch(3, n_pad=3)
    assert _port(logits, batch)[0].item() == _port(logits, padded)[0].item()


def test_ctc_loss_matches_jax_per_utterance():
    # one utterance a batch: the normalization by the text length alone
    logits, batch = _batch(4)
    for i in range(4):
        one = Batch(*(np.ascontiguousarray(x[i: i + 1]) for x in batch))
        assert _port(logits, one)[0].item() == pytest.approx(
            _jax(logits, one)[0], rel=LOSS_RTOL)


def test_an_impossible_alignment_gives_jax_s_finite_loss():
    # 5 labels, no repeats, over 4 frames: no CTC path exists. optax clamps
    # log 0 at its log-epsilon and returns a large finite value; the port's
    # CTC runs the same clamped lattice and returns the same value and
    # gradient (the loss is ~1e5, so it is compared relatively)
    logits, batch = _batch(5, lens=(4,), n_pad=0)
    batch.text_int[0, :5] = [1, 2, 3, 4, 5]
    batch.text_len[0] = 5
    ref, ref_grad = _jax(logits, batch)
    loss, grad = _port(logits, batch)
    assert np.isfinite(ref) and ref > 1e4
    assert np.isfinite(loss.item())
    assert loss.item() == pytest.approx(ref, rel=NLL_RTOL)
    np.testing.assert_allclose(grad, ref_grad, rtol=0,
                               atol=GRAD_ATOL * np.abs(ref_grad).max())


# ---- ops/ctc.py on its own: optax's per-utterance NLL ----------------------

# float32 on both sides, the same operations in the same order (only exp
# and log1p are other implementations). Measured on these cases: the NLL
# within 9e-8 relative, infeasible rows (~1e5) included; the gradient at
# the logits within 3.8e-6 of its largest entry
NLL_RTOL = 1e-6


def _lattice_case(seed, repeat=False, last_zero=False, infeasible=False,
                  no_labels=False):
    """(U=5, T=30, K=38) logits, per-row frame and label counts (the last
    row a padding row: no frames, no labels) and labels padded with −1.
    With ``no_labels``, row 3 keeps its frames and has no labels."""
    rng = np.random.default_rng(seed)
    u, t, s = 5, 30, 12
    logits = (rng.normal(size=(u, t, BLANK + 1)) * 2).astype(np.float32)
    utt_len = rng.integers(5, t + 1, size=u)
    utt_len[-1] = 0
    text_len = np.array([min(int(rng.integers(1, s + 1)), max(n // 3, 1))
                         for n in utt_len])
    text_len[-1] = 0
    labels = np.full((u, s), -1, np.int64)
    for i in range(u):
        labels[i, :text_len[i]] = rng.integers(0, BLANK, size=text_len[i])
    if repeat:
        labels[0, 1] = labels[0, 0]
    if last_zero:   # a repeat of the padding, in optax's padded row
        labels[1, text_len[1] - 1] = 0
    if infeasible:
        utt_len[2], text_len[2] = 4, 5
        labels[2] = -1
        labels[2, :5] = [1, 2, 3, 4, 5]
    if no_labels:
        text_len[3] = 0
        labels[3] = -1
    return logits, utt_len, labels, text_len


def _optax_nll(logits, utt_len, labels, text_len):
    """Per-row NLL and the gradient of Σ NLL over the rows with labels,
    at the logits (log-softmaxed before optax, as the trainers do)."""
    t, s = logits.shape[1], labels.shape[1]
    real = (text_len > 0).astype(np.float32)

    def nll(x):
        pad = (jnp.arange(t)[None] >= utt_len[:, None]).astype(jnp.float32)
        lpad = (jnp.arange(s)[None] >= text_len[:, None]).astype(
            jnp.float32)
        return optax.ctc_loss(jax.nn.log_softmax(x), pad,
                              jnp.maximum(labels, 0), lpad, blank_id=BLANK)

    x = jnp.asarray(logits)
    grad = jax.grad(lambda v: jnp.sum(nll(v) * real))(x)
    return np.asarray(nll(x)), np.asarray(grad)


def _port_nll(logits, utt_len, labels, text_len):
    x = torch.from_numpy(logits).requires_grad_()
    nll = ctc_nll(torch.log_softmax(x, -1), torch.from_numpy(utt_len),
                  torch.from_numpy(labels), torch.from_numpy(text_len),
                  BLANK)
    (nll * torch.from_numpy(text_len > 0)).sum().backward()
    return nll.detach().numpy(), x.grad.numpy()


LATTICE_CASES = {"plain": {}, "repeat_and_last_zero": dict(
    repeat=True, last_zero=True), "infeasible": dict(infeasible=True),
    "all": dict(repeat=True, last_zero=True, infeasible=True),
    "no_labels": dict(no_labels=True)}


@pytest.mark.parametrize("case", list(LATTICE_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_nll_matches_optax(case, seed):
    args = _lattice_case(seed, **LATTICE_CASES[case])
    ref, ref_grad = _optax_nll(*args)
    nll, grad = _port_nll(*args)
    assert np.isfinite(nll).all() and nll.dtype == np.float32
    np.testing.assert_allclose(nll, ref, rtol=NLL_RTOL, atol=0)
    if case in ("infeasible", "all"):
        assert nll[2] > 1e4
    np.testing.assert_allclose(grad, ref_grad, rtol=0,
                               atol=GRAD_ATOL * np.abs(ref_grad).max())


@pytest.mark.parametrize("case", list(LATTICE_CASES))
def test_the_kernel_s_backward_recursion_matches_autograd(case):
    # ctc_grad_plain is the kernel's explicit backward (the reverse
    # recursion on the cotangents, then the occupancies summed by label);
    # autograd of the plain forward is the oracle. The same float32
    # operations in another grouping: measured within 6e-8 of the largest
    # entry (~1)
    logits, utt_len, labels, text_len = _lattice_case(
        7, **LATTICE_CASES[case])
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    args = (torch.from_numpy(utt_len), torch.from_numpy(labels),
            torch.from_numpy(text_len))
    x = lp.clone().requires_grad_()
    ctc_nll_plain(x, *args, BLANK).sum().backward()
    mirror = ctc_grad_plain(lp, *args, BLANK)
    scale = x.grad.abs().max().item()
    assert (mirror - x.grad).abs().max().item() <= 1e-6 * scale
    # frames past a row's length: exact zeros; a row without labels (NLL
    # −Σ_t lp[t, blank]): exactly −1 at each live frame's blank, 0 elsewhere
    for i in range(len(utt_len)):
        assert not mirror[i, utt_len[i]:].any()
        if text_len[i] == 0:
            live = mirror[i, :utt_len[i]]
            assert (live[:, BLANK] == -1).all()
            assert not live[:, :BLANK].any()


def test_the_kernel_s_backward_of_rows_without_labels_matches_jax():
    # rows with frames and no labels beside rows with labels, each row
    # weighted: ctc_grad_plain, taken through the log-softmax by autograd,
    # against jax.grad of the weighted sum of optax's loss at the logits
    logits, utt_len, labels, text_len = _lattice_case(9, no_labels=True)
    text_len[1], labels[1] = 0, -1
    assert (utt_len[[1, 3]] > 0).all() and (text_len[[1, 3]] == 0).all()
    weights = np.random.default_rng(10).uniform(
        0.5, 2.0, size=len(utt_len)).astype(np.float32)
    t, s = logits.shape[1], labels.shape[1]

    def weighted(x):
        pad = (jnp.arange(t)[None] >= utt_len[:, None]).astype(jnp.float32)
        lpad = (jnp.arange(s)[None] >= text_len[:, None]).astype(
            jnp.float32)
        return jnp.sum(weights * optax.ctc_loss(
            jax.nn.log_softmax(x), pad, jnp.maximum(labels, 0), lpad,
            blank_id=BLANK))

    ref_grad = np.asarray(jax.grad(weighted)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    lp = torch.log_softmax(x, -1)
    mirror = ctc_grad_plain(lp.detach(), torch.from_numpy(utt_len),
                            torch.from_numpy(labels),
                            torch.from_numpy(text_len), BLANK)
    lp.backward(mirror * torch.from_numpy(weights)[:, None, None])
    grad = x.grad.numpy()
    np.testing.assert_allclose(grad, ref_grad, rtol=0,
                               atol=GRAD_ATOL * np.abs(ref_grad).max())
    assert np.abs(ref_grad[[1, 3]]).max() > 0.5    # the rows carry weight


def test_ctc_nll_checks_its_inputs():
    lp = torch.zeros((2, 5, 4))
    ok = (torch.tensor([5, 5]), torch.zeros((2, 3), dtype=torch.long),
          torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="blank"):
        ctc_nll(lp, *ok, 4)
    with pytest.raises(ValueError, match="utt_len"):
        ctc_nll(lp, torch.tensor([5]), *ok[1:], 3)
    with pytest.raises(ValueError, match="device"):
        ctc_nll(lp.to("meta"), *(x.to("meta") for x in ok), 3)
