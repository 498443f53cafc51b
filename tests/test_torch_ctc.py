"""The port's CTC loss against the JAX package's ``ctc_loss``
(``optax.ctc_loss``) on seeded packed batches with padding utterances:
the loss, and its gradient at the packed logits (the log-softmax the
trainers take first included)."""

from typing import NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.train.losses import ctc_loss as jax_ctc_loss
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


def test_an_impossible_alignment_is_inf_here_and_finite_in_jax():
    # 5 labels, no repeats, over 4 frames: no CTC path exists. optax clamps
    # log 0 at its log-epsilon and returns a large finite value; torch's
    # ctc_loss returns inf. The port keeps torch's answer (an inf epoch
    # loss raises in fit()), where JAX trains on the sentinel.
    logits, batch = _batch(5, lens=(4,), n_pad=0)
    batch.text_int[0, :5] = [1, 2, 3, 4, 5]
    batch.text_len[0] = 5
    ref, _ = _jax(logits, batch)
    loss, _ = _port(logits, batch)
    assert np.isfinite(ref) and ref > 1e4
    assert loss.item() == float("inf")
