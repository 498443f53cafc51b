"""The port's transduction loss and packing vs the JAX package: loss value,
phoneme hits, confusion matrix and gradients of ``transduction_loss`` on
the same ``pack_batch`` output, with and without silent utterances."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.data.packing import pack_batch as jax_pack_batch
from silent_speech_tpu.train.losses import (
    pairwise_l2 as jax_pairwise_l2, transduction_loss as jax_loss)
from silent_speech_tpu_torch.data.packing import pack_batch
from silent_speech_tpu_torch.train.losses import (
    pairwise_l2, transduction_loss)
from silent_speech_tpu_torch.train.transduction import upload


def _example(rng, t, silent):
    ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
          "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
          "session_ids": np.zeros(t, np.int64), "silent": silent,
          "text": "a test", "text_int": rng.integers(0, 37, size=12)}
    tt = int(t * rng.uniform(0.9, 1.15)) if silent else t
    key = "parallel_voiced_audio_features" if silent else "audio_features"
    ex[key] = rng.normal(size=(tt, 80)).astype(np.float32)
    ex["phonemes"] = rng.integers(0, 48, size=tt)
    return ex


def _examples(seed, silent_pattern):
    rng = np.random.default_rng(seed)
    return [_example(rng, int(rng.integers(20, 90)), s)
            for s in silent_pattern]


MIXED = (True, False, True, False, False, True, False)   # 3 silent
VOICED = (False,) * 5


def test_pack_batch_is_the_jax_one():
    examples = _examples(0, MIXED)
    kw = dict(seq_len=50, chunk_bucket=4, fixed_chunks=12, fixed_utts=16,
              fixed_t=128)
    ours, ref = pack_batch(examples, **kw), jax_pack_batch(examples, **kw)
    for name in ("emg", "raw_emg", "session_ids", "segment_ids",
                 "utt_gather_idx", "utt_len", "target_len", "phonemes",
                 "silent", "text_int", "text_len", "audio_features"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name), err_msg=name)
    assert ours.num_silent == ref.num_silent == 4
    assert ours.texts == ref.texts


def test_pairwise_l2_matches_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(3, 17, 80)).astype(np.float32)
            for _ in range(2))
    ref = jax_pairwise_l2(jnp.asarray(a), jnp.asarray(b))
    ours = pairwise_l2(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("pattern", [MIXED, VOICED], ids=["mixed",
                                                           "voiced"])
def test_loss_hits_confusion_and_gradients_match_jax(pattern):
    batch = pack_batch(_examples(2, pattern), seq_len=50, chunk_bucket=4)
    rng = np.random.default_rng(3)
    n, l = batch.emg.shape[:2]
    pred = rng.normal(size=(n, l, 80)).astype(np.float32)
    phone = rng.normal(size=(n, l, 48)).astype(np.float32)
    jb = jax_pack_batch(_examples(2, pattern), seq_len=50, chunk_bucket=4)
    ns = batch.num_silent
    assert ns == jb.num_silent == (4 if pattern == MIXED else 0)

    def jax_fn(pred, phone):
        out = jax_loss(pred, phone, jb.device_batch(), 0.5,
                       phoneme_eval=True, n_silent=ns)
        return out.loss, out

    (_, ref), ref_grads = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(pred),
                                              jnp.asarray(phone))
    tp, tph = (torch.from_numpy(x).requires_grad_() for x in (pred, phone))
    out = transduction_loss(tp, tph, upload(batch, torch.device("cpu")),
                            0.5, phoneme_eval=True, n_silent=ns)
    out.loss.backward()
    # float32 on both sides; sums over ~500 frames in another order
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), rtol=1e-5)
    assert int(out.correct_phones) == int(ref.correct_phones)
    assert int(out.total_length) == int(ref.total_length)
    np.testing.assert_array_equal(out.confusion.numpy(),
                                  np.asarray(ref.confusion))
    for name, t, r in (("pred", tp, ref_grads[0]),
                       ("phone", tph, ref_grads[1])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-6,
                                   err_msg=name)


def test_silent_slice_equals_the_full_dp():
    batch = pack_batch(_examples(4, MIXED), seq_len=50, chunk_bucket=4)
    rng = np.random.default_rng(5)
    n, l = batch.emg.shape[:2]
    pred = torch.from_numpy(rng.normal(size=(n, l, 80)).astype(np.float32))
    phone = torch.from_numpy(rng.normal(size=(n, l, 48)).astype(np.float32))
    db = upload(batch, torch.device("cpu"))
    sliced = transduction_loss(pred, phone, db, n_silent=batch.num_silent)
    full = transduction_loss(pred, phone, db, n_silent=None)
    torch.testing.assert_close(sliced.loss, full.loss, rtol=1e-6, atol=0)
    assert int(sliced.correct_phones) == int(full.correct_phones)
