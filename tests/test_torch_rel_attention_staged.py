"""The plain mirror of the staged bf16 attention backward
(``rel_attention_bwd_staged_plain``, the arithmetic of
``csrc/rel_attention_bwd_wmma.cu``'s four stages) against autograd through
the plain forward and against the JAX ``fused_rel_attention`` VJP (the
Pallas kernel in interpret mode), at tiny sizes on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.ops.pallas.rel_attention import fused_rel_attention
from silent_speech_tpu_torch.ops.rel_attention import (
    attention_drop_threshold, rel_attention_bwd_staged_plain,
    rel_attention_plain, unskew)

SEED = 424242


def _inputs(b, h, t, dh, m, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, dh)).astype(np.float32) * scale
                  for _ in range(4))
    e = rng.normal(size=(h, 2 * m - 1, dh)).astype(np.float32) * scale
    return q, k, v, e, g


def _autograd(q, k, v, e, g, m, valid_len, thresh):
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, e)]
    rel_attention_plain(*xs, m, valid_len, SEED, thresh).backward(
        torch.from_numpy(g))
    return [x.grad for x in xs]


SHAPES = [
    (2, 2, 72, 16, 16, None),   # T above the window
    (1, 2, 24, 16, 16, None),   # T below it: the whole matrix in range
    (2, 2, 72, 16, 16, 50),     # an utterance of 50 frames and its padding
    (1, 2, 37, 16, 8, 20),      # T not a multiple of 16, a narrow band
]


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["nodrop", "drop"])
@pytest.mark.parametrize("b,h,t,dh,m,valid_len", SHAPES)
def test_staged_mirror_matches_autograd(rate, b, h, t, dh, m, valid_len):
    q, k, v, e, g = _inputs(b, h, t, dh, m)
    thresh = attention_drop_threshold(rate)
    ref = _autograd(q, k, v, e, g, m, valid_len, thresh)
    ours = rel_attention_bwd_staged_plain(
        *(torch.from_numpy(x) for x in (q, k, v, e, g)), m, valid_len, SEED,
        thresh)
    # float32 both; the same products grouped in another order
    for name, o, r in zip(("dq", "dk", "dv", "de"), ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * r.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["nodrop", "drop"])
@pytest.mark.parametrize("b,h,t,dh,m", [(2, 2, 72, 16, 16),
                                        (1, 2, 24, 16, 16)])
def test_staged_mirror_matches_pallas_vjp(rate, b, h, t, dh, m):
    q, k, v, e, g = _inputs(b, h, t, dh, m, seed=3)
    thresh = attention_drop_threshold(rate)

    def jax_out(q, k, v, e):
        return fused_rel_attention(q, k, v, e, jnp.asarray(SEED, jnp.int32),
                                   m, thresh)

    _, vjp = jax.vjp(jax_out, *(jnp.asarray(x) for x in (q, k, v, e)))
    ref = vjp(jnp.asarray(g))
    ours = rel_attention_bwd_staged_plain(
        *(torch.from_numpy(x) for x in (q, k, v, e, g)), m, None, SEED,
        thresh)
    # float32 on both sides; the sums run in another order
    for name, o, r in zip(("dq", "dk", "dv", "de"), ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("t,m", [(40, 8), (12, 8)])
def test_unskew_matches_a_direct_loop_at_the_edges(t, m):
    ds = torch.from_numpy(np.random.default_rng(t).normal(
        size=(2, t, t)).astype(np.float32))
    dr = unskew(ds, m)
    assert dr.shape == (2, t, 2 * m - 1)
    ref = torch.zeros_like(dr)
    for q in range(t):
        for r in range(2 * m - 1):
            key = q + r - (m - 1)
            if 0 <= key < t:
                ref[:, q, r] = ds[:, q, key]
    torch.testing.assert_close(dr, ref, rtol=0, atol=0)
    # q = 0: the slots before m − 1 reach keys below 0; q = T − 1: the
    # slots after m − 1 reach keys at or past T
    assert not dr[:, 0, :m - 1].any() and not dr[:, t - 1, m:].any()
    torch.testing.assert_close(dr[:, 0, m - 1], ds[:, 0, 0])
    torch.testing.assert_close(dr[:, t - 1, m - 1], ds[:, t - 1, t - 1])


@pytest.mark.parametrize("b,h,t,dh,m,valid_len", [(2, 2, 72, 16, 16, None),
                                                  (1, 2, 37, 16, 8, 20)])
def test_staged_mirror_with_bf16_scratch_stays_within_the_card_tolerance(
        b, h, t, dh, m, valid_len):
    q, k, v, e, g = _inputs(b, h, t, dh, m, seed=5)
    thresh = attention_drop_threshold(0.2)
    ref = _autograd(q, k, v, e, g, m, valid_len, thresh)
    grads, scratch = rel_attention_bwd_staged_plain(
        *(torch.from_numpy(x) for x in (q, k, v, e, g)), m, valid_len, SEED,
        thresh, store_dtype=torch.bfloat16, return_scratch=True)
    for x in scratch:       # the stored values are bf16 values
        torch.testing.assert_close(x, x.to(torch.bfloat16).float(), rtol=0,
                                   atol=0)
    for name, o, r in zip(("dq", "dk", "dv", "de"), grads, ref):
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-2 * r.abs().max().item(),
                                   msg=name)
