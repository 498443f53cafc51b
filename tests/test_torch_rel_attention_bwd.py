"""The port's attention with dropout and its gradients vs the JAX
``fused_rel_attention`` (the Pallas kernel in interpret mode, its own
custom VJP): the counter hash draws the same mask on both sides, so the
outputs and gradients agree to float32 rounding, dropout on or off."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.ops.pallas.rel_attention import (
    _hash_bits, fused_rel_attention)
from silent_speech_tpu_torch.ops.dropout import hash_bits
from silent_speech_tpu_torch.ops.rel_attention import (
    attention_drop_threshold, attention_keep, rel_attention,
    rel_attention_bwd, rel_attention_plain)

RATE = 0.2
SEED = 1234567


def _inputs(b, h, t, dh, m, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, dh)).astype(np.float32) * scale
                  for _ in range(4))
    e = rng.normal(size=(h, 2 * m - 1, dh)).astype(np.float32) * scale
    return q, k, v, e, g


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 0xFFFFFFFF])
def test_hash_bits_match_the_jax_kernels_mixer(seed):
    shape = (37, 53)
    ref = np.asarray(_hash_bits(shape, jnp.asarray(seed, jnp.uint32)))
    rows = torch.arange(shape[0])[:, None]
    cols = torch.arange(shape[1])[None, :]
    ours = hash_bits(rows, cols, seed).numpy()
    np.testing.assert_array_equal(ours, ref.astype(np.int64))


def test_drop_threshold_and_keep_rate():
    thresh = attention_drop_threshold(RATE)
    assert thresh == round(0.2 * 2 ** 32)
    keep = attention_keep(4, 8, 200, SEED, thresh, "cpu")
    # 1.28M Bernoulli(0.8) draws: the rate within 5 standard deviations
    assert abs(keep.float().mean().item() - 0.8) < 5 * (0.16 / keep.numel()) ** .5


@pytest.mark.parametrize("rate", [0.0, RATE], ids=["nodrop", "drop"])
@pytest.mark.parametrize("b,h,t,dh,m", [
    (2, 2, 72, 16, 16),   # T > window: the training shape family
    (1, 2, 24, 16, 16),   # T < window: the whole matrix in range
])
def test_forward_and_gradients_match_pallas_kernel(rate, b, h, t, dh, m):
    q, k, v, e, g = _inputs(b, h, t, dh, m)
    thresh = attention_drop_threshold(rate)

    def jax_loss(q, k, v, e):
        out = fused_rel_attention(q, k, v, e, jnp.asarray(SEED, jnp.int32),
                                  m, thresh)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(x) for x in (q, k, v, e)))

    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, e)]
    out = rel_attention(*ts, m, None, SEED, thresh)
    (out * torch.from_numpy(g)).sum().backward()
    # float32 on both sides; the sums run in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=3e-5)
    for name, x, r in zip("qkve", ts, ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=3e-5,
                                   err_msg=f"d{name}")


def test_dropout_changes_the_output_and_the_seed_changes_the_mask():
    q, k, v, e, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 16, 8))
    thresh = attention_drop_threshold(RATE)
    base = rel_attention_plain(q, k, v, e, 8)
    a = rel_attention_plain(q, k, v, e, 8, None, 1, thresh)
    b = rel_attention_plain(q, k, v, e, 8, None, 2, thresh)
    assert not torch.allclose(a, base) and not torch.allclose(a, b)
    torch.testing.assert_close(
        a, rel_attention_plain(q, k, v, e, 8, None, 1, thresh), rtol=0,
        atol=0)


def test_backward_kernel_wrapper_takes_only_cuda_tensors():
    q, k, v, e, g = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 16, 8))
    rel_attention_bwd.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        rel_attention_bwd(q, k, v, e, g, 8)
    with pytest.raises(ValueError, match="uint32"):
        rel_attention(q, k, v, e, 8, None, 2 ** 32, 1)
    assert rel_attention_bwd.launches == 0
