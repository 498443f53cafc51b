"""Port's residual LayerNorm vs the JAX ``residual_dropout_ln`` at rate 0."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.ops.fused_norm import residual_dropout_ln
from silent_speech_tpu_torch.ops.fused_norm import (
    residual_dropout_ln as port_residual_dropout_ln)


@pytest.mark.parametrize("dtype,atol", [
    ("float32", 1e-6),
    # z = x + h and y round to bf16 on both sides; one bf16 step at |y|<4
    ("bfloat16", 2 ** -6),
])
def test_matches_jax_residual_ln(dtype, atol):
    rng = np.random.default_rng(0)
    x, h = (rng.normal(size=(3, 17, 64)).astype(np.float32)
            for _ in range(2))
    gamma = 1 + 0.1 * rng.normal(size=64).astype(np.float32)
    beta = 0.1 * rng.normal(size=64).astype(np.float32)
    jdt = getattr(jnp, dtype)
    ref = residual_dropout_ln(jnp.asarray(x, jdt), jnp.asarray(h, jdt),
                              jax.random.PRNGKey(0), 0, jnp.asarray(gamma),
                              jnp.asarray(beta), 1e-6)
    tdt = getattr(torch, dtype)
    ours = port_residual_dropout_ln(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(h).to(tdt), 0, 0,
                                    torch.from_numpy(gamma),
                                    torch.from_numpy(beta))
    assert ours.dtype == tdt
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)
