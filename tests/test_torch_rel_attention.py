"""Port's relative-position attention forward vs the JAX package: the
Pallas kernel in interpret mode, and the segment-masked XLA path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.models.transformer import (
    RelativePositionalAttention as JaxAttention)
from silent_speech_tpu.ops.pallas.rel_attention import fused_rel_attention
from silent_speech_tpu_torch.models.transformer import (
    RelativePositionalAttention)
from silent_speech_tpu_torch.ops.rel_attention import (
    rel_attention, rel_attention_plain)


def _inputs(b, h, t, dh, m, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, dh)).astype(np.float32) * scale
               for _ in range(3))
    e = rng.normal(size=(h, 2 * m - 1, dh)).astype(np.float32) * scale
    return q, k, v, e


@pytest.mark.parametrize("b,h,t,dh,m", [
    (2, 2, 200, 32, 100),   # T > window: the training shape family
    (1, 3, 64, 16, 100),    # T < window: the whole matrix in range
    (2, 2, 150, 32, 40),    # window < T, odd sizes
])
def test_matches_pallas_kernel(b, h, t, dh, m):
    q, k, v, e = _inputs(b, h, t, dh, m)
    ref = fused_rel_attention(*(jnp.asarray(x) for x in (q, k, v, e)),
                              0, m, 0)
    ours = rel_attention(*(torch.from_numpy(x) for x in (q, k, v, e)), m)
    # f32 on both sides; the sums run in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("t,valid_len", [
    (100, 37),    # XLA path's matmul rel→abs map (t ≤ 256)
    (300, 123),   # its skew map (t > 256); pad rows far from valid keys
])
def test_valid_len_matches_segment_masked_xla_path(t, valid_len):
    d, h, m, b = 64, 2, 16, 2
    jmod = JaxAttention(d_model=d, n_head=h, max_dist=m, dropout=0.0,
                        fused=False)
    x = np.random.default_rng(3).normal(size=(b, t, d)).astype(np.float32)
    params = jax.device_get(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    seg = (np.arange(t) < valid_len).astype(np.int32)[None].repeat(b, 0)
    ref = jmod.apply({"params": params}, jnp.asarray(x),
                     segment_ids=jnp.asarray(seg))

    ours = RelativePositionalAttention(d, h, m, torch.float32)
    ours.load_state_dict({
        **{w: torch.tensor(np.asarray(params[w]))
           for w in ("w_q", "w_k", "w_v", "w_o")},
        "relative_positional.embeddings": torch.tensor(
            np.asarray(params["rel_emb"])[..., None])}, strict=True)
    with torch.no_grad():
        out = ours(torch.from_numpy(x), valid_len)
    # every row, padding rows included
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, e = (torch.from_numpy(x) for x in _inputs(1, 2, 48, 16, 8))
    rel_attention.launches = 0
    out = rel_attention(q, k, v, e, 8, 30)
    assert rel_attention.launches == 0
    torch.testing.assert_close(out, rel_attention_plain(q, k, v, e, 8, 30),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["rel_shape", "valid_len", "dtype",
                                  "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v, e = (torch.from_numpy(x) for x in _inputs(1, 2, 48, 16, 8))
    args, kwargs = [q, k, v, e, 8], {}
    if case == "rel_shape":
        args[3] = e[:, 1:]
    elif case == "valid_len":
        kwargs["valid_len"] = 49
    elif case == "dtype":
        args[1] = k.double()
    else:  # a non-CPU tensor never takes the plain version
        args[:4] = [x.to("meta") for x in args[:4]]
    with pytest.raises(ValueError):
        rel_attention(*args, **kwargs)
