"""Port's EMGEncoder vs the JAX ``EMGEncoder.apply(train=False)``, with the
weights carried over by ``jax_to_torch``."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from silent_speech_tpu.models.convert import flax_to_torch
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.models.encoder import EMGEncoder

from torch_port_util import (jax_encoder, port_encoder, random_variables,
                             raw_emg, to_numpy)

HEADS = {"transduction": (80, 48), "recognition": (38, None)}


def _both(kind, fused, monkeypatch, jdtype=jnp.float32, cdtype="float32",
          t=64):
    if fused:
        # the Pallas kernel, interpreted on the CPU
        monkeypatch.setenv("SSTPU_INTERPRET_FUSED", "1")
    num_outs, aux = HEADS[kind]
    jmodel = jax_encoder(num_outs, aux, fused=fused, dtype=jdtype)
    variables = random_variables(jmodel)
    raw = raw_emg(2, t)
    ref = jmodel.apply(variables, jnp.zeros((2, t, 112)), jnp.asarray(raw),
                       train=False)
    model = port_encoder(variables, num_outs, aux, cdtype)
    with torch.no_grad():
        ours = model(torch.from_numpy(raw))
    ref = ref if isinstance(ref, tuple) else (ref,)
    ours = ours if isinstance(ours, tuple) else (ours,)
    assert len(ours) == len(ref)
    return ours, ref


@pytest.mark.parametrize("kind", sorted(HEADS))
@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas"])
def test_matches_jax_encoder_f32(kind, fused, monkeypatch):
    ours, ref = _both(kind, fused, monkeypatch)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(to_numpy(o), np.asarray(r), atol=1e-4)


def test_matches_jax_encoder_bf16(monkeypatch):
    # XLA's CPU backend has no bf16 x bf16 → f32 dot, which the JAX
    # XLA path's matmul rel→abs map needs at t ≤ 256: take the kernel
    ours, ref = _both("transduction", True, monkeypatch,
                      jdtype=jnp.bfloat16, cdtype="bfloat16")
    for o, r in zip(ours, ref):
        o, r = to_numpy(o), np.asarray(r, np.float32)
        # bf16 keeps ~3 significant digits and the two frameworks round
        # at different places (the port's attention runs in f32, JAX's
        # softmax in bf16); the gap measured ~1.7% of the output scale,
        # the same as the port in f32 against JAX in bf16. Hold it to 5%
        assert np.abs(o - r).max() <= 0.05 * np.abs(r).max()


def test_state_dict_is_the_reference_layout():
    jmodel = jax_encoder(80, 48)
    variables = random_variables(jmodel, seed=4)
    ours = jax_to_torch(variables["params"], variables["batch_stats"])
    ref = flax_to_torch(variables["params"], variables["batch_stats"])
    assert sorted(ours) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(value))
    model = EMGEncoder.from_state_dict(ours, compute_dtype="float32")
    assert model.cfg.num_layers == 2 and model.cfg.num_heads == 2
    assert model.cfg.relative_positional_distance == 16
    assert sorted(model.state_dict()) == sorted(ours)
