"""The port's train-mode ops vs the JAX package: ``residual_dropout_ln``
and ``relu_dropout`` (the JAX op at rate 0; at rate 0.2 the port's counter
hash draws its own mask, held to the quantized rate and to the same mask
in the backward), and the encoder's train forward (BatchNorm on batch
statistics with flax's running update, shift augmentation with a fixed
shift)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
from silent_speech_tpu.ops.dropout import (
    dropout_threshold as jax_dropout_threshold)
from silent_speech_tpu.ops.fused_norm import residual_dropout_ln as jax_ln
from silent_speech_tpu_torch.models import encoder as port_encoder_mod
from silent_speech_tpu_torch.models.encoder import shift_raw
from silent_speech_tpu_torch.ops.dropout import (
    dropout_threshold, keep_mask, mask_scale, regen_dropout, relu_dropout)
from silent_speech_tpu_torch.ops.fused_norm import residual_dropout_ln

from torch_port_util import (TINY, port_encoder, random_variables, raw_emg,
                             to_numpy)

T8 = dropout_threshold(0.2)


def _ln_inputs(seed=0, shape=(3, 17, 64)):
    rng = np.random.default_rng(seed)
    x, h, dy = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    gamma = 1 + 0.1 * rng.normal(size=shape[-1]).astype(np.float32)
    beta = 0.1 * rng.normal(size=shape[-1]).astype(np.float32)
    return x, h, dy, gamma, beta


def test_threshold_quantization_matches_jax():
    assert T8 == jax_dropout_threshold(0.2) == 51
    assert dropout_threshold(0.0) == 0


def test_residual_dropout_ln_forward_and_gradients_match_jax_at_rate_0():
    x, h, dy, gamma, beta = _ln_inputs()

    def f(x, h, gamma, beta):
        return jax_ln(x, h, jax.random.PRNGKey(0), 0, gamma, beta, 1e-6)

    ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, h, gamma, beta)))
    ref_grads = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, h, gamma, beta)]
    out = residual_dropout_ln(ts[0], ts[1], 0, 0, ts[2], ts[3])
    out.backward(torch.from_numpy(dy))
    # float32 on both sides; reductions in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    for name, t, r in zip(("x", "h", "gamma", "beta"), ts, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4,
                                   err_msg=name)


def test_dropout_mask_has_the_quantized_rate():
    keep = keep_mask((64, 200, 768), seed=5, threshold=T8, device="cpu")
    rate = 1 - keep.float().mean().item()
    # 9.8M draws of P(drop) = 51/256: within 5 standard deviations
    p = 51 / 256
    assert abs(rate - p) < 5 * (p * (1 - p) / keep.numel()) ** 0.5
    other = keep_mask((64, 200, 768), seed=6, threshold=T8, device="cpu")
    assert (keep != other).float().mean().item() > 0.3


def test_residual_dropout_regenerates_the_same_mask_in_backward():
    x, h, dy, gamma, beta = _ln_inputs(1)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, h, gamma, beta)]
    out = residual_dropout_ln(ts[0], ts[1], 99, T8, ts[2], ts[3])
    out.backward(torch.from_numpy(dy))
    keep = keep_mask(h.shape, 99, T8, "cpu")
    # the forward equals the rate-0 op on the masked, scaled h
    ref = residual_dropout_ln(torch.from_numpy(x),
                              mask_scale(torch.from_numpy(h), 99, T8), 0, 0,
                              torch.from_numpy(gamma), torch.from_numpy(beta))
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    # dh = dz on kept elements, scaled; 0 where the forward dropped
    assert (ts[1].grad[~keep] == 0).all()
    torch.testing.assert_close(ts[1].grad[keep],
                               ts[0].grad[keep] * (256 / 205), rtol=1e-6,
                               atol=0)


def test_regen_dropout_gradient_is_the_mask():
    x = torch.randn(5, 33, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    regen_dropout(x, 3, T8).sum().backward()
    keep = keep_mask(x.shape, 3, T8, "cpu")
    expected = torch.where(keep, torch.tensor(256 / 205), torch.tensor(0.0))
    torch.testing.assert_close(x.grad, expected)


@pytest.mark.parametrize("threshold", [0, T8])
def test_relu_dropout_backward_uses_the_output_sign(threshold):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 9, 128)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    ours = torch.from_numpy(x).requires_grad_()
    out = relu_dropout(ours, 17, threshold)
    out.backward(torch.from_numpy(g))
    plain = torch.from_numpy(x).requires_grad_()
    ref = (mask_scale(torch.relu(plain), 17, threshold) if threshold
           else torch.relu(plain))
    ref.backward(torch.from_numpy(g))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(ours.grad, plain.grad, rtol=0, atol=0)
    if threshold == 0:
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jax.nn.relu(x)))


def test_shift_raw_matches_the_jax_roll():
    x = raw_emg(3, 10)
    for r in range(8):
        t = x.shape[1]
        ref = jnp.where((jnp.arange(t) < t - r)[None, :, None],
                        jnp.roll(jnp.asarray(x), -r, axis=1), 0.0)
        np.testing.assert_array_equal(
            shift_raw(torch.from_numpy(x), r).numpy(), np.asarray(ref))


@pytest.mark.parametrize("shift", [None, 3], ids=["noshift", "shift3"])
def test_train_forward_and_batchnorm_statistics_match_jax(shift,
                                                          monkeypatch):
    jmodel = JaxEncoder(num_outs=80, num_aux_outs=48, dropout=0.0,
                        fused_attention=False, shift_augment=shift
                        is not None, **TINY)
    variables = random_variables(jmodel, seed=3)
    raw = raw_emg(4, 64, seed=5)
    rngs = {"dropout": jax.random.PRNGKey(1)}
    if shift is not None:
        rngs["shift"] = jax.random.PRNGKey(2)
        # pin the JAX model's shift draw; the port's below draws the same
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(shift, jnp.int32))
        monkeypatch.setattr(port_encoder_mod, "draw_shift",
                            lambda generator: shift)
    (ref_out, ref_aux), mutated = jmodel.apply(
        variables, jnp.zeros((4, 64, 112)), jnp.asarray(raw), train=True,
        rngs=rngs, mutable=["batch_stats"])

    model = port_encoder(variables, 80, 48)
    model.cfg.shift_augment = shift is not None
    out, aux = model(torch.from_numpy(raw), train=True,
                     generator=torch.Generator().manual_seed(0))
    # float32 on both sides; batch statistics reduce in another order
    for o, r in ((out, ref_out), (aux, ref_aux)):
        np.testing.assert_allclose(to_numpy(o), np.asarray(r), atol=2e-4)
    stats = mutated["batch_stats"]
    for i in range(3):
        for name in ("bn1", "bn2", "res_norm"):
            bn = getattr(model.conv_blocks[i], name)
            s = stats[f"res{i}"][name]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(s["mean"]), atol=1e-5)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(s["var"]), rtol=1e-5,
                                       atol=1e-5)


def test_training_forward_needs_a_generator():
    jmodel = JaxEncoder(num_outs=80, num_aux_outs=48, dropout=0.0, **TINY)
    model = port_encoder(random_variables(jmodel), 80, 48)
    with pytest.raises(ValueError, match="generator"):
        model(torch.from_numpy(raw_emg(1, 16)), train=True)
