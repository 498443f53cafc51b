"""One full transduction training step of the port vs the JAX package, at
dropout 0, shift off, float32: ``jax.value_and_grad`` over
``EMGEncoder.apply(train=True)`` plus ``transduction_loss``, then
``fused_adamw`` (bfloat16 moments) or ``optax.adamw`` (float32 moments),
against ``TransductionTrainer.train_step`` with the same weights and batch.
Loss, gradients, BatchNorm statistics and the updated parameters are
compared; so are the optimizers alone on the same gradients, and the
learning-rate schedule.

The JAX trainer class is not the oracle: it switches the whole process to
the ``rbg`` PRNG (``train/transduction.py:64``). The step is composed from
its parts instead."""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from silent_speech_tpu.data.packing import pack_batch as jax_pack_batch
from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
from silent_speech_tpu.train import schedule as jax_schedule
from silent_speech_tpu.train.losses import transduction_loss as jax_loss
from silent_speech_tpu.train.state import fused_adamw
from silent_speech_tpu_torch.config import (DataConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.train import schedule
from silent_speech_tpu_torch.train.state import FusedAdamW
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import TINY, random_variables, tiny_config

LR = 1e-3
L2 = 1e-7
# BatchNorm subtracts the batch mean, so the exact gradient of the bias of
# every conv that feeds one is 0: what the two frameworks compute there is
# rounding noise of either sign, and Adam's first step moves such a bias
# by up to ±LR·|g|/(|g| + ε). Those biases are held to 2·LR.
NOISE_GRAD = ("conv1.bias", "conv2.bias", "residual_path.bias")
# Packed without whole padding chunks (no fixed shapes, chunk bucket 1):
# with three all-zero chunks in the batch, JAX's float32 gradient of the
# layers before the last transformer layer moved up to 9% away from the
# same computation with jax_enable_x64 on, while the port's float32 stayed
# within 1e-6 of its float64 (measured at this geometry; an open question
# in ROADMAP.md). The trainer's fixed-shape padding is exercised on the
# card by chip_smoke.py.
DATA = DataConfig(seq_len=50, chunk_bucket=1, fixed_shapes=False)


def _examples(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for silent in (True, False, True, False, False):
        t = int(rng.integers(20, 90))
        tt = int(t * rng.uniform(0.9, 1.15)) if silent else t
        ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
              "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
              "session_ids": np.zeros(t, np.int64), "silent": silent,
              "text": "x", "text_int": rng.integers(0, 37, size=12),
              "phonemes": rng.integers(0, 48, size=tt)}
        key = "parallel_voiced_audio_features" if silent \
            else "audio_features"
        ex[key] = rng.normal(size=(tt, 80)).astype(np.float32)
        out.append(ex)
    return out


def _trainer(variables, moment_dtype):
    trainer = TransductionTrainer(
        tiny_config(),
        DATA,
        TransductionTrainConfig(max_batch_len=4000, l2=L2,
                                moment_dtype=moment_dtype), device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    return trainer


def _jax_step(jmodel, variables, batch, tx):
    db = batch.device_batch()

    def loss_fn(params):
        (pred, phone), mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            db.emg, db.raw_emg, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        out = jax_loss(pred, phone, db, 0.5, n_silent=batch.num_silent,
                       matmul_dtype=jnp.float32)
        return out.loss, (mutated["batch_stats"], out)

    params = variables["params"]
    (loss, (stats, out)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return (float(loss), out, jax.device_get(grads), stats,
            jax.device_get(optax.apply_updates(params, updates)))


def _tx(moment_dtype):
    if moment_dtype == "float32":
        return optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=L2)
    return fused_adamw(LR, weight_decay=L2, moment_dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxEncoder(num_outs=80, num_aux_outs=48, dropout=0.0,
                        fused_attention=False, shift_augment=False, **TINY)
    return jmodel, random_variables(jmodel, seed=7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(setup, moment_dtype):
    jmodel, variables = setup
    trainer = _trainer(variables, moment_dtype)
    batch = trainer._pack(_examples())
    jbatch = jax_pack_batch(_examples(), seq_len=50, chunk_bucket=1)
    np.testing.assert_array_equal(batch.raw_emg, jbatch.raw_emg)
    assert batch.num_silent == jbatch.num_silent == 4
    loss, ref, grads, stats, new_params = _jax_step(
        jmodel, variables, jbatch, _tx(moment_dtype))

    out = trainer.train_step(batch, LR)
    # float32 on both sides; sums over ~300 frames in another order
    assert out.loss.item() == pytest.approx(loss, rel=1e-5)
    assert int(out.correct_phones) == int(ref.correct_phones)
    assert int(out.total_length) == int(ref.total_length)

    ours = dict(trainer.model.named_parameters())
    ref_grads = jax_to_torch(grads)
    assert sorted(ref_grads) == sorted(ours)
    for name, g in ref_grads.items():
        if name.endswith(NOISE_GRAD):  # an exact 0 on both sides' scale
            assert float(g.abs().max()) < 1e-6, name
            assert float(ours[name].grad.abs().max()) < 1e-6, name
            continue
        # gradients to 1e-4 of each tensor's largest entry
        np.testing.assert_allclose(ours[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * float(g.abs().max()),
                                   err_msg=name)

    ref_params = jax_to_torch(new_params, jax.device_get(stats))
    state = trainer.model.state_dict()
    for name, p in ref_params.items():
        if name.endswith("num_batches_tracked"):
            continue
        noisy = name.endswith(NOISE_GRAD)
        # an Adam step moves a parameter by ≤ LR; elsewhere the two sides
        # agree to a small fraction of it
        np.testing.assert_allclose(
            state[name].numpy(), p.numpy(), rtol=0,
            atol=2 * LR if noisy else 5e-3 * LR, err_msg=name)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_optimizer_matches_jax_on_the_same_gradients(setup, moment_dtype):
    _, variables = setup
    rng = np.random.default_rng(9)
    params = variables["params"]
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=np.shape(p)).astype(np.float32) * 1e-2,
        params)
    tx = _tx(moment_dtype)
    state = tx.init(params)
    ref = params
    for _ in range(3):
        updates, state = tx.update(grads, state, ref)
        ref = optax.apply_updates(ref, updates)

    ours = {k: v.clone() for k, v in jax_to_torch(params).items()}
    for name, g in jax_to_torch(grads).items():
        ours[name].grad = g
    opt = FusedAdamW(ours.values(), weight_decay=L2,
                     moment_dtype=getattr(torch, moment_dtype))
    for _ in range(3):
        opt.step(LR)
    # the same float32 operations in the same order, but XLA may contract
    # a multiply and an add into one FMA: a few ulps of the parameter or
    # of the update (≤ 3·LR). With bfloat16 moments an ulp in the float32
    # moment can round to the neighbouring bfloat16 value, which moves a
    # later update by up to LR·2⁻⁸.
    atol = LR * (1e-6 if moment_dtype == "float32" else 2 ** -8)
    for name, p in jax_to_torch(jax.device_get(ref)).items():
        np.testing.assert_allclose(ours[name].numpy(), p.numpy(), rtol=5e-7,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("step", [0, 10, 499, 500, 2000])
def test_warmup_matches_jax(step):
    assert schedule.warmup_lr(step, 1e-3, 500) == \
        jax_schedule.warmup_lr(step, 1e-3, 500)


def test_plateau_matches_jax():
    ours, ref = schedule.ReduceLROnPlateau(patience=2), \
        jax_schedule.ReduceLROnPlateau(patience=2)
    for metric in (5.0, 4.0, 4.0, 4.0, 4.0, 3.9, 3.9, 3.9, 3.9):
        assert ours.step(metric) == ref.step(metric)
