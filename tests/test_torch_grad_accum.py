"""Gradient accumulation in the port's ``FusedAdamW`` against the JAX
package's ``make_adamw(grad_accum=2)`` (``optax.MultiSteps`` around AdamW)
over micro-steps whose gradients and learning rates all differ: the
weights after each micro-step, the running mean, and a checkpoint written
between the two micro-steps of a group. Also the milestone schedule."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from silent_speech_tpu.train import schedule as jax_schedule
from silent_speech_tpu.train.state import make_adamw, set_learning_rate
from silent_speech_tpu_torch.train import schedule
from silent_speech_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
from silent_speech_tpu_torch.train.state import FusedAdamW

L2 = 1e-7
SHAPES = {"w": (7, 5), "b": (5,), "e": (3, 4, 2)}
STEPS = 5
LRS = [1e-3 * (i + 1) for i in range(STEPS)]  # a new rate every micro-step


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(size=s) * 10.0 ** -(step % 3)).astype(np.float32)
            for k, s in SHAPES.items()}


def _params():
    rng = np.random.default_rng(1)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()}


def _optax_trajectory(moment_dtype):
    """Weights and accumulator after each micro-step under optax."""
    tx = make_adamw(weight_decay=L2, grad_accum=2, moment_dtype=moment_dtype)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    state = tx.init(params)
    out = []
    for step in range(STEPS):
        state = set_learning_rate(state, LRS[step])
        updates, state = tx.update(_grads(step), state, params)
        params = optax.apply_updates(params, updates)
        out.append((jax.device_get(params), jax.device_get(state.acc_grads),
                    int(state.mini_step)))
    return out


def _port_state(moment_dtype):
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in _params().items()}
    opt = FusedAdamW(params.values(), weight_decay=L2,
                     moment_dtype=getattr(torch, moment_dtype), grad_accum=2)
    return params, opt


def _micro_step(params, opt, step):
    for k, g in _grads(step).items():
        params[k].grad = torch.from_numpy(g)
    return opt.step(LRS[step])


# The same float32 operations in the same order, but XLA may contract a
# multiply and an add into one FMA: a few ulps of the weight or of the
# update (≤ 5·LR). With bfloat16 moments an ulp of the float32 moment can
# round to the neighbouring bfloat16 value: up to LR·2⁻⁸ (the tolerances
# of test_torch_train_step.py's optimizer test).
def _atol(moment_dtype):
    return max(LRS) * (1e-6 if moment_dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_accumulation_matches_optax_multisteps(moment_dtype):
    ref = _optax_trajectory(moment_dtype)
    params, opt = _port_state(moment_dtype)
    before = {k: p.detach().clone() for k, p in params.items()}
    for step, (ref_params, ref_acc, ref_mini) in enumerate(ref):
        emitted = _micro_step(params, opt, step)
        assert emitted == (step % 2 == 1)
        assert opt.mini_step == ref_mini
        assert opt.count == (step + 1) // 2   # Adam counts updates only
        for i, k in enumerate(SHAPES):
            np.testing.assert_allclose(
                params[k].detach().numpy(), ref_params[k], rtol=5e-7,
                atol=_atol(moment_dtype), err_msg=f"{k} at {step}")
            # the running mean: one division and one add, exact
            np.testing.assert_array_equal(opt.acc[i].numpy(), ref_acc[k])
            if not emitted:   # between updates the weights stand still
                assert torch.equal(params[k].detach(), before[k])
        before = {k: p.detach().clone() for k, p in params.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_a_checkpoint_between_micro_steps_resumes_exactly(tmp_path,
                                                          moment_dtype):
    """Written after micro-step 3 of 5, where the accumulator holds half a
    group: the resumed optimizer ends where an uninterrupted one and optax
    end."""
    ref = _optax_trajectory(moment_dtype)
    whole, whole_opt = _port_state(moment_dtype)
    for step in range(STEPS):
        _micro_step(whole, whole_opt, step)

    def trainer(params, opt):
        model = torch.nn.ParameterDict(params)
        return types.SimpleNamespace(model=model, optimizer=opt,
                                     generator=torch.Generator())

    first, first_opt = _port_state(moment_dtype)
    for step in range(3):
        _micro_step(first, first_opt, step)
    assert first_opt.mini_step == 1 and first_opt.acc[0].abs().sum() > 0
    save_checkpoint(str(tmp_path), trainer(first, first_opt))

    second, second_opt = _port_state(moment_dtype)
    restore_checkpoint(str(tmp_path), trainer(second, second_opt))
    assert second_opt.mini_step == 1 and second_opt.count == 1
    for a, b in zip(second_opt.acc, first_opt.acc):
        assert torch.equal(a, b)
    for step in range(3, STEPS):
        _micro_step(second, second_opt, step)
    for k in SHAPES:
        assert torch.equal(second[k], whole[k]), k
        np.testing.assert_allclose(second[k].detach().numpy(), ref[-1][0][k],
                                   rtol=5e-7, atol=_atol(moment_dtype))


def test_a_checkpoint_without_accumulation_does_not_restore_into_one(
        tmp_path):
    params, opt = _port_state("float32")
    plain = FusedAdamW(params.values())
    ns = types.SimpleNamespace
    save_checkpoint(str(tmp_path), ns(model=torch.nn.ParameterDict(params),
                                      optimizer=plain,
                                      generator=torch.Generator()))
    with pytest.raises(ValueError, match="accumulation"):
        restore_checkpoint(str(tmp_path), ns(
            model=torch.nn.ParameterDict(params), optimizer=opt,
            generator=torch.Generator()))


@pytest.mark.parametrize("milestones", [(125, 150, 175), (1, 2), (3,)])
def test_multistep_lr_matches_jax(milestones):
    ours = schedule.MultiStepLR(milestones=milestones, gamma=0.5)
    ref = jax_schedule.MultiStepLR(milestones=milestones, gamma=0.5)
    for _ in range(200):
        assert ours.step() == ref.step()
        assert ours.scale == ref.scale
