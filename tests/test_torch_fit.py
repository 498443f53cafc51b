"""The port's ``fit()`` against the JAX trainer's ``fit()`` at dropout 0,
shift off, float32: the same examples, the same converted initial weights,
the same sampler seed, so the same batches. Every step's loss and each
epoch's validation loss and phoneme accuracy are compared.

Packing has no whole padding chunks on either side (``fixed_shapes`` off,
chunk bucket 1, a one-device JAX mesh): with whole zero chunks the JAX
float32 gradients drift from their float64 values (an open question of
the roadmap), so those batches are the host path's. The device-corpus path
is held to this host path inside the port (``test_torch_fit_port.py``).
In its own file: the JAX trainer switches the process to the ``rbg``
PRNG."""

import numpy as np
import pytest

from silent_speech_tpu_torch.data.dataset import ExampleList

from torch_port_util import (example_dict, jax_encoder, jax_fit,
                             jax_prng_impl_restored, one_torch_thread,
                             port_fit, random_variables)

SEQ_LEN = 48
FRAMES = 48            # every utterance: one chunk, so few JAX shapes
PER_BATCH = 3
EPOCHS = 2
LR, WARMUP = 2e-3, 2
# float32 on both sides, sums in another order, over 8 Adam steps: the
# largest step-loss gap measured at this geometry was 7.0e-7 relative
STEP_RTOL = 1e-5
# The validation forward reads the BatchNorm running statistics, and those
# carry the conv biases in front of each BatchNorm. Those biases have an
# exact gradient of 0 (BatchNorm subtracts the batch mean), so each side's
# Adam moves them by up to ±LR on rounding noise of either sign (as in
# test_torch_train_step.py). Measured: 3.9e-5 and 3.0e-5 relative after
# epochs 1 and 2; held to 2e-4, five times the larger. Phoneme accuracy
# and the confusion matrix were equal; one frame may move between cells.
VAL_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def prng_impl_restored_and_one_torch_thread():
    with jax_prng_impl_restored(), one_torch_thread():
        yield


def _datasets():
    rng = np.random.default_rng(11)
    pattern = [True, False, False, True, False, False] * 2
    train = [example_dict(rng, FRAMES, s, t_tgt=int(FRAMES * f), text=f"u{i}")
             for i, (s, f) in enumerate(zip(pattern, [1.1, 1, 1, 0.9] * 3))]
    dev = [example_dict(rng, 40, True, t_tgt=44), example_dict(rng, 36,
                                                               False)]
    return ExampleList(train), ExampleList(dev)


def _max_batch_len(train):
    return PER_BATCH * train.example_meta(0)["emg_length"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = random_variables(jax_encoder(80, 48), seed=5)
    train, dev = _datasets()
    root = tmp_path_factory.mktemp("fit")
    kw = dict(seq_len=SEQ_LEN, lr=LR, warmup=WARMUP,
              max_batch_len=_max_batch_len(train), epochs=EPOCHS)
    return (port_fit(variables, train, dev, str(root / "port"), **kw),
            jax_fit(variables, train, dev, str(root / "jax"), **kw))


def test_step_losses_match_jax(runs):
    (ours, _), (ref, _) = runs
    assert len(ours) == len(ref) == EPOCHS * 12 // PER_BATCH
    np.testing.assert_allclose(ours, ref, rtol=STEP_RTOL)


def test_validation_matches_jax(runs):
    (_, ours), (_, ref) = runs
    assert len(ours) == len(ref) == EPOCHS
    for (loss, acc, confusion), (ref_loss, ref_acc, ref_conf) in zip(ours,
                                                                      ref):
        frames = ref_conf.sum()
        assert loss == pytest.approx(ref_loss, rel=VAL_RTOL)
        assert confusion.sum() == frames
        assert abs(acc - ref_acc) <= 1 / frames
        assert np.abs(confusion - ref_conf).sum() <= 2
