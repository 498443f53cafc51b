"""One and two recognition micro-steps of the port against the JAX package,
at dropout 0, shift off, float32: ``jax.value_and_grad`` over
``EMGEncoder.apply(train=True)`` (38 outputs), ``log_softmax`` and
``ctc_loss``, then the JAX trainer's optimizer ``make_adamw(grad_accum=2)``
(``optax.MultiSteps``), against ``RecognitionTrainer.train_step`` on the
same weights and batches. Then the port alone: the device-corpus
micro-step against the host-packed one, and the gathered recognition batch
against the packed upload, bit for bit.

The JAX trainer class is not the oracle here: it switches the whole
process to the ``rbg`` PRNG. The micro-step is composed from its parts."""

import numpy as np
import pytest

import jax
import optax
import torch

from silent_speech_tpu.data.packing import pack_batch as jax_pack_batch
from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
from silent_speech_tpu.train.losses import ctc_loss as jax_ctc_loss
from silent_speech_tpu.train.state import make_adamw, set_learning_rate
from silent_speech_tpu_torch.config import (DataConfig,
                                            RecognitionTrainConfig)
from silent_speech_tpu_torch.data.device_cache import (DeviceCorpus,
                                                       assemble_batch)
from silent_speech_tpu_torch.data.packing import upload
from silent_speech_tpu_torch.models.convert import jax_to_torch
from silent_speech_tpu_torch.text import TextTransform
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer

from torch_port_util import (TINY, one_torch_thread, random_variables,
                             tiny_config)

BLANK = 37
LRS = (1e-3, 2e-3)
# float32 on both sides, sums in another order: the loss to 1e-5
# relative, the weights to 1e-5 of each tensor's largest entry (measured:
# 1.0e-7). Adam's first update moves a weight by about the learning rate
# however small its gradient, so where the exact gradient is 0 the two
# sides move it by ±lr on rounding noise of either sign: the conv biases
# in front of a BatchNorm (as in test_torch_train_step.py), and the
# entries whose accumulated gradient is under 1e-3 of its tensor's
# largest (measured: 42-234 entries a tensor, up to 1.85·lr apart). Those
# are held to 2·lr.
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
NOISE_GRAD = ("conv1.bias", "conv2.bias", "residual_path.bias")
NOISE_FLOOR = 1e-3
SENTENCES = ("the cat sat", "a dog ran far", "hello there", "on the mat",
             "silent speech", "we read it")
# no whole padding chunks (ROADMAP.md fault 4), as in the transduction
# step's test
DATA = DataConfig(seq_len=50, chunk_bucket=1, fixed_shapes=False)


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _examples(seed):
    rng = np.random.default_rng(seed)
    tt = TextTransform()
    out = []
    for i, silent in enumerate((True, False, False, True)):
        t = int(rng.integers(40, 90))
        sentence = SENTENCES[(seed + i) % len(SENTENCES)]
        ex = {"emg": rng.normal(size=(t, 112)).astype(np.float32),
              "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
              "session_ids": np.zeros(t, np.int64), "silent": silent,
              "text": sentence,
              "text_int": np.asarray(tt.text_to_int(sentence), np.int64),
              "phonemes": rng.integers(0, 48, size=t)}
        key = "parallel_voiced_audio_features" if silent \
            else "audio_features"
        ex[key] = rng.normal(size=(t, 80)).astype(np.float32)
        out.append(ex)
    return out


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxEncoder(num_outs=BLANK + 1, num_aux_outs=None, dropout=0.0,
                        fused_attention=False, shift_augment=False, **TINY)
    return jmodel, random_variables(jmodel, seed=3)


@pytest.fixture(scope="module")
def reference(setup):
    """Two batches, and the JAX loss, BatchNorm statistics and gradient of
    each micro-step. The optimizer does not move the weights at the first
    micro-step, so both are taken at the starting weights."""
    jmodel, variables = setup
    examples = [_examples(0), _examples(1)]
    jbatches = [jax_pack_batch(e, seq_len=50, chunk_bucket=1,
                               with_audio=False) for e in examples]
    params, stats = variables["params"], variables["batch_stats"]
    out = []
    for batch in jbatches:
        db = batch.device_batch()

        def loss_fn(p):
            logits, mutated = jmodel.apply(
                {"params": p, "batch_stats": stats}, db.emg, db.raw_emg,
                train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            lp = jax.nn.log_softmax(logits, axis=-1)
            return jax_ctc_loss(lp, db, blank_id=BLANK), mutated[
                "batch_stats"]

        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        out.append((float(loss), jax.device_get(stats),
                    jax.device_get(grads)))
    return examples, jbatches, out


def _jax_micro_steps(params, steps, moment_dtype):
    """Loss, weights, statistics and gradient after each micro-step under
    the JAX trainers' optimizer."""
    tx = make_adamw(weight_decay=0.0, grad_accum=2, moment_dtype=moment_dtype)
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for (loss, stats, grads), lr in zip(steps, LRS):
        state = set_learning_rate(state, lr)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        out.append((loss, jax.device_get(params), stats, grads))
    return out


def _trainer(variables, moment_dtype, data=DATA):
    trainer = RecognitionTrainer(
        tiny_config(), data,
        RecognitionTrainConfig(max_batch_len=4000,
                               moment_dtype=moment_dtype), device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    return trainer


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_two_micro_steps_match_jax(setup, reference, moment_dtype):
    variables = setup[1]
    examples, jbatches, steps = reference
    trainer = _trainer(variables, moment_dtype)
    batches = [trainer._pack(e) for e in examples]
    for ours, ref in zip(batches, jbatches):
        np.testing.assert_array_equal(ours.raw_emg, ref.raw_emg)
        np.testing.assert_array_equal(ours.text_int, ref.text_int)
    ref = _jax_micro_steps(variables["params"], steps, moment_dtype)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    for step, (batch, lr) in enumerate(zip(batches, LRS)):
        loss = trainer.train_step(batch, lr)
        ref_loss, ref_params, ref_stats, ref_grads = ref[step]
        assert loss.item() == pytest.approx(ref_loss, rel=LOSS_RTOL)
        state = trainer.model.state_dict()
        params = dict(trainer.model.named_parameters())
        if step == 0:
            # the first micro-step folds its gradient into the mean and
            # leaves the weights as they were, on both sides
            for name in params:
                assert torch.equal(state[name], start[name]), name
            ref_grads = jax_to_torch(ref_grads)
            for (name, p), acc in zip(params.items(),
                                      trainer.optimizer.acc):
                g = ref_grads[name]
                assert torch.equal(acc, p.grad)
                if not name.endswith(NOISE_GRAD):
                    np.testing.assert_allclose(
                        acc.numpy(), g.numpy(), rtol=0,
                        atol=1e-4 * float(g.abs().max()), err_msg=name)
        expect = jax_to_torch(ref_params, ref_stats)
        mean_grad = jax_to_torch(jax.tree_util.tree_map(
            lambda a, b: (a + b) / 2, ref[0][3], ref[1][3]))
        for name, p in expect.items():
            if name.endswith("num_batches_tracked"):
                continue
            atol = np.full(p.shape, PARAM_RTOL * float(p.abs().max()))
            if step == 1 and name in mean_grad:
                g = mean_grad[name].abs()
                noise = (g <= NOISE_FLOOR * g.max()).numpy() \
                    | name.endswith(NOISE_GRAD)
                atol[noise] = 2 * LRS[1]
            assert (np.abs(state[name].numpy() - p.numpy()) <= atol).all(), \
                name
    assert trainer.optimizer.count == 1 and trainer.optimizer.mini_step == 0


def _fixed_trainer(variables):
    # 2000 raw samples → int(2000·0.51679/6) = 172 frames → 4 + 2 chunks
    # of 50, rounded up to 8
    data = DataConfig(seq_len=50, chunk_bucket=4, utt_cap=8, t_cap=128)
    trainer = RecognitionTrainer(
        tiny_config(), data,
        RecognitionTrainConfig(max_batch_len=2000), device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    return trainer


@pytest.mark.parametrize("subset", [[0, 1, 2, 3], [2, 0], [1]])
def test_gathered_batch_is_the_packed_upload(setup, subset):
    trainer = _fixed_trainer(setup[1])
    examples = _examples(2)
    corpus = DeviceCorpus.build(examples, "cpu")
    ids = corpus.order_silent_first(subset)
    caps = trainer._cache_caps()
    assert caps["n_chunks"] == 8 and caps["text_cap"] == 128
    utt_ids = torch.zeros(8, dtype=torch.int64)
    utt_ids[: len(ids)] = torch.tensor(ids)
    dev = assemble_batch(corpus.arrays, utt_ids, torch.arange(8) < len(ids),
                         with_audio=False, **caps)
    host = upload(trainer._pack([examples[i] for i in subset]), "cpu")
    assert dev.audio_features is None and host.audio_features is None
    assert host.text_int.shape == (8, 128)
    for name in host._fields:
        ours, ref = getattr(dev, name), getattr(host, name)
        if ref is None:
            continue
        assert ours.dtype == ref.dtype and torch.equal(ours, ref), name


def test_train_step_ids_is_train_step_on_the_packed_batch(setup):
    host, dev = _fixed_trainer(setup[1]), _fixed_trainer(setup[1])
    examples = _examples(3)
    corpus = DeviceCorpus.build(examples, "cpu")
    for ids, lr in (([3, 1, 0], 1e-3), ([2, 0], 2e-3), ([1, 2, 3], 5e-4)):
        ref = host.train_step(host._pack([examples[i] for i in ids]), lr)
        assert torch.equal(dev.train_step_ids(corpus, ids, lr), ref)
    for (name, a), b in zip(dev.model.state_dict().items(),
                            host.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(dev.optimizer.acc, host.optimizer.acc):
        assert torch.equal(a, b)
    assert dev.optimizer.mini_step == host.optimizer.mini_step == 1


def test_train_step_ids_declines_a_batch_over_the_caps(setup):
    trainer = _fixed_trainer(setup[1])
    examples = _examples(4)
    examples[0]["text_int"] = np.zeros(129, np.int64)   # over text_cap
    corpus = DeviceCorpus.build(examples, "cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    assert trainer.train_step_ids(corpus, [0, 1], 1e-3) is None
    assert trainer.train_step_ids(corpus, list(range(4)) * 3, 1e-3) is None
    assert trainer.optimizer.mini_step == 0
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
