"""The port's device corpus: ``assemble_batch`` against the port's own
``pack_batch`` upload (bit for bit) and the JAX ``assemble_batch``, the
budget, ``train_step_ids`` against ``train_step`` on the same
utterances, and the one difference in the trainers' shared guard: only
batches that carry audio need their voiced targets within ``t_cap``."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from silent_speech_tpu.data.device_cache import (
    DeviceCorpus as JaxCorpus, assemble_batch as jax_assemble_batch)
from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            RecognitionTrainConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data.device_cache import (
    DeviceCorpus, HBMBudgetError, assemble_batch, device_budget)
from silent_speech_tpu_torch.data.packing import pack_batch, upload
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import example_dict, one_torch_thread

N_CHUNKS, SEQ_LEN, T_CAP, U_CAP = 8, 40, 128, 8


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def examples():
    rng = np.random.default_rng(0)
    return [example_dict(rng, 55, True, t_tgt=62, sess=1),
            example_dict(rng, 40, False),
            example_dict(rng, 71, True, t_tgt=66, sess=2),
            example_dict(rng, 33, False, sess=3),
            example_dict(rng, 28, False, sess=1)]


def _ids(ids):
    utt_ids = np.zeros(U_CAP, np.int64)
    utt_ids[: len(ids)] = ids
    return utt_ids, np.arange(U_CAP) < len(ids)


def _assemble(corpus, ids):
    utt_ids, valid = _ids(ids)
    return assemble_batch(corpus.arrays, torch.from_numpy(utt_ids),
                          torch.from_numpy(valid), n_chunks=N_CHUNKS,
                          seq_len=SEQ_LEN, t_cap=T_CAP)


@pytest.mark.parametrize("subset", [[0, 1, 2, 3, 4], [3, 2, 1], [1, 4],
                                    [2]])
def test_assembled_batch_is_the_packed_upload(examples, subset):
    corpus = DeviceCorpus.build(examples, "cpu")
    ids = corpus.order_silent_first(subset)
    dev = _assemble(corpus, ids)
    host = upload(pack_batch([examples[i] for i in subset], seq_len=SEQ_LEN,
                             chunk_bucket=1, fixed_chunks=N_CHUNKS,
                             fixed_utts=U_CAP, fixed_t=T_CAP), "cpu")
    for name in host._fields:
        ours, ref = getattr(dev, name), getattr(host, name)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, name
        assert torch.equal(ours, ref), name


def test_assembled_batch_matches_jax(examples):
    corpus = DeviceCorpus.build(examples, "cpu")
    jcorpus = JaxCorpus.build(examples)
    ids = corpus.order_silent_first(range(len(examples)))
    assert ids == jcorpus.order_silent_first(range(len(examples)))
    utt_ids, valid = _ids(ids)
    ref = jax_assemble_batch(jcorpus.arrays, jnp.asarray(utt_ids, jnp.int32),
                             jnp.asarray(valid), n_chunks=N_CHUNKS,
                             seq_len=SEQ_LEN, t_cap=T_CAP, text_cap=128)
    dev = _assemble(corpus, ids)
    for name in dev._fields:  # gathers and copies: exact
        np.testing.assert_array_equal(getattr(dev, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(corpus.text_len_host,
                                  jcorpus.text_len_host)


def test_over_budget_raises_with_its_bytes(examples, monkeypatch):
    monkeypatch.setenv("SSTPU_CACHE_BUDGET_BYTES", "1000")
    with pytest.raises(HBMBudgetError, match="raw_frames=") as err:
        DeviceCorpus.build(examples, "cpu")
    e = err.value
    assert e.budget_bytes == 1000
    assert e.total_bytes == sum(e.breakdown.values())
    raw_rows = sum(ex["raw_emg"].shape[0] // 8 for ex in examples) + 1
    assert e.breakdown["raw_frames"] == raw_rows * 64 * 4
    # without the override the CPU has no budget
    monkeypatch.delenv("SSTPU_CACHE_BUDGET_BYTES")
    DeviceCorpus.build(examples, "cpu")


def test_the_cpu_has_no_budget(monkeypatch):
    monkeypatch.delenv("SSTPU_CACHE_BUDGET_BYTES", raising=False)
    assert device_budget(torch.device("cpu"), 0.4) is None
    monkeypatch.setenv("SSTPU_CACHE_BUDGET_BYTES", "123")
    assert device_budget(torch.device("cpu"), 0.4) == 123


def _trainer(dropout, trainer_cls=TransductionTrainer,
             config_cls=TransductionTrainConfig):
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=8,
                      compute_dtype="float32", dropout=dropout)
    # frames_cap = int(4000·0.51679/6) = 344 → 4 + 2 = 6 chunks of 64,
    # rounded up to 8
    data = DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128)
    trainer = trainer_cls(cfg, data, config_cls(max_batch_len=4000),
                          device="cpu")
    trainer.init_state(3)
    return trainer


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_train_step_ids_is_train_step_on_the_packed_batch(examples, dropout):
    ids = [4, 0, 3, 2]
    host, dev = _trainer(dropout), _trainer(dropout)
    corpus = DeviceCorpus.build(examples, "cpu")
    for lr in (1e-3, 5e-4):  # two steps: the generators stay in step
        ref = host.train_step(host._pack([examples[i] for i in ids]), lr)
        out = dev.train_step_ids(corpus, ids, lr)
        assert torch.equal(out.loss, ref.loss)
        assert int(out.correct_phones) == int(ref.correct_phones)
        assert int(out.total_length) == int(ref.total_length)
    for (name, a), b in zip(dev.model.state_dict().items(),
                            host.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(dev.generator.get_state(), host.generator.get_state())


def test_train_step_ids_declines_a_batch_over_the_caps(examples):
    trainer = _trainer(0.0)
    corpus = DeviceCorpus.build(examples + [example_dict(
        np.random.default_rng(1), 140, False)], "cpu")
    before = [p.clone() for p in trainer.model.parameters()]
    assert trainer.train_step_ids(corpus, [5, 1], 1e-3) is None  # T > t_cap
    assert trainer.train_step_ids(corpus, list(range(5)) * 2, 1e-3) is None
    assert all(torch.equal(a, b) for a, b in
               zip(before, trainer.model.parameters()))
    assert trainer._cache_fits(corpus, [0, 1, 2])


@pytest.mark.parametrize("trainer_cls,config_cls,taken", [
    (TransductionTrainer, TransductionTrainConfig, False),
    (RecognitionTrainer, RecognitionTrainConfig, True)],
    ids=["transduction", "recognition"])
def test_only_batches_with_audio_need_their_targets_within_t_cap(
        examples, trainer_cls, config_cls, taken):
    """A silent utterance whose voiced target (140 frames) is over
    ``t_cap`` (128) while its EMG (55 frames) fits: the transducer, whose
    batches carry that target, declines the batch; the recognizer, whose
    batches carry no audio, steps on it."""
    trainer = _trainer(0.0, trainer_cls, config_cls)
    corpus = DeviceCorpus.build(examples + [example_dict(
        np.random.default_rng(2), 55, True, t_tgt=140, sess=1)], "cpu")
    out = trainer.train_step_ids(corpus, [5, 1], 1e-3)
    assert trainer._cache_fits(corpus, [5, 1]) == taken
    assert (out is not None) == taken
    assert all((p.grad is not None) == taken
               for p in trainer.model.parameters())
    if taken:
        assert torch.isfinite(out)
