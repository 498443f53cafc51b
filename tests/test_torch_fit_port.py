"""The port's ``fit()`` on its own: the device-corpus path against the host
packing path (bit for bit), the fallbacks, the ``log.txt`` lines, the stop
on a non-finite loss, resume, and ``data_size_fraction``."""

import logging

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data.dataset import ExampleList
from silent_speech_tpu_torch.data.sampler import SizeAwareSampler
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import example_dict, one_torch_thread, record_calls

MODEL = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                    dim_feedforward=64, relative_positional_distance=8,
                    compute_dtype="float32", dropout=0.2)
# frames_cap = int(4000·0.51679/6) = 344 → 6 + 2 chunks of 64
MAX_BATCH_LEN = 4000


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _data(seed=0, n=30):
    rng = np.random.default_rng(seed)
    train = ExampleList([example_dict(rng, int(rng.integers(20, 70)),
                                      i % 3 == 0, t_tgt=40 + i, text=f"u{i}")
                         for i in range(n)])
    dev = ExampleList([example_dict(rng, 45, True, t_tgt=50),
                       example_dict(rng, 30, False)])
    return train, dev


def _trainer(out_dir, device_cache=True, **train_kw):
    data = DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128,
                      device_cache=device_cache)
    train = TransductionTrainConfig(max_batch_len=MAX_BATCH_LEN,
                                    learning_rate_warmup=2,
                                    output_directory=str(out_dir),
                                    **train_kw)
    trainer = TransductionTrainer(MODEL, data, train, device="cpu")
    trainer.init_state(0)
    return trainer


def _fit(trainer, train, dev, epochs=2, **kw):
    steps, ids_steps = [], []
    record_calls(trainer, "train_step", steps)
    record_calls(trainer, "train_step_ids", ids_steps)
    trainer.fit(train, dev, epochs=epochs, **kw)
    return steps, [o for o in ids_steps if o is not None]


def test_device_corpus_path_is_the_host_path(tmp_path):
    train, dev = _data()
    host = _trainer(tmp_path / "host", device_cache=False)
    dev_ = _trainer(tmp_path / "dev")
    host_steps, _ = _fit(host, train, dev)
    fallback, ids_steps = _fit(dev_, train, dev)
    assert not fallback and len(ids_steps) == len(host_steps) > 4
    assert torch.equal(torch.stack([o.loss for o in ids_steps]),
                       torch.stack([o.loss for o in host_steps]))
    for (name, a), b in zip(dev_.model.state_dict().items(),
                            host.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_a_batch_over_the_caps_is_packed_on_the_host(tmp_path):
    train, dev = _data()
    train.examples[5] = example_dict(np.random.default_rng(3), 150, False,
                                     text="long")   # T > t_cap = 128
    trainer = _trainer(tmp_path)
    host_steps, ids_steps = _fit(trainer, train, dev, epochs=1)
    assert len(host_steps) == 1 and len(ids_steps) > 1


def test_over_budget_trains_on_the_host_path(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("SSTPU_CACHE_BUDGET_BYTES", "1000")
    train, dev = _data()
    trainer = _trainer(tmp_path)
    with caplog.at_level(logging.WARNING):
        host_steps, ids_steps = _fit(trainer, train, dev, epochs=1)
    assert host_steps and not ids_steps
    assert "over budget" in caplog.text and "raw_frames=" in caplog.text


def test_log_lines_checkpoint_and_model_pt(tmp_path, caplog):
    train, dev = _data()
    trainer = _trainer(tmp_path)
    with caplog.at_level(logging.INFO):
        trainer.fit(train, dev, epochs=2, eval_every=2)
    lines = caplog.messages
    assert any(m.startswith("finished epoch 1 - training loss: ")
               for m in lines)
    assert any(m.startswith("finished epoch 2 - validation loss: ")
               and "phoneme accuracy: " in m for m in lines)
    assert any(m.startswith("epoch 2: ") and "steps/s)" in m for m in lines)
    assert (tmp_path / "checkpoint.pt").is_file()
    state = torch.load(tmp_path / "model.pt", weights_only=True)
    assert all(torch.equal(state[k], v.cpu())
               for k, v in trainer.model.state_dict().items())


class _HostReads(torch.Tensor):
    """A step output that counts the calls that would bring it to the host
    (on the card each is a sync); what they return is a plain tensor."""
    reads = []
    READS = {torch.Tensor.cpu, torch.Tensor.item, torch.Tensor.tolist,
             torch.Tensor.numpy, torch.Tensor.__float__,
             torch.Tensor.__int__, torch.Tensor.__index__,
             torch.Tensor.__bool__, torch.Tensor.__array__,
             torch.Tensor.__format__, torch.Tensor.__repr__}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        to_host = func is torch.Tensor.to and any(
            isinstance(a, (str, torch.device))
            for a in list(args[1:]) + list(kwargs.values()))
        out = super().__torch_function__(func, types, args, kwargs)
        if func in cls.READS or to_host:
            cls.reads.append(func.__name__)
            if isinstance(out, torch.Tensor):
                out = out.as_subclass(torch.Tensor)
        return out


@pytest.mark.parametrize("device_cache", [True, False],
                         ids=["device_corpus", "host_packing"])
def test_fit_reads_the_step_outputs_once_an_epoch(tmp_path, device_cache):
    """The step losses stay on the device and are read once an epoch, so
    steps queue without a sync (a read per step would stall the card)."""
    train, dev = _data()
    trainer = _trainer(tmp_path, device_cache=device_cache)
    steps = []
    for name in ("train_step_ids", "train_step"):
        fn = getattr(trainer, name)

        def counted(*args, fn=fn):
            out = fn(*args)
            if out is None:
                return None
            steps.append(out)
            return out._replace(**{
                f: v.as_subclass(_HostReads) for f, v in
                out._asdict().items() if isinstance(v, torch.Tensor)})

        setattr(trainer, name, counted)
    _HostReads.reads.clear()
    trainer.fit(train, dev, epochs=3)
    assert len(steps) > 3 * 4
    assert _HostReads.reads == ["cpu"] * 3


def test_a_non_finite_loss_stops_training(tmp_path):
    train, dev = _data()
    train.examples[2]["raw_emg"] = np.full_like(train[2]["raw_emg"], np.nan)
    with pytest.raises(FloatingPointError):
        _trainer(tmp_path).fit(train, dev, epochs=2)
    assert not (tmp_path / "checkpoint.pt").exists()


def test_resume_restores_the_saved_state(tmp_path):
    train, dev = _data()
    first = _trainer(tmp_path)
    _fit(first, train, dev, epochs=2, seed=4)
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    saved_gen = first.generator.get_state()
    saved_count = first.optimizer.count

    resumed = _trainer(tmp_path)
    resumed.init_state(9)               # other weights, another generator
    restored, seen = {}, []
    step_ids = resumed.train_step_ids

    def spy(corpus, ids, lr):
        if not seen:  # the state fit() resumed with, before its first step
            restored.update(model={k: v.clone() for k, v in
                                   resumed.model.state_dict().items()},
                            gen=resumed.generator.get_state(),
                            count=resumed.optimizer.count)
        seen.append(list(ids))
        return step_ids(corpus, ids, lr)

    resumed.train_step_ids = spy
    resumed.fit(train, dev, epochs=3, seed=4, resume=True)
    assert all(torch.equal(restored["model"][k], v)
               for k, v in saved.items())
    assert torch.equal(restored["gen"], saved_gen)
    assert restored["count"] == saved_count
    # one epoch was left; as in JAX, the sampler is built after the
    # restore, so that epoch shuffles as the run's first did
    assert seen == list(SizeAwareSampler(train, MAX_BATCH_LEN, seed=4))
    extra = torch.load(tmp_path / "checkpoint.pt", weights_only=True)[
        "extra"]
    assert extra["epoch"] == 3
    assert extra["global_step"] == saved_count + len(seen)


def test_batches_packs_the_sampler_batches(tmp_path):
    train, _ = _data()
    trainer = _trainer(tmp_path)
    got = list(trainer.batches(train, seed=3))
    want = [trainer._pack([train[i] for i in ids]) for ids in
            SizeAwareSampler(train, MAX_BATCH_LEN, seed=3)]
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert np.array_equal(a.raw_emg, b.raw_emg)
        assert np.array_equal(a.utt_len, b.utt_len)


def test_data_size_fraction_trains_on_a_prefix(tmp_path, monkeypatch):
    train, dev = _data()
    trainer = _trainer(tmp_path, data_size_fraction=0.5)
    seen = []
    fit_sampler = SizeAwareSampler.__iter__

    def spy(self):
        seen.append([self.dataset[i] for i in range(len(self.dataset))])
        return fit_sampler(self)

    monkeypatch.setattr(SizeAwareSampler, "__iter__", spy)
    trainer.fit(train, dev, epochs=1)
    assert len(seen) == 1 and seen[0] == train.examples[:15]
