"""The port's recognition training run: resume restores the saved state
(the half-full gradient accumulator included), the device corpus trains
as host packing does, the ``log.txt`` lines, an infeasible CTC target
trains on with the JAX trainer's step losses, and the LM's load
contract. The one test that builds a JAX trainer restores JAX's PRNG
implementation after it."""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import DataConfig, RecognitionTrainConfig
from silent_speech_tpu_torch.data.dataset import ExampleList
from silent_speech_tpu_torch.text import TextTransform
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer

from test_kenlm_binary import ARPA
from torch_port_util import (TINY, jax_prng_impl_restored, one_torch_thread,
                             random_variables, record_calls, tiny_config)

SENTENCES = ("the cat", "the dog", "cat the dog", "a cat sat", "dog ran",
             "the the cat")
# float32 on both sides, sums in another order: step losses to 1e-5
# relative, as in test_torch_recognition_fit.py
STEP_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _example(rng, t, silent, sentence):
    ex = {"emg": np.zeros((t, 112), np.float32),
          "raw_emg": rng.normal(size=(t * 8, 8)).astype(np.float32),
          "session_ids": np.zeros(t, np.int64), "silent": silent,
          "text": sentence,
          "text_int": np.asarray(TextTransform().text_to_int(sentence),
                                 np.int64),
          "phonemes": rng.integers(0, 48, size=t)}
    key = "parallel_voiced_audio_features" if silent else "audio_features"
    ex[key] = rng.normal(size=(t, 80)).astype(np.float32)
    return ex


def _datasets(n_train=9):
    rng = np.random.default_rng(4)
    train = [_example(rng, 40 + (i % 3) * 4, i % 4 == 0, SENTENCES[i % 6])
             for i in range(n_train)]
    dev = [_example(rng, 36, False, "the cat"),
           _example(rng, 44, True, "dog the")]
    return ExampleList(train), ExampleList(dev)


def _trainer(out_dir, fixed_shapes=False, device_cache=True, **train_kw):
    cfg = dataclasses.replace(tiny_config(), dropout=0.1,
                              shift_augment=True)
    data = DataConfig(seq_len=48, chunk_bucket=2, utt_cap=4, t_cap=64,
                      fixed_shapes=fixed_shapes, device_cache=device_cache)
    # 1600 raw samples: 3 utterances a batch, 3 micro-steps an epoch; the
    # caps: int(1600·0.51679/6) = 137 frames → 3 + 2 chunks of 48,
    # rounded up to 6
    kw = dict(learning_rate=1e-3, learning_rate_warmup=2, max_batch_len=1600,
              output_directory=str(out_dir), lm_path="", beam_width=4)
    train = RecognitionTrainConfig(**{**kw, **train_kw})
    return RecognitionTrainer(cfg, data, train, device="cpu")


def test_resume_restores_the_saved_state(tmp_path):
    train, dev = _datasets()
    first = _trainer(tmp_path)
    steps = []
    record_calls(first, "train_step", steps)
    first.fit(train, dev, epochs=1)
    # an odd number of micro-steps: the checkpoint holds half a group
    assert len(steps) % 2 == 1 and first.optimizer.mini_step == 1
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    opt = first.optimizer

    second = _trainer(tmp_path)
    second.init_state(5)   # other weights, overwritten by the restore
    seen = {}
    step = second.train_step

    def first_step(*args):
        if not seen:
            o = second.optimizer
            seen.update(
                model=all(torch.equal(v, saved[k]) for k, v in
                          second.model.state_dict().items()),
                moments=all(torch.equal(a, b) for a, b in
                            zip(o.mu + o.nu, opt.mu + opt.nu)),
                acc=all(torch.equal(a, b) for a, b in zip(o.acc, opt.acc)),
                mini_step=o.mini_step == 1, count=o.count == opt.count,
                generator=torch.equal(second.generator.get_state(),
                                      first.generator.get_state()))
        return step(*args)

    second.train_step = first_step
    second.fit(train, dev, epochs=2, resume=True)
    assert seen and all(seen.values()), seen


def test_device_corpus_trains_as_host_packing_does(tmp_path):
    train, dev = _datasets()
    runs = {}
    for cache in (True, False):
        tr = _trainer(tmp_path / str(cache), fixed_shapes=True,
                      device_cache=cache)
        ids, host = [], []
        record_calls(tr, "train_step_ids", ids)
        record_calls(tr, "train_step", host)
        tr.fit(train, dev, epochs=2)
        runs[cache] = (ids, host, tr.model.state_dict())
    (ids, host, state), (no_ids, packed, ref_state) = runs[True], runs[False]
    assert ids and not host and not no_ids
    assert all(o is not None for o in ids)
    assert torch.equal(torch.stack(ids), torch.stack(packed))
    for k, v in state.items():
        assert torch.equal(v, ref_state[k]), k


def test_fit_logs_the_jax_lines(tmp_path, caplog):
    train, dev = _datasets()
    tr = _trainer(tmp_path, lr_milestones=(1,))
    with caplog.at_level(logging.INFO):
        tr.fit(train, dev, epochs=2)
    lines = [r.getMessage() for r in caplog.records]
    for epoch in (1, 2):
        line = next(m for m in lines
                    if m.startswith(f"finished epoch {epoch} - "))
        loss, wer = line.split("training loss: ")[1].split(
            " validation WER: ")
        assert np.isfinite(float(loss)) and float(wer) >= 0
    assert (tmp_path / "model.pt").is_file()
    assert (tmp_path / "checkpoint.pt").is_file()
    extra = torch.load(tmp_path / "checkpoint.pt",
                       weights_only=True)["extra"]
    assert extra["epoch"] == 2 and extra["lr_scale"] == 0.5


def _jax_fit_step_losses(variables, train, dev, out_dir):
    """The JAX trainer's ``fit()`` for one epoch at the tiny geometry in
    float32, dropout and shift off, from ``variables``: its step losses.
    No whole padding chunks (chunk bucket 1, one-device mesh)."""
    from silent_speech_tpu.config import Config
    from silent_speech_tpu.parallel.mesh import make_mesh
    from silent_speech_tpu.train.recognition import \
        RecognitionTrainer as JaxTrainer

    cfg = Config()
    m = cfg.model
    m.model_size, m.num_layers, m.num_heads = 64, 2, 2
    m.dim_feedforward, m.relative_positional_distance = 128, 16
    m.dropout, m.compute_dtype, m.shift_augment = 0.0, "float32", False
    m.fused_attention = False
    cfg.data.seq_len, cfg.data.chunk_bucket = 48, 1
    cfg.data.fixed_shapes = False
    r = cfg.recognition
    r.learning_rate, r.learning_rate_warmup = 1e-4, 2
    r.max_batch_len, r.output_directory, r.lm_path = 1600, out_dir, ""
    r.beam_width = 4
    trainer = JaxTrainer(cfg, mesh=make_mesh(1, 1,
                                             devices=jax.devices()[:1]))
    trainer.init_state(trainer._pack([train[0]]), seed=0)
    trainer.state = trainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    steps = []
    record_calls(trainer, "_train_step", steps)
    trainer.fit(train, dev, epochs=1, seed=0)
    return [float(m["loss"]) for _, m in steps]


def test_an_infeasible_target_trains_on_as_in_jax(tmp_path):
    # 31 characters over 12 frames: CTC has no path. optax's clamped lattice
    # gives a finite loss (~1e5 for the row), so the JAX trainer trains on;
    # the port's CTC runs the same lattice, and its fit() takes the same
    # steps with the same losses (ROADMAP.md, fault 8)
    from silent_speech_tpu.models.encoder import EMGEncoder as JaxEncoder
    from silent_speech_tpu_torch.models.convert import jax_to_torch

    train, dev = _datasets()
    rng = np.random.default_rng(0)
    bad = _example(rng, 12, False, "the cat the dog the cat the dog")
    train = ExampleList([bad] + list(train))
    variables = random_variables(JaxEncoder(
        num_outs=38, num_aux_outs=None, dropout=0.0, fused_attention=False,
        shift_augment=False, **TINY), seed=3)
    with jax_prng_impl_restored():
        ref = _jax_fit_step_losses(variables, train, dev,
                                   str(tmp_path / "jax"))
    trainer = RecognitionTrainer(
        tiny_config(), DataConfig(seq_len=48, chunk_bucket=1,
                                  fixed_shapes=False),
        RecognitionTrainConfig(learning_rate=1e-4, learning_rate_warmup=2,
                               max_batch_len=1600, lm_path="",
                               beam_width=4,
                               output_directory=str(tmp_path / "port")),
        device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(
        jax_to_torch(variables["params"], variables["batch_stats"]))
    steps = []
    record_calls(trainer, "train_step", steps)
    trainer.fit(train, dev, epochs=1, seed=0)
    losses = [float(s) for s in steps]
    assert len(losses) == len(ref) >= 3
    # the batch with the infeasible row: its ~1e5 NLL over 31 characters
    assert max(ref) > 1e3 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref, rtol=STEP_RTOL)
    assert (tmp_path / "port" / "model.pt").is_file()


def test_the_lm_load_contract(tmp_path, caplog):
    tr = _trainer(tmp_path, lm_path=str(tmp_path / "missing.arpa"))
    with pytest.raises(FileNotFoundError):
        tr._get_lm()
    # the default path, absent: decode without an LM, and say so once
    default = _trainer(tmp_path, lm_path="lm.binary")
    monkey_cwd = tmp_path / "empty"
    monkey_cwd.mkdir()
    with pytest.MonkeyPatch.context() as mp, caplog.at_level(logging.INFO):
        mp.chdir(monkey_cwd)
        assert default._get_lm() is None and default._get_lm() is None
    assert sum("WITHOUT an LM" in r.getMessage()
               for r in caplog.records) == 1
    (tmp_path / "lm.arpa").write_text(ARPA)
    arpa = _trainer(tmp_path, lm_path=str(tmp_path / "lm.arpa"))
    assert arpa._get_lm().order == 3
