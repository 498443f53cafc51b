"""Checkpoints of the port: the full train state round-trips exactly,
the step generator included, and ``model.pt`` loads strictly into the
encoder."""

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.train.checkpoint import (
    checkpoint_exists, export_reference_checkpoint, restore_checkpoint,
    save_checkpoint)
from silent_speech_tpu_torch.train.transduction import TransductionTrainer

from torch_port_util import example_dict, one_torch_thread

CFG = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                  dim_feedforward=64, relative_positional_distance=8,
                  compute_dtype="float32", dropout=0.2)


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _trainer(seed):
    trainer = TransductionTrainer(
        CFG, DataConfig(seq_len=40, fixed_shapes=False),
        TransductionTrainConfig(), device="cpu")
    trainer.init_state(seed)
    return trainer


def _examples():
    rng = np.random.default_rng(0)
    return [example_dict(rng, 50, True, t_tgt=55), example_dict(rng, 37,
                                                                False)]


def _state(trainer):
    opt = trainer.optimizer
    return (trainer.model.state_dict(), opt.mu, opt.nu, opt.count,
            trainer.generator.get_state())


def test_restore_is_exact_and_the_next_step_repeats(tmp_path):
    trainer = _trainer(0)
    batch = trainer._pack(_examples())
    trainer.train_step(batch, 1e-3)
    extra = {"epoch": 3, "global_step": 1,
             "plateau": {"best": 1.5, "num_bad_epochs": 2, "scale": 0.5}}
    save_checkpoint(str(tmp_path), trainer, extra)
    assert checkpoint_exists(str(tmp_path))
    model, mu, nu, count, gen = _state(trainer)
    saved = ({k: v.clone() for k, v in model.items()},
             [m.clone() for m in mu], [v.clone() for v in nu], count, gen)
    after = trainer.train_step(batch, 1e-3)

    other = _trainer(7)          # other weights and another generator
    assert restore_checkpoint(str(tmp_path), other) == extra
    model, mu, nu, count, gen = _state(other)
    for name, v in saved[0].items():
        assert torch.equal(model[name], v), name
    assert all(torch.equal(a, b) for a, b in zip(mu + nu,
                                                 saved[1] + saved[2]))
    assert count == saved[3] == 1 and torch.equal(gen, saved[4])
    # dropout 0.2: the restored generator draws the same shift and masks
    again = other.train_step(batch, 1e-3)
    assert torch.equal(again.loss, after.loss)
    for a, b in zip(other.model.parameters(), trainer.model.parameters()):
        assert torch.equal(a, b)


def test_model_pt_loads_strictly(tmp_path):
    trainer = _trainer(1)
    trainer.train_step(trainer._pack(_examples()), 1e-3)
    path = str(tmp_path / "model.pt")
    export_reference_checkpoint(trainer.model, path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model = EMGEncoder(80, 48, CFG)
    model.load_state_dict(state, strict=True)
    for name, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[name], v), name
    assert EMGEncoder.from_state_dict(state).cfg.model_size == 32


def test_restore_without_a_checkpoint_raises(tmp_path):
    assert not checkpoint_exists(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _trainer(0))


def test_start_training_from_loads_a_model_pt(tmp_path):
    source = _trainer(5)
    path = str(tmp_path / "model.pt")
    export_reference_checkpoint(source.model, path)
    trainer = TransductionTrainer(
        CFG, DataConfig(seq_len=40, fixed_shapes=False),
        TransductionTrainConfig(start_training_from=path), device="cpu")
    trainer.init_state(0)
    assert _state_equal(trainer.model.state_dict(),
                        source.model.state_dict())


def _state_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
