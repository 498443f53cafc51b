"""The float32 training step computes in float32 (``utils.device.full_fp32``)
and the benchmark's float32 cell runs through the harness.

A float32 step of either trainer runs with TF32 off in cuBLAS and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, read in the forward and in the
backward) and restores both flags afterwards; a bf16 step leaves them as
they are. ``full_fp32.steps`` counts one a (micro-)step. The encoder's
training forward opens ``ssp.conv_stack`` around its three ResBlocks.
``transduction-f32-train`` runs at the tiny size on the CPU and is
``correct`` against its limits; the program in bf16, judged against the
same limits, is not; a program without the full-FP32 scope does not run
the cell. Each number the cell compares has a limit between its readings.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny
from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            RecognitionTrainConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
from silent_speech_tpu_torch.models.encoder import EMGEncoder
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
from silent_speech_tpu_torch.train.transduction import TransductionTrainer
from silent_speech_tpu_torch.utils.device import full_fp32

from torch_port_util import example_dict

KINDS = ("recognition", "transduction")
DTYPES = ("float32", "bfloat16")
IDS = [4, 0, 3, 2]
LR = 1e-3
CELL = "transduction-f32-train"


@pytest.fixture(autouse=True)
def one_thread_and_flags():
    """One torch thread; both TF32 flags as they were after the test."""
    threads = torch.get_num_threads()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _trainer(kind, dtype, grad_accum=1):
    """A trainer at tiny widths in ``dtype`` with dropout, and a corpus of
    five utterances, from fixed seeds."""
    rng = np.random.default_rng(0)
    examples = [example_dict(rng, 55, True, t_tgt=62, sess=1),
                example_dict(rng, 40, False),
                example_dict(rng, 71, True, t_tgt=66, sess=2),
                example_dict(rng, 33, False, sess=3),
                example_dict(rng, 28, False, sess=1)]
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=8,
                      compute_dtype=dtype, dropout=0.2)
    data = DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128)
    if kind == "transduction":
        trainer = TransductionTrainer(
            cfg, data, TransductionTrainConfig(max_batch_len=4000,
                                               moment_dtype=dtype),
            device="cpu")
    else:
        trainer = RecognitionTrainer(
            cfg, data, RecognitionTrainConfig(max_batch_len=4000,
                                              moment_dtype=dtype,
                                              grad_accum=grad_accum),
            device="cpu")
    trainer.init_state(3)
    return trainer, DeviceCorpus.build(examples, "cpu")


def _record_flags(model):
    """Record both flags in the model's forward and, through a hook on its
    output, in the backward."""
    seen = []

    def hook(module, args, out):
        seen.append(("forward", _flags()))
        first = out[0] if isinstance(out, tuple) else out
        first.register_hook(lambda g: seen.append(("backward", _flags())))

    model.register_forward_hook(hook)
    return seen


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_step_computes_in_its_dtype_and_restores_the_flags(kind, dtype):
    trainer, corpus = _trainer(kind, dtype)
    seen = _record_flags(trainer.model)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    before = full_fp32.steps
    out = trainer.train_step_ids(corpus, IDS, LR)
    loss = out.loss if hasattr(out, "loss") else out
    assert torch.isfinite(loss)
    assert [where for where, _ in seen] == ["forward", "backward"]
    inside = (False, False) if dtype == "float32" else (True, True)
    assert all(flags == inside for _, flags in seen), seen
    assert _flags() == (True, True)
    assert full_fp32.steps - before == (dtype == "float32")


@pytest.mark.parametrize("kind", KINDS)
def test_the_counter_counts_one_a_micro_step(kind):
    trainer, corpus = _trainer(kind, "float32", grad_accum=2)
    before = full_fp32.steps
    for _ in range(3):
        assert trainer.train_step_ids(corpus, IDS, LR) is not None
    assert full_fp32.steps - before == 3


def test_the_scope_restores_the_flags_on_an_error():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = False
    with pytest.raises(ValueError):
        with full_fp32():
            assert _flags() == (False, False)
            raise ValueError
    assert _flags() == (True, False)


def test_the_training_forward_opens_the_conv_stack_span():
    from torch.profiler import ProfilerActivity, profile

    model = EMGEncoder(80, 48, ModelConfig(
        model_size=32, num_layers=1, num_heads=2, dim_feedforward=64,
        relative_positional_distance=8, compute_dtype="float32",
        dropout=0.2))
    model.init_weights(torch.Generator().manual_seed(0))
    raw = torch.randn(2, 8 * 32, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(raw, train=True, generator=torch.Generator().manual_seed(1))
    events = list(prof.profiler.kineto_results.events())
    (stack,) = [ev for ev in events if ev.name() == "ssp.conv_stack"]
    lo, hi = stack.start_ns(), stack.start_ns() + stack.duration_ns()
    convs = [ev for ev in events if ev.name() == "aten::conv1d"]
    assert len(convs) == 9     # three convolutions a ResBlock
    assert all(lo <= ev.start_ns() and ev.start_ns() + ev.duration_ns()
               <= hi for ev in convs)


# ---- the benchmark's float32 cell, at the tiny size -----------------------
@pytest.mark.parametrize("trace", [False, True])
def test_the_f32_cell_runs_and_is_correct(trace):
    line = tiny.run(CELL, trace=trace)
    assert line["correct"] is True
    assert line["checks"]     # the limits compare at least one number
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert line["attempted"] > 0
    # the reference computes the transduction loss for this entry: the
    # first update's losses agree to float32's rounding
    assert line["checks"]["loss_gap"]["value"] < 1e-5
    if trace:
        assert set(line["metrics"]) == {"step_mfu_f32_pct"}
    else:
        assert {"train_frames_per_s", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_the_program_in_bf16_is_not_correct_against_the_f32_limits(seed):
    cell = tiny.cell(CELL)
    cell.config.update(compute_dtype="bfloat16", moment_dtype="bfloat16")
    line = harness.run_cell(tiny.ROOT, CELL, seed, 0.3, False, "cpu",
                            time.perf_counter(), cell=cell)
    assert line["correct"] is False


def test_a_program_without_the_scope_does_not_run_the_f32_cell(monkeypatch):
    from silent_speech_tpu_torch.utils import device

    monkeypatch.delattr(device, "full_fp32")
    with pytest.raises(RuntimeError, match="no full-FP32 step"):
        tiny.run(CELL)


LIMITS = "benchmark/reference/limits/gaddy21-transduction-f32.json"
COMPARED = ("head_gap", "grad_gap_median", "grad_gap", "change_gap",
            "loss_gap")


@pytest.mark.parametrize("name", COMPARED)
def test_each_f32_limit_lies_between_its_readings(name):
    """Every number the float32 configuration compares has a limit above
    its widest sound reading and below its upper reading."""
    with open(os.path.join(tiny.ROOT, LIMITS)) as f:
        entry = json.load(f)[name]
    assert entry["lower"] < entry["limit"] < entry["upper"]
    assert entry["lower_from"] and entry["upper_from"]
