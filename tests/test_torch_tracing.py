"""The port's own spans (``utils/profiling.span``).

With no profiler recording, a span is one shared null context and no
profiler range is made. Under ``torch.profiler`` on the CPU, one
``train_step_ids`` of each trainer, at tiny widths with dropout on,
records ``ssp.assemble``, ``ssp.loss`` and ``ssp.backward`` inside
``ssp.step``, the encoder's ``ssp.conv_stack``, and the dropout masks
(``ssp.dropout.mask``) both in the forward and in the backward; the
losses and the updated weights are the same to the bit with and without
the profiler. The private torch names ``span`` rests on are pinned, and a
torch without them fails at import with a message that names them.
"""

import re
import types

import numpy as np
import pytest
import torch

from silent_speech_tpu_torch.config import (DataConfig, ModelConfig,
                                            RecognitionTrainConfig,
                                            TransductionTrainConfig)
from silent_speech_tpu_torch.data.device_cache import DeviceCorpus
from silent_speech_tpu_torch.train.recognition import RecognitionTrainer
from silent_speech_tpu_torch.train.transduction import TransductionTrainer
from silent_speech_tpu_torch.utils import profiling

from torch_port_util import example_dict, one_torch_thread

KINDS = ("recognition", "transduction")
SPANS = {"ssp.step", "ssp.assemble", "ssp.loss", "ssp.backward",
         "ssp.dropout.mask", "ssp.conv_stack"}
IDS = [4, 0, 3, 2]
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    with one_torch_thread():
        yield


def _setup(kind):
    """A trainer at tiny widths with dropout, and a corpus of five
    utterances, from fixed seeds."""
    rng = np.random.default_rng(0)
    examples = [example_dict(rng, 55, True, t_tgt=62, sess=1),
                example_dict(rng, 40, False),
                example_dict(rng, 71, True, t_tgt=66, sess=2),
                example_dict(rng, 33, False, sess=3),
                example_dict(rng, 28, False, sess=1)]
    cfg = ModelConfig(model_size=32, num_layers=1, num_heads=2,
                      dim_feedforward=64, relative_positional_distance=8,
                      compute_dtype="float32", dropout=0.2)
    data = DataConfig(seq_len=64, chunk_bucket=4, utt_cap=8, t_cap=128)
    if kind == "transduction":
        trainer = TransductionTrainer(
            cfg, data, TransductionTrainConfig(max_batch_len=4000),
            device="cpu")
    else:
        trainer = RecognitionTrainer(
            cfg, data, RecognitionTrainConfig(max_batch_len=4000),
            device="cpu")
    trainer.init_state(3)
    return trainer, DeviceCorpus.build(examples, "cpu")


def _step(kind):
    trainer, corpus = _setup(kind)
    out = trainer.train_step_ids(corpus, IDS, LR)
    assert out is not None
    loss = out.loss if hasattr(out, "loss") else out
    return loss, {n: p.detach().clone()
                  for n, p in trainer.model.named_parameters()}


# ---- no profiler, no range ------------------------------------------------
def test_span_without_a_profiler_is_the_shared_null_context():
    assert profiling.span("ssp.step") is profiling.span("ssp.loss")
    with profiling.span("ssp.step") as inside:
        assert inside is None


@pytest.mark.parametrize("kind", KINDS)
def test_a_step_without_a_profiler_makes_no_range(monkeypatch, kind):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was made")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    loss, _ = _step(kind)
    assert torch.isfinite(loss)


# ---- the private names span() rests on ------------------------------------
@pytest.mark.parametrize("module,name", profiling.PRIVATE_NAMES,
                         ids=[n for _, n in profiling.PRIVATE_NAMES])
def test_the_private_torch_names_span_rests_on_exist(module, name):
    assert hasattr(module, name)


def test_a_torch_without_them_fails_with_their_names(monkeypatch):
    module, name = profiling.PRIVATE_NAMES[0]
    monkeypatch.delattr(module, name)
    with pytest.raises(ImportError, match=re.escape(
            f"{module.__name__}.{name}, which torch {torch.__version__}")):
        profiling._private_names_present()


def test_span_under_a_profiler_is_a_host_range_of_its_name():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("ssp.probe"):
            torch.ones(3).sum()
    (probe,) = [ev for ev in prof.profiler.kineto_results.events()
                if ev.name() == "ssp.probe"]
    assert probe.device_type() == torch.autograd.DeviceType.CPU
    assert probe.duration_ns() > 0


# ---- the spans a profiled step records ------------------------------------
def _ranges(prof):
    """(name, thread, start, end) of every ``ssp.`` range."""
    return [(ev.name(), ev.start_thread_id(), ev.start_ns(),
             ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith("ssp.")]


@pytest.fixture(scope="module")
def profiled():
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for kind in KINDS:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            loss, weights = _step(kind)
        out[kind] = types.SimpleNamespace(ranges=_ranges(prof), loss=loss,
                                          weights=weights)
    return out


def _within(inner, lo, hi):
    return inner[2] >= lo and inner[3] <= hi


def _one(ranges, name):
    (found,) = [r for r in ranges if r[0] == name]
    return found


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("span", ["ssp.assemble", "ssp.loss",
                                  "ssp.backward"])
def test_a_profiled_step_records_each_phase_once_inside_the_step(
        profiled, kind, span):
    ranges = profiled[kind].ranges
    step, phase = _one(ranges, "ssp.step"), _one(ranges, span)
    assert phase[1] == step[1] and _within(phase, step[2], step[3])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("where", ["forward", "backward"])
def test_a_profiled_step_draws_dropout_masks_in_forward_and_backward(
        profiled, kind, where):
    # the forward runs between the batch's assembly and the loss, on the
    # stepping thread; the backward regenerates the masks on whichever
    # thread autograd runs it, while the stepping thread is in
    # ssp.backward
    ranges = profiled[kind].ranges
    step = _one(ranges, "ssp.step")
    if where == "forward":
        lo, hi = _one(ranges, "ssp.assemble")[3], _one(ranges, "ssp.loss")[2]
    else:
        lo, hi = _one(ranges, "ssp.backward")[2:]
    masks = [r for r in ranges if r[0] == "ssp.dropout.mask"
             and _within(r, lo, hi)]
    assert masks
    if where == "forward":
        assert all(r[1] == step[1] for r in masks)


@pytest.mark.parametrize("kind", KINDS)
def test_a_profiled_step_opens_the_port_s_spans_and_no_others(profiled,
                                                              kind):
    assert {r[0] for r in profiled[kind].ranges} == SPANS


# ---- the spans change nothing ---------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_a_profiled_step_equals_a_plain_one(profiled, kind):
    loss, weights = _step(kind)
    assert torch.equal(loss, profiled[kind].loss)
    assert weights.keys() == profiled[kind].weights.keys()
    for name, w in weights.items():
        assert torch.equal(w, profiled[kind].weights[name]), name
