"""The float32 cell's four readers on a hand-built trace: the f32 attention
rooflines (the frozen bounds at the float32 peak over the device time in
``bench.rel_attention`` / ``bench.rel_attention_bwd``), the conv stack's
device ms a micro-step in ``bench.conv_block``, and the step's share of
the float32 peak. The f32 attention readers give None on a bf16 call, the
conv reader None without ``bench.conv_block``, the share None for a bf16
configuration."""

from __future__ import annotations

import os
import types

import pytest
import torch

from benchmark import bounds, flops, harness
from benchmark.tests import tiny
from benchmark.trace import Trace

CELL = "transduction-f32-train"
STEPPING, AUTOGRAD = 11, 22
US = 1000   # ns
# host ranges of one micro-step: (name, thread, start µs, end µs) ...
HOST = [("bench.train_step_ids", STEPPING, 0, 1000),
        ("bench.conv_block", STEPPING, 100, 150),
        ("bench.rel_attention", STEPPING, 200, 300),
        ("bench.rel_attention_bwd", AUTOGRAD, 500, 700)]
# ... and launches: (thread, launched at µs, device µs)
LAUNCHES = [(STEPPING, 110, 40), (STEPPING, 140, 20),   # the conv stack
            (STEPPING, 250, 300),                        # attention fwd
            (AUTOGRAD, 550, 500), (AUTOGRAD, 650, 200),  # attention bwd
            (STEPPING, 900, 70)]                         # elsewhere
CONV_US, FWD_US, BWD_US = 60, 300, 700
MICRO_STEPS = 2
SHAPE = dict(b=120, h=8, t=200, dh=96, m=100)


class _Event:
    def __init__(self, name, device, start, dur, tid=0, corr=0, linked=0):
        self._v = (name, device, start, dur, tid, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _trace(drop=()):
    from torch.autograd import DeviceType

    events, corr = [], 0
    for step in range(MICRO_STEPS):
        t0 = 2000 * step
        for name, tid, s, e in HOST:
            if name not in drop:
                events.append(_Event(name, DeviceType.CPU, (t0 + s) * US,
                                     (e - s) * US, tid))
        for tid, at, dur in LAUNCHES:
            corr += 1
            events.append(_Event("cudaLaunchKernel", DeviceType.CPU,
                                 (t0 + at) * US, US, tid, corr, corr))
            events.append(_Event(f"kernel_{corr}", DeviceType.CUDA,
                                 (t0 + at + 1) * US, dur * US, corr=corr))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return Trace(prof, window_s=2000 * MICRO_STEPS * US / 1e9)


def _calls(dtype="float32"):
    fwd = dict(SHAPE, valid_len=SHAPE["t"], dtype=dtype)
    bwd = dict(SHAPE, dtype=dtype)
    return {"rel_attention": [fwd] * MICRO_STEPS,
            "rel_attention_bwd": [bwd] * MICRO_STEPS,
            "conv_block": [dict(dtype=dtype)] * 3 * MICRO_STEPS}


def _read(metric, trace=None, calls=None, config=None):
    reader = harness.load_file(
        os.path.join(harness.PACKAGE, "metrics", f"{metric}.py"),
        f"metric_{metric}")
    cell = tiny.cell(CELL, config={}, traffic={})
    cell.config.update(config or {})
    window = harness.Window(seconds=2.0, frames=[20000, 21000],
                            micro_steps=MICRO_STEPS, updates=MICRO_STEPS)
    run = harness.Run(cell, torch.device("cpu"), 0.0, window, 0,
                      traced=window, trace=trace,
                      calls=_calls() if calls is None else calls)
    return reader.read(run)


def test_attention_f32_forward_roofline():
    bound = bounds.attention_bound(**SHAPE, valid_len=SHAPE["t"],
                                   dtype_name="float32")
    assert bound[1] == "operations"
    want = 100.0 * MICRO_STEPS * bound[0] / (1e-3 * MICRO_STEPS * FWD_US)
    assert _read("attn_f32_fwd_roofline_pct", _trace()) == \
        pytest.approx(want, rel=1e-12)


def test_attention_f32_backward_roofline():
    bound = bounds.attention_bwd_bound(**SHAPE, dtype_name="float32")
    assert bound[1] == "operations"
    want = 100.0 * MICRO_STEPS * bound[0] / (1e-3 * MICRO_STEPS * BWD_US)
    assert _read("attn_f32_bwd_roofline_pct", _trace()) == \
        pytest.approx(want, rel=1e-12)


def test_conv_stack_forward_ms_a_micro_step():
    assert _read("conv_fwd_f32_ms", _trace()) == \
        pytest.approx(CONV_US * 1e-3, rel=1e-12)


def test_step_share_of_the_float32_peak():
    cfg = tiny.cell(CELL, config={}, traffic={}).config
    want = 100.0 * sum(flops.step_flops(cfg, f) for f in (20000, 21000)) \
        / 2.0 / 67e12
    assert _read("step_mfu_f32_pct") == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", ["attn_f32_fwd_roofline_pct",
                                    "attn_f32_bwd_roofline_pct",
                                    "conv_fwd_f32_ms"])
def test_the_f32_readers_read_nothing_on_a_bf16_call(metric):
    assert _read(metric, _trace(), calls=_calls("bfloat16")) is None


def test_the_f32_readers_read_nothing_where_one_call_is_bf16():
    calls = _calls()
    calls["rel_attention"] = calls["rel_attention"][:1] + _calls(
        "bfloat16")["rel_attention"][:1]
    assert _read("attn_f32_fwd_roofline_pct", _trace(), calls=calls) is None


def test_conv_reader_reads_nothing_without_its_span():
    assert _read("conv_fwd_f32_ms", _trace(drop=("bench.conv_block",)),
                 calls={}) is None
    assert _read("conv_fwd_f32_ms", _trace(drop=("bench.conv_block",))) \
        is None


def test_the_f32_share_reads_nothing_for_a_bf16_configuration():
    assert _read("step_mfu_f32_pct",
                 config=dict(compute_dtype="bfloat16")) is None
