"""``metrics/step_launches.py`` on a hand-built trace of two threads: the
device events launched, on either thread, while the stepping thread is
inside ``bench.train_step_ids``, per micro-step; None without that range."""

from __future__ import annotations

import os
import types

import pytest
import torch

from benchmark import harness
from benchmark.trace import Trace


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


STEPPING, AUTOGRAD = 11, 22
US = 1000   # ns
# one micro-step: host ranges (name, thread, start µs, end µs) ...
HOST = [("bench.train_step_ids", STEPPING, 0, 1000),
        ("bench.model.forward", STEPPING, 100, 300),
        ("aten::mm", AUTOGRAD, 400, 800)]
# ... and launches (thread, launched at µs, device µs)
LAUNCHES = [(STEPPING, 30, 5),      # the id upload
            (STEPPING, 250, 11),    # a forward GEMM
            (AUTOGRAD, 450, 17),    # the backward, on autograd's thread
            (STEPPING, 995, 2),     # the call's edge, still inside
            (AUTOGRAD, 1200, 3),    # autograd's thread after the call
            (STEPPING, 1500, 7)]    # the stepping thread between calls
INSIDE = 4
MICRO_STEPS = 2


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


def _read(trace, micro_steps=MICRO_STEPS):
    reader = harness.load_file(
        os.path.join(harness.PACKAGE, "metrics", "step_launches.py"),
        "metric_step_launches")
    traced = harness.Window(seconds=trace.window_s, frames=[1, 1],
                            micro_steps=micro_steps, updates=micro_steps)
    run = harness.Run(None, torch.device("cpu"), 0.0, traced, 0,
                      traced=traced, trace=trace)
    return reader.read(run)


def test_step_launches_counts_either_thread_inside_the_step_call():
    assert _read(_trace()) == pytest.approx(INSIDE, rel=1e-12, abs=0)


@pytest.mark.parametrize("drop,micro_steps", [
    (("bench.train_step_ids",), MICRO_STEPS), ((), 0)])
def test_step_launches_reads_none_without_a_step_call(drop, micro_steps):
    assert _read(_trace(drop), micro_steps) is None
