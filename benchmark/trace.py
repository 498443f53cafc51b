"""What a traced window's profile says: device busy time, the device time
inside each span, the busiest operations and where the device waited.

The busy time is the union of the device events' intervals (kernels may
overlap, as cuDNN's grouped convolutions do): the idle-share computation of
``chip_smoke.py``'s ``device_profile``, frozen here. A device event
belongs to a span when the runtime call that launched it (the profiler
gives both one correlation id) was made inside one of the span's ranges,
on the same thread: so the kernels that a library launches from ctypes,
and those of a backward on autograd's thread, count where they were
issued. A span's device time is the sum of its events' durations. Each
idle gap is named by what the stepping thread was doing when it began
(its innermost ``bench.`` span and innermost operation), and the gaps are
summed by name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .spans import PREFIX

TOP = 10
PROFILER_OWN = "Activity Buffer"   # the profiler's own host events


class Trace:
    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        device, host, launch = [], [], {}
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                if ev.name().startswith(PREFIX):
                    continue    # a span's range drawn on the device
                device.append((start, end, ev.name(), ev.correlation_id()))
            elif ev.device_type() == DeviceType.CPU:
                if ev.linked_correlation_id() or ev.name().startswith("cu"):
                    # a runtime call (a launch, a copy), by its correlation
                    launch[ev.correlation_id()] = (ev.start_thread_id(),
                                                   start)
                elif not ev.name().startswith(PROFILER_OWN):
                    host.append((start, end, ev.name(),
                                 ev.start_thread_id()))
        self.device = sorted(device)
        self.host = host
        self._launch = launch
        self._ranges: Dict[str, Dict[int, Tuple[list, list]]] = {}
        for s, e, name, tid in sorted(host):
            if name.startswith(PREFIX):
                span = self._ranges.setdefault(name[len(PREFIX):], {})
                starts, ends = span.setdefault(tid, ([], []))
                starts.append(s)
                ends.append(e)
        self.busy_s, self._gaps = self._union()

    def _union(self):
        busy, reach, gaps = 0, None, []
        for s, e, _, _ in self.device:
            if reach is not None and s > reach:
                gaps.append((s - reach, reach))
            lo = s if reach is None else max(s, reach)
            busy += max(0, e - lo)
            reach = e if reach is None else max(reach, e)
        return busy / 1e9, gaps

    def span_device_s(self, span: str) -> Optional[float]:
        """Device seconds of the events launched inside ``span``'s ranges,
        or None where the trace has no such range or no such event."""
        ranges = self._ranges.get(span)
        if not ranges:
            return None
        total, found = 0, False
        for s, e, _, corr in self.device:
            launch = self._launch.get(corr)
            if launch is None or launch[0] not in ranges:
                continue
            starts, ends = ranges[launch[0]]
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and launch[1] <= ends[i]:
                total += e - s
                found = True
        return total / 1e9 if found else None

    def top_ops(self) -> List[list]:
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, thread: Optional[int]) -> List[list]:
        """Idle seconds summed by what ``thread`` was doing when each gap
        began, the largest sums first."""
        segments = _innermost(sorted((s, e, n) for s, e, n, tid in self.host
                                     if tid == thread))
        starts = [seg[0] for seg in segments]
        totals: Dict[str, int] = defaultdict(int)
        for length, at in self._gaps:
            i = bisect.bisect_right(starts, at) - 1
            label = "host, outside any operation"
            if i >= 0 and at < segments[i][1]:
                label = segments[i][2]
            totals[label] += length
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[label[:160], ns / 1e9] for label, ns in top]

    def thread_of(self, span: str) -> Optional[int]:
        ranges = self._ranges.get(span)
        return next(iter(ranges)) if ranges else None


def _innermost(ops) -> List[tuple]:
    """Nested (start, end, name) intervals, sorted by start, cut into
    segments each labelled by its innermost ``bench.`` span and innermost
    operation."""
    segments, stack = [], []

    def label():
        names = [n for _, n in stack]
        spans = [n for n in names if n.startswith(PREFIX)]
        inner = names[-1]
        return f"{spans[-1]} / {inner}" if spans and spans[-1] != inner \
            else inner

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end = stack[-1][0]
            if end > at:
                segments.append((at, end, label()))
            at = end
            stack.pop()

    at = 0
    for s, e, name in ops:
        close_until(s)
        if stack and s > at:
            segments.append((at, s, label()))
        at = s
        stack.append((e, name))
    close_until(float("inf"))
    return segments
