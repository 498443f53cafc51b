"""Spans around the calls into the program, from the benchmark's side.

In a traced run the harness wraps each call that a driver names (an
attribute of a program object or module, replaced where the program looks
the name up) in a ``torch.profiler.record_function`` range called
``bench.<span>``, times it on the host clock (no sync), and keeps what a
driver's ``info`` function records of the call's arguments (shapes,
lengths). The trace then attributes to each range the device time of the
kernels launched inside it (``trace.py``). Spans inside the program are
left to the program.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

PREFIX = "bench."


class Spans:
    def __init__(self):
        self.calls: Dict[str, List] = defaultdict(list)
        self.host_s: Dict[str, float] = defaultdict(float)
        self._undo = []

    def wrap(self, owner, attr: str, span: str,
             info: Optional[Callable] = None) -> bool:
        """Wrap ``owner.attr``; False, and nothing wrapped, where the
        program has no such name. The wrapper carries the original's
        attributes, so code that looks the name up finds them."""
        orig = getattr(owner, attr, None)
        if orig is None:
            return False
        label = PREFIX + span

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            self.calls[span].append(info(*args, **kwargs) if info else None)
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = orig(*args, **kwargs)
            self.host_s[span] += time.perf_counter() - t0
            return out

        shadowed = attr in getattr(owner, "__dict__", {})
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig, shadowed))
        return True

    def unwrap(self) -> None:
        for owner, attr, orig, shadowed in reversed(self._undo):
            # a function that keeps counters on itself (``f.launches +=
            # 1``) counted on the wrapper meanwhile: hand them back
            counts = {k: v for k, v in getattr(owner, attr).__dict__.items()
                      if k != "__wrapped__"}
            if hasattr(orig, "__dict__") and not hasattr(orig, "__self__"):
                orig.__dict__.update(counts)
            if shadowed:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()
