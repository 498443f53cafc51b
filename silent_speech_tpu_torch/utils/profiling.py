"""Tracing and per-step timing, as library functions.

Own copy of the JAX package's ``silent_speech_tpu/utils/profiling.py``:

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  records the host and, when a CUDA card is present, the card's kernels,
  and writes a Chrome trace into ``logdir`` (TensorBoard's profiler plugin
  and ``chrome://tracing`` read it);
- ``StepTimer``: wall-clock step statistics (steps a second, p50 and p90
  ms) with a log line every ``log_every`` ticks.

Nothing in the port calls either, and no CLI has a flag for them: the
JAX docstring's ``--profile_steps`` exists in no JAX module either.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its trace into ``logdir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Call ``tick()`` once a step; the durations between ticks give
    ``steps_per_sec`` and ``percentile_ms``, logged every ``log_every``
    durations (0: never)."""

    def __init__(self, log_every: int = 50, name: str = "train"):
        self.log_every = log_every
        self.name = name
        self._durations: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.time()
        if self._last is not None:
            self._durations.append(now - self._last)
            if self.log_every and len(self._durations) % self.log_every == 0:
                self.log()
        self._last = now

    def reset(self) -> None:
        self._durations = []
        self._last = None

    @property
    def steps_per_sec(self) -> float:
        if not self._durations:
            return 0.0
        return len(self._durations) / sum(self._durations)

    def percentile_ms(self, q: float) -> float:
        """The duration at percentile ``q`` (nearest rank below), in ms."""
        if not self._durations:
            return 0.0
        xs = sorted(self._durations)
        i = min(int(q / 100 * len(xs)), len(xs) - 1)
        return xs[i] * 1000.0

    def log(self) -> None:
        logging.info(
            "%s: %.2f steps/s (p50 %.1f ms, p90 %.1f ms, n=%d)",
            self.name, self.steps_per_sec, self.percentile_ms(50),
            self.percentile_ms(90), len(self._durations))
