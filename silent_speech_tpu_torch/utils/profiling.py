"""The port's own spans, and a trace of them and of the card's kernels.

- ``span(name)``: the context manager the training step opens around
  itself and its phases (``ssp.step`` around ``ssp.assemble``,
  ``ssp.loss`` and ``ssp.backward``), the encoder's forward around its
  three ResBlocks (``ssp.conv_stack``), and ``ops/dropout.py`` around each
  dropout mask (``ssp.dropout.mask``: ``keep_mask`` on a CPU tensor, the
  dropout kernel's launch on the card). While a
  ``torch.profiler`` profile records, it is a range of the profiler's own,
  on the clock the card's kernels are traced on, so a kernel belongs to
  the span its launch was issued in; otherwise it is one shared null
  context, and the step pays an attribute read a span. It creates no
  tensor and never syncs. The range is a function-scope record (the kind
  ATen's operators are), not a ``record_function`` user annotation: the
  profiler draws each user annotation on the device as well, from its
  first kernel to its last, which would hide the card's idle time inside
  the step. Both the range and the enabled flag are private names of
  torch's profiler; a torch without them fails at import with an
  ``ImportError`` that names them and the torch version.
- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  records the host, the spans and, when a CUDA card is present, the
  card's kernels, and writes a Chrome trace into ``logdir`` (TensorBoard's
  profiler plugin and ``chrome://tracing`` read it).

No CLI has a flag for a trace: the JAX docstring's ``--profile_steps``
exists in no JAX module either.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
# the private names span() rests on: (module, attribute)
PRIVATE_NAMES = ((torch._C._profiler, "_RecordFunctionFast"),
                 (_autograd_profiler, "_is_profiler_enabled"))


def _private_names_present():
    missing = [f"{module.__name__}.{name}" for module, name in PRIVATE_NAMES
               if not hasattr(module, name)]
    if missing:
        raise ImportError(
            f"utils.profiling.span needs {', '.join(missing)}, which torch "
            f"{torch.__version__} does not have")


_private_names_present()
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A profiler range called ``name`` while a profile records, else a
    shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


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
