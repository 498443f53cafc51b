"""Device resolution and the card's identity for printed numbers."""

from __future__ import annotations

import contextlib
import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller names another device. Asking for CUDA
    where there is none raises; there is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic convolution algorithms inside, forward and
    backward: its default weight-gradient algorithms sum in an order that
    changes between calls. The trainers run their steps under it, so that
    two steps from one state on one batch give bit-equal gradients on the
    card, as JAX's do."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


@contextlib.contextmanager
def full_fp32():
    """TF32 off inside, in cuBLAS and in cuDNN, both flags restored on
    exit. ``torch.backends.cudnn.allow_tf32`` is True by default, so a
    float32 convolution would otherwise multiply with a 10-bit mantissa.
    The trainers run each float32 step under it, so that every product of
    the step is the float32 its configuration states; ``full_fp32.steps``
    counts the steps it wrapped."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full_fp32.steps += 1
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


full_fp32.steps = 0


def step_precision(dtype: torch.dtype):
    """The scope of a training step in ``dtype``: ``full_fp32()`` for
    float32, else a null context (a bf16 step leaves the flags as they
    are)."""
    return full_fp32() if dtype == torch.float32 else contextlib.nullcontext()


def card_info(device: Union[str, torch.device] = "cuda") -> str:
    """``<name>, <power limit>`` of the card behind ``device``, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"card_info needs a CUDA device, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip()
