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
