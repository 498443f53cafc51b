"""Device resolution and the card's identity for printed numbers."""

from __future__ import annotations

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
