"""The run directory's ``log.txt``.

Own copy of ``silent_speech_tpu/utils/run_logging.py`` (reference
``transduction_model.py:229-244``): a ``log.txt`` and the console with the
bare message, the git SHA, the working tree's diff, argv, and the device
the run trains on (the card's name and power limit on CUDA).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

import torch

from .device import card_info


def setup_run_logging(output_directory: str,
                      filename: str = "log.txt") -> None:
    os.makedirs(output_directory, exist_ok=True)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    logging.basicConfig(
        handlers=[logging.FileHandler(
                      os.path.join(output_directory, filename), "w"),
                  logging.StreamHandler()],
        level=logging.INFO, format="%(message)s")


def setup_rank_logging(output_directory: str, mesh,
                       filename: str = "log.txt") -> None:
    """``setup_run_logging`` on rank 0 of ``mesh`` (or without one), with
    the mesh's shape as its first line; the other ranks log warnings only
    and write no file."""
    if mesh is not None and mesh.rank:
        logging.basicConfig(level=logging.WARNING, format="%(message)s")
        return
    setup_run_logging(output_directory, filename)
    if mesh is not None:
        logging.info("mesh: %s", mesh.shape)


def log_run_provenance() -> None:
    """The git SHA, the diff and argv, as the reference logs them."""
    for cmd in (["git", "rev-parse", "HEAD"], ["git", "diff"]):
        try:
            out = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL,
                                 universal_newlines=True, timeout=10).stdout
        except Exception:
            out = f"<{' '.join(cmd)} unavailable>"
        logging.info(out)
    logging.info(sys.argv)


def log_device_info(device: torch.device) -> None:
    name = card_info(device) if device.type == "cuda" else "cpu"
    logging.info("device: %s (%s)", device, name)
