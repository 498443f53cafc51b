"""Checkpoints: the full train state with ``torch.save``, and the
reference-layout ``model.pt``.

Counterpart of ``silent_speech_tpu/train/checkpoint.py``, which saves with
orbax; a checkpoint resumes port to port only. The saved state is the
model's state dict (weights and BatchNorm statistics), the AdamW moments
and count, the gradient accumulator and its micro-step (so a resume that
falls between two micro-steps of an accumulation group is exact), the step
generator's state and a dict of host-side state (epoch, global step,
plateau or milestone schedule). The JAX step draws its randomness by
``fold_in(rng, step)`` and needs no saved state; the port's
``torch.Generator`` draws in sequence, so without its state a resumed run
would draw other shifts and dropout masks.

``export_reference_checkpoint`` writes the weights alone as the
reference's ``model.pt``, which ``EMGEncoder.load_state_dict(...,
strict=True)`` and ``eval/export.py`` take.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

CHECKPOINT = "checkpoint.pt"


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, trainer,
                    extra: Optional[dict] = None) -> str:
    """Write ``trainer``'s full state to ``directory/checkpoint.pt``
    (overwritten each time, replaced atomically) and return the path."""
    opt = trainer.optimizer
    state = {"model": _cpu_state(trainer.model),
             "mu": [m.detach().cpu() for m in opt.mu],
             "nu": [v.detach().cpu() for v in opt.nu],
             "count": opt.count,
             "acc": [a.detach().cpu() for a in opt.acc],
             "mini_step": opt.mini_step,
             "generator": trainer.generator.get_state(),
             "extra": dict(extra or {})}
    path = os.path.join(directory, CHECKPOINT)
    _atomic_save(state, path)
    return path


def checkpoint_exists(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, CHECKPOINT))


@torch.no_grad()
def restore_checkpoint(directory: str, trainer) -> dict:
    """Load the state saved by ``save_checkpoint`` into ``trainer`` (whose
    state is initialized) and return the saved host-side dict."""
    state = torch.load(os.path.join(directory, CHECKPOINT), map_location="cpu",
                       weights_only=True)
    trainer.model.load_state_dict(state["model"], strict=True)
    opt = trainer.optimizer
    for dst, src in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
        dst.copy_(src)
    opt.count = int(state["count"])
    # checkpoints written before the port accumulated gradients have no
    # accumulator: an empty one
    acc = state.get("acc", [])
    if len(acc) != len(opt.acc):
        raise ValueError("the checkpoint's gradient accumulation does not "
                         "match the optimizer's")
    for dst, src in zip(opt.acc, acc):
        dst.copy_(src)
    opt.mini_step = int(state.get("mini_step", 0))
    trainer.generator.set_state(state["generator"])
    return state["extra"]


def export_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Write the weights and BatchNorm statistics as a reference-layout
    ``model.pt``."""
    _atomic_save(_cpu_state(model), path)
