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

A trainer on a mesh (``parallel/mesh.py``) saves the full state in the
same format: its shards are gathered over ``model`` (a collective: every
rank calls ``save_checkpoint``), a gradient accumulator in mid-group is
summed over ``data`` first, and rank 0 alone writes. Every rank restores
by slicing the full state, onto any mesh or none; the accumulator goes
whole to data rank 0 and as zeros to the others, so the update's sum
over ``data`` finds it once.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

CHECKPOINT = "checkpoint.pt"


def _mesh(model: torch.nn.Module):
    return getattr(model, "mesh", None)


def is_writer(model: torch.nn.Module) -> bool:
    """Whether this process writes the run's files: always without a mesh,
    on rank 0 with one."""
    mesh = _mesh(model)
    return mesh is None or mesh.rank == 0


def _cpu_state(model: torch.nn.Module) -> dict:
    """The full state dict on the CPU, gathered over a mesh's model axis
    (every rank calls it)."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    mesh = _mesh(model)
    if mesh is not None:
        from ..parallel.mesh import gather_state

        state = gather_state(state, mesh)
    return {k: v.cpu() for k, v in state.items()}


def _full(model, tensors, sum_data: bool = False):
    """Per-parameter tensors (moments, accumulator) in full, on the CPU."""
    mesh = _mesh(model)
    if mesh is None:
        return [t.detach().cpu() for t in tensors]
    from ..parallel.collectives import all_reduce_
    from ..parallel.mesh import gather_tensor

    out = []
    for (name, _), t in zip(model.named_parameters(), tensors):
        t = t.detach()
        if sum_data:
            t = all_reduce_(t.clone(), mesh.data_group)
        out.append(gather_tensor(name, t, mesh).cpu())
    return out


def _sharded(model, tensors, data_rank0_only: bool = False):
    mesh = _mesh(model)
    if mesh is None:
        return tensors
    from ..parallel.mesh import shard_tensor

    out = [shard_tensor(name, t, mesh)
           for (name, _), t in zip(model.named_parameters(), tensors)]
    if data_rank0_only and mesh.data_rank:
        out = [torch.zeros_like(t) for t in out]
    return out


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, trainer,
                    extra: Optional[dict] = None) -> str:
    """Write ``trainer``'s full state to ``directory/checkpoint.pt``
    (overwritten each time, replaced atomically) and return the path. On
    a mesh every rank calls it and rank 0 writes."""
    opt, model = trainer.optimizer, trainer.model
    state = {"model": _cpu_state(model),
             "mu": _full(model, opt.mu),
             "nu": _full(model, opt.nu),
             "count": opt.count,
             "acc": _full(model, opt.acc, sum_data=True),
             "mini_step": opt.mini_step,
             "generator": trainer.generator.get_state(),
             "extra": dict(extra or {})}
    path = os.path.join(directory, CHECKPOINT)
    if is_writer(model):
        _atomic_save(state, path)
    _barrier(model)
    return path


def _barrier(model) -> None:
    mesh = _mesh(model)
    if mesh is not None:
        from ..parallel.mesh import barrier

        barrier(mesh)


def checkpoint_exists(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, CHECKPOINT))


@torch.no_grad()
def restore_checkpoint(directory: str, trainer) -> dict:
    """Load the state saved by ``save_checkpoint`` into ``trainer`` (whose
    state is initialized) and return the saved host-side dict. On a mesh
    each rank takes its slices."""
    state = torch.load(os.path.join(directory, CHECKPOINT), map_location="cpu",
                       weights_only=True)
    model = trainer.model
    saved = state["model"]
    if _mesh(model) is not None:
        from ..parallel.mesh import shard_state

        saved = shard_state(saved, _mesh(model))
    model.load_state_dict(saved, strict=True)
    opt = trainer.optimizer
    for dst, src in zip(opt.mu + opt.nu, _sharded(model, state["mu"])
                        + _sharded(model, state["nu"])):
        dst.copy_(src)
    opt.count = int(state["count"])
    # checkpoints written before the port accumulated gradients have no
    # accumulator: an empty one
    acc = state.get("acc", [])
    if len(acc) != len(opt.acc):
        raise ValueError("the checkpoint's gradient accumulation does not "
                         "match the optimizer's")
    for dst, src in zip(opt.acc, _sharded(model, acc, data_rank0_only=True)):
        dst.copy_(src)
    opt.mini_step = int(state.get("mini_step", 0))
    trainer.generator.set_state(state["generator"])
    return state["extra"]


def export_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Write the weights and BatchNorm statistics as a reference-layout
    ``model.pt`` (on a mesh: gathered, by rank 0)."""
    state = _cpu_state(model)
    if is_writer(model):
        _atomic_save(state, path)
    _barrier(model)
