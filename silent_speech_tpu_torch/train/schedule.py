"""Learning-rate control on the host: linear warmup, plateau decay and
milestone decay.

Own copy of ``warmup_lr``, ``ReduceLROnPlateau`` and ``MultiStepLR`` in
the JAX package (``silent_speech_tpu/train/schedule.py``; reference
``transduction_model.py:179-189``, torch's defaults: threshold 1e-4
relative, cooldown 0; ``recognition_model.py:72-83``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


def warmup_lr(step: int, target_lr: float, warmup_steps: int) -> float:
    """LR for the 0-based global step: linear over the first
    ``warmup_steps`` optimizer steps, then the target."""
    it = step + 1
    if warmup_steps > 0 and it <= warmup_steps:
        return it * target_lr / warmup_steps
    return target_lr


@dataclass
class ReduceLROnPlateau:
    """Tracks a metric to minimize; ``scale`` shrinks by ``factor`` after
    more than ``patience`` epochs without a relative improvement of
    ``threshold``."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    best: float = float("inf")
    num_bad_epochs: int = 0
    scale: float = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale *= self.factor
            self.num_bad_epochs = 0
        return self.scale


@dataclass
class MultiStepLR:
    """×gamma at each milestone epoch (epochs counted from 1 upward)."""

    milestones: Sequence[int] = (125, 150, 175)
    gamma: float = 0.5
    epoch: int = 0
    scale: float = 1.0

    def step(self) -> float:
        self.epoch += 1
        if self.epoch in set(self.milestones):
            self.scale *= self.gamma
        return self.scale
