"""AdamW with reduced-precision moments, the learning rate set per step.

Counterpart of ``fused_adamw`` in the JAX package
(``silent_speech_tpu/train/state.py``): the update math is float32, the
moments are stored in ``moment_dtype`` (bfloat16 by default, which cuts
the optimizer's memory traffic), and the arithmetic follows optax:
``(1 − b)`` is formed in float64 before it meets a float32 tensor, the
bias corrections ``1 − b**count`` are float32, and the update is
``p − lr·(m̂/(√v̂ + ε) + wd·p)``. With ``moment_dtype=torch.float32`` it is
``optax.adamw``. The reference trains with torch's AdamW defaults
(β = (0.9, 0.999), ε = 1e-8, decoupled weight decay,
``transduction_model.py:178``). The parameters are updated in place.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


class FusedAdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.moment_dtype = moment_dtype
        self.mu = [torch.zeros_like(p, dtype=moment_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype)
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One update with learning rate ``lr`` from each parameter's
        ``.grad``; a parameter without a gradient takes a zero one."""
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        one_minus_b1, one_minus_b2 = 1.0 - self.b1, 1.0 - self.b2
        for p, m, v in zip(self.params, self.mu, self.nu):
            g32 = (p.grad if p.grad is not None
                   else torch.zeros_like(p)).float()
            m32 = self.b1 * m.float() + one_minus_b1 * g32
            v32 = self.b2 * v.float() + one_minus_b2 * (g32 * g32)
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps) \
                + self.weight_decay * p.float()
            p.add_((-lr * upd).to(p.dtype))
            m.copy_(m32)
            v.copy_(v32)
