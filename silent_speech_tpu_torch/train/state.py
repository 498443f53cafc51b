"""AdamW with reduced-precision moments, the learning rate set per step,
and gradient accumulation.

Counterpart of ``make_adamw`` in the JAX package
(``silent_speech_tpu/train/state.py``), the optimizer of its trainers: the
update math is float32, the moments are stored in ``moment_dtype``
(bfloat16 by default, ``fused_adamw`` there, which cuts the optimizer's
memory traffic), and the arithmetic is that of optax under
``inject_hyperparams``, which holds β, ε and the decay as float32 arrays:
``1 − b`` and the bias corrections ``1 − b**count`` are float32, and the
update is ``p − lr·(m̂/(√v̂ + ε) + wd·p)``. With
``moment_dtype=torch.float32`` it is ``optax.adamw`` so wrapped. The
reference trains with torch's AdamW defaults (β = (0.9, 0.999), ε = 1e-8,
decoupled weight decay, ``transduction_model.py:178``). The parameters are updated in place.

``grad_accum=k > 1`` is ``optax.MultiSteps(every_k_schedule=k)`` (0.2.6)
around it, as the recognition trainer uses with k = 2
(``recognition_model.py:105-107``): each micro-step folds its gradient into
a float32 running mean ``acc + (g − acc)/(n + 1)`` (n the micro-step within
the group) kept on the parameters' device; the k-th updates the weights
from the mean at that micro-step's learning rate, advances the Adam count
and zeroes the mean; the others leave the weights, moments and count as
they are.

On a mesh, ``grad_sync`` turns the rank's gradients into the mesh's
(``train/transduction.py``: summed over the data axis) in place, just
before an update reads them: once a step, or once an accumulation group,
on the mean of its micro-steps.

Leaves on the card go through ``ops/adamw.py`` (``csrc/adamw.cu``): one
launch an update over every leaf and, with accumulation, one fold a
micro-step, whose last also reads and zeroes the mean; bit for bit the
per-leaf loop's numbers. CPU tensors take the loop (``_fold_plain``,
``_update_plain``), the kernels' plain version.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from ..ops import adamw


class FusedAdamW:
    def __init__(self, params: Iterable[torch.nn.Parameter],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.bfloat16,
                 grad_accum: int = 1,
                 grad_sync: Optional[Callable[[List[torch.Tensor]], None]]
                 = None):
        self.params = list(params)
        self.grad_sync = grad_sync
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.moment_dtype = moment_dtype
        self.mu = [torch.zeros_like(p, dtype=moment_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=moment_dtype)
                   for p in self.params]
        self.count = 0
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.grad_accum = grad_accum
        self.mini_step = 0   # micro-steps folded into ``acc`` so far
        self.acc = [torch.zeros_like(p, dtype=torch.float32)
                    for p in self.params] if grad_accum > 1 else []
        self._on_card: Optional[adamw.Leaves] = None

    def _leaves(self) -> Optional[adamw.Leaves]:
        """The leaves as the kernels take them when they lie on the card
        (built at the first step, again when a leaf's storage moves); None
        on the CPU, where the per-leaf loop runs."""
        if not self.params or self.params[0].device.type != "cuda":
            return None
        if self._on_card is None or not self._on_card.current(
                self.params, self.mu, self.nu, self.acc):
            self._on_card = adamw.Leaves(self.params, self.mu, self.nu,
                                       self.acc)
        return self._on_card

    def _dense(self, grads):
        return [torch.zeros_like(p) if g is None else g.float()
                for p, g in zip(self.params, grads)]

    @torch.no_grad()
    def step(self, lr: float) -> bool:
        """One micro-step with learning rate ``lr`` from each parameter's
        ``.grad`` (a parameter without one takes a zero gradient). Returns
        whether the weights were updated: always without accumulation,
        on every ``grad_accum``-th micro-step with it."""
        table = self._leaves()
        grads = [p.grad for p in self.params]
        if self.grad_accum > 1:
            if table is None:
                self._fold_plain(self._dense(grads))
            else:
                adamw.adamw_fold(table, grads, self.mini_step + 1)
            self.mini_step = (self.mini_step + 1) % self.grad_accum
            if self.mini_step:
                return False
            grads = self.acc
        elif table is None or self.grad_sync is not None:
            # the loop, and a collective over the same leaves on every
            # rank, take a tensor a leaf
            grads = self._dense(grads)
        if self.grad_sync is not None:
            self.grad_sync(grads)
        self.count += 1
        c = np.float32(self.count)
        bc1 = np.float32(1) - np.float32(self.b1) ** c
        bc2 = np.float32(1) - np.float32(self.b2) ** c
        one_minus_b1 = float(np.float32(1) - np.float32(self.b1))
        one_minus_b2 = float(np.float32(1) - np.float32(self.b2))
        if table is None:
            self._update_plain(grads, lr, float(bc1), float(bc2),
                               one_minus_b1, one_minus_b2)
            return True
        f32 = np.float32
        adamw.adamw_update(
            table, None if self.acc else grads,
            adamw.Hyper(float(f32(self.b1)), float(f32(self.b2)),
                        one_minus_b1, one_minus_b2,
                        float(f32(1) / bc1), float(f32(1) / bc2),
                        float(f32(self.eps)), float(f32(self.weight_decay)),
                        float(f32(-lr))))
        return True

    def _fold_plain(self, grads: List[torch.Tensor]) -> None:
        # optax's Welford mean: acc + (g − acc)/(n + 1), in place
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, self.mini_step + 1)
        torch._foreach_add_(self.acc, delta)

    def _update_plain(self, grads: List[torch.Tensor], lr: float,
                      bc1: float, bc2: float, one_minus_b1: float,
                      one_minus_b2: float) -> None:
        for p, g32, m, v in zip(self.params, grads, self.mu, self.nu):
            m32 = self.b1 * m.float() + one_minus_b1 * g32
            v32 = self.b2 * v.float() + one_minus_b2 * (g32 * g32)
            upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps) \
                + self.weight_decay * p.float()
            p.add_((-lr * upd).to(p.dtype))
            m.copy_(m32)
            v.copy_(v32)
        if self.acc:
            torch._foreach_zero_(self.acc)
