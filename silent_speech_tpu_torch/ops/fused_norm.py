"""``LN(x + h)``: forward of the JAX package's ``residual_dropout_ln`` at
dropout rate 0 (``silent_speech_tpu/ops/fused_norm.py``).

The statistics reduce in float32 with ``var = E[z²] − μ²`` and ε=1e-6 (not
``torch.nn.LayerNorm``'s 1e-5); the sum ``z = x + h`` and the result are in
the compute dtype, as in the JAX op. Plain PyTorch: the JAX op is an XLA
fusion, not a Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn


def residual_ln(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``LN(x + h)`` over the last axis, in the dtype of ``x``."""
    z32 = (x + h).float()
    mu = z32.mean(-1, keepdim=True)
    var = (z32 * z32).mean(-1, keepdim=True) - mu * mu
    xhat32 = (z32 - mu) * torch.rsqrt(var + eps)
    return (xhat32 * gamma.float() + beta.float()).to(x.dtype)


class FusedResidualNorm(nn.Module):
    """Post-norm residual LayerNorm with the reference's parameter names
    (``weight``/``bias`` of shape (D,))."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        return residual_ln(x.to(dtype), h.to(dtype), self.weight, self.bias,
                           self.eps).to(x.dtype)
