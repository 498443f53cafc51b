"""``LN(x + dropout(h))``: the JAX package's ``residual_dropout_ln``
(``silent_speech_tpu/ops/fused_norm.py``) with its minimal-residual
backward.

The statistics reduce in float32 with ``var = E[z²] − μ²`` and ε=1e-6 (not
``torch.nn.LayerNorm``'s 1e-5); the sum ``z = x + h`` and the result are in
the compute dtype, as in the JAX op. The backward saves only x̂ (compute
dtype) and the per-row rstd, reduces dγ and dβ in float32, and the dropout
on ``h`` regenerates its mask from the seed (``ops/dropout.py``). Plain
PyTorch: the JAX op is an XLA fusion, not a Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from typing import Optional

from .dropout import Shard, regen_dropout


class _ResidualLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, gamma, beta, eps):
        z32 = (x + h).float()
        mu = z32.mean(-1, keepdim=True)
        var = (z32 * z32).mean(-1, keepdim=True) - mu * mu
        rstd = torch.rsqrt(var + eps)
        xhat32 = (z32 - mu) * rstd
        ctx.save_for_backward(xhat32.to(x.dtype), rstd, gamma)
        return (xhat32 * gamma.float() + beta.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, rstd, gamma = ctx.saved_tensors
        xhat32, dy32 = xhat.float(), dy.float()
        g = dy32 * gamma.float()
        mean_g = g.mean(-1, keepdim=True)
        mean_gx = (g * xhat32).mean(-1, keepdim=True)
        dz = (rstd * (g - mean_g - xhat32 * mean_gx)).to(dy.dtype)
        rows = tuple(range(xhat.dim() - 1))
        dgamma = (dy32 * xhat32).sum(rows).to(gamma.dtype)
        dbeta = dy32.sum(rows).to(gamma.dtype)
        return dz, dz, dgamma, dbeta, None


def residual_dropout_ln(x: torch.Tensor, h: torch.Tensor, seed: int,
                        threshold: int, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-6,
                        shard: Optional[Shard] = None) -> torch.Tensor:
    """``LN(x + dropout(h))`` over the last axis, in the dtype of ``x``;
    ``threshold`` is the uint8 dropout threshold (0 = no dropout);
    ``shard`` places ``h`` in the one-process tensor (``ops/dropout``)."""
    return _ResidualLN.apply(x, regen_dropout(h, seed, threshold, shard),
                             gamma, beta, eps)


class FusedResidualNorm(nn.Module):
    """Post-norm residual LayerNorm with the reference's parameter names
    (``weight``/``bias`` of shape (D,))."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype,
                seed: int = 0, threshold: int = 0,
                shard: Optional[Shard] = None) -> torch.Tensor:
        return residual_dropout_ln(x.to(dtype), h.to(dtype), seed,
                                   threshold, self.weight, self.bias,
                                   self.eps, shard).to(x.dtype)
