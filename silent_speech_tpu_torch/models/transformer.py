"""Post-norm relative-position transformer encoder, eval forward.

Counterpart of ``silent_speech_tpu/models/transformer.py``. Parameter names
and shapes are the reference's (``w_q``/``w_k``/``w_v`` (H, D, d_head),
``w_o`` (H, d_head, D), ``relative_positional.embeddings``
(H, 2m−1, d_head, 1), ``linear1``, ``linear2``, ``norm1``, ``norm2``), so a
reference ``model.pt`` loads as it is. The projections are plain matmuls in
the compute dtype; the attention core is ``ops.rel_attention``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import FusedResidualNorm
from ..ops.rel_attention import rel_attention


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (a flax ``Dense(dtype=...)``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class LearnedRelativePositionalEmbedding(nn.Module):
    """Holds the per-head relative table with the reference's trailing
    singleton axis."""

    def __init__(self, n_head: int, max_dist: int, d_head: int):
        super().__init__()
        self.embeddings = nn.Parameter(
            torch.empty(n_head, 2 * max_dist - 1, d_head, 1))


class RelativePositionalAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, max_dist: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_head {n_head}")
        d_head = d_model // n_head
        self.max_dist = max_dist
        self.compute_dtype = compute_dtype
        self.w_q = nn.Parameter(torch.empty(n_head, d_model, d_head))
        self.w_k = nn.Parameter(torch.empty(n_head, d_model, d_head))
        self.w_v = nn.Parameter(torch.empty(n_head, d_model, d_head))
        self.w_o = nn.Parameter(torch.empty(n_head, d_head, d_model))
        self.relative_positional = LearnedRelativePositionalEmbedding(
            n_head, max_dist, d_head)

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None
                ) -> torch.Tensor:
        """x (B, T, D) → (B, T, D); ``valid_len`` masks the padding
        beyond the utterance out of attention."""
        cdt = self.compute_dtype
        xc = x.to(cdt)
        q, k, v = (torch.einsum("btd,hda->bhta", xc, w.to(cdt)).contiguous()
                   for w in (self.w_q, self.w_k, self.w_v))
        rel_emb = self.relative_positional.embeddings[..., 0].to(cdt)
        o = rel_attention(q, k, v, rel_emb.contiguous(), self.max_dist,
                          valid_len)
        out = torch.einsum("bhta,haf->btf", o, self.w_o.to(cdt))
        return out.to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """attn → add & norm → ReLU FFN → add & norm (reference
    ``transformer.py:43-60``)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 max_dist: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.self_attn = RelativePositionalAttention(
            d_model, n_head, max_dist, compute_dtype)
        self.norm1 = FusedResidualNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = FusedResidualNorm(d_model)

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None
                ) -> torch.Tensor:
        cdt = self.compute_dtype
        x = self.norm1(x, self.self_attn(x, valid_len), cdt)
        h = linear(self.linear2, F.relu(linear(self.linear1, x, cdt)), cdt)
        return self.norm2(x, h, cdt)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(**layer_kwargs)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None
                ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, valid_len)
        return x


def xavier_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Xavier normal over the last two axes (the reference's init of the
    attention projections)."""
    fan_in, fan_out = w.shape[-2], w.shape[-1]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                  generator=generator)
