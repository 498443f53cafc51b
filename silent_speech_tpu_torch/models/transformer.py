"""Post-norm relative-position transformer encoder, eval and train forward.

Counterpart of ``silent_speech_tpu/models/transformer.py``. Parameter names
and shapes are the reference's (``w_q``/``w_k``/``w_v`` (H, D, d_head),
``w_o`` (H, d_head, D), ``relative_positional.embeddings``
(H, 2m−1, d_head, 1), ``linear1``, ``linear2``, ``norm1``, ``norm2``), so a
reference ``model.pt`` loads as it is. The projections are plain matmuls in
the compute dtype; the attention core is ``ops.rel_attention``.

In training each layer drops, at the configured rate: the attention
probabilities (inside the attention kernels, uint32 threshold), the
residual branches of ``norm1`` and ``norm2`` and the FFN's ReLU output
(uint8 threshold, ``ops/dropout.py``). Every site draws its own seed per
step from the caller's CPU ``torch.Generator``, so drawing never waits for
the card.

On a mesh (``parallel/mesh.py``, set by ``EMGEncoder.shard``) a layer holds
its model rank's heads (``w_q``, ``w_k``, ``w_v``, ``w_o`` and the relative
table sliced by head) and FFN columns (``linear1`` with its bias,
``linear2``'s input rows), Megatron's split: the input of each block goes
through *f* (``collectives.copy_to``), the attention output after ``w_o``
and the FFN output after ``linear2`` through *g* (``reduce_from``), and
``linear2.bias`` is added once, after the reduce. Norms are replicated.
Every dropout draws the slice of the one-process mask: the attention
kernels take the shard's first row, first head and the head count of the
whole, the FFN's and residuals' masks their place in the one-process
tensor (``ops/dropout.Shard``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import Shard, dropout_threshold, relu_dropout
from ..ops.fused_norm import FusedResidualNorm
from ..ops.rel_attention import attention_drop_threshold, rel_attention
from ..parallel.collectives import copy_to, reduce_from


def draw_seed(generator: torch.Generator) -> int:
    """One dropout seed in [0, 2³¹) from a CPU generator."""
    return int(torch.randint(0, 2 ** 31, (), generator=generator))


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
                 compute_dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_head {n_head}")
        d_head = d_model // n_head
        self.max_dist = max_dist
        self.compute_dtype = compute_dtype
        self.drop_threshold = attention_drop_threshold(dropout)
        self.w_q = nn.Parameter(torch.empty(n_head, d_model, d_head))
        self.w_k = nn.Parameter(torch.empty(n_head, d_model, d_head))
        self.w_v = nn.Parameter(torch.empty(n_head, d_model, d_head))
        self.w_o = nn.Parameter(torch.empty(n_head, d_head, d_model))
        self.relative_positional = LearnedRelativePositionalEmbedding(
            n_head, max_dist, d_head)
        self.mesh = None

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                b_offset: int = 0) -> torch.Tensor:
        """x (B, T, D) → (B, T, D); ``valid_len`` masks the padding
        beyond the utterance out of attention; a ``generator`` (training)
        turns the probability dropout on; ``b_offset`` is the first row's
        index in the one-process batch."""
        cdt = self.compute_dtype
        mesh = self.mesh
        cells = {}
        if mesh is not None:
            x = copy_to(x, mesh.model_group)
            n_head = self.w_q.shape[0]
            cells = dict(b_offset=b_offset,
                         h_offset=mesh.model_rank * n_head,
                         h_total=mesh.model_parallel * n_head)
        # one product for q, k and v: x then has one consumer here, so its
        # gradient sums the same terms in the same order on a mesh (behind
        # *f*) as without one
        w = torch.stack([self.w_q, self.w_k, self.w_v]).to(cdt)
        q, k, v = (t.contiguous() for t in torch.einsum(
            "btd,shda->sbhta", x.to(cdt), w))
        rel_emb = self.relative_positional.embeddings[..., 0].to(cdt)
        seed, thresh = 0, 0
        if generator is not None and self.drop_threshold:
            seed, thresh = draw_seed(generator), self.drop_threshold
        o = rel_attention(q, k, v, rel_emb.contiguous(), self.max_dist,
                          valid_len, seed, thresh, **cells)
        out = torch.einsum("bhta,haf->btf", o, self.w_o.to(cdt))
        if mesh is not None:
            out = reduce_from(out, mesh.model_group)
        return out.to(x.dtype)


class TransformerEncoderLayer(nn.Module):
    """attn → add & norm → ReLU FFN → add & norm (reference
    ``transformer.py:43-60``)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 max_dist: int, compute_dtype: torch.dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.drop_threshold = dropout_threshold(dropout)
        self.self_attn = RelativePositionalAttention(
            d_model, n_head, max_dist, compute_dtype, dropout)
        self.norm1 = FusedResidualNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = FusedResidualNorm(d_model)
        self.mesh = None

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                b_offset: int = 0) -> torch.Tensor:
        cdt = self.compute_dtype
        mesh = self.mesh
        t = self.drop_threshold if generator is not None else 0
        seeds = [draw_seed(generator) if t else 0 for _ in range(3)]
        rows = ffn = None
        if mesh is not None:
            n_cols = self.linear1.weight.shape[0]
            rows = Shard(b_offset * x.shape[1])
            ffn = Shard(rows.row0, mesh.model_rank * n_cols,
                        mesh.model_parallel * n_cols)
        x = self.norm1(x, self.self_attn(x, valid_len, generator, b_offset),
                       cdt, seeds[0], t, rows)
        xf = x if mesh is None else copy_to(x, mesh.model_group)
        h = relu_dropout(linear(self.linear1, xf, cdt), seeds[1], t, ffn)
        if mesh is None:
            h = linear(self.linear2, h, cdt)
        elif mesh.model_parallel == 1:
            h = reduce_from(linear(self.linear2, h, cdt), mesh.model_group)
        else:   # the bias once, after the partial sums are reduced
            h = reduce_from(F.linear(h.to(cdt), self.linear2.weight.to(cdt)),
                            mesh.model_group) + self.linear2.bias.to(cdt)
        return self.norm2(x, h, cdt, seeds[2], t, rows)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(**layer_kwargs)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, valid_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                b_offset: int = 0) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, valid_len, generator, b_offset)
        return x


def xavier_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Xavier normal over the last two axes (the reference's init of the
    attention projections)."""
    fan_in, fan_out = w.shape[-2], w.shape[-1]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                  generator=generator)
