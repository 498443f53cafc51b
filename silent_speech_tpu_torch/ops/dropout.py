"""Regenerating dropout from a counter hash, and the fused ReLU+dropout.

Counterpart of ``silent_speech_tpu/ops/dropout.py``. The keep mask is a
pure function of (element index, seed): a murmur3-style counter hash, the
same mixer as the attention kernel's (``_hash_bits`` in
``silent_speech_tpu/ops/pallas/rel_attention.py``). So the backward
regenerates the mask instead of saving it, and the CPU and the card draw
the same mask for the same seed. One 32-bit hash yields the 8-bit random
words of four consecutive elements; the rate is quantized to 1/256 as in
the JAX op (0.2 → drop iff the byte < 51, keep scaled by 256/205).

A tensor that is a shard of the one-process tensor (``parallel/``: a data
rank's rows, a model rank's FFN columns) draws its slice of the
one-process mask: a ``Shard`` gives its rows' offset and its columns'
offset and count in the whole, and each element takes the bits of its
index in the whole, ``(row0 + r)·cols + col0 + c``.

These are XLA fusions in the JAX package, not Pallas kernels, so the port
runs them as plain PyTorch tensor code on either device. uint32
arithmetic runs on int64 tensors, masked to 32 bits after every multiply:
the int64 product of two 32-bit values may wrap, but its low 32 bits are
right.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.profiling import span

M32 = 0xFFFFFFFF


def hash_bits(row: torch.Tensor, col, seed) -> torch.Tensor:
    """uint32 counter hash of (row, col, seed), as int64 values in
    [0, 2³²): ``x = (row·0x9E3779B1) ^ (col·0x85EBCA77) ^ seed`` then the
    murmur3 finalizer. Arguments broadcast; ``col`` and ``seed`` may be
    Python ints."""
    x = ((row * 0x9E3779B1) & M32) ^ ((col * 0x85EBCA77) & M32) ^ (seed & M32)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """Quantize a dropout rate to the uint8 threshold (drop iff the random
    byte < threshold)."""
    return int(round(rate * 256.0))


class Shard(NamedTuple):
    """Where a tensor lies in the one-process tensor: its rows (every axis
    but the last, flattened) start at row ``row0``, its columns at column
    ``col0`` of ``cols`` (None: the tensor's own width)."""

    row0: int = 0
    col0: int = 0
    cols: Optional[int] = None


def keep_mask(shape, seed: int, threshold: int, device: torch.device,
              shard: Optional[Shard] = None) -> torch.Tensor:
    """Boolean keep mask of ``shape``: element n keeps iff byte n mod 4 of
    ``hash_bits(n // 4, 0, seed)`` is ≥ ``threshold``, n the element's
    index in the one-process tensor that ``shard`` places it in."""
    with span("ssp.dropout.mask"):
        n = 1
        for d in shape:
            n *= int(d)
        width = int(shape[-1]) if len(shape) else 1
        row0, col0, cols = shard or Shard()
        cols = width if cols is None else cols
        shifts = torch.arange(0, 32, 8, device=device)
        if col0 == 0 and cols == width:
            # whole rows: one run of the flat index from base
            base = row0 * cols
            first = base % 4
            words = hash_bits(torch.arange(base // 4, (base + n + 3) // 4,
                                           device=device), 0, seed)
            bytes_ = (words[:, None] >> shifts) & 0xFF
            return (bytes_.reshape(-1)[first: first + n]
                    >= threshold).reshape(shape)
        rows = torch.arange(row0, row0 + n // width, device=device)
        index = (rows[:, None] * cols
                 + torch.arange(col0, col0 + width, device=device)[None, :])
        bytes_ = (hash_bits(index >> 2, 0, seed) >> ((index & 3) * 8)) & 0xFF
        return (bytes_ >= threshold).reshape(shape)


def _scale(threshold: int, dtype: torch.dtype) -> torch.Tensor:
    # the keep scale rounded to the tensor's dtype, as the JAX op casts it
    return torch.tensor(1.0 / (1.0 - threshold / 256.0), dtype=dtype)


def mask_scale(x: torch.Tensor, seed: int, threshold: int,
               shard: Optional[Shard] = None) -> torch.Tensor:
    """``x`` with the dropped elements zeroed and the kept ones scaled."""
    keep = keep_mask(x.shape, seed, threshold, x.device, shard)
    return torch.where(keep, x * _scale(threshold, x.dtype).to(x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _RegenDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, threshold, shard):
        ctx.seed, ctx.threshold, ctx.shard = seed, threshold, shard
        return mask_scale(x, seed, threshold, shard)

    @staticmethod
    def backward(ctx, g):
        # the same bits from the same seed: the mask is recomputed, not
        # saved
        return (mask_scale(g, ctx.seed, ctx.threshold, ctx.shard), None,
                None, None)


def regen_dropout(x: torch.Tensor, seed: int, threshold: int,
                  shard: Optional[Shard] = None) -> torch.Tensor:
    """Dropout whose backward regenerates the mask from ``seed``;
    ``threshold`` 0 is the identity."""
    if threshold == 0:
        return x
    return _RegenDropout.apply(x, seed, threshold, shard)


class _ReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, threshold, shard):
        y = mask_scale(torch.relu(x), seed, threshold, shard)
        ctx.save_for_backward(y)
        ctx.threshold = threshold
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        scale = _scale(ctx.threshold, g.dtype).to(g.device)
        return (torch.where(y > 0, g * scale,
                            torch.zeros((), dtype=g.dtype, device=g.device)),
                None, None, None)


def relu_dropout(x: torch.Tensor, seed: int, threshold: int,
                 shard: Optional[Shard] = None) -> torch.Tensor:
    """``dropout(relu(x))`` whose backward needs no random bits: the saved
    output's sign is the joint relu and keep mask (JAX ``relu_dropout``).
    ``threshold`` 0 is a plain ReLU."""
    if threshold == 0:
        return torch.relu(x)
    return _ReluDropout.apply(x, seed, threshold, shard)
