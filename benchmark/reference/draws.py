"""The step's random draws, worked out again from the step seed.

Frozen copies of what the program's training forward draws
(``silent_speech_tpu_torch/models/encoder.py`` ``draw_shift``,
``shift_raw``; ``models/transformer.py`` ``draw_seed`` and the order of
the draws in a layer) and of the counter hash that turns a seed into the
dropout masks (``ops/dropout.py`` ``hash_bits``, ``keep_mask``;
``ops/rel_attention.py`` ``attention_keep``). Per step, from one CPU
``torch.Generator``: the raw shift r in [0, 8); then for each layer three
seeds in [0, 2³¹) (the residual dropout after attention, the FFN's ReLU
dropout, the residual dropout after the FFN), then the attention's seed;
a dropout whose threshold is 0 draws nothing.

Masks: an element of a (rows, width) activation keeps iff byte n mod 4 of
``hash(n // 4, 0, seed)`` is at least the uint8 threshold round(rate·256),
n its flat index, and scales by 1/(1 − threshold/256). Attention
probability (q, k) of batch row b and head h keeps iff
``hash(q, k, seed + b·H + h)`` is at least round(rate·2³²), and scales by
1/(1 − threshold/2³²).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


class Draws:
    """The draws of consecutive steps from one generator seed."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def shift(self) -> int:
        return int(torch.randint(0, 8, (), generator=self.generator))

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31, (), generator=self.generator))


def hash_bits(row: torch.Tensor, col, seed) -> torch.Tensor:
    """uint32 murmur3-style counter hash of (row, col, seed), as int64
    values in [0, 2³²)."""
    x = ((row * 0x9E3779B1) & M32) ^ ((col * 0x85EBCA77) & M32) ^ (seed & M32)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def byte_threshold(rate: float) -> int:
    return int(round(rate * 256.0))


def word_threshold(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), M32)


def element_keep(shape, seed: int, threshold: int, device) -> torch.Tensor:
    """Keep mask of a whole activation, by flat element index."""
    n = 1
    for d in shape:
        n *= int(d)
    words = hash_bits(torch.arange((n + 3) // 4, device=device), 0, seed)
    shifts = torch.arange(0, 32, 8, device=device)
    bytes_ = (words[:, None] >> shifts) & 0xFF
    return (bytes_.reshape(-1)[:n] >= threshold).reshape(shape)


def dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    t = byte_threshold(rate)
    if t == 0:
        return x
    keep = element_keep(x.shape, seed, t, x.device)
    return torch.where(keep, x / (1.0 - t / 256.0), torch.zeros_like(x))


def attention_keep(b: int, h: int, t: int, seed: int, threshold: int,
                   device) -> torch.Tensor:
    """(B, H, T, T) keep mask of the attention probabilities."""
    pos = torch.arange(t, device=device)
    rows = torch.arange(b, device=device)
    heads = torch.arange(h, device=device)
    cell = (seed + rows[:, None] * h + heads[None, :]) & M32
    return hash_bits(pos[:, None], pos[None, :],
                     cell[:, :, None, None]) >= threshold


def shift_chunks(raw: torch.Tensor, r: int) -> torch.Tensor:
    """Every raw chunk (N, L, C) moved left by r samples, its last r
    samples zero."""
    if r == 0:
        return raw
    out = torch.zeros_like(raw)
    out[:, : raw.shape[1] - r] = raw[:, r:]
    return out
