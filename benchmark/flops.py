"""Model FLOPs of a training step, counted from the configuration and the
real frames it trains.

Per feature frame the encoder's forward computes, as multiply-adds times
two: the conv stack at 4, 2 and 1 output positions a frame (the raw input
has ``raw_per_frame`` = 8 samples a frame and each ResBlock halves it):
two k=3 convolutions and the 1×1 shortcut of each block; the dense layer
into the transformer; each layer's Q, K, V and output projections and its
FFN; the heads. The attention adds, per visible (query, key) pair of each
head, its three d_head-long products (q·k, q·E, P·V); a training batch
packs the utterances back to back into chunks of ``seq_len`` frames and
attends inside each chunk without a length mask, so its pairs are those of
its full chunks and of the last, partial one (``bounds.visible_pairs``).
A step's model FLOPs are three times its forward's (the backward computes
each product's two gradients). Padding frames, norms, softmax, the loss
and the optimizer are not counted.
"""

from __future__ import annotations

from benchmark.bounds import visible_pairs


def dense_per_frame(cfg: dict) -> int:
    """Forward FLOPs a frame outside the attention band."""
    d = int(cfg["model_size"])
    c_in = int(cfg["raw_channels"])
    ff = int(cfg["dim_feedforward"])
    per = int(cfg["raw_per_frame"])
    flops = 0
    for i in range(3):
        positions = per >> (i + 1)
        cin = c_in if i == 0 else d
        flops += 2 * positions * (3 * cin * d + 3 * d * d + cin * d)
    flops += 2 * d * d                                   # w_raw_in
    layer = 2 * (4 * d * d + 2 * d * ff)                 # QKVO + FFN
    flops += int(cfg["num_layers"]) * layer
    heads = int(cfg["num_outs"]) + int(cfg.get("num_aux_outs") or 0)
    return flops + 2 * d * heads


def band_forward(cfg: dict, frames: int) -> int:
    """Forward FLOPs of the attention band over ``frames`` packed real
    frames."""
    seq_len = int(cfg["seq_len"])
    m = int(cfg["relative_positional_distance"])
    full, rest = divmod(frames, seq_len)
    pairs = full * visible_pairs(seq_len, m, seq_len)
    if rest:
        pairs += visible_pairs(rest, m, rest)
    d = int(cfg["model_size"])     # heads × d_head
    return int(cfg["num_layers"]) * 3 * 2 * d * pairs


def step_flops(cfg: dict, frames: int) -> int:
    """Model FLOPs of a training micro-step over ``frames`` real frames."""
    return 3 * (dense_per_frame(cfg) * frames + band_forward(cfg, frames))
