"""A training batch, packed from the benchmark's example dicts.

The published packing (``data_utils.py:158-167``, ``read_emg.py:261-275``):
the utterances, silent ones first and otherwise in the sampler's order,
are concatenated along time, zero-padded and cut into chunks of
``seq_len`` frames; the chunk count is the batch capacity's frames
(``int(max_batch_len · 516.79 / 1000 / 6)``) in chunks, plus two, rounded up
to ``chunk_bucket``, so every batch has one shape and BatchNorm sees the
same padding rows the program does. Each utterance's frames are the rows
``start .. start + T`` of the flattened output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


def chunk_count(cfg: dict) -> int:
    frames_cap = int(int(cfg["max_batch_len"]) * (516.79 / 1000.0) / 6.0)
    seq_len = int(cfg["seq_len"])
    bucket = int(cfg["chunk_bucket"])
    n = -(-frames_cap // seq_len) + 2
    return -(-n // bucket) * bucket


@dataclass
class Batch:
    raw: torch.Tensor            # (N, 8·seq_len, C)
    starts: List[int]            # first flattened row of each utterance
    frames: List[int]            # frames of each utterance
    silent: List[bool]
    targets: List[torch.Tensor]  # (Ttgt, mels) each
    phonemes: List[torch.Tensor]  # (Ttgt,) each
    texts: List[torch.Tensor]    # (S,) each


def layout(examples: Sequence[dict], ids: Sequence[int], cfg: dict):
    """(order, starts, frames): the utterances in packing order, and the
    first flattened row and frame count of each."""
    order = sorted(ids, key=lambda i: not examples[i]["silent"])
    per_frame = int(cfg["raw_per_frame"])
    capacity = chunk_count(cfg) * int(cfg["seq_len"])
    starts, frames, at = [], [], 0
    for i in order:
        t = len(examples[i]["raw_emg"]) // per_frame
        if at + t > capacity:
            raise ValueError("the batch exceeds its chunk capacity")
        starts.append(at)
        frames.append(t)
        at += t
    return order, starts, frames


def pack(examples: Sequence[dict], ids: Sequence[int], cfg: dict,
         device) -> Batch:
    order, starts, frames = layout(examples, ids, cfg)
    per_frame = int(cfg["raw_per_frame"])
    seq_len = int(cfg["seq_len"])
    n = chunk_count(cfg)
    raws = [np.asarray(examples[i]["raw_emg"], np.float32) for i in order]
    channels = raws[0].shape[1]
    flat = np.zeros((n * seq_len * per_frame, channels), np.float32)
    for r, at, t in zip(raws, starts, frames):
        flat[at * per_frame: (at + t) * per_frame] = r[: t * per_frame]
    raw = torch.from_numpy(flat.reshape(n, seq_len * per_frame, channels))

    def target(e):
        return e["parallel_voiced_audio_features"] if e["silent"] \
            else e["audio_features"]

    ex = [examples[i] for i in order]
    return Batch(
        raw=raw.to(device), starts=starts, frames=frames,
        silent=[bool(e["silent"]) for e in ex],
        targets=[torch.from_numpy(np.asarray(target(e), np.float32))
                 .to(device) for e in ex],
        phonemes=[torch.from_numpy(np.asarray(e["phonemes"], np.int64))
                  .to(device) for e in ex],
        texts=[torch.from_numpy(np.asarray(e["text_int"], np.int64))
               .to(device) for e in ex])
