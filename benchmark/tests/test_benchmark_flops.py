"""``step_mfu_pct``'s FLOP count against torch's own counter over the
plain reference, and its attention band against a brute-force count of
the visible pairs."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import bounds, flops, weights
from benchmark.reference import model
from benchmark.reference.draws import Draws
from benchmark.tests import tiny


def _brute_pairs(t: int, m: int, valid_len: int) -> int:
    q = np.arange(t)[:, None]
    k = np.arange(t)[None, :]
    same_side = (q < valid_len) == (k < valid_len)
    return int(((np.abs(k - q) <= m - 1) & same_side).sum())


@pytest.mark.parametrize("t,m,valid_len", [(200, 100, 200), (37, 8, 37),
                                           (64, 8, 40), (5, 8, 5)])
def test_visible_pairs(t, m, valid_len):
    assert bounds.visible_pairs(t, m, valid_len) == \
        _brute_pairs(t, m, valid_len)


@pytest.mark.parametrize("frames", [0, 31, 32, 200, 333])
def test_band_counts_the_pairs_of_packed_chunks(frames):
    cfg = tiny.cell("transduction-train").config
    seq_len = cfg["seq_len"]
    m = cfg["relative_positional_distance"]
    pairs = sum(_brute_pairs(min(seq_len, frames - at), m,
                             min(seq_len, frames - at))
                for at in range(0, frames, seq_len))
    assert flops.band_forward(cfg, frames) == \
        cfg["num_layers"] * 3 * 2 * cfg["model_size"] * pairs


@pytest.mark.parametrize("cell", ["transduction-train", "recognition-train"])
def test_dense_count_matches_torch_flop_counter(cell):
    cfg = tiny.cell(cell).config
    n_chunks, seq_len = 3, cfg["seq_len"]
    per = cfg["raw_per_frame"]
    torch.manual_seed(0)
    raw = torch.randn(n_chunks, seq_len * per, cfg["raw_channels"])
    params = weights.make(cfg, 7, "cpu")
    with FlopCounterMode(display=False) as total:
        model.forward(params, raw, cfg, Draws(3))
    d, h = cfg["model_size"], cfg["num_heads"]
    m = cfg["relative_positional_distance"]
    q = torch.randn(n_chunks, h, seq_len, d // h)
    with FlopCounterMode(display=False) as core:
        model.attention_core(q, q, q, torch.randn(h, 2 * m - 1, d // h),
                             m, 11, cfg["dropout"], model.Precision())
    dense = total.get_total_flops() \
        - cfg["num_layers"] * core.get_total_flops()
    frames = n_chunks * seq_len
    assert dense == flops.dense_per_frame(cfg) * frames
    assert flops.step_flops(cfg, frames) == \
        3 * (dense + flops.band_forward(cfg, frames))
