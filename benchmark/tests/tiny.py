"""A cell of the benchmark at a size the CPU runs in seconds: the
configuration's widths and the traffic's sizes cut down, everything else
as the files state it. For the CPU tests only."""

from __future__ import annotations

import os
import time

import torch

from benchmark import harness

ROOT = os.path.dirname(harness.PACKAGE)
CONFIG = dict(model_size=32, num_layers=2, num_heads=2, dim_feedforward=64,
              relative_positional_distance=8, max_batch_len=3000,
              seq_len=32, utt_cap=16, t_cap=64, compute_dtype="float32",
              moment_dtype="float32")
TRAFFIC = dict(utterances=24, frames=[20, 60], text_ids=6)
# the published widths and depth, with batches of ~260 frames: the size at
# which the CPU runs the control against the limits set at the cells' size
WIDE_CONFIG = dict(max_batch_len=3000, chunk_bucket=1, utt_cap=16,
                   t_cap=256)
WIDE_TRAFFIC = dict(utterances=40, frames=[100, 200], text_ids=12)


def cell(name: str, root: str = ROOT, config=None, traffic=None
         ) -> harness.Cell:
    c = harness.load_cell(root, name)
    c.config.update(CONFIG if config is None else config)
    c.traffic.update(TRAFFIC if traffic is None else traffic)
    return c


def run(name: str, seed: int = 2 ** 31 + 7, trace: bool = False,
        fault=None, root: str = ROOT) -> dict:
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(root, name, seed, 0.3, trace, "cpu",
                                time.perf_counter(), cell=cell(name, root),
                                fault=fault)
    finally:
        torch.set_num_threads(n)
