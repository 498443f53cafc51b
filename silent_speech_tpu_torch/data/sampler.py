"""Length-aware batch sampling.

Own copy of the JAX package's ``SizeAwareSampler``
(``silent_speech_tpu/data/sampler.py``; reference ``read_emg.py:115-140``):
shuffle the example indices, then fill batches greedily until the summed
raw-recording EMG length (``example_meta(i)["emg_length"]``) would exceed
``max_len``; skip examples whose text has no ASCII letter. Each pass
shuffles with ``random.Random(seed · 1000003 + epoch)``, so for a seed it
yields the JAX sampler's batches epoch for epoch.
"""

from __future__ import annotations

import logging
import random
import string
from typing import Iterator, List, Optional


class SizeAwareSampler:
    def __init__(self, dataset, max_len: int, seed: Optional[int] = None):
        """The final partial batch is kept, so small datasets still train
        (the reference drops it, ``read_emg.py:140``)."""
        self.dataset = dataset
        self.max_len = max_len
        self.seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[List[int]]:
        indices = list(range(len(self.dataset)))
        rng = random.Random(None if self.seed is None
                            else self.seed * 1000003 + self._epoch)
        rng.shuffle(indices)
        self._epoch += 1

        batch: List[int] = []
        batch_length = 0
        for idx in indices:
            meta = self.dataset.example_meta(idx)
            if not any(c in string.ascii_letters for c in meta["text"]):
                continue
            length = meta["emg_length"]
            if length > self.max_len:
                logging.warning(
                    "example %d cannot fit within desired batch length", idx)
            if length + batch_length > self.max_len:
                yield batch
                batch = []
                batch_length = 0
            batch.append(idx)
            batch_length += length
        if batch:
            yield batch
