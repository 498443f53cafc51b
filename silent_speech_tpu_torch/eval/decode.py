"""CTC decoding. Greedy only; the LM-fused beam search is not ported yet."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def greedy_ctc_decode(log_probs: np.ndarray, blank_id: int,
                      length: Optional[int] = None) -> List[int]:
    """Best-path decode of one utterance: argmax, collapse, strip blanks."""
    ids = np.asarray(log_probs).argmax(axis=-1)
    if length is not None:
        ids = ids[:length]
    out: List[int] = []
    prev = -1
    for i in ids.tolist():
        if i != prev and i != blank_id:
            out.append(i)
        prev = i
    return out
