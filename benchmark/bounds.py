"""The yardstick's peaks and the least time of each kernel, from shapes.

Frozen copy of ``chip_smoke.py``'s bound arithmetic (``HBM_BYTES_PER_S``,
``PEAK_OPS``, ``_visible_pairs``, ``_bound``, ``attention_bound``,
``attention_bwd_bound``, ``dtw_bound``, ``ctc_bound``), so that a later
change to the program cannot move the yardstick. Each bound is the larger
of the bytes a kernel has to move once over HBM and the operations it has
to issue over the peak rate, whatever the implementation; each returns
``(ms, "bytes" | "operations")``, the second naming which of the two set
it. ``ctc_bound`` takes the shapes and the lengths, not the log-probs
themselves, so that a run keeps no (U, T, K) tensor for it.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense,
without sparsity.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 on the tensor cores
            "float32": 67e12}      # f32 outside the tensor cores


def visible_pairs(t: int, m: int, valid_len: int) -> int:
    """(query, key) pairs of one (row, head) that the relative band lets
    attend: |k − q| ≤ m − 1, and both on the same side of ``valid_len``."""
    q = np.arange(t)
    lo = np.where(q < valid_len, np.maximum(0, q - m + 1),
                  np.maximum(valid_len, q - m + 1))
    hi = np.where(q < valid_len, np.minimum(valid_len - 1, q + m - 1),
                  np.minimum(t - 1, q + m - 1))
    return int(np.sum(hi - lo + 1))


def bound(nbytes: float, ops: float, dtype_name: str) -> Tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_bound(b, h, t, dh, m, valid_len, dtype_name):
    """The forward: Q, K, V and E read once and O written once, or its
    three d_h-long dot products (QK, QE, PV) per visible pair."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (4 * b * h * t * dh + h * (2 * m - 1) * dh) * item
    ops = 3 * 2 * dh * visible_pairs(t, m, valid_len) * b * h
    return bound(nbytes, ops, dtype_name)


def attention_bwd_bound(b, h, t, dh, m, dtype_name):
    """The backward: Q, K, V, dO and E read once, dQ, dK, dV and dE
    written once, or its eight d_h-long products per visible pair (S's
    two, dP, dV, dQ's two, dK, dE)."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = (7 * b * h * t * dh + 2 * h * (2 * m - 1) * dh) * item
    ops = 8 * 2 * dh * visible_pairs(t, m, t) * b * h
    return bound(nbytes, ops, dtype_name)


def dtw_bound(n1: Sequence[int], n2: Sequence[int], t1: int, item: int):
    """The DTW: the valid cost cells read once, the lengths read and the
    alignment and costs written once, or four f32 operations (three
    compares and an add) per valid cell over the f32 peak."""
    n1 = np.asarray(n1, np.int64)
    n2 = np.asarray(n2, np.int64)
    cells = int(np.sum(n1 * n2))
    k = len(n1)
    nbytes = cells * item + 8 * k + 4 * k * t1 + 4 * k
    return bound(nbytes, 4 * cells, "float32")


def ctc_bound(lp_shape: Sequence[int], utt_len: Sequence[int],
              text_len: Sequence[int], labels_width: int):
    """The CTC forward and backward: the log-probs of the live frames of
    rows with text read once, their labels, the counts and the NLL's
    cotangent read once, the dense (U, T, K) gradient and the NLL written
    once; or 61 f32 operations a live (frame, position) cell of a row with
    text (24 forward, 35 in the backward's recursion, 2 in the gradient's
    sum; an exp or a log1p counted as one)."""
    u, t, k = lp_shape
    frames = np.clip(np.asarray(utt_len, np.int64), 0, t)
    text = np.clip(np.asarray(text_len, np.int64), 0, labels_width)
    live = text > 0
    nbytes = (4 * k * int(frames[live].sum()) + 4 * int(text.sum())
              + 3 * 4 * u + 4 * u * t * k + 4 * u)
    cells = int((frames[live] * (text[live] + 1)).sum())
    return bound(nbytes, 61 * cells, "float32")
