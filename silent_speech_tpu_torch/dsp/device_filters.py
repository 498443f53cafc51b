"""IIR filtering on tensors: ``lfilter`` and ``filtfilt`` with scipy's
semantics.

Counterpart of the JAX package's ``silent_speech_tpu/dsp/jax_filters.py``.
``filtfilt`` follows scipy's defaults: an odd extension of
``3·max(len(a), len(b))`` samples at both ends, the steady-state delays
(``lfilter_zi``) scaled by the first sample, a forward pass, a reverse pass,
and the crop. The recurrence is transposed direct form II over time, in
float32, with the coefficients cast to float32 as JAX casts them.

``filtfilt_masked`` filters the valid prefix of each column of a padded
buffer: rows at and past ``length`` come out as zeros, and the valid rows
equal ``filtfilt`` of the prefix alone bit for bit. This is what lets
utterances of different lengths share one launch.

The plain versions (``lfilter``, ``filtfilt_plain``,
``filtfilt_masked_plain``) are loops over time on tensors of shape
(columns,), every column at once; they serve CPU tensors and are the oracle
of the tests. A CUDA tensor goes through the kernel ``csrc/filtfilt.cu``
(``ops/filtfilt.py``) or raises.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def _normalize_ba(b, a) -> Tuple[np.ndarray, np.ndarray]:
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    return b / a[0], a / a[0]


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state initial delays (``scipy.signal.lfilter_zi``), float64."""
    b, a = _normalize_ba(b, a)
    n = len(a)
    if n == 1:
        return np.zeros(0)
    # solve (I - A) zi = B with the companion-form transition matrix
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - A, B)


def padlen(b, a) -> int:
    """scipy's default odd-extension length, 3·max(len(a), len(b))."""
    bn, _ = _normalize_ba(b, a)
    return 3 * len(bn)


def filter_table(b, a) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The float32 coefficients both routes use: b and a normalized by
    a[0] in float64, then cast, and the float64 ``lfilter_zi`` cast."""
    bn, an = _normalize_ba(b, a)
    return (bn.astype(np.float32), an.astype(np.float32),
            lfilter_zi(bn, an).astype(np.float32))


def lfilter(b, a, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Transposed direct form II over axis 0 of ``x`` (T, N) float32 from
    the delays ``zi`` (n−1, N): each step ``y = b0·x + z0``, then
    ``z' = (shift(z) + b[1:]·x) − a[1:]·y``, one rounding each."""
    b32, a32, _ = (torch.from_numpy(v).to(x.device)
                   for v in filter_table(b, a))
    n = len(b32)
    bx = [b32[k] * x for k in range(n)]       # the products, one rounding
    ak = list(a32.unbind(0))
    z = list(zi.unbind(0))
    zero = torch.zeros_like(x[0])
    y = torch.empty_like(x)
    for t in range(x.shape[0]):
        yt = bx[0][t] + z[0]
        shifted = z[1:] + [zero]
        z = [(shifted[k] + bx[k + 1][t]) - ak[k + 1] * yt
             for k in range(n - 1)]
        y[t] = yt
    return y


def _zi_times(b, a, first: torch.Tensor) -> torch.Tensor:
    zi = torch.from_numpy(filter_table(b, a)[2]).to(first.device)
    return zi[:, None] * first[None, :]


def filtfilt_plain(b, a, x: torch.Tensor) -> torch.Tensor:
    """scipy's ``filtfilt`` of (T, N) float32 over axis 0, the plain way:
    concatenate the extensions, filter, reverse, filter, reverse, crop."""
    p = padlen(b, a)
    n = x.shape[0]
    if n <= p:
        raise ValueError(f"filtfilt needs more than {p} samples, got {n}")
    front = 2 * x[0:1] - x[1: p + 1].flip(0)
    back = 2 * x[-1:] - x[-p - 1: -1].flip(0)
    ext = torch.cat([front, x, back], 0)
    y = lfilter(b, a, ext, _zi_times(b, a, ext[0]))
    y_rev = y.flip(0)
    y2 = lfilter(b, a, y_rev, _zi_times(b, a, y_rev[0])).flip(0)
    return y2[p: p + n]


def filtfilt_masked_plain(b, a, x: torch.Tensor, lengths: torch.Tensor
                          ) -> torch.Tensor:
    """``filtfilt_plain`` of each column's valid prefix: ``x`` is (T_pad,
    N), column j valid in rows [0, lengths[j]). The extensions, the
    reversal and the crop are gathers at each column's own end (JAX's
    ``_filtfilt_masked_impl``); rows at and past a column's length are 0."""
    p = padlen(b, a)
    t_pad, n = x.shape
    dev = x.device
    lengths = lengths.to(device=dev, dtype=torch.long)
    total_rows = t_pad + 2 * p
    cols = torch.arange(n, device=dev)

    def rows(idx):          # gather x[idx[i, j], j], indices clipped
        return x[idx.clamp(0, t_pad - 1), cols]

    j = torch.arange(p, device=dev)[:, None]
    front = 2 * x[0:1] - x[1: p + 1].flip(0)
    back = 2 * rows(lengths - 1)[None, :] - rows(lengths[None, :] - 2 - j)
    ext = torch.cat([front, x, x.new_zeros(p, n)], 0)
    ext[p + lengths[None, :] + j, cols] = back
    y = lfilter(b, a, ext, _zi_times(b, a, ext[0]))

    total = lengths + 2 * p
    t = torch.arange(total_rows, device=dev)[:, None]
    y_rev = torch.where(t < total,
                        y[(total - 1 - t).clamp(0, total_rows - 1), cols],
                        0.0)
    y2 = lfilter(b, a, y_rev, _zi_times(b, a, y_rev[0]))
    tp = torch.arange(t_pad, device=dev)[:, None]
    out = y2[(lengths + p - 1 - tp).clamp(0, total_rows - 1), cols]
    return torch.where(tp < lengths, out, 0.0)


def _as_columns(x: torch.Tensor):
    """(T,), (T, C) or (B, T, C) → (B, T, C) and how to undo it."""
    if x.dim() == 1:
        return x[None, :, None], lambda y: y[0, :, 0]
    if x.dim() == 2:
        return x[None], lambda y: y[0]
    if x.dim() == 3:
        return x, lambda y: y
    raise ValueError(f"expected (T,), (T, C) or (B, T, C), got "
                     f"{tuple(x.shape)}")


def filtfilt(b, a, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase filtering of (T,) or (T, C) float32 over time."""
    if x.device.type == "cpu":
        if x.dim() == 1:
            return filtfilt_plain(b, a, x[:, None])[:, 0]
        return filtfilt_plain(b, a, x)
    return filtfilt_masked(b, a, x, x.shape[0])


def filtfilt_masked(b, a, x: torch.Tensor,
                    length: Union[int, torch.Tensor]) -> torch.Tensor:
    """Zero-phase filtering of the valid prefix of a padded buffer: ``x``
    is (T_pad,), (T_pad, C) or (B, T_pad, C), valid in rows [0, length)
    (an int, or (B,) lengths for a batch). Rows at and past the length are
    0. A length ≤ the padlen (3·ntaps) raises ``ValueError``."""
    from ..ops.filtfilt import filtfilt_chain

    x3, undo = _as_columns(x)
    lengths = torch.as_tensor(length, dtype=torch.int32).reshape(-1)
    if lengths.numel() == 1:
        lengths = lengths.expand(x3.shape[0])
    return undo(filtfilt_chain(x3, lengths, ((b, a),)))
