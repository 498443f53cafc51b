"""Monotonic DTW alignment: CUDA kernel, plain version and numpy oracle.

Counterpart of the JAX package's ``dtw_align_batch``
(``silent_speech_tpu/ops/dtw.py``) and its TPU kernel
``pallas_dtw_align_batch`` (``ops/pallas/dtw_kernel.py``). For each
utterance, with valid lengths n1 (rows) and n2 (columns) of its padded cost
matrix C::

    dtw[0, 0] = 0, the rest of row 0 and column 0 = +inf
    dtw[i, j] = C[i, j] + min(dtw[i−1, j], dtw[i, j−1], dtw[i−1, j−1])

in float32 (the costs may be stored in bfloat16), then a backtrace from
(n1−1, n2−1) taking the first minimum in the order up, left, diag. Returns,
for each row i < n1, the smallest column visited (0 for row 0 and beyond
n1) and the corner cost ``dtw[n1−1, n2−1]``.

``dtw_align_batch`` launches ``csrc/dtw.cu`` for CUDA tensors and runs
``dtw_align_batch_plain`` (the JAX scan's per-cell recurrence, vectorized
over utterances and anti-diagonals) for CPU tensors; both sum in the same
order, so they agree bit for bit. ``dp_only=True`` skips the backtrace
(alignment of zeros): the DP-only timing mode of the JAX package's
``tools/prof_dtw.py``. ``align_from_distances_numpy`` is the float64
reference-semantics oracle of the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from . import build


def dtw_align_batch_plain(costs: torch.Tensor, n1: torch.Tensor,
                          n2: torch.Tensor, dp_only: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, T1, T2) costs and (K,) lengths → ((K, T1) int32 alignment, (K,)
    float32 path cost), in plain PyTorch on the costs' device."""
    k, t1, t2 = costs.shape
    dev = costs.device
    c = costs.float()
    n1 = n1.long().clamp(1, t1)
    n2 = n2.long().clamp(1, t2)
    inf = torch.full((k, 1), float("inf"), device=dev)
    i = torch.arange(t1, device=dev)
    rows = torch.arange(k, device=dev)
    prev = torch.full((k, t1), float("inf"), device=dev)
    prev[:, 0] = 0.0                                   # diagonal 0: (0, 0)
    prev2 = torch.full((k, t1), float("inf"), device=dev)
    corner = torch.zeros(k, device=dev)
    choices = torch.zeros((k, t1 + t2 - 1, t1), dtype=torch.uint8,
                          device=dev)
    for d in range(1, t1 + t2 - 1):
        up = torch.cat([inf, prev[:, :-1]], 1)         # dtw[i−1, j]
        left = prev                                    # dtw[i, j−1]
        dg = torch.cat([inf, prev2[:, :-1]], 1)        # dtw[i−1, j−1]
        pick_up = (up <= left) & (up <= dg)
        pick_left = ~pick_up & (left <= dg)
        choices[:, d] = torch.where(pick_up, 0, torch.where(pick_left, 1, 2))
        best = torch.minimum(torch.minimum(up, left), dg)
        j = d - i
        interior = (i >= 1) & (j >= 1) & (j <= t2 - 1)
        cell = c[:, i, j.clamp(0, t2 - 1)]
        cur = torch.where(interior, cell + best, float("inf"))
        corner = corner + torch.where(
            (n1 + n2 - 2 == d), cur[rows, n1 - 1], 0.0)
        prev2, prev = prev, cur
    align = torch.zeros((k, t1), dtype=torch.int64, device=dev)
    if not dp_only:
        bi, bj = n1 - 1, n2 - 1
        for _ in range(t1 + t2):
            active = (bi > 0) & (bj > 0)
            align[rows, bi] = torch.where(active, bj, align[rows, bi])
            ch = choices[rows, bi + bj, bi].long()
            bi = torch.where(active & (ch != 1), bi - 1, bi)
            bj = torch.where(active & (ch != 0), bj - 1, bj)
    return align.int(), corner


def dtw_align_batch(costs: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor,
                    dp_only: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched DTW: (K, T1, T2) costs (float32 or bfloat16; the DP runs in
    float32) and (K,) int lengths on one device → ((K, T1) int32
    alignment, (K,) float32 path cost). Lengths are clamped to [1, T]."""
    if costs.dim() != 3:
        raise ValueError(f"costs must be (K, T1, T2), got "
                         f"{tuple(costs.shape)}")
    k, t1, t2 = costs.shape
    for name, n in (("n1", n1), ("n2", n2)):
        if n.shape != (k,) or n.device != costs.device:
            raise ValueError(f"{name} must be ({k},) on {costs.device}, got "
                             f"{tuple(n.shape)} on {n.device}")
    if costs.device.type == "cpu":
        return dtw_align_batch_plain(costs, n1, n2, dp_only)
    if costs.device.type != "cuda":
        raise ValueError(f"no dtw_align_batch for device {costs.device}")
    if costs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bfloat16 or float32 costs, not "
                         f"{costs.dtype}")
    if not costs.is_contiguous():
        raise ValueError("costs must be contiguous")
    lib = _library()
    if lib.dtw_smem_bytes(t1) > 232448:  # an H100 block's shared memory
        raise ValueError(f"T1={t1} rows exceed the kernel's shared memory")
    n1 = n1.to(torch.int32).contiguous()
    n2 = n2.to(torch.int32).contiguous()
    align = torch.empty((k, t1), dtype=torch.int32, device=costs.device)
    cost = torch.empty(k, dtype=torch.float32, device=costs.device)
    choices = torch.empty((k, t1, (t2 + 15) // 16), dtype=torch.int32,
                          device=costs.device)
    with torch.cuda.device(costs.device):
        stream = torch.cuda.current_stream(costs.device).cuda_stream
        err = lib.dtw_align(costs.data_ptr(), n1.data_ptr(), n2.data_ptr(),
                            align.data_ptr(), cost.data_ptr(),
                            choices.data_ptr(), k, t1, t2,
                            int(costs.dtype == torch.bfloat16), int(dp_only),
                            stream)
    if err != 0:
        raise RuntimeError(
            f"dtw_align launch failed: {lib.dtw_error_string(err).decode()} "
            f"(cudaError {err}; shared memory per CTA "
            f"{lib.dtw_smem_bytes(t1)} bytes)")
    if dp_only:
        dtw_align_batch.dp_only_launches += 1
    else:
        dtw_align_batch.launches += 1
    return align, cost


# kernel launches since the last reset, with the backtrace and without
dtw_align_batch.launches = 0
dtw_align_batch.dp_only_launches = 0


def align_from_distances_numpy(distance_matrix: np.ndarray) -> List[int]:
    """Float64 oracle with the reference's semantics (``align.py:16-34``):
    the DP over the whole matrix, then the first-minimal backtrace."""
    costs = np.asarray(distance_matrix, dtype=np.float64)
    t1, t2 = costs.shape
    dtw = np.zeros_like(costs)
    dtw[0, 1:] = np.inf
    dtw[1:, 0] = np.inf
    for i in range(1, t1):
        for j in range(1, t2):
            dtw[i, j] = costs[i, j] + min(dtw[i - 1, j], dtw[i, j - 1],
                                          dtw[i - 1, j - 1])
    i, j = t1 - 1, t2 - 1
    results = [0] * t1
    while i > 0 and j > 0:
        results[i] = j
        i, j = min([(i - 1, j), (i, j - 1), (i - 1, j - 1)],
                   key=lambda x: dtw[x[0], x[1]])
    return results


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("dtw")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dtw_align.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                              i32, i32, ptr]
    lib.dtw_align.restype = i32
    lib.dtw_smem_bytes.argtypes = [i32]
    lib.dtw_smem_bytes.restype = i32
    lib.dtw_error_string.argtypes = [i32]
    lib.dtw_error_string.restype = ctypes.c_char_p
    return lib
