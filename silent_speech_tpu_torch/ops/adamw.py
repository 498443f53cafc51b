"""AdamW over every leaf of an optimizer in one launch, and the gradient
accumulation's fold (``csrc/adamw.cu``).

Counterpart of ``fused_adamw`` / ``make_adamw`` in the JAX package
(``silent_speech_tpu/train/state.py``), an XLA fusion, not a Pallas
kernel. ``train/state.FusedAdamW`` keeps the per-leaf loop of eager tensor
ops as the plain version, which CPU tensors take and the tests hold the
kernels to, bit for bit on the card. On the card it calls ``adamw_update``
once an update and, with accumulation, ``adamw_fold`` once a micro-step:
one launch each for up to ``leaves_per_launch()`` leaves. Every pointer
and scalar goes by value in the launch's parameter block, computed on the
host: nothing is copied to the card, nothing is allocated there, and the
stream is not synchronized.

``Leaves`` holds what the kernels take of an optimizer's leaves, checked
once: their pointers, sizes and chunks (``plan_chunks``), and the launches
that cover them (``plan_launches``). It is rebuilt when a leaf's storage
moves; the gradients, new tensors every step, are read at each launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build


def plan_chunks(sizes: Sequence[int], chunk: int) -> List[int]:
    """Each leaf's first chunk, and after them the chunks in all: leaf k of
    ``sizes[k]`` elements is cut from its first element into runs of
    ``chunk`` (the last one ragged), its chunks numbered first[k] ..
    first[k + 1] − 1, leaf after leaf. Chunk c of leaf k holds its elements
    from (c − first[k])·chunk."""
    if chunk < 4 or chunk % 4:
        raise ValueError(f"a chunk holds a multiple of 4 elements, got "
                         f"{chunk}")
    first = [0]
    for n in sizes:
        first.append(first[-1] + -(-n // chunk))
    return first


def plan_launches(first: Sequence[int], per_launch: int
                  ) -> List[Tuple[int, int]]:
    """The leaves leaf0 .. leaf1 − 1 of each launch, at most ``per_launch``
    of them, from ``plan_chunks``'s offsets. A run of leaves without
    elements takes no launch."""
    n_leaves = len(first) - 1
    return [(leaf0, min(leaf0 + per_launch, n_leaves))
            for leaf0 in range(0, n_leaves, per_launch)
            if first[min(leaf0 + per_launch, n_leaves)] > first[leaf0]]


class Hyper(NamedTuple):
    """An update's scalars, each a float32 value computed on the host:
    β₁, β₂, 1 − β₁, 1 − β₂, the reciprocals of the bias corrections
    1 − β**count, ε, the weight decay and −lr."""

    b1: float
    b2: float
    one_minus_b1: float
    one_minus_b2: float
    inv_bc1: float
    inv_bc2: float
    eps: float
    weight_decay: float
    neg_lr: float


MOMENT_DTYPES = (torch.bfloat16, torch.float32)


def _check_leaf(k: int, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                acc: Optional[torch.Tensor], device: torch.device) -> None:
    if p.dtype != torch.float32:
        raise ValueError(f"the AdamW kernel takes float32 parameters, leaf "
                         f"{k} is {p.dtype}")
    if m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype:
        raise ValueError(f"the AdamW kernel takes bfloat16 or float32 "
                         f"moments, leaf {k} has {m.dtype} and {v.dtype}")
    if acc is not None and acc.dtype != torch.float32:
        raise ValueError(f"leaf {k}'s accumulator is {acc.dtype}")
    for t in (p, m, v) if acc is None else (p, m, v, acc):
        if t.device != device:
            raise ValueError(f"leaf {k} lies on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"the AdamW kernel takes contiguous leaves, "
                             f"leaf {k} is not")
        if t.numel() != p.numel():
            raise ValueError(f"leaf {k}: {tuple(t.shape)} beside "
                             f"{tuple(p.shape)}")


class Leaves:
    """The leaves ``params`` with moments ``mu``, ``nu`` and accumulators
    ``acc`` (empty without accumulation) as the kernels take them: 5
    pointers a leaf (p, m, v, acc, and the gradient, set at each launch),
    their sizes and first chunks, and the launches' runs of leaves."""

    def __init__(self, params: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                 acc: Sequence[torch.Tensor]):
        device = params[0].device
        if device.type != "cuda":
            raise ValueError(f"the AdamW kernel runs on CUDA tensors, not "
                             f"{device}")
        accs = list(acc) or [None] * len(params)
        if not len(params) == len(mu) == len(nu) == len(accs):
            raise ValueError("one moment pair (and accumulator) a leaf")
        for k, (p, m, v, a) in enumerate(zip(params, mu, nu, accs)):
            _check_leaf(k, p, m, v, a, device)
        if len({m.dtype for m in mu}) > 1:
            raise ValueError("the AdamW kernel takes one moment dtype")
        self.key = self._key([*params, *mu, *nu, *acc])
        self.device = device
        self.sizes = [p.numel() for p in params]
        self.bf16_moments = mu[0].dtype == torch.bfloat16
        self.ptrs = (ctypes.c_ulonglong * (5 * len(params)))(*[
            x for p, m, v, a in zip(params, mu, nu, accs)
            for x in (p.data_ptr(), m.data_ptr(), v.data_ptr(),
                      0 if a is None else a.data_ptr(), 0)])
        first = plan_chunks(self.sizes, _library().adamw_chunk_elements())
        self.runs = []
        for leaf0, leaf1 in plan_launches(first, leaves_per_launch()):
            n = leaf1 - leaf0
            self.runs.append((
                leaf0, n,
                (ctypes.c_longlong * n)(*self.sizes[leaf0:leaf1]),
                (ctypes.c_int * n)(*[f - first[leaf0]
                                     for f in first[leaf0:leaf1]]),
                first[leaf1] - first[leaf0]))

    @staticmethod
    def _key(tensors) -> list:
        return [t.data_ptr() for t in tensors]

    def current(self, params, mu, nu, acc) -> bool:
        """Whether these are the tensors, in the same storage, that the
        leaves were built from."""
        return self._key([*params, *mu, *nu, *acc]) == self.key

    def set_grads(self, grads: Optional[Sequence[Optional[torch.Tensor]]]
                  ) -> None:
        """Point each leaf at its gradient in ``grads`` (None: zero; all
        None for ``grads`` None): contiguous float32 tensors of the leaves'
        sizes on their card."""
        if grads is None:
            grads = [None] * len(self.sizes)
        if len(grads) != len(self.sizes):
            raise ValueError(f"{len(grads)} gradients for {len(self.sizes)} "
                             f"leaves")
        for k, g in enumerate(grads):
            if g is None:
                self.ptrs[5 * k + 4] = 0
                continue
            if g.dtype != torch.float32 or not g.is_contiguous() \
                    or g.numel() != self.sizes[k] \
                    or g.get_device() != self.device.index:
                raise ValueError(f"the AdamW kernel takes contiguous float32 "
                                 f"gradients of the leaf's size on "
                                 f"{self.device}; leaf {k}'s is {g.dtype} "
                                 f"{tuple(g.shape)} on {g.device}")
            self.ptrs[5 * k + 4] = g.data_ptr()

    def launches(self):
        """Each launch's leading arguments: its leaves' pointers, sizes and
        first chunks, their count and their chunks."""
        base = ctypes.addressof(self.ptrs)
        row = 5 * ctypes.sizeof(ctypes.c_ulonglong)
        for leaf0, n, sizes, first, chunks in self.runs:
            yield base + row * leaf0, sizes, first, n, chunks


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.adamw_error_string(err).decode()} "
                           f"(cudaError {err})")


def adamw_update(leaves: Leaves,
                 grads: Optional[Sequence[Optional[torch.Tensor]]],
                 h: Hyper) -> None:
    """One AdamW update of every leaf in ``leaves`` from ``grads`` (one a
    leaf, None for a zero gradient), or, with ``grads`` None, from each
    leaf's accumulator, which is then zeroed."""
    lib = _library()
    leaves.set_grads(grads)
    with torch.cuda.device(leaves.device):
        stream = torch.cuda.current_stream(leaves.device).cuda_stream
        for args in leaves.launches():
            err = lib.adamw_update(*args, *h, int(grads is None),
                                   int(leaves.bf16_moments), stream)
            _raise_on(lib, "adamw_update", err)
            adamw_update.launches += 1


# kernel launches since the last reset
adamw_update.launches = 0


def adamw_fold(leaves: Leaves, grads: Sequence[Optional[torch.Tensor]],
               n: int) -> None:
    """``acc ← acc + (g − acc)·(1/n)`` for every leaf's accumulator, g its
    gradient in ``grads`` (None: zero) and 1/n rounded to float32: the
    loop's ``torch._foreach_div_`` by ``n`` on the card."""
    lib = _library()
    leaves.set_grads(grads)
    inv_n = float(np.float32(1) / np.float32(n))
    with torch.cuda.device(leaves.device):
        stream = torch.cuda.current_stream(leaves.device).cuda_stream
        for args in leaves.launches():
            err = lib.adamw_fold(*args, inv_n, stream)
            _raise_on(lib, "adamw_fold", err)
            adamw_fold.launches += 1


# kernel launches since the last reset
adamw_fold.launches = 0


def leaves_per_launch() -> int:
    """The leaves one launch takes at most (their pointers fill the
    kernel's parameter block)."""
    return _library().adamw_leaves_per_launch()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("adamw")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adamw_leaves_per_launch.argtypes = []
    lib.adamw_leaves_per_launch.restype = i32
    lib.adamw_chunk_elements.argtypes = []
    lib.adamw_chunk_elements.restype = i32
    lib.adamw_update.argtypes = [ptr, ptr, ptr, i32, i32, *[f32] * 9, i32,
                                 i32, ptr]
    lib.adamw_update.restype = i32
    lib.adamw_fold.argtypes = [ptr, ptr, ptr, i32, i32, f32, ptr]
    lib.adamw_fold.restype = i32
    lib.adamw_error_string.argtypes = [i32]
    lib.adamw_error_string.restype = ctypes.c_char_p
    return lib
