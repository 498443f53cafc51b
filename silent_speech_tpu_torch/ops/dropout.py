"""Regenerating dropout from a counter hash, and the fused ReLU+dropout.

Counterpart of ``silent_speech_tpu/ops/dropout.py``. The keep mask is a
pure function of (element index, seed): a murmur3-style counter hash, the
same mixer as the attention kernel's (``_hash_bits`` in
``silent_speech_tpu/ops/pallas/rel_attention.py``). So the backward
regenerates the mask instead of saving it, and the CPU and the card draw
the same mask for the same seed. One 32-bit hash yields the 8-bit random
words of four consecutive elements; the rate is quantized to 1/256 as in
the JAX op (0.2 → drop iff the byte < 51, keep scaled by 256/205).

A tensor that is a shard of the one-process tensor (``parallel/``: a data
rank's rows, a model rank's FFN columns) draws its slice of the
one-process mask: a ``Shard`` gives its rows' offset and its columns'
offset and count in the whole, and each element takes the bits of its
index in the whole, ``(row0 + r)·cols + col0 + c``.

These are XLA fusions in the JAX package, not Pallas kernels. On a CUDA
tensor ``mask_scale`` (mask, scale and the optional ReLU) and the ReLU
dropout's backward launch ``csrc/dropout.cu``: one pass over the tensor
a site, the bits drawn in the kernel, the scale passed by value (no copy
to the card, no stream sync); bf16 and f32, contiguous. CPU tensors take
the plain versions, ``mask_scale_plain`` and
``relu_dropout_backward_plain``: plain PyTorch tensor code, the oracle of
the tests, whose uint32 arithmetic runs on int64 tensors, masked to 32
bits after every multiply (the int64 product of two 32-bit values may
wrap, but its low 32 bits are right).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span
from . import build

M32 = 0xFFFFFFFF


def hash_bits(row: torch.Tensor, col, seed) -> torch.Tensor:
    """uint32 counter hash of (row, col, seed), as int64 values in
    [0, 2³²): ``x = (row·0x9E3779B1) ^ (col·0x85EBCA77) ^ seed`` then the
    murmur3 finalizer. Arguments broadcast; ``col`` and ``seed`` may be
    Python ints."""
    x = ((row * 0x9E3779B1) & M32) ^ ((col * 0x85EBCA77) & M32) ^ (seed & M32)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """Quantize a dropout rate to the uint8 threshold (drop iff the random
    byte < threshold)."""
    return int(round(rate * 256.0))


class Shard(NamedTuple):
    """Where a tensor lies in the one-process tensor: its rows (every axis
    but the last, flattened) start at row ``row0``, its columns at column
    ``col0`` of ``cols`` (None: the tensor's own width)."""

    row0: int = 0
    col0: int = 0
    cols: Optional[int] = None


def keep_mask(shape, seed: int, threshold: int, device: torch.device,
              shard: Optional[Shard] = None) -> torch.Tensor:
    """Boolean keep mask of ``shape``: element n keeps iff byte n mod 4 of
    ``hash_bits(n // 4, 0, seed)`` is ≥ ``threshold``, n the element's
    index in the one-process tensor that ``shard`` places it in."""
    with span("ssp.dropout.mask"):
        n = 1
        for d in shape:
            n *= int(d)
        width = int(shape[-1]) if len(shape) else 1
        row0, col0, cols = shard or Shard()
        cols = width if cols is None else cols
        shifts = torch.arange(0, 32, 8, device=device)
        if col0 == 0 and cols == width:
            # whole rows: one run of the flat index from base
            base = row0 * cols
            first = base % 4
            words = hash_bits(torch.arange(base // 4, (base + n + 3) // 4,
                                           device=device), 0, seed)
            bytes_ = (words[:, None] >> shifts) & 0xFF
            return (bytes_.reshape(-1)[first: first + n]
                    >= threshold).reshape(shape)
        rows = torch.arange(row0, row0 + n // width, device=device)
        index = (rows[:, None] * cols
                 + torch.arange(col0, col0 + width, device=device)[None, :])
        bytes_ = (hash_bits(index >> 2, 0, seed) >> ((index & 3) * 8)) & 0xFF
        return (bytes_ >= threshold).reshape(shape)


def _scale(threshold: int, dtype: torch.dtype) -> torch.Tensor:
    # the keep scale rounded to the tensor's dtype, as the JAX op casts it
    return torch.tensor(1.0 / (1.0 - threshold / 256.0), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _scale_value(threshold: int, dtype: torch.dtype) -> float:
    """``_scale`` as the Python float the kernels take by value."""
    return float(_scale(threshold, dtype))


def mask_scale_plain(x: torch.Tensor, seed: int, threshold: int,
                     shard: Optional[Shard] = None,
                     relu: bool = False) -> torch.Tensor:
    """``x`` (after a ReLU with ``relu``) with the dropped elements zeroed
    and the kept ones scaled, in plain tensor code on any device."""
    if relu:
        x = torch.relu(x)
    keep = keep_mask(x.shape, seed, threshold, x.device, shard)
    return torch.where(keep, x * _scale(threshold, x.dtype).to(x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def relu_dropout_backward_plain(g: torch.Tensor, y: torch.Tensor,
                                threshold: int) -> torch.Tensor:
    """The ReLU dropout's input gradient from its output ``y``: ``g``
    scaled where ``y > 0``, else 0."""
    return torch.where(y > 0, g * _scale(threshold, g.dtype).to(g.device),
                       torch.zeros((), dtype=g.dtype, device=g.device))


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check(*tensors: torch.Tensor) -> None:
    """What the kernels take: contiguous bf16 or f32 tensors of one dtype
    and shape (``ValueError`` otherwise)."""
    first = tensors[0]
    for t in tensors:
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"the dropout kernels take bfloat16 or float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the dropout kernels take contiguous tensors")
        if t.dtype != first.dtype or t.shape != first.shape:
            raise ValueError(f"{t.dtype} {tuple(t.shape)} beside "
                             f"{first.dtype} {tuple(first.shape)}")


def _geometry(shape, shard: Optional[Shard] = None
              ) -> Tuple[int, int, int, int, int, int]:
    """The kernel's index arguments for a tensor of ``shape`` that
    ``shard`` places: (n, width, base, row0, col0, cols). Its element i
    (row-major) takes the index ``base + i`` when it holds whole rows
    (``col0`` 0 and ``cols`` its width; ``base = row0·cols``), else
    ``(row0 + i // width)·cols + col0 + i % width``, as in ``keep_mask``."""
    n = 1
    for d in shape:
        n *= int(d)
    width = int(shape[-1]) if len(shape) else 1
    row0, col0, cols = shard or Shard()
    cols = width if cols is None else cols
    return n, width, row0 * cols, row0, col0, cols


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.dropout_error_string(err).decode()} "
                           f"(cudaError {err})")


def _launch_mask_scale(x, seed, threshold, shard, relu):
    _check(x)
    n, width, base, row0, col0, cols = _geometry(x.shape, shard)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dropout_mask_scale(
            x.data_ptr(), y.data_ptr(), n, width, base, row0, col0, cols,
            seed & M32, threshold, _scale_value(threshold, x.dtype),
            int(relu), int(x.dtype == torch.bfloat16), stream)
    _raise_on(lib, "dropout_mask_scale", err)
    mask_scale.launches += 1
    return y


def _launch_relu_bwd(g, y, threshold):
    _check(g, y)
    out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    if g.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.dropout_relu_bwd(
            g.data_ptr(), y.data_ptr(), out.data_ptr(), g.numel(),
            _scale_value(threshold, g.dtype),
            int(g.dtype == torch.bfloat16), stream)
    _raise_on(lib, "dropout_relu_bwd", err)
    relu_dropout.backward_launches += 1
    return out


def mask_scale(x: torch.Tensor, seed: int, threshold: int,
               shard: Optional[Shard] = None,
               relu: bool = False) -> torch.Tensor:
    """``x`` (after a ReLU with ``relu``) with the dropped elements zeroed
    and the kept ones scaled. A CUDA tensor (contiguous, bf16 or f32)
    launches ``csrc/dropout.cu`` once; a CPU tensor takes
    ``mask_scale_plain``."""
    if x.device.type == "cpu":
        return mask_scale_plain(x, seed, threshold, shard, relu)
    if x.device.type != "cuda":
        raise ValueError(f"no mask_scale for device {x.device}")
    with span("ssp.dropout.mask"):
        return _launch_mask_scale(x, seed, threshold, shard, relu)


# kernel launches since the last reset
mask_scale.launches = 0


class _RegenDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, threshold, shard):
        ctx.seed, ctx.threshold, ctx.shard = seed, threshold, shard
        return mask_scale(x.contiguous(), seed, threshold, shard)

    @staticmethod
    def backward(ctx, g):
        # the same bits from the same seed: the mask is recomputed, not
        # saved
        return (mask_scale(g.contiguous(), ctx.seed, ctx.threshold,
                           ctx.shard), None, None, None)


def regen_dropout(x: torch.Tensor, seed: int, threshold: int,
                  shard: Optional[Shard] = None) -> torch.Tensor:
    """Dropout whose backward regenerates the mask from ``seed``;
    ``threshold`` 0 is the identity."""
    if threshold == 0:
        return x
    return _RegenDropout.apply(x, seed, threshold, shard)


class _ReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, threshold, shard):
        y = mask_scale(x.contiguous(), seed, threshold, shard, relu=True)
        ctx.save_for_backward(y)
        ctx.threshold = threshold
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        if g.device.type == "cpu":
            dx = relu_dropout_backward_plain(g, y, ctx.threshold)
        else:
            dx = _launch_relu_bwd(g.contiguous(), y, ctx.threshold)
        return dx, None, None, None


def relu_dropout(x: torch.Tensor, seed: int, threshold: int,
                 shard: Optional[Shard] = None) -> torch.Tensor:
    """``dropout(relu(x))`` whose backward needs no random bits: the saved
    output's sign is the joint relu and keep mask (JAX ``relu_dropout``).
    ``threshold`` 0 is a plain ReLU."""
    if threshold == 0:
        return torch.relu(x)
    return _ReluDropout.apply(x, seed, threshold, shard)


# backward kernel launches since the last reset (its forward launches
# count under mask_scale.launches)
relu_dropout.backward_launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("dropout")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dropout_mask_scale.argtypes = [
        ptr, ptr, i64, i32, i64, i64, i64, i64, ctypes.c_uint, i32,
        ctypes.c_float, i32, i32, ptr]
    lib.dropout_mask_scale.restype = i32
    lib.dropout_relu_bwd.argtypes = [ptr, ptr, ptr, i64, ctypes.c_float,
                                     i32, ptr]
    lib.dropout_relu_bwd.restype = i32
    lib.dropout_error_string.argtypes = [i32]
    lib.dropout_error_string.restype = ctypes.c_char_p
    return lib
