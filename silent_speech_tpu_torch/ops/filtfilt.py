"""A chain of zero-phase IIR filters over ragged columns: CUDA kernel and
plain version.

The JAX package filters each utterance's EMG with seven notches and a
high-pass, each a ``filtfilt`` whose recurrence is a ``lax.scan`` under XLA
(``silent_speech_tpu/dsp/jax_filters.py:49-148``,
``silent_speech_tpu/dsp/jax_pipeline.py:34-43``), not a Pallas kernel.
``filtfilt_chain`` applies such a chain to a (B, T_pad, C) float32 buffer
whose utterance b is valid in rows [0, lengths[b]): every filter runs
forward and reverse with its odd extension, to each column's own length,
and the rows past it come out as 0.

CUDA tensors launch ``csrc/filtfilt.cu``: the whole chain in one launch,
one lane per (utterance, channel) column and 32 columns a CTA, whose
recurrence reads and writes a ring of tiles in shared memory that
producer warps fill ahead of it (cp.async) and drain warps empty into a
(B, T_pad + 2P, C) scratch between passes; bit-equal to the plain version
(explicit roundings, the same order). CPU tensors take
``filtfilt_chain_plain``, which runs ``dsp/device_filters``'
``filtfilt_masked_plain`` filter after filter on every column at once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..dsp.device_filters import (filter_table, filtfilt_masked_plain,
                                  padlen)
from . import build

Chain = Sequence[Tuple[Sequence[float], Sequence[float]]]

# the kernel's limits: filters a launch, delays a filter (4 taps)
MAX_FILTERS = 16
MAX_DELAYS = 3


def chain_padlen(coeffs: Chain) -> int:
    """The largest odd-extension length of the chain's filters."""
    return max(padlen(b, a) for b, a in coeffs)


def _key(coeffs: Chain) -> tuple:
    """The chain as nested tuples of floats: what a launch derives from it
    (float64 normalizations and solves, ~1 ms on the host) is cached."""
    return tuple((tuple(np.ravel(b).tolist()), tuple(np.ravel(a).tolist()))
                 for b, a in coeffs)


@functools.lru_cache(maxsize=32)
def _padlen(key: tuple) -> int:
    return chain_padlen(key)


def _check(x: torch.Tensor, lengths: torch.Tensor, coeffs: Chain
           ) -> torch.Tensor:
    """Validate the inputs; returns the lengths on the host as int32."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T_pad, C), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not 1 <= len(coeffs) <= MAX_FILTERS:
        raise ValueError(f"a chain of 1 to {MAX_FILTERS} filters, got "
                         f"{len(coeffs)}")
    host = lengths.detach().to("cpu", torch.int32).reshape(-1)
    if host.shape[0] != x.shape[0]:
        raise ValueError(f"lengths must be ({x.shape[0]},), got "
                         f"{tuple(lengths.shape)}")
    p = _padlen(_key(coeffs))
    if host.numel() and (int(host.min()) <= p
                         or int(host.max()) > x.shape[1]):
        raise ValueError(
            f"every length must exceed the padlen {p} (scipy's filtfilt "
            f"needs more samples than its odd extension) and be at most "
            f"T_pad = {x.shape[1]}; got {host.tolist()}")
    return host


def filtfilt_chain_plain(x: torch.Tensor, lengths: torch.Tensor,
                         coeffs: Chain) -> torch.Tensor:
    """The plain version: each filter's ``filtfilt_masked_plain`` over the
    B·C columns, in the chain's order."""
    b_, t_pad, c = x.shape
    cols = x.permute(1, 0, 2).reshape(t_pad, b_ * c)
    col_len = lengths.to(x.device, torch.long).repeat_interleave(c)
    for b, a in coeffs:
        cols = filtfilt_masked_plain(b, a, cols, col_len)
    return cols.reshape(t_pad, b_, c).permute(1, 0, 2).contiguous()


def filtfilt_chain(x: torch.Tensor, lengths: torch.Tensor,
                   coeffs: Chain) -> torch.Tensor:
    """The chain ``coeffs`` ((b, a) pairs, applied in order) over the
    valid prefix of each utterance of ``x`` (B, T_pad, C) float32;
    ``lengths`` (B,), each above the chain's largest padlen and at most
    T_pad (else ``ValueError``). A CUDA tensor launches the kernel once;
    a CPU tensor takes the plain version."""
    host = _check(x, lengths, coeffs)
    if x.shape[0] == 0:
        return x.clone()
    if x.device.type == "cpu":
        return filtfilt_chain_plain(x, host, coeffs)
    if x.device.type != "cuda":
        raise ValueError(f"no filtfilt_chain for device {x.device}")
    return _launch(x.contiguous(), host, coeffs)


# kernel launches since the last reset
filtfilt_chain.launches = 0


@functools.lru_cache(maxsize=32)
def _kernel_table(key: tuple) -> Tuple[np.ndarray, np.ndarray]:
    return _table(key)


def _table(coeffs: Chain) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's coefficient table: delays a filter, and per filter
    b[4], a[4], zi[3] in float32 (unused taps 0)."""
    nd = np.zeros(len(coeffs), np.int32)
    coef = np.zeros((len(coeffs), 11), np.float32)
    for f, (b, a) in enumerate(coeffs):
        b32, a32, zi = filter_table(b, a)
        n = len(b32) - 1
        if not 1 <= n <= MAX_DELAYS:
            raise ValueError(f"the kernel takes filters of 2 to "
                             f"{MAX_DELAYS + 1} taps, got {n + 1}")
        nd[f] = n
        coef[f, : n + 1] = b32
        coef[f, 4: 5 + n] = a32
        coef[f, 8: 8 + n] = zi
    return nd, coef


def _launch(x: torch.Tensor, lengths: torch.Tensor, coeffs: Chain
            ) -> torch.Tensor:
    b_, t_pad, c = x.shape
    key = _key(coeffs)
    nd, coef = _kernel_table(key)
    lib = _library()
    rows = t_pad + 2 * _padlen(key)
    out = torch.empty_like(x)
    scratch = torch.empty((b_, rows, c), dtype=torch.float32,
                          device=x.device)
    dev_len = lengths.to(x.device, non_blocking=True)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.filtfilt_chain(
            x.data_ptr(), dev_len.data_ptr(), out.data_ptr(),
            scratch.data_ptr(),
            nd.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(coeffs), b_, t_pad, c, stream)
    if err != 0:
        raise RuntimeError(f"filtfilt_chain launch failed: "
                           f"{lib.filtfilt_error_string(err).decode()} "
                           f"(cudaError {err})")
    filtfilt_chain.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("filtfilt")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.filtfilt_chain.argtypes = [ptr] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        i32, i32, i32, i32, ptr]
    lib.filtfilt_chain.restype = i32
    lib.filtfilt_error_string.argtypes = [i32]
    lib.filtfilt_error_string.restype = ctypes.c_char_p
    return lib
