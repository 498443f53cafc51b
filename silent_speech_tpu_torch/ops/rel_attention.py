"""Relative-position attention: forward and backward CUDA kernels and their
plain version.

Counterpart of ``fused_rel_attention`` in the JAX package
(``silent_speech_tpu/ops/pallas/rel_attention.py``: ``_fwd`` and ``_bwd``
→ ``pl.pallas_call``, bodies ``_fwd_kernel`` and ``_bwd_kernel``), plus the
utterance-length mask that the JAX serving forward applies through segment
ids. For query q and key k of one (batch b, head h)::

    s[q, k] = (q·k)/√d_h + q·E_h[k − q + m − 1]
              if |k − q| ≤ m − 1 and (k < L) == (q < L), else −1e8
    P = softmax(s);  P' = P ⊙ keep / (1 − t/2³²);  O = P' · V

with ``keep[q, k] = hash_bits(q, k, seed + b·H + h) ≥ t`` for a uint32
threshold t (0 = no dropout): the counter hash that the JAX kernel runs
off the TPU (``_hash_bits``), so the kernels, the plain version and the
JAX kernel in interpret mode draw the same mask.

``rel_attention`` launches ``csrc/rel_attention_fwd.cu`` for CUDA tensors,
inside an autograd function whose backward launches
``csrc/rel_attention_bwd.cu``; nothing quadratic is saved between them.
CPU tensors take ``rel_attention_plain``, differentiated by autograd;
nothing else selects the plain version. What bounds each kernel on the
card is in its source's header.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build
from .dropout import M32, hash_bits

NEG_INF = -1e8  # the reference's out-of-window logit


def attention_drop_threshold(rate: float) -> int:
    """uint32 dropout threshold of the attention probabilities (drop iff
    the 32 random bits < threshold), as the JAX model computes it."""
    return min(int(round(rate * 2.0 ** 32)), M32)


def _keep_scale(drop_threshold: int) -> float:
    return 1.0 / (1.0 - drop_threshold / 2.0 ** 32)


def attention_keep(b: int, h: int, t: int, seed: int, drop_threshold: int,
                   device) -> torch.Tensor:
    """(B, H, T, T) keep mask of the attention-probability dropout."""
    pos = torch.arange(t, device=device)
    cell = (seed + torch.arange(b * h, device=device).reshape(b, h)) & M32
    bits = hash_bits(pos[:, None], pos[None, :], cell[:, :, None, None])
    return bits >= drop_threshold


def rel_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_emb: torch.Tensor, max_dist: int,
                        valid_len: Optional[int] = None, seed: int = 0,
                        drop_threshold: int = 0) -> torch.Tensor:
    """The same function in plain PyTorch, computed in float32 and returned
    in the input dtype. Materializes the (B, H, T, T) scores."""
    b, h, t, dh = q.shape
    m = max_dist
    qf, kf, vf, ef = (x.float() for x in (q, k, v, rel_emb))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(dh))
    rel = torch.einsum("bhqd,hwd->bhqw", qf, ef)            # (B, H, T, 2m−1)
    pos = torch.arange(t, device=q.device)
    off = pos[None, :] - pos[:, None]                        # k − q
    idx = (off + m - 1).clamp(0, 2 * m - 2)
    s = s + rel.gather(-1, idx.expand(b, h, t, t))
    side = pos < (t if valid_len is None else valid_len)
    visible = (off.abs() <= m - 1) & (side[None, :] == side[:, None])
    s = s.masked_fill(~visible, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if drop_threshold:
        keep = attention_keep(b, h, t, seed, drop_threshold, q.device)
        p = torch.where(keep, p * _keep_scale(drop_threshold), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def _check(q, k, v, rel_emb, max_dist, valid_len, seed,
           drop_threshold) -> int:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, d_head), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _, h, t, dh = q.shape
    if max_dist < 1 or rel_emb.shape != (h, 2 * max_dist - 1, dh):
        raise ValueError(f"rel_emb must be (H, 2*max_dist-1, d_head) = "
                         f"{(h, 2 * max_dist - 1, dh)}, got "
                         f"{tuple(rel_emb.shape)}")
    for x in (k, v, rel_emb):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("q, k, v and rel_emb must share dtype and "
                             "device")
    valid_len = t if valid_len is None else int(valid_len)
    if not 0 <= valid_len <= t:
        raise ValueError(f"valid_len {valid_len} outside [0, {t}]")
    if not 0 <= seed <= M32 or not 0 <= drop_threshold <= M32:
        raise ValueError(f"seed {seed} and drop_threshold {drop_threshold} "
                         f"must be uint32 values")
    return valid_len


def _check_kernel_input(tensors, dtype) -> None:
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bfloat16 or float32, not "
                         f"{dtype}")
    dh = tensors["q"].shape[-1]
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"the kernel takes d_head in 16..128, a multiple "
                         f"of 16; got {dh}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_launch_error(name, lib, err, smem_bytes) -> None:
    raise RuntimeError(
        f"{name} launch failed: "
        f"{lib.rel_attention_error_string(err).decode()} (cudaError {err}; "
        f"shared memory per CTA {smem_bytes} bytes)")


def _launch_fwd(q, k, v, rel_emb, max_dist, valid_len, seed,
                drop_threshold) -> torch.Tensor:
    _check_kernel_input({"q": q, "k": k, "v": v, "rel_emb": rel_emb},
                        q.dtype)
    b, h, t, dh = q.shape
    lib = _library("rel_attention_fwd")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rel_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_emb.data_ptr(),
            out.data_ptr(), b, h, t, dh, max_dist, valid_len,
            1.0 / math.sqrt(dh), seed, drop_threshold,
            _keep_scale(drop_threshold), int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        _raise_launch_error("rel_attention_fwd", lib, err,
                            lib.rel_attention_fwd_smem_bytes(dh, max_dist))
    rel_attention.launches += 1
    return out


def rel_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      rel_emb: torch.Tensor, dout: torch.Tensor,
                      max_dist: int, valid_len: Optional[int] = None,
                      seed: int = 0, drop_threshold: int = 0):
    """Gradients (dQ, dK, dV, dE) of ``rel_attention``'s output against
    ``dout``, from ``csrc/rel_attention_bwd.cu`` (CUDA tensors only). dQ,
    dK and dV come back in the input dtype, dE in ``rel_emb``'s; dK, dV
    and dE (summed over the batch) accumulate in float32 with atomics."""
    valid_len = _check(q, k, v, rel_emb, max_dist, valid_len, seed,
                       drop_threshold)
    if q.device.type != "cuda":
        raise ValueError(f"rel_attention_bwd runs on CUDA tensors, not "
                         f"{q.device}")
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError("dout must match q in shape, dtype and device")
    _check_kernel_input({"q": q, "k": k, "v": v, "rel_emb": rel_emb,
                         "dout": dout}, q.dtype)
    b, h, t, dh = q.shape
    lib = _library("rel_attention_bwd")
    dq = torch.empty_like(q)
    dk32, dv32 = (torch.zeros(q.shape, dtype=torch.float32, device=q.device)
                  for _ in range(2))
    de32 = torch.zeros(rel_emb.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rel_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_emb.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk32.data_ptr(),
            dv32.data_ptr(), de32.data_ptr(), b, h, t, dh, max_dist,
            valid_len, 1.0 / math.sqrt(dh), seed, drop_threshold,
            _keep_scale(drop_threshold), int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        _raise_launch_error("rel_attention_bwd", lib, err,
                            lib.rel_attention_bwd_smem_bytes(dh, max_dist))
    rel_attention_bwd.launches += 1
    return dq, dk32.to(q.dtype), dv32.to(q.dtype), de32.to(rel_emb.dtype)


rel_attention_bwd.launches = 0  # kernel launches since the last reset


class _RelAttention(torch.autograd.Function):
    """Forward K1f, backward K1b; saves the inputs and the seed, never P."""

    @staticmethod
    def forward(ctx, q, k, v, rel_emb, max_dist, valid_len, seed,
                drop_threshold):
        ctx.save_for_backward(q, k, v, rel_emb)
        ctx.args = (max_dist, valid_len, seed, drop_threshold)
        return _launch_fwd(q, k, v, rel_emb, max_dist, valid_len, seed,
                           drop_threshold)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_emb = ctx.saved_tensors
        grads = rel_attention_bwd(q, k, v, rel_emb, dout.contiguous(),
                                  *ctx.args)
        return (*grads, None, None, None, None)


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rel_emb: torch.Tensor, max_dist: int,
                  valid_len: Optional[int] = None, seed: int = 0,
                  drop_threshold: int = 0) -> torch.Tensor:
    """Relative-position attention, differentiable. q, k, v: (B, H, T,
    d_head); rel_emb: (H, 2·max_dist−1, d_head); ``valid_len`` L (default
    T) splits each sequence into the utterance and its padding, which do
    not see each other; ``seed`` and the uint32 ``drop_threshold`` set the
    probability dropout (0 = off). Returns (B, H, T, d_head) in the input
    dtype."""
    valid_len = _check(q, k, v, rel_emb, max_dist, valid_len, seed,
                       drop_threshold)
    if q.device.type == "cpu":
        return rel_attention_plain(q, k, v, rel_emb, max_dist, valid_len,
                                   seed, drop_threshold)
    if q.device.type != "cuda":
        raise ValueError(f"no rel_attention for device {q.device}")
    return _RelAttention.apply(q, k, v, rel_emb, max_dist, valid_len, seed,
                               drop_threshold)


rel_attention.launches = 0  # forward kernel launches since the last reset


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    f32 = ctypes.c_float
    if name == "rel_attention_fwd":
        lib.rel_attention_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32,
            u32, u32, f32, i32, ptr]
        lib.rel_attention_fwd.restype = i32
    else:
        lib.rel_attention_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
            i32, i32, i32, f32, u32, u32, f32, i32, ptr]
        lib.rel_attention_bwd.restype = i32
    getattr(lib, f"{name}_smem_bytes").argtypes = [i32, i32]
    getattr(lib, f"{name}_smem_bytes").restype = i32
    lib.rel_attention_error_string.argtypes = [i32]
    lib.rel_attention_error_string.restype = ctypes.c_char_p
    return lib
