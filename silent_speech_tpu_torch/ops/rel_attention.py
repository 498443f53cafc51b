"""Relative-position attention forward: CUDA kernel and its plain version.

Counterpart of the forward of ``fused_rel_attention`` in the JAX package
(``silent_speech_tpu/ops/pallas/rel_attention.py``, ``_fwd`` →
``pl.pallas_call``, body ``_fwd_kernel``), with dropout off, plus the
utterance-length mask that the JAX serving forward applies through segment
ids. For query q and key k of one (batch, head)::

    s[q, k] = (q·k)/√d_h + q·E_h[k − q + m − 1]
              if |k − q| ≤ m − 1 and (k < L) == (q < L), else −1e8
    O = softmax(s) · V

``rel_attention`` launches ``csrc/rel_attention_fwd.cu`` for CUDA tensors
and runs ``rel_attention_plain`` for CPU tensors; nothing else selects the
plain version. On the card the function is bound by bytes (Q, K, V read
and O written once; ~2 µs at T=1024); the kernel's design and what bounds
it instead are in the source's header.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e8  # the reference's out-of-window logit


def rel_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_emb: torch.Tensor, max_dist: int,
                        valid_len: Optional[int] = None) -> torch.Tensor:
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
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def _check(q, k, v, rel_emb, max_dist, valid_len) -> int:
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
    return valid_len


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rel_emb: torch.Tensor, max_dist: int,
                  valid_len: Optional[int] = None) -> torch.Tensor:
    """Relative-position attention forward. q, k, v: (B, H, T, d_head);
    rel_emb: (H, 2·max_dist−1, d_head); ``valid_len`` L (default T) splits
    each sequence into the utterance and its padding, which do not see
    each other. Returns (B, H, T, d_head) in the input dtype."""
    valid_len = _check(q, k, v, rel_emb, max_dist, valid_len)
    if q.device.type == "cpu":
        return rel_attention_plain(q, k, v, rel_emb, max_dist, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"no rel_attention for device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bfloat16 or float32, not "
                         f"{q.dtype}")
    b, h, t, dh = q.shape
    if dh % 16 or not 16 <= dh <= 128:
        raise ValueError(f"the kernel takes d_head in 16..128, a multiple "
                         f"of 16; got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v), ("rel_emb", rel_emb)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rel_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_emb.data_ptr(),
            out.data_ptr(), b, h, t, dh, max_dist, valid_len,
            1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            "rel_attention_fwd launch failed: "
            f"{lib.rel_attention_error_string(err).decode()} (cudaError "
            f"{err}; shared memory per CTA "
            f"{lib.rel_attention_fwd_smem_bytes(dh, max_dist)} bytes)")
    rel_attention.launches += 1
    return out


rel_attention.launches = 0  # kernel launches since the last reset


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("rel_attention_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rel_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, i32, ptr]
    lib.rel_attention_fwd.restype = i32
    lib.rel_attention_error_string.argtypes = [i32]
    lib.rel_attention_error_string.restype = ctypes.c_char_p
    lib.rel_attention_fwd_smem_bytes.argtypes = [i32, i32]
    lib.rel_attention_fwd_smem_bytes.restype = i32
    return lib
