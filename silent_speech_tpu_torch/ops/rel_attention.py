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
JAX kernel in interpret mode draw the same mask. A call on a shard of the
batch's rows or heads (``parallel/``) names the shard's place in the
whole: ``b_offset``, ``h_offset`` and ``h_total`` make the cell ``seed +
(b_offset + b)·h_total + h_offset + h``, so the shard draws its slice of
the unsharded mask; the defaults (0, 0, H) are the unsharded call.

``rel_attention`` launches, for CUDA tensors, one forward kernel (K1f)
inside an autograd function whose backward (K1b) recomputes P, so nothing
quadratic is saved between the two. bfloat16 runs on the tensor cores:
the forward is ``csrc/rel_attention_fwd_wmma.cu`` (one WMMA kernel that
rounds P' to bf16 before ·V, where the JAX kernel rounds it), the backward
the four staged WMMA kernels of ``csrc/rel_attention_bwd_wmma.cu``.
float32, the route that ``--compute_dtype float32`` trains on, keeps full
f32 arithmetic on the CUDA cores with register-tiled FP32 products on the
band machinery of ``csrc/f32_band.cuh``: the forward is
``csrc/rel_attention_fwd.cu`` (one kernel; raises ``ValueError`` only where
a CTA's shared memory, which grows with the window past m = 105, exceeds
the card's), the backward the same four stages in
``csrc/rel_attention_bwd.cu`` with f32 scratch. Every route is bit-equal
from call to call. CPU tensors take ``rel_attention_plain``,
differentiated by autograd; nothing else selects the plain version, and a
CUDA launch that fails raises.
``rel_attention_plain(store_dtype=torch.bfloat16)`` mirrors the bf16
forward's rounding and ``rel_attention_bwd_staged_plain`` the staged
backward's arithmetic (either route's), for the tests. What bounds each
kernel on the card is in its source's header.
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
                   device, b_offset: int = 0, h_offset: int = 0,
                   h_total: Optional[int] = None) -> torch.Tensor:
    """(B, H, T, T) keep mask of the attention-probability dropout, for
    rows ``b_offset``.. and heads ``h_offset``.. of a batch with
    ``h_total`` heads (default H)."""
    h_total = h if h_total is None else h_total
    pos = torch.arange(t, device=device)
    rows = torch.arange(b_offset, b_offset + b, device=device)
    heads = torch.arange(h_offset, h_offset + h, device=device)
    cell = (seed + rows[:, None] * h_total + heads[None, :]) & M32
    bits = hash_bits(pos[:, None], pos[None, :], cell[:, :, None, None])
    return bits >= drop_threshold


def _probs(q, k, rel_emb, max_dist, valid_len, seed, drop_threshold,
           cells=(0, 0, None)):
    """P (the softmax of the masked scores) and P' (after the dropout), in
    float32, (B, H, T, T); ``cells`` is (b_offset, h_offset, h_total)."""
    b, h, t, dh = q.shape
    m = max_dist
    qf, kf, ef = (x.float() for x in (q, k, rel_emb))
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
    if not drop_threshold:
        return p, p
    keep = attention_keep(b, h, t, seed, drop_threshold, q.device, *cells)
    return p, torch.where(keep, p * _keep_scale(drop_threshold), 0.0)


def rel_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rel_emb: torch.Tensor, max_dist: int,
                        valid_len: Optional[int] = None, seed: int = 0,
                        drop_threshold: int = 0,
                        store_dtype: Optional[torch.dtype] = None,
                        b_offset: int = 0, h_offset: int = 0,
                        h_total: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch, computed in float32 and returned
    in the input dtype. Materializes the (B, H, T, T) scores. With
    ``store_dtype``, P' is rounded to it before ·V, as the bf16 kernel
    (``csrc/rel_attention_fwd_wmma.cu``) and the JAX kernel round it."""
    _, p = _probs(q, k, rel_emb, max_dist, valid_len, seed, drop_threshold,
                  (b_offset, h_offset, h_total))
    if store_dtype is not None:
        p = p.to(store_dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def unskew(ds: torch.Tensor, max_dist: int) -> torch.Tensor:
    """dR[..., q, r] = dS[..., q, q + r − (m−1)], 0 where that key lies
    outside [0, T): (..., T, T) → (..., T, 2m−1)."""
    t = ds.shape[-1]
    pos = torch.arange(t, device=ds.device)
    key = pos[:, None] + torch.arange(2 * max_dist - 1,
                                      device=ds.device)[None, :] \
        - (max_dist - 1)
    inside = (key >= 0) & (key < t)
    dr = ds.gather(-1, key.clamp(0, t - 1).expand(*ds.shape[:-1], -1))
    return torch.where(inside, dr, 0.0)


def rel_attention_bwd_staged_plain(q, k, v, rel_emb, dout, max_dist: int,
                                   valid_len: Optional[int] = None,
                                   seed: int = 0, drop_threshold: int = 0,
                                   store_dtype: Optional[torch.dtype] = None,
                                   return_scratch: bool = False,
                                   b_offset: int = 0, h_offset: int = 0,
                                   h_total: Optional[int] = None):
    """The backward's four stages (``csrc/rel_attention_bwd_wmma.cu`` in
    bf16, ``csrc/rel_attention_bwd.cu`` in f32) in plain PyTorch, computed
    in float32: stage A's P', dS and dR, then dK, dV (B), dQ (C) and dE (D)
    from them. With ``store_dtype``, P', dS and dR are rounded to it where
    the bf16 kernel stores them (None: the f32 kernel's f32 scratch).
    Returns (dQ, dK, dV, dE) in the input dtypes and, with
    ``return_scratch``, also (P', dS, dR) in float32, unpadded."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, ef, gf = (x.float() for x in (q, k, v, rel_emb, dout))
    p, pp = _probs(q, k, rel_emb, max_dist, valid_len, seed, drop_threshold,
                   (b_offset, h_offset, h_total))
    prod = pp * torch.einsum("bhqd,bhkd->bhqk", gf, vf)     # P' ⊙ dP
    ds = prod - p * prod.sum(-1, keepdim=True)
    if store_dtype is not None:
        pp, ds = (x.to(store_dtype).float() for x in (pp, ds))
    dr = unskew(ds, max_dist)
    dq = (torch.einsum("bhqr,hrd->bhqd", dr, ef)
          + scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf))
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", pp, gf)
    de = torch.einsum("bhqr,bhqd->hrd", dr, qf)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
             de.to(rel_emb.dtype))
    return (grads, (pp, ds, dr)) if return_scratch else grads


def _check(q, k, v, rel_emb, max_dist, valid_len, seed, drop_threshold,
           b_offset=0, h_offset=0, h_total=None):
    """The checked (valid_len, (b_offset, h_offset, h_total)) of a call."""
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
    b = q.shape[0]
    h_total = h if h_total is None else int(h_total)
    if (b_offset < 0 or h_offset < 0 or h_offset + h > h_total
            or (b_offset + b) * h_total > 2 ** 31 - 1):
        raise ValueError(f"rows {b_offset}+{b} and heads {h_offset}+{h} "
                         f"do not fit in a batch of {h_total} heads")
    return valid_len, (int(b_offset), int(h_offset), h_total)


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


# stage A of the f32 backward: a 32-query tile's key band and the slots it
# reaches fit 256 columns (``too_wide`` in ``csrc/rel_attention_bwd.cu``)
F32_BWD_COLS = 256


def f32_bwd_fits(t: int, max_dist: int) -> bool:
    """Whether the f32 backward takes sequences of ``t`` frames at window
    ``max_dist`` (every m <= 105 at any T, and every m at T <= 225)."""
    band = min(_round16(t), _round16(32 + 2 * (max_dist - 1) + 15))
    return (band <= F32_BWD_COLS
            and min(2 * max_dist - 1, t + 31) <= F32_BWD_COLS)


# the H100's shared memory for one CTA, where the device properties do not
# give it
SMEM_PER_BLOCK_OPTIN = 232448


def _raise_launch_error(name, lib, err, smem_bytes) -> None:
    raise RuntimeError(
        f"{name} launch failed: "
        f"{lib.rel_attention_error_string(err).decode()} (cudaError {err}; "
        f"shared memory per CTA {smem_bytes} bytes)")


def _launch_fwd(q, k, v, rel_emb, max_dist, valid_len, seed,
                drop_threshold, cells) -> torch.Tensor:
    """One forward launch: bf16 on the WMMA kernel, f32 on the f32 one."""
    _check_kernel_input({"q": q, "k": k, "v": v, "rel_emb": rel_emb},
                        q.dtype)
    b, h, t, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    name = "rel_attention_fwd_wmma" if bf16 else "rel_attention_fwd"
    lib = _library(name)
    if not bf16:   # its score buffer grows with the window past m = 105
        need = lib.rel_attention_fwd_smem_bytes(t, dh, max_dist)
        limit = getattr(torch.cuda.get_device_properties(q.device),
                        "shared_memory_per_block_optin", SMEM_PER_BLOCK_OPTIN)
        if need > limit:
            raise ValueError(
                f"the f32 forward's CTA needs {need} bytes of shared memory "
                f"at T={t}, max_dist={max_dist}; the card gives {limit}")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_emb.data_ptr(),
            out.data_ptr(), b, h, t, dh, max_dist, valid_len,
            1.0 / math.sqrt(dh), seed, drop_threshold,
            _keep_scale(drop_threshold), *cells)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if bf16:
            err = lib.rel_attention_fwd_wmma(*args, stream)
        else:
            err = lib.rel_attention_fwd(*args, 0, stream)
    if err != 0:
        smem = getattr(lib, f"{name}_smem_bytes")(t, dh, max_dist)
        _raise_launch_error(name, lib, err, smem)
    rel_attention.launches += 1
    if not bf16:
        rel_attention.f32_launches += 1
    return out


def rel_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      rel_emb: torch.Tensor, dout: torch.Tensor,
                      max_dist: int, valid_len: Optional[int] = None,
                      seed: int = 0, drop_threshold: int = 0,
                      b_offset: int = 0, h_offset: int = 0,
                      h_total: Optional[int] = None):
    """Gradients (dQ, dK, dV, dE) of ``rel_attention``'s output against
    ``dout`` (CUDA tensors only), in the input dtype.

    Both dtypes run four staged kernels (``_staged_bwd``) with scratch in
    the input dtype and no atomics: bfloat16 on the tensor cores
    (``csrc/rel_attention_bwd_wmma.cu``), float32 on the CUDA cores with
    register-tiled FP32 products (``csrc/rel_attention_bwd.cu``; raises
    ``ValueError`` where ``f32_bwd_fits`` is False). Both routes are
    bit-equal from call to call. A launch that fails raises."""
    valid_len, cells = _check(q, k, v, rel_emb, max_dist, valid_len, seed,
                              drop_threshold, b_offset, h_offset, h_total)
    if q.device.type != "cuda":
        raise ValueError(f"rel_attention_bwd runs on CUDA tensors, not "
                         f"{q.device}")
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError("dout must match q in shape, dtype and device")
    _check_kernel_input({"q": q, "k": k, "v": v, "rel_emb": rel_emb,
                         "dout": dout}, q.dtype)
    f32 = q.dtype == torch.float32
    if f32 and not f32_bwd_fits(q.shape[2], max_dist):
        raise ValueError(f"the f32 backward takes a 32-query tile's band and "
                         f"slots in {F32_BWD_COLS} columns: T={q.shape[2]}, "
                         f"max_dist={max_dist} exceed them")
    grads, stages, _ = _staged_bwd(q, k, v, rel_emb, dout, max_dist,
                                   valid_len, seed, drop_threshold, cells)
    for _, launch in stages:
        launch()
    rel_attention_bwd.launches += 1
    if f32:
        rel_attention_bwd.f32_launches += 1
    return grads


rel_attention_bwd.launches = 0  # backward calls since the last reset
rel_attention_bwd.f32_launches = 0  # of them, on the f32 route

STAGES = ("scores", "dkdv", "dq", "de")   # the backward's stages A-D


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _staged_bwd(q, k, v, rel_emb, dout, max_dist, valid_len, seed,
                drop_threshold, cells=(0, 0, None), lib=None):
    """Outputs, scratch and the stage launches of the backward, not yet
    launched: ``(grads, [(stage name, launch), ...], (P', dS, dR))``, on
    ``csrc/rel_attention_bwd_wmma.cu`` for bf16 and
    ``csrc/rel_attention_bwd.cu`` for f32 (``lib``: another build of that
    source, bound by ``_bind``). Each launch runs on the current stream and
    raises if its C function returns an error. The scratch, in the input
    dtype, is padded to Tp = T and Wp = 2m−1 rounded up to 16; dE's
    partials take one group of batch rows per slice of CTAs that fills the
    card about twice at three CTAs per SM (bf16: 64-slot tiles), or four
    times at two (f32: 128-slot tiles, a shorter tail)."""
    b, h, t, dh = q.shape
    if cells[2] is None:
        cells = (cells[0], cells[1], h)
    tp, wp = _round16(t), _round16(2 * max_dist - 1)
    bf16 = q.dtype == torch.bfloat16
    slot_tile, ctas = (64, 6) if bf16 else (128, 8)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    groups = min(b, -(-ctas * sms // (h * -(-wp // slot_tile))))
    groups = -(-b // -(-b // groups))     # no empty group
    lib_name = "rel_attention_bwd_wmma" if bf16 else "rel_attention_bwd"
    lib = lib or _library(lib_name)
    dq, dk, dv, de = (torch.empty_like(x) for x in (q, k, v, rel_emb))
    pp, ds = (torch.empty((b, h, tp, tp), dtype=q.dtype, device=q.device)
              for _ in range(2))
    dr = torch.empty((b, h, tp, wp), dtype=q.dtype, device=q.device)
    part = torch.empty((groups, h, wp, dh), dtype=torch.float32,
                       device=q.device)
    scale = 1.0 / math.sqrt(dh)
    dims = (b, h, t, dh, max_dist)
    # the tensors themselves, so that each stays alive while a launch uses it
    args = {
        "scores": (q, k, v, rel_emb, dout, pp, ds, dr, *dims, valid_len,
                   scale, seed, drop_threshold, _keep_scale(drop_threshold),
                   *cells, *(() if bf16 else (0,))),    # f32: is_bf16 = 0
        "dkdv": (q, dout, pp, ds, dk, dv, *dims, scale),
        "dq": (k, rel_emb, ds, dr, dq, *dims, scale),
        "de": (q, dr, part, de, *dims, groups),
    }

    def launcher(i, name):
        fn = getattr(lib, f"{lib_name}_{name}")

        def launch():
            with torch.cuda.device(q.device):
                stream = torch.cuda.current_stream(q.device).cuda_stream
                err = fn(*(x.data_ptr() if isinstance(x, torch.Tensor)
                           else x for x in args[name]), stream)
            if err != 0:
                smem = getattr(lib, f"{lib_name}_smem_bytes")
                _raise_launch_error(f"rel_attention_bwd stage {name}", lib,
                                    err, smem(i, t, dh, max_dist))
        return launch

    return ((dq, dk, dv, de),
            [(name, launcher(i, name)) for i, name in enumerate(STAGES)],
            (pp, ds, dr))


class _RelAttention(torch.autograd.Function):
    """Forward K1f, backward K1b; saves the inputs and the seed, never P."""

    @staticmethod
    def forward(ctx, q, k, v, rel_emb, max_dist, valid_len, seed,
                drop_threshold, cells):
        ctx.save_for_backward(q, k, v, rel_emb)
        ctx.args = (max_dist, valid_len, seed, drop_threshold, *cells)
        return _launch_fwd(q, k, v, rel_emb, max_dist, valid_len, seed,
                           drop_threshold, cells)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_emb = ctx.saved_tensors
        grads = rel_attention_bwd(q, k, v, rel_emb, dout.contiguous(),
                                  *ctx.args)
        return (*grads, None, None, None, None, None)


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rel_emb: torch.Tensor, max_dist: int,
                  valid_len: Optional[int] = None, seed: int = 0,
                  drop_threshold: int = 0, b_offset: int = 0,
                  h_offset: int = 0, h_total: Optional[int] = None
                  ) -> torch.Tensor:
    """Relative-position attention, differentiable. q, k, v: (B, H, T,
    d_head); rel_emb: (H, 2·max_dist−1, d_head); ``valid_len`` L (default
    T) splits each sequence into the utterance and its padding, which do
    not see each other; ``seed`` and the uint32 ``drop_threshold`` set the
    probability dropout (0 = off); ``b_offset``, ``h_offset`` and
    ``h_total`` place a shard's rows and heads in the whole batch's
    dropout cells. Returns (B, H, T, d_head) in the input dtype."""
    valid_len, cells = _check(q, k, v, rel_emb, max_dist, valid_len, seed,
                              drop_threshold, b_offset, h_offset, h_total)
    if q.device.type == "cpu":
        return rel_attention_plain(q, k, v, rel_emb, max_dist, valid_len,
                                   seed, drop_threshold, None, *cells)
    if q.device.type != "cuda":
        raise ValueError(f"no rel_attention for device {q.device}")
    return _RelAttention.apply(q, k, v, rel_emb, max_dist, valid_len, seed,
                               drop_threshold, cells)


rel_attention.launches = 0  # forward kernel launches since the last reset
rel_attention.f32_launches = 0  # of them, on the f32 route


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    return _bind(build.load(name), name)


def _bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of the C entries of a build of
    ``csrc/<name>.cu``."""
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    f32 = ctypes.c_float
    dims = [i32] * 5                                      # B, H, T, dh, m
    # valid_len, scale, seed, t, 1/keep, b_offset, h_offset, H_total
    drop = [i32, f32, u32, u32, f32, i32, i32, i32]
    if name in ("rel_attention_fwd", "rel_attention_fwd_wmma"):
        # the f32 entry takes is_bf16; both smem functions (T, dh, m)
        f32_flag = [i32] if name == "rel_attention_fwd" else []
        argtypes = {name: [ptr] * 5 + dims + drop + f32_flag + [ptr]}
        smem_args = [i32, i32, i32]
    else:   # the backward's stages; the f32 scores entry takes is_bf16
        f32_flag = [i32] if name == "rel_attention_bwd" else []
        argtypes = {f"{name}_scores": [ptr] * 8 + dims + drop + f32_flag
                    + [ptr],
                    f"{name}_dkdv": [ptr] * 6 + dims + [f32, ptr],
                    f"{name}_dq": [ptr] * 5 + dims + [f32, ptr],
                    f"{name}_de": [ptr] * 4 + dims + [i32, ptr]}
        smem_args = [i32, i32, i32, i32]
    for fn, types in argtypes.items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = i32
    getattr(lib, f"{name}_smem_bytes").argtypes = smem_args
    getattr(lib, f"{name}_smem_bytes").restype = i32
    lib.rel_attention_error_string.argtypes = [i32]
    lib.rel_attention_error_string.restype = ctypes.c_char_p
    return lib
