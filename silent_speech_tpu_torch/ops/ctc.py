"""CTC negative log-likelihood on optax's clamped lattice: CUDA kernel,
plain version and a plain mirror of the kernel's backward.

The JAX package computes its recognition loss with ``optax.ctc_loss``
(``silent_speech_tpu/train/losses.py:210-238``; optax 0.2.6,
``optax/losses/_classification.py:629``), under XLA and not as a Pallas
kernel. Its lattice differs from textbook CTC, and this module follows it
step for step. For one utterance with labels ``l`` (the padded row,
``max(text_int, 0)``: padding is label 0), ``L`` real labels and ``T``
frames of log-probs ``lp``:

- a blank state ``phi[0..N]`` and a label state ``emit[0..N-1]``, N the
  padded row's width; ``phi[0] = 0``, every other entry ``ε = -1e5`` (its
  log-epsilon, used in place of log 0);
- ``repeat[n] = l[n] == l[n+1]`` over the padded row (``repeat[N-1] = 0``),
  so a last real label of 0 is a repeat of the padding;
- each frame ``t < utt_len``::

      A[0] = phi[0];  A[n+1] = lae(phi[n+1], emit[n] + ε·repeat[n])
      emit'[n] = lae(A[n] + lp[t, l[n]], emit[n] + lp[t, l[n]])
      phi'[0] = A[0] + lp[t, blank]
      phi'[n+1] = lae(A[n+1] + lp[t, blank],
                      emit[n] + lp[t, blank] + ε·(1 - repeat[n]))

  (``lae`` is ``jnp.logaddexp``: ``max + log1p(exp(-|a - b|))``); frames
  at or past ``utt_len`` leave the state as it is;
- then one last ``phi[n+1] = lae(phi[n+1], emit[n])`` with no penalty, and
  the loss ``-phi[L]``.

An infeasible target (more labels than the frames can emit) is therefore
finite, ~1e5, where textbook CTC gives ``inf``. A row with frames and no
labels has the NLL ``−Σ_t lp[t, blank]`` (only ``phi[0]`` is read), and
its gradient is −1 at each live frame's blank, on every route. The gradient is JAX's
autodiff through that lattice: each ``lae``'s cotangents are
``g · exp(x - out)`` (``jax._src.lax.other._logaddexp_jvp``), which
``_LogAddExp`` copies, so that at the ~1e5 scale of an infeasible loss
the rounding of ``out`` enters the gradient as it does in JAX.

``ctc_nll`` launches ``csrc/ctc.cu`` for CUDA tensors: a forward kernel
(one CTA per utterance, one thread per label position, the row's
log-probs staged in shared memory a chunk of frames ahead, the per-frame
states kept in global memory) and a backward that runs the same reverse
recursion as autodiff (cotangents, not log-betas; each chunk's step
coefficients computed in parallel first) and then sums the per-position
occupancies into ``grad[u, t, k]`` in ascending position order, without
atomics, so two calls are bit-equal. CPU tensors take
``ctc_nll_plain`` (the lattice above as a loop over frames, vectorized
over utterances and positions; its gradient from autograd), the oracle of
the tests. ``ctc_grad_plain`` mirrors the kernel's explicit backward in
PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

LOG_EPSILON = -1e5
# label positions the kernel takes: one thread each, plus phi[N], in one CTA
MAX_LABELS = 1023


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` for finite inputs, with JAX's cotangents."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_lae = _LogAddExp.apply


def _penalties(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ε·repeat`` and ``ε·(1 - repeat)`` of each position, (U, S)."""
    rep = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    rep[:, :-1] = labels[:, :-1] == labels[:, 1:]
    return (torch.where(rep, LOG_EPSILON, 0.0),
            torch.where(rep, 0.0, LOG_EPSILON))


def _inputs(lp, utt_len, labels, text_len, dtype=torch.long):
    """The integer inputs as ``dtype`` (int64 for the plain version, int32
    for the kernels), contiguous: frame and label counts clamped to [0, T]
    and [0, S], padding labels (−1) to 0."""
    _, t, _ = lp.shape
    s = labels.shape[1]
    return (utt_len.to(dtype).clamp(0, t).contiguous(),
            labels.to(dtype).clamp_min(0).contiguous(),
            text_len.to(dtype).clamp(0, s).contiguous())


def _states(lp, utt_len, labels, blank, keep: bool):
    """The scan over frames: the final (phi, emit) and, with ``keep``, the
    state before each frame and the last, (U, T' + 1, S + 1) and
    (U, T' + 1, S), T' the longest utterance."""
    u, _, _ = lp.shape
    s = labels.shape[1]
    pen_rep, pen_norep = _penalties(labels)
    lp_emit = lp.gather(2, labels[:, None, :].expand(u, lp.shape[1], s))
    lp_phi = lp[..., blank:blank + 1]                     # (U, T, 1)
    phi = torch.full((u, s + 1), LOG_EPSILON, dtype=lp.dtype,
                     device=lp.device)
    phi[:, 0] = 0.0
    emit = torch.full((u, s), LOG_EPSILON, dtype=lp.dtype, device=lp.device)
    hist = [(phi, emit)] if keep else None
    t_run = int(utt_len.max()) if u else 0
    for t in range(t_run):
        le, lb = lp_emit[:, t], lp_phi[:, t]
        a = torch.cat([phi[:, :1], _lae(phi[:, 1:], emit + pen_rep)], 1)
        next_emit = _lae(a[:, :-1] + le, emit + le)
        next_phi = a + lb
        next_phi = torch.cat([next_phi[:, :1], _lae(
            next_phi[:, 1:], emit + lb + pen_norep)], 1)
        pad = (t >= utt_len)[:, None]
        emit = torch.where(pad, emit, next_emit)
        phi = torch.where(pad, phi, next_phi)
        if keep:
            hist.append((phi, emit))
    if keep:
        return (torch.stack([h[0] for h in hist], 1),
                torch.stack([h[1] for h in hist], 1))
    return phi, emit


def ctc_nll_plain(lp: torch.Tensor, utt_len: torch.Tensor,
                  labels: torch.Tensor, text_len: torch.Tensor,
                  blank: int) -> torch.Tensor:
    """(U, T, K) float32 log-probs, (U,) frame counts, (U, S) labels (−1
    or any value past ``text_len`` is padding) and (U,) label counts →
    (U,) float32 NLL, optax's lattice step for step (module docstring)."""
    utt_len, labels, text_len = _inputs(lp, utt_len, labels, text_len)
    phi, emit = _states(lp, utt_len, labels, blank, keep=False)
    last = torch.cat([phi[:, :1], _lae(phi[:, 1:], emit)], 1)
    return -last.gather(1, text_len[:, None])[:, 0]


@torch.no_grad()
def ctc_grad_plain(lp: torch.Tensor, utt_len: torch.Tensor,
                   labels: torch.Tensor, text_len: torch.Tensor, blank: int
                   ) -> torch.Tensor:
    """d NLL / d lp, (U, T, K), by the kernel's explicit backward: the
    reverse of each frame's step on the cotangents of (phi, emit), from
    the stored per-frame states, then each position's occupancy summed
    into its label's column (the blank's from every position). Frames
    past ``utt_len`` are exactly 0; a row without labels, whose NLL is
    −Σ_t lp[t, blank], gets −1 at each live frame's blank (its cotangent
    stays at position 0, whose occupancy is the blank's), as ``jax.grad``
    of optax's loss gives it."""
    utt_len, labels, text_len = _inputs(lp, utt_len, labels, text_len)
    u, t_max, _ = lp.shape
    s = labels.shape[1]
    pen_rep, pen_norep = _penalties(labels)
    h_phi, h_emit = _states(lp, utt_len, labels, blank, keep=True)
    t_run = h_phi.shape[1] - 1
    rows = torch.arange(u, device=lp.device)
    phi_t, emit_t = h_phi[rows, utt_len], h_emit[rows, utt_len]
    last = torch.cat([phi_t[:, :1], _lae(phi_t[:, 1:], emit_t)], 1)
    one = torch.nn.functional.one_hot(text_len, s + 1).to(lp.dtype)
    g_phi = torch.cat([one[:, :1], one[:, 1:] * torch.exp(
        phi_t[:, 1:] - last[:, 1:])], 1)
    g_emit = one[:, 1:] * torch.exp(emit_t - last[:, 1:])
    occ_emit = torch.zeros((u, t_max, s), dtype=lp.dtype, device=lp.device)
    occ_blank = torch.zeros((u, t_max, s + 1), dtype=lp.dtype,
                            device=lp.device)
    for t in range(t_run - 1, -1, -1):
        phi, emit = h_phi[:, t], h_emit[:, t]
        p_out, e_out = h_phi[:, t + 1], h_emit[:, t + 1]
        le = lp[rows[:, None], t, labels]
        lb = lp[:, t, blank:blank + 1]
        d = emit + pen_rep
        a = torch.cat([phi[:, :1], _lae(phi[:, 1:], d)], 1)
        b = a + lb
        c = emit + lb + pen_norep
        g_b = torch.cat([g_phi[:, :1], g_phi[:, 1:] * torch.exp(
            b[:, 1:] - p_out[:, 1:])], 1)
        g_c = g_phi[:, 1:] * torch.exp(c - p_out[:, 1:])
        g1 = g_emit * torch.exp(a[:, :-1] + le - e_out)
        g2 = g_emit * torch.exp(emit + le - e_out)
        g_a = g_b + torch.nn.functional.pad(g1, (0, 1))
        new_phi = torch.cat([g_a[:, :1], g_a[:, 1:] * torch.exp(
            phi[:, 1:] - a[:, 1:])], 1)
        new_emit = g2 + (g_c + g_a[:, 1:] * torch.exp(d - a[:, 1:]))
        live = (t < utt_len)[:, None]
        occ_emit[:, t] = torch.where(live, g1 + g2, 0.0)
        occ_blank[:, t] = torch.where(
            live, g_b + torch.nn.functional.pad(g_c, (1, 0)), 0.0)
        g_phi = torch.where(live, new_phi, g_phi)
        g_emit = torch.where(live, new_emit, g_emit)
    pos = torch.arange(s, device=lp.device)
    occ_emit = occ_emit * (pos < text_len[:, None])[:, None, :]
    grad = torch.zeros_like(lp)
    grad.scatter_add_(2, labels[:, None, :].expand(u, t_max, s), occ_emit)
    grad[..., blank] += occ_blank.sum(-1)
    return -grad


def _check(lp, utt_len, labels, text_len, blank):
    if lp.dim() != 3 or labels.dim() != 2:
        raise ValueError(f"lp must be (U, T, K) and labels (U, S), got "
                         f"{tuple(lp.shape)} and {tuple(labels.shape)}")
    u, _, k = lp.shape
    for name, x in (("utt_len", utt_len), ("text_len", text_len)):
        if x.shape != (u,):
            raise ValueError(f"{name} must be ({u},), got {tuple(x.shape)}")
    if labels.shape[0] != u:
        raise ValueError(f"labels must have {u} rows, got {labels.shape[0]}")
    if not 0 <= blank < k:
        raise ValueError(f"blank {blank} outside the {k} classes")
    for x in (utt_len, labels, text_len):
        if x.device != lp.device:
            raise ValueError(f"all inputs must be on {lp.device}, got "
                             f"{x.device}")


def _launch_fwd(lp, utt_len, labels, text_len, blank):
    u, t, k = lp.shape
    s = labels.shape[1]
    if lp.dtype != torch.float32 or not lp.is_contiguous():
        raise ValueError("the kernel takes contiguous float32 log-probs")
    if s > MAX_LABELS:
        raise ValueError(f"{s} label positions exceed the kernel's limit "
                         f"of {MAX_LABELS} (MAX_LABELS)")
    lib = _library()
    nll = torch.empty(u, dtype=torch.float32, device=lp.device)
    h_phi = torch.empty((u, t + 1, s + 1), dtype=torch.float32,
                        device=lp.device)
    h_emit = torch.empty_like(h_phi)
    with torch.cuda.device(lp.device):
        stream = torch.cuda.current_stream(lp.device).cuda_stream
        err = lib.ctc_forward(lp.data_ptr(), utt_len.data_ptr(),
                              labels.data_ptr(), text_len.data_ptr(),
                              nll.data_ptr(), h_phi.data_ptr(),
                              h_emit.data_ptr(), u, t, k, s, blank, stream)
    if err != 0:
        raise RuntimeError(f"ctc_forward launch failed: "
                           f"{lib.ctc_error_string(err).decode()} "
                           f"(cudaError {err})")
    ctc_nll.launches += 1
    return nll, h_phi, h_emit


def _launch_bwd(lp, utt_len, labels, text_len, blank, h_phi, h_emit,
                g_nll):
    u, t, k = lp.shape
    s = labels.shape[1]
    lib = _library()
    g_nll = g_nll.to(torch.float32).contiguous()
    occ_emit = torch.empty((u, t, s + 1), dtype=torch.float32,
                           device=lp.device)
    occ_blank = torch.empty_like(occ_emit)
    grad = torch.empty_like(lp)
    with torch.cuda.device(lp.device):
        stream = torch.cuda.current_stream(lp.device).cuda_stream
        err = lib.ctc_backward(lp.data_ptr(), utt_len.data_ptr(),
                               labels.data_ptr(), text_len.data_ptr(),
                               h_phi.data_ptr(), h_emit.data_ptr(),
                               g_nll.data_ptr(), occ_emit.data_ptr(),
                               occ_blank.data_ptr(), grad.data_ptr(), u, t,
                               k, s, blank, stream)
    if err != 0:
        raise RuntimeError(f"ctc_backward launch failed: "
                           f"{lib.ctc_error_string(err).decode()} "
                           f"(cudaError {err})")
    ctc_nll.backward_launches += 1
    return grad


class _CTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp, utt_len, labels, text_len, blank):
        nll, h_phi, h_emit = _launch_fwd(lp, utt_len, labels, text_len,
                                         blank)
        ctx.blank = blank
        ctx.save_for_backward(lp, utt_len, labels, text_len, h_phi, h_emit)
        return nll

    @staticmethod
    def backward(ctx, g_nll):
        lp, utt_len, labels, text_len, h_phi, h_emit = ctx.saved_tensors
        grad = _launch_bwd(lp, utt_len, labels, text_len, ctx.blank, h_phi,
                           h_emit, g_nll)
        return grad, None, None, None, None


def ctc_nll(lp: torch.Tensor, utt_len: torch.Tensor, labels: torch.Tensor,
            text_len: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-utterance CTC NLL on optax's lattice, (U,) float32, with its
    gradient with respect to ``lp`` through autograd.

    ``lp`` (U, T, K) are float32 log-probs; ``utt_len`` (U,) frame counts
    (clamped to [0, T]); ``labels`` (U, S) class ids, negative or past
    ``text_len`` for padding; ``text_len`` (U,) label counts (clamped to
    [0, S]). On a CUDA tensor the kernels run (at most ``MAX_LABELS``
    positions; a label outside [0, K) gives that row a NaN loss); CPU
    tensors take ``ctc_nll_plain``."""
    _check(lp, utt_len, labels, text_len, blank)
    if lp.device.type == "cpu":
        return ctc_nll_plain(lp, utt_len, labels, text_len, blank)
    if lp.device.type != "cuda":
        raise ValueError(f"no ctc_nll for device {lp.device}")
    return _CTC.apply(lp, *_inputs(lp, utt_len, labels, text_len,
                                    torch.int32), blank)


# kernel launches since the last reset: the forward and the backward
ctc_nll.launches = 0
ctc_nll.backward_launches = 0


def chunk_frames(k: int, s: int) -> Tuple[int, int]:
    """Frames a chunk of the forward and of the backward kernel at ``k``
    classes and ``s`` label positions, as the kernels choose them (needs
    the built kernel)."""
    lib = _library()
    return lib.ctc_chunk_frames(k, s, 0), lib.ctc_chunk_frames(k, s, 1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("ctc")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ctc_forward.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.ctc_forward.restype = i32
    lib.ctc_backward.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.ctc_backward.restype = i32
    lib.ctc_chunk_frames.argtypes = [i32] * 3
    lib.ctc_chunk_frames.restype = i32
    lib.ctc_error_string.argtypes = [i32]
    lib.ctc_error_string.restype = ctypes.c_char_p
    return lib
