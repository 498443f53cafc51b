"""The conv stack's BatchNorm: the training forward fused with its ReLU and
the ResBlock's residual add, and a backward that recomputes from the
compute-dtype conv outputs.

Counterpart of flax's ``nn.BatchNorm`` in ``silent_speech_tpu/models/
encoder.py`` (XLA fusions in the JAX package, not a Pallas kernel). In
training, on the batch's statistics: mean and E[x²] over (B, L) of
channels-first x, var = E[x²] − mean² clipped at 0 (the biased variance;
flax's), the running statistics moving as ``running = 0.9·running +
0.1·batch``; on a mesh the sums are synced over its data axis first, as
flax's ``pmean`` does. In eval, on the running statistics.

``batch_norm_plain`` is that composition in plain tensor code, in float32
(float64 stays float64), with autograd's backward: the path of CPU tensors
and of the eval forward everywhere. On a CUDA tensor the training forward
launches ``csrc/batchnorm.cu`` (no fallback):

- ``bn_relu(c, bn, ...)`` = relu(BN(c)): a statistics pass over c, a
  finalize launch (mean, rstd, scale = rstd·γ, shift = β − mean·scale, the
  running statistics), an apply pass writing relu(c·scale + shift);
- ``bn_add_relu(c, bn, res, res_bn, ...)`` = relu(BN(c) + BN'(res)) at a
  ResBlock's end, one statistics pass and one apply over both conv
  outputs; relu(BN(c) + res) where the block has no residual path.

The output is stored in the compute dtype, which is what each consumer
reads (the next conv and ``w_raw_in`` cast to it), or in float32 where a
model all-gather follows (a mesh), so that the gather's backward sums
float32 partial gradients as before. A block's output feeds the next
block's conv1 and residual path: it goes out as two handles on one tensor
(``forks=2``), whose two gradients the backward adds in float32, as
autograd added them on the float32 output (one bf16 output would sum them
in bf16). Saved for the backward: the conv outputs as they are and five
floats a channel (mean, rstd, scale, shift, and whether E[x²] − mean² was
≥ 0). The backward recomputes x̂ and the ReLU mask, reduces Σg and Σg·x̂ a
channel (a block's two BNs share g and one pass), sums them over the data
axis on a mesh, and writes dx = scale·(g − Σg/n − x̂·Σg·x̂/n), the last
term dropped at a channel whose variance was clipped (autograd's gradient
through ``clamp_min``).
``statistics_plain``, ``forward_plain``, ``backward_reduce_plain`` and
``backward_apply_plain`` are these steps in plain tensor code, the oracle
of the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_, all_reduce_sum
from . import build

BN_MOMENTUM = 0.9  # flax's momentum: the running statistics' decay

# the kernels' modes: relu(BN(x0)), relu(BN(x0) + BN'(x1)), relu(BN(x0) + r)
BN_RELU, BN_BN_ADD_RELU, BN_INPUT_ADD_RELU = 0, 1, 2
# elements a CTA of every pass takes: whole batch rows of one channel
SLAB_ELEMENTS = 16384
# a BN launch's statistics are (5, K) float32, a column a channel: mean,
# rstd, scale, shift, and 1 where E[x²] − mean² ≥ 0 (0: the variance clipped)


def batch_norm_plain(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool,
                     mesh=None) -> torch.Tensor:
    """BatchNorm over (B, L) of channels-first x, in float32 (float64 for
    float64 x). In training, on the batch's statistics (var = E[x²] −
    E[x]², clipped at 0, the means synced over ``mesh``'s data axis), and
    the running statistics move toward them in place."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if not train:
        return F.batch_norm(x32, bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps)
    mean = x32.mean((0, 2))
    mean_sq = (x32 * x32).mean((0, 2))
    if mesh is not None:
        mean, mean_sq = all_reduce_sum(torch.stack([mean, mean_sq]),
                                       mesh.data_group) / mesh.data_parallel
    var = (mean_sq - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        for running, batch in ((bn.running_mean, mean),
                               (bn.running_var, var)):
            running.copy_(BN_MOMENTUM * running
                          + (1.0 - BN_MOMENTUM) * batch)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x32 - mean[:, None]) * mul[:, None] + bn.bias[:, None]


def bn_relu_plain(c: torch.Tensor, bn: nn.BatchNorm1d, train: bool,
                  mesh=None) -> torch.Tensor:
    """relu(BN(c)) in float32, plain."""
    return F.relu(batch_norm_plain(bn, c, train, mesh))


def bn_add_relu_plain(c: torch.Tensor, bn: nn.BatchNorm1d,
                      res: torch.Tensor, res_bn: Optional[nn.BatchNorm1d],
                      train: bool, mesh=None) -> torch.Tensor:
    """relu(BN(c) + BN'(res)), or relu(BN(c) + res) without ``res_bn``, in
    float32, plain."""
    h = batch_norm_plain(bn, c, train, mesh)
    if res_bn is not None:
        res = batch_norm_plain(res_bn, res, train, mesh)
    return F.relu(h + res)


def bn_relu(c: torch.Tensor, bn: nn.BatchNorm1d, train: bool, mesh=None,
            store: Optional[torch.dtype] = None) -> torch.Tensor:
    """``bn_relu_plain``; the training forward of a CUDA tensor in the
    fused kernels, its output in ``store`` (default c's dtype)."""
    if not train or c.device.type == "cpu":
        return bn_relu_plain(c, bn, train, mesh)
    return _FusedBatchNorm.apply(c, bn.weight, bn.bias, None, None, None,
                                 bn, None, mesh, store or c.dtype, 1)


def bn_add_relu(c: torch.Tensor, bn: nn.BatchNorm1d, res: torch.Tensor,
                res_bn: Optional[nn.BatchNorm1d], train: bool, mesh=None,
                store: Optional[torch.dtype] = None, forks: int = 1
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``bn_add_relu_plain``; the training forward of CUDA tensors in the
    fused kernels, its output in ``store`` (default c's dtype). With
    ``forks=2`` a pair of handles on the output, one for each of its two
    consumers: from the kernels, two tensors whose gradients the backward
    adds in float32 (where a bf16 output's one gradient would be their bf16
    sum); else the output twice."""
    if not train or c.device.type == "cpu":
        out = bn_add_relu_plain(c, bn, res, res_bn, train, mesh)
        return out if forks == 1 else (out, out)
    if res_bn is None:
        return _FusedBatchNorm.apply(c, bn.weight, bn.bias, res, None, None,
                                     bn, None, mesh, store or c.dtype, forks)
    return _FusedBatchNorm.apply(c, bn.weight, bn.bias, res, res_bn.weight,
                                 res_bn.bias, bn, res_bn, mesh,
                                 store or c.dtype, forks)


# ---- the kernels' steps in plain tensor code --------------------------------


@torch.no_grad()
def statistics_plain(xs: Sequence[torch.Tensor],
                     bns: Sequence[nn.BatchNorm1d]) -> torch.Tensor:
    """The (5, K) statistics of each x's channels in turn (K = C·len(xs)), the
    means formed as ``batch_norm_plain`` forms them, in x's precision
    promoted to float32; running statistics untouched."""
    rows = []
    for x, bn in zip(xs, bns):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean((0, 2))
        d = (x * x).mean((0, 2)) - mean * mean
        rstd = torch.rsqrt(d.clamp_min(0.0) + bn.eps)
        scale = rstd * bn.weight.to(x.dtype)
        rows.append(torch.stack([mean, rstd, scale,
                                 bn.bias.to(x.dtype) - mean * scale,
                                 (d >= 0).to(x.dtype)]))
    return torch.cat(rows, 1)


def _pre(xs: Sequence[torch.Tensor], r: Optional[torch.Tensor],
         stats: torch.Tensor) -> torch.Tensor:
    """The pre-activation: x0·scale + shift, plus the second BN's or r."""
    c = xs[0].shape[1]
    pre = 0
    for i, x in enumerate(xs):
        s = stats[:, i * c:(i + 1) * c, None]
        pre = pre + x.to(stats.dtype) * s[2] + s[3]
    return pre if r is None else pre + r.to(stats.dtype)


def forward_plain(xs: Sequence[torch.Tensor], r: Optional[torch.Tensor],
                  stats: torch.Tensor) -> torch.Tensor:
    """The apply pass: relu of the pre-activation, in ``stats``' dtype."""
    return torch.relu(_pre(xs, r, stats))


def backward_reduce_plain(g: torch.Tensor, xs: Sequence[torch.Tensor],
                          r: Optional[torch.Tensor], stats: torch.Tensor
                          ) -> torch.Tensor:
    """The backward's sums, (J, C) in ``stats``' dtype: Σg and Σg·x̂ of
    each x in turn, g masked by the recomputed ReLU."""
    dt, c = stats.dtype, xs[0].shape[1]
    gm = _masked(g, xs, r, stats)
    sums = [gm.sum((0, 2))]
    for i, x in enumerate(xs):
        sums.append((gm * _xhat(x, stats[:, i * c:(i + 1) * c])).sum((0, 2)))
    return torch.stack(sums).to(dt)


def backward_apply_plain(g: torch.Tensor, xs: Sequence[torch.Tensor],
                         r: Optional[torch.Tensor], stats: torch.Tensor,
                         tot: torch.Tensor, count: float
                         ) -> Tuple[List[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """The x's gradients and r's (or None) from ``tot``, the sums over
    every data rank; ``count`` is n, a channel's elements over them."""
    dt, c = stats.dtype, xs[0].shape[1]
    gm = _masked(g, xs, r, stats)
    mean_g = (tot[0] / count)[:, None]
    dxs = []
    for i, x in enumerate(xs):
        s = stats[:, i * c:(i + 1) * c]
        k = torch.where(s[4] != 0, tot[i + 1] / count,
                        torch.zeros((), dtype=dt))
        dxs.append(s[2][:, None] * (gm - mean_g - _xhat(x, s) * k[:, None]))
    return dxs, (gm if r is not None else None)


def backward_plain(g: torch.Tensor, xs: Sequence[torch.Tensor],
                   r: Optional[torch.Tensor], stats: torch.Tensor,
                   count: float
                   ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor],
                              List[torch.Tensor]]:
    """The backward off a mesh: the x's gradients, r's (or None), and each
    BN's (dβ, dγ) in turn."""
    tot = backward_reduce_plain(g, xs, r, stats)
    dxs, dr = backward_apply_plain(g, xs, r, stats, tot, count)
    grads = []
    for i in range(len(xs)):
        grads += [tot[0], tot[i + 1]]
    return dxs, dr, grads


def _xhat(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (x.to(s.dtype) - s[0][:, None]) * s[1][:, None]


def _masked(g: torch.Tensor, xs: Sequence[torch.Tensor],
            r: Optional[torch.Tensor], stats: torch.Tensor) -> torch.Tensor:
    return torch.where(_pre(xs, r, stats) > 0, g.to(stats.dtype),
                       torch.zeros((), dtype=stats.dtype))


# ---- the kernels -----------------------------------------------------------

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _slabs(b: int, length: int) -> Tuple[int, int]:
    """Every pass's batch rows a CTA and slabs of a channel."""
    rows = min(b, max(1, SLAB_ELEMENTS // length))
    return rows, -(-b // rows)


def _vec(length: int, dtype: torch.dtype, *tensors) -> int:
    """1 where every row is whole 16-byte groups and each buffer is
    16-byte aligned: the kernels' vector loads and stores."""
    n = 16 // dtype.itemsize
    return int(length % n == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in tensors))


def _check(x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    """What the kernels take: contiguous (B, C, L) CUDA tensors, bf16 or
    float32, the others of x's shape (``ValueError`` otherwise)."""
    if x.device.type != "cuda":
        raise ValueError(f"no batch-norm kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the batch-norm kernels take bfloat16 or float32, "
                         f"got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"the batch-norm kernels take (B, C, L), got "
                         f"{tuple(x.shape)}")
    for t in (x, *others):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("the batch-norm kernels take contiguous tensors")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{tuple(t.shape)} on {t.device} beside "
                             f"{tuple(x.shape)} on {x.device}")


def _check_grads(gs: Sequence[torch.Tensor], x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One or two gradients of one dtype, x's or float32."""
    if not 1 <= len(gs) <= 2 or len({g.dtype for g in gs}) != 1:
        raise ValueError("the backward takes one or two gradients of one "
                         "dtype")
    if gs[0].dtype not in (x.dtype, torch.float32):
        raise ValueError(f"the gradient is {x.dtype} or float32, not "
                         f"{gs[0].dtype}")
    return gs[0], (gs[1] if len(gs) > 1 else None)


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.bn_error_string(err).decode()} "
                           f"(cudaError {err})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def batch_norm_stats(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-slab partial Σx and Σx² of each channel of one or two (B, C, L)
    tensors: (P, 2, K) float32, K = C·len(xs)."""
    _check(xs[0], *xs[1:])
    b, c, length = xs[0].shape
    rows, p = _slabs(b, length)
    part = torch.empty((p, 2, len(xs) * c), dtype=torch.float32,
                       device=xs[0].device)
    lib = _library()
    with torch.cuda.device(xs[0].device):
        err = lib.bn_stats(_ptr(xs[0]), _ptr(xs[1] if len(xs) > 1 else None),
                           part.data_ptr(), len(xs), b, c, length, rows,
                           int(xs[0].dtype == torch.bfloat16),
                           _vec(length, xs[0].dtype, *xs), _stream(xs[0]))
    _raise_on(lib, "bn_stats", err)
    batch_norm_stats.launches += 1
    return part


def _params(bn: nn.BatchNorm1d) -> List[torch.Tensor]:
    ts = [bn.weight, bn.bias, bn.running_mean, bn.running_var]
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the batch-norm kernels take contiguous float32 "
                             "parameters and running statistics")
    return ts


def batch_norm_finalize(part: torch.Tensor, c: int,
                        bns: Sequence[nn.BatchNorm1d], count: float,
                        sums_only: bool = False) -> torch.Tensor:
    """From (P, 2, K) partials: their sums (2, K) with ``sums_only``; else
    the (5, K) statistics, the BNs' running statistics moved in place."""
    p, _, k = part.shape
    if len({bn.eps for bn in bns}) != 1:
        raise ValueError("the BNs of one launch share eps")
    params = [_params(bn) for bn in bns]
    params += [[None] * 4] * (2 - len(params))
    out = torch.empty((2 if sums_only else 5, k), dtype=torch.float32,
                      device=part.device)
    stats, sums = (None, out) if sums_only else (out, None)
    lib = _library()
    with torch.cuda.device(part.device):
        err = lib.bn_finalize(
            part.data_ptr(), p, k, c, float(count), float(bns[0].eps),
            BN_MOMENTUM, 1.0 - BN_MOMENTUM,
            *(_ptr(t) for t in params[0]), *(_ptr(t) for t in params[1]),
            _ptr(stats), _ptr(sums), int(sums_only), _stream(part))
    _raise_on(lib, "bn_finalize", err)
    batch_norm_finalize.launches += 1
    return out


def _mode(xs, r) -> int:
    return (BN_BN_ADD_RELU if len(xs) > 1
            else BN_RELU if r is None else BN_INPUT_ADD_RELU)


def batch_norm_apply(xs: Sequence[torch.Tensor], r: Optional[torch.Tensor],
                     stats: torch.Tensor, store: torch.dtype
                     ) -> torch.Tensor:
    """relu(BN(x0) [+ BN'(x1) | + r]) in ``store`` (x0's dtype or
    float32); r float32."""
    x0 = xs[0]
    x1 = xs[1] if len(xs) > 1 else None
    _check(x0, x1, r)
    if store not in (x0.dtype, torch.float32):
        raise ValueError(f"the apply pass stores {x0.dtype} or float32, "
                         f"not {store}")
    if r is not None and r.dtype != torch.float32:
        raise ValueError("the residual input is float32")
    b, c, length = x0.shape
    out = torch.empty(x0.shape, dtype=store, device=x0.device)
    lib = _library()
    with torch.cuda.device(x0.device):
        err = lib.bn_apply(_mode(xs, r), _ptr(x0), _ptr(x1), _ptr(r),
                           out.data_ptr(), stats.data_ptr(), b, c, length,
                           _slabs(b, length)[0],
                           int(x0.dtype == torch.bfloat16),
                           int(store == torch.float32),
                           _vec(length, x0.dtype, x0, x1, r, out),
                           _stream(x0))
    _raise_on(lib, "bn_apply", err)
    batch_norm_apply.launches += 1
    return out


def batch_norm_bwd_reduce(gs: Sequence[torch.Tensor],
                          xs: Sequence[torch.Tensor],
                          r: Optional[torch.Tensor], stats: torch.Tensor
                          ) -> torch.Tensor:
    """Per-slab partial Σg, Σg·x̂0 (and Σg·x̂1) of each channel, g the sum
    of the one or two gradients ``gs`` in float32, masked by the
    recomputed ReLU: (P, J, C) float32."""
    x0 = xs[0]
    x1 = xs[1] if len(xs) > 1 else None
    g, g2 = _check_grads(gs, x0)
    _check(x0, x1, r, g, g2)
    b, c, length = x0.shape
    rows, p = _slabs(b, length)
    part = torch.empty((p, 3 if x1 is not None else 2, c),
                       dtype=torch.float32, device=x0.device)
    lib = _library()
    with torch.cuda.device(x0.device):
        err = lib.bn_bwd_reduce(
            _mode(xs, r), g.data_ptr(), _ptr(g2), _ptr(x0), _ptr(x1),
            _ptr(r), stats.data_ptr(), part.data_ptr(), b, c, length, rows,
            int(x0.dtype == torch.bfloat16), int(g.dtype == torch.float32),
            _vec(length, x0.dtype, x0, x1, r, g, g2), _stream(x0))
    _raise_on(lib, "bn_bwd_reduce", err)
    batch_norm_bwd_reduce.launches += 1
    return part


def batch_norm_bwd_finalize(part: torch.Tensor
                            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The partials' sums (J, C), and each BN's (dβ, dγ) in turn."""
    p, j, c = part.shape
    tot = torch.empty((j, c), dtype=torch.float32, device=part.device)
    grads = [torch.empty(c, dtype=torch.float32, device=part.device)
             for _ in range(2 * (j - 1))]
    lib = _library()
    with torch.cuda.device(part.device):
        err = lib.bn_bwd_finalize(part.data_ptr(), p, j, c, tot.data_ptr(),
                                  *(t.data_ptr() for t in grads),
                                  *([None] * (4 - len(grads))),
                                  _stream(part))
    _raise_on(lib, "bn_bwd_finalize", err)
    batch_norm_finalize.launches += 1
    return tot, grads


def batch_norm_bwd_apply(gs: Sequence[torch.Tensor],
                         xs: Sequence[torch.Tensor],
                         r: Optional[torch.Tensor], stats: torch.Tensor,
                         tot: torch.Tensor, count: float
                         ) -> Tuple[List[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """The x's gradients (their dtype) and r's (float32) from the totals
    over every data rank; ``gs`` as in ``batch_norm_bwd_reduce``."""
    x0 = xs[0]
    x1 = xs[1] if len(xs) > 1 else None
    g, g2 = _check_grads(gs, x0)
    _check(x0, x1, r, g, g2)
    b, c, length = x0.shape
    dxs = [torch.empty_like(x) for x in xs]
    dr = None if r is None else torch.empty_like(r)
    lib = _library()
    with torch.cuda.device(x0.device):
        err = lib.bn_bwd_apply(
            _mode(xs, r), g.data_ptr(), _ptr(g2), _ptr(x0), _ptr(x1),
            _ptr(r), stats.data_ptr(), tot.data_ptr(), dxs[0].data_ptr(),
            _ptr(dxs[1] if x1 is not None else None), _ptr(dr), b, c,
            length, _slabs(b, length)[0], float(count),
            int(x0.dtype == torch.bfloat16),
            int(g.dtype == torch.float32),
            _vec(length, x0.dtype, x0, x1, r, g, g2, *dxs, dr), _stream(x0))
    _raise_on(lib, "bn_bwd_apply", err)
    batch_norm_bwd_apply.launches += 1
    return dxs, dr


# kernel launches since the last reset (the backward's finalize counts
# under batch_norm_finalize)
batch_norm_stats.launches = 0
batch_norm_finalize.launches = 0
batch_norm_apply.launches = 0
batch_norm_bwd_reduce.launches = 0
batch_norm_bwd_apply.launches = 0


class _FusedBatchNorm(torch.autograd.Function):
    """relu(BN(x0)), relu(BN(x0) + BN'(x1)) or relu(BN(x0) + x1) (x1 a
    residual input, ``bn1`` None) through the kernels."""

    @staticmethod
    def forward(ctx, x0, w0, b0, x1, w1, b1, bn0, bn1, mesh, store, forks):
        x0 = x0.contiguous()
        xs, r = [x0], None
        if x1 is not None and bn1 is not None:
            xs.append(x1.contiguous())
        elif x1 is not None:
            r = x1.to(torch.promote_types(x1.dtype, torch.float32))
            r = r.contiguous()
            ctx.r_dtype = x1.dtype
        bns = [bn0] + ([bn1] if bn1 is not None else [])
        b, c, length = x0.shape
        count = float(b * length * (1 if mesh is None else
                                    mesh.data_parallel))
        part = batch_norm_stats(xs)
        if mesh is not None:
            part = all_reduce_(batch_norm_finalize(part, c, bns, count,
                                                   sums_only=True),
                               mesh.data_group)[None]
        stats = batch_norm_finalize(part, c, bns, count)
        ctx.save_for_backward(stats, *xs, *([] if r is None else [r]))
        ctx.n_x, ctx.count, ctx.mesh = len(xs), count, mesh
        out = batch_norm_apply(xs, r, stats, store)
        # two consumers, two handles on one tensor: each hands back its own
        # gradient, and the backward adds them in float32
        return out if forks == 1 else (out, out.view_as(out))

    @staticmethod
    def backward(ctx, *grads_out):
        stats, *saved = ctx.saved_tensors
        xs, rest = saved[:ctx.n_x], saved[ctx.n_x:]
        r = rest[0] if rest else None
        gs = [g.contiguous() for g in grads_out if g is not None]
        tot, grads = batch_norm_bwd_finalize(
            batch_norm_bwd_reduce(gs, xs, r, stats))
        if ctx.mesh is not None:
            all_reduce_(tot, ctx.mesh.data_group)
        dxs, dr = batch_norm_bwd_apply(gs, xs, r, stats, tot, ctx.count)
        db0, dw0 = grads[0], grads[1]
        if len(xs) > 1:
            return (dxs[0], dw0, db0, dxs[1], grads[3], grads[2],
                    None, None, None, None, None)
        d1 = None if r is None else dr.to(ctx.r_dtype)
        return dxs[0], dw0, db0, d1, None, None, None, None, None, None, None


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("batchnorm")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bn_stats.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                             i32, ptr]
    lib.bn_finalize.argtypes = [ptr, i32, i32, i32, f32, f32, f32, f32,
                                ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                ptr, ptr, i32, ptr]
    lib.bn_apply.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                             i32, i32, i32, i32, ptr]
    lib.bn_bwd_reduce.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, i32, i32, ptr]
    lib.bn_bwd_finalize.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr,
                                    ptr, ptr]
    lib.bn_bwd_apply.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                 ptr, ptr, ptr, i32, i32, i32, i32, f32,
                                 i32, i32, i32, ptr]
    for name in ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_reduce",
                 "bn_bwd_finalize", "bn_bwd_apply"):
        getattr(lib, name).restype = i32
    lib.bn_error_string.argtypes = [i32]
    lib.bn_error_string.restype = ctypes.c_char_p
    return lib
