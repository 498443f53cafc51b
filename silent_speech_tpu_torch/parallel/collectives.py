"""Autograd-aware collectives of the data × model mesh.

Each backward is chosen by what consumes the result: whether the gradient
that arrives is *partial* (each rank of the group holds a part of it, to be
summed) or *replicated* (each rank holds the whole, computed identically):

- ``copy_to(x, group)``: Megatron's *f*, at the input of a
  column-parallel block (the heads, the FFN's first layer). Forward the
  identity; backward all-reduces, since each rank's block gives a partial
  gradient of its input.
- ``reduce_from(x, group)``: Megatron's *g*, after a row-parallel product
  (``w_o``, ``linear2``). Forward all-reduces the partial sums; backward
  the identity, since what follows is replicated.
- ``all_reduce_sum(x, group)``: sum forward and backward, for values that
  every rank then uses on its own rows (BatchNorm's synced statistics).
- ``all_gather(x, group, dim, grad)``: concatenates the ranks' shards along
  ``dim``. ``grad="sum"`` when the consumer is itself sharded (the next
  conv's output channels): the backward sums the ranks' partial gradients
  and keeps the rank's slice, a reduce-scatter. ``grad="slice"`` when
  every rank consumes the whole identically (the encoder's outputs
  gathered over ``data`` for a loss that every rank computes whole, the
  conv stack's output before the replicated ``w_raw_in``): the backward
  keeps the rank's slice and does not sum, which would multiply the
  gradient by the group's size.

``all_reduce_`` (in place, no autograd) and ``all_reduce_flat_`` (a list
of tensors through one flat buffer) serve the gradients and metrics. No
collective is skipped for a group of one rank. ``calls`` counts the
collectives issued since the last reset.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, in a new tensor."""
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    calls.count += 1
    return y


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.group, ctx.dim, ctx.grad = group, dim, grad
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        calls.count += 1
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _all_reduce(g, ctx.group)
        return _slice(g, ctx.group, ctx.dim), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0,
               grad: str = "sum") -> torch.Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', not {grad!r}")
    return _AllGather.apply(x, group, dim, grad)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place and return it."""
    dist.all_reduce(x, group=group)
    calls.count += 1
    return x


@torch.no_grad()
def all_reduce_flat_(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor of ``tensors`` (one dtype and device) over ``group``
    in place, through one flat buffer: one collective for the list."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset: offset + n].view_as(t))
        offset += n


class _Calls:
    count = 0


calls = _Calls()   # collectives issued since the last ``calls.count = 0``
