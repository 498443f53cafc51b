"""The 2-D ``data × model`` mesh over ``torch.distributed`` process groups,
and the sharding of parameters, states and batches.

Counterpart of ``silent_speech_tpu/parallel/mesh.py``. The ranks of the
default process group form a (data, model) grid, rank = data_rank · mp +
model_rank, as JAX reshapes its device list. ``Mesh`` holds a rank's
coordinates and its two subgroups: the ranks that share its model rank
(its ``data`` group) and those that share its data rank (its ``model``
group).

- **data**: each data rank computes the chunk rows ``shard_batch`` gives
  it; gradients are summed over ``data`` and BatchNorm's statistics
  synced over it (``models/encoder.py``). The device corpus is
  replicated: every rank holds it whole (``DeviceCorpus.build(mesh=)``,
  JAX's ``replicate``) and splits each assembled batch.
- **model**: Megatron-style tensor parallelism with JAX's rules
  (``_PARAM_RULES``, kept here as a copy): attention heads, the FFN's
  hidden columns and the conv stack's output channels (with their
  BatchNorm) are split over ``model``; everything else is replicated.
  ``param_partition_spec`` takes a key of the port's (reference-layout)
  state dict, finds its flax path through ``models/convert.
  encoder_leaves`` and maps the flax dimension of JAX's spec to the torch
  one: a flax conv kernel is (K, Cin, Cout) and torch's (Cout, Cin, K), so
  JAX's ``P(None, None, "model")`` is torch dimension 0.

Where JAX declares shardings and lets XLA insert the collectives, the port
issues them itself (``collectives.py``). ``make_mesh`` builds on an
existing default group, on ``torchrun``'s environment, or on a world of
one process (an in-memory store); the card's backend is NCCL, the CPU's
gloo. Asking for more CUDA ranks than there are cards raises: nothing
falls back to a virtual mesh on the CPU.
"""

from __future__ import annotations

import functools
import os
import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..data.packing import DeviceBatch
from ..models.convert import encoder_leaves
from ..utils.device import resolve_device
from .collectives import all_gather

DATA, MODEL = "data", "model"


@dataclass(eq=False)
class Mesh:
    data_parallel: int
    model_parallel: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    device: torch.device

    @property
    def rank(self) -> int:
        return self.data_rank * self.model_parallel + self.model_rank

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA: self.data_parallel, MODEL: self.model_parallel}

    def group(self, axis: str):
        return {DATA: self.data_group, MODEL: self.model_group}[axis]

    def axis_rank(self, axis: str) -> int:
        return {DATA: self.data_rank, MODEL: self.model_rank}[axis]

    def rows(self, n: int) -> Tuple[int, int]:
        """(first, count) of this data rank's share of ``n`` rows."""
        if n % self.data_parallel:
            raise ValueError(f"{n} rows do not split over a data axis of "
                             f"{self.data_parallel}")
        k = n // self.data_parallel
        return self.data_rank * k, k

    def __repr__(self) -> str:
        return (f"Mesh({self.data_parallel}x{self.model_parallel}, rank "
                f"{self.rank} = ({self.data_rank}, {self.model_rank}), "
                f"{self.device})")


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init_default_group(device: torch.device) -> None:
    """The default process group: ``torchrun``'s when its environment is
    set, else a world of one process on an in-memory store."""
    backend = backend_for(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The (data_parallel, model_parallel) mesh over the default process
    group, which it creates if there is none. ``data_parallel=-1`` takes
    every rank the model axis leaves. Every rank must call it, with the
    same arguments. On CUDA each rank takes card ``LOCAL_RANK`` (default
    its rank); a rank without a card raises."""
    device = resolve_device(device)
    if not dist.is_initialized():
        _init_default_group(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"a model axis of {model_parallel} does not divide "
                         f"{world} ranks")
    if data_parallel == -1:
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} needs "
                         f"{data_parallel * model_parallel} ranks, the "
                         f"process group has {world}")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if device.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {rank} needs card {local}, but this host has "
                    f"{torch.cuda.device_count()}")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    data_rank, model_rank = divmod(rank, model_parallel)
    model_group = data_group = None
    # every rank creates every group, in the same order
    for d in range(data_parallel):
        g = dist.new_group([d * model_parallel + m
                            for m in range(model_parallel)])
        if d == data_rank:
            model_group = g
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m
                            for d in range(data_parallel)])
        if m == model_rank:
            data_group = g
    return Mesh(data_parallel, model_parallel, data_rank, model_rank,
                data_group, model_group, device)


def destroy() -> None:
    """Tear the default process group down (every rank)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


# ---------------- partition rules -------------------------------------
# (regex over the flax path 'a/b/c') → the spec of each flax dimension, a
# copy of the JAX package's rules
_PARAM_RULES = [
    # attention: shard heads over the model axis
    (r".*self_attn/w_[qkvo]$", (MODEL, None, None)),
    (r".*self_attn/rel_emb$", (MODEL, None, None)),
    # FFN: Megatron split — up proj columns, down proj rows
    (r".*linear1/kernel$", (None, MODEL)),
    (r".*linear1/bias$", (MODEL,)),
    (r".*linear2/kernel$", (MODEL, None)),
    # conv stack: shard output channels; BN params follow the channel dim
    (r".*res\d+/conv\d+/kernel$", (None, None, MODEL)),
    (r".*res\d+/conv\d+/bias$", (MODEL,)),
    (r".*res\d+/residual_path/kernel$", (None, None, MODEL)),
    (r".*res\d+/residual_path/bias$", (MODEL,)),
    (r".*res\d+/(bn\d+|res_norm)/(scale|bias|mean|var)$", (MODEL,)),
]

# flax dimension → torch dimension, by the layout map of convert.py
_DIM_MAPS = {"dense": {0: 1, 1: 0}, "conv": {0: 2, 1: 1, 2: 0}}


def flax_spec(path: str) -> Tuple[Optional[str], ...]:
    """JAX's spec of the flax path ``path`` ('res0/conv1/kernel'); () is
    replicated."""
    for pattern, spec in _PARAM_RULES:
        if re.match(pattern, path):
            return spec
    return ()


@functools.lru_cache(maxsize=None)
def _leaf(key: str) -> Optional[Tuple[Tuple[str, ...], str]]:
    m = re.match(r"transformer\.layers\.(\d+)\.", key)
    n_layers = int(m.group(1)) + 1 if m else 0
    for k, path, kind in encoder_leaves(n_layers, [True] * 3, True):
        if k == key:
            return path, kind
    return None


def param_partition_spec(name: str) -> Optional[Tuple[int, str]]:
    """(torch dimension, mesh axis) along which the state-dict entry
    ``name`` is split, or None when it is replicated (every key outside
    the encoder's, such as the vocoder's, is)."""
    leaf = _leaf(name)
    if leaf is None or not leaf[0]:
        return None
    path, kind = leaf
    spec = flax_spec("/".join(path[1:]))
    for flax_dim, axis in enumerate(spec):
        if axis is not None:
            return _DIM_MAPS.get(kind, {}).get(flax_dim, flax_dim), axis
    return None


# ---------------- states ----------------------------------------------
def shard_tensor(name: str, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` of entry ``name``."""
    spec = param_partition_spec(name)
    if spec is None:
        return x
    dim, axis = spec
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"{name} {tuple(x.shape)} does not split {n} ways "
                         f"along dimension {dim}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_rank(axis) * size, size).clone()


def gather_tensor(name: str, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full tensor of entry ``name`` from this rank's slice ``x``
    (every rank of the axis calls it)."""
    spec = param_partition_spec(name)
    if spec is None:
        return x
    dim, axis = spec
    with torch.no_grad():
        return all_gather(x, mesh.group(axis), dim)


def shard_state(state: Mapping[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state dict."""
    return {k: shard_tensor(k, v, mesh) for k, v in state.items()}


def gather_state(state: Mapping[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """The full state dict from this rank's slices (a collective: every
    rank calls it, with the same keys in the same order)."""
    return {k: gather_tensor(k, v, mesh) for k, v in state.items()}


@torch.no_grad()
def shard_module(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replace each parameter and buffer of ``module`` (full) by this
    rank's slice, in place."""
    for name, p in module.named_parameters():
        p.data = shard_tensor(name, p.data, mesh)
    for name, b in module.named_buffers():
        b.data = shard_tensor(name, b.data, mesh)
    return module


# ---------------- batches ---------------------------------------------
def shard_batch(batch: DeviceBatch, mesh: Mesh) -> DeviceBatch:
    """This data rank's rows of each tensor of ``batch`` whose leading
    dimension splits over ``data``; a tensor whose leading dimension does
    not split is kept whole (JAX replicates it)."""
    dp = mesh.data_parallel

    def take(v):
        if v is None or v.dim() == 0 or v.shape[0] % dp:
            return v
        first, count = mesh.rows(v.shape[0])
        return v[first: first + count]

    return DeviceBatch(*(take(v) for v in batch))


def full_model(model):
    """A one-process copy of a sharded ``EMGEncoder`` with the gathered
    state (every rank calls it): what ``eval/export.save_serving_bundle``
    takes from a trainer on a mesh."""
    from ..models.encoder import EMGEncoder

    mesh = model.mesh
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if mesh is not None:
        state = gather_state(state, mesh)
    aux = model.w_aux.weight.shape[0] if model.w_aux is not None else None
    full = EMGEncoder(model.w_out.weight.shape[0], aux, model.cfg)
    full.load_state_dict({k: v.cpu() for k, v in state.items()},
                         strict=True)
    return full.to(mesh.device if mesh is not None else
                   next(model.parameters()).device)


def data_sync(mesh: Mesh, mean: bool = False):
    """The optimizer's ``grad_sync`` on ``mesh``: the gradients summed (or
    averaged) over ``data``, one collective for all of them."""
    from .collectives import all_reduce_flat_

    def sync(grads):
        all_reduce_flat_(grads, mesh.data_group)
        if mean:
            torch._foreach_div_(grads, float(mesh.data_parallel))
    return sync
