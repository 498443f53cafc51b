"""JAX parameter tree → the port's (reference-layout) state dict.

Own copy of the mapping in the JAX package's ``models/convert.py``
(``flax_to_torch``):

- flax Dense ``kernel`` (in, out) → Linear ``weight`` (out, in)
- flax Conv ``kernel`` (k, in, out) → Conv1d ``weight`` (out, in, k)
- flax BatchNorm ``scale``/``bias`` + batch stats ``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var``
- relative tables (H, 2m−1, d_head) → (H, 2m−1, d_head, 1)

The input is the tree with numpy leaves; the output loads into
``models.encoder.EMGEncoder`` with ``strict=True``. With ``batch_stats``
None (a gradient tree, which has no statistics) the running statistics are
left out. ``encoder_leaves`` holds the mapping as data, so that
``eval/export.quantize_state`` finds each torch weight's flax name.

The vocoder's trees map the same way: ``hifigan_params_to_torch`` gives the
official HiFi-GAN generator state dict (the inverse of the JAX package's
``hifigan_torch_to_params``), ``discriminator_params_to_torch`` the port's
discriminator names (the Flax module names, dot-joined).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def encoder_leaves(n_layers: int, residual: Sequence[bool], aux: bool
                   ) -> List[Tuple[str, Tuple[str, ...], str]]:
    """Every entry of the encoder's state dict as ``(torch key, flax path,
    map)``. The path starts at ``params`` or ``batch_stats``; ``map`` is
    ``"dense"`` (kernel (in, out) → (out, in)), ``"conv"`` ((k, in, out) →
    (out, in, k)), ``"rel"`` (a trailing axis added), ``"count"`` (BatchNorm's
    ``num_batches_tracked``, 0) or ``"same"``. ``residual[i]`` says whether
    ResBlock i has its 1×1 shortcut; ``aux`` whether the phoneme head
    exists."""
    leaves: List[Tuple[str, Tuple[str, ...], str]] = []

    def dense(key, path, kind="dense"):
        leaves.append((f"{key}.weight", ("params",) + path + ("kernel",),
                       kind))
        leaves.append((f"{key}.bias", ("params",) + path + ("bias",),
                       "same"))

    def norm(key, path, stats):
        leaves.append((f"{key}.weight", ("params",) + path + ("scale",),
                       "same"))
        leaves.append((f"{key}.bias", ("params",) + path + ("bias",),
                       "same"))
        if stats:
            for name, stat in (("running_mean", "mean"),
                               ("running_var", "var")):
                leaves.append((f"{key}.{name}",
                               ("batch_stats",) + path + (stat,), "same"))
            leaves.append((f"{key}.num_batches_tracked", (), "count"))

    for i in range(3):
        key, path = f"conv_blocks.{i}", (f"res{i}",)
        dense(f"{key}.conv1", path + ("conv1",), "conv")
        dense(f"{key}.conv2", path + ("conv2",), "conv")
        norm(f"{key}.bn1", path + ("bn1",), True)
        norm(f"{key}.bn2", path + ("bn2",), True)
        if residual[i]:
            dense(f"{key}.residual_path", path + ("residual_path",), "conv")
            norm(f"{key}.res_norm", path + ("res_norm",), True)

    dense("w_raw_in", ("w_raw_in",))
    for i in range(n_layers):
        key, path = f"transformer.layers.{i}", (f"layer{i}",)
        for w in ("w_q", "w_k", "w_v", "w_o"):
            leaves.append((f"{key}.self_attn.{w}",
                           ("params",) + path + ("self_attn", w), "same"))
        leaves.append((f"{key}.self_attn.relative_positional.embeddings",
                       ("params",) + path + ("self_attn", "rel_emb"), "rel"))
        dense(f"{key}.linear1", path + ("linear1",))
        dense(f"{key}.linear2", path + ("linear2",))
        norm(f"{key}.norm1", path + ("norm1",), False)
        norm(f"{key}.norm2", path + ("norm2",), False)

    dense("w_out", ("w_out",))
    if aux:
        dense("w_aux", ("w_aux",))
    return leaves


def state_leaves(state: Mapping[str, object]
                 ) -> List[Tuple[str, Tuple[str, ...], str]]:
    """``encoder_leaves`` of the architecture a reference-layout state dict
    describes."""
    n_layers = 0
    while f"transformer.layers.{n_layers}.linear1.weight" in state:
        n_layers += 1
    return encoder_leaves(
        n_layers, [f"conv_blocks.{i}.residual_path.weight" in state
                   for i in range(3)], "w_aux.weight" in state)


_MAPS = {"dense": lambda a: a.T,
         "conv": lambda a: np.transpose(a, (2, 1, 0)),
         "rel": lambda a: a[..., None],
         "same": lambda a: a}


def jax_to_torch(params: dict, batch_stats: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    n_layers = 0
    while f"layer{n_layers}" in params:
        n_layers += 1
    leaves = encoder_leaves(
        n_layers, ["residual_path" in params[f"res{i}"] for i in range(3)],
        "w_aux" in params)
    trees = {"params": params, "batch_stats": batch_stats}
    out: Dict[str, torch.Tensor] = {}
    for key, path, kind in leaves:
        if kind == "count":
            if batch_stats is not None:
                out[key] = torch.tensor(np.asarray(0))
            continue
        node = trees[path[0]]
        if node is None:   # a gradient tree has no statistics
            continue
        for name in path[1:]:
            node = node[name]
        out[key] = torch.tensor(_MAPS[kind](np.asarray(node)))
    return out


def _conv(out: dict, prefix: str, p: dict) -> None:
    """A flax/lax conv kernel (*spatial, Cin/g, Cout) → torch's
    (Cout, Cin/g, *spatial)."""
    k = np.asarray(p["kernel"])
    out[f"{prefix}.weight"] = torch.tensor(np.ascontiguousarray(
        np.moveaxis(k, (-1, -2), (0, 1))))
    out[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"]))


def hifigan_params_to_torch(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """A JAX generator tree (``generator_apply``'s) → the official
    checkpoint's state dict for ``models.hifigan.Generator``: conv kernels
    (K, Cin, Cout) → (Cout, Cin, K); the ``ups_*`` kernels already carry
    torch's ConvTranspose1d layout (Cin, Cout, K)."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "conv_pre", params["conv_pre"])
    _conv(out, "conv_post", params["conv_post"])
    nk = len(cfg.resblock_kernel_sizes)
    names = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    for i in range(len(cfg.upsample_rates)):
        up = params[f"ups_{i}"]
        out[f"ups.{i}.weight"] = torch.tensor(np.asarray(up["kernel"]))
        out[f"ups.{i}.bias"] = torch.tensor(np.asarray(up["bias"]))
        for j in range(nk):
            blk = params[f"res_{i}_{j}"]
            for d in range(len(cfg.resblock_dilation_sizes[j])):
                for name in names:
                    _conv(out, f"resblocks.{i * nk + j}.{name}.{d}",
                          blk[f"{name}_{d}"])
    return out


def discriminator_params_to_torch(params: dict) -> Dict[str, torch.Tensor]:
    """A Flax ``HiFiGANDiscriminators`` tree → the state dict of
    ``models.hifigan_discriminators.HiFiGANDiscriminators``: ``mpd_{p}``
    kernels (kh, kw, Cin, Cout) → (Cout, Cin, kh, kw), ``msd_{i}`` kernels
    (k, Cin/g, Cout) → (Cout, Cin/g, k)."""
    out: Dict[str, torch.Tensor] = {}
    for sub, convs in params.items():
        for name, p in convs.items():
            _conv(out, f"{sub}.{name}", p)
    return out
