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
left out.

The vocoder's trees map the same way: ``hifigan_params_to_torch`` gives the
official HiFi-GAN generator state dict (the inverse of the JAX package's
``hifigan_torch_to_params``), ``discriminator_params_to_torch`` the port's
discriminator names (the Flax module names, dot-joined).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def jax_to_torch(params: dict, batch_stats: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}

    def dense(prefix, p):
        out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
        out[f"{prefix}.bias"] = np.asarray(p["bias"])

    def conv(prefix, p):
        out[f"{prefix}.weight"] = np.transpose(np.asarray(p["kernel"]),
                                               (2, 1, 0))
        out[f"{prefix}.bias"] = np.asarray(p["bias"])

    def bn(prefix, p, s):
        out[f"{prefix}.weight"] = np.asarray(p["scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
        if s is None:
            return
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0)

    for i in range(3):
        blk_p = params[f"res{i}"]
        blk_s = (dict.fromkeys(("bn1", "bn2", "res_norm")) if batch_stats
                 is None else batch_stats[f"res{i}"])
        rp = f"conv_blocks.{i}"
        conv(f"{rp}.conv1", blk_p["conv1"])
        conv(f"{rp}.conv2", blk_p["conv2"])
        bn(f"{rp}.bn1", blk_p["bn1"], blk_s["bn1"])
        bn(f"{rp}.bn2", blk_p["bn2"], blk_s["bn2"])
        if "residual_path" in blk_p:
            conv(f"{rp}.residual_path", blk_p["residual_path"])
            bn(f"{rp}.res_norm", blk_p["res_norm"], blk_s["res_norm"])

    dense("w_raw_in", params["w_raw_in"])
    i = 0
    while f"layer{i}" in params:
        layer = params[f"layer{i}"]
        rp = f"transformer.layers.{i}"
        sa = layer["self_attn"]
        for w in ("w_q", "w_k", "w_v", "w_o"):
            out[f"{rp}.self_attn.{w}"] = np.asarray(sa[w])
        out[f"{rp}.self_attn.relative_positional.embeddings"] = np.asarray(
            sa["rel_emb"])[..., None]
        dense(f"{rp}.linear1", layer["linear1"])
        dense(f"{rp}.linear2", layer["linear2"])
        for n in ("norm1", "norm2"):
            out[f"{rp}.{n}.weight"] = np.asarray(layer[n]["scale"])
            out[f"{rp}.{n}.bias"] = np.asarray(layer[n]["bias"])
        i += 1

    dense("w_out", params["w_out"])
    if "w_aux" in params:
        dense("w_aux", params["w_aux"])
    return {k: torch.tensor(v) for k, v in out.items()}


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
