"""JAX parameter tree → the port's (reference-layout) state dict.

Own copy of the mapping in the JAX package's ``models/convert.py``
(``flax_to_torch``):

- flax Dense ``kernel`` (in, out) → Linear ``weight`` (out, in)
- flax Conv ``kernel`` (k, in, out) → Conv1d ``weight`` (out, in, k)
- flax BatchNorm ``scale``/``bias`` + batch stats ``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var``
- relative tables (H, 2m−1, d_head) → (H, 2m−1, d_head, 1)

The input is the tree with numpy leaves; the output loads into
``models.encoder.EMGEncoder`` with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def jax_to_torch(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
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
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0)

    for i in range(3):
        blk_p, blk_s = params[f"res{i}"], batch_stats[f"res{i}"]
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
