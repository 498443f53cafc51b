"""The encoder's weights, made from the run's seed on the run's device.

The benchmark makes the weights, and both the program and the reference
take them: the program's parameters are overwritten with them after it is
built, and the reference builds its plain model from them. Each leaf is
named as the program and the reference name it (the reference layout of
``transduction_model.py``: ``conv_blocks.{i}.conv1``, ``w_raw_in``,
``transformer.layers.{l}.self_attn.w_q``, ``w_out``, ``w_aux``, ...).

One ``torch.rand`` call on the device draws every value; each leaf is a
view of it, scaled to its spread: torch's fan-in uniform for convolutions
and dense layers, the variance of Xavier's normal for the attention
projections, 1/d_head for the relative tables, identity norms. The values
are uniform in every leaf; their spread is what matters to the work and
to the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .traffic import derived_seed

Leaf = Tuple[str, Tuple[int, ...], str]   # name, shape, init rule


def leaves(config: dict) -> List[Leaf]:
    """Every parameter of the configuration's encoder, in a fixed
    order."""
    d = int(config["model_size"])
    h = int(config["num_heads"])
    dh = d // h
    m = int(config["relative_positional_distance"])
    ff = int(config["dim_feedforward"])
    out: List[Leaf] = []

    def conv(name, cout, cin, k):
        out.append((f"{name}.weight", (cout, cin, k), "fan_in"))
        out.append((f"{name}.bias", (cout,), "fan_in"))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), "one"))
        out.append((f"{name}.bias", (n,), "zero"))

    def dense(name, fout, fin):
        out.append((f"{name}.weight", (fout, fin), "fan_in"))
        out.append((f"{name}.bias", (fout,), "fan_in"))

    for i in range(3):
        cin = int(config["raw_channels"]) if i == 0 else d
        p = f"conv_blocks.{i}"
        conv(f"{p}.conv1", d, cin, 3)
        norm(f"{p}.bn1", d)
        conv(f"{p}.conv2", d, d, 3)
        norm(f"{p}.bn2", d)
        conv(f"{p}.residual_path", d, cin, 1)
        norm(f"{p}.res_norm", d)
    dense("w_raw_in", d, d)
    for layer in range(int(config["num_layers"])):
        p = f"transformer.layers.{layer}"
        for w in ("w_q", "w_k", "w_v"):
            out.append((f"{p}.self_attn.{w}", (h, d, dh), "xavier"))
        out.append((f"{p}.self_attn.w_o", (h, dh, d), "xavier"))
        out.append((f"{p}.self_attn.relative_positional.embeddings",
                    (h, 2 * m - 1, dh, 1), "rel"))
        norm(f"{p}.norm1", d)
        dense(f"{p}.linear1", ff, d)
        dense(f"{p}.linear2", d, ff)
        norm(f"{p}.norm2", d)
    dense("w_out", int(config["num_outs"]), d)
    if config.get("num_aux_outs"):
        dense("w_aux", int(config["num_aux_outs"]), d)
    return out


def _half_width(shape, rule: str) -> float:
    """Half the width of a uniform leaf with the rule's spread."""
    if rule == "fan_in":      # a weight's; its bias follows with the same
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    if rule == "xavier":
        return math.sqrt(3.0 * 2.0 / (shape[-2] + shape[-1]))
    if rule == "rel":
        return math.sqrt(3.0 / shape[2])
    raise ValueError(f"no spread for rule {rule}")


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 weights of ``config``'s encoder from ``seed``, on
    ``device``: the same seed gives the same values on the same kind of
    device."""
    spec = leaves(config)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(
        derived_seed(seed, "weights"))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    weights: Dict[str, torch.Tensor] = {}
    at = 0
    width = 0.0
    for name, shape, rule in spec:
        n = math.prod(shape)
        leaf = flat[at: at + n].view(shape)
        at += n
        if rule == "one":
            leaf.fill_(1.0)
        elif rule == "zero":
            leaf.zero_()
        else:
            if not (rule == "fan_in" and name.endswith("bias")):
                width = _half_width(shape, rule)
            leaf.mul_(width)
        weights[name] = leaf
    return weights


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``weights`` over ``module``'s parameters, which must be the
    same leaves with the same shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's leaves: missing {missing}, extra "
                         f"{extra}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(p.shape)} differs from "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
