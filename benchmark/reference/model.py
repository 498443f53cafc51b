"""The encoder's training forward in plain PyTorch, float32.

Raw EMG chunks (N, 8L, C) → three strided ResBlocks (conv k=3 → BatchNorm
→ ReLU → conv k=3 → BatchNorm, plus a 1×1 conv → BatchNorm shortcut, then
ReLU; BatchNorm on the batch's statistics, the biased variance, ε 1e-5)
→ a dense layer → post-norm transformer layers (relative-position
attention over a band of ``relative_positional_distance`` − 1 positions
each side, dropout on the probabilities; residual dropout and LayerNorm,
ε ``layer_norm_eps``; a ReLU FFN with dropout on its hidden layer;
residual dropout and LayerNorm) → the output head and, for transduction,
the phoneme head. Training mode: the raw chunks are shifted left by the
step's draw first (``draws.py``). The attention is computed densely, the
scores of pairs outside the band set to −1e8 (the published model's
out-of-window logit), so nothing here mirrors how the program's kernels
tile it.

``Precision("fp8")`` is the control: the configuration's bfloat16 one
step lower. Where the program casts to its compute dtype (both operands of
every convolution, dense layer and attention product, each product's
result, the heads' logits among them, and the transformer's residual
stream after each LayerNorm), the control rounds to float8 e4m3
with a per-tensor scale, and the gradients flowing back through those
points to e5m2; the rest stays float32, as the program keeps it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import draws as rnd

NEG_INF = -1e8


class _FakeFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class Precision:
    """Where the operands of products are rounded: ``"float32"`` (not at
    all) or ``"fp8"``."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"no precision {name}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else _FakeFP8.apply(x)


def _conv(x, w, b, stride, padding, prec):
    return prec(F.conv1d(prec(x), prec(w), prec(b), stride=stride,
                         padding=padding))


def _bn(x, w, b, eps):
    mean = x.mean((0, 2), keepdim=True)
    var = x.var((0, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w[None, :, None] \
        + b[None, :, None]


def _dense(x, P, name, prec):
    return prec(F.linear(prec(x), prec(P[f"{name}.weight"]),
                         prec(P[f"{name}.bias"])))


def resblock(x, P, p, stride, eps, prec):
    h = F.relu(_bn(_conv(x, P[f"{p}.conv1.weight"], P[f"{p}.conv1.bias"],
                         stride, 1, prec),
                   P[f"{p}.bn1.weight"], P[f"{p}.bn1.bias"], eps))
    h = _bn(_conv(h, P[f"{p}.conv2.weight"], P[f"{p}.conv2.bias"], 1, 1,
                  prec), P[f"{p}.bn2.weight"], P[f"{p}.bn2.bias"], eps)
    res = _bn(_conv(x, P[f"{p}.residual_path.weight"],
                    P[f"{p}.residual_path.bias"], stride, 0, prec),
              P[f"{p}.res_norm.weight"], P[f"{p}.res_norm.bias"], eps)
    return F.relu(h + res)


def attention_core(q, k, v, emb, max_dist, seed, drop_rate, prec):
    """softmax((q·k)/√d + q·E[k − q + m − 1]) over the band, dropout,
    times V. q, k, v (B, H, T, d); emb (H, 2m − 1, d)."""
    b, h, t, dh = q.shape
    m = max_dist
    s = torch.einsum("bhqd,bhkd->bhqk", prec(q), prec(k)) / math.sqrt(dh)
    rel = torch.einsum("bhqd,hwd->bhqw", prec(q), prec(emb))
    pos = torch.arange(t, device=q.device)
    off = pos[None, :] - pos[:, None]
    idx = (off + m - 1).clamp(0, 2 * m - 2)
    s = s + rel.gather(-1, idx.expand(b, h, t, t))
    s = s.masked_fill((off.abs() > m - 1), NEG_INF)
    p = torch.softmax(s, dim=-1)
    thresh = rnd.word_threshold(drop_rate)
    if thresh:
        keep = rnd.attention_keep(b, h, t, seed, thresh, q.device)
        p = torch.where(keep, p / (1.0 - thresh / 2.0 ** 32),
                        torch.zeros_like(p))
    return prec(torch.einsum("bhqk,bhkd->bhqd", prec(p), prec(v)))


def layer(x, P, p, cfg, draws: rnd.Draws, prec):
    rate = float(cfg["dropout"])
    eps = float(cfg["layer_norm_eps"])
    # a dropout that drops nothing draws no seed
    s_attn_res, s_ffn, s_ffn_res = (
        draws.seed() if rnd.byte_threshold(rate) else 0 for _ in range(3))
    s_attn = draws.seed() if rnd.word_threshold(rate) else 0
    a = f"{p}.self_attn"
    xq = prec(x)
    q, k, v = (prec(torch.einsum("btd,hda->bhta", xq, prec(P[f"{a}.{w}"])))
               for w in ("w_q", "w_k", "w_v"))
    o = attention_core(q, k, v,
                       P[f"{a}.relative_positional.embeddings"][..., 0],
                       int(cfg["relative_positional_distance"]), s_attn,
                       rate, prec)
    attn = prec(torch.einsum("bhta,haf->btf", prec(o), prec(P[f"{a}.w_o"])))
    d = x.shape[-1]
    x = prec(F.layer_norm(x + rnd.dropout(attn, s_attn_res, rate), (d,),
                          P[f"{p}.norm1.weight"], P[f"{p}.norm1.bias"], eps))
    h = rnd.dropout(F.relu(_dense(x, P, f"{p}.linear1", prec)), s_ffn, rate)
    h = _dense(h, P, f"{p}.linear2", prec)
    return prec(F.layer_norm(x + rnd.dropout(h, s_ffn_res, rate), (d,),
                             P[f"{p}.norm2.weight"], P[f"{p}.norm2.bias"],
                             eps))


def forward(P: Dict[str, torch.Tensor], raw: torch.Tensor, cfg: dict,
            draws: rnd.Draws, prec: Optional[Precision] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The training forward: raw (N, 8L, C) → (N, L, num_outs) and the
    phoneme head's (N, L, num_aux_outs), or None without one."""
    prec = prec or Precision()
    if cfg.get("shift_augment", True):
        raw = rnd.shift_chunks(raw, draws.shift())
    h = raw.transpose(1, 2)
    eps = float(cfg["batch_norm_eps"])
    for i in range(3):
        h = resblock(h, P, f"conv_blocks.{i}", 2, eps, prec)
    h = _dense(h.transpose(1, 2), P, "w_raw_in", prec)
    for i in range(int(cfg["num_layers"])):
        h = layer(h, P, f"transformer.layers.{i}", cfg, draws, prec)
    out = _dense(h, P, "w_out", prec)
    aux = _dense(h, P, "w_aux", prec) if cfg.get("num_aux_outs") else None
    return out, aux
