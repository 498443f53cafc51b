"""The EMG encoder, eval and train forward: conv downsampling stack,
transformer, heads.

Counterpart of ``silent_speech_tpu/models/encoder.py``. The public layout
is the JAX one, raw EMG (B, 8T, C) in and (B, T, out) frames out; the convs
run channels-first inside. Casts follow the JAX module: convs and dense
layers compute in the compute dtype, BatchNorm in float32 with its running
statistics, the heads emit float32. Parameter names are the reference's
(``conv_blocks.{i}.conv1|bn1|conv2|bn2|residual_path|res_norm``,
``w_raw_in``, ``transformer.layers.{i}``, ``w_out``, ``w_aux``).

The train forward (``train=True``) follows the JAX module's
``train=True``: one random left shift of the packed raw chunks per batch
(``shift_raw``), BatchNorm on batch statistics with flax's running update
(``running = 0.9·running + 0.1·batch``, the biased batch variance; torch's
``F.batch_norm`` would take the unbiased one), and the transformer's
dropout. All randomness comes from the caller's CPU ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from .transformer import TransformerEncoder, linear, xavier_normal_


def _conv(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    conv.stride, conv.padding)


BN_MOMENTUM = 0.9  # flax's momentum: the running statistics' decay


def _bn(bn: nn.BatchNorm1d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """BatchNorm over (B, L) of channels-first x, in float32. In training,
    on the batch's statistics (var = E[x²] − E[x]², clipped at 0), and the
    running statistics move toward them in place."""
    x32 = x.float()
    if not train:
        return F.batch_norm(x32, bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps)
    mean = x32.mean((0, 2))
    var = ((x32 * x32).mean((0, 2)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        for running, batch in ((bn.running_mean, mean),
                               (bn.running_var, var)):
            running.copy_(BN_MOMENTUM * running
                          + (1.0 - BN_MOMENTUM) * batch)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x32 - mean[:, None]) * mul[:, None] + bn.bias[:, None]


def shift_raw(x_raw: torch.Tensor, r: int) -> torch.Tensor:
    """Shift every raw chunk (N, L, C) left by r samples along L, the last
    r samples becoming zeros (JAX ``jnp.roll(x, -r, axis=1)`` then the
    tail mask)."""
    t = x_raw.shape[1]
    keep = (torch.arange(t, device=x_raw.device) < t - r)[None, :, None]
    return torch.where(keep, torch.roll(x_raw, -r, dims=1),
                       torch.zeros((), dtype=x_raw.dtype,
                                   device=x_raw.device))


def draw_shift(generator: torch.Generator) -> int:
    """The batch's raw shift r in [0, 8)."""
    return int(torch.randint(0, 8, (), generator=generator))


class ResBlock(nn.Module):
    """conv-bn-relu → conv-bn (+ 1×1-conv-bn shortcut) → relu (reference
    ``architecture.py:14-40``)."""

    def __init__(self, in_channels: int, channels: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv1d(in_channels, channels, 3, stride, padding=1)
        self.bn1 = nn.BatchNorm1d(channels, eps=1e-5)
        self.conv2 = nn.Conv1d(channels, channels, 3, 1, padding=1)
        self.bn2 = nn.BatchNorm1d(channels, eps=1e-5)
        self.residual_path = self.res_norm = None
        if stride != 1 or in_channels != channels:
            self.residual_path = nn.Conv1d(in_channels, channels, 1, stride)
            self.res_norm = nn.BatchNorm1d(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, C, L) → (B, channels, L/stride), float32."""
        cdt = self.compute_dtype
        h = F.relu(_bn(self.bn1, _conv(self.conv1, x, cdt), train))
        h = _bn(self.bn2, _conv(self.conv2, h, cdt), train)
        res = x
        if self.residual_path is not None:
            res = _bn(self.res_norm, _conv(self.residual_path, x, cdt),
                      train)
        return F.relu(h + res)


class EMGEncoder(nn.Module):
    """Raw EMG → frame representations → output head(s): ``num_outs`` is
    80 (mel bins) for transduction or 38 (chars + CTC blank) for
    recognition; ``num_aux_outs=48`` adds the phoneme head."""

    def __init__(self, num_outs: int, num_aux_outs: Optional[int] = None,
                 cfg: Optional[ModelConfig] = None):
        super().__init__()
        cfg = cfg or ModelConfig()
        self.cfg = cfg
        cdt = getattr(torch, cfg.compute_dtype)
        self.compute_dtype = cdt
        d = cfg.model_size
        self.conv_blocks = nn.ModuleList(
            ResBlock(cfg.raw_channels if i == 0 else d, d, 2, cdt)
            for i in range(3))
        self.w_raw_in = nn.Linear(d, d)
        self.transformer = TransformerEncoder(
            cfg.num_layers, d_model=d, n_head=cfg.num_heads,
            dim_feedforward=cfg.dim_feedforward,
            max_dist=cfg.relative_positional_distance, compute_dtype=cdt,
            dropout=cfg.dropout)
        self.w_out = nn.Linear(d, num_outs)
        self.w_aux = (nn.Linear(d, num_aux_outs)
                      if num_aux_outs is not None else None)

    def forward(self, x_raw: torch.Tensor, valid_len: Optional[int] = None,
                *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x_raw (B, 8T, C) → (B, T, num_outs) float32, plus (B, T,
        num_aux_outs) when the model has the phoneme head. ``valid_len``
        is the utterance's length in frames inside a padded T (default
        T); padding frames and utterance frames do not attend to each
        other. ``train=True`` is the training forward and needs a CPU
        ``generator`` for its shift and dropout draws."""
        cdt = self.compute_dtype
        if train:
            if generator is None:
                raise ValueError("the training forward needs a generator")
            if self.cfg.shift_augment:
                x_raw = shift_raw(x_raw, draw_shift(generator))
        else:
            generator = None
        h = x_raw.transpose(1, 2)
        for block in self.conv_blocks:
            h = block(h, train)
        h = linear(self.w_raw_in, h.transpose(1, 2), cdt)
        h = self.transformer(h, valid_len, generator)
        out = linear(self.w_out, h, cdt).float()
        if self.w_aux is None:
            return out
        return out, linear(self.w_aux, h, cdt).float()

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor],
                        compute_dtype: str = "bfloat16") -> "EMGEncoder":
        """Build the architecture a reference-layout state dict describes
        and load it (strict)."""
        n_layers = 0
        while f"transformer.layers.{n_layers}.linear1.weight" in state:
            n_layers += 1
        sa = "transformer.layers.0.self_attn"
        n_head, d, _ = state[f"{sa}.w_q"].shape
        cfg = ModelConfig(
            model_size=d, num_layers=n_layers, num_heads=n_head,
            dim_feedforward=state[
                "transformer.layers.0.linear1.weight"].shape[0],
            relative_positional_distance=(
                state[f"{sa}.relative_positional.embeddings"].shape[1] + 1)
            // 2,
            raw_channels=state["conv_blocks.0.conv1.weight"].shape[1],
            compute_dtype=compute_dtype)
        aux = state.get("w_aux.weight")
        model = cls(state["w_out.weight"].shape[0],
                    None if aux is None else aux.shape[0], cfg)
        model.load_state_dict(state, strict=True)
        return model

    def init_weights(self, generator: torch.Generator) -> "EMGEncoder":
        """Random weights from ``generator``: torch's default fan-in
        uniform for convs and dense layers, Xavier normal for the
        attention projections, N(0, 1/d_head) for the relative tables,
        identity norms and BatchNorm statistics."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (nn.Conv1d, nn.Linear)):
                    bound = 1.0 / math.sqrt(mod.weight[0].numel())
                    mod.weight.uniform_(-bound, bound, generator=generator)
                    mod.bias.uniform_(-bound, bound, generator=generator)
                elif isinstance(mod, nn.BatchNorm1d):
                    mod.reset_parameters()
            for name, p in self.named_parameters():
                if name.split(".")[-1] in ("w_q", "w_k", "w_v", "w_o"):
                    xavier_normal_(p, generator)
                elif name.endswith("relative_positional.embeddings"):
                    p.normal_(0.0, p.shape[2] ** -0.5, generator=generator)
                elif ".norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
        return self
