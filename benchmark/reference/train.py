"""The reference's first training steps, and what the comparison reads of
them.

From the benchmark's weights and batches, the reference runs the
configuration's micro-steps: the training forward, the loss, autograd's
backward; with ``grad_accum`` k > 1 the gradients of k micro-steps are
averaged before an update. The update is AdamW as torch defines it
(β = (0.9, 0.999), ε = 1e-8, decoupled weight decay ``l2``), in float32
with float32 moments, at the configuration's fixed learning rate.

It returns the readings that ``benchmark/checks.py`` compares with the
program's: each micro-step's loss, each leaf's norm of the first update's
gradient, each leaf's norm of the change of its weights after the last
update, and the first micro-step's output head (the logits, before any
loss) at the rows of the batch's real frames.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from . import losses, model
from .batch import pack
from .draws import Draws


@dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]     # first update's gradient, per leaf
    change_norms: Dict[str, float]   # weights after the last update − before
    head: Optional[torch.Tensor] = None  # first micro-step's (rows, outs)


def real_rows(batch) -> torch.Tensor:
    """Flattened output rows of the batch's real (unpadded) frames."""
    return torch.cat([torch.arange(s, s + t)
                      for s, t in zip(batch.starts, batch.frames)])


@contextlib.contextmanager
def no_tf32():
    """Full float32 products inside: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def micro_loss(P, cfg, batch, draws, prec):
    """The micro-step's loss and its flattened output head."""
    out, aux = model.forward(P, batch.raw, cfg, draws, prec)
    out = out.reshape(-1, out.shape[-1])
    if cfg["entry"] == "transduction":
        return losses.transduction_loss(
            out, aux.reshape(-1, aux.shape[-1]), batch,
            float(cfg["phoneme_loss_weight"])), out
    return losses.recognition_loss(out, batch,
                                   int(cfg["num_outs"]) - 1), out


def follow(cfg: dict, weights: Dict[str, torch.Tensor], examples,
           micro_batches: Sequence[Sequence[int]], draw_seed: int,
           precision: str = "float32") -> Readings:
    """Run the micro-steps of ``micro_batches`` (corpus indices) from
    ``weights``, with the program's draws from ``draw_seed``."""
    device = next(iter(weights.values())).device
    prec = model.Precision(precision)
    k = int(cfg.get("grad_accum", 1))
    lr = float(cfg["learning_rate"])
    b1, b2 = cfg.get("betas", (0.9, 0.999))
    eps = float(cfg.get("adam_eps", 1e-8))
    wd = float(cfg["l2"])
    P = {n: w.detach().clone().requires_grad_(True)
         for n, w in weights.items()}
    start = {n: w.detach().clone() for n, w in weights.items()}
    mu = {n: torch.zeros_like(w) for n, w in P.items()}
    nu = {n: torch.zeros_like(w) for n, w in P.items()}
    acc = {n: torch.zeros_like(w) for n, w in P.items()}
    draws = Draws(draw_seed)
    step_losses, grad_norms, head = [], {}, None
    count = 0
    with no_tf32():
        for i, ids in enumerate(micro_batches):
            batch = pack(examples, ids, cfg, device)
            loss, out = micro_loss(P, cfg, batch, draws, prec)
            if i == 0:
                rows = real_rows(batch).to(out.device)
                head = out.detach()[rows].cpu()
            del out
            grads = torch.autograd.grad(loss, list(P.values()))
            step_losses.append(float(loss.detach()))
            for n, g in zip(P, grads):
                acc[n] += g / k
            if (i + 1) % k:
                continue
            count += 1
            if count == 1:
                grad_norms = {n: float(g.norm()) for n, g in acc.items()}
            with torch.no_grad():
                for n, p in P.items():
                    g = acc[n]
                    mu[n].mul_(b1).add_(g, alpha=1 - b1)
                    nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = mu[n] / (1 - b1 ** count)
                    v_hat = nu[n] / (1 - b2 ** count)
                    p.sub_(lr * (m_hat / (v_hat.sqrt() + eps) + wd * p))
                    acc[n].zero_()
    change = {n: float((P[n].detach() - start[n]).norm()) for n in P}
    return Readings(step_losses, grad_norms, change, head)
