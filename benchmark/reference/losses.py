"""The two training losses, plain.

Transduction (``transduction_model.py:98-157``): a voiced utterance costs
Σ_t ‖y_t − ŷ_t + 1e−6‖₂ + w·CE(phoneme_t); a silent one is aligned to its
voiced recording by DTW over the cost ‖y_i − ŷ_j‖₂ − w·log p_j(phoneme_i)
(rows i the target's frames), and costs that sum along the alignment; the
batch's loss is Σ costs / Σ target frames. The DTW is ``align.py``'s: the
DP over the whole matrix with row 0 and column 0 closed but for (0, 0),
then the backtrace from the corner taking the first minimum of up, left,
diagonal, each row keeping the smallest column visited. It runs in NumPy
on float64 costs; the path is a constant to the gradient.

Recognition (``recognition_model.py:96-101``): the CTC negative
log-likelihood of each utterance's text under its frames' log-softmax,
divided by the text's length, averaged over the utterances. The CTC is the
textbook forward recursion over the blank-interleaved labels in log space,
with the log of zero taken as −1e5 so that unreachable states carry no
gradient.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

LOG_ZERO = -1e5


def dtw_align(costs: np.ndarray) -> np.ndarray:
    """For each row i of the (n1, n2) costs, the smallest column of the
    alignment path in that row (0 for row 0)."""
    n1, n2 = costs.shape
    dp = np.full((n1, n2), np.inf)
    dp[0, 0] = 0.0
    for d in range(2, n1 + n2 - 1):
        i = np.arange(max(1, d - n2 + 1), min(n1 - 1, d - 1) + 1)
        j = d - i
        best = np.minimum(np.minimum(dp[i - 1, j], dp[i, j - 1]),
                          dp[i - 1, j - 1])
        dp[i, j] = costs[i, j] + best
    align = np.zeros(n1, np.int64)
    i, j = n1 - 1, n2 - 1
    while i > 0 and j > 0:
        align[i] = j
        up, left, diag = dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1]
        if up <= left and up <= diag:
            i -= 1
        elif left <= diag:
            j -= 1
        else:
            i, j = i - 1, j - 1
    return align


def transduction_loss(pred: torch.Tensor, phone_logits: torch.Tensor,
                      batch, weight: float) -> torch.Tensor:
    """pred (N·L, mels) and phone_logits (N·L, phonemes), flattened."""
    lsm = torch.log_softmax(phone_logits, dim=-1)
    total = pred.new_zeros(())
    target_frames = 0
    for start, t, silent, y, ph in zip(batch.starts, batch.frames,
                                       batch.silent, batch.targets,
                                       batch.phonemes):
        p = pred[start: start + t]
        lp = lsm[start: start + t]
        if silent:
            with torch.no_grad():
                yd, pd = y.double(), p.double()
                dist = torch.cdist(yd[None], pd[None])[0]
                cost = dist - weight * lp.double()[:, ph].T
            align = torch.from_numpy(dtw_align(cost.cpu().numpy())).to(
                p.device)
            diff = y - p[align]
            ce = -lp[align, ph]
            dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
        else:
            diff = y - p + 1e-6
            dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
            ce = -lp[torch.arange(t, device=p.device), ph]
        total = total + (dist + weight * ce).sum()
        target_frames += y.shape[0]
    return total / target_frames


def ctc_nll(lp: torch.Tensor, frames: List[int], labels: torch.Tensor,
            label_len: List[int], blank: int) -> torch.Tensor:
    """(U,) negative log-likelihoods; lp (U, T, K) log-probs, labels
    (U, S)."""
    u, t_max, _ = lp.shape
    s = labels.shape[1]
    dev = lp.device
    ext = torch.full((u, 2 * s + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    prev2 = torch.cat([torch.full((u, 2), blank, dtype=torch.long,
                                  device=dev), ext[:, :-2]], 1)
    skip = (ext != blank) & (ext != prev2)
    frames_t = torch.tensor(frames, device=dev)
    emit = lp.gather(2, ext[:, None, :].expand(u, t_max, 2 * s + 1))
    alpha = torch.full((u, 2 * s + 1), LOG_ZERO, device=dev)
    alpha = torch.cat([emit[:, 0, :2], alpha[:, 2:]], 1)
    pad = torch.full((u, 1), LOG_ZERO, device=dev)
    for t in range(1, t_max):
        a1 = torch.cat([pad, alpha[:, :-1]], 1)
        a2 = torch.where(skip, torch.cat([pad, pad, alpha[:, :-2]], 1),
                         torch.full_like(alpha, LOG_ZERO))
        new = torch.logsumexp(torch.stack([alpha, a1, a2]), 0) + emit[:, t]
        alpha = torch.where((t < frames_t)[:, None], new, alpha)
    last = torch.tensor([2 * n for n in label_len], device=dev)
    ends = torch.stack([alpha.gather(1, last[:, None])[:, 0],
                        alpha.gather(1, (last - 1)[:, None])[:, 0]])
    return -torch.logsumexp(ends, 0)


def recognition_loss(logits: torch.Tensor, batch, blank: int
                     ) -> torch.Tensor:
    """logits (N·L, classes), flattened."""
    lsm = torch.log_softmax(logits, dim=-1)
    t_max = max(batch.frames)
    rows = []
    for start, t in zip(batch.starts, batch.frames):
        lp = torch.log_softmax(lsm[start: start + t], dim=-1)
        rows.append(torch.cat([lp, lp.new_zeros(t_max - t, lp.shape[1])]))
    labels = torch.stack(batch.texts)
    lengths = [int(x.shape[0]) for x in batch.texts]
    nll = ctc_nll(torch.stack(rows), batch.frames, labels, lengths, blank)
    return (nll / torch.tensor(lengths, device=nll.device)).mean()
