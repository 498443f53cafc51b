"""The transduction (EMG→mel) loss over packed batches.

Counterpart of ``transduction_loss`` and ``pairwise_l2`` in the JAX
package (``silent_speech_tpu/train/losses.py``; reference
``transduction_model.py:98-157``):

- **silent** utterances: the pairwise L2 distances between the target
  frames and the predicted frames, minus ``w·log p(phone)`` of the target's
  phoneme under the phoneme head, are DTW-aligned (rows = target frames);
  the loss sums the cost along the alignment, one term per target frame.
  The dense cost matrix exists only to pick the path and is built without
  gradient; the loss is recomputed along the path with gathers.
- **voiced** utterances: the framewise ‖y − ŷ + 1e−6‖₂ plus ``w·`` the
  summed phoneme cross-entropy.
- batch loss = Σ utterance losses / Σ target lengths.

``matmul_dtype`` sets the dtype of the interior (the gathered views, the
log-softmax, the distances and the stored cost matrix); every sum over
frames or features accumulates in float32 and the loss is a float32
scalar. Everything stays on the batch's device: nothing here waits for the
card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.dtw import dtw_align_batch
from ..phonemes import NUM_PHONES


class TransductionLossOut(NamedTuple):
    loss: torch.Tensor            # scalar: Σ utterance losses / Σ target len
    correct_phones: torch.Tensor  # scalar int: aligned phoneme hits
    total_length: torch.Tensor    # scalar int: Σ target lengths
    confusion: Optional[torch.Tensor]  # (48, 48) pred × target, or None
    alignment: torch.Tensor       # (U, T) DTW alignment, zero when voiced


def pairwise_l2(a: torch.Tensor, b: torch.Tensor,
                matmul_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Batched ‖a_i − b_j‖₂: (U, Ta, D) × (U, Tb, D) → (U, Ta, Tb), float32.

    Uses |a|² + |b|² − 2a·b. The inner product takes operands rounded to
    ``matmul_dtype`` and sums in float32; the norms square in the input
    dtype and sum in float32.
    """
    md = matmul_dtype or a.dtype
    a2 = (a * a).float().sum(-1)[:, :, None]
    b2 = (b * b).float().sum(-1)[:, None, :]
    ab = torch.matmul(a.to(md).float(), b.to(md).float().transpose(1, 2))
    return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=1e-12))


def transduction_loss(pred: torch.Tensor, phoneme_pred: torch.Tensor, batch,
                      phoneme_loss_weight: float = 0.5,
                      phoneme_eval: bool = False,
                      n_silent: Optional[int] = None,
                      matmul_dtype: Optional[torch.dtype] = None
                      ) -> TransductionLossOut:
    """Args:
      pred:          (N, L, 80) packed mel predictions.
      phoneme_pred:  (N, L, 48) packed phoneme logits.
      batch:         the packed batch's tensors on the device
        (``utt_gather_idx``, ``audio_features``, ``phonemes``,
        ``utt_len``, ``target_len``, ``silent``).
      phoneme_eval:  also count the (48, 48) confusion matrix.
      n_silent:      count of leading silent utterances (the packer sorts
        silent first and rounds up to ``SILENT_BUCKET``): the distance
        matrices and the DTW run only on that slice. None = every row.
      matmul_dtype:  dtype of the loss interior (None = float32).
    """
    cdt = torch.float32 if matmul_dtype is None else matmul_dtype
    d_out = pred.shape[-1]
    idx = batch.utt_gather_idx.long()

    def per_utterance(x):
        # (N, L, D) packed rows → (U, T, D); index_select's backward is an
        # index_add, where advanced indexing's sorts the indices first
        flat = x.reshape(-1, x.shape[-1]).to(cdt)
        return flat.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, x.shape[-1])

    utt_pred = per_utterance(pred)                            # (U, T, 80)
    utt_phone = per_utterance(phoneme_pred)                   # (U, T, 48)
    y = batch.audio_features.to(cdt)
    y_phone = batch.phonemes.long()
    utt_len, tgt_len, silent = batch.utt_len, batch.target_len, batch.silent

    u, t_max = utt_phone.shape[:2]
    pos = torch.arange(t_max, device=pred.device)
    tgt_mask = pos[None, :] < tgt_len[:, None]

    lsm = torch.log_softmax(utt_phone, dim=-1)
    y_phone_idx = y_phone.clamp_min(0)[..., None]             # (U, T, 1)
    w = phoneme_loss_weight

    # ---- silent path: DTW over the combined cost --------------------------
    k = u if n_silent is None else min(max(n_silent, 0), u)
    if k > 0:
        md = matmul_dtype or torch.float32
        with torch.no_grad():
            dists_t = pairwise_l2(y[:k], utt_pred[:k], md)    # (K, Ttgt, Tpred)
            # phone_lp_t[u, t, p] = lsm[u, p, y_phone[u, t]]
            phone_lp_t = lsm[:k].to(md).float().gather(
                2, y_phone_idx[:k, :, 0][:, None, :].expand(-1, t_max, -1)
            ).transpose(1, 2)
            costs_t = (dists_t + w * (-phone_lp_t)).to(md)
            alignment_k, _ = dtw_align_batch(
                costs_t, tgt_len[:k].clamp_min(1), utt_len[:k].clamp_min(1))
        align_idx = alignment_k.long()
        aligned_pred = utt_pred[:k].gather(
            1, align_idx[:, :, None].expand(-1, -1, d_out))
        diff_k = y[:k] - aligned_pred
        picked_dist = torch.sqrt(torch.clamp(
            (diff_k * diff_k).float().sum(-1), min=1e-12))
        aligned_lsm = lsm[:k].gather(
            1, align_idx[:, :, None].expand(-1, -1, lsm.shape[-1]))
        picked_lp = aligned_lsm.gather(2, y_phone_idx[:k])[..., 0]
        picked = picked_dist + w * (-picked_lp.float())
        silent_k = torch.where(tgt_mask[:k], picked, 0.0).sum(1)
        silent_losses = F.pad(silent_k, (0, u - k))
        alignment = F.pad(align_idx, (0, 0, 0, u - k))
    else:
        silent_losses = torch.zeros(u, device=pred.device)
        alignment = torch.zeros((u, t_max), dtype=torch.long,
                                device=pred.device)

    # ---- voiced path: framewise distance + CE, on every row ---------------
    # (voiced rows may sit below the bucketed silent count; ``silent``
    # picks each row's branch)
    diff = y - utt_pred
    eps = torch.tensor(1e-6, dtype=cdt, device=pred.device)
    framewise = torch.sqrt(torch.clamp(
        ((diff + eps) ** 2).float().sum(-1), min=1e-12))
    ce = -lsm.gather(2, y_phone_idx)[..., 0].float()
    voiced_losses = torch.where(tgt_mask, framewise + w * ce, 0.0).sum(1)

    per_utt = torch.where(silent, silent_losses, voiced_losses)
    total_length = tgt_len.sum()
    loss = per_utt.sum() / total_length.clamp_min(1)

    # ---- phoneme accuracy / confusion -------------------------------------
    pred_phone_ids = lsm.argmax(-1)                           # (U, Tpred)
    aligned_pred_ids = pred_phone_ids.gather(1, alignment)
    eval_ids = torch.where(silent[:, None], aligned_pred_ids, pred_phone_ids)
    hits = (eval_ids == y_phone) & tgt_mask
    correct = hits.sum()

    confusion = None
    if phoneme_eval:
        cells = (eval_ids * NUM_PHONES + y_phone).reshape(-1)
        confusion = torch.bincount(
            cells, weights=tgt_mask.reshape(-1).float(),
            minlength=NUM_PHONES * NUM_PHONES).reshape(
                NUM_PHONES, NUM_PHONES).float()

    return TransductionLossOut(loss=loss, correct_phones=correct,
                               total_length=total_length,
                               confusion=confusion, alignment=alignment)
