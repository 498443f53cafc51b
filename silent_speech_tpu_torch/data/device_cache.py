"""The training corpus on the device, and batch assembly there.

Counterpart of ``silent_speech_tpu/data/device_cache.py``. The corpus (raw
EMG grouped by feature frame, mel targets, phonemes) lives in a few flat
tensors on the card; each training step uploads only a (U,) vector of
utterance ids, and ``assemble_batch`` gathers the packed batch from the
flat tensors. The result equals ``upload(pack_batch(..., fixed_*))`` of
the same utterances bit for bit. These are gathers, as in JAX, not a
kernel of their own.

Bytes per corpus hour (f32, both timelines at ~86.13 frames a second):
raw EMG frame-grouped 86.13 · 3600 · 64 · 4 B ≈ 79 MB, mel targets
86.13 · 3600 · 80 · 4 B ≈ 99 MB, phonemes ≈ 1.2 MB: ≈ 0.18 GB an hour.
Silent utterances carry their voiced pair's targets. The corpus may take
``cache_hbm_fraction`` (0.4) of the card's memory; ``DeviceCorpus.build``
counts the exact bytes before the upload and raises ``HBMBudgetError``
over that budget, and the trainer then packs on the host. On the CPU there
is no budget. ``SSTPU_CACHE_BUDGET_BYTES`` overrides the budget on any
device.

The text of each utterance (its character ids) is on the card too, for
the recognition trainer's CTC loss. The JAX corpus also carries session
ids, which no step of the port reads.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .packing import DeviceBatch


class HBMBudgetError(RuntimeError):
    """The corpus would exceed its share of the card's memory. Carries the
    byte count of each tensor; the trainer catches it and packs on the
    host."""

    def __init__(self, total_bytes: int, budget_bytes: int,
                 breakdown: dict):
        self.total_bytes = total_bytes
        self.budget_bytes = budget_bytes
        self.breakdown = breakdown
        detail = ", ".join(f"{k}={v / 2**20:.1f} MiB"
                           for k, v in breakdown.items())
        super().__init__(
            f"the device corpus needs {total_bytes / 2**30:.2f} GiB "
            f"({detail}) but the budget is {budget_bytes / 2**30:.2f} GiB; "
            f"falling back to the host packing path (set "
            f"data.cache_hbm_fraction or SSTPU_CACHE_BUDGET_BYTES to raise "
            f"the allowance, or data.device_cache=False to silence this)")


def device_budget(device: torch.device, fraction: float) -> Optional[int]:
    """The corpus's allowance in bytes on ``device``, or None (no limit).

    ``SSTPU_CACHE_BUDGET_BYTES`` first; on CUDA, the card's total memory
    times ``fraction``; on the CPU none, as JAX reports none for CPU
    devices."""
    env = os.environ.get("SSTPU_CACHE_BUDGET_BYTES")
    if env:
        return int(env)
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total * fraction)


class CorpusArrays(NamedTuple):
    """The flat corpus on the device (leading dims are corpus-wide sums).

    Raw EMG is grouped by feature frame: row f holds the 8 consecutive
    8-channel samples of frame f as 64 floats, so assembly is one wide row
    gather. Each flat tensor ends in one zero row, the source of padding.
    """

    raw_frames: torch.Tensor   # (Σ T_u + 1, 64) frame-grouped raw EMG
    tgt_flat: torch.Tensor     # (Σ Ttgt_u + 1, 80) mel targets
    phon_flat: torch.Tensor    # (Σ Ttgt_u + 1,) target-timeline phonemes
    text_flat: torch.Tensor    # (Σ chars_u + 1,) character ids
    feat_len: torch.Tensor     # (E,) feature frames per example
    raw_off: torch.Tensor      # (E,) frame offsets into raw_frames
    tgt_off: torch.Tensor      # (E,) offsets into tgt_flat / phon_flat
    tgt_len: torch.Tensor      # (E,)
    text_off: torch.Tensor     # (E,) offsets into text_flat
    text_len: torch.Tensor     # (E,)
    silent: torch.Tensor       # (E,) bool


@dataclass
class DeviceCorpus:
    arrays: CorpusArrays
    num_examples: int
    # host copies for ordering and the caps' guard
    silent_mask: np.ndarray
    feat_len_host: np.ndarray
    tgt_len_host: np.ndarray
    text_len_host: np.ndarray

    @staticmethod
    def build(examples: Sequence[dict],
              device: Optional[Union[str, torch.device]] = None,
              hbm_fraction: float = 0.4, mesh=None) -> "DeviceCorpus":
        """Flatten example dicts (the ``EMGDataset.__getitem__`` schema) on
        the host, count their bytes against the budget, then upload once.
        On a ``mesh`` every rank holds the whole corpus on its device (JAX
        replicates it), and each step's batch is split after assembly."""
        device = mesh.device if mesh is not None else resolve_device(device)
        raw_parts, tgt_parts, phon_parts, text_parts = [], [], [], []
        feat_len, tgt_len, text_len, silent = [], [], [], []
        for e in examples:
            raw = np.asarray(e["raw_emg"], np.float32)
            tgt = np.asarray(e["parallel_voiced_audio_features"]
                             if e["silent"] else e["audio_features"],
                             np.float32)
            phon = np.asarray(e["phonemes"], np.int32)
            if phon.shape[0] != tgt.shape[0]:
                raise ValueError("phonemes must follow the target timeline")
            raw_parts.append(raw.reshape(-1, 8 * raw.shape[1]))
            tgt_parts.append(tgt)
            phon_parts.append(phon)
            text_parts.append(np.asarray(e["text_int"], np.int32))
            feat_len.append(raw.shape[0] // 8)
            tgt_len.append(tgt.shape[0])
            text_len.append(len(e["text_int"]))
            silent.append(bool(e["silent"]))

        def with_pad_row(parts, dtype=np.float32):
            tail = parts[0].shape[1:] if parts else ()
            return np.concatenate(parts + [np.zeros((1,) + tail, dtype)])

        def offsets(lengths):
            return np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
                np.int32) if lengths else np.zeros(0, np.int32)

        host = CorpusArrays(
            raw_frames=with_pad_row(raw_parts),
            tgt_flat=with_pad_row(tgt_parts),
            phon_flat=with_pad_row(phon_parts, np.int32),
            text_flat=with_pad_row(text_parts, np.int32),
            feat_len=np.asarray(feat_len, np.int32),
            raw_off=offsets(feat_len),
            tgt_off=offsets(tgt_len),
            tgt_len=np.asarray(tgt_len, np.int32),
            text_off=offsets(text_len),
            text_len=np.asarray(text_len, np.int32),
            silent=np.asarray(silent, bool))
        breakdown = {f: getattr(host, f).nbytes for f in host._fields}
        total = sum(breakdown.values())
        budget = device_budget(device, hbm_fraction)
        if budget is not None and total > budget:
            raise HBMBudgetError(total, budget, breakdown)
        return DeviceCorpus(
            arrays=CorpusArrays(*(torch.from_numpy(a).to(device)
                                  for a in host)),
            num_examples=len(examples),
            silent_mask=host.silent,
            feat_len_host=host.feat_len,
            tgt_len_host=host.tgt_len,
            text_len_host=host.text_len)

    def order_silent_first(self, ids: Sequence[int]) -> List[int]:
        return sorted(ids, key=lambda i: not bool(self.silent_mask[i]))


def build_training_corpus(dataset, data_cfg, device: torch.device
                          ) -> Optional[DeviceCorpus]:
    """``dataset`` as a ``DeviceCorpus``, or None when the corpus is off
    (``data_cfg.device_cache`` and ``fixed_shapes`` both needed) or over
    its budget; a trainer then packs on the host. A corpus on disk (an
    ``EMGDataset``) is featurized on the device when
    ``data_cfg.cache_featurize`` is ``"device"``; example dicts in memory
    have no raw capture and go as they are."""
    from .dataset import EMGDataset
    from .device_featurize import build_device_corpus

    if not (data_cfg.device_cache and data_cfg.fixed_shapes):
        return None
    featurize = data_cfg.cache_featurize \
        if isinstance(dataset, EMGDataset) else "host"
    logging.info("building the device corpus (%d examples, %s "
                 "featurization)", len(dataset), featurize)
    try:
        return build_device_corpus(dataset, device, featurize=featurize,
                                   hbm_fraction=data_cfg.cache_hbm_fraction)
    except HBMBudgetError as e:
        logging.warning("%s", e)
        logging.warning("device corpus over budget - using the host "
                        "packing path (per-batch upload)")
        return None


def _segment_owner(dest_starts: torch.Tensor, total: torch.Tensor,
                   n_positions: int):
    """For each output position, which utterance owns it (−1 on
    padding)."""
    pos = torch.arange(n_positions, device=dest_starts.device)
    owner = torch.searchsorted(dest_starts, pos, right=True) - 1
    return pos, torch.where(pos < total, owner, -1)


def assemble_batch(arrays: CorpusArrays, utt_ids: torch.Tensor,
                   utt_valid: torch.Tensor, *, n_chunks: int,
                   seq_len: int = 200, t_cap: int = 1024,
                   text_cap: int = 128, with_audio: bool = True
                   ) -> DeviceBatch:
    """The packed batch of the utterances ``utt_ids`` ((U,) int64, padded
    entries arbitrary; ``utt_valid`` the (U,) bool mask), gathered on their
    device, with the shapes of ``pack_batch(..., fixed_chunks=n_chunks,
    fixed_utts=U, fixed_t=t_cap, with_audio=with_audio)`` and its text
    padded to ``text_cap`` characters. Without audio, as in the packer, the
    targets are left out and a voiced utterance's target length is 0."""
    zero = torch.zeros((), dtype=torch.int32, device=utt_ids.device)
    feat_len = torch.where(utt_valid, arrays.feat_len[utt_ids], zero)
    tgt_len = torch.where(utt_valid, arrays.tgt_len[utt_ids], zero)
    text_len = torch.where(utt_valid, arrays.text_len[utt_ids], zero)
    raw_off = arrays.raw_off[utt_ids].long()
    tgt_off = arrays.tgt_off[utt_ids].long()
    text_off = arrays.text_off[utt_ids].long()
    silent = utt_valid & arrays.silent[utt_ids]

    # where each utterance starts in the packed rows (combine_fixed_length)
    ends = torch.cumsum(feat_len.long(), 0)
    feat_starts = ends - feat_len.long()
    n_rows = n_chunks * seq_len
    pos, owner = _segment_owner(feat_starts, ends[-1], n_rows)
    own = owner.clamp_min(0)
    pad_raw = arrays.raw_frames.shape[0] - 1      # the trailing zero row
    frame_src = torch.where(owner >= 0, raw_off[own] + pos - feat_starts[own],
                            pad_raw)
    raw = arrays.raw_frames.index_select(0, frame_src)   # (n_rows, 8·C)

    # per-utterance views (U, t_cap, ·)
    t_range = torch.arange(t_cap, device=utt_ids.device)
    pad_tgt = arrays.tgt_flat.shape[0] - 1
    tgt_src = torch.where(t_range[None, :] < tgt_len[:, None],
                          tgt_off[:, None] + t_range[None, :], pad_tgt)
    u = utt_ids.shape[0]
    audio = None
    if with_audio:
        audio = arrays.tgt_flat.index_select(
            0, tgt_src.reshape(-1)).reshape(u, t_cap, -1)
    else:
        tgt_len = torch.where(silent, tgt_len, zero)
    phonemes = arrays.phon_flat.index_select(
        0, tgt_src.reshape(-1)).reshape(u, t_cap)
    gather = torch.clamp(feat_starts[:, None] + t_range[None, :],
                         max=n_rows - 1)
    gather = torch.where(utt_valid[:, None], gather, 0).to(torch.int32)

    c_range = torch.arange(text_cap, device=utt_ids.device)
    text_mask = c_range[None, :] < text_len[:, None]
    text_src = torch.where(text_mask, text_off[:, None] + c_range[None, :],
                           arrays.text_flat.shape[0] - 1)
    text = arrays.text_flat.index_select(0, text_src.reshape(-1)).reshape(
        u, text_cap)
    text = torch.where(text_mask, text, torch.full_like(text, -1))
    return DeviceBatch(
        raw_emg=raw.reshape(n_chunks, seq_len * 8, -1),
        utt_gather_idx=gather, utt_len=feat_len, target_len=tgt_len,
        phonemes=phonemes, silent=silent, audio_features=audio,
        text_int=text, text_len=text_len)
