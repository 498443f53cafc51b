"""Sequence packing into fixed-length chunks (numpy, host side).

Own copy of the JAX package's ``silent_speech_tpu/data/packing.py``
(``pack_batch``, ``PackedBatch``, ``combine_fixed_length``,
``bucket_length``, ``SILENT_BUCKET``): utterances are concatenated along
time, zero-padded and cut into ``(N, seq_len, ·)`` chunks
(reference ``data_utils.py:158-167``), and per-utterance views are gathered
from the flattened model output with precomputed ``(U, T_max)`` indices.
With the fixed caps of the trainer every batch has one shape.
``DeviceBatch`` holds the tensors of a batch that the training step reads,
on the device; ``upload`` makes one from a ``PackedBatch``, and
``data/device_cache.assemble_batch`` one from utterance ids.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

# silent-count bucket: the number of leading silent utterances is rounded
# up to a multiple of this. At most SILENT_BUCKET−1 real voiced utterances
# can sit below the bucketed silent count; the loss handles them.
SILENT_BUCKET = 4


def combine_fixed_length(arrays: Sequence[np.ndarray], length: int,
                         pad_to_multiple: int = 1) -> np.ndarray:
    """Concat (T_i, ...) arrays along time, zero-pad, reshape to (N, length, ...).

    Matches ``data_utils.py:158-167``; additionally pads N up to a multiple of
    ``pad_to_multiple`` (extra all-zero chunks) for shape bucketing.
    """
    total = sum(int(a.shape[0]) for a in arrays)
    n = -(-total // length)  # ceil
    n = -(-n // pad_to_multiple) * pad_to_multiple
    tail = arrays[0].shape[1:]
    out = np.zeros((n * length,) + tuple(tail), dtype=arrays[0].dtype)
    idx = 0
    for a in arrays:
        out[idx: idx + a.shape[0]] = a
        idx += a.shape[0]
    return out.reshape((n, length) + tuple(tail))


_T_BUCKETS = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def bucket_length(t: int, buckets: Sequence[int] = _T_BUCKETS) -> int:
    for b in buckets:
        if t <= b:
            return b
    return -(-t // 1024) * 1024


@dataclass
class PackedBatch:
    """A fully static-shape training batch.

    Chunked model inputs:
      emg          (N, L, 112)  float32 — normalized EMG features
      raw_emg      (N, 8L, 8)   float32 — soft-clipped raw EMG
      session_ids  (N, L)       int32
      segment_ids  (N, L)       int32   — utterance id + 1, 0 on padding

    Per-utterance views (U utterances padded to T_max frames):
      utt_gather_idx (U, T_max) int32 — rows of the flattened (N*L, d) output
      utt_len        (U,)       int32
      audio_features (U, T_max, 80) float32 — loss targets (voiced features
                       for silent utterances, reference ``read_emg.py:261-275``)
      target_len     (U,)       int32
      phonemes       (U, T_max) int32 — target-timeline phoneme ids
      silent         (U,)       bool
      text_int       (U, text_max) int32, padded with -1
      text_len       (U,)       int32
    """

    emg: np.ndarray
    raw_emg: np.ndarray
    session_ids: np.ndarray
    segment_ids: np.ndarray
    utt_gather_idx: np.ndarray
    utt_len: np.ndarray
    target_len: np.ndarray
    phonemes: np.ndarray
    silent: np.ndarray
    text_int: np.ndarray
    text_len: np.ndarray
    audio_features: Optional[np.ndarray] = None
    texts: List[str] = field(default_factory=list)
    # number of leading silent utterances (packers sort silent-first), padded
    # up to a bucket; None when silent examples are not a prefix. The loss
    # runs the DTW only on that slice.
    num_silent: Optional[int] = None


def pack_batch(examples: Sequence[dict], seq_len: int = 200,
               raw_factor: int = 8, chunk_bucket: int = 8,
               utt_bucket: int = 8, text_bucket: int = 64,
               with_audio: bool = True,
               sort_silent_first: bool = True,
               silent_bucket: int = SILENT_BUCKET,
               fixed_chunks: Optional[int] = None,
               fixed_utts: Optional[int] = None,
               fixed_t: Optional[int] = None) -> PackedBatch:
    """Build a :class:`PackedBatch` from dataset example dicts.

    Each example dict follows the reference ``EMGDataset.__getitem__`` schema
    (``read_emg.py:224-259``): keys ``emg`` (T,112), ``raw_emg`` (8T,8),
    ``session_ids`` (T,), ``silent``, ``phonemes``, ``text_int``, ``text``,
    and for loss targets either ``audio_features`` or
    ``parallel_voiced_audio_features``.

    ``fixed_chunks`` / ``fixed_utts`` / ``fixed_t`` pin the padded shapes
    (the trainer derives them from the batch-capacity config) so every
    training batch has the same shape. A batch that exceeds a fixed cap
    keeps its bucketed size.
    """
    if sort_silent_first:
        examples = sorted(examples, key=lambda e: not bool(e["silent"]))
    n_sil_real = sum(1 for e in examples if e["silent"])
    silent_is_prefix = all(
        bool(e["silent"]) == (i < n_sil_real)
        for i, e in enumerate(examples))

    emg_list = [np.asarray(e["emg"], dtype=np.float32) for e in examples]
    raw_list = [np.asarray(e["raw_emg"], dtype=np.float32) for e in examples]
    sess_list = [np.asarray(e["session_ids"], dtype=np.int32)
                 for e in examples]
    lengths = [a.shape[0] for a in emg_list]

    seg_list = [np.full(t, u + 1, dtype=np.int32)
                for u, t in enumerate(lengths)]

    emg = combine_fixed_length(emg_list, seq_len, chunk_bucket)
    raw = combine_fixed_length(raw_list, seq_len * raw_factor, chunk_bucket)
    sess = combine_fixed_length(sess_list, seq_len, chunk_bucket)
    seg = combine_fixed_length(seg_list, seq_len, chunk_bucket)

    if fixed_chunks is not None and emg.shape[0] < fixed_chunks:
        def _pad_chunks(arr):
            pad = np.zeros((fixed_chunks - arr.shape[0],) + arr.shape[1:],
                           arr.dtype)
            return np.concatenate([arr, pad], axis=0)

        emg, raw, sess, seg = map(_pad_chunks, (emg, raw, sess, seg))
    n_rows = emg.shape[0] * seq_len

    # Loss targets: voiced features for silent utterances
    # (reference collate_raw, ``read_emg.py:261-275``).
    targets: List[np.ndarray] = []
    silent = np.array([bool(e["silent"]) for e in examples])
    for e in examples:
        if e["silent"]:
            targets.append(
                np.asarray(e["parallel_voiced_audio_features"],
                           dtype=np.float32))
        elif with_audio:
            targets.append(np.asarray(e["audio_features"], dtype=np.float32))
        else:
            targets.append(np.zeros((0, 1), dtype=np.float32))
    target_len = np.array([t.shape[0] for t in targets], dtype=np.int32)

    phon_list = [np.asarray(e["phonemes"], dtype=np.int32) for e in examples]

    u_real = len(examples)
    u = -(-u_real // utt_bucket) * utt_bucket
    if fixed_utts is not None and u < fixed_utts:
        u = fixed_utts
    t_max = bucket_length(max(max(lengths), int(target_len.max(initial=1))))
    if fixed_t is not None and t_max < fixed_t:
        t_max = fixed_t

    utt_gather_idx = np.zeros((u, t_max), dtype=np.int32)
    utt_len = np.zeros((u,), dtype=np.int32)
    start = 0
    for i, t in enumerate(lengths):
        idx = start + np.arange(t_max)
        utt_gather_idx[i] = np.minimum(idx, n_rows - 1)
        utt_len[i] = t
        start += t

    tl = np.zeros((u,), dtype=np.int32)
    tl[:u_real] = target_len
    phonemes = np.zeros((u, t_max), dtype=np.int32)
    for i, p in enumerate(phon_list):
        phonemes[i, : min(len(p), t_max)] = p[:t_max]

    audio_features = None
    if with_audio:
        dim = next((t.shape[1] for t in targets if t.size), 80)
        audio_features = np.zeros((u, t_max, dim), dtype=np.float32)
        for i, t in enumerate(targets):
            audio_features[i, : min(t.shape[0], t_max)] = t[:t_max]

    sil = np.zeros((u,), dtype=bool)
    sil[:u_real] = silent

    text_ints = [np.asarray(e["text_int"], dtype=np.int32) for e in examples]
    text_max = max(1, max((len(t) for t in text_ints), default=1))
    if fixed_t is not None:  # fixed-shape mode: stabilize the text dim too
        text_max = max(text_max, 2 * text_bucket)
    text_max = -(-text_max // text_bucket) * text_bucket
    text_int = np.full((u, text_max), -1, dtype=np.int32)
    text_len = np.zeros((u,), dtype=np.int32)
    for i, t in enumerate(text_ints):
        text_int[i, : len(t)] = t[:text_max]
        text_len[i] = min(len(t), text_max)

    num_silent = None
    if silent_is_prefix:
        num_silent = min(-(-max(n_sil_real, 0) // silent_bucket)
                         * silent_bucket, u) if n_sil_real else 0

    return PackedBatch(
        emg=emg, raw_emg=raw, session_ids=sess, segment_ids=seg,
        utt_gather_idx=utt_gather_idx, utt_len=utt_len,
        target_len=tl, phonemes=phonemes, silent=sil,
        text_int=text_int, text_len=text_len,
        audio_features=audio_features,
        texts=[e.get("text", "") for e in examples],
        num_silent=num_silent,
    )


class DeviceBatch(NamedTuple):
    """The tensors of a ``PackedBatch`` that the steps read, on the
    device. ``audio_features`` is None in a batch packed without audio
    (the recognition trainer's)."""

    raw_emg: torch.Tensor
    utt_gather_idx: torch.Tensor
    utt_len: torch.Tensor
    target_len: torch.Tensor
    phonemes: torch.Tensor
    silent: torch.Tensor
    audio_features: Optional[torch.Tensor]
    text_int: torch.Tensor
    text_len: torch.Tensor


def upload(batch: PackedBatch, device: torch.device) -> DeviceBatch:
    return DeviceBatch(*(
        None if getattr(batch, name) is None else torch.from_numpy(
            np.ascontiguousarray(getattr(batch, name))).to(device)
        for name in DeviceBatch._fields))
