"""Corpus featurization on the device, for the training corpus.

Counterpart of the JAX package's ``silent_speech_tpu/data/jax_featurize.py``.
The host path (``EMGDataset.__getitem__``) featurizes each utterance with
scipy's ``filtfilt`` chain, ``np.interp`` and a numpy log-mel
(``read_emg.py:52-100``); this module runs the same steps on tensors for
many utterances at once:

- the EMG pass: the cleaning chain over each utterance's neighbour-context
  concat (``ops/filtfilt.py``: one kernel launch for every utterance of
  the corpus on the card), the crop to the utterance, float32 linear
  interpolation to 689.06 Hz from the host path's ``[8:]`` trim, the
  channel mask and the soft clip ``50·tanh(x / 20 / 50)``;
- the mel pass: the clip to ±1, reflect padding at each utterance's own
  end, Hann frames, the DFT as two products, ``log(clamp(·, 1e-5))`` and
  the normalizer.

The host keeps the file reads and the integer bookkeeping (section
lengths, trims), with the host path's exact arithmetic, so the metadata
of every example equals the host path's. The 112 EMG frame features are
not computed: the corpus never reads them.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..dsp.device_pipeline import CAPTURE_RATE, FEAT_RATE, RAW_RATE, \
    filter_coeffs
from ..dsp.mel import MelConfig, _mel_constants
from ..dsp.resample import resample_poly_audio
from ..ops.filtfilt import filtfilt_chain
from ..phonemes import SIL_ID, read_phonemes
from ..utils.audio_io import read_audio
from ..utils.device import resolve_device

FRAME_LENGTH = 16
HOP_LENGTH = 6
# device memory a pass may hold for its largest buffer: the utterances of
# a pass are split into groups under it (results do not depend on the
# grouping; a corpus of thousands of utterances needs several groups)
GROUP_BYTES = 256 << 20


# ---------------------------------------------------------------------------
# the host path's integer arithmetic (dsp.resample.subsample,
# dsp.mel.log_mel_spectrogram, data.dataset.load_utterance)
# ---------------------------------------------------------------------------

def subsample_len(n: int, new_freq: float, old_freq: float = CAPTURE_RATE
                  ) -> int:
    """Output length of ``dsp.resample.subsample`` for n input samples
    (the ``np.arange`` count, float endpoint included)."""
    return len(np.arange(0, (n - 1) / old_freq, 1.0 / new_freq))


def mel_frames_len(n_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Frames of ``dsp.mel.log_mel_spectrogram`` for an n-sample clip
    (reflect padding of (n_fft − hop)/2 a side, ``center=False``)."""
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    return 1 + (n_samples + 2 * pad - cfg.n_fft) // cfg.hop_size


def emg_frame_count(n_516: int) -> int:
    """EMG feature frames of an n-sample 516.79 Hz signal."""
    return 1 + (n_516 - FRAME_LENGTH) // HOP_LENGTH


def load_utterance_raw(base_dir: str, index: int) -> dict:
    """The file half of ``dataset.load_utterance``: the neighbour-context
    raw EMG concat, the 22.05 kHz audio and the info record."""
    from .dataset import load_neighbor_context_emg

    x, n_before, n_main = load_neighbor_context_emg(base_dir, index)
    audio_path = os.path.join(base_dir, f"{index}_audio_clean.flac")
    audio, rate = read_audio(audio_path)
    if rate != 22050:
        audio = resample_poly_audio(audio, rate, 22050)
    with open(os.path.join(base_dir, f"{index}_info.json")) as f:
        info = json.load(f)
    return {
        "raw_concat": np.asarray(x, np.float32),
        "before_len": n_before,
        "main_len": n_main,
        "audio": np.asarray(audio, np.float32),
        "audio_file": audio_path,
        "text": info["text"],
        "book_location": (info["book"], info["sentence_index"]),
        "base_dir": base_dir,
        "index": index,
    }


# ---------------------------------------------------------------------------
# the two passes, on (B, ...) tensors of one device
# ---------------------------------------------------------------------------

def emg_pass(raw: torch.Tensor, total_len: torch.Tensor,
             before_len: torch.Tensor, main_len: torch.Tensor,
             t8: torch.Tensor, chan_mask: torch.Tensor, raw_cap: int
             ) -> torch.Tensor:
    """(B, T_pad, C) raw captures → (B, raw_cap, C) soft-clipped 689.06 Hz
    model input, rows [0, t8[b]) valid (JAX's ``_emg_kernel``). The
    lengths are (B,) int tensors on ``raw``'s device, ``total_len`` also
    readable on the host."""
    dev = raw.device
    x = filtfilt_chain(raw, total_len, filter_coeffs(CAPTURE_RATE, 60.0))
    t_pad = x.shape[1]
    bef, mlen = before_len.long()[:, None], main_len.long()[:, None]
    tp = torch.arange(t_pad, device=dev)[None, :]
    src = (bef + tp).clamp(0, t_pad - 1)
    z = torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[2]))
    z = torch.where((tp < mlen)[..., None], z, 0.0)

    t = torch.arange(raw_cap, device=dev)
    pos = (t + 8).to(torch.float32) * torch.tensor(
        np.float32(CAPTURE_RATE / RAW_RATE), device=dev)
    lo = pos.floor().long()[None, :].clamp(min=0)
    lo = torch.minimum(lo, mlen - 1)
    hi = torch.minimum(lo + 1, mlen - 1)
    frac = (pos[None, :] - lo.to(torch.float32))[..., None]
    c = z.shape[2]
    v = (torch.gather(z, 1, lo[..., None].expand(-1, -1, c)) * (1 - frac)
         + torch.gather(z, 1, hi[..., None].expand(-1, -1, c)) * frac)
    v = v * chan_mask[None, None, :]
    v = torch.where((t[None, :] < t8.long()[:, None])[..., None], v, 0.0)
    v = v / 20.0
    return 50.0 * torch.tanh(v / 50.0)


def mel_pass(audio: torch.Tensor, a_len: torch.Tensor,
             n_frames: torch.Tensor, mel_mean: torch.Tensor,
             mel_std: torch.Tensor, mel_cap: int,
             cfg: MelConfig = MelConfig(), normalize: bool = True
             ) -> torch.Tensor:
    """(B, A_pad) audio → (B, mel_cap, 80) normalized log-mel, rows
    [0, n_frames[b]) valid (JAX's ``_mel_kernel``): reflect padding at each
    utterance's own end, the DFT as two products."""
    dev = audio.device
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    b_, a_pad = audio.shape
    window, cos_m, sin_m, basis_t = _mel_constants(cfg, dev)
    x = audio.clamp(-1.0, 1.0)
    j = torch.arange(pad, device=dev)
    front = x[:, pad - j]
    ext = torch.cat([front, x, x.new_zeros(b_, pad)], 1)
    length = a_len.long()[:, None]
    back = torch.gather(x, 1, (length - 2 - j[None, :]).clamp(0, a_pad - 1))
    ext.scatter_(1, pad + length + j[None, :], back)

    starts = cfg.hop_size * torch.arange(mel_cap, device=dev)
    idx = (starts[:, None] + torch.arange(cfg.n_fft, device=dev)[None, :]
           ).clamp(0, ext.shape[1] - 1)
    frames = ext[:, idx] * window
    re, im = frames @ cos_m, frames @ sin_m
    mag = torch.sqrt(re * re + im * im + 1e-9)
    mel = torch.log(torch.clamp(mag @ basis_t, min=1e-5))
    if normalize:
        mel = (mel - mel_mean) / mel_std
    rows = torch.arange(mel_cap, device=dev)[None, :, None]
    return torch.where(rows < n_frames.long()[:, None, None], mel, 0.0)


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _groups(n: int, bytes_each: int) -> List[range]:
    size = max(1, GROUP_BYTES // max(bytes_each, 1))
    return [range(lo, min(lo + size, n)) for lo in range(0, n, size)]


def featurize_on_device(dataset, ids: Optional[Sequence[int]] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> List[dict]:
    """Featurize ``dataset`` examples (an ``EMGDataset``; all by default)
    on ``device`` (``cuda`` unless told otherwise); returns example dicts
    in the ``EMGDataset.__getitem__`` schema, numpy on the host, without
    the 112 EMG features. A silent example's voiced pair is featurized
    without the length limit, as the dataset loads it, and keyed by
    (directory, index, limit) since the two variants differ."""
    device = resolve_device(device)
    ids = list(range(len(dataset))) if ids is None else list(ids)
    if not ids:
        return []

    utt_keys, key_pos = [], {}

    def claim(d, idx, lim):
        k = (d.directory, idx, lim)
        if k not in key_pos:
            key_pos[k] = len(utt_keys)
            utt_keys.append((d, idx, lim))
        return key_pos[k]

    ex_rows, pair_rows = [], []
    for i in ids:
        d, idx = dataset.example_indices[i]
        ex_rows.append(claim(d, idx, dataset.limit_length))
        if d.silent:
            with open(os.path.join(d.directory, f"{idx}_info.json")) as f:
                info = json.load(f)
            vd, vidx = dataset.voiced_data_locations[
                (info["book"], info["sentence_index"])]
            pair_rows.append(claim(vd, vidx, False))
        else:
            pair_rows.append(-1)

    # ---- host reads and integer bookkeeping ---------------------------
    raws = []
    for d, idx, lim in utt_keys:
        r = load_utterance_raw(d.directory, idx)
        r["session_index"] = d.session_index
        r["silent"] = d.silent
        feat_frames = emg_frame_count(subsample_len(r["main_len"],
                                                    FEAT_RATE))
        max_frames = min(feat_frames, 800) if lim else feat_frames
        mel_frames = min(mel_frames_len(len(r["audio"])), max_frames)
        r["t_frames"] = min(feat_frames, mel_frames)
        r["mel_frames"] = mel_frames
        raws.append(r)

    t_pad = _round_up(max(r["raw_concat"].shape[0] for r in raws), 256)
    raw_cap = _round_up(max(8 * r["t_frames"] for r in raws), 256)
    a_pad = _round_up(max(len(r["audio"]) for r in raws), 4096)
    mel_cap = _round_up(max(r["mel_frames"] for r in raws), 32)
    n_ch = raws[0]["raw_concat"].shape[1]
    chan_mask = np.ones(n_ch, np.float32)
    for c in getattr(dataset.cfg, "remove_channels", ()) or ():
        chan_mask[int(c)] = 0.0
    chan_mask = torch.from_numpy(chan_mask).to(device)

    normalize = not dataset.no_normalizers
    if normalize:
        mel_mean = np.asarray(dataset.mfcc_norm.feature_means,
                              np.float32).reshape(1, -1)
        mel_std = np.float32(dataset.mfcc_norm.feature_stddevs)
    else:
        mel_mean, mel_std = np.zeros((1, 80), np.float32), np.float32(1.0)
    mel_mean = torch.from_numpy(mel_mean).to(device)
    mel_std = torch.tensor(mel_std).to(device)

    def ints(group, fn):
        return torch.tensor([fn(raws[k]) for k in group], dtype=torch.int32)

    # ---- the EMG pass: every utterance's columns in one launch ---------
    raw_out = [None] * len(raws)
    for group in _groups(len(raws), 4 * t_pad * n_ch):
        buf = np.zeros((len(group), t_pad, n_ch), np.float32)
        for k, row in enumerate(group):
            x = raws[row]["raw_concat"]
            buf[k, : x.shape[0]] = x
        tot = ints(group, lambda r: r["raw_concat"].shape[0])
        out = emg_pass(
            torch.from_numpy(buf).to(device), tot,
            ints(group, lambda r: r["before_len"]).to(device),
            ints(group, lambda r: r["main_len"]).to(device),
            ints(group, lambda r: 8 * r["t_frames"]).to(device),
            chan_mask, raw_cap).cpu().numpy()
        for k, row in enumerate(group):
            raw_out[row] = out[k, : 8 * raws[row]["t_frames"]]

    # ---- the mel pass ---------------------------------------------------
    mel_out = [None] * len(raws)
    for group in _groups(len(raws), 4 * mel_cap * MelConfig().n_fft):
        buf = np.zeros((len(group), a_pad), np.float32)
        for k, row in enumerate(group):
            a = raws[row]["audio"]
            buf[k, : len(a)] = a
        out = mel_pass(
            torch.from_numpy(buf).to(device),
            ints(group, lambda r: max(len(r["audio"]), 2)).to(device),
            ints(group, lambda r: r["mel_frames"]).to(device),
            mel_mean, mel_std, mel_cap, normalize=normalize).cpu().numpy()
        for k, row in enumerate(group):
            r = raws[row]
            mel_out[row] = out[k, : r["mel_frames"]][: r["t_frames"]]

    # ---- phonemes (TextGrids on the host) ------------------------------
    tad = dataset.cfg.text_align_directory
    phon_out = []
    for r in raws:
        t = r["t_frames"]
        phon = None
        if tad is not None:
            sess = os.path.basename(r["base_dir"])
            tg = os.path.join(tad, sess,
                              f'{sess}_{r["index"]}_audio.TextGrid')
            if os.path.exists(tg):
                phon = read_phonemes(tg, t)
        if phon is None:
            phon = np.full(t, SIL_ID, dtype=np.int64)
        phon_out.append(phon)

    examples = []
    for row, pair in zip(ex_rows, pair_rows):
        r = raws[row]
        t = r["t_frames"]
        ex = {
            "audio_features": mel_out[row],
            "raw_emg": raw_out[row],
            "text": r["text"],
            "text_int": np.array(
                dataset.text_transform.text_to_int(r["text"]),
                dtype=np.int64),
            "file_label": r["index"],
            "session_ids": np.full(t, r["session_index"], dtype=np.int64),
            "book_location": r["book_location"],
            "silent": r["silent"],
            "phonemes": phon_out[row],
            "audio_file": r["audio_file"],
        }
        if pair >= 0:
            ex["parallel_voiced_audio_features"] = mel_out[pair]
            ex["phonemes"] = phon_out[pair]
            ex["audio_file"] = raws[pair]["audio_file"]
        examples.append(ex)
    return examples


def build_device_corpus(dataset, device=None, featurize: str = "device",
                        hbm_fraction: float = 0.4):
    """The training corpus of ``dataset`` on ``device``, featurized there
    (``featurize="device"``) or by the host path (``"host"``). Raises
    ``HBMBudgetError`` over ``hbm_fraction`` of the card's memory."""
    from .device_cache import DeviceCorpus

    device = resolve_device(device)
    if featurize == "device":
        examples = featurize_on_device(dataset, device=device)
    elif featurize == "host":
        examples = [dataset[i] for i in range(len(dataset))]
    else:
        raise ValueError(f"featurize must be 'device' or 'host', got "
                         f"{featurize!r}")
    return DeviceCorpus.build(examples, device, hbm_fraction=hbm_fraction)
