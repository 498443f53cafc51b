"""Streaming EMG→text and EMG→speech over a live capture.

Counterpart of the JAX package's ``silent_speech_tpu/eval/streaming.py``.
Raw 1 kHz capture chunks stream in; after every ``hop_s`` seconds of new
signal the buffered window is featurized again, exactly as the offline
dataset featurizes a recording (``featurize_raw_window``, on the host in
float64), and the model runs on the whole window: the running greedy
transcript (``StreamingRecognizer``) or the vocoded audio
(``StreamingSynthesizer``). The zero-phase filters and the centred
feature frames are not causal, so recomputing from the buffer is what
keeps the streamed output equal to the offline output over the same
samples. ``max_window_s`` bounds the buffer: old samples fall off the
front. Each recompute runs the encoder once, through the attention kernel
on the card.

A live demo against the synthetic board::

    python -m silent_speech_tpu_torch.eval.streaming --seconds 6 \\
        [--hop_s 0.5] [--model model.pt] [--device cpu]

With ``--model``, a reference-layout recognition ``model.pt`` is loaded
strictly at full width (d=768, 6 layers); without it a tiny model with
random weights from seed 0 decodes (the JAX demo's, with 4 heads).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..data.dataset import CAPTURE_RATE, FEAT_RATE, RAW_RATE
from ..dsp.emg_features import get_emg_features
from ..dsp.filters import clean_emg
from ..dsp.resample import subsample
from .decode import greedy_ctc_decode


def featurize_raw_window(x: np.ndarray, emg_norm=None,
                         session_index: int = 0,
                         remove_channels=()) -> Optional[dict]:
    """A raw 1 kHz capture window (n, 8) → a model example (``emg``,
    ``raw_emg``, ``session_ids``) with the dataset's featurization and
    normalization (``read_emg.py:52-100``), without the audio-length cap
    (a live stream has no parallel audio). None while the window is too
    short for a feature frame."""
    x = clean_emg(np.asarray(x, np.float64), fs=CAPTURE_RATE)
    emg_orig = subsample(x, RAW_RATE, CAPTURE_RATE)
    emg = subsample(x, FEAT_RATE, CAPTURE_RATE)
    for c in remove_channels:
        emg[:, int(c)] = 0
        emg_orig[:, int(c)] = 0
    if emg.shape[0] < 32:  # too few 516.79 Hz samples for one frame
        return None
    feats = get_emg_features(emg)
    n = feats.shape[0]
    # hop-exact trims, then the dataset's soft clip and normalization
    emg_model = emg_orig[8: 8 + 8 * n]
    if emg_model.shape[0] < 8 * n:
        n = emg_model.shape[0] // 8
        if n == 0:
            return None
        feats = feats[:n]
        emg_model = emg_model[: 8 * n]
    raw = emg_model / 20.0
    raw = 50.0 * np.tanh(raw / 50.0)
    if emg_norm is not None:
        feats = emg_norm.normalize(feats)
        feats = 8.0 * np.tanh(feats / 8.0)
    return {
        "emg": feats.astype(np.float32),
        "raw_emg": raw.astype(np.float32),
        "session_ids": np.full(n, session_index, dtype=np.int64),
    }


class _Window:
    """The bounded buffer of raw samples and the hop bookkeeping."""

    def __init__(self, trainer, emg_norm, session_index: int, hop_s: float,
                 max_window_s: float, remove_channels: Sequence[int]):
        if trainer.model is None:
            raise RuntimeError("the trainer has no model: call "
                               "init_state() or load one first")
        self.trainer = trainer
        self.emg_norm = emg_norm
        self.session_index = session_index
        self.hop = int(hop_s * CAPTURE_RATE)
        self.max_window = int(max_window_s * CAPTURE_RATE)
        self.remove_channels = tuple(remove_channels)
        self._buf = np.zeros((0, 8), np.float64)
        self._since_decode = 0

    def feed(self, samples: np.ndarray) -> None:
        """Append (n, 8) raw 1 kHz samples to the stream."""
        samples = np.atleast_2d(np.asarray(samples, np.float64))
        self._buf = np.concatenate([self._buf, samples], axis=0)
        if self._buf.shape[0] > self.max_window:
            self._buf = self._buf[-self.max_window:]
        self._since_decode += samples.shape[0]

    @property
    def buffered_samples(self) -> int:
        return self._buf.shape[0]

    def _due_example(self, force: bool) -> Optional[dict]:
        """The featurized window when a recompute is due (a hop of new
        samples, or ``force``), else None."""
        if self._since_decode < self.hop and not force:
            return None
        self._since_decode = 0
        return featurize_raw_window(self._buf, self.emg_norm,
                                    self.session_index, self.remove_channels)


class StreamingRecognizer(_Window):
    """Feed raw capture chunks; read back the running transcript.
    ``trainer`` is a ``RecognitionTrainer`` with a model: its padded solo
    forward (``predict_logits``) and the greedy CTC decode run unchanged,
    so the streamed transcript equals the offline greedy decode of the
    same samples."""

    def __init__(self, trainer, emg_norm=None, session_index: int = 0,
                 hop_s: float = 0.25, max_window_s: float = 20.0,
                 remove_channels=()):
        super().__init__(trainer, emg_norm, session_index, hop_s,
                         max_window_s, remove_channels)
        self._text = ""

    def transcript(self, force: bool = False) -> str:
        """The running greedy transcript, recomputed when at least one hop
        of new samples arrived since the last one (or ``force``)."""
        ex = self._due_example(force)
        if ex is not None:
            lp = self.trainer.predict_logits(ex)
            ids = greedy_ctc_decode(lp, self.trainer.blank_id)
            self._text = self.trainer.text_transform.int_to_text(ids)
        return self._text


class StreamingSynthesizer(_Window):
    """Live EMG→speech, the transduction twin of ``StreamingRecognizer``:
    ``audio()`` is the vocoded waveform of the buffered window (the
    predicted normalized mel → ``mfcc_norm.inverse`` → the vocoder),
    recomputed a hop at a time. ``trainer`` is a ``TransductionTrainer``
    with a model; ``vocoder`` maps a (T, 80) mel to 22.05 kHz audio
    (``models.hifigan.Vocoder``)."""

    def __init__(self, trainer, mfcc_norm, vocoder, emg_norm=None,
                 session_index: int = 0, hop_s: float = 0.25,
                 max_window_s: float = 20.0, remove_channels=()):
        super().__init__(trainer, emg_norm, session_index, hop_s,
                         max_window_s, remove_channels)
        self.mfcc_norm = mfcc_norm
        self.vocoder = vocoder
        self._audio = np.zeros(0, np.float32)

    def audio(self, force: bool = False) -> np.ndarray:
        """The 22.05 kHz waveform of the buffered window, recomputed when at
        least one hop of new samples arrived (or ``force``)."""
        ex = self._due_example(force)
        if ex is not None:
            mel = self.mfcc_norm.inverse(self.trainer.predict(ex))
            self._audio = np.asarray(self.vocoder(mel),
                                     np.float32).reshape(-1)
        return self._audio


def demo_trainer(model_path: str = "", device=None):
    """The demo's recognizer: a reference-layout ``model.pt`` loaded
    strictly at full width, or a tiny model with random weights from seed
    0 when ``model_path`` is empty (JAX's d=64, 2 layers, f32, no dropout,
    with 4 heads of 16: the attention kernel's smallest head)."""
    import torch

    from ..config import ModelConfig
    from ..models.encoder import EMGEncoder
    from ..train.recognition import RecognitionTrainer

    if model_path:
        cfg = ModelConfig()
    else:
        cfg = ModelConfig(model_size=64, num_layers=2, num_heads=4,
                          dim_feedforward=128, dropout=0.0,
                          compute_dtype="float32")
    trainer = RecognitionTrainer(cfg, device=device)
    model = EMGEncoder(trainer.blank_id + 1, None, cfg)
    if model_path:
        model.load_state_dict(torch.load(
            model_path, map_location="cpu", weights_only=True), strict=True)
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    trainer.model = model.to(trainer.device).eval()
    return trainer


def _demo(seconds: float, hop_s: float, model_path: str = "",
          device=None) -> str:
    """Live demo: the synthetic board → the streaming recognizer; prints
    the running transcript and returns the last one."""
    import time

    from ..capture.recorder import SyntheticBoard

    trainer = demo_trainer(model_path, device)
    board = SyntheticBoard()
    stream = StreamingRecognizer(trainer, hop_s=hop_s)
    board.start_stream()
    t0 = time.monotonic()
    text = ""
    try:
        while time.monotonic() - t0 < seconds:
            time.sleep(hop_s / 2)
            data = board.get_board_data()
            if data.shape[1]:
                stream.feed(data[:8].T)
            text = stream.transcript()
            print(f"\r[{stream.buffered_samples / 1000.0:6.2f}s] "
                  f"{text!r}", end="", flush=True)
    finally:
        board.stop_stream()
    print()
    return text


def main(argv: Optional[Sequence[str]] = None) -> str:
    import argparse

    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(description="Live streaming recognition "
                                 "from the synthetic board (PyTorch port).")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--hop_s", type=float, default=0.5)
    ap.add_argument("--model", default="",
                    help="reference-layout recognition model.pt (full "
                         "width); a tiny random model without it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)  # no card: raise before any work
    return _demo(a.seconds, a.hop_s, a.model, device)


if __name__ == "__main__":
    main()
