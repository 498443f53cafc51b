"""Debug figures (host side; matplotlib optional).

Own copy of the JAX package's ``silent_speech_tpu/utils/debug_viz.py``,
the reference's two inspection modes as functions that save a figure to a
file or return it:

- ``plot_alignment``: the DTW alignment path (reference ``align.py:28-32``,
  ``align_from_distances(..., debug=True)``);
- ``plot_emg_features``: the 7 panels of one EMG channel's features
  (reference ``data_utils.py:113-130``): the signal, w_h, p_w, p_r, z_p,
  r_h and the STFT magnitude.

Importing this module never needs matplotlib; a plot function without it
raises ``RuntimeError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..dsp.emg_features import (FRAME_LENGTH, _rms, _zero_crossing_rate,
                                double_average, frame_signal)
from ..dsp.mel import hann_window


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "matplotlib is required for debug visualization; install it "
            "or call the non-debug API") from e
    return plt


def _finish(plt, fig, save_path: Optional[str], show: bool):
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    if show:
        plt.show()
    return fig


def plot_alignment(alignment: Sequence[int],
                   shape: Optional[tuple] = None,
                   costs: Optional[np.ndarray] = None,
                   save_path: Optional[str] = None,
                   show: bool = False):
    """Draw a DTW alignment path: ``alignment[i] = j`` maps position i of
    sequence 1 to position j of sequence 2 (``ops.dtw``'s output). Over
    ``costs`` when given; otherwise the binary path matrix of the
    reference's debug mode. Returns ``save_path`` or the figure."""
    plt = _plt()
    alignment = np.asarray(alignment, np.int64)
    if shape is None:
        shape = (len(alignment),
                 int(alignment.max()) + 1 if len(alignment) else 1)
    fig, ax = plt.subplots(figsize=(6, 6))
    if costs is not None:
        ax.matshow(np.asarray(costs), aspect="auto", cmap="viridis")
        ax.plot(alignment, np.arange(len(alignment)), "r-", linewidth=1.5)
        ax.set_xlabel("sequence 2 (target)")
        ax.set_ylabel("sequence 1 (prediction)")
    else:
        visual = np.zeros(shape, np.float32)
        visual[np.arange(len(alignment)), alignment] = 1.0
        ax.matshow(visual, aspect="auto")
    ax.set_title("DTW alignment")
    return _finish(plt, fig, save_path, show)


def plot_emg_features(x: np.ndarray, channel: int = 0,
                      save_path: Optional[str] = None,
                      show: bool = False):
    """The 7 panels of one channel (``x`` (time,) or (time, channels) of
    cleaned EMG): the mean-centred signal, the five frame features (w_h,
    p_w, p_r, z_p, r_h) and the STFT magnitude. Returns ``save_path`` or
    the figure."""
    plt = _plt()
    x = np.asarray(x, np.float64)
    if x.ndim == 2:
        x = x[:, channel]
    x = x - x.mean()
    w = double_average(x)
    p = x - w
    r = np.abs(p)
    w_h = frame_signal(w).mean(axis=1)
    p_w = _rms(frame_signal(w))
    p_r = _rms(frame_signal(r))
    z_p = _zero_crossing_rate(p)
    r_h = frame_signal(r).mean(axis=1)
    window = hann_window(FRAME_LENGTH).astype(np.float64)
    frames = frame_signal(x) * window[None, :]
    s = np.abs(np.fft.rfft(frames, n=FRAME_LENGTH, axis=1)).T  # (9, n)

    fig, axes = plt.subplots(7, 1, figsize=(8, 10), sharex=False)
    panels = [("raw", x), ("w_h", w_h), ("p_w", p_w), ("p_r", p_r),
              ("z_p", z_p), ("r_h", r_h)]
    for ax, (name, sig) in zip(axes[:6], panels):
        ax.plot(sig)
        ax.set_ylabel(name, rotation=0, labelpad=18)
    axes[6].imshow(s, origin="lower", aspect="auto",
                   interpolation="nearest")
    axes[6].set_ylabel("stft", rotation=0, labelpad=18)
    fig.suptitle(f"EMG features, channel {channel}")
    return _finish(plt, fig, save_path, show)
