"""The port's ``utils/debug_viz.py`` against the JAX package's under
matplotlib's Agg backend: the same panels with equal arrays (each line's
data, each image's array) and the same titles and labels."""

import sys

import matplotlib
import numpy as np
import pytest

from silent_speech_tpu.utils import debug_viz as jax_viz
from silent_speech_tpu_torch.utils import debug_viz

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _figure_data(fig):
    out = [fig._suptitle.get_text() if fig._suptitle else None]
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
                     for ln in ax.get_lines()],
                    [np.asarray(im.get_array()) for im in ax.get_images()]))
    return out


def _assert_same(a, b):
    assert len(a) == len(b) and a[0] == b[0]
    for pa, pb in zip(a[1:], b[1:]):
        assert pa[:3] == pb[:3]
        assert len(pa[3]) == len(pb[3]) and len(pa[4]) == len(pb[4])
        for (xa, ya), (xb, yb) in zip(pa[3], pb[3]):
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
        for ia, ib in zip(pa[4], pb[4]):
            assert ia.dtype == ib.dtype and np.array_equal(ia, ib)


def _both(name, *args, **kwargs):
    figs = [getattr(m, name)(*args, **kwargs) for m in (debug_viz, jax_viz)]
    data = [_figure_data(f) for f in figs]
    for f in figs:
        plt.close(f)
    _assert_same(*data)
    return data[0]


@pytest.mark.parametrize("with_costs", [False, True])
def test_plot_alignment_matches_jax(with_costs):
    rng = np.random.default_rng(0)
    alignment = np.sort(rng.integers(0, 40, size=30))
    costs = rng.random((30, 40)) if with_costs else None
    data = _both("plot_alignment", alignment, costs=costs)
    assert data[1][0] == "DTW alignment"
    if not with_costs:
        visual = data[1][4][0]
        assert visual.shape == (30, int(alignment.max()) + 1)
        assert visual.sum() == 30


def test_plot_alignment_with_a_shape_and_a_file(tmp_path):
    _both("plot_alignment", [0, 1, 1, 3], shape=(4, 6))
    path = str(tmp_path / "a.png")
    assert debug_viz.plot_alignment([0, 1, 2], save_path=path) == path
    assert (tmp_path / "a.png").stat().st_size > 0


@pytest.mark.parametrize("channel", [0, 5])
def test_plot_emg_features_matches_jax(channel):
    x = np.random.default_rng(channel).normal(size=(400, 8)) * 20
    data = _both("plot_emg_features", x, channel=channel)
    assert [p[2] for p in data[1:]] == ["raw", "w_h", "p_w", "p_r", "z_p",
                                        "r_h", "stft"]
    assert data[7][4][0].shape[0] == 9


def test_plot_emg_features_single_channel_to_a_file(tmp_path):
    x = np.random.default_rng(3).normal(size=300)
    _both("plot_emg_features", x)
    path = str(tmp_path / "f.png")
    assert debug_viz.plot_emg_features(x, save_path=path) == path
    assert (tmp_path / "f.png").stat().st_size > 0


def test_without_matplotlib_a_plot_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib is required"):
        debug_viz.plot_alignment([0, 1])
