"""The whole step's share of the card's peak: the model FLOPs of the
measured window's real frames (``benchmark/flops.py``: convolutions, dense
layers, the attention band's visible pairs, heads; three times the
forward) over the window's seconds on the host clock, against the
data-sheet peak of the configuration's compute dtype (989 TFLOP/s in
bf16), in %. Read from the untraced window that a traced run measures
first, as ``train_frames_per_s`` is, so the profiler's host cost is not in
it."""

from benchmark.bounds import PEAK_OPS
from benchmark.flops import step_flops


def read(run):
    cfg = run.cell.config
    w = run.window
    if w.seconds <= 0 or not w.frames:
        return None
    flops = sum(step_flops(cfg, f) for f in w.frames)
    return 100.0 * flops / w.seconds / PEAK_OPS[cfg["compute_dtype"]]
