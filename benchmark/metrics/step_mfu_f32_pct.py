"""The float32 step's share of the card's float32 peak: ``step_mfu_pct``'s
arithmetic, the model FLOPs of the measured window's real frames
(``benchmark/flops.py``) over the window's seconds on the host clock,
against the data-sheet float32 peak outside the tensor cores
(``bounds.PEAK_OPS["float32"]``, 67 TFLOP/s), in %. Read from the
untraced window that a traced run measures first. None where the
configuration does not compute in float32."""

from benchmark.bounds import PEAK_OPS
from benchmark.flops import step_flops


def read(run):
    cfg = run.cell.config
    w = run.window
    if cfg["compute_dtype"] != "float32" or w.seconds <= 0 or not w.frames:
        return None
    flops = sum(step_flops(cfg, f) for f in w.frames)
    return 100.0 * flops / w.seconds / PEAK_OPS["float32"]
