"""The CTC kernels' share of their roofline: the frozen ``ctc_bound`` of
each call's lengths (read after the window; bytes or operations, printed
on standard error), forward and backward, summed, over the device time of
the kernels launched inside ``ctc_nll`` (the forward) and inside the
backward's launch (``ops/ctc.py`` ``_launch_bwd``), in %. Without both
spans there is nothing to read."""

import sys

from benchmark.bounds import ctc_bound


def read(run):
    calls = run.calls.get("ctc_nll")
    if run.trace is None or not calls:
        return None
    forward = run.trace.span_device_s("ctc_nll")
    backward = run.trace.span_device_s("ctc_nll.backward")
    if not forward or not backward:
        return None
    device_s = forward + backward
    bounds = [ctc_bound(c["shape"], c["utt_len"].cpu().numpy(),
                        c["text_len"].cpu().numpy(), c["labels_width"])
              for c in calls]
    kinds = sorted({k for _, k in bounds})
    print(f"[metric] ctc_roofline_pct: bound set by {', '.join(kinds)}",
          file=sys.stderr)
    return 100.0 * sum(ms for ms, _ in bounds) / (1e3 * device_s)
