"""The DTW kernel's share of its roofline: the frozen ``dtw_bound`` of
each call's lengths (read after the window; bytes or operations, printed
on standard error), summed, over the device time of the kernels launched
inside ``dtw_align_batch``, in %."""

import sys

from benchmark.bounds import dtw_bound


def read(run):
    calls = run.calls.get("dtw_align_batch")
    if run.trace is None or not calls:
        return None
    device_s = run.trace.span_device_s("dtw_align_batch")
    if not device_s:
        return None
    bounds = [dtw_bound(c["n1"].cpu().numpy(), c["n2"].cpu().numpy(),
                        c["shape"][1], c["item"]) for c in calls]
    kinds = sorted({k for _, k in bounds})
    print(f"[metric] dtw_roofline_pct: bound set by {', '.join(kinds)}",
          file=sys.stderr)
    return 100.0 * sum(ms for ms, _ in bounds) / (1e3 * device_s)
