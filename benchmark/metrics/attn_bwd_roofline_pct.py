"""The attention backward kernels' share of their roofline: the frozen
``attention_bwd_bound`` of each call's shapes (bytes or operations, printed
on standard error), summed, over the device time of the kernels launched
inside ``rel_attention_bwd``, in %."""

import sys

from benchmark.bounds import attention_bwd_bound


def read(run):
    calls = run.calls.get("rel_attention_bwd")
    if run.trace is None or not calls:
        return None
    device_s = run.trace.span_device_s("rel_attention_bwd")
    if not device_s:
        return None
    bounds = [attention_bwd_bound(c["b"], c["h"], c["t"], c["dh"], c["m"],
                                  c["dtype"]) for c in calls]
    kinds = sorted({k for _, k in bounds})
    print(f"[metric] attn_bwd_roofline_pct: bound set by {', '.join(kinds)}",
          file=sys.stderr)
    return 100.0 * sum(ms for ms, _ in bounds) / (1e3 * device_s)
