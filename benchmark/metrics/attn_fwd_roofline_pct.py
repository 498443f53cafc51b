"""The attention forward kernels' share of their roofline: the frozen
``attention_bound`` of each call's own shapes (which of bytes or operations
sets it is printed on standard error; at the training shapes, bytes),
summed, over the device time of the kernels launched inside
``rel_attention``, in %."""

import sys

from benchmark.bounds import attention_bound


def read(run):
    calls = run.calls.get("rel_attention")
    if run.trace is None or not calls:
        return None
    device_s = run.trace.span_device_s("rel_attention")
    if not device_s:
        return None
    bounds = [attention_bound(c["b"], c["h"], c["t"], c["dh"], c["m"],
                              c["valid_len"], c["dtype"]) for c in calls]
    kinds = sorted({k for _, k in bounds})
    print(f"[metric] attn_fwd_roofline_pct: bound set by {', '.join(kinds)}",
          file=sys.stderr)
    return 100.0 * sum(ms for ms, _ in bounds) / (1e3 * device_s)
