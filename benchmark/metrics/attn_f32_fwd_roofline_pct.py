"""The f32 attention forward's share of its roofline: the frozen
``attention_bound`` of each call's own shapes at the float32 peak (which
of bytes or operations sets it is printed on standard error; at the
training shapes, operations), summed, over the device time of the kernels
launched inside ``rel_attention``, in %. None where any call read is not
float32: the number stands for the f32 route alone."""

import sys

from benchmark.bounds import attention_bound


def read(run):
    calls = run.calls.get("rel_attention")
    if run.trace is None or not calls:
        return None
    if any(c["dtype"] != "float32" for c in calls):
        return None
    device_s = run.trace.span_device_s("rel_attention")
    if not device_s:
        return None
    bounds = [attention_bound(c["b"], c["h"], c["t"], c["dh"], c["m"],
                              c["valid_len"], "float32") for c in calls]
    kinds = sorted({k for _, k in bounds})
    print(f"[metric] attn_f32_fwd_roofline_pct: bound set by "
          f"{', '.join(kinds)}", file=sys.stderr)
    return 100.0 * sum(ms for ms, _ in bounds) / (1e3 * device_s)
