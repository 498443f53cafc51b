"""Device milliseconds of the kernels launched inside the forward of the
encoder's three ResBlocks (``bench.conv_block``: the convolutions, their
BatchNorms and ReLUs) per micro-step, in the traced window. None without
that span, or where a block read does not compute in float32."""


def read(run):
    calls = run.calls.get("conv_block")
    if run.trace is None or not calls or not run.traced.micro_steps:
        return None
    if any(c["dtype"] != "float32" for c in calls):
        return None
    s = run.trace.span_device_s("conv_block")
    return None if s is None else 1e3 * s / run.traced.micro_steps
