"""Device milliseconds of the kernels launched inside the model's training
forward (conv stack, BatchNorm, transformer, dropout masks, heads) per
micro-step, in the traced window."""


def read(run):
    if run.trace is None or not run.traced.micro_steps:
        return None
    s = run.trace.span_device_s("model.forward")
    return None if s is None else 1e3 * s / run.traced.micro_steps
