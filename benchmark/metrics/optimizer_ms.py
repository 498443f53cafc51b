"""Device milliseconds of the kernels launched inside
``trainer.optimizer.step`` (``FusedAdamW.step``: the accumulation and the
update) per update, in the traced window."""


def read(run):
    if run.trace is None or not run.traced.updates:
        return None
    s = run.trace.span_device_s("optimizer.step")
    return None if s is None else 1e3 * s / run.traced.updates
