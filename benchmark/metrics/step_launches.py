"""Device events (kernels, copies, fills) a micro-step launches, in the
traced window: those whose runtime call was made, on any thread, while the
stepping thread was inside a ``train_step_ids`` call. The backward's
kernels launch on autograd's device thread while the stepping thread waits
in ``loss.backward()``, so the launching thread is not asked."""

import bisect


def read(run):
    if run.trace is None or run.traced is None or not run.traced.micro_steps:
        return None
    tid = run.trace.thread_of("train_step_ids")
    if tid is None:
        return None
    starts, ends = run.trace._ranges["train_step_ids"][tid]
    n = 0
    for _, _, _, corr in run.trace.device:
        launch = run.trace._launch.get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[1]) - 1
        n += i >= 0 and launch[1] <= ends[i]
    return n / run.traced.micro_steps if n else None
