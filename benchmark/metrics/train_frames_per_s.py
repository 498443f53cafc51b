"""EMG feature frames trained a second: the real (unpadded) frames of every
micro-step completed in the window over the window's seconds, host clock,
the window closed on one loss read and a sync."""


def read(run):
    w = run.window
    if w.seconds <= 0 or not w.frames:
        return None
    return sum(w.frames) / w.seconds
