"""Seconds from the start of the process to the first timed step: imports,
the kernels built or loaded, the corpus and weights made from the seed,
the compared steps that also warm up the window's path."""


def read(run):
    return run.setup_s
