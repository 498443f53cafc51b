"""One reader a metric: ``metrics/<metric>.py`` defines ``read(run)``,
which returns the metric's value from a ``harness.Run``, or None where the
run has nothing for it to read."""
