"""One driver a program entry: ``drivers/<entry>.py`` defines ``Driver``,
which a configuration file names by its ``entry``."""
