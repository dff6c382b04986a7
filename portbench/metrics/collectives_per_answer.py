"""Collectives (``parallel/collectives.py``): collectives across processes
per answer, from the program's counter ``collectives`` (one per
all-gather, all-to-all and halo exchange), in rank 0's process."""

from portbench.metrics._program import counter


def read(run):
    return counter(run, "collectives")
