"""Collectives (``parallel/collectives.py``): megabytes per answer that
rank 0's process sends to the others, from the program's counter
``comm_bytes``."""

from portbench.metrics._program import counter


def read(run):
    v = counter(run, "comm_bytes")
    return None if v is None else v / 1e6
