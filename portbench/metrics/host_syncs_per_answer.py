"""Solver loop dispatch: blocking reads of a device value by the host per
answer (the CG loop's stopping tests, the residuals read as numbers, each
fetch), from the program's counter ``host_syncs``."""

from portbench.metrics._program import counter


def read(run):
    return counter(run, "host_syncs")
