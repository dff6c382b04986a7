"""Solver: CG iterations per answer (``iters_per_answer``), in the cells
whose answers are held to the device's time per answer."""

from portbench.metrics.iters_per_answer import read  # noqa: F401
