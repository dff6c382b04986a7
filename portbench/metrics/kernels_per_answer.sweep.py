"""Solver loop dispatch: device kernels per answer
(``kernels_per_answer``), in the cells whose answers are held to the
device's time per answer."""

from portbench.metrics.kernels_per_answer import read  # noqa: F401
