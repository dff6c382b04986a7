"""Session API and request glue (``api.py::SteadyHeatSolver.rhs_for``):
milliseconds per answer forming the right-hand side on the host, from the
program's spans ``request.rhs``."""

from portbench.metrics._program import span_ms


def read(run):
    return span_ms(run, "request.rhs")
