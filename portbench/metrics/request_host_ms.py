"""Session API and request glue (``api.py``; ``put_vector`` /
``get_vector``): host milliseconds per answer outside the solver's
iterations (right-hand side, staging, fetch to the host), from the
benchmark's spans around the solver call (the refinement's own timings)."""


def read(run):
    vals = [r.ms - r.solve_ms for r in run.records if r.solve_ms is not None]
    return sum(vals) / len(vals) if vals else None
