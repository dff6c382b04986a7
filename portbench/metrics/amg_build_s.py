"""Preconditioner set-up (``solvers/precond/amg.py``): seconds of the
program's own span ``setup.amg`` around ``smoothed_aggregation_setup``,
summed over the process's outermost set-ups, whoever calls it."""

from portbench.metrics import _program


def read(run):
    spans = _program.held_spans(run)
    if spans is None or _program.recorder().dropped:
        return None
    ns = [s.end_ns - s.start_ns
          for s in _program.outermost(spans, "setup.amg")]
    return sum(ns) / 1e9 if ns else None
