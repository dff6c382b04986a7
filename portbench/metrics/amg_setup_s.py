"""Preconditioner set-up (``solvers/precond/amg.py``): seconds of
``smoothed_aggregation_setup``, from the benchmark's span around it."""


def read(run):
    return run.setup.get("amg_setup")
