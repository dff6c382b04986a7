"""Solver (``solvers/cg.py``, ``solvers/mixed.py``): CG iterations per
answer, summed over the sweeps of a refinement."""


def read(run):
    if not run.records:
        return None
    return sum(r.iterations for r in run.records) / len(run.records)
