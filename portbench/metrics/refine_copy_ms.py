"""Refinement (``solvers/mixed.py``): milliseconds per answer of staging
the right-hand side and the warm start and fetching the answer, from
``MixedSolveResult.timings`` (``stage_ms`` + ``fetch_ms``)."""


def read(run):
    vals = [r.copy_ms for r in run.records if r.copy_ms is not None]
    return sum(vals) / len(vals) if vals else None
