"""Solver loop dispatch (``solvers/cg.py``): milliseconds per answer the
host spends issuing the CG iterations, each span ``cg.iter`` less its
stopping test's device read (``cg.sync``): what a CUDA graph of the
iteration would remove."""

from portbench.metrics._program import per_answer, window_spans


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    iters = {s.id: s.end_ns - s.start_ns for s in spans if s.name == "cg.iter"}
    if not iters:
        return None
    own = sum(iters.values()) - sum(
        s.end_ns - s.start_ns for s in spans
        if s.name == "cg.sync" and s.parent in iters)
    return per_answer(run, own / 1e6)
