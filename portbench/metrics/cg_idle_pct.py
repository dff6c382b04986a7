"""Solver loop dispatch (``solvers/cg.py``): percent of the time inside
the program's ``cg`` spans in which no kernel of the trace runs on the
card.  The spans and the trace share the host's clock
(``time.time_ns()``)."""

import bisect

from portbench.metrics._program import window_spans
from portbench.tracing import _merge


def read(run):
    spans = window_spans(run)
    if spans is None or not run.trace.kernels:
        return None
    cg = [(s.start_ns, s.end_ns) for s in spans if s.name == "cg"]
    total = sum(e - s for s, e in cg)
    if total <= 0:
        return None
    busy = _merge((k.start_ns, k.end_ns) for k in run.trace.kernels)
    starts = [s for s, _e in busy]
    covered = 0
    for c0, c1 in cg:
        i = max(bisect.bisect_right(starts, c0) - 1, 0)
        while i < len(busy) and busy[i][0] < c1:
            covered += max(0, min(c1, busy[i][1]) - max(c0, busy[i][0]))
            i += 1
    return 100.0 * (1.0 - covered / total)
