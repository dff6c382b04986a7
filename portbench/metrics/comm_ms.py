"""Collectives (``parallel/collectives.py``): milliseconds per answer in
the program's spans ``comm.gather``, ``comm.exchange`` and ``comm.halo``
in rank 0's process (not ``comm.dot``, which holds a gather): the host's
time in the collectives, its waits for the other processes included.
Like the counters of ``_program.py``, 0 where the window holds spans of
the program and none of these."""

from portbench.metrics._program import outermost, per_answer, window_spans

NAMES = ("comm.gather", "comm.exchange", "comm.halo")


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    ns = sum(s.end_ns - s.start_ns for name in NAMES
             for s in outermost(spans, name))
    return per_answer(run, ns / 1e6)
