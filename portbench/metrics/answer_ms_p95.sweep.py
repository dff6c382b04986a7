"""The whole answer on the host's clock, in a cell whose tail follows the
host's speed too closely to be held to a bound: the 95th percentile of
every request's time in the traced window (as ``answer_ms_p95``, but
under the profiler, which slows each launch)."""

from portbench.harness import answer_p95


def read(run):
    return answer_p95(run) if run.records else None
