"""The whole answer on the host's clock, in a cell whose rate follows the
host's speed too closely to be held to a bound: answers that came right
over the traced window's length (as ``answers_per_s``, but under the
profiler, which slows each launch)."""

from portbench.harness import answer_rate


def read(run):
    return answer_rate(run) if run.records else None
